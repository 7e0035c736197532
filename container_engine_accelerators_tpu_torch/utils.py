# Copyright 2026 The container-engine-accelerators-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""Env-var knob parsing (own copies of the JAX package's helpers) and
the error every option of the JAX package that the port does not
carry yet raises."""

import logging
import os

log = logging.getLogger(__name__)


def env_number(name, default, parse=float):
    """Numeric env-var knob: ``parse``d value, or ``default`` when
    unset/empty; junk warns and falls back rather than crashing the
    process that reads a mistyped deployment manifest."""
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return parse(raw)
    except ValueError:
        log.warning("ignoring non-numeric %s=%r", name, raw)
        return default


def env_str(name, default=None):
    """String env-var knob: the raw value, or ``default`` when the
    variable is UNSET (an explicitly empty value comes back as "" —
    flag knobs distinguish "operator said nothing" from "operator
    said off")."""
    return os.environ.get(name, default)


def not_ported(what):
    """The ValueError for an option or mode not ported yet: raised,
    never silently ignored."""
    return ValueError(f"{what} is not yet ported to the PyTorch package")


def _env_flag(env_name, default):
    """Flag-knob parsing: unset/empty -> ``default``;
    0/false/off/no -> False; anything else -> True."""
    raw = env_str(env_name)
    if raw is None or not raw.strip():
        return default
    return raw.strip().lower() not in ("0", "false", "off", "no")
