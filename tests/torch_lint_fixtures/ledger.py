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


# Seeded violations of the port lint's ledger-writer rule (parsed, never
# imported). Each finding line carries an EXPECT comment.
import json
import os
import shutil

LEDGER = "PERF_LEDGER.json"
ROWS = "PERF_LEDGER.jsonl"


def direct_literal_write():
    # The bypass the rule exists for: rows landed here skip the schema,
    # the fingerprint and the append counter.
    with open("PERF_LEDGER.json", "a") as f:  # EXPECT: ledger-writer
        f.write("{}\n")


def resolved_name_write(rows):
    with open(LEDGER, "w") as f:  # EXPECT: ledger-writer
        json.dump(rows, f)


def joined_path_write(root, rows):
    with open(  # EXPECT: ledger-writer
            os.path.join(root, ROWS), mode="x") as f:
        json.dump(rows, f)


def update_in_place(root):
    with open(os.path.join(root, LEDGER), "r+") as f:  # EXPECT: ledger-writer
        return f.read()


def staged_rename(tmp):
    # Sliding a staged file onto the ledger is the same bypass.
    os.replace(tmp, LEDGER)  # EXPECT: ledger-writer
    os.rename(tmp, "PERF_LEDGER.jsonl")  # EXPECT: ledger-writer


def read_only_is_fine():
    # Reports and checks read freely; only writes need the writer.
    with open("PERF_LEDGER.json") as f:
        return json.load(f)


def other_files_are_fine(tmp, rows):
    with open("BENCHMARK.json", "w") as f:
        json.dump(rows, f)
    shutil.move(tmp, "notes.txt")


def escaped_write():
    with open(LEDGER, "w") as f:  # lint: disable=ledger-writer
        f.write("{}\n")
