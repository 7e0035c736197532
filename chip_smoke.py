#!/usr/bin/env python3
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

"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card (name, count, power limit);
2. builds every CUDA kernel of the port from ops/csrc (one nvcc per
   source, all at once) and reads each kernel's registers and spills
   from ``-Xptxas -v``: a tensor-core kernel (the Hopper wgmma kernels
   included) must not spill, and ptxas must neither serialize a wgmma
   ("Potential Performance Loss") nor ignore a setmaxnreg;
3. holds each kernel against its plain PyTorch version on the card
   (flash forward, dQ, dK/dV, cross-entropy forward and backward; the
   cross-entropy gradient element by element, scaled by its mean):
   the bf16 flash forward, dQ and dK/dV (Hopper kernels: wgmma, TMA)
   at head dims 16, 40, 64 and 128, lengths 17 and 1000, the window
   band, B 1 at S 1920, grids with one and with several consumer
   warpgroups a block, and on q/k/v/dO rows that do not start on 16
   bytes (the mma.sync kernels, ``attention.tma_rows``); every flash
   kernel, f32 and bf16, at head dims 4 and 12 (padded to 8 and 16) and
   136, 192, 256, 320 and 640 (the wide kernels; the bf16 forward, dQ
   and dK/dV at 136-256 on TMA rows the Hopper kernels at DMAX 256,
   each launch's route held: the D 256 rows off 16 bytes and k, v
   broadcast over the heads take the wide mma.sync kernels), causal at
   S 17 and with the
   W 200 band at S 1000, bf16 causal at S 2048 (HEAD_DIM_CASES); one
   causal W 64
   forward at S 4 194 368, past the old grid.y limit of 65 535 row
   tiles (``check_long_sequence``); launches the three tensor-core
   kernels (bf16 flash forward, dQ, dK/dV) twice on the same inputs at
   the training and the serving prefill's shapes and at D 256, and
   requires bitwise-equal outputs; and counts the tensor-core
   instructions in their SASS (cuobjdump): HMMA or HGMMA in every
   ``*_tc_kernel``, HGMMA in each wgmma kernel, and all three wgmma
   kernels present, with their D 256 instantiations (``WIDE_WGMMA``,
   whose registers phase 2 logs);
4. times each kernel at its path's shapes beside its bound, its plain
   version and one PyTorch library call (flash forward at the serving
   prefill widths, at the demo draft's D 16 and at the training shape;
   the backward and the cross-entropy at the training shapes, the
   cross-entropy also at ResNet-50's logits), the flash kernels by
   CUDA-graph replay (device time; ``launch_ms`` launched back to back)
   beside the mma.sync design's time where one was taken
   (``MMA_SYNC_MS``), and the next-token objective's logits copy
   alone; the flash forward, dQ and dK/dV at D 256 (WIDE_SHAPE,
   GPT-J-6B's attention) beside their bounds and SDPA's, all three (the
   Hopper kernels) beside the wide mma.sync kernels' times they
   replaced (``MMA_SYNC_MS``); and a line of
   this run's D <= 128 times over PERF.md's (``recorded_ratios``);
5. serves the full-width LM (the architecture of
   demo/serving/lm-serving.yaml without its int8 options: vocab 32000,
   E 512, 8 layers, 8 heads, 2 KV heads, rope, max_seq_len 2048; bf16,
   random weights from a seed) through the port's GenerationServer on
   a localhost port, on the dense pool (``CEA_TPU_PAGED_KV=0`` while
   the server is built): greedy requests in several buckets,
   concurrent requests that batch in the slots, one sampled request.
   Every greedy response must equal greedy_decode on the same prompt,
   and the flash kernel must have launched once per layer per
   admission;
6. times the engine's admission prefill at four bucket widths and one
   decode step with every slot active (host clock around synced work);
   then serves the same model on the paged pool, the server's default
   (slot_len 2048, block 16: 1024 usable blocks and the trash block):
   a 1000-token system prompt, 8 concurrent requests of that prefix
   and a 3-30-token suffix, 4 cold prompts, the prefix again once
   every row is released (a revival). /stats must say "paged" with at
   least 8 prefix hits, every hit row admits at a width of at most 32,
   no flash kernel launches (the paged prefill attends the cache, as
   the JAX engine's does), and the pool is clean when the server is
   idle. Each greedy stream must equal greedy_decode's or first differ
   where the oracle's top two logits lie within 2e-2 of its largest
   logit (the bf16 limit: the paged prefill rounds at other points than
   the flash prefill). An engine with a small arena spills the prefix
   to the host tier and rehydrates it bitwise. Informational: a decode
   step with 8 rows on the paged and the dense pool, the admission of
   a 1003-token prompt cold and on a prefix hit, the rehydrate. Then
   the deployment phase: demo/serving/lm-serving.yaml's command line
   as written (int8 KV cache, int8 weights, byte tokenizer, --warm),
   with --port=0 added, through the port's launcher. /healthz must
   answer 503 first and 200 once warm-up is done; text, token-id and
   ndjson-stream requests (the stream equal to the same request
   unstreamed) and the demo's load generator, plain and --stream, are
   served with no kernel launch and the pool clean after; each greedy
   stream equals greedy_decode on the int8 model or first differs at a
   near tie (the rule above). The same command line on the dense pool
   (CEA_TPU_PAGED_KV=0): 8 flash launches an admission and every
   greedy response equal to greedy_decode. Reported: arena bytes and
   usable blocks (the deployed pool, and at equal memory in bf16, int8
   and int4), projection weight bytes, an engine-level int4 run, and
   in turns the paged step (bf16, int8 cache, the deployment), the
   dense admission (bf16 against int8) and one projection at decode
   width (Int8Linear against the bf16 Linear);
7. trains the same architecture at full width and depth (f32
   parameters, bf16 compute, f32 logits, sequence 2048, the demo
   driver's SGD defaults; global batch 8, cut from 256) for 12 steps
   through the driver's ``run`` (what ``python -m
   container_engine_accelerators_tpu_torch.train`` runs before it
   prints its result line): every loss finite, the last below the
   first, exactly 8 flash_fwd, 8 dQ, 8 dK/dV, 1 cross-entropy
   forward and 1 backward launch per step,
   and the driver's JSON result in agreement; then one batch-2 step
   held against the same step through the plain versions (plain
   attention_fn and plain loss): loss and every gradient's relative
   L2 error;
8. trains the image models through the same driver: ResNet-50 at full
   width (224x224x3, 1000 classes, bf16 compute, f32 parameters and
   logits, batch 128, bench.py's configuration) for 12 steps: every
   loss finite, the last below the first, exactly 1 cross-entropy
   forward and 1 backward launch a step and no attention launch, every
   BN's running statistics moved, the eval step's logits finite; then
   one step through the fused loss held against the same step through
   the plain loss (and against itself, bitwise or not, reported);
   MNIST at the demo's shapes (28x28x1, 10 classes, batch 256) for a
   few steps with the same launch counts; Inception-v3 at 299x299,
   batch 32, 3 steps on the plain loss (no kernel launch). Phases 3
   and 4 also hold and time the cross-entropy kernels at the image
   logits' shapes ([128, 1000] and [256, 10] f32);
9. runs phase 5-7's architecture with a sliding window of W 512: (a)
   6 training steps through ``train.run`` with ``--attention-window 512``
   (sequence 2048, batch 8: 8/8/8/1/1 launches a step, the loss falls)
   and one batch-2 step against the plain step with the band (phase
   7's limits); on the same weights and tokens, the windowed logits
   equal the causal model's before position 512 (bf16 limit) and
   differ after it; (b) ``decode()`` on the ring (prompts of 1500 and
   16 tokens, 128 new tokens each): 8 flash_fwd launches a call, ring
   leaves of [1, 512, 2, 64], every greedy token the argmax of one
   cache-free windowed forward over the generated sequence or at a
   near tie (PERF.md §2's 2e-2 rule), ``stream_decode`` (chunks of 16)
   and ``beam_search(num_beams=1)`` equal to decode() or held to the
   same rule; (c) ``serve.py --attention-window 512`` on the paged
   pool (2 short and 4 long requests of up to 1500 tokens, concurrent)
   and on the dense pool (4 requests): no kernel launch, each greedy
   stream equal to decode() on the ring (greedy_decode, on the ring
   too) or first differing at a near tie, the pool clean when idle;
   (d) informational: the three flash kernels at [8, 2048, 8, 64] with
   the band beside their bounds and SDPA with the band as a boolean
   mask, the ring's KV bytes a row against the full-length cache, and
   a decode step on each;
10. runs speculation at full width, k 4, with two drafts: the demo
   launcher's default (2 layers, E 128, the target's 8 heads, MHA,
   rope, seed 1) and the target itself (a self-draft). (a)
   ``speculative_decode`` on prompts of 1500 and 16 tokens, 128 new
   tokens each: 16 flash_fwd launches a self-draft call and 10 a
   demo-draft call (the two one-shot prefills) and nothing else; each
   greedy stream equal to greedy_decode's or first differing at a near
   tie (PERF.md §2's 2e-2 rule); self-draft acceptance at least 0.9;
   one sampled call finite and reproducible from its generator; the
   windowed target (W 512) with its self-draft on rings of [1, 516, 2,
   64] under the same rule; (b) ``serve.py --speculative-k 4`` (the
   demo draft) on the paged pool, 6 concurrent greedy requests and 1
   sampled: exactly 2 flash_fwd launches a greedy admission (the
   draft's prefill) and 0 for the sampled one, the streams under the
   rule, /stats with the speculation fields, pool and draft arena
   clean when idle; the same flags on the dense pool, 10 launches a
   greedy admission; an engine with the self-draft driven directly,
   its acceptance at least 0.5 (the JAX tool's floor); (c)
   informational: a decode step with 8 rows plain, with the demo draft
   and with the self-draft, tokens committed a step, the draft arena's
   bytes;
11. runs the serving contract: (a) demo/serving/jax-serving.yaml's
   command line (``--model-name=resnet --port=8500``, ``--port=0``
   added) through the port's launcher in its own process: the default
   model, ResNet-50 v1.5 at 224x224x3 (bf16, seed 0, eval mode,
   micro-batches padded to 8); /readyz 200; 8 instances in one request
   and 8 one-instance requests at once must return the classes of the
   same ResNet-50's eval forward run here on the same batch (or differ
   at a near tie, the 2e-2 rule) and scores within 2e-2;
   informational p50 latency at 1 and 8 images, images/s; exit 0 on
   SIGTERM. (b) a fault drill on the dense and the paged pool of the
   GenerationServer: ``CEA_TPU_FAULT_PLAN`` {"step": [8]}, then
   {"prefill": [3]}, with 6 concurrent greedy requests of 16-1500
   tokens: each plan exactly one quarantine, naming an InjectedFault
   (any other error fails the phase), and one rebuild; every stream
   equal to greedy_decode's or first differing at a near tie; 8
   flash_fwd launches a replay admission on the dense pool, 0 on the
   paged pool; the pool clean. (c) SIGTERM to a launcher process (the
   LM) with 3 streams in flight: /readyz 503 {"state": "draining"}, a
   new POST 503 with Retry-After, the streams finish, exit 0. (d)
   ``--system-prefix-ids`` with 1000 ids, alone and with
   ``--speculative-k 4``: 4 prefix hits each, suffix streams against
   greedy_decode over prefix + suffix (the near-tie rule), no launch
   alone and 2 a greedy draft admission with speculation. (e) on the
   first prefix server: /metrics with the TTFT buckets,
   /debug/requests records summing to their wall time, and a request
   sent with a traceparent and a request id lands in one
   ``serving.request`` span under that trace, with the id in its
   ledger record.
12. runs the fleet front door: lm-serving.yaml's architecture in two
   launcher processes (started before phase 11, warmed up while it
   runs) behind the port's FleetCollector and RouterServer: A on the
   paged pool (deploy/fleet/engine.yaml's), B on the dense pool
   (``CEA_TPU_PAGED_KV=0``). (a) 8 greedy streams of 128 tokens through
   the router, 4 of 16-1000 tokens and 4 on a shared 1000-token prefix
   whose first request is pinned to A and whose repeats land there by
   affinity (``tpu_router_routed_total{reason="affinity"}``); every
   stream equal to greedy_decode's or first differing at a near tie.
   (b) SIGKILL A with at least 2 of the repeats mid-flight: every
   stream completes through the router, each spliced tail equals B's
   direct answer for prompt + the tokens delivered before the kill
   (exact), the failover counter moves, and B's flash_fwd launches
   grow by 8 a splice admission (kernel #1 on the fleet path). (c) B
   quiesces with its slots free and every admitted request retired.
   (d) each spliced journey is one router record with one trace id,
   under which B's ``serving.request`` span for the resubmit parents.
   (e) SIGUSR1 drains B: the router's /readyz turns 503 and new work
   gets 503 with Retry-After. The ``fleet:`` line holds each stream's
   first divergence, the splices, #1's launches, the router overhead
   (its own buckets of a splice-free journey) and the phase's seconds.
13. runs the MoE family at full width: the serving architecture with
   the launchers' MoE defaults (8 experts, top-2 routing at capacity
   factor 1.25 on the 4 odd layers). (a) one routed layer at T 2048,
   d 512, bf16: the index form's slot assignment and weights equal to
   the dense form's (``top_k_routing``) exactly, its output within the
   bf16 rule of ``dense_moe_reference``'s, aux within 1e-5, both forms
   timed; (b) ``train.run`` with ``--model moe`` at phase 7's shape for
   5 steps (8/8/8/1/1 launches a step, the loss falls), and the batch-2
   kernel step against the plain step (plain attention, plain loss,
   ``dense_moe_reference``; phase 7's limits); (c) ``serve.py --model
   moe`` (build_server) on the dense and the paged pool, 6 concurrent
   greedy requests of 16-1100 tokens: 8 flash_fwd launches a dense
   admission, none paged, the pool clean; each greedy stream equal to
   greedy_decode's or first differing at a near tie (the 2e-2 rule);
   the engine's calls recorded and replayed on a fresh engine of the
   server's factory that routes through ``dense_moe_reference``, every
   live row's token equal or the first difference at a near tie. A
   dropping router routes each step's 8 slots and each admission's
   padded bucket as one group, which greedy_decode's batch-1 calls do
   not: the replay makes the same calls, and greedy_decode's rule
   holds while a drop moves the logits less than the rule's limit
   (PERF.md §6). The 8-slot step timed on each pool. (d) drop-free routing (capacity factor 4) with its
   own draft at k 4 through the server on the paged pool: streams
   against greedy_decode under the near-tie rule, acceptance at least
   0.5, 8 flash_fwd launches a greedy admission; ``serve.py --model
   moe --speculative-k 4`` refuses the dropping router at startup (on
   2 layers and vocab 1024: the refusal reads the routing options).
14. runs real data, checkpoints and trained weights through the driver
   and the launcher, at full width. (a) ResNet-50 as
   demo/tpu-training/resnet-jax.yaml runs it on one card (batch 128,
   224x224x3, 1000 classes) on 5 seeded .npz shards of 176 images in a
   temporary directory (batches cross shard boundaries): A, 4 steps
   with ``--data-dir``, ``--model-dir`` M, ``--checkpoint-every 2`` and
   ``--keep-checkpoints 2``; B, resumed in M for 2 steps (the loader
   skips the batches A took, shard by shard); C, 6 steps straight in a
   second directory on shards that replay A's and B's six batches,
   saving at the end only (its images/s is the file pipeline's). Each
   step's labels and the last pixels of each image, read on the card as
   the step reads them, equal numpy's NpzShardDataset's; 0/0/0/1/1
   launches a step; M holds checkpoint_4 and checkpoint_6; B's
   checkpoint_6 against C's leaf by leaf within 5e-2 relative L2
   (``CKPT_RESUME_TOL``). (b) An async save at C's last step with two
   more steps at once: the archive equals the host copy of that step
   bitwise. (c) MODEL trained 3 steps at sequence 2048, batch 8, with
   ``--model-dir`` (8/8/8/1/1 a step) and the demo's draft (2 layers, E
   128) 3 steps into its own directory; ``serve.py --model-dir`` on the
   dense and the paged pool: every served weight the archive's leaf cast
   to bf16 bitwise, 4 concurrent greedy streams against greedy_decode
   under the near-tie rule, 8 flash_fwd launches a dense admission and
   none paged; lm-serving.yaml's flags (without --warm) with
   ``--model-dir``: the int8 weights equal ``quantize_lm`` of the
   archive's tree, bitwise; ``--speculative-k 4 --draft-model-dir``:
   the draft's weights the archive's, streams under the near-tie rule,
   2 launches a greedy admission, the trained draft's acceptance beside
   phase 10's random draft (no bound). (d) The ResNet-50 predict server
   from B's checkpoint: weights and BN statistics equal the archive,
   classes the eval forward of the restored model or a near tie.
15. runs the tooling adapters at full width (``drive_tooling``). (a)
   The dense pool behind the port server (MODEL): every prompt bucket
   served once, a 0.1 s ``/debug/profile`` capture paying the
   profiler's start-up, then ``/debug/profile?seconds=2`` while waves of
   8 concurrent requests are admitted and decode (a second capture
   meanwhile answers 409): its Chrome trace must name
   ``flash_fwd_wgmma_tc_kernel`` (up to TOOL_CAPTURES captures, each
   one's kernel count reported). (b) ``/stats`` ``hbm_peak_bytes`` at
   least ``torch.cuda.max_memory_allocated()`` read just before and at
   most ``mem_get_info()[1]``; ``hbm_in_use_bytes`` at most the peak.
   (c) ``decode_mfu`` finite and in (0, 1) after at least 32 eight-slot
   steps; 8 ``flash_fwd`` launches an admission. (d) 3 LM steps at
   phase 7's shape through the driver with ``--profile-dir``: 8/8/8/1/1
   a step, the trace names the dQ and dK/dV kernels, ``train_mfu`` in
   (0, 1), the goodput buckets sum to the wall within 1%. (f) The FLOPs
   the Trainer counted on its first step equal the analytic count (6
   a linear weight a token, 18·D a kept pair a layer) within 1%. (e) A
   launcher process (``lm_flags()``, the paged pool,
   ``CEA_TPU_TRACE_FILE`` set) SIGTERM'd with a stream in flight: the
   stream finishes, the process exits 0, and the journal holds
   ``serving_kv_blocks``, the drained request in ``serving_requests``
   and a ``cuda:0`` memory watermark.
16. runs the distributed forms in a one-rank NCCL group it starts
   (``drive_group``). (a) MODEL through the driver on the group's mesh,
   once with ``--fsdp`` and once with ``--model-parallelism 1``, for
   GROUP_STEPS steps: 8/8/8/1/1 launches a step, a falling loss, and
   the losses of phase 7's first GROUP_STEPS steps (same init, same
   batches) within STEP_LOSS_TOL relative (bitwise equality reported).
   (b) ResNet-50 at bench.py's shape on the mesh: 0/0/0/1/1 launches a
   step and the running statistics of all 53 BatchNorms moved. Every
   mesh axis is one rank wide, so neither runs a collective (counted,
   and gated at 0), as GSPMD does no work on a 1-wide axis. The group
   is torn down; (c) two processes try a two-rank NCCL group on the
   one card, and each rank's outcome (the error NCCL gives, or the
   all-reduce) is recorded, not gated. (d) The program guard
   (``analysis/programs.py``) over phase 6's kind of traffic (the
   1000-token system prompt, 8 suffixed rows of it, 2 cold prompts) on
   a paged and a dense engine at the server's buckets: one prefill
   program a bucket, one insert (paged), one step, no CUDA-graph
   capture; flash launches on the dense pool only.
17. runs tensor-parallel serving, context and expert parallelism in a
   one-rank NCCL group it starts (``drive_parallel``). (a) MODEL on the
   launcher's --tensor-parallel code path (``serve.build_lm_models``,
   ``Spmd`` on a 1 x 1 mesh, ``lockstep.Channel``, the server's
   ``LockstepEngine``) on the paged pool, the dense pool and the
   deployed int8 form (int8 weights and KV): TP_PROMPTS greedy requests
   at once, each stream equal to the same request's on a server without
   a group, token for token; flash_fwd launches 8 a dense admission and
   none paged; the program guard over the lockstep engine (buckets +
   insert + step). (b) The ring on the card at the long-context
   manifest's per-layer width (q/k/v [1, 32768, 16, 64] bf16, causal,
   RING_BLOCKS blocks of 4096): ``context._flash_hop`` +
   ``context._lse_merge`` over every hop of every block in one process
   (the ring's code, the transport replaced by indexing) against
   ``flash_attention`` on the whole sequence, the output and dQ/dK/dV
   (through the lse cotangent) at phase 4's tolerance; diagonal, full
   and masked hops counted with their launches (a masked hop launches
   nothing); Ulysses' local attention on 16/8 heads the same way.
   (c) demo/tpu-training/longcontext-lm-jax.yaml's model (vocab 32000,
   E 1024, 12 layers, 16 heads, sequence 32768; batch cut from 8 to 1,
   one chip's share) through the Trainer with ring attention on a
   one-rank ("data", "context") mesh for LONG_STEPS steps: 12/12/12/1/1
   launches a step, a finite falling loss, the losses of the same steps
   with the default flash attention within STEP_LOSS_TOL relative;
   step time and peak memory reported. (d) Phase 13's MoE through
   ``MoETransformerLM`` bound to a one-rank expert mesh for MOE_STEPS
   steps: 8/8/8/1/1 launches a step, the losses of phase 13's steps
   within STEP_LOSS_TOL (bitwise equality reported).
18. runs pipeline parallelism and elastic recovery (``drive_pipeline``).
   (a) demo/tpu-training/pipeline-lm-jax.yaml's model at full width
   (vocab 32000, E 1024, 16 layers, 16 heads, sequence 2048, batch 32,
   8 microbatches; its pipe axis cut from 4 to 1: one card is one
   rank, so the circular schedule runs 16 laps, 128 ticks, no bubble)
   through the port's ``run_pipeline_lm``: first the pipelined logits
   and gradients of 8 rows in 2 microbatches against
   ``reference_apply`` on the same weights (PIPE_LOGITS_TOL and
   STEP_GRAD_TOL, relative L2); then PIPE_STEPS steps in a one-rank
   NCCL group (128/128/128/1/1 launches a step, a falling loss), the
   same with --remat (256 ``flash_fwd``; losses and final parameters
   bitwise the group's) and without a group (bitwise the group's);
   step time, tokens/s and peak memory of each. (b) MODEL through the
   Trainer on a one-rank mesh: 3 steps, a checkpoint, 3 more; the
   supervisor's ``rebuild`` after the planned eviction of a host that
   holds no rank (one card cannot lose one): ``Trainer.remesh`` and
   ``restore_state(shardings=)`` on a rebuilt one-rank mesh, whose next
   3 steps must give the uninterrupted losses bitwise, with the
   recovery in the restart bucket and one ``train.recovered`` event.
19. runs the multichip dryrun and the combined ("data", "context",
   "expert") step in a one-rank NCCL group it starts
   (``drive_dryrun``). (a) ``parallel.dryrun.dryrun_multichip(1)`` on
   the card, as the driver's one-chip validation calls it: stage 1
   (ResNet-50 width 16 on the (1, 1) mesh) runs, a finite loss and
   step 1; stages 1b-4 report skipped with the JAX dryrun's gates. (b)
   Phase 13's MoE through the Trainer on a (1, 1, 1) ("data",
   "context", "expert") mesh (``dryrun.combined_mesh``): ring
   attention over "context", the routed layers bound to "expert", the
   driver's MoE loss, COMBINED_STEPS steps at S 2048, batch 8: 8/8/8/1/1
   launches a step, no collective (every axis one rank wide), the
   losses of phase 13's steps within STEP_LOSS_TOL; step time, tokens/s
   and peak memory reported. (c) The dryrun's stage 2 at its own shape
   (vocab 32, E 32, 2 layers, head dim 8, f32) on a (1, 1, 1) mesh: a
   finite loss, step 1, 2/2/2/0/0 launches (the f32 flash kernels).
   (d) The dryrun's stage 3 on one rank (``stage_pp(1)``, outside the
   JAX gate, which skips it below two devices): the circular
   PipelinedLM at head dim 4, f32, through the kernels (D 4 padded to
   8), 4/4/4/0/0 launches, its loss within DRYRUN_STAGE3_TOL of the
   same step with the kernels replaced by their plain versions.
20. trains and serves head dim 256 (``drive_d256``): GPT-J-6B's
   attention widths (E 4096 over 16 heads, rope; vocab 32000; depth cut
   from 28 layers to 4). (a) D256_STEPS steps through the driver at S
   2048, batch 4: 4/4/4/1/1 launches a step, every forward, dQ and
   dK/dV launch on the Hopper kernels (``hopper_launches``), a finite
   and falling
   loss, step time, tokens/s and peak memory; (b) the batch-2 kernel
   step against the plain step at phase 7's limits; (c) the launcher's
   dense pool serves one greedy prompt: 4 ``flash_fwd`` launches for
   its one admission, all on the Hopper kernel, the stream under the
   near-tie rule against
   greedy_decode.

Where a training step's device time goes is measured by
``container_engine_accelerators_tpu_torch.train_profile`` (a
torch.profiler trace), not here.

Any failure exits nonzero. Without a CUDA device it exits 2 before
printing any result. The last three lines of output are the
``{"kernels": [...]}`` line, the card's name and power limit, and
``{"ok": true, "device": {...}}``. Details go to
chiprun_out/chip_smoke.json.
"""

import contextlib
import functools
import itertools
import math
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO_ROOT, "chiprun_out")

# One full-width model the repo serves (demo/serving/lm-serving.yaml).
MODEL = dict(vocab_size=32000, embed_dim=512, num_layers=8, num_heads=8,
             num_kv_heads=2, pos_embedding="rope", max_seq_len=2048)
MAX_NEW = 128
MAX_BATCH = 8
SEED = 0
# The paged phase: a 1000-token system prompt (62 full blocks of 16 and
# 8 tokens, so the boundary block forks) and 64 new tokens a request.
PAGED_PREFIX = 1000
PAGED_NEW = 64
PAGED_COLD = (100, 700)   # cold prompt lengths
# The deployment phase: demo/serving/lm-serving.yaml's command line as
# written, through the port's launcher, with --port=0 added.
MANIFEST = os.path.join(REPO_ROOT, "demo", "serving", "lm-serving.yaml")
DEPLOY_NEW = 32                      # new tokens a greedy request
DEPLOY_PROMPTS = (16, 100, 700, 1500)
PREFILL_WIDTHS = (16, 128, 1024, 1920)   # timed admission widths
# The training slice: sequence 2048 at global batch 8 (the demo
# driver's default batch, 256, cut to keep the run short).
TRAIN_SEQ = 2048
TRAIN_BATCH = 8
TRAIN_STEPS = 12
TRAIN_WARMUP = 2
PLAIN_BATCH = 2  # the plain attention's [B, H, S, S] f32 scores fit
# The window phase (9): the same architecture with a sliding window of
# W 512, a quarter of the context. No public configuration of this
# architecture fixes a width; at 512 the serving buckets 1024 and 1920
# wrap the ring while 16 and 128 do not, and at S 2048 the band keeps
# 917 760 of the 2 098 176 causal pairs, so the kernels skip tiles.
WINDOW = 512
WINDOW_STEPS = 6
WINDOW_WARMUP = 2
WINDOW_PROMPTS = (1500, 16)        # decode() on the ring
WINDOW_SERVE = (16, 100, 1024, 1200, 1350, 1500)   # 2 short, 4 long
WINDOW_DENSE = (16, 100, 1024, 1500)
WINDOW_NEW = 32
WINDOW_STEP_POS = 1600             # the timed decode step's position
# The speculation phase (10): k 4; the demo launcher's default draft
# (demo/serving/serve.py: 2 layers, E 128, the target's heads, MHA,
# rope, the target's vocab and max_seq_len; seed SEED + 1 as the port's
# launcher makes it) and the self-draft.
SPEC_K = 4
SPEC_DRAFT = dict(MODEL, embed_dim=128, num_layers=2, num_kv_heads=None)
SPEC_PROMPTS = (1500, 16)
SPEC_SERVE = (16, 64, 100, 300, 700, 1500)     # concurrent greedy
SPEC_DENSE = (16, 100, 700, 1500)
SPEC_ENGINE = (16, 32, 64, 100, 200, 300, 500, 700)
SPEC_ENGINE_NEW = 64
SPEC_NEW = 32
SPEC_ACCEPT_SINGLE = 0.9   # single-request self-draft: no draft holes
SPEC_ACCEPT_ENGINE = 0.5   # tools/bench_serving_occupancy.py's floor
# The serving-contract phase (11): demo/serving/jax-serving.yaml's
# predict server (ResNet-50 at 224x224x3, the launcher's --max-batch 8);
# a fault drill of 6 concurrent greedy requests of 16-1500 tokens on
# both pools under a step plan and a prefill plan (the step fault lands
# mid-stream, the prefill fault on the fourth admission); drain; a
# 1000-id system prefix with 4 suffixes of 3-500 tokens.
PREDICT_MANIFEST = os.path.join(REPO_ROOT, "demo", "serving",
                                "jax-serving.yaml")
PREDICT_DEPTH = 50
PREDICT_BATCH = 8
DRILL_LENGTHS = (16, 64, 300, 700, 1000, 1500)
DRILL_NEW = 24
DRILL_PLANS = ({"step": [8]}, {"prefill": [3]})
PREFIX_IDS = 1000
PREFIX_SUFFIXES = (3, 30, 200, 500)
DRAIN_PROMPTS = (16, 100, 700)     # streams in flight at SIGTERM
# The kernel step against the plain step: loss within 1e-3 relative,
# each gradient within 5e-2 relative L2. Both steps compute in bf16
# with f32 sums but round at different points (the flash forward's
# online softmax against one dense softmax, the fused cross-entropy's
# gradient against log_softmax's), so single values differ by a bf16
# unit (2**-8) here and there, and the differences grow through 8
# layers of backward: on the card the worst gradient sits near 2%
# (the last layer's q projection, whose gradient is small) and the
# median near 0.7%. A wrong mask or tile bound moves a gradient by
# O(1).
STEP_LOSS_TOL = 1e-3
STEP_GRAD_TOL = 5e-2

# The image slice (phase 8): bench.py's ResNet-50 at full width, the
# demo driver's MNIST, Inception-v3 at its 299 input with the batch
# cut from 256 to 32 and 3 steps to keep the phase short.
RESNET_BATCH = 128
RESNET_SIZE = 224
RESNET_CLASSES = 1000
RESNET_STEPS = 12
RESNET_WARMUP = 2
MNIST_BATCH = 256
MNIST_STEPS = 5
INCEPTION_BATCH = 32
INCEPTION_STEPS = 3
# The fused-loss step against the plain-loss step, same weights and
# batch: the forward is the same cuDNN work on the same inputs, so the
# logits agree and the two losses differ only in the f32 summation
# order of 1000-class rows (a few f32 units): 1e-5 relative. The
# gradients enter the bf16 backward from dlogits that differ by f32
# units, so a bf16 rounding flips here and there and cuDNN's backward
# algorithms may sum in another order; each gradient within 5e-2
# relative L2, as the LM step (a wrong softmax or label moves them by
# O(1)).
IMAGE_LOSS_TOL = 1e-5
IMAGE_GRAD_TOL = 5e-2

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; FLOP/s by
# input type (bf16 on the tensor cores, f32 outside them).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TOL = {"torch.bfloat16": 2e-2, "torch.float32": 1e-4}


def log(*args):
    print(*args, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean time of ``fn`` on the card by CUDA events, after warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters, reps=5):
    """Mean device time of ``fn`` by CUDA events around replays of a
    CUDA graph of ``iters`` calls: the kernels' own time, without the
    host's launch cost (which bounds back-to-back calls at small
    shapes)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def bound_ms(nbytes, flops, dtype):
    """The least time for ``nbytes`` of memory traffic and ``flops``
    operations of input type ``dtype``: (ms, "bytes"|"operations")."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")


def kept_pairs(s, causal, window):
    """(query, key) pairs the masks keep in one head."""
    if causal and window:
        return sum(min(i + 1, window) for i in range(s))
    if causal:
        return s * (s + 1) // 2
    return s * s


def attention_bound_ms(b, s, h, d, dtype, causal, window, role="fwd"):
    """Least time for one flash kernel's work on these inputs. Bytes:
    each input read once, each output written once (fwd: q, k, v in,
    o and lse out; dq: q, k, v, dO, lse, delta in, dQ out; dkv: the
    same in, dK and dV out). Operations over the kept score pairs:
    fwd QK^T and PV (4*D a pair), dq also dO.V^T (6*D), dkv also the
    dV and dK products (8*D); against the input type's peak."""
    item = 2 if dtype == "torch.bfloat16" else 4
    tensor = b * s * h * d * item
    rows = b * s * h * 4
    nbytes, per_pair = {
        "fwd": (4 * tensor + rows, 4),
        "dq": (5 * tensor + 2 * rows, 6),
        "dkv": (6 * tensor + 2 * rows, 8),
    }[role]
    flops = per_pair * d * b * h * kept_pairs(s, causal, window)
    return bound_ms(nbytes, flops, dtype)


def xent_bound_ms(n, c, role):
    """Least time for the cross-entropy kernels on f32 logits [n, c]
    with int64 labels: fwd reads logits and labels and writes the
    loss; bwd also reads g and writes dlogits. About 4 (fwd) and 6
    (bwd) f32 operations per logit against the f32 peak."""
    if role == "fwd":
        return bound_ms(n * c * 4 + n * 8 + n * 4, 4 * n * c,
                        "torch.float32")
    return bound_ms(2 * n * c * 4 + n * 8 + n * 4, 6 * n * c,
                    "torch.float32")


def attn_operands(torch, shape, dtype, n, gen, misaligned=False):
    """n random [B, S, H, D] operands. misaligned: slices of one fused
    [B, S, n*H*D + 1] projection starting one element in, so no row
    starts on 16 bytes (the kernels' narrow-load staging); "broadcast":
    the second and third (k, v) expanded over the heads from [B, S, 1,
    D] (rows on 16 bytes, a head stride of 0 that no TMA tensor map
    takes)."""
    b, s, h, d = shape
    if misaligned == "broadcast":
        xs = [torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
              for _ in range(n)]
        xs[1:3] = [torch.randn((b, s, 1, d), generator=gen, device="cuda",
                               dtype=dtype).expand(shape) for _ in range(2)]
        return xs
    if not misaligned:
        return [torch.randn(shape, generator=gen, device="cuda",
                            dtype=dtype) for _ in range(n)]
    fused = torch.randn((b, s, n * h * d + 1), generator=gen,
                        device="cuda", dtype=dtype)
    return [fused[:, :, 1 + i * h * d:1 + (i + 1) * h * d].unflatten(
        -1, (h, d)) for i in range(n)]


# Phase 3's attention cases: (shape, dtype, causal, window, misaligned
# rows). bf16 runs the Hopper forward, dQ and dK/dV (wgmma, TMA): head
# dims 16 (the demo draft's), 40 (not a multiple of 16), 64 and 128;
# lengths 17 and 1000 (not multiples of a tile); the window band; one
# and two consumer warpgroups a block (the grid's 128-row tiles below
# and above the card's 132 SMs); and rows that do not start on 16
# bytes, which take the mma.sync forward, dQ and dK/dV
# (``attention.tma_rows``). f32 runs the FMA kernels.
BF16_TC_CASES = [((2, 333, 4, 128), "bfloat16", True, 0, False),
                 ((2, 200, 4, 40), "bfloat16", False, 0, False),
                 ((1, 300, 4, 64), "bfloat16", True, 64, False),
                 ((2, 150, 4, 64), "bfloat16", True, 0, True),
                 ((2, 17, 8, 16), "bfloat16", True, 0, False),
                 ((1, 1920, 8, 16), "bfloat16", True, 0, False),
                 ((2, 1000, 4, 40), "bfloat16", True, 0, False),
                 ((1, 1000, 8, 64), "bfloat16", True, 512, False),
                 ((4, 1000, 8, 128), "bfloat16", True, 256, False),
                 ((8, 512, 8, 64), "bfloat16", False, 0, False),
                 ((2, 150, 4, 128), "bfloat16", True, 64, True)]

# Head dims past the multiples of 8 up to 128 (``attention.
# head_dim_route``): D 4 and 12 run zero-padded to 8 and 16, D 136 to
# 320 the wide kernels (128-column chunks of each output over the grid,
# bf16 on mma.sync), except the bf16 forward, dQ and dK/dV at D 136-256
# on rows a TMA tensor map describes, which run the Hopper kernels at
# DMAX 256
# (136 and 192 zero-filled past their last column). f32 and bf16,
# causal at length 17 and with the W 200 band at length 1000; bf16
# causal at length 2048 (D 136, 192, 256); at D 256 the ragged S 150
# with the W 64 band on TMA rows (Hopper), on rows off 16 bytes and on k
# and v broadcast over the heads (both the wide mma.sync kernels;
# ``check_flash`` and ``check_backward`` hold the route); D 640 (bf16, aligned and ragged
# rows) stages its own tile again each partner tile, past the four
# 128-column slabs the wide kernels hold.
HEAD_DIM_CASES = [((b, s, 2, d), dtype, True, w, False)
                  for d in (4, 12, 136, 192, 256, 320)
                  for dtype in ("float32", "bfloat16")
                  for b, s, w in ((2, 17, 0), (1, 1000, 200))]
HEAD_DIM_CASES += [((1, 2048, 2, d), "bfloat16", True, 0, False)
                   for d in (136, 192, 256)]
HEAD_DIM_CASES += [((2, 150, 4, 256), "bfloat16", True, 64, rows)
                   for rows in (False, True, "broadcast")]
HEAD_DIM_CASES += [((1, 200, 2, 640), "bfloat16", True, 64, False),
                   ((2, 100, 2, 640), "bfloat16", True, 0, True)]

# The bf16 forward's, dQ's and dK/dV's times on the mma.sync design
# the Hopper kernels replaced (the same measurement on one NVIDIA H100
# 80GB HBM3 at 700 W), printed beside the new times: {(name, shape,
# window): ms}.
MMA_SYNC_MS = {("flash_fwd", (8, 2048, 8, 64), 0): 0.1949,
               ("flash_bwd_dkv", (8, 2048, 8, 64), 0): 0.4184,
               ("flash_bwd_dq", (8, 2048, 8, 64), 0): 0.2753,
               ("flash_fwd", (8, 2048, 8, 64), 512): 0.1137,
               ("flash_bwd_dkv", (8, 2048, 8, 64), 512): 0.2284,
               ("flash_bwd_dq", (8, 2048, 8, 64), 512): 0.1481,
               ("flash_fwd", (1, 1920, 8, 64), 0): 0.0460,
               # The wide mma.sync forward, dQ and dK/dV the D 256
               # Hopper kernels replaced on TMA rows (PERF.md §6).
               ("flash_fwd", (4, 2048, 16, 256), 0): 1.1736,
               ("flash_bwd_dq", (4, 2048, 16, 256), 0): 2.4167,
               ("flash_bwd_dkv", (4, 2048, 16, 256), 0): 3.1527}


def hopper_route(torch, attn, dtype, kd, handed):
    """(runs a Hopper kernel, the route it must take) for operands
    ``handed`` (padded to kernel head dim ``kd``) of type ``dtype``:
    bf16 runs the Hopper forward, dQ and dK/dV exactly where a tensor
    map describes the rows up to kernel head dim 256; other bf16 rows
    above 128 take the wide mma.sync kernels (16-byte staging where
    every row starts on 16 bytes)."""
    hopper = (dtype == torch.bfloat16 and kd <= 256
              and attn.tma_rows(*handed) == 1)
    if hopper:
        return True, attn.ROUTE_HOPPER
    if kd > 128:
        return False, attn.ROUTE_ROWS16 * attn.rows_aligned(*handed)
    return False, 0


def check_flash(torch, attn):
    """Phase 3: the kernel against the plain version, O and lse, and
    each launch's route (``hopper_route``)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [((1, s, 8, 64), "bfloat16", True, 0, False)
             for s in (16, 200, 512, 1920)]
    cases += [((2, 200, 4, 32), "float32", False, 0, False),
              ((1, 300, 4, 64), "float32", True, 64, False),
              ((1, 1920, 8, 64), "bfloat16", True, 256, False)]
    cases += BF16_TC_CASES + HEAD_DIM_CASES
    results = []
    for shape, dtype, causal, window, misaligned in cases:
        dtype = getattr(torch, dtype)
        q, k, v = attn_operands(torch, shape, dtype, 3, gen, misaligned)
        # The route of what the wrapper hands the kernel (padded to kd).
        kd, _ = attn.head_dim_route(shape[3])
        handed = attn._padded(kd, q, k, v)
        route = attn.kernel_route(kd, *handed)
        hopper, want = hopper_route(torch, attn, dtype, kd, handed)
        hopper0 = attn.flash_fwd.hopper_launches
        o, lse = attn.flash_attention_lse(q, k, v, causal=causal,
                                          window=window or None)
        torch.cuda.synchronize()
        ro, rl = attn.flash_attention_reference(q, k, v, causal, window)
        err_o = (o.float() - ro.float()).abs().max().item()
        err_l = (lse - rl).abs().max().item()
        tol = TOL[str(dtype)]
        case = dict(shape=list(shape), dtype=str(dtype), causal=causal,
                    window=window, rows_aligned=attn.rows_aligned(q, k, v),
                    tma_rows=attn.tma_rows(q, k, v),
                    head_dim_route=attn.head_dim_route(shape[3]),
                    route=route, hopper_launches=(
                        attn.flash_fwd.hopper_launches - hopper0),
                    err_o=err_o, err_lse=err_l, tol=tol)
        log("flash check", json.dumps(case))
        if not (err_o <= tol and err_l <= tol
                and case["hopper_launches"] == int(hopper)
                and (dtype != torch.bfloat16 or route == want)):
            raise AssertionError(f"flash kernel disagrees: {case}")
        results.append(case)
    return results


def time_flash(torch, attn, widths, d=None):
    """Phase 4: kernel, plain version and SDPA at the path shapes
    (head dim ``d``, the target's by default), each beside the
    mma.sync kernel's time where one was taken."""
    import torch.nn.functional as F
    heads = MODEL["num_heads"]
    d = d or MODEL["embed_dim"] // heads
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []
    for s in widths:
        q, k, v = (torch.randn((1, s, heads, d), generator=gen,
                               device="cuda", dtype=torch.bfloat16)
                   for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        iters = 200 if s <= 512 else 50
        row = dict(shape=[1, s, heads, d], dtype="torch.bfloat16",
                   timing="graph")
        row["kernel_ms"] = graph_ms(
            lambda: attn.flash_fwd.launch(q, k, v, True, 0), 20)
        row["launch_ms"] = cuda_ms(
            lambda: attn.flash_fwd.launch(q, k, v, True, 0), iters)
        row["plain_ms"] = cuda_ms(
            lambda: attn.flash_attention_reference(q, k, v, True, 0),
            max(10, iters // 10))
        row["library_ms"] = graph_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True), 20)
        o, _ = attn.flash_fwd.launch(q, k, v, True, 0)
        ro, _ = attn.flash_attention_reference(q, k, v, True, 0)
        row["max_abs_err"] = (o.float() - ro.float()).abs().max().item()
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            1, s, heads, d, "torch.bfloat16", True, 0)
        row["mma_sync_ms"] = MMA_SYNC_MS.get(("flash_fwd", (1, s, heads, d),
                                              0))
        log("flash time", json.dumps(row))
        rows.append(row)
    return rows


def near(got, want, dtype):
    """(max abs error, tolerance): bf16 2e-2 of the reference's largest
    magnitude (outputs rounded to 8 bits); f32 1e-4, relative once the
    values exceed 1 (summation order)."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = TOL[dtype] * (scale if dtype == "torch.bfloat16"
                        else max(1.0, scale))
    return err, tol


def bwd_inputs(torch, attn, shape, dtype, causal, window, gen, lse_grad,
               misaligned=False):
    """q, k, v, dO, and the lse/delta the backward kernels take
    (delta = rowsum(dO * O) - g_lse, from the plain forward)."""
    q, k, v, do = attn_operands(torch, shape, dtype, 4, gen, misaligned)
    o, lse = attn.flash_attention_reference(q, k, v, causal, window)
    delta = (do.float() * o.float()).sum(-1)
    if lse_grad:
        delta = delta - torch.randn(shape[:3], generator=gen,
                                    device="cuda")
    return q, k, v, do, lse, delta


def check_backward(torch, attn):
    """Phase 3: dQ and dK/dV against their plain versions."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cases = [((1, s, 8, 64), "bfloat16", True, 0, False, s == 200)
             for s in (16, 200, 512, 2048)]
    cases += [((2, 200, 4, 32), "float32", False, 0, False, False),
              ((1, 300, 4, 64), "float32", True, 64, False, True),
              ((1, 2048, 8, 64), "bfloat16", True, 256, False, False)]
    cases += [case + (True,) for case in BF16_TC_CASES + HEAD_DIM_CASES]
    results = []
    kernels = (attn.flash_bwd_dq, attn.flash_bwd_dkv)
    for shape, dtype, causal, window, misaligned, lse_grad in cases:
        dtype = getattr(torch, dtype)
        args = bwd_inputs(torch, attn, shape, dtype, causal, window, gen,
                          lse_grad, misaligned)
        # The route of what the wrapper hands the kernels (padded to kd).
        kd, _ = attn.head_dim_route(shape[3])
        handed = attn._padded(kd, *args[:4])
        route = attn.kernel_route(kd, *handed)
        hopper, want = hopper_route(torch, attn, dtype, kd, handed)
        hopper0 = [kern.hopper_launches for kern in kernels]
        dq = attn.flash_bwd_dq(*args, causal, window)
        dk, dv = attn.flash_bwd_dkv(*args, causal, window)
        torch.cuda.synchronize()
        rq = attn.flash_attention_dq_reference(*args, causal, window)
        rk, rv = attn.flash_attention_dkv_reference(*args, causal, window)
        case = dict(shape=list(shape), dtype=str(dtype), causal=causal,
                    window=window, rows_aligned=attn.rows_aligned(*args[:4]),
                    tma_rows=attn.tma_rows(*args[:4]),
                    head_dim_route=attn.head_dim_route(shape[3]),
                    route=route, hopper_launches=[
                        kern.hopper_launches - n
                        for kern, n in zip(kernels, hopper0)],
                    lse_cotangent=lse_grad)
        ok = (case["hopper_launches"] == [int(hopper)] * 2
              and (dtype != torch.bfloat16 or route == want))
        for name, got, want in (("dq", dq, rq), ("dk", dk, rk),
                                ("dv", dv, rv)):
            err, tol = near(got, want, str(dtype))
            case[f"err_{name}"], case[f"tol_{name}"] = err, tol
            ok = ok and err <= tol
        log("flash bwd check", json.dumps(case))
        if not ok:
            raise AssertionError(f"flash backward kernel disagrees: {case}")
        results.append(case)
    return results


def check_repeat(torch, attn):
    """Phase 3: the tensor-core kernels (bf16 flash forward, dQ, dK/dV)
    at the training shape (two consumer warpgroups a block), at the
    serving prefill's [1, 1920, 8, 64] (one) and at D 256 (the wide
    kernels), launched twice on the same inputs, give bitwise-equal
    outputs (each output tile has one owner block and there are no
    atomics)."""
    heads, d = MODEL["num_heads"], MODEL["embed_dim"] // MODEL["num_heads"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    out = {}
    for shape in ((TRAIN_BATCH, TRAIN_SEQ, heads, d), (1, 1920, heads, d),
                  (2, 1000, 4, 256)):
        args = bwd_inputs(torch, attn, shape, torch.bfloat16, True, 0, gen,
                          True)
        for name, run in (
                ("flash_fwd",
                 lambda: attn.flash_fwd.launch(*args[:3], True, 0)),
                ("flash_bwd_dq",
                 lambda: attn.flash_bwd_dq.launch(*args, True, 0)),
                ("flash_bwd_dkv",
                 lambda: attn.flash_bwd_dkv.launch(*args, True, 0))):
            first, second = run(), run()
            torch.cuda.synchronize()
            out[f"{name} {list(shape)}"] = all(
                torch.equal(a, b) for a, b in zip(first, second))
    log("bitwise repeat:", json.dumps(out))
    if not all(out.values()):
        raise AssertionError(f"two launches on the same inputs differ: {out}")
    return out


# The grid's sequence limit: one causal W 64 forward at S 4 194 368
# (65 537 row tiles of 64, past the 65 535 a grid.y takes), [1, S, 1, 8]
# bf16. With the band, row p sees keys (p - 64, p] alone, so the last
# 1000 rows equal the plain version on the last W + 1000 positions.
LONG_SEQ = 4194368
LONG_WINDOW = 64
LONG_ROWS = 1000


def check_long_sequence(torch, attn):
    """Phase 3: the forward past the old 65 535-tile limit (above)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    q, k, v = attn_operands(torch, (1, LONG_SEQ, 1, 8), torch.bfloat16, 3,
                            gen)
    before = attn.flash_fwd.launches
    o, lse = attn.flash_attention_lse(q, k, v, causal=True,
                                      window=LONG_WINDOW)
    torch.cuda.synchronize()
    tail = LONG_WINDOW + LONG_ROWS
    ro, rl = attn.flash_attention_reference(
        q[:, -tail:], k[:, -tail:], v[:, -tail:], True, LONG_WINDOW)
    tol = TOL["torch.bfloat16"]
    out = dict(shape=[1, LONG_SEQ, 1, 8], window=LONG_WINDOW,
               tiles=-(-LONG_SEQ // 64), rows_checked=LONG_ROWS,
               launches=attn.flash_fwd.launches - before,
               err_o=(o[:, -LONG_ROWS:].float()
                      - ro[:, -LONG_ROWS:].float()).abs().max().item(),
               err_lse=(lse[:, -LONG_ROWS:]
                        - rl[:, -LONG_ROWS:]).abs().max().item(),
               finite=bool(torch.isfinite(o.float()).all()), tol=tol)
    log("long sequence:", json.dumps(out))
    if not (out["launches"] == 1 and out["finite"] and out["err_o"] <= tol
            and out["err_lse"] <= tol):
        raise AssertionError(f"the forward at S {LONG_SEQ}: {out}")
    del q, k, v, o, lse
    torch.cuda.empty_cache()
    return out


def kernel_key(symbol):
    """A kernel's short name from its mangled or demangled symbol:
    "flash_bwd_dq_tc_kernel<64>", "flash_fwd_wgmma_tc_kernel<64,2>",
    "xent_fwd_kernel f32"; None for a function that is not one of the
    port's kernels."""
    # Mangled: ...22flash_bwd_dq_tc_kernelILi64EE...,
    # ...25flash_fwd_wgmma_tc_kernelILi64ELi2EE...; demangled:
    # ...::flash_bwd_dq_tc_kernel<64>(...), <64, 2>.
    name = re.search(r"(?:\d|::)((?:flash|xent)_\w+?_kernel)", symbol)
    if name is None:
        return None
    key = name.group(1)
    args = re.search(r"I((?:Li\d+E)+)E|<(\d+(?:, *\d+)*)>", symbol)
    if args:
        ints = re.findall(r"\d+", args.group(1).replace("Li", " ")
                          if args.group(1) else args.group(2))
        key += f"<{','.join(ints)}>"
    if "bfloat16" in symbol:
        key += " bf16"
    elif "kernelIf" in symbol or "<float" in symbol:
        key += " f32"
    return key


def ptxas_report(compiler):
    """Registers and spilled bytes of each kernel from the build's
    ``-Xptxas -v`` output: {"flash_bwd_dq_tc_kernel<64>": {"registers":
    n, "spill_bytes": n}, ...} (a library that was already built has
    no output and adds nothing). Fails if a tensor-core kernel
    (``*_tc_kernel``, the wgmma kernels included) spills, if ptxas
    serialized wgmma instructions ("Potential Performance Loss") or
    ignored a setmaxnreg, or if a flash library was compiled and none
    of its tensor-core kernels is in the output."""
    report = {}
    serialized, ignored = [], []
    for lib, text in sorted(compiler.items()):
        key = None
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                key = kernel_key(entry.group(1))
                if key:
                    report[key] = {}
                continue
            serial = re.search(r"wgmma\.mma_async instructions are "
                               r"serialized.*?'(\w+)'", line)
            if serial or "wgmma.mma_async instructions are serialized" in line:
                where = kernel_key(serial.group(1)) if serial else key
                serialized.append(f"{where}: {line.strip()}")
            if "setmaxnreg ignored" in line:
                ignored.append(f"{key}: {line.strip()}")
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if key and spill:
                report[key]["spill_bytes"] = (int(spill.group(1))
                                              + int(spill.group(2)))
            if key and regs:
                report[key]["registers"] = int(regs.group(1))
        if text and lib.startswith("flash") and not any(
                k.startswith(lib) and "_tc_kernel" in k for k in report):
            raise AssertionError(f"no tensor-core kernel in {lib}'s "
                                 f"ptxas output:\n{text}")
    log("registers and spills (ptxas -v):", json.dumps(report))
    # The D 256 Hopper kernels of each library compiled in this run
    # (k[:9]: "flash_fwd" or "flash_bwd").
    wide = {k: report.get(k) for k in WIDE_WGMMA if compiler.get(k[:9])}
    log("D 256 Hopper kernels (ptxas -v):", json.dumps(wide))
    if any(v is None for v in wide.values()):
        raise AssertionError(f"D 256 Hopper kernels missing from ptxas's "
                             f"output: {wide}")
    spills = {k: v for k, v in report.items()
              if "_tc_kernel" in k and v.get("spill_bytes", 1)}
    if spills:
        raise AssertionError(f"tensor-core kernels spill (or ptxas "
                             f"reported no spill line): {spills}")
    if serialized or ignored:
        raise AssertionError(
            "ptxas serialized wgmma or ignored setmaxnreg:\n"
            + "\n".join(serialized + ignored))
    return report


# The Hopper kernels (wgmma, TMA) each flash library must hold.
WGMMA_KERNELS = {"flash_fwd": ("flash_fwd_wgmma_tc_kernel",),
                 "flash_bwd": ("flash_bwd_dkv_wgmma_tc_kernel",
                               "flash_bwd_dq_wgmma_tc_kernel")}
# Their instantiations at kernel head dims 136-256 (DMAX 256).
WIDE_WGMMA = ("flash_fwd_wgmma_tc_kernel<256,2>",
              "flash_bwd_dq_wgmma_tc_kernel<256,1>",
              "flash_bwd_dkv_wgmma_tc_kernel<256,2>")


def tensor_core_counts(build):
    """HMMA and HGMMA instructions in each kernel of the built flash
    libraries, from ``cuobjdump -sass``: {"flash_fwd_tc_kernel<64>":
    {"HMMA": n, "HGMMA": n}, ...}, or None when the toolkit has no
    cuobjdump. Fails if a tensor-core kernel (``*_tc_kernel``) has
    neither, if a wgmma kernel has no HGMMA, or if a flash library
    lacks its wgmma kernels (``WGMMA_KERNELS``)."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = os.path.join(home, "bin", "cuobjdump")
    if not os.path.isfile(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        log("tensor-core count skipped: the CUDA toolkit has no cuobjdump "
            f"(not in {home}/bin nor on PATH)")
        return None
    counts = {}
    for lib in ("flash_fwd", "flash_bwd"):
        sass = subprocess.run([tool, "-sass", str(build.library_path(lib))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        for section in sass.split("Function : ")[1:]:
            key = kernel_key(section.split("\n", 1)[0])
            if key is None:
                continue
            lines = section.splitlines()
            counts[key] = {
                "HMMA": sum(bool(re.search(r"\bHMMA", ln)) for ln in lines),
                "HGMMA": sum("HGMMA" in ln for ln in lines)}
    log("tensor-core instructions (SASS HMMA/HGMMA):", json.dumps(counts))
    tc = {k: n for k, n in counts.items() if "_tc_kernel" in k}
    bad = {k: n for k, n in tc.items()
           if not (n["HGMMA"] if "wgmma" in k else n["HMMA"] + n["HGMMA"])}
    missing = [name for names in WGMMA_KERNELS.values() for name in names
               if not any(k.startswith(name + "<") for k in tc)]
    missing += [key for key in WIDE_WGMMA if key not in tc]
    if not tc or bad or missing:
        raise AssertionError(f"tensor-core kernels without HMMA/HGMMA "
                             f"(wgmma kernels: HGMMA): {bad}; wgmma "
                             f"kernels missing: {missing}; {counts}")
    return counts


def xent_inputs(torch, n, c, gen):
    """f32 logits [n, c] (std 3), labels with rows 0 and 1 outside
    [0, c) (they match no class), and a per-row cotangent."""
    logits = 3 * torch.randn((n, c), generator=gen, device="cuda")
    labels = torch.randint(0, c, (n,), generator=gen, device="cuda")
    labels[0], labels[1] = -1, c + 7
    g = torch.randn((n,), generator=gen, device="cuda")
    return logits, labels, g


# dlogits against its plain version, element by element: |got - want|
# <= DLOGITS_RTOL * (|want| + mean|want|). Almost every entry is a
# softmax term p * g, far below the label's (p - 1) * g, so a bound
# tied to the largest value would pass a softmax that is wrong
# everywhere but at the top. Both sides compute exp(x - max) / sum in f32 and differ by a few f32
# units (~4e-6 relative at most); the floor mean|want| leaves out only
# values far below the row's typical one.
DLOGITS_RTOL = 1e-4


def dlogits_err(got, want):
    """(max |got - want| / (|want| + mean|want|), relative L2 error)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    scaled = (diff / (want.abs() + want.abs().mean())).max().item()
    return scaled, (diff.norm() / want.norm()).item()


def check_xent(torch, xent):
    """Phase 3: the cross-entropy kernels against their plain
    versions: at the training shape and at a ragged C % 4 == 0 shape
    (16-byte loads, 513 float4s a row) and a ragged C % 4 != 0 one
    (scalar loads); at ResNet's logits [128, 1000] (16-byte loads; not
    a multiple of the Pallas kernel's 128 lanes) and MNIST's [256, 10]
    (C % 4 != 0: scalar loads)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    results = []
    for n, c in (((TRAIN_SEQ - 1) * TRAIN_BATCH, MODEL["vocab_size"]),
                 (300, 2052), (200, 333), (RESNET_BATCH, RESNET_CLASSES),
                 (MNIST_BATCH, 10)):
        logits, labels, g = xent_inputs(torch, n, c, gen)
        loss = xent.xent_fwd(logits, labels)
        dlogits = xent.xent_bwd(logits, labels, g)
        torch.cuda.synchronize()
        case = dict(shape=[n, c], dtype="torch.float32")
        err, tol = near(loss, xent.softmax_cross_entropy_reference(
            logits, labels), "torch.float32")
        case["err_loss"], case["tol_loss"] = err, tol
        want = xent.softmax_cross_entropy_bwd_reference(logits, labels, g)
        case["err_dlogits"] = (dlogits - want).abs().max().item()
        case["err_dlogits_scaled"], case["rel_l2_dlogits"] = dlogits_err(
            dlogits, want)
        case["tol_dlogits_scaled"] = DLOGITS_RTOL
        log("xent check", json.dumps(case))
        if not (err <= tol and case["err_dlogits_scaled"] <= DLOGITS_RTOL):
            raise AssertionError(f"xent kernel disagrees: {case}")
        results.append(case)
        del logits, dlogits, want
        torch.cuda.empty_cache()
    return results


def time_flash_kernels(torch, attn, window, gen, shape=None):
    """The flash forward, dQ and dK/dV at q/k/v ``shape`` (default the
    training shape, [8, 2048, 8, 64]) bf16 causal (with the ``window``
    band when > 0): {name: row} with each
    kernel's device time (``graph_ms``) and its time launched back to
    back (``launch_ms``), its plain version's, the library yardstick's
    (never called by the port: SDPA forward, causal or with the band as
    a boolean mask, by graph; its backward for dQ and dK/dV together,
    by graph where the card's torch captures it, else by events over 50
    calls: ``library_timing``), the error, the bound over the kept
    pairs and the mma.sync design's time where one was taken."""
    import torch.nn.functional as F
    heads, d = MODEL["num_heads"], MODEL["embed_dim"] // MODEL["num_heads"]
    shape = tuple(shape or (TRAIN_BATCH, TRAIN_SEQ, heads, d))
    seq = shape[1]
    bf16 = "torch.bfloat16"
    q, k, v, do, lse, delta = bwd_inputs(torch, attn, shape, torch.bfloat16,
                                         True, window, gen, False)
    mask = (dict(attn_mask=attn._keep_mask(seq, window, "cuda"))
            if window else dict(is_causal=True))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, **mask)
    sdpa_g = do.transpose(1, 2)
    sdpa_bwd_ms, sdpa_bwd_timing = sdpa_backward_ms(
        torch, lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), sdpa_g, retain_graph=True))
    rows = {}
    row = dict(shape=list(shape), dtype=bf16, window=window,
               timing="graph")
    row["kernel_ms"] = graph_ms(lambda: attn.flash_fwd.launch(
        q, k, v, True, window), 20)
    row["launch_ms"] = cuda_ms(lambda: attn.flash_fwd.launch(
        q, k, v, True, window), 20)
    row["plain_ms"] = cuda_ms(lambda: attn.flash_attention_reference(
        q, k, v, True, window), 5)
    row["library_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, **mask), 20)
    o, _ = attn.flash_fwd.launch(q, k, v, True, window)
    ro, _ = attn.flash_attention_reference(q, k, v, True, window)
    row["max_abs_err"] = (o.float() - ro.float()).abs().max().item()
    row["bound_ms"], row["bound_by"] = attention_bound_ms(
        *shape, bf16, True, window, "fwd")
    row["mma_sync_ms"] = MMA_SYNC_MS.get(("flash_fwd", shape, window))
    rows["flash_fwd"] = row
    args = (q, k, v, do, lse, delta, True, window)
    for name, kern, plain in (
            ("flash_bwd_dq", attn.flash_bwd_dq,
             attn.flash_attention_dq_reference),
            ("flash_bwd_dkv", attn.flash_bwd_dkv,
             attn.flash_attention_dkv_reference)):
        row = dict(shape=list(shape), dtype=bf16, window=window,
                   timing="graph")
        row["kernel_ms"] = graph_ms(lambda: kern.launch(*args), 20)
        row["launch_ms"] = cuda_ms(lambda: kern.launch(*args), 20)
        row["plain_ms"] = cuda_ms(lambda: plain(*args), 5)
        row["library_ms"] = sdpa_bwd_ms
        row["library_timing"] = sdpa_bwd_timing
        row["library_call"] = ("scaled_dot_product_attention backward "
                               "(dQ, dK and dV together)")
        got, want = kern.launch(*args), plain(*args)
        want = want if isinstance(want, tuple) else (want,)
        row["max_abs_err"] = max((a.float() - b.float()).abs().max().item()
                                 for a, b in zip(got, want))
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            *shape, bf16, True, window, name.split("_")[-1])
        row["mma_sync_ms"] = MMA_SYNC_MS.get((name, shape, window))
        rows[name] = row
    del q, k, v, do, lse, delta, qt, kt, vt, sdpa_out, sdpa_g, o, ro, mask
    torch.cuda.empty_cache()
    return rows


# PERF.md §6's device times at the D <= 128 shapes phase 4 times (NVIDIA
# H100 80GB HBM3, 700 W; before the head-dim routes and the flattened
# grid), beside which phase 4 prints this run's: {(name, shape): ms}.
RECORDED_MS = {("flash_fwd", (8, 2048, 8, 64)): 0.1178,
               ("flash_bwd_dq", (8, 2048, 8, 64)): 0.1683,
               ("flash_bwd_dkv", (8, 2048, 8, 64)): 0.2613,
               ("flash_fwd", (1, 1920, 8, 64)): 0.0272}
# The wide kernels' shape in phase 4: GPT-J-6B's attention (16 heads of
# 256) at batch 4, S 2048.
WIDE_SHAPE = (4, 2048, 16, 256)


def recorded_ratios(report):
    """This run's times at RECORDED_MS's shapes over the recorded ones:
    {"name shape": ratio}."""
    rows = dict(report["train_kernel_times"])
    big = report["flash_times"][-1]
    out = {}
    for (name, shape), ms in RECORDED_MS.items():
        row = rows.get(name)
        if shape == tuple(big["shape"]) and name == "flash_fwd":
            row = big
        if row is not None and tuple(row["shape"]) == shape:
            out[f"{name} {list(shape)}"] = row["kernel_ms"] / ms
    return out


def sdpa_backward_ms(torch, fn):
    """(ms, "graph" | "events"): SDPA's backward ``fn`` by CUDA-graph
    replay of 20 calls, or, where the card's torch cannot capture it
    (torch 2.11 at [8, 2048, 8, 64] causal: the capture is
    invalidated), by events over 50 calls back to back."""
    try:
        return graph_ms(fn, 20), "graph"
    except RuntimeError as err:
        log(f"SDPA backward not captured ({err}); timed by events")
        torch.cuda.synchronize()
        return cuda_ms(fn, 50), "events"


def time_training_kernels(torch, attn, xent):
    """Phase 4 at the training slice's shapes: the flash forward, dQ
    and dK/dV at q/k/v [8, 2048, 8, 64] bf16 causal
    (``time_flash_kernels``), the cross-entropy at logits [16376,
    32000] f32 against F.cross_entropy(reduction="none") and its
    backward."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rows = time_flash_kernels(torch, attn, 0, gen)
    n, c = (TRAIN_SEQ - 1) * TRAIN_BATCH, MODEL["vocab_size"]
    rows.update(time_xent(torch, xent, n, c, gen, 20))
    # The next-token objective's copy of logits[:, :-1] (a view that
    # does not merge to [N, V]), timed alone at the slice's shape.
    full = torch.randn((TRAIN_BATCH, TRAIN_SEQ, c), generator=gen,
                       device="cuda")
    rows["logits_copy_ms"] = cuda_ms(
        lambda: full[:, :-1].reshape(-1, c), 20)
    del full
    torch.cuda.empty_cache()
    for name, row in rows.items():
        log("train kernel time", name, json.dumps(row))
    return rows


def time_xent(torch, xent, n, c, gen, iters):
    """The cross-entropy kernels on f32 logits [n, c]: {"xent_fwd":
    row, "xent_bwd": row}, each with the kernel's time over ``iters``
    launches, its plain version's (over a quarter as many), one
    library call's (F.cross_entropy, reduction none; its autograd
    backward), the error and the bound."""
    import torch.nn.functional as F
    logits, labels, g = xent_inputs(torch, n, c, gen)
    lib_logits = logits.detach().requires_grad_()
    lib_loss = F.cross_entropy(lib_logits, labels.clamp(0, c - 1),
                               reduction="none")
    rows = {}
    for name, launch, plain, lib, role in (
            ("xent_fwd", lambda: xent.xent_fwd.launch(logits, labels),
             lambda: xent.softmax_cross_entropy_reference(logits, labels),
             lambda: F.cross_entropy(logits, labels.clamp(0, c - 1),
                                     reduction="none"), "fwd"),
            ("xent_bwd", lambda: xent.xent_bwd.launch(logits, labels, g),
             lambda: xent.softmax_cross_entropy_bwd_reference(
                 logits, labels, g),
             lambda: torch.autograd.grad(lib_loss, lib_logits, g,
                                         retain_graph=True), "bwd")):
        row = dict(shape=[n, c], dtype="torch.float32")
        row["kernel_ms"] = cuda_ms(launch, iters)
        row["plain_ms"] = cuda_ms(plain, max(5, iters // 4))
        row["library_ms"] = cuda_ms(lib, iters)
        row["max_abs_err"] = (launch().float() - plain().float()).abs(
        ).max().item()
        row["bound_ms"], row["bound_by"] = xent_bound_ms(n, c, role)
        rows[name] = row
    del logits, lib_logits, lib_loss
    torch.cuda.empty_cache()
    return rows


def time_image_xent(torch, xent):
    """Phase 4 at ResNet-50's logits [128, 1000] f32 (a few µs a
    launch, so 200 launches back to back)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rows = time_xent(torch, xent, RESNET_BATCH, RESNET_CLASSES, gen, 200)
    for name, row in rows.items():
        log("image kernel time", name, json.dumps(row))
    return rows


def post(port, payload, timeout=600):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/lm:generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read())


def drive_server(server, rng):
    """Phase 5's traffic. Returns (greedy [(prompt, new, sequence)],
    summary dict). Every response is checked for status, length and
    token range here."""
    port, vocab = server.port, MODEL["vocab_size"]
    greedy = []
    summary = {"requests": 0, "tokens": 0, "ttft_ms": []}

    def run(payload):
        t0 = time.perf_counter()
        status, body = post(port, payload)
        dt = time.perf_counter() - t0
        if status != 200:
            raise AssertionError(f"status {status}: {body}")
        p_len, new = len(payload["prompts"][0]), payload["max_new_tokens"]
        for seq in body["sequences"]:
            if len(seq) != p_len + new or not all(
                    0 <= t < vocab for t in seq):
                raise AssertionError(
                    f"bad sequence: len {len(seq)} != {p_len + new}")
        summary["requests"] += 1
        summary["tokens"] += new * len(body["sequences"])
        return body, dt

    def prompt(n):
        return rng.integers(0, vocab, n).tolist()

    # Greedy, one request at a time, in several buckets (1920 = the
    # largest bucket, max_seq_len - max_new_tokens). A one-token
    # request times the admission alone (time to first token).
    for n, new in ((16, 1), (16, 64), (100, 64), (700, 32),
                   (1920, MAX_NEW)):
        p = prompt(n)
        body, dt = run({"prompts": [p], "max_new_tokens": new})
        greedy.append((p, new, body["sequences"][0]))
        if new == 1:
            summary["ttft_ms"].append(1e3 * dt)
    # Concurrent requests: 8 clients at once (slots batch), one of them
    # a multi-prompt request, one asking for logprobs.
    payloads = [{"prompts": [prompt(n)], "max_new_tokens": MAX_NEW}
                for n in (16, 32, 64, 128, 200, 300)]
    payloads.append({"prompts": [prompt(48), prompt(48)],
                     "max_new_tokens": 96})
    payloads.append({"prompts": [prompt(40)], "max_new_tokens": 64,
                     "logprobs": True})
    results = [None] * len(payloads)
    errors = []

    def client(i):
        try:
            results[i] = run(payloads[i])
        except Exception as e:  # reported below, fails the run
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent requests failed: {errors}")
    batch_tokens = sum(p["max_new_tokens"] * len(p["prompts"])
                       for p in payloads)
    summary["concurrent_tokens_per_s"] = batch_tokens / wall
    summary["concurrent_wall_s"] = wall
    for pay, (body, _) in zip(payloads, results):
        if "logprobs" in body:
            lps = body["logprobs"][0]
            if len(lps) != len(pay["prompts"][0]) + pay["max_new_tokens"] \
                    or not all(x <= 1e-6 for x in lps):
                raise AssertionError("bad logprobs row")
        for p, seq in zip(pay["prompts"], body["sequences"]):
            greedy.append((p, pay["max_new_tokens"], seq))
    # One sampled request.
    run({"prompts": [prompt(64)], "max_new_tokens": 32,
         "temperature": 0.8, "top_k": 50, "top_p": 0.9})
    return greedy, summary


def time_engine(torch, engine, rng):
    """Host-clock times of the engine's two operations at full width,
    each ending in a device sync (admit and step copy their results to
    the host): one admission prefill per bucket width, and one decode
    step with every slot active. Returns {"prefill_ms": {width: ms},
    "step_ms": ms}."""
    vocab = MODEL["vocab_size"]
    out = {"prefill_ms": {}}
    for width in (16, 128, 1024, 1920):
        times = []
        for _ in range(4):
            row = rng.integers(0, vocab, width)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slot = engine.admit(row, width)[0]
            times.append(1e3 * (time.perf_counter() - t0))
            engine.release(slot)
        out["prefill_ms"][width] = min(times[1:])
    slots = [engine.admit(rng.integers(0, vocab, 16), 16)[0]
             for _ in range(engine.slots)]
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 20
    for _ in range(steps):
        engine.step()
    out["step_ms"] = 1e3 * (time.perf_counter() - t0) / steps
    for slot in slots:
        engine.release(slot)
    return out


def drive_paged_server(server, rng):
    """The paged phase's traffic through the HTTP server: the system
    prompt alone, then 8 concurrent requests of prefix + a distinct
    3-30-token suffix (totals not block-aligned; the boundary block
    forks), then 4 cold prompts of 100-700 tokens, then the prefix
    again once every row is released. Returns (greedy [(prompt, new,
    sequence)], the system prompt)."""
    port, vocab = server.port, MODEL["vocab_size"]
    prefix = rng.integers(0, vocab, PAGED_PREFIX).tolist()
    greedy = []

    def run(prompt, new):
        status, body = post(port, {"prompts": [prompt],
                                   "max_new_tokens": new})
        seq = body.get("sequences", [[]])[0]
        if status != 200 or len(seq) != len(prompt) + new or not all(
                0 <= t < vocab for t in seq):
            raise AssertionError(f"bad response {status}: {body}")
        greedy.append((prompt, new, seq))

    run(prefix, PAGED_NEW)
    suffixes = 3 + rng.permutation(28)[:8]
    errors = []

    def client(n):
        try:
            run(prefix + rng_suffix[n], PAGED_NEW)
        except Exception as e:  # reported below, fails the run
            errors.append(repr(e))

    rng_suffix = {int(n): rng.integers(0, vocab, int(n)).tolist()
                  for n in suffixes}
    threads = [threading.Thread(target=client, args=(int(n),))
               for n in suffixes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent paged requests failed: {errors}")
    for n in rng.integers(PAGED_COLD[0], PAGED_COLD[1] + 1, 4):
        run(rng.integers(0, vocab, int(n)).tolist(), PAGED_NEW)
    run(prefix, PAGED_NEW)
    return greedy, prefix


def stream_divergence(torch, model, prompt, new, seq, wants=None):
    """None when ``seq`` equals greedy_decode's stream, else where it
    first differs and the oracle's margin there: the gap between its
    top two logits against 2e-2 of its largest logit (the logits of
    greedy_decode's own path, fed its own tokens up to that point).
    ``wants`` caches the oracle's streams by (prompt, new)."""
    from container_engine_accelerators_tpu_torch.models.decode import (
        greedy_decode,
        logits_of,
    )
    key = (tuple(prompt), new)
    want = None if wants is None else wants.get(key)
    if want is None:
        want = greedy_decode(model, torch.tensor([prompt],
                                                 device=model.device),
                             new)[0].tolist()
        if wants is not None:
            wants[key] = want
    if want == seq:
        return None
    first = next(i for i, (a, b) in enumerate(zip(want, seq)) if a != b)
    p = len(prompt)
    with torch.inference_mode():
        cache = model.init_cache(1, len(want))
        logits = logits_of(model(torch.tensor([prompt], device=model.device),
                                 cache, 0))[0, -1]
        for t in range(p, first):
            logits = logits_of(model(torch.tensor([[want[t]]],
                                                  device=model.device),
                                     cache, t))[0, 0]
    top = logits.float().topk(2).values
    gap = (top[0] - top[1]).item()
    limit = 2e-2 * logits.float().abs().max().item()
    return dict(prompt_len=p, first_diff=first - p, top2_gap=gap,
                limit=limit, near_tie=gap <= limit)


def spill_round_trip(torch, model, rng):
    """An engine whose arena holds one row (128 usable blocks): admit
    the 1000-token prefix and snapshot its blocks, churn two other
    prompts through the arena until the prefix's blocks are reused
    (spilled to the host tier), admit the prefix again: its blocks must
    come back bitwise (the full blocks, and the boundary block's rows
    below the re-prefilled last token). Returns a summary with the
    rehydrate's time."""
    from container_engine_accelerators_tpu_torch.models.decode import (
        SlotDecodeEngine,
    )
    bs = 16
    eng = SlotDecodeEngine(model, 1, MODEL["max_seq_len"], paged=True,
                           kv_block_size=bs,
                           kv_blocks=MODEL["max_seq_len"] // bs + 1,
                           kv_spill=True)
    vocab = MODEL["vocab_size"]
    prefix = rng.integers(0, vocab, PAGED_PREFIX)
    full = PAGED_PREFIX // bs

    def blocks(slot, n):
        ids = torch.as_tensor(eng._tables[slot, :n], device="cuda")
        return torch.stack([a[ids] for layer in eng._cache for a in layer])

    slot = eng.admit(prefix, PAGED_PREFIX, max_new=8)[0]
    snap = blocks(slot, full + 1)
    eng.release(slot)
    churned = 0
    while eng.kv_block_stats()["kv_spill_blocks"] == 0 and churned < 4:
        eng.release(eng.admit(rng.integers(0, vocab, PAGED_PREFIX),
                              PAGED_PREFIX, max_new=8)[0])
        churned += 1
    spilled = eng.kv_block_stats()["kv_spill_blocks"]
    slot = eng.admit(prefix, PAGED_PREFIX, max_new=8)[0]
    back = blocks(slot, full + 1)
    stats = eng.kv_block_stats()
    tail = PAGED_PREFIX - full * bs - 1     # boundary rows kept as copied
    out = dict(churned=churned, spill_blocks=spilled,
               rehydrated_blocks=stats["kv_rehydrated_blocks"],
               spill_hits=stats["kv_spill_hits"],
               full_blocks_equal=bool(torch.equal(back[:, :full],
                                                  snap[:, :full])),
               boundary_rows_equal=bool(torch.equal(
                   back[:, full, :tail], snap[:, full, :tail])),
               rehydrate_ms=[1e3 * t for t in eng.drain_rehydrate_events()])
    eng.release(slot)
    out["leaks"] = eng.pool_leak_report()
    log("spill round trip:", json.dumps(out))
    if not (spilled and out["rehydrated_blocks"] > 0
            and out["full_blocks_equal"] and out["boundary_rows_equal"]
            and out["leaks"] is None):
        raise AssertionError(f"spill round trip failed: {out}")
    del eng, snap, back
    torch.cuda.empty_cache()
    return out


def time_paged(torch, paged, dense, rng):
    """Host-clock times (each ending in a device sync) on the paged
    engine against the dense one: one decode step with 8 rows of 16
    tokens active, each pool twice in turns (dense, paged, paged,
    dense); the admission of a 1003-token prompt cold (width 1024)
    and on a hit of a resident 1000-token prefix (width 16): the
    least of the last three of four."""
    import numpy as np
    vocab = MODEL["vocab_size"]

    def step_ms(eng):
        slots = [eng.admit(rng.integers(0, vocab, 16), 16)[0]
                 for _ in range(eng.slots)]
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            eng.step()
        ms = 1e3 * (time.perf_counter() - t0) / 20
        for slot in slots:
            eng.release(slot)
        return ms

    out = {"step_ms": {"dense": [], "paged": []}}
    for eng, name in ((dense, "dense"), (paged, "paged"), (paged, "paged"),
                      (dense, "dense")):
        out["step_ms"][name].append(step_ms(eng))

    def admit_ms(row):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slot = paged.admit(row, len(row), max_new=8)[0]
        ms = 1e3 * (time.perf_counter() - t0)
        paged.release(slot)
        return ms

    prefix = rng.integers(0, vocab, PAGED_PREFIX)
    cold = [admit_ms(rng.integers(0, vocab, PAGED_PREFIX + 3))
            for _ in range(4)]
    admit_ms(prefix)
    hit = [admit_ms(np.concatenate([prefix, rng.integers(0, vocab, 3)]))
           for _ in range(4)]
    out["prefill_prompt_len"] = PAGED_PREFIX + 3
    out["prefill_cold_ms"], out["prefill_hit_ms"] = min(cold[1:]), min(hit[1:])
    out["prefill_cold_all_ms"], out["prefill_hit_all_ms"] = cold, hit
    log("paged times:", json.dumps(out))
    return out


def drive_paged(torch, model, engine_dense, kernels, rng):
    """The paged phase (see the module docstring): the server's default
    pool at full width, with every launch count set to 0 just before
    the traffic and read just after. Returns (report, launches)."""
    from container_engine_accelerators_tpu_torch.serving.server import (
        GenerationServer,
    )
    server = GenerationServer("lm", model, port=0, max_new_tokens=MAX_NEW,
                              max_batch=MAX_BATCH, host="127.0.0.1")
    eng = server.engine
    if not eng.paged:
        raise AssertionError("the server's default pool is not paged")
    server.start()
    try:
        widths0 = dict(eng.prefill_widths)
        for kern in kernels:
            kern.launches = 0
        greedy, _ = drive_paged_server(server, rng)
        launches = {kern.name: kern.launches for kern in kernels}
        stats = get(server.port, "/stats")
    finally:
        server.stop()
    leaks = eng.pool_leak_report()
    widths = {w: n - widths0.get(w, 0) for w, n in eng.prefill_widths.items()
              if n != widths0.get(w, 0)}
    narrow = sum(n for w, n in widths.items() if w <= 32)
    report = dict(stats=stats, widths=widths, leaks=leaks,
                  launches=launches, arena_bytes=eng.kv_arena_bytes)
    log("paged server:", json.dumps(report))
    if stats["kv_pool"] != "paged" or stats["prefix_hits"] < 8:
        raise AssertionError(f"paged server: {stats}")
    if narrow != stats["prefix_hits"]:
        raise AssertionError(f"hit rows admitted wider than 32: {widths}, "
                             f"{stats['prefix_hits']} hits")
    if any(launches.values()):
        raise AssertionError(f"the paged pool launched kernels: {launches}")
    if leaks is not None:
        raise AssertionError(f"paged pool not clean when idle: {leaks}")
    diverged = []
    for p, new, seq in greedy:
        d = stream_divergence(torch, model, p, new, seq)
        if d is not None:
            diverged.append(d)
    report["greedy_checked"] = len(greedy)
    report["greedy_exact"] = len(greedy) - len(diverged)
    report["greedy_diverged"] = diverged
    log(f"paged greedy: {report['greedy_exact']} of {len(greedy)} streams "
        f"equal greedy_decode; diverged {diverged}")
    if not all(d["near_tie"] for d in diverged):
        raise AssertionError(f"paged streams diverge off a near tie: "
                             f"{diverged}")
    report["spill"] = spill_round_trip(torch, model, rng)
    report["times"] = time_paged(torch, eng, engine_dense, rng)
    report["times"]["rehydrate_ms"] = report["spill"]["rehydrate_ms"]
    return report, launches


def manifest_argv(path=MANIFEST):
    """The serving container's arguments in a deployment manifest
    (lm-serving.yaml unless ``path`` names another; after the
    interpreter and the script), read as plain text: the "- " items
    under the first "command:" key, comments skipped."""
    args, indent = [], None
    with open(path) as f:
        for line in f:
            stripped = line.strip()
            depth = len(line) - len(line.lstrip())
            if indent is None:
                if stripped == "command:":
                    indent = depth
                continue
            if not stripped or stripped.startswith("#"):
                continue
            if depth < indent or not stripped.startswith("- "):
                break
            args.append(stripped[2:].strip())
    if args[:2] != ["python3", "/demos/serving/serve.py"]:
        raise AssertionError(f"unexpected command in {path}: {args}")
    return args[2:]


def healthz(port):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def launch_deployed(serve, paged=True, argv=None):
    """The port's launcher on ``argv`` (default the manifest's arguments
    and --port=0; CEA_TPU_PAGED_KV=0 while it builds when not
    ``paged``); polls /healthz from the first moment until warm-up is
    done. Returns (server, {"health": first codes, "ready_s": launch to
    200})."""
    t0 = time.perf_counter()
    if argv is None:
        argv = manifest_argv() + ["--port=0"]
    if not paged:
        os.environ["CEA_TPU_PAGED_KV"] = "0"
    try:
        server = serve.build_server(serve.build_parser().parse_args(argv))
    finally:
        os.environ.pop("CEA_TPU_PAGED_KV", None)
    server.start()
    codes = []
    while True:
        codes.append(healthz(server.port))
        if codes[-1] == 200:
            break
        if codes[-1] != 503 or time.perf_counter() - t0 > 600:
            server.stop()
            raise AssertionError(f"/healthz during warm-up: {codes[-20:]}")
        time.sleep(0.02)
    return server, {"health_503": len(codes) - 1, "health_first": codes[0],
                    "ready_s": time.perf_counter() - t0,
                    "warm_s": server.warm_seconds}


def post_stream(port, payload):
    """(Content-Type, ndjson lines) of a streamed request."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/lm:generate",
        data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=600) as resp:
        return (resp.headers["Content-Type"],
                [json.loads(line) for line in resp.read().splitlines()])


def run_load_generator(port, stream):
    """demo/serving/load_generator.py --mode generate against the
    server (16 requests, 4 clients, 32 new tokens), in its own process;
    returns its summary line."""
    argv = [sys.executable, os.path.join(REPO_ROOT, "demo", "serving",
                                         "load_generator.py"),
            "--mode", "generate", "--model-name", "lm", "--host",
            "127.0.0.1", "--port", str(port), "-n", "16", "--parallelism",
            "4", "--max-new-tokens", str(DEPLOY_NEW), "--vocab-size",
            str(MODEL["vocab_size"])]
    out = subprocess.run(argv + (["--stream"] if stream else []),
                         capture_output=True, text=True, check=True,
                         timeout=600)
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    if summary["requests"] != 16 or summary["errors"]:
        raise AssertionError(f"load generator: {summary}")
    return summary


def drive_deployed_traffic(server, rng):
    """Text, token-id and ndjson-stream requests on the deployed server.
    Returns (greedy [(prompt ids, new, sequence)], summary)."""
    port, vocab = server.port, MODEL["vocab_size"]
    greedy, summary = [], {}
    texts = ["The quick brown fox jumps over the lazy dog.",
             "Kubernetes schedules pods onto nodes with accelerators: "
             "naïve placement fragments a slice."]
    status, body = post(port, {"text": texts, "max_new_tokens": DEPLOY_NEW})
    ids = [list(t.encode("utf-8")) for t in texts]
    if (status != 200 or len(body["completions"]) != 2
            or not all(isinstance(c, str) for c in body["completions"])):
        raise AssertionError(f"text request: {status} {body}")
    for row, seq in zip(ids, body["sequences"]):
        if seq[:len(row)] != row or len(seq) != len(row) + DEPLOY_NEW:
            raise AssertionError("text request: bad sequence")
        greedy.append((row, DEPLOY_NEW, seq))
    summary["completions"] = body["completions"]
    prompts = [rng.integers(0, vocab, n).tolist() for n in DEPLOY_PROMPTS]
    results, errors = [None] * len(prompts), []

    def client(i):
        try:
            results[i] = post(port, {"prompts": [prompts[i]],
                                     "max_new_tokens": DEPLOY_NEW})
        except Exception as e:  # reported below, fails the run
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent deployed requests failed: {errors}")
    for p, (status, body) in zip(prompts, results):
        seq = body["sequences"][0]
        if status != 200 or len(seq) != len(p) + DEPLOY_NEW or not all(
                0 <= t < vocab for t in seq):
            raise AssertionError(f"bad response {status}: {body}")
        greedy.append((p, DEPLOY_NEW, seq))
    # The stream of a greedy request against the same request unstreamed.
    p = rng.integers(0, vocab, 64).tolist()
    status, body = post(port, {"prompts": [p], "max_new_tokens": DEPLOY_NEW})
    want = body["sequences"][0][len(p):]
    kind, lines = post_stream(port, {"prompts": [p], "stream": True,
                                     "max_new_tokens": DEPLOY_NEW})
    got = [line["tokens"][0] for line in lines[:-1]]
    if (kind != "application/x-ndjson" or lines[-1] != {"done": True}
            or got != want):
        raise AssertionError(f"stream differs: {kind} {got} != {want}, "
                             f"last {lines[-1]}")
    greedy.append((p, DEPLOY_NEW, body["sequences"][0]))
    _, lines = post_stream(port, {"text": [texts[0]], "stream": True,
                                  "max_new_tokens": 8})
    if lines[-1] != {"done": True} or not all(
            "completion_delta" in line for line in lines[:-1]):
        raise AssertionError(f"text stream: {lines}")
    summary["stream_tokens"] = len(got)
    summary["load_generator"] = run_load_generator(port, stream=False)
    summary["load_generator_stream"] = run_load_generator(port, stream=True)
    return greedy, summary


def quant_layout(torch, model):
    """Bytes of the model's projection weights (int8 values and f32
    scales, or the native weights) and their parameter count."""
    from container_engine_accelerators_tpu_torch.models.quantized import (
        Int8Linear,
    )
    names = ("qkv", "q", "kv", "proj", "mlp_in", "mlp_out")
    out = {"params": 0, "weight_bytes": 0, "scale_bytes": 0}
    for name, mod in model.named_modules():
        if name.rsplit(".", 1)[-1] not in names:
            continue
        out["params"] += mod.weight.numel()
        out["weight_bytes"] += mod.weight.numel() * mod.weight.element_size()
        if isinstance(mod, Int8Linear):
            out["scale_bytes"] += mod.scale.numel() * 4
    return out


def arena_sizes(torch, decode, model_bf16):
    """Usable blocks and arena bytes of the paged pool (8 slots of
    2048, block 16) at equal memory: the engine asked for bf16, int8
    and int4 on the bf16-cache model."""
    out = {}
    for mode in ("bf16", "int8", "int4"):
        eng = decode.SlotDecodeEngine(model_bf16, MAX_BATCH,
                                      MODEL["max_seq_len"], paged=True,
                                      kv_block_size=16, kv_quant=mode)
        out[mode] = {"usable_blocks": eng._pool.usable,
                     "arena_bytes": eng.kv_arena_bytes}
        del eng
    torch.cuda.empty_cache()
    return out


def int4_engine_run(torch, decode, model, rng):
    """An engine-level int4 run (the paged pool, 4 slots, kv_quant int4
    on the bf16 model): three greedy requests (16, 100 and 700 tokens)
    admitted and stepped
    together; each stream against greedy_decode with an int4 cache
    (informational: the paged prefill attends the quantized prompt,
    the oracle's prefill the raw one)."""
    eng = decode.SlotDecodeEngine(model, 4, MODEL["max_seq_len"], paged=True,
                                  kv_block_size=16, kv_quant="int4")
    vocab = MODEL["vocab_size"]
    prompts = [rng.integers(0, vocab, n).tolist()
               for n in DEPLOY_PROMPTS[:3]]
    rows = {}
    for p in prompts:
        slot, first, _, _ = eng.admit(p, len(p), max_new=DEPLOY_NEW)
        rows[slot] = [first]
    for _ in range(DEPLOY_NEW - 1):
        toks, _ = eng.step()
        for slot, out in rows.items():
            out.append(int(toks[slot]))
    for slot in rows:
        eng.release(slot)
    out = {"leaks": eng.pool_leak_report(), "usable_blocks": eng._pool.usable,
           "exact": 0, "diverged": []}
    for p, (slot, toks) in zip(prompts, rows.items()):
        if not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"int4 engine: bad tokens {toks}")
        want = decode.greedy_decode(model, torch.tensor([p]), DEPLOY_NEW,
                                    kv_quant="int4")[0, len(p):]
        want = want.tolist()
        if want == toks:
            out["exact"] += 1
        else:
            out["diverged"].append(next(
                i for i, (a, b) in enumerate(zip(want, toks)) if a != b))
    if out["leaks"] is not None:
        raise AssertionError(f"int4 engine not clean: {out['leaks']}")
    del eng
    torch.cuda.empty_cache()
    return out


def time_deployment(torch, decode, deployed, dense_int8, model_bf16,
                    dense_bf16, rng):
    """Host-clock times in turns within this call: the paged decode step
    with 8 rows of 16 tokens (bf16 model and cache; bf16 model, int8
    cache; the deployed int8 weights and cache: A B C C B A), the dense
    admission at 16/128/1024/1920 tokens on the bf16 and the int8
    model (least of the last three of four, bf16 int8 int8 bf16), and
    one projection at decode width (8 rows, mlp_in 512 -> 2048) as
    Int8Linear and as the bf16 Linear (CUDA events)."""
    vocab = MODEL["vocab_size"]

    def step_ms(eng):
        slots = [eng.admit(rng.integers(0, vocab, 16), 16)[0]
                 for _ in range(eng.slots)]
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            eng.step()
        ms = 1e3 * (time.perf_counter() - t0) / 20
        for slot in slots:
            eng.release(slot)
        return ms

    kv8 = decode.SlotDecodeEngine(model_bf16, MAX_BATCH, MODEL["max_seq_len"],
                                  paged=True, kv_quant="int8")
    bf16 = decode.SlotDecodeEngine(model_bf16, MAX_BATCH,
                                   MODEL["max_seq_len"], paged=True)
    engines = {"bf16": bf16, "int8_kv": kv8, "deployed": deployed}
    out = {"step_ms": {k: [] for k in engines}}
    for name in ("bf16", "int8_kv", "deployed", "deployed", "int8_kv",
                 "bf16"):
        out["step_ms"][name].append(step_ms(engines[name]))
    del kv8, bf16, engines

    def admit_ms(eng, width):
        times = []
        for _ in range(4):
            row = rng.integers(0, vocab, width)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slot = eng.admit(row, width)[0]
            times.append(1e3 * (time.perf_counter() - t0))
            eng.release(slot)
        return min(times[1:])

    out["dense_prefill_ms"] = {}
    for width in PREFILL_WIDTHS:
        out["dense_prefill_ms"][width] = {
            "bf16": [admit_ms(dense_bf16, width)],
            "int8": [admit_ms(dense_int8, width)]}
        out["dense_prefill_ms"][width]["int8"].append(
            admit_ms(dense_int8, width))
        out["dense_prefill_ms"][width]["bf16"].append(
            admit_ms(dense_bf16, width))
    x = torch.randn((MAX_BATCH, 1, MODEL["embed_dim"]),
                    device=model_bf16.device, dtype=torch.bfloat16)
    int8_layer = deployed._model.blocks[0].mlp_in
    bf16_layer = model_bf16.blocks[0].mlp_in
    with torch.inference_mode():
        out["mlp_in_ms"] = {"int8": cuda_ms(lambda: int8_layer(x), 200),
                            "bf16": cuda_ms(lambda: bf16_layer(x), 200)}
    torch.cuda.empty_cache()
    return out


def drive_deployment(torch, kernels, model_bf16, dense_bf16, rng):
    """The deployment phase (see the module docstring). Returns
    (report, launches summed over its two servers' traffic)."""
    from container_engine_accelerators_tpu_torch.models import decode
    from container_engine_accelerators_tpu_torch.serving import serve
    report = {"argv": manifest_argv() + ["--port=0"]}
    # The deployment as written: the paged pool, int8 cache and weights.
    server, report["launch"] = launch_deployed(serve)
    eng, model = server.engine, server.engine._model
    if not (eng.paged and eng.kv_quant == "int8" and model.weights == "int8"
            and model.kv_cache_dtype == "int8"):
        raise AssertionError("the launcher did not build the int8 server")
    try:
        if report["launch"]["health_first"] != 503:
            raise AssertionError("/healthz answered 200 before warm-up")
        for kern in kernels:
            kern.launches = 0
        greedy, report["traffic"] = drive_deployed_traffic(server, rng)
        launches = {kern.name: kern.launches for kern in kernels}
        stats = get(server.port, "/stats")
    finally:
        server.stop()
    leaks = eng.pool_leak_report()
    report.update(stats=stats, launches=launches, leaks=leaks,
                  usable_blocks=eng._pool.usable,
                  arena_bytes=eng.kv_arena_bytes,
                  weights=quant_layout(torch, model),
                  weights_bf16=quant_layout(torch, model_bf16))
    log("deployed server:", json.dumps({k: report[k] for k in (
        "launch", "launches", "leaks", "usable_blocks", "arena_bytes",
        "weights")}))
    if (stats["kv_quant_mode"] != "int8" or stats["kv_pool"] != "paged"
            or leaks is not None or any(launches.values())):
        raise AssertionError(f"deployed server: {stats}, {launches}, "
                             f"{leaks}")
    diverged = []
    for p, new, seq in greedy:
        d = stream_divergence(torch, model, p, new, seq)
        if d is not None:
            diverged.append(d)
    report["greedy_checked"] = len(greedy)
    report["greedy_exact"] = len(greedy) - len(diverged)
    report["greedy_diverged"] = diverged
    log(f"deployed greedy (paged int8): {report['greedy_exact']} of "
        f"{len(greedy)} streams equal greedy_decode; diverged {diverged}")
    if not all(d["near_tie"] for d in diverged):
        raise AssertionError(f"deployed streams diverge off a near tie: "
                             f"{diverged}")

    # The same command line on the dense pool: its admission prefill
    # runs the flash kernel on the raw prompt and writes the int8 cache.
    dense, report["dense_launch"] = launch_deployed(serve, paged=False)
    deng = dense.engine
    if deng.paged or deng.kv_quant != "int8":
        raise AssertionError("CEA_TPU_PAGED_KV=0 did not build a dense "
                             "int8 engine")
    try:
        prefills0 = deng.prefills
        for kern in kernels:
            kern.launches = 0
        dense_greedy = []
        for n in DEPLOY_PROMPTS:
            p = rng.integers(0, MODEL["vocab_size"], n).tolist()
            status, body = post(dense.port, {"prompts": [p],
                                             "max_new_tokens": DEPLOY_NEW})
            if status != 200:
                raise AssertionError(f"dense int8: {status} {body}")
            dense_greedy.append((p, body["sequences"][0]))
        dense_launches = {kern.name: kern.launches for kern in kernels}
        admissions = deng.prefills - prefills0
    finally:
        dense.stop()
    mismatches = []
    for p, seq in dense_greedy:
        want = decode.greedy_decode(dense.engine._model, torch.tensor([p]),
                                    DEPLOY_NEW)[0].tolist()
        if want != seq:
            mismatches.append(dict(prompt_len=len(p), first_diff=next(
                i for i, (a, b) in enumerate(zip(want, seq)) if a != b)
                - len(p)))
    report["dense"] = dict(launches=dense_launches, admissions=admissions,
                           greedy_checked=len(dense_greedy),
                           mismatches=mismatches,
                           leaks=deng.pool_leak_report())
    log("deployed dense int8:", json.dumps(report["dense"]))
    layers = MODEL["num_layers"]
    if (dense_launches["flash_fwd"] != layers * admissions
            or admissions != len(dense_greedy)
            or any(n for k, n in dense_launches.items() if k != "flash_fwd")):
        raise AssertionError(f"dense int8 launches: {dense_launches} for "
                             f"{admissions} admissions")
    if mismatches:
        raise AssertionError(f"dense int8 greedy differs: {mismatches}")
    launches = {k: launches[k] + dense_launches[k] for k in launches}

    report["arenas"] = arena_sizes(torch, decode, model_bf16)
    report["int4"] = int4_engine_run(torch, decode, model_bf16, rng)
    log("deployed arenas:", json.dumps(report["arenas"]), "int4 run:",
        json.dumps(report["int4"]))
    report["times"] = time_deployment(torch, decode, eng, deng, model_bf16,
                                      dense_bf16, rng)
    log("deployed times:", json.dumps(report["times"]))
    del server, dense, eng, deng, model
    torch.cuda.empty_cache()
    return report, launches


def train_argv(steps, warmup, batch=TRAIN_BATCH):
    """The training slice's flags for the port's driver: MODEL at full
    width, sequence 2048, the demo's optimizer defaults."""
    return ["--model", "transformer", "--device", "cuda",
            "--vocab-size", str(MODEL["vocab_size"]),
            "--embed-dim", str(MODEL["embed_dim"]),
            "--num-layers", str(MODEL["num_layers"]),
            "--num-heads", str(MODEL["num_heads"]),
            "--num-kv-heads", str(MODEL["num_kv_heads"]),
            "--pos-embedding", MODEL["pos_embedding"],
            "--seq-len", str(TRAIN_SEQ), "--batch-size", str(batch),
            "--steps", str(steps), "--warmup-steps", str(warmup),
            "--seed", str(SEED)]


def drive(torch, train, kernels, argv, per_step, warmup, on_batch=None):
    """One run of the port's training driver (``train.run``, what
    ``python -m container_engine_accelerators_tpu_torch.train`` runs
    before it prints) on ``argv``, with every launch count set to 0
    just before it. A per-step hook records a CUDA event after each
    step and checks that step's launches against ``per_step`` (one
    count per kernel of ``kernels``); ``on_batch`` is the driver's hook
    before each step. Fails on a step with other launches, a driver
    count that disagrees, or a non-finite loss. Returns (summary,
    launches, trainer, state)."""
    losses, events, bad = [], [], []
    prev = [0] * len(kernels)

    def on_step(step, loss):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        events.append(event)
        losses.append(loss)
        counts = [kern.launches for kern in kernels]
        got = tuple(c - p for c, p in zip(counts, prev))
        if got != per_step:
            bad.append((step, got))
        prev[:] = counts

    args = train.parse_args(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    result, trainer, state = train.run(args, on_step=on_step,
                                       on_batch=on_batch)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {kern.name: kern.launches for kern in kernels}
    losses = [float(x) for x in losses]
    # Step i's time: from the event after step i - 1 to the one after
    # step i (step 0 has no start event, and is warm-up).
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    timed = step_ms[warmup - 1:]
    summary = dict(
        losses=losses, step_ms=step_ms,
        step_ms_mean=sum(timed) / len(timed), wall_s=wall_s,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        per_step_launches_expected=per_step, bad_steps=bad,
        driver_result=result)
    want = {kern.name: args.steps * n for kern, n in zip(kernels, per_step)}
    if bad or len(losses) != args.steps:
        raise AssertionError(f"{args.model}: steps with other launch counts "
                             f"than {per_step}: {bad}")
    if result["kernel_launches"] != want or launches != want:
        raise AssertionError(f"{args.model}: driver launches "
                             f"{result['kernel_launches']}, counted "
                             f"{launches}, want {want}")
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        raise AssertionError(f"{args.model}: non-finite loss: {losses}")
    if not (result["final_loss"] == losses[-1]
            and result["images_per_sec"] > 0):
        raise AssertionError(f"{args.model}: the driver's result "
                             f"disagrees: {losses} {result}")
    return summary, launches, trainer, state


def image_argv(model, batch, steps, warmup, size=RESNET_SIZE,
               classes=RESNET_CLASSES):
    """The driver's flags for an image model on the card, with the
    demo's optimizer defaults (SGD lr 0.1, momentum 0.9, weight decay
    1e-4 on conv and dense kernels)."""
    return ["--model", model, "--device", "cuda", "--depth", "50",
            "--image-size", str(size), "--num-classes", str(classes),
            "--batch-size", str(batch), "--steps", str(steps),
            "--warmup-steps", str(warmup), "--seed", str(SEED)]


def drive_resnet(torch, train, kernels):
    """Phase 8's main path: ResNet-50 at full width through the driver.
    The loss falls, each step launches the two cross-entropy kernels
    once and no attention kernel, every BN's running statistics moved
    from their init (mean 0, var 1), and the eval step (running
    statistics, no gradient) gives finite logits."""
    from container_engine_accelerators_tpu_torch.models.layers import (
        BatchNorm,
    )
    from container_engine_accelerators_tpu_torch.parallel import (
        SyntheticLoader,
    )
    per_step = (0, 0, 0, 1, 1)
    summary, launches, trainer, state = drive(
        torch, train, kernels,
        image_argv("resnet", RESNET_BATCH, RESNET_STEPS, RESNET_WARMUP),
        per_step, RESNET_WARMUP)
    losses = summary["losses"]
    norms = [m for m in state.model.modules() if isinstance(m, BatchNorm)]
    still = [i for i, m in enumerate(norms)
             if not ((m.running_mean != 0).any() and
                     (m.running_var != 1).any())]
    images, _ = next(SyntheticLoader(RESNET_BATCH, (RESNET_SIZE,) * 2 + (3,),
                                     RESNET_CLASSES, device="cuda"))
    logits = trainer.eval_step(state, images)
    torch.cuda.synchronize()
    summary.update(images_per_s=summary["driver_result"]["images_per_sec"],
                   batch_norms=len(norms), stats_unmoved=still,
                   eval_logits_shape=list(logits.shape),
                   eval_logits_finite=bool(torch.isfinite(logits).all()))
    log("resnet:", json.dumps(summary))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"resnet: the loss did not fall: {losses}")
    if not norms or still:
        raise AssertionError(f"resnet: BN running statistics of layers "
                             f"{still} did not move")
    if not (summary["eval_logits_finite"] and summary["eval_logits_shape"]
            == [RESNET_BATCH, RESNET_CLASSES]):
        raise AssertionError(f"resnet: bad eval logits {summary}")
    del trainer, state, logits
    torch.cuda.empty_cache()
    return summary, launches


def check_image_plain_step(torch, train):
    """One ResNet-50 step (forward and backward, batch 128) through the
    fused loss against the same step through the plain
    ``cross_entropy_loss``, on the same weights and batch: loss and
    every gradient's relative L2 error. The fused step also runs twice
    and reports whether it repeats bitwise (cuDNN may pick backward
    algorithms that sum in another order; not a gate)."""
    from container_engine_accelerators_tpu_torch.ops.xent import (
        mean_cross_entropy_loss,
    )
    from container_engine_accelerators_tpu_torch.parallel import (
        SyntheticLoader,
        cross_entropy_loss,
    )
    args = train.parse_args(image_argv("resnet", RESNET_BATCH, 1, 0))
    model, shape, classes = train.build_model(args, "cuda")
    start = {n: t.clone() for n, t in model.state_dict().items()}
    images, labels = next(SyntheticLoader(RESNET_BATCH, shape, classes,
                                          device="cuda"))

    def step(loss_fn):
        model.load_state_dict(start)
        model.zero_grad(set_to_none=True)
        value = loss_fn(model(images), labels)
        value.backward()
        return value.item(), {n: p.grad.clone()
                              for n, p in model.named_parameters()}

    kernel_loss, kernel_grads = step(mean_cross_entropy_loss)
    again_loss, again_grads = step(mean_cross_entropy_loss)
    plain_loss, plain_grads = step(cross_entropy_loss)
    rel = {n: ((kernel_grads[n] - g).norm() / g.norm().clamp_min(1e-30)
               ).item() for n, g in plain_grads.items()}
    worst = max(rel, key=rel.get)
    differ = sorted(n for n, g in again_grads.items()
                    if not torch.equal(g, kernel_grads[n]))
    out = dict(kernel_loss=kernel_loss, plain_loss=plain_loss,
               loss_rel_err=abs(kernel_loss - plain_loss) / abs(plain_loss),
               grad_rel_l2_max=rel[worst], grad_rel_l2_worst=worst,
               grad_rel_l2_median=sorted(rel.values())[len(rel) // 2],
               loss_tol=IMAGE_LOSS_TOL, grad_tol=IMAGE_GRAD_TOL,
               repeat_loss_bitwise=again_loss == kernel_loss,
               repeat_grads_bitwise=not differ,
               repeat_grads_differing=len(differ), grads=len(rel))
    log("resnet kernel step vs plain step:", json.dumps(out))
    if out["loss_rel_err"] > IMAGE_LOSS_TOL or rel[worst] > IMAGE_GRAD_TOL:
        raise AssertionError(f"resnet: the fused-loss step differs from "
                             f"the plain step: {out}")
    del model, start, kernel_grads, again_grads, plain_grads
    torch.cuda.empty_cache()
    return out


def drive_small_images(torch, train, kernels):
    """Phase 8's other models: MNIST at the demo's shapes (fused loss,
    one cross-entropy forward and backward a step) and Inception-v3 at
    299 (the plain loss, as the demo: no kernel launch)."""
    out, launches = {}, {}
    for name, argv, per_step, warmup in (
            ("mnist", image_argv("mnist", MNIST_BATCH, MNIST_STEPS, 1),
             (0, 0, 0, 1, 1), 1),
            ("inception", image_argv("inception", INCEPTION_BATCH,
                                     INCEPTION_STEPS, 1, size=299),
             (0,) * 5, 1)):
        summary, launches[name], _, _ = drive(
            torch, train, kernels, argv, per_step, warmup)
        summary["images_per_s"] = summary["driver_result"]["images_per_sec"]
        log(f"{name}:", json.dumps(summary))
        out[name] = summary
        torch.cuda.empty_cache()
    return out, launches


def drive_training(torch, train, kernels):
    """Phase 7's main path: TRAIN_STEPS steps of the LM through the
    port's training driver (``drive``): 8 flash_fwd, 8 dQ, 8 dK/dV, 1
    cross-entropy forward and 1 backward launch a step, and the loss
    falls. Returns the summary and the launch counts of the run."""
    per_step = (MODEL["num_layers"],) * 3 + (1, 1)
    summary, launches, _, _ = drive(torch, train, kernels,
                                    train_argv(TRAIN_STEPS, TRAIN_WARMUP),
                                    per_step, TRAIN_WARMUP)
    losses, result = summary["losses"], summary["driver_result"]
    summary["tokens_per_s"] = result["tokens_per_sec"]
    log("train:", json.dumps(summary))
    if not (losses[-1] < losses[0] and result["tokens_per_sec"] > 0):
        raise AssertionError(f"loss did not fall: {losses} {result}")
    torch.cuda.empty_cache()
    return summary, launches


def check_plain_step(torch, attn, convert, train, window=0, extra=()):
    """One batch-2 step's loss and gradients through the kernels
    against the same step through the plain versions (attention_fn =
    the plain forward, with the band when ``window``; loss = the plain
    cross_entropy_loss), on the same weights and batch. ``extra``: more
    driver flags; with ``--model moe`` both steps add the router's aux
    loss, the plain step routes through ``dense_moe_reference`` and
    takes the kernel step's expert choices (``RoutePin``)."""
    from container_engine_accelerators_tpu_torch.models import moe
    from container_engine_accelerators_tpu_torch.models.transformer import (
        next_token_loss_fn,
    )
    from container_engine_accelerators_tpu_torch.parallel import expert
    from container_engine_accelerators_tpu_torch.ops.xent import (
        mean_cross_entropy_loss,
    )
    from container_engine_accelerators_tpu_torch.parallel import (
        SyntheticTokenLoader,
        cross_entropy_loss,
    )
    config = train.lm_config(train.parse_args(
        train_argv(1, 0, PLAIN_BATCH) + ["--attention-window", str(window)]
        + list(extra)))
    tree = convert.init_flax_layout_params(config, SEED)
    tokens = next(SyntheticTokenLoader(PLAIN_BATCH, TRAIN_SEQ,
                                       config["vocab_size"],
                                       device="cuda"))[0]

    def plain_attention(q, k, v, causal, window=0):
        return attn.flash_attention_reference(q, k, v, causal, window)[0]

    pin = RoutePin(torch, expert) if "num_experts" in config else None

    def step(attention_fn, loss):
        model = convert.load_lm(config, tree, device="cuda",
                                trainable=True, attention_fn=attention_fn)
        loss_fn = next_token_loss_fn(functools.partial(
            loss, label_smoothing=0.0))
        routing = contextlib.nullcontext()
        if pin is not None:
            loss_fn = moe.with_router_loss(loss_fn)
            routing = pin.recording()
            if attention_fn is not None:
                set_moe_fn(moe, model, expert.dense_moe_reference)
                routing = pin.replaying()
        with routing:
            value = loss_fn(model(tokens), tokens)
        value.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        return value.item(), grads

    kernel_loss, kernel_grads = step(None, mean_cross_entropy_loss)
    plain_loss, plain_grads = step(plain_attention, cross_entropy_loss)
    rel = {n: ((kernel_grads[n] - g).norm() / g.norm().clamp_min(1e-30)
               ).item() for n, g in plain_grads.items()}
    worst = max(rel, key=rel.get)
    out = dict(kernel_loss=kernel_loss, plain_loss=plain_loss,
               loss_rel_err=abs(kernel_loss - plain_loss) / abs(plain_loss),
               grad_rel_l2_max=rel[worst], grad_rel_l2_worst=worst,
               grad_rel_l2_median=sorted(rel.values())[len(rel) // 2],
               loss_tol=STEP_LOSS_TOL, grad_tol=STEP_GRAD_TOL, window=window,
               flags=list(extra))
    if pin is not None:
        out.update(route_choices=pin.total, route_flips=pin.flips)
    log("kernel step vs plain step:", json.dumps(out))
    if out["loss_rel_err"] > STEP_LOSS_TOL or rel[worst] > STEP_GRAD_TOL:
        raise AssertionError(f"kernel step differs from the plain step: "
                             f"{out}")
    del kernel_grads, plain_grads
    torch.cuda.empty_cache()
    return out


class RoutePin:
    """Pins one step's expert choices in another. ``recording()``
    keeps every routing call's choices (the argmax rounds of
    ``expert._route``); ``replaying()`` makes each routing call, in the
    same order, take the recorded choices and compute everything else
    (probabilities, queue positions, drops, weights, aux) from its own
    gate logits. A choice near a tie flips between two steps whose
    hidden states round apart (flash against plain attention), and a
    flip moves a token's whole expert output and shifts that expert's
    queue: the kernel step and the plain step then differ by routing,
    not by the kernels' rounding. ``flips`` counts the replayed choices
    that differed from the step's own argmax, ``total`` all of
    them."""

    def __init__(self, torch, expert):
        self.torch, self.expert = torch, expert
        self.choices, self.flips, self.total = [], 0, 0

    @contextlib.contextmanager
    def _patched(self, fn):
        orig = self.expert._route
        self.expert._route = functools.partial(fn, orig)
        try:
            yield
        finally:
            self.expert._route = orig

    def recording(self):
        def record(orig, gate_logits, capacity, top_k):
            out = orig(gate_logits, capacity, top_k)
            self.choices.append([idx for idx, _, _ in out[1]])
            return out
        return self._patched(record)

    def replaying(self):
        torch = self.torch
        import torch.nn.functional as F

        def replay(orig, gate_logits, capacity, top_k):
            probs, own, _, _ = orig(gate_logits, capacity, top_k)
            forced = self.choices.pop(0)
            e = probs.shape[1]
            counts = torch.zeros((e,), dtype=torch.long, device=probs.device)
            assign_frac = torch.zeros((e,), device=probs.device)
            chosen_mass = torch.zeros(probs.shape[:1], device=probs.device)
            rounds = []
            for idx, (own_idx, _, _) in zip(forced, own):
                self.flips += int((idx != own_idx).sum())
                self.total += idx.numel()
                onehot = F.one_hot(idx, e)
                assign_frac = assign_frac + onehot.float().mean(dim=0) / top_k
                pos = self.expert._rank_in_expert(onehot, idx) + counts[idx]
                w = probs.gather(1, idx[:, None])[:, 0]
                chosen_mass = chosen_mass + w
                counts = counts + (onehot * (pos < capacity)[:, None]).sum(0)
                rounds.append((idx, pos, w))
            return probs, rounds, assign_frac, chosen_mass
        return self._patched(replay)


def drive_window_training(torch, train, kernels):
    """Phase 9a: the windowed LM through ``train.run``, as phase
    7: 8 flash_fwd, 8 dQ, 8 dK/dV, 1 cross-entropy forward and 1
    backward a step, and the loss falls."""
    per_step = (MODEL["num_layers"],) * 3 + (1, 1)
    summary, launches, _, state = drive(
        torch, train, kernels,
        train_argv(WINDOW_STEPS, WINDOW_WARMUP)
        + ["--attention-window", str(WINDOW)], per_step, WINDOW_WARMUP)
    losses, result = summary["losses"], summary["driver_result"]
    summary["tokens_per_s"] = result["tokens_per_sec"]
    log("window train:", json.dumps(summary))
    if state.model.attention_window != WINDOW:
        raise AssertionError("train.run did not build a windowed LM")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"window train: loss did not fall: {losses}")
    del state
    torch.cuda.empty_cache()
    return summary, launches


def check_band(torch, convert, rng):
    """Phase 9a: one 2048-token row through the windowed and the causal
    model on the same weights (bf16 serving weights, flash forward).
    Before position W the band does not bind, so the logits must agree
    within the bf16 limit (2e-2 of their largest magnitude); after it
    they must differ by more than that agreement, and by more than 1e-3
    of that magnitude: the band is applied, not ignored by both."""
    tree = convert.init_flax_layout_params(MODEL, SEED)
    toks = torch.as_tensor(rng.integers(0, MODEL["vocab_size"],
                                        (1, MODEL["max_seq_len"])),
                           device="cuda")
    with torch.inference_mode():
        causal = convert.load_lm(MODEL, tree)(toks)
        windowed = convert.load_lm(dict(MODEL, attention_window=WINDOW),
                                   tree)(toks)
    scale = causal.abs().max().item()
    early = (windowed[:, :WINDOW] - causal[:, :WINDOW]).abs().max().item()
    late = (windowed[:, WINDOW:] - causal[:, WINDOW:]).abs().max().item()
    out = dict(scale=scale, early_max_abs=early, late_max_abs=late,
               limit=2e-2 * scale)
    log("window band:", json.dumps(out))
    if not (early <= 2e-2 * scale and late > max(10 * early, 1e-3 * scale)):
        raise AssertionError(f"the band is not applied as it should: {out}")
    del causal, windowed
    torch.cuda.empty_cache()
    return out


def window_mismatches(torch, model, seq, prompt_len):
    """Positions where greedy ``seq`` [1, T] disagrees with the argmax
    of one cache-free forward of the windowed model over it (each
    position teacher-forced by ``seq`` itself), with the gap between
    that forward's top two logits against 2e-2 of its largest logit
    (the bf16 rule of PERF.md §2)."""
    with torch.inference_mode():
        logits = model(seq[:, :-1])[0].float()
    out = []
    for t in range(prompt_len - 1, seq.shape[1] - 1):
        if int(logits[t].argmax()) == int(seq[0, t + 1]):
            continue
        top = logits[t].topk(2).values
        gap = (top[0] - top[1]).item()
        limit = 2e-2 * logits[t].abs().max().item()
        out.append(dict(position=t + 1 - prompt_len, top2_gap=gap,
                        limit=limit, near_tie=gap <= limit))
    return out


def window_decode(torch, decode, model, kernels, rng):
    """Phase 9b: ``decode()`` on the ring: greedy, prompts of 1500 and
    16 tokens and MAX_NEW new tokens each, counts set to 0 just before
    and read just after (one 8-launch flash prefill a call, nothing
    else). The ring holds W slots, not P + MAX_NEW. Each token equals
    the cache-free forward's argmax or sits at a near tie;
    ``stream_decode`` in chunks of 16 and ``beam_search(num_beams=1)``
    give decode()'s tokens (or the same rule holds for theirs)."""
    import numpy as np
    vocab = MODEL["vocab_size"]
    prompts = [torch.as_tensor(rng.integers(0, vocab, (1, n)),
                               device="cuda") for n in WINDOW_PROMPTS]
    for kern in kernels:
        kern.launches = 0
    seqs = [decode.decode(model, p, MAX_NEW) for p in prompts]
    torch.cuda.synchronize()
    launches = {kern.name: kern.launches for kern in kernels}
    report = {"launches": dict(launches), "calls": len(prompts)}
    state = decode.prefill_prefix(model, prompts[0],
                                  max_total_len=WINDOW_PROMPTS[0] + MAX_NEW)
    ring = state[0]
    report["ring_leaf_shape"] = list(ring[0][0].shape)
    report["ring_slot_pos_range"] = [int(ring.slot_pos.min()),
                                     int(ring.slot_pos.max())]
    full = model.init_cache(1, MODEL["max_seq_len"], ring=False)
    report["kv_bytes_per_row"] = {
        "ring": sum(a.numel() * a.element_size()
                    for layer in ring for a in layer)
        + ring.slot_pos.numel() * ring.slot_pos.element_size(),
        "full_length": sum(a.numel() * a.element_size()
                           for layer in full for a in layer),
        "per_token": sum(a[0, 0].numel() * a.element_size()
                         for layer in full for a in layer)}
    del state, ring, full
    checks = []
    for p, seq in zip(prompts, seqs):
        n = p.shape[1]
        entry = dict(prompt_len=n,
                     mismatches=window_mismatches(torch, model, seq, n))
        streamed = torch.as_tensor(np.concatenate(
            list(decode.stream_decode(model, p, MAX_NEW, chunk=16)), axis=1),
            device="cuda")
        beam, _ = decode.beam_search(model, p, MAX_NEW, num_beams=1)
        for name, other in (("stream_decode", torch.cat([p, streamed], 1)),
                            ("beam_search_1", beam[:, 0])):
            same = bool(torch.equal(other, seq))
            entry[f"{name}_equal"] = same
            if not same:
                entry[f"{name}_mismatches"] = window_mismatches(
                    torch, model, other, n)
        checks.append(entry)
    report["streams"] = checks
    log("window decode:", json.dumps(report))
    layers = MODEL["num_layers"]
    if (launches["flash_fwd"] != layers * len(prompts)
            or any(v for k, v in launches.items() if k != "flash_fwd")):
        raise AssertionError(f"decode() on the ring launched {launches}")
    kv = MODEL["num_kv_heads"]
    d = MODEL["embed_dim"] // MODEL["num_heads"]
    if report["ring_leaf_shape"] != [1, WINDOW, kv, d]:
        raise AssertionError(f"ring leaves {report['ring_leaf_shape']}")
    bad = [m for c in checks for key in c if key.endswith("mismatches")
           for m in c[key] if not m["near_tie"]]
    if bad:
        raise AssertionError(f"ring greedy tokens off a near tie: {bad}")
    return report, launches


def time_window_step(torch, model, rng):
    """Phase 9d: one decode step (batch 1, at WINDOW_STEP_POS) on the
    ring against the full-length windowed cache (the slot engine's
    kind), host clock around 20 synced steps, in turns ring, full,
    full, ring."""
    caches = {"ring": model.init_cache(1, MODEL["max_seq_len"]),
              "full": model.init_cache(1, MODEL["max_seq_len"], ring=False)}
    tok = torch.as_tensor(rng.integers(0, MODEL["vocab_size"], (1, 1)),
                          device="cuda")
    out = {"ring": [], "full": []}
    with torch.inference_mode():
        for name in ("ring", "full", "full", "ring"):
            for _ in range(3):
                model(tok, caches[name], WINDOW_STEP_POS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                model(tok, caches[name], WINDOW_STEP_POS)
            torch.cuda.synchronize()
            out[name].append(1e3 * (time.perf_counter() - t0) / 20)
    return out


def time_window_kernels(torch, attn):
    """Phase 9d: the three flash kernels at q/k/v [8, 2048, 8, 64] bf16
    with the W 512 band (``time_flash_kernels``)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows = time_flash_kernels(torch, attn, WINDOW, gen)
    for name, row in rows.items():
        log("window kernel time", name, json.dumps(row))
    return rows


def window_server_traffic(server, rng, lengths):
    """Concurrent greedy requests of ``lengths`` tokens, WINDOW_NEW new
    tokens each. Returns [(prompt, new, sequence)]."""
    vocab = MODEL["vocab_size"]
    prompts = [rng.integers(0, vocab, n).tolist() for n in lengths]
    results, errors = [None] * len(prompts), []

    def client(i):
        try:
            results[i] = post(server.port, {"prompts": [prompts[i]],
                                            "max_new_tokens": WINDOW_NEW})
        except Exception as e:  # reported below, fails the run
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"windowed requests failed: {errors}")
    out = []
    for p, (status, body) in zip(prompts, results):
        seq = body["sequences"][0]
        if status != 200 or len(seq) != len(p) + WINDOW_NEW or not all(
                0 <= t < vocab for t in seq):
            raise AssertionError(f"bad windowed response {status}: {body}")
        out.append((p, WINDOW_NEW, seq))
    return out


def drive_window_serving(torch, kernels, rng):
    """Phase 9c: ``serve.py --attention-window 512`` (the full-width
    model, bf16) on the paged pool, then on the dense pool
    (CEA_TPU_PAGED_KV=0 while it builds): no kernel launch (the
    admissions ride per-row positions), each greedy stream equal to
    decode() on the ring (``greedy_decode`` is that path) or first
    differing at a near tie, the pool clean when idle."""
    from container_engine_accelerators_tpu_torch.serving import serve
    argv = ["--model", "transformer", "--model-name", "lm", "--port", "0",
            "--vocab-size", str(MODEL["vocab_size"]),
            "--embed-dim", str(MODEL["embed_dim"]),
            "--num-layers", str(MODEL["num_layers"]),
            "--num-heads", str(MODEL["num_heads"]),
            "--num-kv-heads", str(MODEL["num_kv_heads"]),
            "--pos-embedding", MODEL["pos_embedding"],
            "--max-seq-len", str(MODEL["max_seq_len"]),
            "--max-new-tokens", str(MAX_NEW),
            "--max-batch", str(MAX_BATCH), "--seed", str(SEED),
            "--attention-window", str(WINDOW)]
    report, launches = {}, {kern.name: 0 for kern in kernels}
    for pool, lengths in (("paged", WINDOW_SERVE), ("dense", WINDOW_DENSE)):
        if pool == "dense":
            os.environ["CEA_TPU_PAGED_KV"] = "0"
        try:
            server = serve.build_server(serve.build_parser().parse_args(argv))
        finally:
            os.environ.pop("CEA_TPU_PAGED_KV", None)
        eng = server.engine
        if (eng.paged != (pool == "paged")
                or eng._model.attention_window != WINDOW):
            raise AssertionError(f"the launcher built the wrong {pool} engine")
        server.start()
        try:
            for kern in kernels:
                kern.launches = 0
            greedy = window_server_traffic(server, rng, lengths)
            counts = {kern.name: kern.launches for kern in kernels}
        finally:
            server.stop()
        diverged = [d for d in (stream_divergence(torch, eng._model, p, new,
                                                  seq)
                                for p, new, seq in greedy) if d is not None]
        entry = dict(launches=counts, requests=len(greedy),
                     greedy_exact=len(greedy) - len(diverged),
                     greedy_diverged=diverged, leaks=eng.pool_leak_report(),
                     arena_bytes=eng.kv_arena_bytes)
        report[pool] = entry
        log(f"window serving ({pool}):", json.dumps(entry))
        if any(counts.values()):
            raise AssertionError(f"windowed {pool} pool launched kernels: "
                                 f"{counts}")
        if entry["leaks"] is not None:
            raise AssertionError(f"windowed {pool} pool not clean: "
                                 f"{entry['leaks']}")
        if not all(d["near_tie"] for d in diverged):
            raise AssertionError(f"windowed {pool} streams diverge off a "
                                 f"near tie: {diverged}")
        launches = {k: launches[k] + counts[k] for k in launches}
        del server, eng
        torch.cuda.empty_cache()
    return report, launches


def drive_window(torch, attn, convert, train, kernels, rng):
    """Phase 9 (see the module docstring). Returns (report, launches
    by path)."""
    from container_engine_accelerators_tpu_torch.models import decode
    report, launches = {}, {}
    report["train"], launches["window_training"] = drive_window_training(
        torch, train, kernels)
    report["train_plain_step"] = check_plain_step(torch, attn, convert,
                                                  train, WINDOW)
    report["band"] = check_band(torch, convert, rng)
    model = convert.load_lm(dict(MODEL, attention_window=WINDOW),
                            convert.init_flax_layout_params(MODEL, SEED))
    report["decode"], launches["window_decode"] = window_decode(
        torch, decode, model, kernels, rng)
    report["serving"], launches["window_serving"] = drive_window_serving(
        torch, kernels, rng)
    report["step_ms"] = time_window_step(torch, model, rng)
    log("window step (ring vs full-length cache):",
        json.dumps(report["step_ms"]))
    del model
    torch.cuda.empty_cache()
    report["kernel_times"] = time_window_kernels(torch, attn)
    return report, launches


def spec_decode_calls(torch, speculative, model, draft, kernels, rng,
                      name, launches_per_call, window=0):
    """Phase 10a: greedy ``speculative_decode`` (k SPEC_K) on the
    SPEC_PROMPTS prompts, MAX_NEW new tokens each, counts set to 0 just
    before each call and read just after. Returns (entry, launches
    summed over the calls)."""
    vocab = MODEL["vocab_size"]
    entry, total = {"calls": []}, {kern.name: 0 for kern in kernels}
    accepted = proposed = 0
    for n in SPEC_PROMPTS:
        prompt = torch.as_tensor(rng.integers(0, vocab, (1, n)),
                                 device="cuda")
        for kern in kernels:
            kern.launches = 0
        t0 = time.perf_counter()
        seq, stats = speculative.speculative_decode(
            model, draft, prompt, MAX_NEW, k=SPEC_K, return_stats=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {kern.name: kern.launches for kern in kernels}
        total = {k: total[k] + counts[k] for k in total}
        accepted += stats["accepted_drafts"]
        proposed += stats["rounds"] * (SPEC_K - 1)
        entry["calls"].append(dict(
            prompt_len=n, launches=counts, stats=stats, wall_s=wall,
            divergence=stream_divergence(torch, model, prompt[0].tolist(),
                                         MAX_NEW, seq[0].tolist())))
        if (counts["flash_fwd"] != launches_per_call
                or any(v for k, v in counts.items() if k != "flash_fwd")):
            raise AssertionError(f"speculative_decode ({name}, prompt {n}) "
                                 f"launched {counts}")
    entry["acceptance"] = accepted / max(proposed, 1)
    bad = [c["divergence"] for c in entry["calls"]
           if c["divergence"] is not None and not c["divergence"]["near_tie"]]
    if bad:
        raise AssertionError(f"speculative_decode ({name}) diverges off a "
                             f"near tie: {bad}")
    log(f"speculative_decode ({name}):", json.dumps(entry))
    return entry, total


def drive_spec_decode(torch, speculative, convert, model, draft, kernels,
                      rng):
    """Phase 10a (see the module docstring)."""
    report, launches = {}, {}
    layers, dlayers = MODEL["num_layers"], SPEC_DRAFT["num_layers"]
    report["self"], launches["spec_decode_self"] = spec_decode_calls(
        torch, speculative, model, model, kernels, rng, "self-draft",
        2 * layers)
    if report["self"]["acceptance"] < SPEC_ACCEPT_SINGLE:
        raise AssertionError(f"single-request self-draft acceptance "
                             f"{report['self']['acceptance']:.4f} < "
                             f"{SPEC_ACCEPT_SINGLE}")
    report["demo"], launches["spec_decode_demo"] = spec_decode_calls(
        torch, speculative, model, draft, kernels, rng, "demo draft",
        layers + dlayers)
    # One sampled call, twice from the same generator seed.
    prompt = torch.as_tensor(rng.integers(0, MODEL["vocab_size"], (1, 16)),
                             device="cuda")
    runs = [speculative.speculative_decode(
        model, draft, prompt, SPEC_NEW, k=SPEC_K, temperature=0.8, top_k=50,
        top_p=0.9, return_logprobs=True,
        generator=torch.Generator(device="cuda").manual_seed(SEED + 3))
        for _ in range(2)]
    (seq, lps), (seq2, lps2) = runs
    report["sampled"] = dict(
        reproducible=bool(torch.equal(seq, seq2) and torch.equal(lps, lps2)),
        finite=bool(torch.isfinite(lps).all()),
        in_vocab=bool(((seq >= 0) & (seq < MODEL["vocab_size"])).all()))
    if not all(report["sampled"].values()):
        raise AssertionError(f"sampled speculation: {report['sampled']}")
    # The windowed target with its self-draft: rings of W + k slots.
    windowed = convert.load_lm(dict(MODEL, attention_window=WINDOW),
                               convert.init_flax_layout_params(MODEL, SEED))
    shapes = []
    real = windowed.init_cache

    def spy(*args, **kwargs):
        cache = real(*args, **kwargs)
        shapes.append(list(cache[0][0].shape))
        return cache

    windowed.init_cache = spy
    report["window"], launches["spec_decode_window"] = spec_decode_calls(
        torch, speculative, windowed, windowed, kernels, rng,
        "windowed self-draft", 2 * layers)
    windowed.init_cache = real
    report["window"]["ring_leaf_shapes"] = shapes
    kv = MODEL["num_kv_heads"]
    d = MODEL["embed_dim"] // MODEL["num_heads"]
    if shapes[:2] != [[1, WINDOW + SPEC_K, kv, d]] * 2:
        raise AssertionError(f"speculation's ring leaves {shapes}")
    del windowed
    torch.cuda.empty_cache()
    return report, launches


def spec_server_traffic(server, rng, lengths):
    """Concurrent greedy requests of ``lengths`` tokens and one sampled
    request, SPEC_NEW new tokens each. Returns the greedy [(prompt,
    new, sequence)]."""
    vocab = MODEL["vocab_size"]
    payloads = [{"prompts": [rng.integers(0, vocab, n).tolist()],
                 "max_new_tokens": SPEC_NEW} for n in lengths]
    payloads.append({"prompts": [rng.integers(0, vocab, 64).tolist()],
                     "max_new_tokens": SPEC_NEW, "temperature": 0.8,
                     "top_k": 50})
    results, errors = [None] * len(payloads), []

    def client(i):
        try:
            results[i] = post(server.port, payloads[i])
        except Exception as e:  # reported below, fails the run
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"speculative requests failed: {errors}")
    greedy = []
    for pay, (status, body) in zip(payloads, results):
        p = pay["prompts"][0]
        seq = body["sequences"][0]
        if status != 200 or len(seq) != len(p) + SPEC_NEW or not all(
                0 <= t < vocab for t in seq):
            raise AssertionError(f"bad speculative response {status}: "
                                 f"{body}")
        if "temperature" not in pay:
            greedy.append((p, SPEC_NEW, seq))
    return greedy


def drive_spec_serving(torch, kernels, rng):
    """Phase 10b: ``serve.py --speculative-k 4`` (the demo draft) on the
    paged pool, then on the dense pool (CEA_TPU_PAGED_KV=0 while it
    builds), counts set to 0 just before the traffic and read just
    after."""
    from container_engine_accelerators_tpu_torch.serving import serve
    argv = ["--model", "transformer", "--model-name", "lm", "--port", "0",
            "--vocab-size", str(MODEL["vocab_size"]),
            "--embed-dim", str(MODEL["embed_dim"]),
            "--num-layers", str(MODEL["num_layers"]),
            "--num-heads", str(MODEL["num_heads"]),
            "--num-kv-heads", str(MODEL["num_kv_heads"]),
            "--pos-embedding", MODEL["pos_embedding"],
            "--max-seq-len", str(MODEL["max_seq_len"]),
            "--max-new-tokens", str(MAX_NEW),
            "--max-batch", str(MAX_BATCH), "--seed", str(SEED),
            "--speculative-k", str(SPEC_K),
            "--draft-layers", str(SPEC_DRAFT["num_layers"]),
            "--draft-embed-dim", str(SPEC_DRAFT["embed_dim"])]
    report, launches = {}, {kern.name: 0 for kern in kernels}
    # flash_fwd launches of a greedy and of the sampled admission: the
    # draft's one-shot prefill, and on the dense pool the target's.
    per_admission = {
        "paged": (SPEC_DRAFT["num_layers"], 0),
        "dense": (MODEL["num_layers"] + SPEC_DRAFT["num_layers"],
                  MODEL["num_layers"])}
    for pool, lengths in (("paged", SPEC_SERVE), ("dense", SPEC_DENSE)):
        if pool == "dense":
            os.environ["CEA_TPU_PAGED_KV"] = "0"
        try:
            server = serve.build_server(serve.build_parser().parse_args(argv))
        finally:
            os.environ.pop("CEA_TPU_PAGED_KV", None)
        eng = server.engine
        if eng.paged != (pool == "paged") or eng._spec_k != SPEC_K:
            raise AssertionError(f"the launcher built the wrong {pool} engine")
        server.start()
        try:
            for kern in kernels:
                kern.launches = 0
            prefills0 = eng.prefills
            greedy = spec_server_traffic(server, rng, lengths)
            counts = {kern.name: kern.launches for kern in kernels}
            stats = get(server.port, "/stats")
            admissions = eng.prefills - prefills0
        finally:
            server.stop()
        diverged = [d for d in (stream_divergence(torch, eng._model, p, new,
                                                  seq)
                                for p, new, seq in greedy) if d is not None]
        fields = ("spec_steps", "spec_proposed_tokens",
                  "spec_accepted_tokens", "draft_prefills",
                  "speculative_acceptance_rate", "accepted_tokens_per_step")
        entry = dict(launches=counts, admissions=admissions,
                     greedy=len(greedy), greedy_exact=len(greedy)
                     - len(diverged), greedy_diverged=diverged,
                     leaks=eng.pool_leak_report(),
                     stats={k: stats.get(k) for k in fields
                            + ("spec_kv_blocks_total", "spec_kv_blocks_free",
                               "spec_kv_arena_bytes")},
                     spec_kv_arena_bytes=eng.spec_kv_arena_bytes)
        report[pool] = entry
        log(f"speculative serving ({pool}):", json.dumps(entry))
        greedy_each, sampled_each = per_admission[pool]
        want = greedy_each * len(lengths) + sampled_each
        if (counts["flash_fwd"] != want
                or any(v for k, v in counts.items() if k != "flash_fwd")
                or stats["draft_prefills"] != len(lengths)
                or admissions != len(lengths) + 1):
            raise AssertionError(
                f"speculative {pool} serving launched {counts} for "
                f"{admissions} admissions, {stats['draft_prefills']} "
                f"drafting; want {want} flash_fwd")
        if any(k not in stats for k in fields) or not stats["spec_steps"]:
            raise AssertionError(f"/stats lacks speculation: {stats}")
        if entry["leaks"] is not None:
            raise AssertionError(f"speculative {pool} pool not clean: "
                                 f"{entry['leaks']}")
        if not all(d["near_tie"] for d in diverged):
            raise AssertionError(f"speculative {pool} streams diverge off "
                                 f"a near tie: {diverged}")
        launches = {k: launches[k] + counts[k] for k in launches}
        del server, eng
        torch.cuda.empty_cache()
    return report, launches


def spec_engine_run(torch, decode, model, draft, rng, slot_len):
    """Phase 10b/c: SPEC_ENGINE greedy rows (SPEC_ENGINE_NEW new tokens)
    through a paged engine with ``draft`` (None: plain), all admitted
    first, stepped until each row has its budget (released there), 10
    steps with all 8 rows active timed (host clock around synced
    steps). Returns (engine, report)."""
    import numpy as np
    kwargs = {} if draft is None else dict(draft_model=draft, spec_k=SPEC_K)
    eng = decode.SlotDecodeEngine(model, MAX_BATCH, slot_len, paged=True,
                                  **kwargs)
    vocab = MODEL["vocab_size"]
    rows = {}
    for n in SPEC_ENGINE:
        slot, first, _, _ = eng.admit(rng.integers(0, vocab, n), n,
                                      max_new=SPEC_ENGINE_NEW)
        rows[slot] = [first]
    committed, step_ms = [], []
    while rows:
        full = len(rows) == MAX_BATCH and len(step_ms) < 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.step()
        if full:
            step_ms.append(1e3 * (time.perf_counter() - t0))
        counts = out[2] if draft is not None else np.ones(MAX_BATCH, int)
        for slot in list(rows):
            c = int(counts[slot])
            toks = out[0][slot, :c] if draft is not None else [out[0][slot]]
            rows[slot].extend(int(t) for t in toks)
            if full:
                committed.append(c)
            if len(rows[slot]) >= SPEC_ENGINE_NEW:
                eng.release(slot)
                del rows[slot]
    report = dict(step_ms=step_ms, leaks=eng.pool_leak_report(),
                  tokens_per_row_step=(sum(committed) / len(committed)
                                       if committed else None))
    if draft is not None:
        report.update(acceptance=eng.spec_accepted / max(eng.spec_proposed,
                                                         1),
                      spec_steps=eng.spec_steps,
                      accepted_tokens_per_step=(
                          (eng.spec_accepted + eng.spec_row_steps)
                          / max(eng.spec_row_steps, 1)),
                      spec_kv_arena_bytes=eng.spec_kv_arena_bytes)
    return eng, report


def drive_spec_engine(torch, decode, model, draft, kernels, rng):
    """Phase 10b/c: the self-draft engine's acceptance (>= the JAX
    tool's floor), and the decode step with 8 rows plain, with the demo
    draft and with the self-draft (informational)."""
    slot_len = MODEL["max_seq_len"]
    report = {}
    for name, d in (("plain", None), ("demo", draft), ("self", model)):
        eng, report[name] = spec_engine_run(torch, decode, model, d, rng,
                                            slot_len)
        log(f"speculative engine ({name}):", json.dumps(report[name]))
        if report[name]["leaks"] is not None:
            raise AssertionError(f"speculative engine ({name}) not clean: "
                                 f"{report[name]['leaks']}")
        del eng
    if report["self"]["acceptance"] < SPEC_ACCEPT_ENGINE:
        raise AssertionError(f"engine self-draft acceptance "
                             f"{report['self']['acceptance']:.4f} < "
                             f"{SPEC_ACCEPT_ENGINE}")
    torch.cuda.empty_cache()
    return report


def drive_spec(torch, convert, kernels, rng):
    """Phase 10 (see the module docstring). Returns (report, launches by
    path)."""
    from container_engine_accelerators_tpu_torch.models import decode
    from container_engine_accelerators_tpu_torch.models import speculative
    t0 = time.perf_counter()
    model = convert.load_lm(MODEL, convert.init_flax_layout_params(MODEL,
                                                                   SEED))
    draft = convert.load_lm(SPEC_DRAFT, convert.init_flax_layout_params(
        SPEC_DRAFT, SEED + 1))
    report, launches = drive_spec_decode(torch, speculative, convert, model,
                                         draft, kernels, rng)
    report["serving"], launches["spec_serving"] = drive_spec_serving(
        torch, kernels, rng)
    report["engine"] = drive_spec_engine(torch, decode, model, draft,
                                         kernels, rng)
    report["phase_s"] = time.perf_counter() - t0
    del model, draft
    torch.cuda.empty_cache()
    return report, launches


# ---------------------------------------------------------------------
# Phase 11: the serving contract.
# ---------------------------------------------------------------------


def spawn_launcher(argv, env=None):
    """The port's launcher in its own process on ``argv`` (``env`` on
    top of this process's), its stderr piped for ``launcher_port``."""
    return subprocess.Popen(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.serving.serve"] + argv,
        cwd=REPO_ROOT, env=dict(os.environ, **(env or {})), text=True,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def launch_process(argv, env=None):
    """The port's launcher in its own process on ``argv``; returns
    (process, port, stderr lines) once it prints the port it serves on
    (the rest of its stderr is drained on a thread)."""
    proc = spawn_launcher(argv, env)
    return (proc,) + launcher_port(proc, argv)


def launcher_port(proc, argv):
    """(port, stderr lines) once the launcher ``proc`` prints the port
    it serves on; the rest of its stderr is drained on a thread."""
    lines, port = [], None
    while port is None:
        line = proc.stderr.readline()
        if not line:
            proc.wait(timeout=60)
            raise AssertionError(f"launcher {argv} exited {proc.returncode}"
                                 f" before serving: {lines[-20:]}")
        lines.append(line.rstrip())
        m = re.search(r"on port (\d+)", line)
        port = int(m.group(1)) if m else None

    def drain():
        for line in proc.stderr:
            lines.append(line.rstrip())

    threading.Thread(target=drain, daemon=True).start()
    return port, lines


def stop_process(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=60)


def http_call(port, path, payload=None, headers=None, timeout=600):
    """(status, headers, parsed JSON body) of a GET or POST; an HTTP
    error status is an answer here."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def class_check(logits, pred):
    """None when ``pred`` (a predict response row) is the argmax and
    top softmax probability of ``logits`` (f32 [classes]) within the
    bf16 limit, else what differs: a class other than the argmax must
    sit within 2e-2 of the largest logit of it (a near tie), the score
    within 2e-2 of the top probability."""
    top = int(logits.argmax())
    gap = float(logits.max() - logits[pred["class"]])
    score = float(logits.softmax(-1).max())
    near = gap <= 2e-2 * float(logits.abs().max())
    if (pred["class"] == top or near) and abs(pred["score"] - score) <= 2e-2:
        return None
    return dict(got=pred, want_class=top, want_score=score, gap=gap)


def drive_predict(torch, convert, proc, port):
    """Phase 11a: jax-serving.yaml's command line through the port's
    launcher (a process on the card): /readyz 200, 8 instances in one
    request and 8 one-instance requests at once against the same
    ResNet-50's eval forward run here, then p50 latencies and images/s
    (informational)."""
    import numpy as np

    from container_engine_accelerators_tpu_torch.models.resnet import resnet
    size = RESNET_SIZE
    deadline = time.perf_counter() + 300
    while http_call(port, "/readyz")[0] != 200:
        if time.perf_counter() > deadline or proc.poll() is not None:
            raise AssertionError("the predict server never became ready")
        time.sleep(0.1)
    meta = http_call(port, "/v1/models/resnet")[2]
    info = meta["model_version_status"][0]["metadata"]
    if info != {"kind": "predict", "input_shape": [size, size, 3],
                "max_batch": PREDICT_BATCH}:
        raise AssertionError(f"predict server metadata: {info}")
    # Two decimals keep the JSON body near 1 MB an image; the server
    # and the forward here read the same f32 values.
    rng = np.random.default_rng(SEED + 11)
    values = np.round(rng.standard_normal((PREDICT_BATCH, size, size, 3)),
                      2)
    images = values.astype(np.float32)
    model = resnet(depth=PREDICT_DEPTH, device="meta")
    model = convert.load_image_model(
        model.to_empty(device="cuda"),
        convert.init_flax_layout_image(model, SEED)).eval()
    with torch.inference_mode():
        logits = model(torch.from_numpy(images).cuda()).float().cpu()
    del model
    path = "/v1/models/resnet:predict"
    t0 = time.perf_counter()
    status, _, batch = http_call(port, path, {"instances": values.tolist()})
    batch_ms = 1e3 * (time.perf_counter() - t0)
    singles = [None] * PREDICT_BATCH

    def client(i):
        singles[i] = http_call(port, path, {"instances": [values[i].tolist()]})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(PREDICT_BATCH)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if status != 200 or any(s is None or s[0] != 200 for s in singles):
        raise AssertionError(f"predict failed: {status} {batch} {singles}")
    mismatches = []
    for i in range(PREDICT_BATCH):
        for how, pred in (("batch", batch["predictions"][i]),
                          ("single", singles[i][2]["predictions"][0])):
            bad = class_check(logits[i], pred)
            if bad is not None:
                mismatches.append(dict(bad, row=i, how=how))
    exact = sum(p["class"] == int(logits[i].argmax())
                for i, p in enumerate(batch["predictions"]))
    one_body = {"instances": [values[0].tolist()]}
    eight_body = {"instances": values.tolist()}
    one_ms, eight_ms = [], []
    for body, out, n in ((one_body, one_ms, 8), (eight_body, eight_ms, 3)):
        for _ in range(n):
            t0 = time.perf_counter()
            if http_call(port, path, body)[0] != 200:
                raise AssertionError("timed predict request failed")
            out.append(1e3 * (time.perf_counter() - t0))
    stats = http_call(port, "/stats")[2]
    report = dict(metadata=info, batch_exact=exact, mismatches=mismatches,
                  first_batch_ms=batch_ms,
                  p50_ms_1=float(np.median(one_ms)),
                  p50_ms_8=float(np.median(eight_ms)),
                  images_per_s=8e3 / float(np.median(eight_ms)),
                  stats={k: stats.get(k) for k in ("requests", "shed",
                                                   "p50_ms", "device")})
    log("predict server:", json.dumps(report))
    if mismatches:
        raise AssertionError(f"predictions differ from the forward: "
                             f"{mismatches}")
    if stats.get("device") != "cuda:0":
        raise AssertionError(f"predict server not on the card: {stats}")
    return report


def drill_traffic(server, lengths, rng, vocab):
    """Concurrent greedy requests of ``lengths`` tokens, DRILL_NEW new
    tokens each. Returns [(prompt, sequence)]."""
    import numpy as np
    prompts = [rng.integers(0, vocab, n).tolist() for n in lengths]
    results, errors = [None] * len(prompts), []

    def client(i):
        try:
            results[i] = post(server.port, {"prompts": [prompts[i]],
                                            "max_new_tokens": DRILL_NEW})
        except Exception as e:  # reported below, fails the run
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(r is None or r[0] != 200 for r in results):
        raise AssertionError(f"drill requests failed: {errors} {results}")
    return [(p, r[1]["sequences"][0]) for p, r in zip(prompts, results)]


def quarantine_events(obs):
    events = obs.TRACER.snapshot()["events"]
    return ([e for e in events if e["name"] == "serving.engine_quarantine"],
            [e for e in events if e["name"] == "serving.engine_recovered"])


def drive_fault_drill(torch, model, kernels, rng, wants):
    """Phase 11b: CEA_TPU_FAULT_PLAN {"step": [N]}, then {"prefill":
    [N]}, on the dense and the paged pool of the GenerationServer at
    full width, each with DRILL_LENGTHS concurrent greedy requests:
    one quarantine (naming an InjectedFault) and one rebuild a plan,
    every stream equal to greedy_decode's or first differing at a near
    tie, MODEL's layers of flash_fwd launches a replay admission on the
    dense pool and 0 on the paged pool, the pool clean when idle.
    Returns (report, launches by path)."""
    from container_engine_accelerators_tpu_torch import obs
    from container_engine_accelerators_tpu_torch.ops import attention
    from container_engine_accelerators_tpu_torch.serving.server import (
        GenerationServer,
    )
    from container_engine_accelerators_tpu_torch.utils import faults
    layers = MODEL["num_layers"]
    report, launches = {}, {}
    for pool in ("dense", "paged"):
        totals = {kern.name: 0 for kern in kernels}
        for plan in DRILL_PLANS:
            if pool == "dense":
                os.environ["CEA_TPU_PAGED_KV"] = "0"
            try:
                server = GenerationServer("lm", model, port=0,
                                          max_new_tokens=MAX_NEW,
                                          max_batch=MAX_BATCH,
                                          host="127.0.0.1")
            finally:
                os.environ.pop("CEA_TPU_PAGED_KV", None)
            svc = server._engine_service
            first_engine = server.engine
            replays = []
            real_admit = svc._admit

            def spy(work, real_admit=real_admit, replays=replays):
                replay = bool(work.tokens)
                before = attention.flash_fwd.launches
                out = real_admit(work)
                if replay:
                    replays.append(attention.flash_fwd.launches - before)
                return out

            svc._admit = spy
            server.start()
            q0, r0 = (len(x) for x in quarantine_events(obs))
            try:
                os.environ[faults.FAULT_PLAN_ENV] = json.dumps(plan)
                faults.reset()   # the next fire parses the plan
                for kern in kernels:
                    kern.launches = 0
                p0 = first_engine.prefills
                greedy = drill_traffic(server, DRILL_LENGTHS, rng,
                                       MODEL["vocab_size"])
                counts = {kern.name: kern.launches for kern in kernels}
                fired = faults.active().fired()
                deadline = time.perf_counter() + 60
                while server.stats()["slots_active"] and (
                        time.perf_counter() < deadline):
                    time.sleep(0.01)
                stats = server.stats()
                admissions = (first_engine.prefills - p0
                              + server.engine.prefills)
                leaks = server.engine.pool_leak_report()
            finally:
                os.environ.pop(faults.FAULT_PLAN_ENV, None)
                faults.reset()
                server.stop()
            quarantines, recovered = quarantine_events(obs)
            quarantines, recovered = quarantines[q0:], recovered[r0:]
            diverged = []
            for p, seq in greedy:
                d = stream_divergence(torch, model, p, DRILL_NEW, seq,
                                      wants)
                if d is not None:
                    diverged.append(d)
            key = f"{pool}_{next(iter(plan))}"
            entry = dict(plan=plan, fired=fired, launches=counts,
                         admissions=admissions, replay_launches=replays,
                         greedy=len(greedy),
                         greedy_exact=len(greedy) - len(diverged),
                         greedy_diverged=diverged, leaks=leaks,
                         quarantine_errors=[e["fields"].get("error_type")
                                            for e in quarantines],
                         recovered=len(recovered),
                         stats={k: stats[k] for k in (
                             "engine_rebuilds", "quarantine_episodes",
                             "replayed_rows", "replayed_tokens",
                             "engine_state", "requests_retired")})
            report[key] = entry
            log(f"fault drill ({key}):", json.dumps(entry))
            per_replay = layers if pool == "dense" else 0
            if (stats["engine_rebuilds"] != 1
                    or stats["quarantine_episodes"] != 1
                    or len(quarantines) != 1 or len(recovered) != 1
                    or fired != plan):
                raise AssertionError(f"fault drill {key}: not one "
                                     f"quarantine and one rebuild")
            if entry["quarantine_errors"] != ["InjectedFault"]:
                raise AssertionError(f"fault drill {key}: a quarantine "
                                     f"not caused by the injected fault: "
                                     f"{quarantines}")
            if not replays or any(n != per_replay for n in replays):
                raise AssertionError(f"fault drill {key}: replay launches "
                                     f"{replays}, want {per_replay} each")
            if (counts["flash_fwd"] != per_replay * admissions
                    or any(n for k, n in counts.items() if k != "flash_fwd")):
                raise AssertionError(f"fault drill {key}: launches {counts} "
                                     f"for {admissions} admissions")
            if leaks is not None or stats["engine_state"] != "serving":
                raise AssertionError(f"fault drill {key}: pool {leaks}, "
                                     f"state {stats['engine_state']}")
            if not all(d["near_tie"] for d in diverged):
                raise AssertionError(f"fault drill {key}: streams diverge "
                                     f"off a near tie: {diverged}")
            totals = {k: totals[k] + counts[k] for k in totals}
            del server, svc, first_engine
            torch.cuda.empty_cache()
        launches[f"fault_drill_{pool}"] = totals
    return report, launches


def lm_flags():
    return ["--model", "transformer", "--model-name", "lm", "--port", "0",
            "--vocab-size", str(MODEL["vocab_size"]),
            "--embed-dim", str(MODEL["embed_dim"]),
            "--num-layers", str(MODEL["num_layers"]),
            "--num-heads", str(MODEL["num_heads"]),
            "--num-kv-heads", str(MODEL["num_kv_heads"]),
            "--pos-embedding", MODEL["pos_embedding"],
            "--max-seq-len", str(MODEL["max_seq_len"]),
            "--max-new-tokens", str(MAX_NEW),
            "--max-batch", str(MAX_BATCH), "--seed", str(SEED)]


def drive_drain(proc, port):
    """Phase 11c: SIGTERM to a launcher process (the LM on the paged
    pool) with DRAIN_PROMPTS streams in flight: /readyz turns 503
    {"state": "draining"}, a new POST gets 503 with Retry-After, every
    stream finishes with its done line and all its tokens, and the
    process exits 0."""
    import signal

    import numpy as np
    vocab = MODEL["vocab_size"]
    rng = np.random.default_rng(SEED + 12)
    prompts = [rng.integers(0, vocab, n).tolist() for n in DRAIN_PROMPTS]
    conns, firsts = [], []
    for p in prompts:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/lm:generate",
            data=json.dumps({"prompts": [p], "max_new_tokens": MAX_NEW,
                             "stream": True}).encode())
        conns.append(urllib.request.urlopen(req, timeout=600))
    for c in conns:
        firsts.append(json.loads(c.readline()))
    t0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    while http_call(port, "/readyz")[0] != 503:
        if time.perf_counter() - t0 > 30:
            raise AssertionError("/readyz did not turn 503 after SIGTERM")
        time.sleep(0.005)
    readyz = http_call(port, "/readyz")
    post_code, post_headers, post_body = http_call(
        port, "/v1/models/lm:generate", {"prompts": [[1, 2, 3]],
                                         "max_new_tokens": 2})
    streams = []
    for c, first in zip(conns, firsts):
        lines = [first] + [json.loads(x) for x in c.read().splitlines()]
        c.close()
        streams.append(lines)
    rc = proc.wait(timeout=120)
    report = dict(readyz_code=readyz[0], readyz=readyz[2],
                  post_code=post_code,
                  retry_after=post_headers.get("Retry-After"),
                  stream_tokens=[sum(len(x.get("tokens", [])) for x in s)
                                 for s in streams],
                  stream_ends=[s[-1] for s in streams], exit_code=rc,
                  drain_s=time.perf_counter() - t0)
    log("drain:", json.dumps(report))
    if (readyz[0] != 503 or readyz[2].get("state") != "draining"
            or post_code != 503 or int(post_headers["Retry-After"]) < 1
            or "request_id" not in post_body):
        raise AssertionError(f"drain did not shed: {report}")
    if (any(e != {"done": True} for e in report["stream_ends"])
            or any(n != MAX_NEW for n in report["stream_tokens"])):
        raise AssertionError(f"drained streams did not finish: {report}")
    if rc != 0:
        raise AssertionError(f"launcher exited {rc} after the drain")
    return report


def prefix_traffic(server, prefix, rng):
    vocab = MODEL["vocab_size"]
    suffixes = [rng.integers(0, vocab, n).tolist() for n in PREFIX_SUFFIXES]
    results, errors = [None] * len(suffixes), []

    def client(i):
        try:
            results[i] = post(server.port, {"prompts": [suffixes[i]],
                                            "max_new_tokens": DRILL_NEW})
        except Exception as e:  # reported below, fails the run
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(suffixes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(r is None or r[0] != 200 for r in results):
        raise AssertionError(f"prefix requests failed: {errors} {results}")
    return [(prefix + s, prefix + r[1]["sequences"][0])
            for s, r in zip(suffixes, results)]


def drive_prefix(torch, model, kernels, rng, wants):
    """Phase 11d/e: ``--system-prefix-ids`` with PREFIX_IDS ids, alone
    and with ``--speculative-k 4``: every request a prefix hit, suffix
    streams against greedy_decode over prefix + suffix (the near-tie
    rule), no launch alone and 2 (the draft's prefill) a greedy
    admission with speculation; on the first server /metrics,
    /debug/requests and a traceparent round trip. Returns (report,
    launches by path)."""
    import numpy as np

    from container_engine_accelerators_tpu_torch import obs
    from container_engine_accelerators_tpu_torch.serving import serve
    vocab = MODEL["vocab_size"]
    prefix = np.random.default_rng(SEED + 13).integers(
        0, vocab, PREFIX_IDS).tolist()
    flags = lm_flags() + ["--system-prefix-ids",
                          ",".join(map(str, prefix))]
    report, launches = {}, {}
    for name, extra in (("system_prefix", []),
                        ("system_prefix_spec",
                         ["--speculative-k", str(SPEC_K)])):
        server = serve.build_server(serve.parse_args(flags + extra))
        server.start()
        try:
            eng = server.engine
            before = server.stats()
            for kern in kernels:
                kern.launches = 0
            streams = prefix_traffic(server, prefix, rng)
            counts = {kern.name: kern.launches for kern in kernels}
            stats = server.stats()
            contract = (drive_observability(obs, server)
                        if name == "system_prefix" else None)
            leaks = eng.pool_leak_report()
        finally:
            server.stop()
        diverged = [d for d in (stream_divergence(torch, model, p,
                                                  DRILL_NEW, seq, wants)
                                for p, seq in streams) if d is not None]
        hits = stats["prefix_hits"] - before["prefix_hits"]
        drafts = stats["draft_prefills"] - before["draft_prefills"]
        entry = dict(launches=counts, prefix_hits=hits,
                     prefix_tokens_shared=stats["prefix_tokens_shared"]
                     - before["prefix_tokens_shared"],
                     draft_prefills=drafts, pinned_blocks=len(eng._pinned),
                     greedy=len(streams),
                     greedy_exact=len(streams) - len(diverged),
                     greedy_diverged=diverged, leaks=leaks,
                     acceptance=stats["speculative_acceptance_rate"])
        if contract is not None:
            entry["observability"] = contract
        report[name] = entry
        log(f"{name}:", json.dumps(entry))
        n = len(PREFIX_SUFFIXES)
        want = SPEC_DRAFT["num_layers"] * n if extra else 0
        if (hits != n or counts["flash_fwd"] != want
                or any(v for k, v in counts.items() if k != "flash_fwd")
                or drafts != (n if extra else 0)):
            raise AssertionError(f"{name}: {entry}")
        if leaks is not None:
            raise AssertionError(f"{name}: pool not clean: {leaks}")
        if not all(d["near_tie"] for d in diverged):
            raise AssertionError(f"{name}: streams diverge off a near tie: "
                                 f"{diverged}")
        launches[name] = counts
        del server, eng
        torch.cuda.empty_cache()
    return report, launches


def drive_observability(obs, server):
    """Phase 11e on a running LM server: /metrics carries the TTFT
    buckets of the traffic, /debug/requests records whose buckets sum
    to their wall time, and a request sent with a traceparent and a
    request id lands under that trace (the serving.request span's
    parent is the header's span) with the id in its ledger record."""
    port = server.port
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=60) as resp:
        text = resp.read().decode()
    ttft = re.search(r'tpu_serving_ttft_seconds_count (\d+)', text)
    if not ttft or int(ttft.group(1)) < len(PREFIX_SUFFIXES):
        raise AssertionError("/metrics lacks the TTFT histogram")
    trace_id, span_id, rid = 0x5EED00C0FFEE, 0xABCDEF, "chip-smoke-11"
    status, _, _ = http_call(
        port, "/v1/models/lm:generate",
        {"prompts": [[1, 2, 3]], "max_new_tokens": 4},
        headers={"traceparent": obs.format_traceparent((trace_id, span_id)),
                 "x-cea-request-id": rid})
    spans = [s for s in obs.TRACER.snapshot()["spans"]
             if s["name"] == "serving.request" and s["trace_id"] == trace_id]
    records = http_call(port, "/debug/requests?n=8")[2]["records"]
    mine = [r for r in records if r.get("request_id") == rid]
    bad_sums = [r for r in records
                if abs(sum(r["buckets"].values()) - r["wall_s"]) > 1e-5]
    out = dict(buckets_in_metrics=text.count("_bucket{"),
               ttft_count=int(ttft.group(1)), traced_spans=len(spans),
               records=len(records), bad_sums=len(bad_sums))
    if (status != 200 or len(spans) != 1
            or spans[0]["parent_id"] != span_id
            or spans[0]["attrs"].get("request_id") != rid
            or len(mine) != 1 or mine[0].get("trace_id") != "%x" % trace_id
            or bad_sums):
        raise AssertionError(f"observability round trip: {out}, {spans}, "
                             f"{mine}")
    return out


def drive_contract(torch, convert, model, kernels):
    """Phase 11 (see the module docstring). The predict and drain
    launchers start first, in their own processes, and warm up while
    the in-process parts run. Returns (report, launches by path)."""
    import numpy as np
    t0 = time.perf_counter()
    predict = launch_process(manifest_argv(PREDICT_MANIFEST) + ["--port=0"])
    drain = launch_process(lm_flags())
    try:
        report = {"predict": drive_predict(torch, convert, predict[0],
                                           predict[1])}
        predict[0].terminate()
        report["predict"]["exit_code"] = predict[0].wait(timeout=120)
        rng = np.random.default_rng(SEED + 14)
        wants = {}
        report["fault_drill"], launches = drive_fault_drill(
            torch, model, kernels, rng, wants)
        report["prefix"], more = drive_prefix(torch, model, kernels, rng,
                                              wants)
        launches.update(more)
        report["drain"] = drive_drain(drain[0], drain[1])
    finally:
        stop_process(predict[0])
        stop_process(drain[0])
    if report["predict"]["exit_code"] != 0:
        raise AssertionError("the predict server did not exit 0 on SIGTERM")
    report["phase_s"] = time.perf_counter() - t0
    log(f"serving contract phase: {report['phase_s']:.1f} s")
    return report, launches


# The fleet phase (12): lm-serving.yaml's architecture in two launcher
# processes behind the port's router and collector. A runs the paged
# pool (what deploy/fleet/engine.yaml deploys), B the dense pool, whose
# admission prefill runs #1, as does a splice's resubmit onto it.
FLEET_SHARED = 1000                  # the shared prefix's tokens
FLEET_UNSHARED = (16, 100, 500, 1000)
FLEET_SUFFIXES = (16, 40, 70, 100)   # after the shared prefix
# The kernels each path must launch at least once in this run, by the
# path's name in the launch record.
PATH_KERNELS = {"fleet": ("flash_fwd",)}


def start_fleet_engines():
    """Phase 12's engines, started before phase 11 so they warm up while
    it runs: {name: (process, thread that reads its port, result)}.
    The thread reads the port and keeps draining stderr from the
    start, so a chatty warm-up never blocks on a full pipe."""
    engines = {}
    for name, env in (("A", None), ("B", {"CEA_TPU_PAGED_KV": "0"})):
        argv = lm_flags() + ["--warm"]
        proc = spawn_launcher(argv, env)
        result = {}

        def read(proc=proc, argv=argv, result=result):
            try:
                result["port"] = launcher_port(proc, argv)[0]
            except AssertionError as e:
                result["error"] = str(e)

        thread = threading.Thread(target=read, daemon=True)
        thread.start()
        engines[name] = (proc, thread, result)
    return engines


def fleet_stream(port, prompt, rid, first=None):
    """One greedy stream of MAX_NEW tokens through the router, with its
    own request id: (tokens, error line or None). ``first`` is set at
    the first token line."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/lm:generate",
        data=json.dumps({"prompts": [prompt], "max_new_tokens": MAX_NEW,
                         "stream": True}).encode(),
        headers={"x-cea-request-id": rid})
    tokens = []
    with urllib.request.urlopen(req, timeout=600) as resp:
        for raw in resp:
            line = json.loads(raw)
            if "tokens" in line:
                tokens.extend(line["tokens"])
                if first is not None:
                    first.set()
            elif line.get("done"):
                return tokens, None
            else:
                return tokens, line
    return tokens, {"error": "stream ended without done"}


def fleet_streams(port, jobs):
    """``jobs`` [(rid, prompt, first event or None)] streamed at once;
    returns {rid: (tokens, error)}."""
    results = {}

    def client(rid, prompt, first):
        try:
            results[rid] = fleet_stream(port, prompt, rid, first)
        except Exception as e:  # reported below, fails the phase
            results[rid] = ([], {"error": repr(e)})

    threads = [threading.Thread(target=client, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return results


def wait_for(predicate, what, timeout_s=60.0):
    deadline = time.perf_counter() + timeout_s
    while True:
        out = predicate()
        if out:
            return out
        if time.perf_counter() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def drive_fleet(torch, model, engines, wants):
    """Phase 12 (see the module docstring): (a) 8 greedy streams through
    the router, 4 of them on a shared 1000-token prefix whose repeats
    land by affinity on A; (b) SIGKILL A with >= 2 of them mid-flight:
    every stream completes, each spliced tail equals B's direct answer
    for prompt + the tokens delivered before the kill, the failover
    counter moves, and B's flash_fwd launches grow by MODEL's layers a
    splice admission; (c) B quiesces clean; (d) one trace id a spliced
    journey, with B's serving.request span under the router's; (e)
    SIGUSR1 drains B and the router sheds 503 with Retry-After, its
    /readyz 503. Returns (report, launches by path)."""
    import signal

    import numpy as np

    from container_engine_accelerators_tpu_torch import obs
    from container_engine_accelerators_tpu_torch.obs.fleet import (
        FleetCollector,
    )
    from container_engine_accelerators_tpu_torch.router_check import (
        router_overhead_ms,
    )
    from container_engine_accelerators_tpu_torch.serving.affinity import (
        affinity_key,
    )
    from container_engine_accelerators_tpu_torch.serving.router import (
        RouterCore,
        RouterServer,
    )
    t0 = time.perf_counter()
    layers = MODEL["num_layers"]
    procs = {name: e[0] for name, e in engines.items()}
    ports = {}
    for name, (proc, thread, result) in engines.items():
        thread.join(timeout=600)
        if "port" not in result:
            raise AssertionError(f"fleet engine {name}: {result}")
        ports[name] = result["port"]
        wait_for(lambda port=ports[name]: healthz(port) == 200,
                 f"engine {name} to warm up", 600)
    pools = {name: get(port, "/stats")["kv_pool"]
             for name, port in ports.items()}
    if pools != {"A": "paged", "B": "dense"}:
        raise AssertionError(f"fleet engines' pools: {pools}")
    urls = {name: f"http://127.0.0.1:{port}" for name, port in ports.items()}
    # The collector and router as deploy/fleet/router.yaml runs them:
    # the default poll interval, shed saturation and spill bound.
    collector = FleetCollector(list(urls.values()))
    core = RouterCore(collector)
    router = RouterServer(core, collector, port=0)
    collector.start()
    router.start()
    rport = router.port
    # Traffic starts once the router is ready, as its readinessProbe
    # gates it in the deployment (the first poll sweep has landed).
    wait_for(lambda: http_call(rport, "/readyz")[0] == 200,
             "the router's /readyz", 30)
    rng = np.random.default_rng(SEED + 15)
    vocab = MODEL["vocab_size"]
    shared = rng.integers(0, vocab, FLEET_SHARED).tolist()
    prompts = {f"fleet-u{i}": rng.integers(0, vocab, n).tolist()
               for i, n in enumerate(FLEET_UNSHARED)}
    prompts.update({f"fleet-s{i}": shared + rng.integers(0, vocab, n).tolist()
                    for i, n in enumerate(FLEET_SUFFIXES)})
    spliced_rids = [f"fleet-s{i}" for i in range(1, len(FLEET_SUFFIXES))]

    def b_stats():
        return get(ports["B"], "/stats")

    try:
        b0 = b_stats()
        # (a) the unshared streams at once; then the shared prefix's
        # first request on A (its blocks live there from now on).
        results = fleet_streams(rport, [(rid, prompts[rid], None)
                                        for rid in prompts if "-u" in rid])
        key = affinity_key(shared, core.block_size, core.affinity_blocks)
        core.repoint(key, urls["A"])
        results.update(fleet_streams(rport, [("fleet-s0",
                                              prompts["fleet-s0"], None)]))
        routed_a = dict(core.stats()["routed"])
        # (b) the shared prefix's repeats, SIGKILL A mid-flight.
        b1 = b_stats()
        failover0 = core.stats()["failover"]
        firsts = [threading.Event() for _ in spliced_rids]
        jobs = [(rid, prompts[rid], first)
                for rid, first in zip(spliced_rids, firsts)]
        box = {}
        runner = threading.Thread(
            target=lambda: box.update(fleet_streams(rport, jobs)))
        runner.start()
        wait_for(lambda: sum(e.is_set() for e in firsts) >= 2,
                 "two shared-prefix streams to start", 120)
        inflight_a = dict(core._inflight).get(urls["A"], 0)
        procs["A"].kill()
        procs["A"].wait(timeout=60)
        runner.join(timeout=600)
        results.update(box)
        routed = dict(core.stats()["routed"])
        failovers = core.stats()["failover"] - failover0
        b2 = b_stats()
        b_records = {r["request_id"]: r for r in get(
            ports["B"], "/debug/requests?n=64")["records"]}
        # Each spliced tail against B asked directly for prompt + the
        # tokens delivered before the kill (B's record of the resubmit
        # holds that prompt's length).
        splices, tails = {}, {}
        for rid in spliced_rids:
            rec = b_records.get(rid)
            if rec is None:
                continue
            tokens = results[rid][0]
            d = rec["prompt_len"] - len(prompts[rid])
            status, body = post(ports["B"], {
                "prompts": [prompts[rid] + tokens[:d]],
                "max_new_tokens": MAX_NEW - d})
            direct = body["sequences"][0][len(prompts[rid]) + d:]
            splices[rid] = d
            tails[rid] = (status == 200 and direct == tokens[d:])
        # (c) B quiesces with its pool clean.
        b3 = wait_for(lambda: (lambda s: s if s["slots_active"] == 0
                               and s["queue_depth"] == 0 else None)(
                                   b_stats()), "B to quiesce")
        # (d) one trace a spliced journey.
        journeys = {}
        for r in http_call(rport, "/debug/requests")[2]["records"]:
            journeys.setdefault(r["request_id"], []).append(r)
        b_spans = {s["attrs"].get("request_id"): s for s in get(
            ports["B"], "/debug/trace")["spans"]
            if s["name"] == "serving.request"}
        router_spans = {s["attrs"].get("request_id"): s
                        for s in obs.TRACER.snapshot()["spans"]
                        if s["name"] == "router.request"}
        traces = {}
        for rid in splices:
            recs = journeys.get(rid, [])
            rec = recs[0] if len(recs) == 1 else {}
            span, parent = b_spans.get(rid), router_spans.get(rid)
            traces[rid] = dict(
                records=len(recs), hops=rec.get("hops"),
                trace_id=rec.get("trace_id"),
                b_span_trace=(None if span is None
                              else "%x" % span["trace_id"]),
                parented=(span is not None and parent is not None
                          and span["parent_id"] == parent["span_id"]),
                sum_err=(abs(sum(rec["buckets"].values()) - rec["wall_s"])
                         if rec else None),
                wall_s=rec.get("wall_s"),
                splice_resubmit_s=(rec["buckets"].get("splice_resubmit")
                                   if rec else None))
        overhead_ms, tax_ms = router_overhead_ms(
            [r for recs in journeys.values() for r in recs
             if r["outcome"] == "completed"])
        metrics = urllib.request.urlopen(
            f"http://127.0.0.1:{rport}/metrics", timeout=60).read().decode()
        # (e) drain B: the fleet has nowhere to send new work.
        os.kill(procs["B"].pid, signal.SIGUSR1)
        wait_for(lambda: http_call(rport, "/readyz")[0] == 503,
                 "the router's /readyz to turn 503", 30)
        shed_code, shed_headers, shed_body = http_call(
            rport, "/v1/models/lm:generate",
            {"prompts": [prompts["fleet-u0"]], "max_new_tokens": 2})
    finally:
        router.stop()
        collector.stop()
        for proc in procs.values():
            stop_process(proc)
    divergence = {}
    for rid, prompt in prompts.items():
        tokens, err = results.get(rid, ([], {"error": "missing"}))
        if err is not None or len(tokens) != MAX_NEW:
            raise AssertionError(f"fleet stream {rid}: {len(tokens)} "
                                 f"tokens, error {err}")
        divergence[rid] = stream_divergence(torch, model, prompt, MAX_NEW,
                                            prompt + tokens, wants)
    b_prefills = b2["engine_prefills"] - b0["engine_prefills"]
    b_launches = b2["flash_fwd_launches"] - b0["flash_fwd_launches"]
    splice_launches = b2["flash_fwd_launches"] - b1["flash_fwd_launches"]
    report = dict(
        smi=smi_line(), pools=pools, routed_before_kill=routed_a,
        routed=routed, inflight_on_a_at_kill=inflight_a,
        failovers=failovers, splices=splices, spliced_tails_exact=tails,
        splice_launches=splice_launches, flash_fwd_launches=b_launches,
        b_prefills=b_prefills,
        first_divergence={rid: (None if d is None else d["first_diff"])
                          for rid, d in divergence.items()},
        diverged=[dict(d, rid=rid) for rid, d in divergence.items() if d],
        b_quiesced={k: b3[k] for k in (
            "slots", "slots_free", "slots_active", "queue_depth",
            "requests_admitted", "requests_retired", "engine_state")},
        traces=traces, router_overhead_ms=overhead_ms,
        router_overhead_by_bucket_ms=tax_ms,
        failover_metric="tpu_router_failover_total" in metrics,
        shed=dict(code=shed_code,
                  retry_after=shed_headers.get("Retry-After"),
                  error=shed_body.get("error")),
        phase_s=time.perf_counter() - t0)
    log("fleet:", json.dumps(report))
    if routed_a.get("affinity", 0) < 1 or routed.get("affinity", 0) \
            < routed_a["affinity"] + len(spliced_rids):
        raise AssertionError(f"fleet: the shared prefix's repeats were not "
                             f"affinity hits: {routed_a} -> {routed}")
    if inflight_a < 2 or failovers < 2 or len(splices) < 2 \
            or not report["failover_metric"]:
        raise AssertionError(f"fleet: the kill spliced {len(splices)} "
                             f"streams ({failovers} failovers, "
                             f"{inflight_a} in flight on A)")
    if not all(tails.values()):
        raise AssertionError(f"fleet: spliced tails differ from B's "
                             f"direct answer: {tails}")
    if not all(d["near_tie"] for d in report["diverged"]):
        raise AssertionError(f"fleet: streams diverge off a near tie: "
                             f"{report['diverged']}")
    q = report["b_quiesced"]
    if (q["slots_free"] != q["slots"] or q["engine_state"] != "serving"
            or q["requests_admitted"] != q["requests_retired"]):
        raise AssertionError(f"fleet: B not clean after the kill: {q}")
    for rid, t in traces.items():
        if (t["records"] != 1 or not t["hops"] or not t["trace_id"]
                or t["b_span_trace"] != t["trace_id"] or not t["parented"]
                or t["sum_err"] > max(0.01 * t["wall_s"], 2e-5)):
            raise AssertionError(f"fleet: journey {rid} is not one trace: "
                                 f"{t}")
    if shed_code != 503 or int(shed_headers.get("Retry-After") or 0) < 1:
        raise AssertionError(f"fleet: drained fleet answered {report['shed']}")
    if (splice_launches != layers * len(splices)
            or b_launches != layers * b_prefills):
        raise AssertionError(
            f"fleet: B launched flash_fwd {splice_launches} times for "
            f"{len(splices)} splice admissions ({b_launches} for "
            f"{b_prefills} admissions in all)")
    log(f"fleet phase: {report['phase_s']:.1f} s")
    return report, {"fleet": {"flash_fwd": b_launches}}


# ---------------------------------------------------------------------
# Phase 13: the MoE family.
# ---------------------------------------------------------------------

# The LM serving architecture with the launchers' MoE defaults: 8
# experts, top-2 routing at capacity factor 1.25 (a dropping router)
# on the 4 odd layers, 67.1 M expert parameters.
MOE = dict(MODEL, num_experts=8)
MOE_ROUTE_T = 2048                  # the routing check's token group
MOE_STEPS = 5
MOE_WARMUP = 2
MOE_NEW = 32
# Concurrent greedy requests through serve.py: buckets 16 and 128, a
# 300-token one and one past 1000 tokens (bucket 1920 on the dense
# pool).
MOE_SERVE = (16, 16, 100, 128, 300, 1100)
MOE_SPEC = (16, 100, 700)            # drop-free speculation's requests
MOE_AUX_TOL = 1e-5
PATH_KERNELS.update({
    "moe_training": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     "xent_fwd", "xent_bwd"),
    "moe_dense_serving": ("flash_fwd",),
    "moe_spec_serving": ("flash_fwd",),
})


def set_moe_fn(moe, model, fn):
    """Route every MoE layer of ``model`` through ``fn`` (None: back to
    the class's ``expert.dense_moe``)."""
    for m in model.modules():
        if isinstance(m, moe.MoEMlp):
            if fn is None:
                m.__dict__.pop("moe_fn", None)
            else:
                m.moe_fn = fn


def moe_argv(extra=()):
    """serve.py's flags for MOE on the card."""
    return ["--model", "moe", "--num-experts", str(MOE["num_experts"]),
            "--model-name", "lm", "--port", "0",
            "--vocab-size", str(MOE["vocab_size"]),
            "--embed-dim", str(MOE["embed_dim"]),
            "--num-layers", str(MOE["num_layers"]),
            "--num-heads", str(MOE["num_heads"]),
            "--num-kv-heads", str(MOE["num_kv_heads"]),
            "--pos-embedding", MOE["pos_embedding"],
            "--max-seq-len", str(MOE["max_seq_len"]),
            "--max-new-tokens", str(MOE_NEW), "--max-batch", str(MAX_BATCH),
            "--seed", str(SEED)] + list(extra)


def moe_routing(torch):
    """13a: one routed layer at the serving width (T 2048, d 512, E 8,
    bf16 tokens and experts, f32 gate, lecun-scaled weights from a
    seed): the index form's slot assignment must equal the dense
    form's exactly, its output lie within the bf16 rule of
    ``dense_moe_reference``'s and its aux within 1e-5. Both forms timed
    by CUDA events."""
    from container_engine_accelerators_tpu_torch.parallel import expert
    gen = torch.Generator().manual_seed(SEED)
    t, d, e = MOE_ROUTE_T, MOE["embed_dim"], MOE["num_experts"]
    f = 4 * d

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).cuda()

    # A shared offset, as a residual stream has, skews the routing so
    # that the preferred experts overflow their capacity.
    tokens = (randn(t, d) + randn(1, d)).bfloat16()
    gate = randn(d, e, scale=d ** -0.5)
    w_in = randn(e, d, f, scale=(e * d) ** -0.5).bfloat16()
    w_out = randn(e, f, d, scale=(e * f) ** -0.5).bfloat16()
    cap = expert.expert_capacity(t, e, 1.25, 2)
    logits = tokens.float() @ gate
    dispatch, combine, aux_dense = expert.top_k_routing(logits, cap)
    idx, slot, keep, weight, aux_idx = expert.top_k_routing_indices(
        logits, cap)
    rebuilt = torch.zeros_like(dispatch)
    rows = torch.arange(t, device="cuda")[:, None].expand_as(idx)
    rebuilt[rows[keep], idx[keep], slot[keep]] = 1.0
    weights = torch.zeros_like(combine)
    weights[rows[keep], idx[keep], slot[keep]] = weight[keep]
    out, aux = expert.dense_moe(tokens, gate, w_in, w_out)
    ref, ref_aux = expert.dense_moe_reference(tokens, gate, w_in, w_out)
    err, tol = near(out, ref, "torch.bfloat16")
    report = dict(
        tokens=t, capacity=cap, kept=int(keep.sum()),
        dropped=int((~keep).sum()),
        assignment_equal=bool(torch.equal(rebuilt, dispatch)),
        weights_equal=bool(torch.equal(weights, combine)),
        max_abs_err=err, tol=tol, aux=float(aux),
        aux_err=abs(float(aux) - float(ref_aux)),
        aux_index_vs_dense=abs(float(aux_idx) - float(aux_dense)),
        index_ms=cuda_ms(lambda: expert.dense_moe(tokens, gate, w_in,
                                                  w_out), 20),
        plain_ms=cuda_ms(lambda: expert.dense_moe_reference(
            tokens, gate, w_in, w_out), 20))
    log("moe routing:", json.dumps(report))
    if not (report["assignment_equal"] and report["weights_equal"]):
        raise AssertionError(f"moe: the index form's slots differ from the "
                             f"dense form's: {report}")
    if err > tol or report["aux_err"] > MOE_AUX_TOL or not report["dropped"]:
        raise AssertionError(f"moe: index form against the reference: "
                             f"{report}")
    return report


def moe_training(torch, train, attn, convert, kernels):
    """13b: MOE_STEPS steps of ``--model moe`` through the driver at
    phase 7's shape (8/8/8/1/1 launches a step, the loss falls), then
    the batch-2 kernel step against the plain step (phase 7's limits;
    the plain step routes through ``dense_moe_reference``)."""
    argv = train_argv(MOE_STEPS, MOE_WARMUP) + [
        "--model", "moe", "--num-experts", str(MOE["num_experts"])]
    per_step = (MOE["num_layers"],) * 3 + (1, 1)
    summary, launches, _, _ = drive(torch, train, kernels, argv, per_step,
                                    MOE_WARMUP)
    losses, result = summary["losses"], summary["driver_result"]
    summary["tokens_per_s"] = result["tokens_per_sec"]
    log("moe train:", json.dumps(summary))
    if not (losses[-1] < losses[0] and result["model"] == "moe"):
        raise AssertionError(f"moe: loss did not fall: {losses} {result}")
    torch.cuda.empty_cache()
    summary["plain_step"] = check_plain_step(
        torch, attn, convert, train,
        extra=("--model", "moe", "--num-experts", str(MOE["num_experts"])))
    return summary, launches


class EngineRecorder:
    """Records a live engine's admit/step/release calls (arguments and
    results) for a replay on another engine."""

    NAMES = ("admit", "step", "release")

    def __init__(self, engine):
        self.calls = []
        self.engine = engine
        for name in self.NAMES:
            setattr(engine, name, self._wrap(name, getattr(engine, name)))

    def detach(self):
        """The engine's own methods again."""
        for name in self.NAMES:
            del self.engine.__dict__[name]

    def _wrap(self, name, fn):
        import copy

        def call(*args, **kwargs):
            args, kwargs = copy.deepcopy(args), copy.deepcopy(kwargs)
            try:
                out = fn(*args, **kwargs)
            except Exception as e:
                self.calls.append((name, args, kwargs, None, type(e)))
                raise
            self.calls.append((name, args, kwargs, copy.deepcopy(out), None))
            return out
        return call


def moe_replay(torch, moe, expert, server, recorder):
    """The recorded calls again, on a fresh engine from the server's
    own factory whose MoE layers route through ``dense_moe_reference``
    (the JAX einsums): the same calls group the same tokens, so every
    first token and step token of a live row must agree, or first
    differ where the reference's top two logits lie within 2e-2 of its
    largest (PERF.md §2's bf16 rule); the replay stops there."""
    model = server.engine._model
    last = {}
    hook = model.register_forward_hook(
        lambda _m, _i, out: last.__setitem__("logits", out[0]))
    set_moe_fn(moe, model, expert.dense_moe_reference)
    engine = server._engine_service._engine_factory()
    if engine.paged != server.engine.paged:
        raise AssertionError("moe replay: the factory built another pool")
    live, compared, divergence = set(), 0, None

    def margin(logits, kind, index, slot):
        top = logits.float().topk(2).values
        gap = (top[0] - top[1]).item()
        limit = 2e-2 * logits.float().abs().max().item()
        return dict(call=index, kind=kind, slot=slot, top2_gap=gap,
                    limit=limit, near_tie=gap <= limit)

    try:
        for i, (name, args, kwargs, out, error) in enumerate(recorder.calls):
            if error is not None:
                try:
                    getattr(engine, name)(*args, **kwargs)
                except error:
                    continue
                raise AssertionError(f"moe replay: call {i} {name} did not "
                                     f"raise {error.__name__}")
            got = getattr(engine, name)(*args, **kwargs)
            if name == "release":
                live.discard(args[0])
                continue
            if name == "admit":
                if got[0] != out[0]:
                    raise AssertionError(f"moe replay: admission {i} took "
                                         f"slot {got[0]}, not {out[0]}")
                live.add(got[0])
                compared += 1
                if got[1] != out[1]:
                    divergence = margin(last["logits"][0, args[1] - 1],
                                        "admit", i, got[0])
                    break
                continue
            for slot in sorted(live):
                compared += 1
                if int(got[0][slot]) != int(out[0][slot]):
                    divergence = margin(last["logits"][slot, 0], "step", i,
                                        slot)
                    break
            if divergence is not None:
                break
    finally:
        hook.remove()
        set_moe_fn(moe, model, None)
    return dict(calls=len(recorder.calls), tokens_compared=compared,
                divergence=divergence)


def moe_step_ms(torch, engine, rng):
    """Host clock around 20 synced decode steps with every slot
    active (16-token prompts)."""
    vocab = MOE["vocab_size"]
    slots = [engine.admit(rng.integers(0, vocab, 16), 16)[0]
             for _ in range(engine.slots)]
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        engine.step()
    ms = 1e3 * (time.perf_counter() - t0) / 20
    for slot in slots:
        engine.release(slot)
    return ms


def moe_serving(torch, kernels, rng):
    """13c: ``serve.py --model moe`` (build_server) on the dense pool
    (CEA_TPU_PAGED_KV=0 while it builds) and on the paged pool:
    MOE_SERVE greedy requests at once, MOE_NEW tokens each, through
    HTTP. Launch counts set to 0 just before the traffic and read just
    after: 8 flash_fwd a dense admission, none paged. The engine's
    calls are recorded and replayed with the plain routing form
    (``moe_replay``). Each greedy stream must also meet greedy_decode
    by the near-tie rule, though a dropping router routes each step's 8
    slots and each admission's padded bucket as one group where
    greedy_decode makes batch-1 calls: the rule holds while a drop
    moves the logits less than its limit. Returns (report, launches by
    path)."""
    from container_engine_accelerators_tpu_torch.models import moe
    from container_engine_accelerators_tpu_torch.parallel import expert
    from container_engine_accelerators_tpu_torch.serving import serve
    report, launches = {}, {}
    vocab = MOE["vocab_size"]
    for pool in ("dense", "paged"):
        if pool == "dense":
            os.environ["CEA_TPU_PAGED_KV"] = "0"
        try:
            server = serve.build_server(serve.parse_args(moe_argv()))
        finally:
            os.environ.pop("CEA_TPU_PAGED_KV", None)
        eng = server.engine
        if (eng.paged != (pool == "paged")
                or not isinstance(eng._model, moe.MoETransformerLM)):
            raise AssertionError(f"moe: the launcher built the wrong {pool} "
                                 f"engine")
        recorder = EngineRecorder(eng)
        payloads = [{"prompts": [rng.integers(0, vocab, n).tolist()],
                     "max_new_tokens": MOE_NEW} for n in MOE_SERVE]
        results, errors = [None] * len(payloads), []

        def client(i):
            try:
                results[i] = post(server.port, payloads[i])
            except Exception as e:  # reported below, fails the run
                errors.append(repr(e))

        server.start()
        try:
            for kern in kernels:
                kern.launches = 0
            prefills0 = eng.prefills
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(payloads))]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            counts = {kern.name: kern.launches for kern in kernels}
            admissions = eng.prefills - prefills0
            stats = get(server.port, "/stats")
        finally:
            server.stop()
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"moe {pool} requests failed: {errors}")
        streams = []
        for pay, (status, body) in zip(payloads, results):
            p, seq = pay["prompts"][0], body["sequences"][0]
            if status != 200 or len(seq) != len(p) + MOE_NEW or not all(
                    0 <= t < vocab for t in seq):
                raise AssertionError(f"bad moe response {status}: {body}")
            streams.append((p, seq))
        recorder.detach()
        replay = moe_replay(torch, moe, expert, server, recorder)
        oracle = [stream_divergence(torch, eng._model, p, MOE_NEW, seq)
                  for p, seq in streams]
        entry = dict(
            launches=counts, admissions=admissions, wall_s=wall,
            tokens_per_s=len(MOE_SERVE) * MOE_NEW / wall, replay=replay,
            prefix_hits=stats.get("prefix_hits"),
            greedy_decode_agreement=dict(
                streams=len(oracle), equal=oracle.count(None),
                diverged=[d for d in oracle if d is not None]),
            leaks=eng.pool_leak_report(),
            step_ms=moe_step_ms(torch, eng, rng))
        report[pool] = entry
        log(f"moe serving ({pool}):", json.dumps(entry))
        want = MOE["num_layers"] * admissions if pool == "dense" else 0
        if (counts["flash_fwd"] != want or admissions != len(MOE_SERVE)
                or any(v for k, v in counts.items() if k != "flash_fwd")):
            raise AssertionError(f"moe {pool} serving launched {counts} for "
                                 f"{admissions} admissions; want {want} "
                                 f"flash_fwd")
        if entry["leaks"] is not None or stats.get("prefix_hits"):
            raise AssertionError(f"moe {pool}: leaks {entry['leaks']}, "
                                 f"prefix hits {stats.get('prefix_hits')}")
        off_tie = [d for d in oracle if d is not None and not d["near_tie"]]
        if off_tie:
            raise AssertionError(f"moe {pool}: streams leave greedy_decode "
                                 f"off a near tie: {off_tie}")
        if replay["divergence"] is not None \
                and not replay["divergence"]["near_tie"]:
            raise AssertionError(f"moe {pool}: the engine diverges from the "
                                 f"plain routing off a near tie: {replay}")
        launches[f"moe_{pool}_serving"] = counts
        del server, eng, recorder
        torch.cuda.empty_cache()
    return report, launches


def moe_speculation(torch, convert, kernels, rng):
    """13d: drop-free routing (capacity_factor 4 = E / top_k) on the
    same weights, its own draft at k 4, through GenerationServer on the
    paged pool: greedy streams against greedy_decode (drop-free routing
    does not depend on the call's other tokens) under the near-tie
    rule, acceptance >= SPEC_ACCEPT_ENGINE, 8 flash_fwd launches a
    greedy admission (the draft's one-shot prefill). Then
    ``serve.py --model moe --speculative-k 4`` (capacity 1.25) must
    fail at construction."""
    from container_engine_accelerators_tpu_torch.serving import serve
    from container_engine_accelerators_tpu_torch.serving.server import (
        GenerationServer,
    )
    config = dict(MOE, capacity_factor=MOE["num_experts"] / 2)
    # The launcher's weights (its tree from --seed), routed drop-free.
    model = convert.load_lm(config, convert.init_flax_layout_params(MOE,
                                                                    SEED))
    server = GenerationServer("lm", model, port=0, max_new_tokens=MOE_NEW,
                              max_batch=MAX_BATCH, host="127.0.0.1",
                              draft_model=model, speculative_k=SPEC_K)
    eng = server.engine
    server.start()
    try:
        for kern in kernels:
            kern.launches = 0
        prefills0 = eng.prefills
        greedy = spec_server_traffic(server, rng, MOE_SPEC)
        counts = {kern.name: kern.launches for kern in kernels}
        admissions = eng.prefills - prefills0
        stats = get(server.port, "/stats")
    finally:
        server.stop()
    diverged = [d for d in (stream_divergence(torch, model, p, new, seq)
                            for p, new, seq in greedy) if d is not None]
    report = dict(launches=counts, admissions=admissions,
                  greedy=len(greedy), greedy_diverged=diverged,
                  acceptance=stats.get("speculative_acceptance_rate"),
                  accepted_tokens_per_step=stats.get(
                      "accepted_tokens_per_step"),
                  draft_prefills=stats.get("draft_prefills"),
                  leaks=eng.pool_leak_report())
    try:
        # The refusal reads the routing options alone: two layers and a
        # small vocab make it quick.
        serve.build_server(serve.parse_args(moe_argv(
            ["--speculative-k", str(SPEC_K), "--num-layers", "2",
             "--vocab-size", "1024"])))
        refused = None
    except ValueError as e:
        refused = str(e)
    report["dropping_refused"] = refused
    log("moe speculation:", json.dumps(report))
    want = MOE["num_layers"] * len(MOE_SPEC)
    if (counts["flash_fwd"] != want or not eng.paged
            or any(v for k, v in counts.items() if k != "flash_fwd")
            or admissions != len(MOE_SPEC) + 1):
        raise AssertionError(f"moe speculation launched {counts} for "
                             f"{admissions} admissions; want {want}")
    if not all(d["near_tie"] for d in diverged) or report["leaks"]:
        raise AssertionError(f"moe speculation: {report}")
    if (report["acceptance"] or 0) < SPEC_ACCEPT_ENGINE:
        raise AssertionError(f"moe speculation acceptance "
                             f"{report['acceptance']} < {SPEC_ACCEPT_ENGINE}")
    if not refused or "drop" not in refused:
        raise AssertionError(f"moe: a dropping router served with "
                             f"--speculative-k: {refused}")
    del server, eng, model
    torch.cuda.empty_cache()
    return report, {"moe_spec_serving": counts}


def drive_moe(torch, train, attn, convert, kernels, rng):
    """Phase 13 (see the module docstring). Returns (report, launches by
    path)."""
    t0 = time.perf_counter()
    report = {"routing": moe_routing(torch)}
    report["train"], train_launches = moe_training(torch, train, attn,
                                                   convert, kernels)
    launches = {"moe_training": train_launches}
    report["serving"], serving = moe_serving(torch, kernels, rng)
    launches.update(serving)
    report["spec"], spec = moe_speculation(torch, convert, kernels, rng)
    launches.update(spec)
    report["phase_s"] = time.perf_counter() - t0
    log(f"moe phase: {report['phase_s']:.1f} s")
    return report, launches


# ---------------------------------------------------------------------
# Phase 14: real data, checkpoints and trained weights.
# ---------------------------------------------------------------------

CKPT_SHARDS = 5              # seeded .npz shards of ResNet-50 images
CKPT_SHARD_ROWS = 176        # not a multiple of 128: batches cross shards
CKPT_EVERY = 2
CKPT_KEEP = 2
# B's final leaves (resumed at step 4) against C's (the straight run on
# the same six batches), each by relative L2: the two runs make the
# same calls, but cuDNN's algorithms may round apart between runs
# (atomics in a backward), and one f32 bit apart flips bf16 roundings
# downstream: phase 8's bf16 gradient limit. A leaf that was not
# restored (parameters, momentum, BN statistics) or a step on other
# data moves by O(1).
CKPT_RESUME_TOL = 5e-2
CKPT_LM_STEPS = 3
CKPT_SERVE = (16, 100, 700, 1500)   # concurrent greedy requests a pool
CKPT_NEW = 32
PATH_KERNELS.update({
    "ckpt_resnet": ("xent_fwd", "xent_bwd"),
    "ckpt_lm_training": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                         "xent_fwd", "xent_bwd"),
    "ckpt_dense_serving": ("flash_fwd",),
})


def write_image_shards(np, root):
    """CKPT_SHARDS shards of CKPT_SHARD_ROWS f32 NHWC images (standard
    normal, 224x224x3) and int32 labels in [0, 1000), from SEED."""
    rng = np.random.default_rng(SEED)
    for s in range(CKPT_SHARDS):
        np.savez(os.path.join(root, f"shard{s}.npz"),
                 images=rng.standard_normal(
                     (CKPT_SHARD_ROWS, RESNET_SIZE, RESNET_SIZE, 3),
                     dtype=np.float32),
                 labels=rng.integers(0, RESNET_CLASSES, CKPT_SHARD_ROWS,
                                     dtype=np.int32))


def replay_shards(np, root, batches):
    """``batches`` as one shard each, named so that NpzShardDataset's
    first epoch (the shard order permuted from seed 0) reads them in
    the given order: a straight run over exactly these batches."""
    order = np.random.default_rng(0).permutation(len(batches))
    for k, (images, labels) in enumerate(batches):
        np.savez(os.path.join(root, f"r{order[k]}.npz"), images=images,
                 labels=labels)


def archive_arrays(np, path):
    """{path key: array} of a checkpoint directory's arrays.npz, read
    with numpy alone."""
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def archive_tree(arrays, prefix):
    """The nested dict of the arrays under ``prefix`` (e.g.
    "['params']"), from their path keys."""
    tree = {}
    for key, value in arrays.items():
        if not key.startswith(prefix):
            continue
        parts = re.findall(r"\['([^']*)'\]", key[len(prefix):])
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def rel_l2(np, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def served_mismatches(torch, model, want):
    """Names of ``model``'s weights that differ from ``want`` ({name: f32
    or int8 CPU tensor}, the converter's reading of an archive) cast to
    the served dtype, bitwise."""
    state = model.state_dict()
    bad = sorted(set(state) ^ set(want))
    for name, value in state.items():
        if name in want and not torch.equal(
                value.cpu(), want[name].to(value.dtype)):
            bad.append(name)
    return bad


def ckpt_resnet(torch, np, train, kernels, root, synthetic_ips):
    """Phase 14a-b. A: 4 steps of ResNet-50 on the shards with
    --model-dir M (every 2, keep 2); B: resumed there for 2; C: 6 steps
    straight in a second directory on shards replaying A's and B's six
    batches. Each step's labels (and the last pixels of each image,
    read on the card as the step sees them) equal what numpy's
    NpzShardDataset yields for it; 0/0/0/1/1 launches a step;
    checkpoint_4 and checkpoint_6 remain; B's leaves against C's. Then
    an async save at C's last step with two more steps at once: the
    archive holds the step's values bitwise."""
    from container_engine_accelerators_tpu_torch.parallel import checkpoint
    from container_engine_accelerators_tpu_torch.parallel.data import (
        NpzShardDataset,
    )
    shards, replay = os.path.join(root, "shards"), os.path.join(root, "replay")
    m1, m2 = os.path.join(root, "resnet_b"), os.path.join(root, "resnet_c")
    os.makedirs(shards)
    os.makedirs(replay)
    t0 = time.perf_counter()
    write_image_shards(np, shards)
    stream_a = list(itertools.islice(NpzShardDataset(shards, RESNET_BATCH),
                                     4))
    stream_b = list(itertools.islice(NpzShardDataset(
        shards, RESNET_BATCH, skip_batches=4), 2))
    replay_shards(np, replay, stream_a + stream_b)
    report = {"data_write_s": time.perf_counter() - t0,
              "data_bytes": sum(os.path.getsize(os.path.join(shards, f))
                                for f in os.listdir(shards))}
    launches = {kern.name: 0 for kern in kernels}

    def run(name, data, model_dir, steps, warmup, want, every=CKPT_EVERY):
        seen = []

        def on_batch(step, batch):
            images, labels = batch
            # On the consumer's stream, as the step reads the batch.
            seen.append((labels.clone(), images[:, -1, -4:, :].clone()))

        argv = image_argv("resnet", RESNET_BATCH, steps, warmup) + [
            "--data-dir", data, "--model-dir", model_dir,
            "--checkpoint-every", str(every),
            "--keep-checkpoints", str(CKPT_KEEP)]
        summary, counts, trainer, state = drive(
            torch, train, kernels, argv, (0, 0, 0, 1, 1), warmup,
            on_batch=on_batch)
        bad = [i for i, ((labels, tail), (w_images, w_labels))
               in enumerate(zip(seen, want))
               if not (np.array_equal(labels.cpu().numpy(), w_labels)
                       and np.array_equal(tail.cpu().numpy(),
                                          w_images[:, -1, -4:, :]))]
        result = summary["driver_result"]
        report[name] = dict(
            steps=steps, losses=summary["losses"],
            step_ms_mean=summary["step_ms_mean"],
            images_per_s=result["images_per_sec"],
            data_wait_ms_mean=result["data_wait_ms_mean"],
            checkpoint_block_s=result["checkpoint_block_s"],
            batches_checked=len(seen), batches_differing=bad)
        log(f"checkpoint phase, resnet run {name}:", json.dumps(report[name]))
        if len(seen) != len(want) or bad:
            raise AssertionError(f"resnet run {name}: steps {bad} did not "
                                 f"get NpzShardDataset's batches")
        for k in launches:
            launches[k] += counts[k]
        return trainer, state

    run("a", shards, m1, 4, 1, stream_a)
    run("b", shards, m1, 2, 1, stream_b)
    # C saves only after its last step, outside the driver's timed
    # steps: its images/s is the file pipeline's alone.
    trainer, state = run("c", replay, m2, 6, 2, stream_a + stream_b, 0)
    kept = sorted(os.listdir(m1))
    if kept != ["checkpoint_4", "checkpoint_6"]:
        raise AssertionError(f"resnet: {m1} holds {kept}, want "
                             f"checkpoint_4 and checkpoint_6")
    got = archive_arrays(np, os.path.join(m1, "checkpoint_6"))
    want = archive_arrays(np, os.path.join(m2, "checkpoint_6"))
    if sorted(got) != sorted(want) or int(got["['step']"]) != 6:
        raise AssertionError("resnet: B's and C's checkpoint_6 differ in "
                             "keys or step")
    errs = {k: rel_l2(np, got[k], want[k]) for k in want if k != "['step']"}
    groups = {}
    for key, err in errs.items():
        group = key.split("]", 1)[0][2:-1]
        if ".trace" in key:
            group = "trace"
        groups[group] = max(groups.get(group, 0.0), err)
    worst = max(errs, key=errs.get)
    report["resume"] = dict(
        leaves=len(errs), bitwise=sum(e == 0.0 for e in errs.values()),
        max_rel_l2_by_group=groups, worst=worst, worst_rel_l2=errs[worst],
        limit=CKPT_RESUME_TOL)
    report["synthetic_images_per_s"] = synthetic_ips
    log("checkpoint phase, resume B vs straight C:",
        json.dumps(report["resume"]))
    if errs[worst] > CKPT_RESUME_TOL:
        raise AssertionError(f"resnet: resumed run B differs from the "
                             f"straight run C: {report['resume']}")

    # (b) an async save racing two steps.
    payload = checkpoint.state_payload(state)
    copy = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.array(v))
            for k, v in checkpoint.keystr_items(payload)}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    batch = (torch.randn((RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3),
                         generator=gen, device="cuda"),
             torch.randint(0, RESNET_CLASSES, (RESNET_BATCH,), generator=gen,
                           device="cuda", dtype=torch.int32))
    mgr = checkpoint.CheckpointManager(os.path.join(root, "race"))
    step = state.step
    mgr.save(payload, step=step)
    for _ in range(2):
        state, _ = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    pending = mgr._pending
    mgr.wait_until_finished()
    raw = archive_arrays(np, os.path.join(mgr.directory,
                                          f"checkpoint_{step}"))
    differ = sorted(k for k in copy if k not in raw
                    or not np.array_equal(raw[k], copy[k]))
    live = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.array(v))
            for k, v in checkpoint.keystr_items(
                checkpoint.state_payload(state))}
    moved = sum(not np.array_equal(live[k], copy[k]) for k in copy)
    report["async_race"] = dict(step=step, leaves=len(copy),
                                differing=differ, moved_after=moved,
                                write_pending_after_steps=pending,
                                blocked_s=mgr.last_blocked_s)
    log("checkpoint phase, async save racing 2 steps:",
        json.dumps(report["async_race"]))
    mgr.close()
    if differ or not moved:
        raise AssertionError(f"async save: {report['async_race']}")
    del trainer, state, payload, live, copy
    torch.cuda.empty_cache()
    return report, launches


def ckpt_traffic(server, rng, lengths):
    """Concurrent greedy requests of ``lengths`` tokens, CKPT_NEW new
    tokens each. Returns [(prompt, new, sequence)]."""
    vocab = MODEL["vocab_size"]
    payloads = [{"prompts": [rng.integers(0, vocab, n).tolist()],
                 "max_new_tokens": CKPT_NEW} for n in lengths]
    results, errors = [None] * len(payloads), []

    def client(i):
        try:
            results[i] = post(server.port, payloads[i])
        except Exception as e:  # reported below, fails the run
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"checkpoint serving requests failed: {errors}")
    out = []
    for pay, (status, body) in zip(payloads, results):
        p, seq = pay["prompts"][0], body["sequences"][0]
        if status != 200 or len(seq) != len(p) + CKPT_NEW:
            raise AssertionError(f"bad response {status}: {body}")
        out.append((p, CKPT_NEW, seq))
    return out


def serve_argv(model_dir, extra=()):
    """The launcher's flags for MODEL with --model-dir."""
    return ["--model", "transformer", "--model-name", "lm", "--port", "0",
            "--vocab-size", str(MODEL["vocab_size"]),
            "--embed-dim", str(MODEL["embed_dim"]),
            "--num-layers", str(MODEL["num_layers"]),
            "--num-heads", str(MODEL["num_heads"]),
            "--num-kv-heads", str(MODEL["num_kv_heads"]),
            "--pos-embedding", MODEL["pos_embedding"],
            "--max-seq-len", str(MODEL["max_seq_len"]),
            "--max-new-tokens", str(MAX_NEW),
            "--max-batch", str(MAX_BATCH), "--seed", str(SEED),
            "--model-dir", model_dir, *extra]


def ckpt_lm(torch, np, train, convert, kernels, rng, root, random_accept):
    """Phase 14c: the LM and the demo draft trained with --model-dir,
    then served from their checkpoints."""
    from container_engine_accelerators_tpu_torch.serving import serve
    report, launches = {}, {}
    lm_dir, draft_dir = os.path.join(root, "lm"), os.path.join(root, "draft")
    summary, launches["ckpt_lm_training"], trainer, state = drive(
        torch, train, kernels, train_argv(CKPT_LM_STEPS, 1) + [
            "--model-dir", lm_dir], (8, 8, 8, 1, 1), 1)
    report["lm_training"] = dict(
        losses=summary["losses"], step_ms_mean=summary["step_ms_mean"],
        checkpoint_block_s=summary["driver_result"]["checkpoint_block_s"])
    del trainer, state
    d = SPEC_DRAFT
    draft_argv = ["--model", "transformer", "--device", "cuda",
                  "--vocab-size", str(d["vocab_size"]),
                  "--embed-dim", str(d["embed_dim"]),
                  "--num-layers", str(d["num_layers"]),
                  "--num-heads", str(d["num_heads"]),
                  "--pos-embedding", d["pos_embedding"],
                  "--seq-len", str(TRAIN_SEQ),
                  "--batch-size", str(TRAIN_BATCH),
                  "--steps", str(CKPT_LM_STEPS), "--warmup-steps", "1",
                  "--seed", str(SEED + 1), "--model-dir", draft_dir]
    summary, launches["ckpt_draft_training"], trainer, state = drive(
        torch, train, kernels, draft_argv, (2, 2, 2, 1, 1), 1)
    report["draft_training"] = dict(losses=summary["losses"],
                                    step_ms_mean=summary["step_ms_mean"])
    del trainer, state
    torch.cuda.empty_cache()
    for name, path in (("lm", lm_dir), ("draft", draft_dir)):
        if sorted(os.listdir(path)) != [f"checkpoint_{CKPT_LM_STEPS}"]:
            raise AssertionError(f"{name}: {path} holds "
                                 f"{sorted(os.listdir(path))}")
    lm_tree = archive_tree(archive_arrays(np, os.path.join(
        lm_dir, f"checkpoint_{CKPT_LM_STEPS}")), "['params']")
    draft_tree = archive_tree(archive_arrays(np, os.path.join(
        draft_dir, f"checkpoint_{CKPT_LM_STEPS}")), "['params']")
    lm_want = convert.params_from_flax(lm_tree)

    def build(argv, paged=True):
        if not paged:
            os.environ["CEA_TPU_PAGED_KV"] = "0"
        try:
            return serve.build_server(serve.build_parser().parse_args(argv))
        finally:
            os.environ.pop("CEA_TPU_PAGED_KV", None)

    def serve_pool(name, server, per_greedy, lengths):
        eng = server.engine
        bad = served_mismatches(torch, eng._model, lm_want)
        server.start()
        try:
            for kern in kernels:
                kern.launches = 0
            prefills0 = eng.prefills
            greedy = ckpt_traffic(server, rng, lengths)
            counts = {kern.name: kern.launches for kern in kernels}
            stats = get(server.port, "/stats")
            admissions = eng.prefills - prefills0
        finally:
            server.stop()
        diverged = [x for x in (stream_divergence(torch, eng._model, p, new,
                                                  seq)
                                for p, new, seq in greedy) if x is not None]
        entry = dict(weights_differing=bad, launches=counts,
                     admissions=admissions, greedy=len(greedy),
                     greedy_diverged=diverged, leaks=eng.pool_leak_report(),
                     acceptance=stats.get("speculative_acceptance_rate"),
                     accepted_tokens_per_step=stats.get(
                         "accepted_tokens_per_step"))
        report[name] = entry
        log(f"checkpoint phase, serving {name}:", json.dumps(entry))
        want = per_greedy * admissions
        if (bad or counts["flash_fwd"] != want
                or any(v for k, v in counts.items() if k != "flash_fwd")
                or admissions != len(lengths)):
            raise AssertionError(f"serving {name} from the checkpoint: "
                                 f"{entry}")
        if entry["leaks"] is not None or not all(x["near_tie"]
                                                 for x in diverged):
            raise AssertionError(f"serving {name}: {entry}")
        return counts

    launches["ckpt_dense_serving"] = serve_pool(
        "dense", build(serve_argv(lm_dir), paged=False),
        MODEL["num_layers"], CKPT_SERVE)
    launches["ckpt_paged_serving"] = serve_pool(
        "paged", build(serve_argv(lm_dir)), 0, CKPT_SERVE)

    # lm-serving.yaml's flags (int8 KV and weights, the byte tokenizer;
    # without --warm) with --model-dir: quantized after the restore.
    argv = [a for a in manifest_argv() if a != "--warm"] + [
        "--port=0", "--model-dir", lm_dir]
    server = build(argv)
    int8_want = convert.params_from_flax(convert.quantize_lm(MODEL, lm_tree))
    bad = served_mismatches(torch, server.engine._model, int8_want)
    kernel_q = convert.params_to_flax(server.engine._model,
                                      dict(MODEL, weights="int8"))
    q_tree = convert.quantize_lm(MODEL, lm_tree)
    q_bad = [f"block{i}" for i in range(MODEL["num_layers"])
             if not all(np.array_equal(kernel_q[f"block{i}"]["attn"][k]
                                       ["kernel_q"],
                                       q_tree[f"block{i}"]["attn"][k]
                                       ["kernel_q"])
                        for k in ("q", "kv", "proj"))]
    server.start()
    try:
        for kern in kernels:
            kern.launches = 0
        greedy = ckpt_traffic(server, rng, (100,))
        counts = {kern.name: kern.launches for kern in kernels}
    finally:
        server.stop()
    diverged = [x for x in (stream_divergence(torch, server.engine._model,
                                              p, new, seq)
                            for p, new, seq in greedy) if x is not None]
    report["deployed_int8"] = dict(weights_differing=bad,
                                   kernel_q_differing=q_bad,
                                   launches=counts,
                                   greedy_diverged=diverged)
    log("checkpoint phase, lm-serving.yaml with --model-dir:",
        json.dumps(report["deployed_int8"]))
    if bad or q_bad or any(counts.values()) or not all(
            x["near_tie"] for x in diverged):
        raise AssertionError(f"int8 serving from the checkpoint: "
                             f"{report['deployed_int8']}")
    launches["ckpt_deployed_serving"] = counts
    del server, int8_want, q_tree, kernel_q
    torch.cuda.empty_cache()

    # Speculation with the trained draft (paged pool): the draft's
    # prefill launches flash_fwd once a draft layer a greedy admission.
    server = build(serve_argv(lm_dir, (
        "--speculative-k", str(SPEC_K),
        "--draft-layers", str(d["num_layers"]),
        "--draft-embed-dim", str(d["embed_dim"]),
        "--draft-model-dir", draft_dir)))
    draft_bad = served_mismatches(torch, server.engine._draft_model,
                                  convert.params_from_flax(draft_tree))
    launches["ckpt_spec_serving"] = serve_pool(
        "speculative", server, d["num_layers"], CKPT_SERVE)
    report["speculative"]["draft_weights_differing"] = draft_bad
    report["speculative"]["random_draft_acceptance"] = random_accept
    if draft_bad:
        raise AssertionError(f"draft weights differ from the archive: "
                             f"{draft_bad}")
    del server
    torch.cuda.empty_cache()
    return report, launches


def ckpt_predict(torch, np, convert, root):
    """Phase 14d: the ResNet-50 predict server from run B's checkpoint:
    its BN statistics and weights equal the archive, its classes the
    eval forward of the restored model or a near tie."""
    from container_engine_accelerators_tpu_torch.serving import serve
    model_dir = os.path.join(root, "resnet_b")
    server = serve.build_server(serve.build_parser().parse_args(
        ["--model-name", "resnet", "--port", "0", "--max-batch",
         str(PREDICT_BATCH), "--model-dir", model_dir]))
    arrays = archive_arrays(np, os.path.join(model_dir, "checkpoint_6"))
    served = convert.image_variables_to_flax(server._model)
    differing = {}
    for collection in ("params", "batch_stats"):
        want = archive_tree(arrays, f"['{collection}']")
        flat_want, flat_got = {}, {}

        def walk(tree, prefix, out):
            for key, value in tree.items():
                if isinstance(value, dict):
                    walk(value, prefix + (key,), out)
                else:
                    out["/".join(prefix + (key,))] = value

        walk(want, (), flat_want)
        walk(served[collection], (), flat_got)
        differing[collection] = sorted(
            k for k in set(flat_want) | set(flat_got)
            if k not in flat_want or k not in flat_got
            or not np.array_equal(flat_got[k], flat_want[k]))
    rng = np.random.default_rng(SEED + 14)
    images = rng.standard_normal((PREDICT_BATCH, RESNET_SIZE, RESNET_SIZE,
                                  3)).astype(np.float32)
    with torch.inference_mode():
        logits = server._model(torch.from_numpy(images).cuda()).float().cpu()
    server.start()
    try:
        status, body = server._handle_post({"instances": images.tolist()})
    finally:
        server.stop()
    if status != 200:
        raise AssertionError(f"predict from the checkpoint: {status} {body}")
    mismatches = [dict(bad, row=i) for i, pred in enumerate(
        body["predictions"]) if (bad := class_check(logits[i], pred))]
    exact = sum(p["class"] == int(logits[i].argmax())
                for i, p in enumerate(body["predictions"]))
    report = dict(differing=differing, exact=exact, mismatches=mismatches,
                  batch_stats_leaves=sum(k.startswith("['batch_stats']")
                                         for k in arrays))
    log("checkpoint phase, predict server:", json.dumps(report))
    if any(differing.values()) or mismatches:
        raise AssertionError(f"predict server from the checkpoint: {report}")
    del server
    torch.cuda.empty_cache()
    return report


def drive_checkpoints(torch, train, convert, kernels, rng, report):
    """Phase 14 (see the module docstring). ``report``: the run's report
    so far (phase 8's images/s, phase 10's random-draft acceptance).
    Returns (report, launches by path)."""
    import tempfile

    import numpy as np
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        out, resnet_counts = ckpt_resnet(torch, np, train, kernels, root,
                                         report["resnet"]["images_per_s"])
        launches = {"ckpt_resnet": resnet_counts}
        random = report["spec"]["serving"]["paged"]["stats"][
            "speculative_acceptance_rate"]
        out["lm"], lm_launches = ckpt_lm(torch, np, train, convert, kernels,
                                         rng, root, random)
        launches.update(lm_launches)
        out["predict"] = ckpt_predict(torch, np, convert, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    log(f"checkpoint phase: {out['phase_s']:.1f} s")
    return out, launches


# Phase 15: the tooling adapters at full width.
TOOL_STEPS = 3
TOOL_WARMUP = 1
TOOL_PROFILE_S = 2.0
TOOL_WAVE_NEW = 16        # new tokens a request in the profiled waves
# torch.profiler's CUDA rows came back empty from 1 of 6 consecutive
# captures of a serving process on an H100 (torch 2.11): (a) takes up
# to this many captures and reports each one's kernel count.
TOOL_CAPTURES = 3
TOOL_FULL_STEPS = 32      # eight-slot steps before decode_mfu is read
TOOL_FLOPS_TOL = 0.01     # counted step FLOPs against the analytic count
TOOL_GOODPUT_TOL = 0.01   # goodput buckets against the wall
TOOL_PROMPTS = (16, 32, 64, 100, 200, 300, 500, 700)   # one a slot
PATH_KERNELS.update({
    "tooling_serving": ("flash_fwd",),
    "tooling_training": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                         "xent_fwd", "xent_bwd"),
})


def trace_summary(path, window_s=None):
    """What a torch.profiler Chrome trace holds: device kernels by name
    (count and total ms, the ten largest), their summed time over the
    window (the device's busy share, kernels of one stream not
    overlapping), and the CPU-side operator events and threads."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels, cpu_ops, cpu_tids = {}, 0, set()
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "kernel":
            row = kernels.setdefault(e["name"], [0, 0.0])
            row[0] += 1
            row[1] += e.get("dur", 0) / 1e3
        elif e.get("cat") == "cpu_op":
            cpu_ops += 1
            cpu_tids.add(e.get("tid"))
    busy_ms = sum(ms for _, ms in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    out = dict(kernel_names=sorted(name[:120] for name in kernels),
               kernel_launches=sum(n for n, _ in kernels.values()),
               kernel_ms=busy_ms,
               by_name=[dict(name=name, count=n)
                        for name, (n, _) in kernels.items()],
        top_kernels=[dict(name=name[:120], count=n, ms=ms)
                     for name, (n, ms) in top],
        cpu_ops=cpu_ops, cpu_threads=len(cpu_tids),
        trace_mb=os.path.getsize(path) / 1e6)
    if window_s:
        out["device_busy_share"] = busy_ms / (1e3 * window_s)
    return out


def named(summary, *kernels):
    """The kernels of ``kernels`` a trace summary does not name."""
    return [k for k in kernels
            if not any(k in name for name in summary["kernel_names"])]


def tooling_serving(torch, model, kernels, rng):
    """Phase 15 (a)-(c): the dense pool behind the port server.
    /debug/profile for TOOL_PROFILE_S while waves of eight short
    requests are admitted and decode (a second capture meanwhile gets
    409), up to TOOL_CAPTURES captures until one names the flash
    kernel; then eight concurrent MAX_NEW-token requests, after which
    /stats' HBM fields are held against the allocator and decode_mfu
    read after at least TOOL_FULL_STEPS eight-slot steps. Returns
    (report, launches)."""
    from container_engine_accelerators_tpu_torch.serving.server import (
        GenerationServer,
    )
    os.environ["CEA_TPU_PAGED_KV"] = "0"
    try:
        server = GenerationServer("lm", model, port=0,
                                  max_new_tokens=MAX_NEW,
                                  max_batch=MAX_BATCH, host="127.0.0.1")
    finally:
        del os.environ["CEA_TPU_PAGED_KV"]
    if server.engine.paged:
        raise AssertionError("CEA_TPU_PAGED_KV=0 built a paged engine")
    server.start()
    try:
        vocab = MODEL["vocab_size"]
        prefills0 = server.engine.prefills
        for kern in kernels:
            kern.launches = 0
        profile, errors = {}, []

        def capture():
            profile["reply"] = http_call(
                server.port, f"/debug/profile?seconds={TOOL_PROFILE_S}")

        def wave(new):
            payloads = [{"prompts": [rng.integers(0, vocab, n).tolist()],
                         "max_new_tokens": new} for n in TOOL_PROMPTS]

            def client(payload):
                try:
                    status, body = post(server.port, payload)
                    if status != 200 or len(body["sequences"][0]) != len(
                            payload["prompts"][0]) + new:
                        errors.append((status, body))
                except Exception as e:  # reported below, fails the run
                    errors.append(repr(e))

            clients = [threading.Thread(target=client, args=(p,))
                       for p in payloads]
            for t in clients:
                t.start()
            for t in clients:
                t.join(timeout=600)
            if errors or any(t.is_alive() for t in clients):
                raise AssertionError(f"tooling traffic failed: {errors}")

        # Every prompt bucket is served once before any capture: a
        # shape's first launches load its kernels lazily, which under
        # an active profiler stalls the engine for seconds. A first
        # short capture then pays the profiler's one-time start-up
        # (up to 15 s on an H100, the GIL held). Waves of admissions
        # run for as long as each capture does.
        wave(TOOL_WAVE_NEW)
        warm = http_call(server.port, "/debug/profile?seconds=0.1")
        if warm[0] != 200:
            raise AssertionError(f"/debug/profile answered {warm}")
        captures = []
        while len(captures) < TOOL_CAPTURES and not any(
                c["flash_fwd_in_trace"] for c in captures):
            profile.clear()
            steps0 = server.engine.steps
            prof_thread = threading.Thread(target=capture)
            prof_thread.start()
            time.sleep(0.05)
            busy = http_call(server.port, "/debug/profile?seconds=0.01")
            waves = 0
            while prof_thread.is_alive() and "reply" not in profile:
                wave(TOOL_WAVE_NEW)
                waves += 1
            prof_thread.join(timeout=600)
            status, _, reply = profile["reply"]
            if status != 200 or busy[0] != 409:
                raise AssertionError(f"/debug/profile answered {status} "
                                     f"{reply}, a second capture {busy[0]}")
            trace = trace_summary(reply["trace"], TOOL_PROFILE_S)
            trace["flash_fwd_in_trace"] = sum(
                row["count"] for row in trace.pop("by_name")
                if "flash_fwd_wgmma_tc_kernel" in row["name"])
            trace.update(waves=waves, start_s=reply["start_s"],
                         engine_steps=server.engine.steps - steps0)
            captures.append(trace)
        wave(MAX_NEW)   # (c): every slot busy for MAX_NEW steps
        launches = {k.name: k.launches for k in kernels}
        admissions = server.engine.prefills - prefills0
        time.sleep(1.1)   # past /stats' sampling interval: a fresh sample
        torch.cuda.synchronize()
        allocator_peak = torch.cuda.max_memory_allocated()
        total = torch.cuda.mem_get_info()[1]
        stats = get(server.port, "/stats")
        occupancy = server._engine_service._occ_hist.snapshot()[0]
    finally:
        server.stop()
    # The last occupancy bucket (1.0) counts the steps with every slot
    # active.
    full_steps = occupancy[-2]
    out = dict(profile=captures[-1], captures=len(captures),
               capture_kernels=[c["kernel_launches"] for c in captures],
               warm_start_s=warm[2]["start_s"],
               hbm_in_use_bytes=stats["hbm_in_use_bytes"],
               hbm_peak_bytes=stats["hbm_peak_bytes"],
               allocator_peak_bytes=allocator_peak, mem_total_bytes=total,
               decode_mfu=stats["decode_mfu"], eight_slot_steps=full_steps,
               engine_steps=stats["engine_steps"], admissions=admissions,
               launches=launches)
    log("tooling serving:", json.dumps({k: v for k, v in out.items()
                                        if k != "profile"}))
    for trace in captures:
        log("tooling serving profile:", json.dumps(
            {k: v for k, v in trace.items() if k != "kernel_names"}))
    if not captures[-1]["flash_fwd_in_trace"]:
        raise AssertionError(f"(a) no serving profile of {len(captures)} "
                             f"names flash_fwd_wgmma_tc_kernel")
    peak, in_use = stats["hbm_peak_bytes"], stats["hbm_in_use_bytes"]
    if not (peak is not None and allocator_peak <= peak <= total
            and in_use is not None and in_use <= peak):
        raise AssertionError(f"(b) HBM fields: {out}")
    mfu = stats["decode_mfu"]
    if not (full_steps >= TOOL_FULL_STEPS and mfu is not None
            and math.isfinite(mfu) and 0 < mfu < 1):
        raise AssertionError(f"(c) decode_mfu {mfu} after {full_steps} "
                             f"eight-slot steps")
    if (launches["flash_fwd"] != MODEL["num_layers"] * admissions
            or admissions < len(TOOL_PROMPTS) * (
                2 + sum(c["waves"] for c in captures))
            or any(n for name, n in launches.items()
                   if name != "flash_fwd")):
        raise AssertionError(f"tooling serving launches {launches} for "
                             f"{admissions} admissions")
    return out, launches


def analytic_train_flops(model, batch, seq):
    """One LM training step's FLOPs, the count the CPU tests pin: 6 a
    linear weight a token (the embedding lookup multiplies nothing),
    and each layer's flash forward, dQ and dK/dV at 4, 6 and 8 D a kept
    pair a head."""
    import torch
    linear = sum(m.weight.numel() for m in model.modules()
                 if isinstance(m, torch.nn.Linear))
    heads, d = MODEL["num_heads"], MODEL["embed_dim"] // MODEL["num_heads"]
    attention = (18 * d * kept_pairs(seq, True, 0) * batch * heads
                 * MODEL["num_layers"])
    return 6 * linear * batch * seq + attention


def tooling_training(torch, train, kernels, profile_dir):
    """Phase 15 (d) and (f): TOOL_STEPS LM steps at phase 7's shape
    through the driver with --profile-dir; the trace names the dQ and
    dK/dV kernels, train_mfu is in (0, 1), the goodput buckets sum to
    the wall, and the FLOPs counted on the first step equal the
    analytic count. Returns (report, launches)."""
    per_step = (MODEL["num_layers"],) * 3 + (1, 1)
    argv = train_argv(TOOL_STEPS, TOOL_WARMUP) + ["--profile-dir",
                                                  profile_dir]
    summary, launches, trainer, _ = drive(torch, train, kernels, argv,
                                          per_step, TOOL_WARMUP)
    result = summary["driver_result"]
    window_s = sum(summary["step_ms"][TOOL_WARMUP - 1:]) / 1e3
    trace = trace_summary(result["profile_trace"], window_s)
    trace.pop("by_name")
    want = analytic_train_flops(trainer.model, TRAIN_BATCH, TRAIN_SEQ)
    counted = result["flops_per_step"]
    buckets = result["goodput_buckets_s"]
    out = dict(train_mfu=result["train_mfu"], flops_per_step=counted,
               analytic_flops=want, goodput_ratio=result["goodput_ratio"],
               goodput_wall_s=result["goodput_wall_s"],
               goodput_buckets_s=buckets, step_ms=summary["step_ms"],
               losses=summary["losses"], profile=trace, launches=launches)
    log("tooling training:", json.dumps({k: v for k, v in out.items()
                                         if k != "profile"}))
    log("tooling training profile:", json.dumps(trace))
    missing = named(trace, "flash_bwd_dq_wgmma_tc_kernel",
                    "flash_bwd_dkv_wgmma_tc_kernel")
    mfu = result["train_mfu"]
    if missing or not (mfu is not None and 0 < mfu < 1):
        raise AssertionError(f"(d) the training profile lacks {missing} "
                             f"or train_mfu is {mfu}")
    if abs(sum(buckets.values()) - result["goodput_wall_s"]) > (
            TOOL_GOODPUT_TOL * result["goodput_wall_s"]):
        raise AssertionError(f"(d) goodput buckets {buckets} against "
                             f"the wall {result['goodput_wall_s']}")
    if not counted or abs(counted - want) > TOOL_FLOPS_TOL * want:
        raise AssertionError(f"(f) counted {counted} FLOPs a step, "
                             f"analytic {want}")
    torch.cuda.empty_cache()
    return out, launches


def tooling_sigterm(proc, port, journal):
    """Phase 15 (e): SIGTERM to a launcher process (lm_flags, the paged
    pool, CEA_TPU_TRACE_FILE set) with a stream in flight: the stream
    finishes, the process exits 0, and the journal's flight record
    holds serving_kv_blocks, serving_requests (the drained stream's
    record) and the memory watermarks."""
    import signal

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/lm:generate",
        data=json.dumps({"prompts": [[1, 2, 3, 4, 5]],
                         "max_new_tokens": MAX_NEW,
                         "stream": True}).encode())
    conn = urllib.request.urlopen(req, timeout=600)
    lines = [json.loads(conn.readline())]
    proc.send_signal(signal.SIGTERM)
    lines += [json.loads(x) for x in conn.read().splitlines()]
    conn.close()
    rc = proc.wait(timeout=120)
    with open(journal) as f:
        doc = json.load(f)
    state = doc.get("postmortem_state", {})
    requests = state.get("serving_requests", {})
    records = requests.get("records") or [{}]
    marks = state.get("hbm_memory", {}).get("watermarks", {})
    out = dict(exit_code=rc, exit_reason=doc.get("exit_reason"),
               stream_tokens=sum(len(x.get("tokens", [])) for x in lines),
               stream_end=lines[-1], providers=sorted(state),
               retired=requests.get("retired_total"),
               record=dict(outcome=records[0].get("outcome"),
                           tokens=records[0].get("tokens")),
               kv_paged=state.get("serving_kv_blocks", {}).get("paged"),
               watermarks=marks)
    log("tooling sigterm:", json.dumps(out))
    if (rc != 0 or out["stream_end"] != {"done": True}
            or out["stream_tokens"] != MAX_NEW
            or out["exit_reason"] != "signal:SIGTERM"
            or out["kv_paged"] is not True
            or out["record"] != {"outcome": "completed", "tokens": MAX_NEW}
            or not marks or not all(v > 0 for v in marks.values())):
        raise AssertionError(f"(e) SIGTERM postmortem: {out}")
    return out


def drive_tooling(torch, train, model, kernels, rng):
    """Phase 15 (see the module docstring). Returns (report, launches by
    path)."""
    import tempfile

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_tooling_")
    journal = os.path.join(root, "journal.json")
    # (e)'s launcher warms up while (a)-(d) run.
    proc = spawn_launcher(lm_flags(), {"CEA_TPU_TRACE_FILE": journal})
    try:
        port_box = {}

        def read():
            try:
                port_box["port"] = launcher_port(proc, lm_flags())[0]
            except AssertionError as e:
                port_box["error"] = str(e)

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        os.environ["CEA_TPU_PROFILE_DIR"] = os.path.join(root, "serving")
        try:
            serving, serving_launches = tooling_serving(
                torch, model, kernels, rng)
        finally:
            del os.environ["CEA_TPU_PROFILE_DIR"]
        training, training_launches = tooling_training(
            torch, train, kernels, os.path.join(root, "training"))
        reader.join(timeout=600)
        if "port" not in port_box:
            raise AssertionError(f"(e) launcher: {port_box}")
        sigterm = tooling_sigterm(proc, port_box["port"], journal)
    finally:
        stop_process(proc)
        shutil.rmtree(root, ignore_errors=True)
    out = dict(serving=serving, training=training, sigterm=sigterm,
               phase_s=time.perf_counter() - t0)
    log(f"tooling phase: {out['phase_s']:.1f} s")
    return out, {"tooling_serving": serving_launches,
                 "tooling_training": training_launches}


# The process-group phase (16): a one-rank NCCL group on the card; the
# LM of phase 7 and ResNet-50 of phase 8 through the driver on a mesh
# (--fsdp, --model-parallelism 1), against phase 7's losses at the same
# steps (STEP_LOSS_TOL); a two-rank NCCL group on one card, whose
# outcome is recorded; the program guard over phase 6's kind of mixed
# paged and dense traffic.
GROUP_STEPS = 4
GROUP_WARMUP = 1
GROUP_RESNET_STEPS = 3
TWO_RANK_TIMEOUT_S = 90
GUARD_SUFFIXES = 8                   # prefix + 3-30-token suffixes
GUARD_COLD = (100, 700)
GUARD_NEW = 16

_TWO_RANKS = r'''
import datetime, sys, torch, torch.distributed as dist
rank, port = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
try:
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
        rank=rank, timeout=datetime.timedelta(seconds=60),
        device_id=torch.device("cuda", 0))
    t = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    print("RESULT ok", t.tolist(), flush=True)
except Exception as e:
    print("RESULT error", type(e).__name__,
          " ".join(str(e).split())[:1500], flush=True)
    sys.exit(3)
finally:
    if dist.is_initialized():
        dist.destroy_process_group()
'''


COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor", "batch_isend_irecv", "broadcast",
               "all_to_all", "all_to_all_single")


@contextlib.contextmanager
def counting_collectives(dist):
    """{name: calls} of torch.distributed's collectives in the body."""
    counts = dict.fromkeys(COLLECTIVES, 0)
    saved = {name: getattr(dist, name) for name in COLLECTIVES}

    def counted(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return saved[name](*args, **kwargs)
        return call

    for name in COLLECTIVES:
        setattr(dist, name, counted(name))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def group_lm(torch, train, kernels, report, flag):
    """(a) MODEL through the driver as the one rank of the NCCL group,
    with ``flag`` (--fsdp, or --model-parallelism 1): 8/8/8/1/1 launches
    a step, no collective (every mesh axis is one rank wide), a finite
    falling loss, and the losses of phase 7's first GROUP_STEPS steps
    (same init, same batches) within STEP_LOSS_TOL relative; whether
    they are bitwise equal is reported."""
    per_step = (MODEL["num_layers"],) * 3 + (1, 1)
    with counting_collectives(torch.distributed) as calls:
        summary, launches, trainer, _ = drive(
            torch, train, kernels,
            train_argv(GROUP_STEPS, GROUP_WARMUP) + flag, per_step,
            GROUP_WARMUP)
    losses = summary["losses"]
    want = report["train"]["losses"][:GROUP_STEPS]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    result = summary["driver_result"]
    out = dict(flag=" ".join(flag), losses=losses, no_group_losses=want,
               loss_rel_err_max=max(rel), bitwise_equal=losses == want,
               step_ms_mean=summary["step_ms_mean"],
               tokens_per_s=result["tokens_per_sec"],
               mesh=result.get("mesh"), devices=result["devices"],
               backend=torch.distributed.get_backend(),
               peak_memory_gb=summary["peak_memory_gb"],
               collectives=sum(calls.values()))
    log(f"group lm {out['flag']}:", json.dumps(out))
    if trainer.mesh is None or out["mesh"] != {"data": 1, "model": 1}:
        raise AssertionError(f"(a) {flag}: the driver trained without the "
                             f"group's mesh: {out}")
    if out["collectives"]:
        raise AssertionError(f"(a) {flag}: collectives on a one-rank "
                             f"mesh: {calls}")
    if out["backend"] != "nccl" or out["devices"] != 1:
        raise AssertionError(f"(a) {flag}: not a one-rank NCCL group: {out}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"(a) {flag}: the loss did not fall: {losses}")
    if max(rel) > STEP_LOSS_TOL:
        raise AssertionError(f"(a) {flag}: losses differ from the steps "
                             f"without a group: {out}")
    torch.cuda.empty_cache()
    return out, launches


def group_resnet(torch, train, kernels, report):
    """(b) ResNet-50 at bench.py's shape as the one rank of the NCCL
    group (a data mesh one rank wide: the batch statistics are the
    global batch's, so no BatchNorm reduces them and no collective
    runs): 0/0/0/1/1 launches a step and the running statistics of all
    53 BNs moved; phase 8's first losses beside it."""
    from container_engine_accelerators_tpu_torch.models.layers import (
        BatchNorm,
    )
    with counting_collectives(torch.distributed) as calls:
        summary, launches, trainer, state = drive(
            torch, train, kernels,
            image_argv("resnet", RESNET_BATCH, GROUP_RESNET_STEPS, 1)
            + ["--model-parallelism", "1"], (0, 0, 0, 1, 1), 1)
    norms = [m for m in state.model.modules() if isinstance(m, BatchNorm)]
    still = [i for i, m in enumerate(norms)
             if not ((m.running_mean != 0).any()
                     and (m.running_var != 1).any())]
    synced = sum(m.stats_reduce is not None for m in norms)
    want = report["resnet"]["losses"][:GROUP_RESNET_STEPS]
    out = dict(losses=summary["losses"], no_group_losses=want,
               loss_rel_err_max=max(abs(a - b) / abs(b) for a, b in
                                    zip(summary["losses"], want)),
               batch_norms=len(norms), stats_reduced=synced,
               stats_unmoved=still, collectives=sum(calls.values()),
               images_per_s=summary["driver_result"]["images_per_sec"],
               step_ms_mean=summary["step_ms_mean"],
               mesh=summary["driver_result"].get("mesh"))
    log("group resnet:", json.dumps(out))
    if len(norms) != 53 or synced or still or out["collectives"]:
        raise AssertionError(f"(b) BatchNorms or collectives: {out}")
    if out["mesh"] != {"data": 1, "model": 1}:
        raise AssertionError(f"(b) no mesh: {out}")
    del trainer, state
    torch.cuda.empty_cache()
    return out, launches


def two_ranks_one_card():
    """(c) A two-rank NCCL group on the one card, each rank a process
    on cuda:0: each rank's outcome ("ok" with its all-reduce, or the
    error NCCL gave) and the last lines of its stderr. Recorded, not
    gated: NCCL puts one rank on a device."""
    from container_engine_accelerators_tpu_torch.parallel.distributed \
        import free_local_port
    port = str(free_local_port())
    env = dict(os.environ, NCCL_DEBUG="WARN")
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_RANKS, str(r),
                               port], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(2)]
    out = []
    deadline = time.monotonic() + TWO_RANK_TIMEOUT_S
    for rank, proc in enumerate(procs):
        try:
            stdout, stderr = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            result = next((line[len("RESULT "):] for line in
                           stdout.splitlines()
                           if line.startswith("RESULT ")), "no result")
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
            result = f"timed out after {TWO_RANK_TIMEOUT_S} s"
        tail = [line for line in stderr.splitlines() if line.strip()][-6:]
        out.append(dict(rank=rank, returncode=proc.returncode,
                        result=result, stderr_tail=tail))
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log("two NCCL ranks on one card:", json.dumps(out))
    return out


def guard_traffic(torch, engine, rng, dense_buckets=None):
    """Phase 6's kind of traffic straight into an engine: a PAGED_PREFIX
    system prompt alone, GUARD_SUFFIXES rows of it plus a distinct
    3-30-token suffix, then GUARD_COLD cold prompts, GUARD_NEW steps
    after each wave; dense rows padded to their bucket."""
    import numpy as np
    vocab = MODEL["vocab_size"]
    prefix = rng.integers(0, vocab, PAGED_PREFIX)
    suffixes = [rng.integers(0, vocab, int(n))
                for n in 3 + rng.permutation(28)[:GUARD_SUFFIXES]]
    waves = [[prefix],
             [np.concatenate([prefix, s]) for s in suffixes[:4]],
             [np.concatenate([prefix, s]) for s in suffixes[4:]],
             [rng.integers(0, vocab, n) for n in GUARD_COLD]]
    for wave in waves:
        slots = []
        for prompt in wave:
            row = prompt
            if dense_buckets is not None:
                width = next(b for b in dense_buckets if b >= len(prompt))
                row = np.zeros(width, np.int64)
                row[:len(prompt)] = prompt
            slots.append(engine.admit(row, len(prompt),
                                      max_new=GUARD_NEW)[0])
        for _ in range(GUARD_NEW):
            engine.step()
        for slot in slots:
            engine.release(slot)
    torch.cuda.synchronize()


def guard_engines(torch, model, kernels, rng):
    """(d) The program guard (analysis/programs.py) over the paged and
    the dense engine at full width, the server's buckets and slot
    length: every prefill within one program a bucket, one insert
    (paged), one step, no CUDA-graph capture; the launch counts of each
    pool's traffic."""
    from container_engine_accelerators_tpu_torch.analysis import programs
    from container_engine_accelerators_tpu_torch.models import decode
    buckets, b = [], 16
    max_prompt = MODEL["max_seq_len"] - MAX_NEW
    while b < max_prompt:
        buckets.append(b)
        b *= 2
    buckets.append(max_prompt)
    out, launches = {}, {}
    for name, paged in (("paged", True), ("dense", False)):
        engine = decode.SlotDecodeEngine(
            model, MAX_BATCH, max_prompt + MAX_NEW, paged=paged,
            buckets=buckets)
        guard = programs.engine_guard(
            engine, prefill_budget=None if paged else len(buckets))
        for kern in kernels:
            kern.launches = 0
        t0 = time.perf_counter()
        with guard:
            guard_traffic(torch, engine, rng,
                          None if paged else buckets)
        launches[f"guard_{name}"] = {k.name: k.launches for k in kernels}
        out[name] = dict(programs=guard.programs(), budgets=guard.budgets(),
                         seconds=time.perf_counter() - t0,
                         launches=launches[f"guard_{name}"])
        del engine
        torch.cuda.empty_cache()
    log("program guard:", json.dumps(out))
    if launches["guard_paged"]["flash_fwd"]:
        raise AssertionError(f"(d) the paged pool launched flash: {out}")
    if not launches["guard_dense"]["flash_fwd"]:
        raise AssertionError(f"(d) the dense pool never launched flash: "
                             f"{out}")
    return out, launches


def drive_group(torch, train, model, kernels, rng, report):
    """Phase 16 (the module docstring): (a)-(d) in a one-rank NCCL group
    this function starts and tears down. Returns (report, launches by
    path)."""
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel import (
        distributed,
    )
    t0 = time.perf_counter()
    distributed.start_local_group("cuda:0")
    try:
        fsdp, fsdp_launches = group_lm(torch, train, kernels, report,
                                       ["--fsdp"])
        mp1, mp1_launches = group_lm(torch, train, kernels, report,
                                     ["--model-parallelism", "1"])
        resnet, resnet_launches = group_resnet(torch, train, kernels,
                                               report)
    finally:
        dist.destroy_process_group()
    two = two_ranks_one_card()
    guard, guard_launches = guard_engines(torch, model, kernels, rng)
    out = dict(lm_fsdp=fsdp, lm_model_parallelism_1=mp1, resnet=resnet,
               two_ranks_one_card=two, guard=guard,
               phase_s=time.perf_counter() - t0)
    log(f"process-group phase: {out['phase_s']:.1f} s")
    return out, dict({"group_lm_fsdp": fsdp_launches,
                      "group_lm_mp1": mp1_launches,
                      "group_resnet": resnet_launches}, **guard_launches)


PATH_KERNELS.update({
    "group_lm_fsdp": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                      "xent_fwd", "xent_bwd"),
    "tp_dense": ("flash_fwd",),
    "ring_card": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
    "ulysses_card": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
    "longctx_ring": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     "xent_fwd", "xent_bwd"),
    "moe_expert_mesh": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                        "xent_fwd", "xent_bwd"),
    "group_lm_mp1": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     "xent_fwd", "xent_bwd"),
    "group_resnet": ("xent_fwd", "xent_bwd"),
    "guard_dense": ("flash_fwd",),
})


# ---------------------------------------------------------------------
# Phase 17: tensor-parallel serving, context and expert parallelism in
# a one-rank NCCL group (the module docstring).
# ---------------------------------------------------------------------
TP_PROMPTS = (16, 100, 700, 1500)        # concurrent greedy requests
TP_NEW = 32
RING_SEQ = 32768                         # longcontext-lm-jax.yaml
RING_HEADS = 16
RING_BLOCKS = 8                          # the manifest's context axis
LONG = ["--model", "transformer", "--vocab-size", "32000",
        "--embed-dim", "1024", "--num-layers", "12", "--num-heads", "16",
        "--seq-len", "32768"]
LONG_BATCH = 1                           # the manifest's 8, one chip's 1
LONG_STEPS = 3


def tp_traffic(server, prompts):
    """Every prompt as one greedy request, all at once; the sequences in
    prompt order."""
    out, errors = [None] * len(prompts), []

    def one(i):
        try:
            status, body = post(server.port, {
                "prompts": [prompts[i].tolist()],
                "max_new_tokens": TP_NEW})
            if status != 200:
                raise AssertionError(f"status {status}: {body}")
            out[i] = body["sequences"][0]
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def tp_serving(torch, kernels, rng):
    """17a: the launcher's --tensor-parallel path as the one rank of the
    group, on the paged pool, the dense pool and the deployed int8
    form, against the same requests on a server without a group; the
    program guard over each lockstep engine."""
    from container_engine_accelerators_tpu_torch.analysis import programs
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        MeshSpec,
        build_mesh,
    )
    from container_engine_accelerators_tpu_torch.parallel.spmd import Spmd
    from container_engine_accelerators_tpu_torch.serving import (
        lockstep,
        serve,
    )
    from container_engine_accelerators_tpu_torch.serving.server import (
        GenerationServer,
    )
    vocab = MODEL["vocab_size"]
    prompts = [rng.integers(0, vocab, n) for n in TP_PROMPTS]
    forms = (("paged", [], True), ("dense", [], False),
             ("int8", ["--kv-cache-dtype", "int8", "--quantize-weights",
                       "int8"], True))
    mesh = build_mesh(MeshSpec(data=1, model=1))
    out, launches = {}, {}
    for name, flags, paged in forms:
        args = serve.parse_args(lm_flags() + flags
                                + ["--tensor-parallel", "1"])
        model, _ = serve.build_lm_models(args, "cuda:0")
        with torch.no_grad():
            spmd = Spmd(mesh, model)
        channel = lockstep.Channel()

        def make(lk):
            if not paged:
                os.environ["CEA_TPU_PAGED_KV"] = "0"
            try:
                return GenerationServer("lm", model, port=0,
                                        max_new_tokens=MAX_NEW,
                                        max_batch=MAX_BATCH,
                                        host="127.0.0.1", lockstep=lk)
            finally:
                os.environ.pop("CEA_TPU_PAGED_KV", None)

        plain = make(None)
        plain.start()
        try:
            want = tp_traffic(plain, prompts)
        finally:
            plain.stop()
        del plain
        srv = make(channel)
        engine = srv.engine
        if not isinstance(engine, lockstep.LockstepEngine):
            raise AssertionError(f"(a) {name}: not a lockstep engine")
        srv.start()
        for kern in kernels:
            kern.launches = 0
        prefills0 = engine.prefills
        t0 = time.perf_counter()
        try:
            got = tp_traffic(srv, prompts)
        finally:
            srv.stop()
        served_s = time.perf_counter() - t0
        launches[f"tp_{name}"] = {k.name: k.launches for k in kernels}
        admissions = engine.prefills - prefills0
        buckets = srv._buckets
        guard_engine = lockstep.build_engine(
            channel, model, slots=MAX_BATCH, slot_len=engine.slot_len,
            paged=paged, buckets=buckets)
        guard = programs.engine_guard(
            guard_engine._engine,
            prefill_budget=None if paged else len(buckets))
        with guard:
            guard_traffic(torch, guard_engine, rng,
                          None if paged else buckets)
        channel.stop()
        mism = [dict(prompt_len=len(p), first_diff=next(
            (i for i, (a, b) in enumerate(zip(g, w)) if a != b), None))
            for p, g, w in zip(prompts, got, want) if g != w]
        fl = launches[f"tp_{name}"]
        row = dict(paged=engine.paged, kv_quant=engine.kv_quant,
                   admissions=admissions, launches=fl, served_s=served_s,
                   sharded=sum(lay.sharded for lay in
                               spmd.layouts.values()),
                   mismatches=mism, programs=guard.programs(),
                   budgets=guard.budgets())
        log(f"tp serving {name}:", json.dumps(row))
        out[name] = row
        if mism:
            raise AssertionError(f"(a) {name}: streams differ from the "
                                 f"server without a group: {mism}")
        want_fwd = MODEL["num_layers"] * admissions if not paged else 0
        if fl["flash_fwd"] != want_fwd or any(
                fl[k] for k in fl if k != "flash_fwd"):
            raise AssertionError(f"(a) {name}: launches {fl}, want "
                                 f"flash_fwd {want_fwd} and nothing else")
        if engine.paged != paged:
            raise AssertionError(f"(a) {name}: the wrong pool")
        del srv, engine, guard_engine, model
        torch.cuda.empty_cache()
    return out, launches


def ring_on_card(torch, attn, context, kernels):
    """17b: the ring's hop and merge over every hop of every block at
    the long-context width, and Ulysses' local attention on its head
    groups, against flash_attention on the whole sequence (forward and
    dQ/dK/dV); the hops by kind and the launches."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    shape = (1, RING_SEQ, RING_HEADS, 64)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    dtype = "torch.bfloat16"

    def leaves():
        return [t.clone().requires_grad_() for t in (q, k, v)]

    def timed(fn, grads):
        """fn's result, its device-clock ms on a second, warm pass
        beside the first (the allocator's first blocks of these sizes),
        and the second pass's launches; ``grads``' gradients are the
        second pass's."""
        ms = []
        for _ in range(2):
            for t in grads:
                t.grad = None
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            for kern in kernels:
                kern.launches = 0
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        return out, ms, {kern.name: kern.launches for kern in kernels}

    ref, ring, uly = leaves(), leaves(), leaves()

    def whole():
        o = attn.flash_attention(*ref, causal=True)
        o.backward(do)
        return o

    want, whole_ms, whole_launches = timed(whole, ref)
    blk = RING_SEQ // RING_BLOCKS
    kinds = dict.fromkeys(("diagonal", "full", "masked"), 0)

    def hops():
        qs, ks, vs = ring
        outs = []
        for i in range(RING_BLOCKS):
            qi = qs[:, i * blk:(i + 1) * blk]
            acc = torch.zeros(qi.shape, dtype=torch.float32, device="cuda")
            m = torch.full(qi.shape[:3], -math.inf, device="cuda")
            den = torch.zeros(qi.shape[:3], device="cuda")
            for t in range(RING_BLOCKS):
                j = (i - t) % RING_BLOCKS
                kinds["diagonal" if j == i else "full" if j < i
                      else "masked"] += 1
                o_t, lse_t = context._flash_hop(
                    qi, ks[:, j * blk:(j + 1) * blk],
                    vs[:, j * blk:(j + 1) * blk], i * blk, j * blk, True)
                acc, m, den = context._lse_merge(acc, m, den, o_t, lse_t)
            outs.append((acc / den[..., None]).to(qi.dtype))
        o = torch.cat(outs, dim=1)
        o.backward(do)
        return o

    got, ring_ms, ring_launches = timed(hops, ring)
    kinds = {k: n // 2 for k, n in kinds.items()}   # two passes
    groups = RING_HEADS // RING_BLOCKS

    def ulysses():
        outs = []
        for g in range(RING_BLOCKS):
            # What the all-to-all hands a rank: every position, its
            # heads, contiguous.
            sl = slice(g * groups, (g + 1) * groups)
            outs.append(attn.flash_attention(
                *(t[:, :, sl].contiguous() for t in uly), causal=True))
        o = torch.cat(outs, dim=2)
        o.backward(do)
        return o

    got_u, uly_ms, uly_launches = timed(ulysses, uly)
    errors = {}
    for name, out, grads in (("ring", got, ring), ("ulysses", got_u, uly)):
        errors[name] = {}
        for what, a, b in (("o", out, want), ("dq", grads[0].grad,
                                              ref[0].grad),
                           ("dk", grads[1].grad, ref[1].grad),
                           ("dv", grads[2].grad, ref[2].grad)):
            err, tol = near(a, b, dtype)
            errors[name][what] = dict(err=err, tol=tol)
    hop_count = kinds["diagonal"] + kinds["full"]
    out = dict(shape=list(shape), blocks=RING_BLOCKS, hops=kinds,
               ring_launches=ring_launches, whole_launches=whole_launches,
               ulysses_launches=uly_launches, errors=errors,
               ring_fwd_bwd_ms=ring_ms[1], whole_fwd_bwd_ms=whole_ms[1],
               ulysses_fwd_bwd_ms=uly_ms[1],
               first_pass_ms=dict(ring=ring_ms[0], whole=whole_ms[0],
                                  ulysses=uly_ms[0]))
    log("ring on the card:", json.dumps(out))
    bad = [(n, w) for n, e in errors.items() for w, x in e.items()
           if not x["err"] <= x["tol"]]
    if bad:
        raise AssertionError(f"(b) beyond phase 4's tolerance: {bad}")
    want_l = {"flash_fwd": hop_count, "flash_bwd_dq": hop_count,
              "flash_bwd_dkv": hop_count}
    if ({k: ring_launches[k] for k in want_l} != want_l
            or kinds["masked"] != RING_BLOCKS * (RING_BLOCKS - 1) // 2):
        raise AssertionError(f"(b) hops {kinds}, launches {ring_launches}")
    if uly_launches["flash_fwd"] != RING_BLOCKS:
        raise AssertionError(f"(b) Ulysses launches {uly_launches}")
    del q, k, v, do, ref, ring, uly, got, got_u, want
    torch.cuda.empty_cache()
    return out, {"ring_card": ring_launches, "ulysses_card": uly_launches}


def train_steps(torch, trainer, state, loader, steps, kernels, per_step):
    """``steps`` Trainer steps with every launch count set to 0 first and
    each step's launches checked against ``per_step``; (losses, step
    times in ms after the first, launches)."""
    for kern in kernels:
        kern.launches = 0
    losses, events, bad = [], [], []
    prev = [0] * len(kernels)
    for step, batch in zip(range(steps), loader):
        state, loss = trainer.train_step(state, batch)
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        events.append(event)
        losses.append(loss)
        counts = [kern.launches for kern in kernels]
        got = tuple(c - p for c, p in zip(counts, prev))
        if got != per_step:
            bad.append((step, got))
        prev[:] = counts
    torch.cuda.synchronize()
    if bad:
        raise AssertionError(f"steps with other launches than {per_step}: "
                             f"{bad}")
    losses = [float(x) for x in losses]
    if not all(x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return losses, step_ms, {kern.name: kern.launches for kern in kernels}


def long_context(torch, train, context, kernels):
    """17c: the long-context manifest's model (batch 1) through the
    Trainer with ring attention on a one-rank ("data", "context") mesh,
    then the same steps with the default flash attention."""
    from container_engine_accelerators_tpu_torch.parallel import (
        SyntheticTokenLoader,
        Trainer,
    )
    args = train.parse_args(LONG + [
        "--device", "cuda", "--batch-size", str(LONG_BATCH), "--steps",
        str(LONG_STEPS), "--seed", str(SEED)])
    per_step = (12, 12, 12, 1, 1)
    runs = {}
    for name in ("ring", "flash"):
        model, loss_fn = train.build_lm(args, "cuda")
        mesh = None
        if name == "ring":
            mesh = context.build_context_mesh(context=1)
            fn = functools.partial(context.ring_attention, mesh,
                                   axis_name=context.CONTEXT_AXIS,
                                   batch_axis="data")
            for block in model.blocks:
                block.attn.attention_fn = fn
        trainer = Trainer(model, loss_fn, train.build_tx(args), mesh=mesh)
        state = trainer.init_state()
        loader = SyntheticTokenLoader(args.batch_size, args.seq_len,
                                      args.vocab_size, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms, fl = train_steps(torch, trainer, state, loader,
                                          LONG_STEPS, kernels, per_step)
        runs[name] = dict(losses=losses, step_ms=step_ms, launches=fl,
                          peak_memory_gb=torch.cuda.max_memory_allocated()
                          / 1e9,
                          mesh=None if mesh is None else dict(zip(
                              mesh.mesh_dim_names, mesh.mesh.shape)))
        del model, trainer, state, loader
        torch.cuda.empty_cache()
    ring, flash = runs["ring"], runs["flash"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(ring["losses"],
                                                  flash["losses"]))
    out = dict(runs, loss_rel_err_max=rel,
               bitwise_equal=ring["losses"] == flash["losses"],
               tokens_per_s=LONG_BATCH * RING_SEQ * 1e3 / (
                   sum(ring["step_ms"]) / len(ring["step_ms"])))
    log("long context:", json.dumps(out))
    if not ring["losses"][-1] < ring["losses"][0]:
        raise AssertionError(f"(c) the loss did not fall: {ring}")
    if rel > STEP_LOSS_TOL:
        raise AssertionError(f"(c) ring losses differ from flash's: {out}")
    return out, ring["launches"]


def moe_expert_mesh(torch, train, kernels, report):
    """17d: phase 13's MoE bound to a one-rank expert mesh through the
    Trainer, against phase 13's losses at the same steps."""
    from container_engine_accelerators_tpu_torch.parallel import (
        SyntheticTokenLoader,
        Trainer,
    )
    from container_engine_accelerators_tpu_torch.parallel import expert
    args = train.parse_args(train_argv(MOE_STEPS, MOE_WARMUP) + [
        "--model", "moe", "--num-experts", str(MOE["num_experts"])])
    model, loss_fn = train.build_lm(args, "cuda")
    mesh = expert.build_expert_mesh(expert=1)
    model.bind_mesh(mesh)
    trainer = Trainer(model, loss_fn, train.build_tx(args), mesh=mesh)
    loader = SyntheticTokenLoader(args.batch_size, args.seq_len,
                                  args.vocab_size, device="cuda")
    per_step = (MOE["num_layers"],) * 3 + (1, 1)
    losses, step_ms, fl = train_steps(torch, trainer, trainer.init_state(),
                                      loader, MOE_STEPS, kernels, per_step)
    want = report["moe"]["train"]["losses"][:MOE_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    out = dict(losses=losses, phase13_losses=want, loss_rel_err_max=rel,
               bitwise_equal=losses == want, step_ms=step_ms, launches=fl,
               mesh=dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)))
    log("moe on the expert mesh:", json.dumps(out))
    if rel > STEP_LOSS_TOL:
        raise AssertionError(f"(d) losses differ from phase 13's: {out}")
    del model, trainer
    torch.cuda.empty_cache()
    return out, fl


def drive_parallel(torch, train, attn, kernels, rng, report):
    """Phase 17 (the module docstring): (a)-(d) in a one-rank NCCL group
    this function starts and tears down. Returns (report, launches by
    path)."""
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel import (
        context,
        distributed,
    )
    t0 = time.perf_counter()
    distributed.start_local_group("cuda:0")
    try:
        tp, tp_launches = tp_serving(torch, kernels, rng)
        ring, ring_launches = ring_on_card(torch, attn, context, kernels)
        longctx, long_launches = long_context(torch, train, context,
                                              kernels)
        moe, moe_launches = moe_expert_mesh(torch, train, kernels, report)
    finally:
        dist.destroy_process_group()
    out = dict(tensor_parallel=tp, ring=ring, long_context=longctx,
               moe_expert_mesh=moe, phase_s=time.perf_counter() - t0)
    log(f"parallel phase: {out['phase_s']:.1f} s")
    return out, dict(tp_launches, **ring_launches,
                     longctx_ring=long_launches,
                     moe_expert_mesh=moe_launches)


# ---------------------------------------------------------------------
# Phase 18: pipeline parallelism and elastic recovery (the module
# docstring).
# ---------------------------------------------------------------------
# demo/tpu-training/pipeline-lm-jax.yaml's model at full width, its
# pipe axis cut from 4 to 1: one card is one rank.
PIPE = ["--model", "transformer", "--device", "cuda", "--vocab-size",
        "32000", "--embed-dim", "1024", "--num-layers", "16",
        "--num-heads", "16", "--seq-len", "2048", "--batch-size", "32",
        "--num-microbatches", "8", "--pipeline-parallelism", "1",
        "--seed", str(SEED)]
PIPE_LAYERS, PIPE_M = 16, 8
PIPE_STEPS = 4
PIPE_WARMUP = 1
PIPE_CHECK_BATCH, PIPE_CHECK_M = 8, 2   # 4-row microbatches, as training
PIPE_LOGITS_TOL = 1e-2                  # relative L2, bf16 compute
ELASTIC_STEPS = 3
PATH_KERNELS.update({
    "pipeline": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
                 "xent_bwd"),
    "elastic_lm": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                   "xent_fwd", "xent_bwd"),
})


def pipeline_reference(torch, train):
    """18a(1): the pipelined logits and gradients of one batch of
    PIPE_CHECK_BATCH rows against ``reference_apply`` (the blocks
    folded in order on the whole batch) on the same weights, under the
    training loss: logits within PIPE_LOGITS_TOL and every gradient
    leaf within STEP_GRAD_TOL, relative L2."""
    from container_engine_accelerators_tpu_torch.ops.xent import (
        mean_cross_entropy_loss,
    )
    from container_engine_accelerators_tpu_torch.parallel import (
        PipelinedLM,
        SyntheticTokenLoader,
    )
    from container_engine_accelerators_tpu_torch.models.transformer import (
        next_token_loss_fn,
    )
    args = train.parse_args(PIPE)
    lm = PipelinedLM(args.vocab_size, args.embed_dim, args.num_layers,
                     args.num_heads, args.seq_len, pipe=1, device="cuda")
    lm.load(lm.init(SEED)).train()
    tokens = next(iter(SyntheticTokenLoader(
        PIPE_CHECK_BATCH, args.seq_len, args.vocab_size, device="cuda")))[0]
    loss_fn = next_token_loss_fn(mean_cross_entropy_loss)
    runs = {}
    for name, fn in (("pipelined", lambda t: lm.apply(
            t, mesh=None, num_microbatches=PIPE_CHECK_M)),
                     ("reference", lm.reference_apply)):
        lm.zero_grad(set_to_none=True)
        logits = fn(tokens)
        loss = loss_fn(logits, tokens)
        loss.backward()
        runs[name] = (logits.detach(), loss.item(),
                      {n: p.grad for n, p in lm.named_parameters()})
        del logits, loss
    (lp, loss_p, gp), (lr, loss_r, gr) = runs["pipelined"], runs["reference"]
    rel = {n: ((gp[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
           for n, g in gr.items()}
    worst = max(rel, key=rel.get)
    out = dict(batch=PIPE_CHECK_BATCH, microbatches=PIPE_CHECK_M,
               logits_rel_l2=((lp - lr).norm() / lr.norm()).item(),
               logits_max_abs_err=(lp - lr).abs().max().item(),
               loss=loss_p, reference_loss=loss_r,
               grad_rel_l2_max=rel[worst], grad_rel_l2_worst=worst,
               grad_rel_l2_median=sorted(rel.values())[len(rel) // 2],
               logits_tol=PIPE_LOGITS_TOL, grad_tol=STEP_GRAD_TOL)
    log("pipelined vs reference_apply:", json.dumps(out))
    del runs, lp, lr, gp, gr, lm
    torch.cuda.empty_cache()
    if (out["logits_rel_l2"] > PIPE_LOGITS_TOL
            or out["grad_rel_l2_max"] > STEP_GRAD_TOL):
        raise AssertionError(f"(a) pipelined step differs from "
                             f"reference_apply: {out}")
    return out


def pipeline_run(torch, train, kernels, extra=()):
    """One run of the port's ``run_pipeline_lm`` on PIPE + ``extra``
    (in whatever group is up), every launch count set to 0 just before
    it; each step's launches against 128/128/128/1/1 (flash_fwd 256
    with --remat). Returns (summary, launches, final parameters on the
    host)."""
    remat = "--remat" in extra
    ticks = PIPE_M * PIPE_LAYERS
    per_step = (2 * ticks if remat else ticks, ticks, ticks, 1, 1)
    losses, events, bad = [], [], []
    prev = [0] * len(kernels)

    def on_step(step, loss):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        events.append(event)
        losses.append(loss)
        counts = [kern.launches for kern in kernels]
        got = tuple(c - p for c, p in zip(counts, prev))
        if got != per_step:
            bad.append((step, got))
        prev[:] = counts

    args = train.parse_args(PIPE + ["--steps", str(PIPE_STEPS),
                                    "--warmup-steps", str(PIPE_WARMUP)]
                            + list(extra))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    result, lm, optimizer = train.run_pipeline_lm(args, on_step=on_step)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {kern.name: kern.launches for kern in kernels}
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in losses]
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    params = {n: p.detach().cpu() for n, p in lm.named_parameters()}
    del lm, optimizer
    torch.cuda.empty_cache()
    n_params = sum(p.numel() for p in params.values())
    summary = dict(
        flags=list(extra), losses=losses, step_ms=step_ms,
        step_ms_mean=sum(step_ms) / len(step_ms),
        tokens_per_s=args.batch_size * args.seq_len * 1e3 / (
            sum(step_ms) / len(step_ms)),
        peak_memory_gb=peak, wall_s=wall_s, params=n_params,
        per_step_launches_expected=per_step, bad_steps=bad,
        group=torch.distributed.is_initialized(), driver_result=result)
    log(f"pipeline run {' '.join(extra) or '(no remat)'} "
        f"{'in the group' if summary['group'] else 'without a group'}: "
        f"{summary['step_ms_mean']:.1f} ms a step, "
        f"{summary['tokens_per_s']:.0f} tokens/s, peak memory "
        f"{peak:.2f} GB, {n_params} parameters, losses {losses}")
    if bad:
        raise AssertionError(f"(a) steps with other launch counts than "
                             f"{per_step}: {bad}")
    if not all(x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"(a) non-finite loss: {losses}")
    want = {kern.name: PIPE_STEPS * n for kern, n in zip(kernels, per_step)}
    if launches != want or result["kernel_launches"] != want:
        raise AssertionError(f"(a) launches {launches}, driver "
                             f"{result['kernel_launches']}, want {want}")
    return summary, launches, params


def elastic_on_card(torch, train, kernels, root):
    """18b: MODEL through the Trainer on a one-rank (data, model) mesh:
    ELASTIC_STEPS steps, a checkpoint, ELASTIC_STEPS more uninterrupted;
    then the supervisor plans the eviction of a second host that holds
    no rank (one card cannot lose one), and its ``rebuild`` runs the
    recovery on rank 0: a rebuilt one-rank mesh, ``Trainer.remesh``,
    the resharded ``restore_state(shardings=)``. The next steps on the
    same batches must give the uninterrupted losses bitwise, the
    restart bucket must hold the recovery, and one train.recovered
    event must be journaled. Returns (report, launches of the first
    run)."""
    from container_engine_accelerators_tpu_torch import obs
    from container_engine_accelerators_tpu_torch.parallel import (
        CheckpointManager,
        ElasticSupervisor,
        MeshSpec,
        SyntheticTokenLoader,
        Trainer,
        build_mesh,
        state_payload,
    )
    args = train.parse_args(train_argv(2 * ELASTIC_STEPS, 1))
    config, schedule = train.lm_config(args), args.lr_schedule != "constant"
    model, loss_fn = train.build_lm(args, "cuda")
    trainer = Trainer(model, loss_fn, train.build_tx(args),
                      mesh=build_mesh(MeshSpec(data=1, model=1)))
    state = trainer.init_state()

    def batches(skip=0):
        loader = iter(SyntheticTokenLoader(args.batch_size, args.seq_len,
                                           args.vocab_size, device="cuda"))
        for _ in range(skip):
            next(loader)
        return loader

    per_step = (MODEL["num_layers"],) * 3 + (1, 1)
    loader = batches()
    losses, step_ms, launches = train_steps(
        torch, trainer, state, loader, ELASTIC_STEPS, kernels, per_step)
    mgr = CheckpointManager(os.path.join(root, "elastic"),
                            goodput=trainer.goodput)
    with trainer.full_state(state):
        mgr.save(state_payload(state, config, schedule), step=state.step)
    ref = []
    for _, batch in zip(range(ELASTIC_STEPS), loader):
        state, loss = trainer.train_step(state, batch)
        ref.append(loss)
    ref = [float(x) for x in ref]
    tracer = obs.Tracer(enabled=True)
    sup = ElasticSupervisor(hosts=["h0", "h1"], goodput=trainer.goodput,
                            tracer=tracer,
                            host_devices={"h0": [0], "h1": []})
    plan = sup.evict([("h1", "health_down")])
    t0 = time.perf_counter()
    new_trainer, new_state, new_mesh = sup.rebuild(
        plan, trainer, mgr, init_state=lambda t: t.init_state(),
        config=config, schedule=schedule)
    rebuild_s = time.perf_counter() - t0
    resumed_at = new_state.step
    loader = batches(skip=ELASTIC_STEPS)
    resumed = []
    for _, batch in zip(range(ELASTIC_STEPS), loader):
        new_state, loss = new_trainer.train_step(new_state, batch)
        resumed.append(loss)
    resumed = [float(x) for x in resumed]
    books = trainer.goodput.publish()
    recovered = [e for e in tracer.snapshot()["events"]
                 if e["name"] == "train.recovered"]
    out = dict(first_losses=losses, uninterrupted=ref, resumed=resumed,
               bitwise_equal=resumed == ref, resume_step=resumed_at,
               rebuild_s=rebuild_s, restart_s=books["buckets"]["restart"],
               recovered_events=len(recovered),
               mesh=dict(zip(new_mesh.mesh_dim_names, new_mesh.mesh.shape)),
               plan=f"{plan.old_spec.data}x{plan.old_spec.model} -> "
                    f"{plan.mesh_spec.data}x{plan.mesh_spec.model}",
               step_ms=step_ms)
    log("elastic recovery:", json.dumps(out))
    mgr.close()
    del model, trainer, state, new_trainer, new_state
    torch.cuda.empty_cache()
    if not out["bitwise_equal"] or resumed_at != ELASTIC_STEPS:
        raise AssertionError(f"(b) the resumed losses differ from the "
                             f"uninterrupted run's: {out}")
    if not (out["restart_s"] > 0 and out["recovered_events"] == 1):
        raise AssertionError(f"(b) the recovery is not in the books: {out}")
    return out, launches


def drive_pipeline(torch, train, kernels):
    """Phase 18 (the module docstring): (a) in a one-rank NCCL group this
    function starts, then without a group; (b) in the group. Returns
    (report, launches by path)."""
    import tempfile

    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel import (
        distributed,
    )
    t0 = time.perf_counter()
    check = pipeline_reference(torch, train)
    root = tempfile.mkdtemp(prefix="chip_smoke_pipe_")
    distributed.start_local_group("cuda:0")
    try:
        grouped, launches, params = pipeline_run(torch, train, kernels)
        remat, _, remat_params = pipeline_run(torch, train, kernels,
                                              ["--remat"])
        elastic, elastic_launches = elastic_on_card(torch, train, kernels,
                                                    root)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    alone, _, alone_params = pipeline_run(torch, train, kernels)
    remat_same = all(torch.equal(params[n], remat_params[n])
                     for n in params)
    alone_same = all(torch.equal(params[n], alone_params[n])
                     for n in params)
    out = dict(reference=check, group=grouped, remat=remat,
               no_group=alone, elastic=elastic,
               losses_equal_without_group=alone["losses"] == grouped["losses"],
               params_equal_without_group=alone_same,
               remat_losses_equal=remat["losses"] == grouped["losses"],
               remat_params_equal=remat_same,
               phase_s=time.perf_counter() - t0)
    log(f"pipeline: {grouped['step_ms_mean']:.1f} ms a step, "
        f"{grouped['tokens_per_s']:.0f} tokens/s; peak memory "
        f"{grouped['peak_memory_gb']:.2f} GB, with --remat "
        f"{remat['peak_memory_gb']:.2f} GB "
        f"({remat['step_ms_mean']:.1f} ms a step)")
    log(f"pipeline phase: {out['phase_s']:.1f} s")
    losses = grouped["losses"]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"(a) the loss did not fall: {losses}")
    if not (out["losses_equal_without_group"]
            and out["params_equal_without_group"]):
        raise AssertionError(f"(a) the group's steps differ from the steps "
                             f"without one: {grouped['losses']} "
                             f"{alone['losses']}")
    if not (out["remat_losses_equal"] and remat_same):
        raise AssertionError(f"(a) --remat changed the steps: "
                             f"{remat['losses']} {grouped['losses']}")
    return out, {"pipeline": launches, "elastic_lm": elastic_launches}


# ---------------------------------------------------------------------
# Phase 19: the multichip dryrun and the combined ("data", "context",
# "expert") MoE step (the module docstring).
# ---------------------------------------------------------------------
COMBINED_STEPS = 3
# The dryrun's stage 2 at its own shape: 2 layers (#1/#3/#4 each, f32
# at head dim 8), the plain loss.
DRYRUN_STAGE2_PER_STEP = (2, 2, 2, 0, 0)
# The dryrun's stage 3 on one rank: the circular PipelinedLM of 2 layers
# over 2 microbatches (head dim 4, f32), one flash call a layer a
# microbatch each way; the plain loss. Its loss against the same step
# through the plain versions.
DRYRUN_STAGE3_PER_STEP = (4, 4, 4, 0, 0)
DRYRUN_STAGE3_TOL = 1e-4
PATH_KERNELS.update({
    "combined_moe": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     "xent_fwd", "xent_bwd"),
    "dryrun_stage2": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
    "dryrun_stage3": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
})


def dryrun_one_chip(torch, dryrun, kernels):
    """19a: ``dryrun_multichip(1)`` on the card, as the driver's one-chip
    validation calls it: stage 1 runs (a finite loss, step 1) and every
    other stage reports skipped, as the JAX gates say at n = 1."""
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    summary = dryrun.dryrun_multichip(1, device="cuda")
    torch.cuda.synchronize()
    out = dict(summary, seconds=time.perf_counter() - t0,
               launches={k.name: k.launches for k in kernels})
    log("dryrun on one card:", json.dumps(out))
    stages = summary["stages"]
    ran = [name for name, st in stages.items() if st["ran"]]
    loss = stages["dp_tp"].get("loss", float("nan"))
    if (ran != ["dp_tp"] or stages["dp_tp"]["step"] != 1
            or not math.isfinite(loss)
            or any(stages[n]["skipped"] != why for n, why in
                   dryrun.gates(1).items() if why is not None)):
        raise AssertionError(f"(a) the one-card dryrun: {out}")
    return out


def combined_step(torch, train, dryrun, kernels, report):
    """19b: phase 13's MoE through the Trainer on a (1, 1, 1) ("data",
    "context", "expert") mesh, ring attention over "context" and the
    routed layers bound to "expert", the driver's MoE loss, against
    phase 13's losses at the same steps; no collective a step."""
    from container_engine_accelerators_tpu_torch.parallel import (
        SyntheticTokenLoader,
        Trainer,
    )
    args = train.parse_args(train_argv(COMBINED_STEPS, MOE_WARMUP) + [
        "--model", "moe", "--num-experts", str(MOE["num_experts"])])
    model, loss_fn = train.build_lm(args, "cuda")
    mesh = dryrun.combined_mesh(1, 1, 1)
    dryrun.bind_combined(model, mesh)
    trainer = Trainer(model, loss_fn, train.build_tx(args), mesh=mesh)
    loader = SyntheticTokenLoader(args.batch_size, args.seq_len,
                                  args.vocab_size, device="cuda")
    per_step = (MOE["num_layers"],) * 3 + (1, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counting_collectives(torch.distributed) as calls:
        losses, step_ms, fl = train_steps(
            torch, trainer, trainer.init_state(), loader, COMBINED_STEPS,
            kernels, per_step)
    want = report["moe"]["train"]["losses"][:COMBINED_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    mean_ms = sum(step_ms) / len(step_ms)
    out = dict(losses=losses, phase13_losses=want, loss_rel_err_max=rel,
               bitwise_equal=losses == want, step_ms=step_ms,
               step_ms_mean=mean_ms,
               tokens_per_s=args.batch_size * args.seq_len * 1e3 / mean_ms,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               collectives=dict(calls), launches=fl,
               mesh=dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
               local_experts=int(model.blocks[1].moe.w_in.shape[0]))
    log("combined (data, context, expert) MoE step:", json.dumps(out))
    if sum(calls.values()):
        raise AssertionError(f"(b) collectives on a one-rank mesh: {out}")
    if rel > STEP_LOSS_TOL:
        raise AssertionError(f"(b) losses differ from phase 13's: {out}")
    del model, trainer
    torch.cuda.empty_cache()
    return out, fl


def dryrun_stage2_on_card(torch, dryrun, kernels):
    """19c: the dryrun's stage 2 at its own shape on a (1, 1, 1) mesh on
    the card: a finite loss, step 1, the f32 flash kernels launched
    (2/2/2/0/0: two layers, the plain loss)."""
    for kern in kernels:
        kern.launches = 0
    out = dryrun.stage_dp_sp_ep(1, "cuda", shape=(1, 1, 1))
    torch.cuda.synchronize()
    got = tuple(kern.launches for kern in kernels)
    res = dict(loss=out["loss"], step=out["step"], mesh=out["mesh"],
               local_experts=out["local_experts"],
               launches={k.name: k.launches for k in kernels})
    log("dryrun stage 2 on the card:", json.dumps(res))
    if (got != DRYRUN_STAGE2_PER_STEP or out["step"] != 1
            or not math.isfinite(out["loss"])):
        raise AssertionError(f"(c) stage 2 on the card: {res}")
    return res, res["launches"]


@contextlib.contextmanager
def plain_flash(attn):
    """The three flash wrappers' kernels replaced by their plain
    versions on the operands the route hands them (``run``: padded to
    the kernel head dim, the true head dim's scale); nothing launches
    meanwhile."""
    fns = {
        attn.flash_fwd: attn.flash_attention_reference,
        attn.flash_bwd_dq: lambda *a: (attn.flash_attention_dq_reference(
            *a),),
        attn.flash_bwd_dkv: attn.flash_attention_dkv_reference,
    }
    for kern, fn in fns.items():
        kern.run = fn
    try:
        yield
    finally:
        for kern in fns:
            del kern.run


def dryrun_stage3_on_card(torch, attn, dryrun, kernels):
    """19d: the dryrun's stage 3 on one rank (``stage_pp(1)``: the GPipe
    toy and the circular PipelinedLM at PIPE_LM's widths, head dim 4,
    f32) through the kernels, then the same step with the kernels
    replaced by their plain versions (``plain_flash``): a finite loss,
    step 1, DRYRUN_STAGE3_PER_STEP launches, the two LM losses within
    DRYRUN_STAGE3_TOL (relative)."""
    for kern in kernels:
        kern.launches = 0
    out = dryrun.stage_pp(1, "cuda")
    torch.cuda.synchronize()
    got = tuple(kern.launches for kern in kernels)
    with plain_flash(attn):
        plain = dryrun.stage_pp(1, "cuda")
    rel = abs(out["lm_loss"] - plain["lm_loss"]) / abs(plain["lm_loss"])
    res = dict(lm_loss=out["lm_loss"], plain_lm_loss=plain["lm_loss"],
               lm_loss_rel_err=rel, toy_loss=out["loss"],
               step=out["step"], mesh=out["mesh"],
               head_dim=dryrun.PIPE_LM["embed_dim"]
               // dryrun.PIPE_LM["num_heads"],
               launches={k.name: k.launches for k in kernels})
    log("dryrun stage 3 on the card:", json.dumps(res))
    if (got != DRYRUN_STAGE3_PER_STEP or out["step"] != 1
            or not math.isfinite(out["lm_loss"])
            or rel > DRYRUN_STAGE3_TOL):
        raise AssertionError(f"(d) stage 3 on the card: {res}")
    return res, res["launches"]


def drive_dryrun(torch, train, kernels, report):
    """Phase 19 (the module docstring): (a)-(c) in a one-rank NCCL group
    this function starts and tears down. Returns (report, launches by
    path)."""
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.ops import attention
    from container_engine_accelerators_tpu_torch.parallel import (
        distributed,
        dryrun,
    )
    t0 = time.perf_counter()
    distributed.start_local_group("cuda:0")
    try:
        one_chip = dryrun_one_chip(torch, dryrun, kernels)
        combined, combined_launches = combined_step(torch, train, dryrun,
                                                    kernels, report)
        stage2, stage2_launches = dryrun_stage2_on_card(torch, dryrun,
                                                        kernels)
        stage3, stage3_launches = dryrun_stage3_on_card(torch, attention,
                                                        dryrun, kernels)
    finally:
        dist.destroy_process_group()
    out = dict(one_chip=one_chip, combined=combined, stage2=stage2,
               stage3=stage3, phase_s=time.perf_counter() - t0)
    log(f"combined step: {combined['step_ms_mean']:.2f} ms a step, "
        f"{combined['tokens_per_s']:.0f} tokens/s, peak memory "
        f"{combined['peak_memory_gb']:.2f} GB on {smi_line()}")
    log(f"dryrun phase: {out['phase_s']:.1f} s")
    return out, {"combined_moe": combined_launches,
                 "dryrun_stage2": stage2_launches,
                 "dryrun_stage3": stage3_launches}


# ---------------------------------------------------------------------
# Phase 20: head dim 256 at full width (GPT-J-6B's attention: n_embd
# 4096 over 16 heads; rotary positions; vocab cut to the slice's 32000)
# through the port's driver and launcher. Depth cut from 28 layers to 4.
# ---------------------------------------------------------------------
D256 = dict(vocab_size=32000, embed_dim=4096, num_layers=4, num_heads=16,
            num_kv_heads=16, pos_embedding="rope", max_seq_len=2048)
D256_BATCH = 4
D256_STEPS = 3
D256_WARMUP = 1
D256_PROMPT = 24
D256_NEW = 16
PATH_KERNELS.update({
    "d256_training": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                      "xent_fwd", "xent_bwd"),
    "d256_serving": ("flash_fwd",),
})


def d256_flags():
    """D256's widths as flags of both the driver and the launcher."""
    return ["--vocab-size", str(D256["vocab_size"]),
            "--embed-dim", str(D256["embed_dim"]),
            "--num-layers", str(D256["num_layers"]),
            "--num-heads", str(D256["num_heads"]),
            "--num-kv-heads", str(D256["num_kv_heads"]),
            "--pos-embedding", D256["pos_embedding"]]


def d256_training(torch, attn, convert, train, kernels):
    """20a-b: D256_STEPS steps of D256 at S 2048, batch D256_BATCH,
    through ``train.run`` (``drive``: 4/4/4/1/1 launches a step, a
    finite loss that falls; step time, tokens/s, peak memory), then
    the batch-2 kernel step against the plain step at phase 7's
    limits (``check_plain_step``)."""
    per_step = (D256["num_layers"],) * 3 + (1, 1)
    hopper0 = [kern.hopper_launches for kern in attn.KERNELS]
    summary, launches, trainer, state = drive(
        torch, train, kernels,
        train_argv(D256_STEPS, D256_WARMUP, D256_BATCH) + d256_flags(),
        per_step, D256_WARMUP)
    del trainer, state
    losses, result = summary["losses"], summary["driver_result"]
    summary["tokens_per_s"] = result["tokens_per_sec"]
    # Every forward, dQ and dK/dV launch of the steps ran the Hopper
    # kernels.
    summary["hopper_launches"] = {
        kern.name: kern.hopper_launches - n
        for kern, n in zip(attn.KERNELS, hopper0)}
    log("D 256 training:", json.dumps(summary))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"(a) D 256 loss did not fall: {losses}")
    if summary["hopper_launches"] != {k.name: launches[k.name]
                                      for k in attn.KERNELS}:
        raise AssertionError(f"(a) D 256 flash off the Hopper kernels: "
                             f"{summary['hopper_launches']} of {launches}")
    torch.cuda.empty_cache()
    plain = check_plain_step(torch, attn, convert, train, extra=d256_flags())
    return summary, plain, launches


def d256_serving(torch, attn, kernels, rng):
    """20c: the launcher on the dense pool at D256's widths serves one
    greedy prompt: D256["num_layers"] flash_fwd launches for its one
    admission, all on the Hopper kernel, nothing else, and the stream
    under the near-tie rule against greedy_decode
    (``stream_divergence``)."""
    from container_engine_accelerators_tpu_torch.serving import serve
    argv = (["--model", "transformer", "--model-name", "lm"] + d256_flags()
            + ["--max-seq-len", str(D256["max_seq_len"]),
               "--max-new-tokens", str(D256_NEW), "--max-batch", "2",
               "--seed", str(SEED), "--port=0"])
    server, launch = launch_deployed(serve, paged=False, argv=argv)
    engine = server.engine
    try:
        if engine.paged:
            raise AssertionError("CEA_TPU_PAGED_KV=0 built a paged engine")
        prompt = rng.integers(0, D256["vocab_size"], D256_PROMPT).tolist()
        prefills0 = engine.prefills
        for kern in kernels:
            kern.launches = 0
        hopper0 = attn.flash_fwd.hopper_launches
        status, body = post(server.port, {"prompts": [prompt],
                                          "max_new_tokens": D256_NEW})
        launches = {kern.name: kern.launches for kern in kernels}
        hopper = attn.flash_fwd.hopper_launches - hopper0
        admissions = engine.prefills - prefills0
    finally:
        server.stop()
    seq = body["sequences"][0] if status == 200 else None
    diverged = (stream_divergence(torch, engine._model, prompt, D256_NEW,
                                  seq) if seq else None)
    out = dict(argv=argv, launch=launch, status=status,
               admissions=admissions, launches=launches,
               hopper_launches=hopper,
               new_tokens=len(seq) - len(prompt) if seq else 0,
               diverged=diverged)
    log("D 256 serving:", json.dumps(out))
    if (status != 200 or admissions != 1
            or launches["flash_fwd"] != D256["num_layers"] * admissions
            or hopper != launches["flash_fwd"]
            or any(n for k, n in launches.items() if k != "flash_fwd")
            or out["new_tokens"] != D256_NEW
            or (diverged is not None and not diverged["near_tie"])):
        raise AssertionError(f"(c) D 256 serving: {out}")
    del server, engine
    torch.cuda.empty_cache()
    return out, launches


def drive_d256(torch, attn, convert, train, kernels, rng):
    """Phase 20 (the module docstring). Returns (report, launches by
    path)."""
    t0 = time.perf_counter()
    summary, plain, train_launches = d256_training(torch, attn, convert,
                                                   train, kernels)
    serving, serve_launches = d256_serving(torch, attn, kernels, rng)
    out = dict(config=D256, batch=D256_BATCH, seq=TRAIN_SEQ,
               cut="28 layers to 4", train=summary, plain_step=plain,
               serving=serving, phase_s=time.perf_counter() - t0)
    log(f"D 256 phase: {summary['step_ms_mean']:.2f} ms a step, "
        f"{summary['tokens_per_s']:.0f} tokens/s, peak memory "
        f"{summary['peak_memory_gb']:.2f} GB; {out['phase_s']:.1f} s on "
        f"{smi_line()}")
    return out, {"d256_training": train_launches,
                 "d256_serving": serve_launches}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO_ROOT)
    import numpy as np

    from container_engine_accelerators_tpu_torch.models.convert import (
        init_flax_layout_params,
        load_lm,
    )
    from container_engine_accelerators_tpu_torch.models.decode import (
        greedy_decode,
    )
    from container_engine_accelerators_tpu_torch import train
    from container_engine_accelerators_tpu_torch.models import convert
    from container_engine_accelerators_tpu_torch.ops import _build
    from container_engine_accelerators_tpu_torch.ops import attention
    from container_engine_accelerators_tpu_torch.ops import xent
    from container_engine_accelerators_tpu_torch.serving.server import (
        GenerationServer,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    log(f"device: {kind} count={count} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    report = {"device": {"kind": kind, "count": count, "smi": smi,
                         "torch": torch.__version__,
                         "cuda": torch.version.cuda}}

    # Phase 2: build.
    t0 = time.perf_counter()
    compiler = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {sorted(compiler)} in {report['build_s']:.2f} s")
    report["ptxas"] = ptxas_report(compiler)

    # Phases 3 and 4: each kernel against its plain version, then times.
    report["tensor_core_instructions"] = tensor_core_counts(_build)
    report["flash_checks"] = check_flash(torch, attention)
    report["flash_bwd_checks"] = check_backward(torch, attention)
    report["bitwise_repeat"] = check_repeat(torch, attention)
    report["long_sequence"] = check_long_sequence(torch, attention)
    report["xent_checks"] = check_xent(torch, xent)
    widths = [16, 128, 1024, 1920]
    report["flash_times"] = time_flash(torch, attention, widths)
    # The demo draft's head dim (E 128, 8 heads) at the largest bucket.
    report["draft_flash_times"] = time_flash(
        torch, attention, [1920],
        d=SPEC_DRAFT["embed_dim"] // MODEL["num_heads"])
    report["train_kernel_times"] = time_training_kernels(torch, attention,
                                                         xent)
    report["wide_kernel_times"] = time_flash_kernels(
        torch, attention, 0, torch.Generator(device="cuda").manual_seed(
            SEED + 7), WIDE_SHAPE)
    for name, row in report["wide_kernel_times"].items():
        log("wide kernel time", name, json.dumps(row))
    report["recorded_ratios"] = recorded_ratios(report)
    log(f"D <= 128 times over PERF.md's recorded ones: "
        f"{json.dumps(report['recorded_ratios'])} on {smi}")
    report["image_kernel_times"] = time_image_xent(torch, xent)

    # Phase 5: the server at full width.
    tree = init_flax_layout_params(MODEL, SEED)
    model = load_lm(MODEL, tree, device="cuda")
    # The dense pool, whose admission prefill runs the flash kernel; the
    # server's default, the paged pool, is the paged phase's.
    os.environ["CEA_TPU_PAGED_KV"] = "0"
    try:
        server = GenerationServer("lm", model, port=0,
                                  max_new_tokens=MAX_NEW,
                                  max_batch=MAX_BATCH, host="127.0.0.1")
    finally:
        del os.environ["CEA_TPU_PAGED_KV"]
    if server.engine.paged:
        raise AssertionError("CEA_TPU_PAGED_KV=0 built a paged engine")
    server.start()
    try:
        if get(server.port, "/healthz")["status"] != "ok":
            raise AssertionError("healthz not ok")
        rng = np.random.default_rng(SEED)
        prefills0 = server.engine.prefills
        for kern in attention.KERNELS + xent.KERNELS:
            kern.launches = 0
        greedy, summary = drive_server(server, rng)
        launches = attention.flash_fwd.launches
        others = {k.name: k.launches for k in attention.KERNELS[1:]
                  + xent.KERNELS if k.launches}
        stats = get(server.port, "/stats")
        admissions = server.engine.prefills - prefills0
    finally:
        server.stop()
    report["server"] = dict(summary, stats=stats, admissions=admissions,
                            launches=launches)
    log("server:", json.dumps(report["server"]))
    if launches != MODEL["num_layers"] * admissions or launches == 0:
        raise AssertionError(
            f"flash_fwd launched {launches} times for {admissions} "
            f"admissions of a {MODEL['num_layers']}-layer model")
    if stats["flash_fwd_launches"] != launches:
        raise AssertionError("/stats flash_fwd_launches disagrees")
    if others:
        raise AssertionError(f"serving launched training kernels: {others}")

    # Every greedy response against the single-request oracle.
    mismatches = []
    for p, new, seq in greedy:
        want = greedy_decode(model, torch.tensor([p]), new)[0].tolist()
        if want != seq:
            first = next(i for i, (a, b) in enumerate(zip(want, seq))
                         if a != b)
            mismatches.append(dict(prompt_len=len(p), new=new,
                                   first_diff=first - len(p)))
    report["greedy_checked"] = len(greedy)
    report["greedy_mismatches"] = mismatches
    log(f"greedy: {len(greedy)} responses vs greedy_decode, "
        f"mismatches {mismatches}")
    if mismatches:
        raise AssertionError(f"greedy responses differ: {mismatches}")

    # Phase 6: where an admission's and a step's time goes (engine
    # alone, after the server has stopped; informational).
    report["engine_times"] = time_engine(torch, server.engine, rng)
    log("engine times:", json.dumps(report["engine_times"]))

    # The paged phase: the server's default pool.
    all_kernels = attention.KERNELS + xent.KERNELS
    report["paged"], paged_launches = drive_paged(
        torch, model, server.engine, all_kernels, rng)

    # The deployment phase: lm-serving.yaml's command line.
    report["deployed"], deployed_launches = drive_deployment(
        torch, all_kernels, model, server.engine, rng)
    del server
    torch.cuda.empty_cache()

    # Phase 7: training at full width.
    report["train"], train_launches = drive_training(torch, train,
                                                     all_kernels)
    report["train_plain_step"] = check_plain_step(torch, attention,
                                                  convert, train)

    # Phase 8: image classification; ResNet-50 is this slice's main path.
    report["resnet"], resnet_launches = drive_resnet(torch, train,
                                                     all_kernels)
    report["resnet_plain_step"] = check_image_plain_step(torch, train)
    small, small_launches = drive_small_images(torch, train, all_kernels)
    report.update(small)

    # Phase 9: the sliding window at full width.
    report["window"], window_launches = drive_window(
        torch, attention, convert, train, all_kernels, rng)

    # Phase 10: speculation at full width.
    report["spec"], spec_launches = drive_spec(torch, convert, all_kernels,
                                               rng)

    # Phase 11: the serving contract; phase 12's engines warm up
    # meanwhile in their own processes.
    fleet_engines = start_fleet_engines()
    try:
        report["contract"], contract_launches = drive_contract(
            torch, convert, model, all_kernels)
        # Phase 12: the fleet front door.
        report["fleet"], fleet_launches = drive_fleet(
            torch, model, fleet_engines, {})
    finally:
        for proc, _, _ in fleet_engines.values():
            stop_process(proc)

    # Phase 13: the MoE family.
    report["moe"], moe_launches = drive_moe(torch, train, attention,
                                            convert, all_kernels, rng)

    # Phase 14: real data, checkpoints and trained weights.
    report["checkpoints"], ckpt_launches = drive_checkpoints(
        torch, train, convert, all_kernels, rng, report)

    # Phase 15: the tooling adapters.
    report["tooling"], tool_launches = drive_tooling(
        torch, train, model, all_kernels, rng)

    # Phase 16: the process group, the mesh and the program guard.
    report["group"], group_launches = drive_group(
        torch, train, model, all_kernels, rng, report)

    # Phase 17: tensor-parallel serving, context and expert parallelism.
    report["parallel"], parallel_launches = drive_parallel(
        torch, train, attention, all_kernels, rng, report)

    # Phase 18: pipeline parallelism and elastic recovery.
    report["pipeline"], pipeline_launches = drive_pipeline(
        torch, train, all_kernels)

    # Phase 19: the multichip dryrun and the combined MoE step.
    report["dryrun"], dryrun_launches = drive_dryrun(
        torch, train, all_kernels, report)

    # Phase 20: head dim 256 through the driver and the launcher.
    report["d256"], d256_launches = drive_d256(
        torch, attention, convert, train, all_kernels, rng)

    big = report["flash_times"][-1]
    tk = report["train_kernel_times"]
    ik = report["image_kernel_times"]
    src = "container_engine_accelerators_tpu_torch/ops/csrc/"
    ref = "container_engine_accelerators_tpu/ops/"
    checks = {
        "flash_fwd": max(c["err_o"] for c in report["flash_checks"]),
        "flash_bwd_dq": max(c["err_dq"] for c in
                            report["flash_bwd_checks"]),
        "flash_bwd_dkv": max(max(c["err_dk"], c["err_dv"]) for c in
                             report["flash_bwd_checks"]),
        "xent_fwd": max(c["err_loss"] for c in report["xent_checks"]),
        "xent_bwd": max(c["err_dlogits"] for c in report["xent_checks"]),
    }
    replaces = {
        "flash_fwd": "attention.py:136 (_fwd_kernel) and :237 "
                     "(_fwd_kernel_stream)",
        "flash_bwd_dq": "attention.py:167 (_dq_kernel) and :275 "
                        "(_dq_kernel_stream)",
        "flash_bwd_dkv": "attention.py:191 (_dkv_kernel) and :307 "
                         "(_dkv_kernel_stream)",
        "xent_fwd": "xent.py:42 (_fwd_kernel)",
        "xent_bwd": "xent.py:54 (_bwd_kernel)",
    }
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    kernels = []
    for kern in all_kernels:
        name = kern.name
        # flash_fwd's fields hold its time at the serving prefill's
        # largest bucket (S 1920), their meaning since the kernel was
        # ported; its time at the training shape goes under train_*.
        # The other kernels run on the training path alone.
        row = big if name == "flash_fwd" else tk[name]
        by_path = {"training": train_launches[name],
                   "resnet_training": resnet_launches[name],
                   "mnist_training": small_launches["mnist"][name],
                   "inception_training": small_launches["inception"][name]}
        if name == "flash_fwd":
            by_path["serving"] = launches
        by_path["paged_serving"] = paged_launches[name]
        by_path["deployed_serving"] = deployed_launches[name]
        for path, counts in window_launches.items():
            by_path[path] = counts[name]
        for path, counts in spec_launches.items():
            by_path[path] = counts[name]
        for path, counts in contract_launches.items():
            by_path[path] = counts[name]
        for path, counts in fleet_launches.items():
            by_path[path] = counts.get(name, 0)
        for path, counts in moe_launches.items():
            by_path[path] = counts[name]
        for path, counts in ckpt_launches.items():
            by_path[path] = counts[name]
        for path, counts in tool_launches.items():
            by_path[path] = counts[name]
        for path, counts in group_launches.items():
            by_path[path] = counts[name]
        for path, counts in parallel_launches.items():
            by_path[path] = counts[name]
        for path, counts in pipeline_launches.items():
            by_path[path] = counts[name]
        for path, counts in dryrun_launches.items():
            by_path[path] = counts[name]
        for path, counts in d256_launches.items():
            by_path[path] = counts[name]
        entry = {
            "name": name, "route": "cuda",
            "source": f"{src}{kern.library}.cu",
            "replaces": f"{ref}{replaces[name]}",
            "launches": sum(by_path.values()),
            "max_abs_err": checks[name],
        }
        entry.update({key: row["kernel_ms" if key == "ms" else key]
                      for key in timed})
        entry["launches_by_path"] = by_path
        if name == "flash_fwd":
            entry.update({f"train_{key}": tk[name][
                "kernel_ms" if key == "ms" else key] for key in timed})
        dk = report["wide_kernel_times"]
        if name in dk:
            # The flash kernels at head dim 256 (WIDE_SHAPE).
            entry.update({f"wide_{key}": dk[name][
                "kernel_ms" if key == "ms" else key] for key in timed})
        wk = report["window"]["kernel_times"]
        if name in wk:
            # The flash kernels at the training shape with the W 512 band.
            entry.update({f"window_{key}": wk[name][
                "kernel_ms" if key == "ms" else key] for key in timed})
        if name in ik:
            # The cross-entropy at ResNet-50's logits, [128, 1000].
            entry.update({f"image_{key}": ik[name][
                "kernel_ms" if key == "ms" else key] for key in timed})
        kernels.append(entry)
    report["kernels"] = kernels
    idle = [(path, entry["name"]) for entry in kernels
            for path, names in PATH_KERNELS.items()
            if entry["name"] in names
            and not entry["launches_by_path"].get(path)]
    if idle:
        raise AssertionError(f"kernels a path never launched: {idle}")
    report["wall_s"] = time.perf_counter() - t_start
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    ckpt_spec = report["checkpoints"]["lm"]["speculative"]
    log(f"informational on {kind} ({smi}): concurrent "
        f"{summary['concurrent_tokens_per_s']:.1f} tokens/s, time to "
        f"first token {summary['ttft_ms']} ms (16-token prompt); "
        f"training {report['train']['tokens_per_s']:.0f} tokens/s, "
        f"{report['train']['step_ms_mean']:.2f} ms a step; ResNet-50 "
        f"batch {RESNET_BATCH}: {report['resnet']['images_per_s']:.1f} "
        f"images/s, {report['resnet']['step_ms_mean']:.2f} ms a step; "
        f"paged: {json.dumps(report['paged']['times'])}; window step "
        f"{json.dumps(report['window']['step_ms'])} ms, windowed training "
        f"{report['window']['train']['step_ms_mean']:.2f} ms a step; "
        f"speculation phase {report['spec']['phase_s']:.1f} s; ResNet-50 "
        f"predict p50 {report['contract']['predict']['p50_ms_1']:.1f} ms "
        f"(1 image), {report['contract']['predict']['p50_ms_8']:.1f} ms "
        f"(8); serving contract phase "
        f"{report['contract']['phase_s']:.1f} s; fleet phase "
        f"{report['fleet']['phase_s']:.1f} s, router overhead "
        f"{report['fleet']['router_overhead_ms']} ms a request; MoE "
        f"training {report['moe']['train']['tokens_per_s']:.0f} tokens/s, "
        f"{report['moe']['train']['step_ms_mean']:.2f} ms a step, MoE "
        f"phase {report['moe']['phase_s']:.1f} s; ResNet-50 from .npz "
        f"shards {report['checkpoints']['c']['images_per_s']:.1f} images/s "
        f"(synthetic {report['resnet']['images_per_s']:.1f}), loader wait "
        f"{report['checkpoints']['c']['data_wait_ms_mean']:.2f} ms a step, "
        f"save blocking {report['checkpoints']['c']['checkpoint_block_s']} "
        f"s; trained draft acceptance "
        f"{ckpt_spec['acceptance']} (random "
        f"{ckpt_spec['random_draft_acceptance']}); checkpoint phase "
        f"{report['checkpoints']['phase_s']:.1f} s; one-rank NCCL group "
        f"LM {report['group']['lm_fsdp']['step_ms_mean']:.2f} ms a step "
        f"(--fsdp), ResNet-50 "
        f"{report['group']['resnet']['images_per_s']:.1f} images/s; "
        f"process-group phase {report['group']['phase_s']:.1f} s; "
        f"long-context ring training "
        f"{report['parallel']['long_context']['tokens_per_s']:.0f} "
        f"tokens/s; parallel phase {report['parallel']['phase_s']:.1f} "
        f"s; pipeline training "
        f"{report['pipeline']['group']['tokens_per_s']:.0f} tokens/s, "
        f"{report['pipeline']['group']['step_ms_mean']:.1f} ms a step; "
        f"pipeline phase {report['pipeline']['phase_s']:.1f} s; combined "
        f"(data, context, expert) MoE step "
        f"{report['dryrun']['combined']['step_ms_mean']:.2f} ms, dryrun "
        f"phase {report['dryrun']['phase_s']:.1f} s; D 256 training "
        f"{report['d256']['train']['step_ms_mean']:.2f} ms a step, D 256 "
        f"phase {report['d256']['phase_s']:.1f} s; whole run "
        f"{report['wall_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
