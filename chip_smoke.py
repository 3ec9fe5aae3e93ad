#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises, so the script exits non-zero
and never prints the final line:

  1. banner   torch/CUDA versions, the card and its power limit, the
              process-group backends this torch has; TF32 off.
  2. build    nvcc builds the ten kernel libraries from src/repro_torch/
              kernels/csrc (one process per source, in parallel) into
              build/repro_torch/; -Xptxas -v's registers and spills, each
              after its function's mangled name (the template's D).
  3. kernels  each kernel against its plain version on the card at the main
              paths' shapes and at edge cases: the embedding kernels bit for
              bit (torch.equal of the raw bits; embed_gather on the route
              ops.gather_route gives each case — the bulk kernel at
              parallax-lm's table and at phi3-medium-14b's and rwkv6-7b's,
              with the ids of a 2,048-token prefill and of a 4-slot decode
              step; the element kernel at E = 100 bf16 and at tables off a
              16-byte boundary — and the one-pass embed_scatter_add at the
              main shapes, a shard owning none of the ids (M = 8), one
              owning half (M = 2), ids out of order, -0.0 rows, Vs below
              one block and E = 100), the gather timed beside its element
              kernel and the scatter beside PR 11's zero fill + dump-row
              kernel and the library's zeros + index_copy_, an empty
              kernel's launch floor under the same timer,
              flash_attention within 2e-5 at f32 and 2e-2 at bf16 on the
              route ops.flash_route gives each case (phi3's prefill whole
              and at a (1, 2) rank's 20 heads; bf16 at D 64/128/160:
              the tensor-core kernel, also at Sq 96/Sk 160 and 160/96
              causal, B 4 with Sq 200, an 8-row q tile and strided views;
              f32 and D 16/32: the scalar kernel; stablelm-12b's D 160 at
              its 2,048-token prefill in bf16 and f32, the buckets
              256/512/1,024, Sq != Sk both ways and a strided view),
              timed at the engine's prefill buckets 256..2,048 beside
              SDPA (phi3's D 128 and stablelm's D 160), wkv
              within 1e-4 at f32 and 5e-2 at bf16 of both its plain
              versions (chunked and sequential) on the route
              ops.wkv_route gives each case (bf16 with E 64 and S > 1:
              the tensor-core kernel; S = 1: the step kernel; else the
              scalar one) at rwkv6-7b's prefill (f32 and bf16 lw) and
              decode shapes and at a (1, 2) rank's 32 heads of them (also
              as a head-sliced view of 64), the reference's sweep, chunk
              1/16/20/48/64, ragged S 2,047 and 100, a strided view, the
              step route at B 1 and 4, a tc prefill continued by 8 step
              tokens, chunk 16 against 48, and clamped cases (chunk *
              |lw| > 80, held against the chunked version only); a
              misaligned view must raise on the tc route. Tolerances are
              absolute and relative, the reference's own bars; the
              difference is summation order.
              Kernel, plain and library-call times (CUDA events, median of
              50 runs, L2 flushed before each) beside the bound.
  4. parity   reduced parallax-lm at f32, the same parameters and batches,
              3 steps on the CPU and on the card, with the default RunConfig
              and with local_agg=False: losses within rtol 1e-4 (GEMM and
              index_add_ summation order differ on the card, and without
              local aggregation index_add_ adds repeated ids with atomics),
              the embed_* census metrics equal, the no-LA push through the
              plain scatter (no kernel launch). Then reduced parallax-nmt
              at f32 the same way: losses within rtol 1e-4, both tables'
              embed_* / enc_embed_* census equal, 2 gathers and 2 one-pass
              scatters a step.
  5. serve_parity  reduced phi3-medium-14b at f32, attention "pallas": the
              same parameters and prompts through Server(device="cpu") and
              Server(device="cuda"): prefill logits within rtol 1e-4, greedy
              tokens equal (at most 2 may differ, the reference's own
              allowance for argmax near-ties; any difference is printed).
     dense_parity  reduced phi3-medium-14b and reduced command-r-35b
              (tied embeddings) at f32, 3 steps on the CPU and on the card
              from the same parameters under naive and chunked attention:
              losses within rtol 1e-4, the embed_* census equal, a bulk
              gather and a one-pass scatter a step; then reduced phi3 at
              the default bf16 under remat none, block and full on the
              card (deterministic algorithms): equal losses.
  6. rwkv_parity  reduced rwkv6-7b at f32, the same parameters on the CPU
              and on the card: make_prefill_step logits and final carry
              within rtol 1e-4 (and 1e-4 of the max-abs scale), ToyServer
              greedy tokens equal (at most 2 may differ).
  7. rwkv_recurrence  rwkv6-7b at full width with n_layers cut to 2, f32,
              one 300-token prompt (9 chunks and a ragged 12): the chunked
              make_prefill_step and 300 one-token make_decode_step calls
              give the same last logits and every layer's carry within 1e-4
              of their max-abs scale.
  8. main     full-width parallax-lm, ShapeConfig("lm1b", 20, 128) and the
              default RunConfig (bf16): get_runner(..., device="cuda"), 10
              steps of SyntheticLM batches. Every loss finite, the last below
              the first, each embedding kernel launched exactly once per
              step, the gather on the bulk route and the scatter on the
              one-pass kernel. Then main_no_la: 3 such steps under
              RunConfig(local_agg=False), their pushes through the plain
              scatter (no embed_scatter_add launch), step ms and losses.
     nmt      full-width parallax-nmt (4 + 4 LSTM layers of 1,024, d 1,024,
              vocab 36,548; nothing cut), bf16, seed 0, ShapeConfig("wmt",
              50, 128) (GNMT's batch 128 and length 50), the reference's
              two-table knobs (capped capacity x 1.5, link latency 0,
              embed declared Zipf 1.3, enc_embed alpha 0.99), 10 steps of
              SyntheticLM(is_encdec=True, src_zipf_a=0.0) batches: losses
              finite and falling, no row dropped (one device: the knobs
              change no math), both tables pulled on the bulk route and
              pushed one-pass every step (2 + 2 launches a step); median
              step ms, tokens/s, peak memory.
     train    full-width parallax-lm through the launcher,
              launch.train.main(TRAIN_ARGS): 12 steps of Zipf(1.3) batches,
              capped x 1.5 from the uniform estimate (capacity 2,560), a
              replan every 4 steps. A replan fires and the capacity shrinks
              to 1.5 x the observed unique count; 12 bulk gathers and 12
              one-pass scatters, no row dropped; the losses equal a
              static-plan run's of the same batches bit for bit
              (deterministic algorithms); both kernels held bitwise
              against their plain versions at the replanned capacity.
              Step ms, the trainer's tokens/s, rebuild ms, peak memory;
              then TRAIN_ARGS once more with deterministic algorithms off
              (the launcher's own setting; not counted): its step median
              beside main's of the same call.
     train_growth  full-width parallax-lm through Trainer: the planner
              assumes Zipf(1.3) at capacity factor 1.0, the first 4 of 10
              batches draw uniform ids; replan every 4 steps, drift 50.
              The burst overflows, the monitor shows the overflow, the
              replan grows embed's capacity and marks it grown, no row
              drops after; the launches at each capacity.
     train_resume  full-width parallax-nmt (the nmt cell) through Trainer:
              6 steps with a checkpoint every 3 under build/; a fresh
              trainer restores step 3 and trains to 6: steps 4-6 and every
              parameter and moment at step 6 equal the uninterrupted
              run's bit for bit (deterministic algorithms). The
              checkpoint's bytes, snapshot / write / restore seconds, the
              disk it used; the directory is removed.
     dense_train  phi3-medium-14b at its published width with n_layers
              cut to 8 of 40 (40 layers' params, grads and AdamW moments
              are ~176 GB), RunConfig() (bf16, AdamW at 1e-3, hybrid, remat
              block, chunked attention), ShapeConfig("train", 512, 8),
              12 steps of Zipf(1.3) batches through runtime/trainer.py's
              Trainer: losses finite and falling, one bulk gather and one
              one-pass scatter a step; step median, tokens/s, TFLOP/s and
              the share of the bf16 peak, peak memory. Both embed kernels
              are also held bit for bit and timed at this path's shapes in
              kernels (phi3's (100,352, 5,120) bf16 table, the first
              batch's 4,096-slot buffer and 4,096 owned ids).
     Then the mesh path (launch/mesh.py ranks, spawned processes):
     mesh_one_rank: the same 3 first steps through get_runner(...,
              mesh=make_mesh((1, 1))) over a one-rank NCCL group: the plan
              (mpi_gatherv), losses equal to main's bit for bit, step ms,
              peak memory, launches (3 bulk gathers, the push through the
              plain scatter). mesh_card: 4 ranks on the one card over gloo
              (NCCL takes one card per rank; gloo stages what it has no
              CUDA path for through the host, so no time here is a
              multi-GPU exchange time): (a) reduced parallax-lm at f32 on a
              (2, 2) mesh, 3 steps under the six flag sets of the
              reference's correctness test (hybrid, ps, mpi, no LA, no
              OPAU, no OPSW), losses within 5e-4 + 1e-4 i of the one-device
              card run on the same batches and the embed_* census the plan
              implies; (b) full-width parallax-lm, bf16, RunConfig(
              comm_mode="ps") on (1, 4): each rank holds 200,000 table rows,
              pulls at row_offset m * 200,000 on the bulk route and pushes
              through the one-pass scatter, 3 each in 3 steps; losses
              within rel 1e-2 of main's; per-rank step ms and peak memory;
              (c) full-width parallax-nmt as in nmt on (4, 1): the plan
              (embed on mpi_gatherv, enc_embed on the dense all-reduce,
              its buckets, fused_apply stamped), 3 steps with the fused
              bucket-apply and 3 with fused_apply=False from the same
              seed, deterministic algorithms on: losses and rank 0's
              parameters equal bit for bit, losses within rel 1e-2 of
              nmt's first 3; per-rank step ms and peak memory, the
              optimizer apply alone fused and per-param (CUDA events on
              rank 0, the other ranks at a barrier), launches per rank (2
              bulk gathers and the enc_embed one-pass push a step; the
              gatherv push of embed takes the plain scatter); (d) the
              launcher's mesh path: launch.train.main(LAUNCH_MESH_ARGS),
              reduced parallax-lm on (4, 1) in 4 ranks of its own spawn, a
              replan every 4 steps that flips embed from the bucketed
              dense all-reduce to mpi_gatherv, against the static plan's
              run: losses within 5e-4 + 1e-4 i; each run's seconds; each
              rank's launches (path mesh_launcher): a bulk gather every
              step, a one-pass push every step on the all-reduce (the
              gatherv push takes the plain scatter); (e) mesh_card_dense:
              reduced phi3 under hybrid, ps and mpi and reduced command-r
              under hybrid and mpi at f32 on (2, 2), 3 steps each, within
              5e-4 + 1e-4 i of the one-device card run from the same
              seed-0 init. replan_replay: repro_torch.benchmarks.
              adaptive_replan's two phases (reduced phi3 at vocab 256,
              static against a replan after step 4; reduced parallax-nmt's
              two tables through a burst), each on 8 gloo ranks on the
              card, with the replay's own checks (the replan fired and
              flipped ps -> ps_gather, divergence < 5e-3, the tables on
              different methods and capacities, the capacity grew).
  9. serve    full-width phi3-medium-14b (40 layers, nothing cut), bf16,
              Server(..., RunConfig(attention_impl="pallas"),
              ServerConfig(max_batch=4, max_seq=2048)) on the card: 8
              requests with prompts of 200..1800 tokens, 16 new tokens each.
              All complete, no cross-slot mismatch, flash_attention launched
              40 times per prefill, every launch on the tensor-core route,
              embed_gather once per prefill and per decode step, all on the
              bulk route. TTFT, inter-token gaps and decode tokens/s over
              the run's window,
              prefill ms per bucket, one synthetic decode step (lens 1024),
              peak memory, clocks and power; each request's prompt and
              tokens through one cache-less prefill (the greedy token at
              every generated position against the decode loop's: the
              near-ties mesh_card_serve is held to).
 10. rwkv_serve  full-width rwkv6-7b (32 layers, nothing cut), bf16,
              ToyServer(..., ServerConfig(max_batch=4, max_seq=2048)) on
              the card: 8 requests with prompts of 16..64 tokens (an
              unsourced smoke mix), 16 new tokens each, greedy. All
              complete; wkv launched n_layers times per device step (decode
              steps plus the teacher-forced prompt steps), every one on the
              step route, embed_gather once per device step (and once in
              the prefill below), all on the bulk route. TTFT, inter-token
              gaps and tokens/s over the run's window, one
              decode step over 4 slots, one 2,048-token make_prefill_step
              (its ms; 32 wkv launches, all on the tensor-core route), peak
              memory.
 11. stablelm_parity  stablelm-12b at its published width with n_layers
              cut to 2, f32, attention "pallas": one 256-token prompt
              through Server on the CPU and on the card; prefill logits
              within rtol 1e-4, at most 2 of 8 greedy tokens different,
              flash launched once a layer per prefill on the scalar route
              (D 160). stablelm_serve: serve's run on full-width
              stablelm-12b (40 layers, d 5,120, 32 q / 8 KV heads of 160,
              nothing cut): every prefill's 40 flash launches on the
              tensor-core route at D 160.
 12. families_parity  reduced seamless-m4t-medium, hymba-1.5b,
              chameleon-34b and rwkv6-7b at f32: 3 training steps on the
              CPU and on the card from the same parameters (losses within
              rtol 1e-4, embed_* census equal, no flash or wkv launch in
              training); seamless and hymba also prefill and decode 4
              tokens with attention "pallas" (logits within rtol 1e-4;
              seamless's encoder and cross attention through flash,
              non-causal, Sq != Sk). Then the families' training through
              Trainer, dense_train's recipe (RunConfig(), ShapeConfig(
              "train", 512, 8), 12 steps of Zipf(1.3) batches), each at its
              cell in profile_step.CELLS (chameleon's AdamW at 1e-5): seamless_train (seamless-m4t-
              medium whole: 12 + 12 layers, d 1,024, vocab 256,206, 128
              stub frames a row), hymba_train (hymba-1.5b whole: 32
              layers, d 1,600, 25 q / 5 KV heads of 64, SSM state 16),
              chameleon_train (chameleon-34b at 4 of 48 layers) and
              rwkv_train (rwkv6-7b at 8 of 32; the WKV through the chunked
              form under autograd): losses finite and falling, peak under
              72 GB, a bulk gather and a one-pass scatter a step, step ms,
              tokens/s, TFLOP/s from counted operations and the share of
              the bf16 peak. mesh_card_encdec = mesh_card (f): reduced
              seamless at f32 on (2, 2) over 4 gloo ranks on the card,
              default flags and comm_mode mpi, within 5e-4 + 1e-4 i of the
              one-device card run.
 13. moe_parity  reduced grok-1-314b (4 experts, top-2) and
              llama4-maverick-400b-a17b (4 experts, top-1, the shared
              expert) at f32: 3 training steps on the CPU and on the card
              from the same parameters (losses within rtol 1e-4,
              moe_dropped and the embed_* census equal, no flash launch in
              training), then each through Server with attention "pallas":
              a 40-token prompt's bucket-padded prefill logits within 1e-4
              of their scale (its pad tokens routed too), at most 2 of 8
              greedy tokens different; flash on the scalar route (f32).
     grok_serve, llama4_serve  serve's run (8 requests of 200..1,800
              tokens, 16 new each, bf16, ServerConfig(max_batch=4,
              max_seq=2048), attention "pallas") at the published widths
              cut to profile_serve.SERVE_LAYERS: grok-1-314b at 4 of 64
              layers (d 6,144, 48 q / 8 KV heads of 128, 8 experts of d_ff
              32,768 top-2, vocab 131,072; 21,290,539,008 parameters,
              42.6 GB), llama4-maverick-400b-a17b at 1 of 48 (d 5,120, 40 /
              8 heads of 128, 128 experts of d_ff 8,192 top-1 and the
              shared expert, vocab 202,048; 36.7 GB). Every flash launch on
              the tc route; moe_dropped of one 2,048-token prefill; the
              decode step beside its byte floor (every weight but the
              embedding read once: the dispatch computes every expert at a
              capacity of at least 4); peak at init and serving under 72 GB.
     mesh_card_moe = mesh_card (g): reduced grok-1 (capacity factor 8,
              SGD at 0.3, f32) on (2, 2) over 4 gloo ranks on the card: the
              default moe_exec (ep: each rank's w_gate holds 2 of the 4
              experts, the tokens moved by all_to_all, staged through the
              host) under hybrid and mpi within 5e-4 + 1e-4 i of the
              one-device card run; moe_exec "tp" (every expert's d_ff/2
              block on every rank, the outputs summed over model) within
              that bar of a (2, 1) run on 2 more ranks (its aux is
              averaged over the data shards, as the JAX package's is);
              each rank's expert bytes.
     mesh_card_serve = mesh_card (h): the serve mesh. Full-width
              phi3-medium-14b, all 40 layers, served on (1, 2) by two gloo
              ranks on the card (bf16, attention "pallas", the 8 requests
              of serve): the attention and MLP tensor-parallel over model
              (each rank 20 of the 40 q heads, half of d_ff, half the vocab
              rows), each rank's decode cache (40, 4, 1,024, 10, 128) its
              block of the positions, the decode's partial softmaxes merged
              over model. Every prefill launches flash once a layer on
              every rank on the tc route; every prefill and decode step one
              bulk gather a rank. serve's greedy tokens teacher-forced
              through one prefill on the mesh: every differing greedy
              token a near-tie (no wider than one device's own prefill
              and decode loop disagree, at least 2 bf16 steps); the
              logits' deviation from one device's and the free-running
              runs' first divergences reported. Each rank's parameter bytes the plan's; init and
              serve peaks under 72 GB a rank; per-rank prefill (2,048) and
              decode-step ms, TTFT. Over gloo on one card these are not
              exchange times.
     mesh_card_tp = mesh_card (i): reduced phi3 and command-r (tied) at
              f32 on (2, 2) over 4 gloo ranks on the card: 3 training
              steps with the layers tensor-parallel, plain and under
              explicit_sp (core/sp.py), within 5e-4 + 1e-4 i of one
              device; the serve mesh's prefill and decode logits within
              rtol 1e-4 of a one-device Server's, the same greedy tokens.
     mesh_card_zero = mesh_card (j): ZeRO-1. phi3-medium-14b at its
              published width cut to 2 of 40 layers
              (profile_step.MESH_CELLS) on (2, 1) over 2 gloo ranks on the
              card, bf16, seq 512, batch 4, the table on the dense
              exchange (table_alpha 1.0): 2 steps at zero_stage 1, then 2
              at 0 (the fused apply) from the same init, under
              deterministic algorithms: the losses bit for bit, each
              rank's dense moments half of each leaf and the table's
              whole, the moment bytes the plan's optimizer term; per-rank
              peaks and step ms (gloo staged through the host).
     mesh_card_dp = mesh_card (k): the dp dense strategy. hymba-1.5b whole
              on (2, 2) over 4 gloo ranks (the model axis a batch axis, a
              row a rank) with ZeRO-1 over both axes, 2 steps: the ranks
              agree, the losses within rtol 2e-2 of the one-device card
              run from the same init and batches, each rank's dense
              moments a quarter of each leaf. Both phases: a bulk gather
              and a one-pass push a step on every rank.
     mesh_card_lstm = mesh_card (l): the LSTM tensor-parallel over model.
              Full-width parallax-lm (main's shape and RunConfig()) and
              parallax-nmt (nmt's cell) on (2, 2) over 4 gloo ranks, 3
              steps each, the losses within rel 1e-4 and the gradients'
              global norms within rel 1e-2 of a one-device card run
              (made and freed first); each LSTM leaf half of the whole on
              lstm_hidden (the gate leaves a rank's units of each gate),
              its blocks gathered over model the one-device leaf bit for
              bit at step 0; the pulls and pushes the plan's methods
              predict. Every rank under the verify gate
              (RunConfig.verify_contract: the first step's record of
              collectives checked against the plan before it applies), a
              recorded step clean under strict_dtype, and the record of
              one step by kind and axes (count, payload and wire bytes,
              ms), whose sum all-reduces a step are held to
              LSTM_ALL_REDUCES (model 44 / 804, data 6 / 12). A planted fault on (4, 1),
              nmt's cell (its plan buckets the exchange): the plan's
              overlap flipped after the build fails the gate with exactly
              a schedule finding and applies nothing. mesh_card (b) above
              runs the LSTM at H/4 a rank.
     table3   paper Table 3 (repro_torch.benchmarks.table3_transfer): an
              embedding-only step of ps, ps_gather and mpi_gatherv (and
              ps without local aggregation) at the paper's sizes (V
              65,536, E 512, bf16, 256 x 256 uniform ids) on (2, 2) over
              4 gloo ranks under a record: the wire bytes a replica
              within 1 % of the cost model's formula plus its named
              terms, the (16, 16) formula beside, each collective's ms
              (gloo staged through the host, not exchange times).
     mesh_card_toy = mesh_card (m): ToyServer on process meshes
              (profile_step.MESH_CELLS): rwkv6-7b whole on (1, 2) (32 of
              64 heads a rank), hymba-1.5b at 8 of 32 layers on (2, 2)
              (800 SSM channels, 13 padded q heads a rank). At f32 (the
              leaves the init makes constant varied) the first 2 of
              rwkv_serve's prompts, one after the other: the tokens of a
              one-device f32 run, every device step's logits of the slot
              that holds the request (rwkv6's 2,048-token prefill's last
              16 positions too) within 1e-3 of each row's scale of it;
              the idle slots' rows printed beside one device on the
              plain WKV. At
              bf16 the first 2 of rwkv_serve's 8 requests: wkv at 32
              heads on every rank (step route in decode, tc in the
              prefill), the tokens that differ from rwkv_serve's
              counted; per-rank init peak, decode-step ms, TTFT (of the
              2 requests).
     mesh_card_moe_tp = mesh_card (n): grok-1 at its published width, 2
              of 64 layers (profile_step.MESH_CELLS), moe_exec "tp",
              served by the paged Server on (1, 2): (8, 6,144, 16,384)
              and (8, 16,384, 6,144) expert blocks a rank; at f32 a
              2,048-token prefill's logits within 1e-3 of each row's
              scale of a one-device f32 run, moe_dropped of each; at
              bf16 the engine's prefill and 8 decode steps.

Each path (main, main_no_la, nmt, train (its adaptive run), train_growth,
train_resume (both runs), dense_parity (its card runs), dense_train,
mesh_one_rank, mesh_card (a) + (b), mesh_card_nmt = mesh_card (c),
mesh_card_dense = mesh_card (e), replan_replay (both phases, rank 0's),
serve, rwkv_serve, stablelm_parity (its card prefills and serving),
stablelm_serve, families_parity (its card runs), seamless_train,
hymba_train, chameleon_train, rwkv_train, mesh_card_encdec, moe_parity
(its card runs), grok_serve, llama4_serve, mesh_card_moe,
mesh_card_serve, mesh_card_tp, mesh_card_zero (both runs), mesh_card_dp,
mesh_card_lstm (both runs), mesh_card_toy (the bf16 serve loops of both
meshes and rwkv6's prefill), mesh_card_moe_tp (its bf16 prefills and
decode steps)) runs with
every launch
count set to 0 just before it and read just after: the mesh phases in
each rank's own process (mesh_card's (a), (b) and (c)'s two runs each so,
a path's launches their sum, rank 0's), rwkv_serve's serve loop and its
2,048-token prefill each so (the path's launches their sum).

Then a "done" line with the run's seconds and each phase's, the card's
name and power limit (nvidia-smi), one JSON line of the kernels' numbers,
and last {"ok": true, "device": {...}}.

It imports the port (src/repro_torch) and nothing of the JAX package.
"""
from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import compat  # noqa: E402
from repro_torch.analysis.contract import ContractViolation  # noqa: E402
from repro_torch.configs import (RunConfig, ShapeConfig, get_config,  # noqa: E402
                                 reduced)
from repro_torch.core import buckets  # noqa: E402
from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.core.embedding import dedupe  # noqa: E402
from repro_torch.core.runtime import Runtime  # noqa: E402
from repro_torch.core.transform import (analyze, get_runner,  # noqa: E402
                                        init_params_, load_params_,
                                        make_decode_step, make_prefill_step)
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.launch.mesh import MeshShape, make_mesh, spawn  # noqa: E402
from repro_torch.launch.profile_serve import (SERVE_LAYERS,  # noqa: E402
                                              serve_config)
from repro_torch.launch.profile_step import (CELLS,  # noqa: E402
                                             MESH_CELLS, cell_config,
                                             mesh_cell_config)
from repro_torch.core.plan import per_device_bytes  # noqa: E402
from repro_torch.models.layers import flatten_specs  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.moe import pick_exec_mode  # noqa: E402
from repro_torch.optim.optimizer import is_fused  # noqa: E402
from repro_torch.runtime.server import (Request, Server,  # noqa: E402
                                        ServerConfig, ToyServer,
                                        _gather_slots, bucket_len)
from repro_torch.utils.roofline import HW  # noqa: E402
from repro_torch.utils.tree import named_parameters  # noqa: E402
from repro_torch.weights import (load_reference_params,  # noqa: E402
                                 shard_tensor)

VOCAB, E, SEQ, BATCH = 800_000, 512, 20, 128      # parallax-lm, lm1b cell
TIMED_RUNS, WARMUP = 50, 5
KERNELS = {
    "embed_gather": {
        "route": "cuda",
        # rows of whole 16-byte units, every full-width path's route
        "source": "src/repro_torch/kernels/csrc/embed_gather_bulk.cu",
        "replaces": "src/repro/kernels/embed_gather.py:29",
        "design": ("bulk route: warps of independent copiers, each row one "
                   "cp.async.bulk into a lane's shared-memory slot "
                   "(mbarrier complete_tx) and one bulk store out; unowned "
                   "rows a bulk store of a zero tile; other rows: the "
                   "element route, a thread per 16 B or element"),
        "element_source": "src/repro_torch/kernels/csrc/embed_gather.cu",
    },
    "embed_scatter_add": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embed_scatter_fused.cu",
        "replaces": "src/repro/kernels/embed_scatter.py:36",
        "design": ("one pass: short blocks of ~64 KB of output in launch "
                   "order, each mapping its rows to source ids in shared "
                   "memory and writing every row once (zeros or the "
                   "widened pushed row); no fill, no dump row"),
        "dump_row_source": "src/repro_torch/kernels/csrc/embed_scatter.cu",
    },
    "flash_attention": {
        "route": "cuda",
        # bf16 with D in {64, 128, 160}, the full-width paths' route
        "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
        "replaces": "src/repro/kernels/flash_attention.py:67",
        "design": ("bf16, D 64/128/160: wgmma m64n128k16 (S from shared "
                   "memory, P.V with P in registers), TMA 4-D tensor maps "
                   "with the 128 B swizzle (D 160: two 64-column boxes "
                   "and a 32-column one with the 64 B swizzle, its P.V an "
                   "m64n32k16), a 2-stage K/V mbarrier ring, one producer "
                   "thread and two consumer warpgroups (setmaxnreg "
                   "24/240); f32 and D 16/32: scalar f32 FMAs"),
        "scalar_source": "src/repro_torch/kernels/csrc/flash_attention.cu",
    },
    # the three routes of ops.wkv (ops.wkv_route), one row each; "wkv" is
    # the scalar route (f32, narrow heads), which no full-width path takes
    "wkv": {
        "route": "cuda",
        "wkv_route": "scalar",
        "source": "src/repro_torch/kernels/csrc/wkv.cu",
        "replaces": "src/repro/kernels/wkv.py:68",
        "design": "f32 and E 16/32, S > 1: scalar f32 FMAs, state in shared "
                  "memory",
    },
    "wkv_tc": {
        "route": "cuda",
        "wkv_route": "tc",
        "source": "src/repro_torch/kernels/csrc/wkv_tc.cu",
        "replaces": "src/repro/kernels/wkv.py:68",
        "design": "bf16, E 64, S > 1: mma.sync m16n8k16 with bf16 hi/lo "
                  "operands, a TMA ring of chunk tiles, factor / product / "
                  "state warpgroups pipelined over chunks",
    },
    "wkv_step": {
        "route": "cuda",
        "wkv_route": "step",
        "source": "src/repro_torch/kernels/csrc/wkv_step.cu",
        "replaces": "src/repro/kernels/wkv.py:68",
        "design": "S = 1, f32 and bf16: one pass over the state, 16-byte "
                  "loads, warp-shuffle sums",
    },
}
# the kernels each path must launch (embed_scatter_add is a backward kernel;
# serving has no backward); rwkv_serve's wkv launches by route
PATH_KERNELS = {"main": ("embed_gather", "embed_scatter_add"),
                # local_agg=False: repeated ids take the plain scatter
                "main_no_la": ("embed_gather",),
                # the 1 x 1 mesh plans mpi_gatherv: its push (repeats
                # possible in general) takes the plain scatter
                "mesh_one_rank": ("embed_gather",),
                # ps on (1, 4): each rank's owner push is one-pass
                "mesh_card": ("embed_gather", "embed_scatter_add"),
                # both tables pulled and pushed one-pass every step
                "nmt": ("embed_gather", "embed_scatter_add"),
                # (4, 1): the gatherv push of embed takes the plain
                # scatter, the dense-routed enc_embed's is one-pass
                "mesh_card_nmt": ("embed_gather", "embed_scatter_add"),
                # the launcher's own ranks: pulls on the bulk route, the
                # all-reduce's pushes one-pass until the flip to gatherv
                "mesh_launcher": ("embed_gather", "embed_scatter_add"),
                # the training driver: every step pulls on the bulk
                # route and pushes one-pass, whatever the capacity
                "train": ("embed_gather", "embed_scatter_add"),
                "train_growth": ("embed_gather", "embed_scatter_add"),
                "train_resume": ("embed_gather", "embed_scatter_add"),
                "serve": ("embed_gather", "flash_attention"),
                # stablelm-12b's 160-wide heads: the tc route at bf16 in
                # the engine, the scalar route at f32 in the parity run
                "stablelm_serve": ("embed_gather", "flash_attention"),
                "stablelm_parity": ("embed_gather", "flash_attention"),
                # slice 6's families: every training step pulls and pushes
                # one table (flash and wkv are forward-only: never in
                # training); the parity run's pallas prefills take flash
                "families_parity": ("embed_gather", "embed_scatter_add",
                                    "flash_attention"),
                "seamless_train": ("embed_gather", "embed_scatter_add"),
                "hymba_train": ("embed_gather", "embed_scatter_add"),
                "chameleon_train": ("embed_gather", "embed_scatter_add"),
                "rwkv_train": ("embed_gather", "embed_scatter_add"),
                # mesh_card (f): hybrid's owner push one-pass, mpi's plain
                "mesh_card_encdec": ("embed_gather", "embed_scatter_add"),
                "rwkv_serve": ("embed_gather", "wkv_tc", "wkv_step"),
                # the dense transformer's training: every step pulls phi3's
                # (or command-r's) table and pushes its unique ids
                # one-pass (the gatherv push of mesh_card (e)'s mpi runs
                # takes the plain scatter)
                "dense_parity": ("embed_gather", "embed_scatter_add"),
                "dense_train": ("embed_gather", "embed_scatter_add"),
                "mesh_card_dense": ("embed_gather", "embed_scatter_add"),
                # the adaptive_replan replay's 8 ranks (rank 0's): ps's
                # owner push one-pass, ps_gather's plain
                "replan_replay": ("embed_gather", "embed_scatter_add"),
                # the moe family: its card-against-CPU training pulls and
                # pushes, its f32 engine prefills take flash's scalar
                # route; full-width serving takes flash's tc route (D 128
                # bf16); on the mesh hybrid's owner push is one-pass
                "moe_parity": ("embed_gather", "embed_scatter_add",
                               "flash_attention"),
                "grok_serve": ("embed_gather", "flash_attention"),
                "llama4_serve": ("embed_gather", "flash_attention"),
                "mesh_card_moe": ("embed_gather", "embed_scatter_add"),
                # the serve mesh: each rank's prefills take flash's tc
                # route at its 20 q heads, every step gathers its vocab
                # rows; the tensor-parallel training pulls and pushes, its
                # f32 serve mesh takes flash's scalar route
                "mesh_card_serve": ("embed_gather", "flash_attention"),
                "mesh_card_tp": ("embed_gather", "embed_scatter_add",
                                 "flash_attention"),
                # ZeRO-1 (phi3, 2 layers, (2, 1)) and dp (hymba, (2, 2)):
                # every rank pulls on the bulk route and, the table on the
                # dense exchange, pushes its unique ids one-pass
                "mesh_card_zero": ("embed_gather", "embed_scatter_add"),
                "mesh_card_dp": ("embed_gather", "embed_scatter_add"),
                # the LSTM tensor-parallel on (2, 2): every rank pulls on
                # the bulk route; parallax-lm's table rides mpi_gatherv
                # (the plain scatter), parallax-nmt's enc_embed the dense
                # exchange (one-pass pushes)
                "mesh_card_lstm": ("embed_gather", "embed_scatter_add"),
                # ToyServer on meshes: rwkv6's rank-of-32-heads WKV on the
                # step route in every device step, the tc route in the
                # 2,048-token prefill; every step gathers the rank's vocab
                # rows
                "mesh_card_toy": ("embed_gather", "wkv_tc", "wkv_step"),
                # grok-1's routed experts over model: flash on the tc
                # route at 24 q heads a rank, a bulk gather a step
                "mesh_card_moe_tp": ("embed_gather", "flash_attention")}
CENSUS = ("embed_rows", "embed_unique", "embed_dropped")
NMT_CENSUS = tuple(f"{t}_{k}" for t in ("embed", "enc_embed")
                   for k in ("rows", "unique", "dropped"))
WKV_ROWS = {"scalar": "wkv", "tc": "wkv_tc", "step": "wkv_step"}
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
WKV_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
SERVE_BATCH, SERVE_MAX_SEQ = 4, 2048                # both serve phases
RWKV, RWKV_PREFILL = "rwkv6-7b", 2048
F32_CORE_FLOPS = 67e12      # f32 FMA rate of the CUDA cores (H100 SXM sheet)
# dense_train: phi3-medium-14b's cell (``profile_step.CELLS``: its
# published width at 8 of 40 layers, launch/train.py's default shape)
DENSE_ARCH, DENSE_STEPS = "phi3-medium-14b", 12
DENSE = CELLS[DENSE_ARCH]
# the slice-6 families' training phases (their cells in
# ``profile_step.CELLS``: seamless and hymba whole, chameleon at 4 of 48
# layers, rwkv6 at 8 of 32), each 12 Trainer steps like dense_train, and a
# training phase's peak-memory limit on the 80 GB card
FAMILY_TRAIN = {"seamless_train": "seamless-m4t-medium",
                "hymba_train": "hymba-1.5b",
                "chameleon_train": "chameleon-34b",
                "rwkv_train": "rwkv6-7b"}
FAMILY_STEPS = 12
PEAK_LIMIT = 72e9
STABLELM = "stablelm-12b"
# the moe family: grok-1 (8 experts, top-2) and llama4-maverick (128
# experts, top-1 and a shared expert); served at their published widths cut
# to profile_serve.SERVE_LAYERS, trained reduced (one layer of either at 12
# B a parameter passes the 80 GB card)
GROK, LLAMA4 = "grok-1-314b", "llama4-maverick-400b-a17b"
# the reference correctness test's RunConfig (f32 end to end, plain
# attention, no remat): dense_parity and mesh_card (e)
DENSE_F32 = dict(param_dtype="float32", compute_dtype="float32",
                 wire_dtype="float32", remat="none")
# rwkv6 parameters that the seeded init leaves constant (zero mixes, zero
# decay LoRA factor, w0 and bonus): the parity phases draw them, so the
# data-dependent decay and the bonus are exercised. (scale, offset) of a
# normal draw; decays stay where chunk * |lw| <= 80 (the exact regime).
RWKV_DRAWN = {"tm.mu": (0.3, 0.0), "cm.mu": (0.3, 0.0),
              "tm.w_lora_b": (0.01, 0.0), "tm.w0": (0.3, -0.5),
              "tm.bonus": (0.3, 0.0)}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Median device time of a callable over CUDA events. Before each timed
    run a 256 MB buffer is zeroed: it evicts the 50 MB L2, as the main path
    finds the tables cold, and keeps the card busy while the host enqueues
    the timed call, so the events bracket device work."""

    def __init__(self, dev):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def ms(self, fn, runs: int = TIMED_RUNS) -> float:
        for _ in range(WARMUP):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(runs):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_ms(fn, calls: int = 200) -> float:
    """Host time to enqueue one call: ``calls`` back to back, timed before
    the synchronise, so a call whose device work is shorter than its host
    work is measured by the latter."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / calls * 1e3


def bound_ms(nbytes: int) -> float:
    return nbytes / HW.hbm_bw * 1e3


def ops_ms(flops: float) -> float:
    """Least time for ``flops`` at the card's bf16 tensor-core peak."""
    return flops / HW.peak_flops * 1e3


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_banner() -> dict:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — this "
                 "script runs on a card")
    cap = compat.capability()
    check(compat.is_hopper(), f"compute capability {cap}, want (9, 0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {
        "phase": "banner",
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "device": torch.cuda.get_device_name(0), "capability": list(cap),
        "count": torch.cuda.device_count(),
        "nvidia_smi": nvidia_smi("name,power.limit"),
        "nvcc": compat.nvcc_path(),
        "backends": {"nccl": compat.nccl_available(),
                     "gloo": compat.gloo_available()},
        "tf32": [torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32],
    }
    emit(info)
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    res = _build.build_all()
    for name in res:
        _build.load(name)
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "ptxas": {n: [ln for ln in r["log"].splitlines()
                        if "registers" in ln or "spill" in ln
                        or "Function properties" in ln]
                    for n, r in res.items()}})


def _main_ids(dev) -> torch.Tensor:
    """The dedupe buffer of the main path's first batch (capacity = tokens,
    ascending unique ids padded with the sentinel VOCAB)."""
    toks = SyntheticLM(VOCAB, SEQ, BATCH).batch(0)["tokens"]
    flat = torch.from_numpy(np.ascontiguousarray(toks)).reshape(-1).to(dev)
    uids, _, _ = dedupe(flat, SEQ * BATCH, VOCAB, True)
    return uids


def _unique_sorted(rng, n: int, lo: int, hi: int, dev) -> torch.Tensor:
    """Sorted ids, unique among owned rows, with negatives and ids >= vs —
    the shape of tests/test_kernels.py's dedupe-buffer generator."""
    uniq = np.unique(rng.integers(lo, hi, size=4 * n))[:n]
    pad = np.full(max(n - uniq.size, 0), hi, np.int64)
    ids = np.concatenate([uniq, pad])[:n].astype(np.int32)
    return torch.from_numpy(ids).to(dev)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of a bf16 or f32 tensor, so that torch.equal tells
    -0.0 from +0.0."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _misaligned(table: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``table`` whose base lies one element past a
    16-byte boundary (the element route's case)."""
    flat = torch.empty(table.numel() + 1, dtype=table.dtype,
                       device=table.device)
    view = flat[1:].view(table.shape)
    view.copy_(table)
    return view


def _nmt_ids(dev) -> dict:
    """The dedupe buffers parallax-nmt's first batch gives its two tables:
    on one device (all 6,400 tokens) and on rank 0 of a (4, 1) mesh (its
    1,600), each at its token count's capacity."""
    cfg, shape, _ = _nmt_setup()
    batch = _nmt_batches(1)[0]
    v, out = cfg.vocab_size, {}
    for table, key in (("embed", "tokens"), ("enc_embed", "src_tokens")):
        flat = torch.from_numpy(np.ascontiguousarray(batch[key])).reshape(
            -1).to(dev)
        for where, ids in (("one_device", flat),
                           ("rank0_of_4", flat[:flat.numel() // 4])):
            out[f"nmt_{table}_{where}"] = dedupe(ids, ids.numel(), v,
                                                 True)[0]
    return out


def _nmt_kernel_cases(dev, gen, hold_gather, hold) -> None:
    """Both embed kernels at parallax-nmt's shapes: a (36,548, 1,024) bf16
    table (2,048-byte rows, the bulk route) and bf16 wire rows pushed into
    its f32 gradient, at each table's ids."""
    v = get_config("parallax-nmt").vocab_size
    table = torch.randn((v, 1024), generator=gen, device=dev).to(
        torch.bfloat16)
    check(ops.gather_route(2048, table.data_ptr()) == "bulk",
          "embed_gather: parallax-nmt's table is not on the bulk route")
    for case, ids in _nmt_ids(dev).items():
        hold_gather(case, table, ids, 0)
        rows = torch.randn((ids.numel(), 1024), generator=gen,
                           device=dev).to(torch.bfloat16)
        fused0 = ops.embed_scatter_add.launches_fused
        got = ops.embed_scatter_add(ids, rows, v)
        check(ops.embed_scatter_add.launches_fused - fused0 == 1,
              f"embed_scatter_add/{case}: not on the one-pass kernel")
        hold("embed_scatter_add", case, got,
             ref.embed_scatter_add_ref(ids, rows, v))
    del table
    torch.cuda.empty_cache()


def _scatter_fns(ids, rows, vs: int, e: int) -> dict:
    """The push's function three ways on the same inputs: the one-pass
    kernel; PR 11's function (a zeroed (Vs + 1, E) buffer, the dump-row
    kernel, the slice); and the library's same function, timed whole
    (torch.zeros, index_copy_ of the widened rows with unowned ids sent to
    row Vs, the slice)."""
    dev = rows.device

    def dump_row():
        out = torch.zeros((vs + 1, e), dtype=torch.float32, device=dev)
        ops.scatter_into(ids, rows, out, vs)
        return out[:vs]

    def library():
        owned = (ids >= 0) & (ids < vs)
        dst = torch.where(owned, ids.long(), vs)
        out = torch.zeros((vs + 1, e), dtype=torch.float32, device=dev)
        return out.index_copy_(0, dst, rows.float())[:vs]

    return {"kernel": lambda: ops.embed_scatter_add(ids, rows, vs),
            "dump_row": dump_row, "library": library}


def phase_kernels(dev) -> dict:
    ops.reset_launch_counts()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    uids = _main_ids(dev)
    n = uids.shape[0]
    t32 = torch.randn((VOCAB, E), generator=gen, device=dev)
    t16 = t32.to(torch.bfloat16)
    small32 = torch.randn((1000, 100), generator=gen, device=dev)
    small16 = small32.to(torch.bfloat16)
    off_ids = torch.from_numpy(rng.integers(
        -1000, VOCAB + 400_000 + 1000, size=n).astype(np.int32)).to(dev)
    small_ids = torch.from_numpy(rng.integers(
        -50, 1050, size=300).astype(np.int32)).to(dev)

    errs = {k: 0.0 for k in KERNELS}
    cases = []

    def hold(kernel: str, case: str, got, want):
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{kernel}/{case}: {got.dtype}{tuple(got.shape)} vs "
              f"{want.dtype}{tuple(want.shape)}")
        err = float((got.float() - want.float()).abs().max()) \
            if got.numel() else 0.0
        check(torch.equal(_bits(got), _bits(want)),
              f"{kernel}/{case}: not bitwise equal to the plain version "
              f"(max abs err {err})")
        errs[kernel] = max(errs[kernel], err)
        cases.append(f"{kernel}/{case}")

    def hold_gather(case, table, ids, off):
        route = ops.gather_route(table.shape[1] * table.element_size(),
                                 table.data_ptr())
        bulk0 = ops.embed_gather.launches_bulk
        got = ops.embed_gather(table, ids, off)
        check(ops.embed_gather.launches_bulk - bulk0 == (route == "bulk"),
              f"embed_gather/{case}: not launched on its {route} route")
        hold("embed_gather", f"{case}_{route}", got,
             ref.embed_gather_ref(table, ids, off))

    for case, table, ids, off in (
            ("main_bf16", t16, uids, 0), ("main_f32", t32, uids, 0),
            ("row_offset_bf16", t16, off_ids, 400_000),
            ("row_offset_f32", t32, off_ids, 400_000),
            ("narrow_e100_bf16", small16, small_ids, 0),
            ("narrow_e100_f32", small32, small_ids, 0),
            ("misaligned_bf16", _misaligned(t16), uids, 0),
            ("misaligned_f32", _misaligned(t32), uids, 0)):
        hold_gather(case, table, ids, off)
    # E = 100 in bf16 and the two misaligned tables; E = 100 in f32 (400 B
    # rows) is whole 16-byte units
    check(sum(c.endswith("_element") for c in cases) == 3,
          f"embed_gather: the element route took {cases}")
    torch.cuda.empty_cache()

    rows32 = torch.randn((n, E), generator=gen, device=dev)
    edge_ids = _unique_sorted(rng, n, -VOCAB // 4, VOCAB + VOCAB // 4, dev)
    small_rows32 = torch.randn((300, 100), generator=gen, device=dev)
    small_sc_ids = _unique_sorted(rng, 300, -100, 1100, dev)
    shuffled = uids[torch.randperm(n, generator=gen, device=dev)]
    signed_zero = rows32.clone()
    signed_zero[::3, ::5] = -0.0
    few = torch.from_numpy(rng.permutation(np.arange(-4, 12))
                           .astype(np.int32)).to(dev)
    for case, ids, rows, vs in (
            ("main_bf16", uids, rows32.to(torch.bfloat16), VOCAB),
            ("main_f32", uids, rows32, VOCAB),
            ("unowned_bf16", edge_ids, rows32.to(torch.bfloat16), VOCAB),
            ("unowned_f32", edge_ids, rows32, VOCAB),
            # a ps shard at M = 8 that owns none of the ids
            ("no_owned_id_m8", uids + VOCAB // 8, rows32, VOCAB // 8),
            # a shard at M = 2 owning about half of 2,560 spread ids
            ("half_owned_m2", _unique_sorted(rng, n, 0, VOCAB, dev),
             rows32.to(torch.bfloat16), VOCAB // 2),
            ("out_of_order_bf16", shuffled, rows32.to(torch.bfloat16),
             VOCAB),
            ("negative_zero_f32", uids, signed_zero, VOCAB),
            ("vs_below_a_block", few, rows32[:16], 5),
            ("narrow_e100_bf16", small_sc_ids,
             small_rows32.to(torch.bfloat16), 1000),
            ("narrow_e100_f32", small_sc_ids, small_rows32, 1000)):
        fused0 = ops.embed_scatter_add.launches_fused
        got = ops.embed_scatter_add(ids, rows, vs)
        check(ops.embed_scatter_add.launches_fused - fused0 == 1,
              f"embed_scatter_add/{case}: not on the one-pass kernel")
        hold("embed_scatter_add", case, got,
             ref.embed_scatter_add_ref(ids, rows, vs))
    del t32, rows32, signed_zero
    torch.cuda.empty_cache()
    _nmt_kernel_cases(dev, gen, hold_gather, hold)

    # ---- timing at the main path's shapes: bf16 table, bf16 wire rows ----
    timer = Timer(dev)
    floor = _build.load("launch_floor")
    floor_ms = timer.ms(
        lambda: floor(torch.cuda.current_stream(dev).cuda_stream))
    owned = int(((uids >= 0) & (uids < VOCAB)).sum())
    clamped = uids.long().clamp(0, VOCAB - 1)
    g_bytes = (owned + n) * E * 2 + 4 * n
    gather = {
        "kernel_ms": timer.ms(lambda: ops.embed_gather(t16, uids, 0)),
        # PR 11's kernel, the element route, on the same inputs
        "element_ms": timer.ms(lambda: ops.gather_element(t16, uids, 0)),
        "plain_ms": timer.ms(lambda: ref.embed_gather_ref(t16, uids, 0)),
        # index_select reads a (clamped) row for every id and zeroes none:
        # the nearest single PyTorch call, timed only
        "library_ms": timer.ms(lambda: torch.index_select(t16, 0, clamped)),
        "floor_ms": floor_ms,
        "bytes": g_bytes, "bound_ms": bound_ms(g_bytes),
    }
    rows16 = torch.randn((n, E), generator=gen, device=dev).to(torch.bfloat16)
    fns = _scatter_fns(uids, rows16, VOCAB, E)
    # the function's bytes: every output byte written once, the ids and
    # the owned ids' rows read once
    s_bytes = VOCAB * E * 4 + owned * E * 2 + 4 * n
    all_owned = torch.from_numpy(rng.permutation(VOCAB)[:n]
                                 .astype(np.int32)).to(dev)
    none_owned = all_owned + VOCAB
    dump_buf = torch.zeros((VOCAB + 1, E), dtype=torch.float32, device=dev)
    scatter = {
        "kernel_ms": timer.ms(fns["kernel"]),
        # PR 11's function: zero fill, dump-row kernel, slice
        "dump_row_ms": timer.ms(fns["dump_row"]),
        # the dump-row kernel alone, into a buffer zeroed outside the timing
        "dump_row_kernel_ms": timer.ms(
            lambda: ops.scatter_into(uids, rows16, dump_buf, VOCAB)),
        "plain_ms": timer.ms(
            lambda: ref.embed_scatter_add_ref(uids, rows16, VOCAB)),
        "library_ms": timer.ms(fns["library"]),
        # the write rate the card gives a plain fill of the same output
        "fill_ms": timer.ms(
            lambda: torch.zeros((VOCAB, E), dtype=torch.float32,
                                device=dev)),
        # the dump-row test: 2,560 ids all owned, then none
        "all_owned_ms": timer.ms(
            lambda: ops.embed_scatter_add(all_owned, rows16, VOCAB)),
        "none_owned_ms": timer.ms(
            lambda: ops.embed_scatter_add(none_owned, rows16, VOCAB)),
        "floor_ms": floor_ms,
        "bytes": s_bytes, "bound_ms": bound_ms(s_bytes),
    }
    del t16, dump_buf, rows16
    torch.cuda.empty_cache()
    gather["shape"] = (f"parallax-lm: table ({VOCAB}, {E}) bf16, {n} ids "
                       f"({owned} owned; one training step's dedupe buffer)")
    scatter["shape"] = (f"parallax-lm: ({VOCAB}, {E}) f32 gradient from "
                        f"{n} bf16 rows ({owned} owned)")
    gather_serve = _serve_gather(dev, gen, timer, hold_gather,
                                 "phi3-medium-14b", _serve_ids(dev), "serve")
    gather_rwkv = _serve_gather(dev, gen, timer, hold_gather, RWKV,
                                _rwkv_ids(dev), "rwkv")
    dense = _dense_train_kernels(dev, gen, timer, hold_gather, hold)
    flash = _flash_kernels(dev, gen, timer, errs, cases)
    wkv = _wkv_kernels(dev, gen, timer, errs, cases)
    res = {"phase": "kernels", "cases": cases, "n_ids": n, "owned": owned,
           "max_abs_err": errs, "launches": ops.launch_counts(),
           "embed_gather": gather, "embed_gather_serve": gather_serve,
           "embed_gather_rwkv": gather_rwkv, "dense_train_shape": dense,
           "embed_scatter_add": scatter, "flash_attention": flash, **wkv}
    emit(res)
    return res


def _serve_ids(dev) -> dict:
    """The ids the serve path hands embed_gather (phi3-medium-14b, exact
    capacity): the dedupe buffer of the serve phase's first prefill (its
    first prompt, 1,561 tokens zero-padded to the 2,048 bucket) and of one
    decode step's 4 tokens (batch 4, one token each)."""
    vs = get_config("phi3-medium-14b").vocab_size
    rng = np.random.default_rng(0)
    prompt = _serve_prompts(rng, vs)[1][0]
    toks = np.zeros(bucket_len(len(prompt), SERVE_MAX_SEQ), np.int32)
    toks[:len(prompt)] = prompt
    step = rng.integers(0, vs, size=SERVE_BATCH).astype(np.int32)
    out = {}
    for case, flat in (("prefill", toks), ("decode", step)):
        ids = torch.from_numpy(flat).to(dev)
        out[case], _, _ = dedupe(ids, min(ids.numel(), vs), vs, True)
    return out


def _rwkv_prompt(vocab: int) -> np.ndarray:
    """The 2,048-token prompt of rwkv_serve's make_prefill_step."""
    return np.random.default_rng(1).integers(
        0, vocab, size=(1, RWKV_PREFILL)).astype(np.int32)


def _rwkv_ids(dev) -> dict:
    """The ids the rwkv6 path hands embed_gather (exact capacity): the
    dedupe buffer of a 2,048-token prompt and of one 4-slot decode step."""
    vs = get_config(RWKV).vocab_size
    step = np.random.default_rng(2).integers(0, vs, size=SERVE_BATCH)
    out = {}
    for case, flat in (("prefill", _rwkv_prompt(vs)[0]),
                       ("decode", step.astype(np.int32))):
        ids = torch.from_numpy(flat).to(dev)
        out[case], _, _ = dedupe(ids, min(ids.numel(), vs), vs, True)
    return out


def _serve_gather(dev, gen, timer: Timer, hold_gather, arch: str,
                  ids: dict, tag: str) -> dict:
    """embed_gather at a serve path's shapes: ``arch``'s table (phi3-
    medium-14b's (100,352, 5,120), rwkv6-7b's (65,536, 4,096)) in bf16 (the
    served dtype) and f32, held bit for bit against its plain version on
    the route ``ops.gather_route`` gives it; kernel, element-route, plain
    and library times of the bf16 prefill and decode lookups beside their
    byte bounds."""
    cfg = get_config(arch)
    vs, d = cfg.vocab_size, cfg.d_model
    t32 = torch.randn((vs, d), generator=gen, device=dev)
    t16 = t32.to(torch.bfloat16)
    for case, uids in ids.items():
        for tname, table in (("bf16", t16), ("f32", t32)):
            hold_gather(f"{tag}_{case}_{tname}", table, uids, 0)
    del t32
    res = {}
    for case, uids in ids.items():
        n = uids.shape[0]
        owned = int(((uids >= 0) & (uids < vs)).sum())
        clamped = uids.long().clamp(0, vs - 1)
        nbytes = (owned + n) * d * 2 + 4 * n
        res[case] = {
            "shape": f"{arch}: table ({vs}, {d}) bf16, {n} ids "
                     f"({owned} owned)",
            "kernel_ms": timer.ms(lambda: ops.embed_gather(t16, uids, 0)),
            "element_ms": timer.ms(
                lambda: ops.gather_element(t16, uids, 0)),
            "plain_ms": timer.ms(lambda: ref.embed_gather_ref(t16, uids, 0)),
            "library_ms": timer.ms(
                lambda: torch.index_select(t16, 0, clamped)),
            "bytes": nbytes, "bound_ms": bound_ms(nbytes),
            "bound_by": "bytes"}
    return res


def _dense_ids(dev) -> dict:
    """The ids dense_train hands the embed kernels: the dedupe buffer of
    its first batch (4,096 Zipf(1.3) tokens at exact capacity: ascending
    unique ids padded with the sentinel), and 4,096 distinct ids, all
    owned, in random order."""
    vs = get_config(DENSE_ARCH).vocab_size
    toks = _dense_batches(1)[0]["tokens"]
    flat = torch.from_numpy(np.ascontiguousarray(toks)).reshape(-1).to(dev)
    n = flat.numel()
    buf, _, _ = dedupe(flat, n, vs, True)
    every = np.random.default_rng(3).permutation(vs)[:n].astype(np.int32)
    return {"dense_train": buf,
            "all_owned": torch.from_numpy(every).to(dev)}


def _dense_train_kernels(dev, gen, timer: Timer, hold_gather,
                         hold) -> dict:
    """Both embed kernels at the dense training path's shapes: phi3's
    (100,352, 5,120) bf16 table (10,240-byte rows, the bulk route) pulled
    at its ids, and the bf16 wire rows pushed into its (100,352, 5,120) f32
    gradient, held bit for bit; kernel, plain and library times of the
    first batch's buffer beside their byte bounds."""
    cfg = get_config(DENSE_ARCH)
    vs, d = cfg.vocab_size, cfg.d_model
    table = torch.randn((vs, d), generator=gen, device=dev).to(
        torch.bfloat16)
    check(ops.gather_route(d * 2, table.data_ptr()) == "bulk",
          "embed_gather: phi3's table is not on the bulk route")
    ids = _dense_ids(dev)
    rows = {}
    for case, uids in ids.items():
        hold_gather(f"{case}_bf16", table, uids, 0)
        rows[case] = torch.randn((uids.numel(), d), generator=gen,
                                 device=dev).to(torch.bfloat16)
        fused0 = ops.embed_scatter_add.launches_fused
        got = ops.embed_scatter_add(uids, rows[case], vs)
        check(ops.embed_scatter_add.launches_fused - fused0 == 1,
              f"embed_scatter_add/{case}: not on the one-pass kernel")
        hold("embed_scatter_add", case, got,
             ref.embed_scatter_add_ref(uids, rows[case], vs))
        del got
        torch.cuda.empty_cache()
    uids, r16 = ids["dense_train"], rows["dense_train"]
    n = uids.numel()
    owned = int(((uids >= 0) & (uids < vs)).sum())
    clamped = uids.long().clamp(0, vs - 1)
    g_bytes = (owned + n) * d * 2 + 4 * n
    s_bytes = vs * d * 4 + owned * d * 2 + 4 * n
    fns = _scatter_fns(uids, r16, vs, d)
    shape = f"{DENSE_ARCH}: table ({vs}, {d}) bf16, {n} ids ({owned} owned)"
    res = {
        "embed_gather": {
            "shape": shape,
            "kernel_ms": timer.ms(lambda: ops.embed_gather(table, uids, 0)),
            "plain_ms": timer.ms(
                lambda: ref.embed_gather_ref(table, uids, 0)),
            "library_ms": timer.ms(
                lambda: torch.index_select(table, 0, clamped)),
            "bytes": g_bytes, "bound_ms": bound_ms(g_bytes),
            "bound_by": "bytes"},
        "embed_scatter_add": {
            "shape": f"{DENSE_ARCH}: ({vs}, {d}) f32 gradient from {n} "
                     f"bf16 rows ({owned} owned)",
            "kernel_ms": timer.ms(fns["kernel"], runs=20),
            "plain_ms": timer.ms(
                lambda: ref.embed_scatter_add_ref(uids, r16, vs), runs=20),
            "library_ms": timer.ms(fns["library"], runs=20),
            "bytes": s_bytes, "bound_ms": bound_ms(s_bytes),
            "bound_by": "bytes"}}
    del table, rows, r16
    torch.cuda.empty_cache()
    return res


def _flash_work(b, sq, h, d, itemsize) -> dict:
    """Operations and bytes of one causal self-attention call: QK^T and P.V
    over the unmasked (q, k) pairs, 2 per FMA; q, k, v read and o written
    once."""
    flops = 4 * d * b * h * sq * (sq + 1) // 2
    nbytes = 4 * b * sq * h * d * itemsize
    t_ops, t_bytes = ops_ms(flops), bound_ms(nbytes)
    return {"flops": flops, "bytes": nbytes, "ops_bound_ms": t_ops,
            "bytes_bound_ms": t_bytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _flash_kernels(dev, gen, timer: Timer, errs: dict, cases: list) -> dict:
    """flash_attention against its plain version at the serve path's main
    shape (one 2,048-token prefill of phi3-medium-14b: B 1, H 40, D 128,
    causal) and at edge cases, in f32 and bf16, each case on the route
    ``ops.flash_route`` gives it (bf16 at D 64 and 128: the tensor-core
    kernel; f32 and the narrow heads: the scalar one); times at the engine's
    prefill buckets (B 1, H 40, D 128, causal, bf16) beside SDPA's, and the
    f32 route's at the main shape."""
    def qkv(b, sq, sk, h, d, dtype):
        return [torch.randn((b, s_, h, d), generator=gen, device=dev)
                .to(dtype) for s_ in (sq, sk, sk)]

    def strided(b, s_, h, d, dtype):
        """q, k, v as non-contiguous (B, S, H, D) views, each a half of
        the last dimension of a (B, H, S, 2D) buffer."""
        base = torch.randn((3, b, h, s_, 2 * d), generator=gen,
                           device=dev).to(dtype)
        q = base[0, ..., :d].transpose(1, 2)
        return [q] + [base[i, ..., d:].transpose(1, 2) for i in (1, 2)]

    def hold(name, q, k, v, causal):
        route = ops.flash_route(q.dtype, q.shape[-1])
        tc0 = ops.flash_attention.launches_tc
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check(ops.flash_attention.launches_tc - tc0 == (route == "tc"),
              f"flash_attention/{name}: not launched on its {route} route")
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"flash_attention/{name}: {got.dtype}{tuple(got.shape)} vs "
              f"{want.dtype}{tuple(want.shape)}")
        diff = (got.float() - want.float()).abs()
        tol = FLASH_TOL[q.dtype]
        bad = diff > tol + tol * want.float().abs()
        err = float(diff.max())
        check(not bool(bad.any()) and bool(torch.isfinite(got).all()),
              f"flash_attention/{name}: {int(bad.sum())} elements outside "
              f"{tol} (max abs err {err})")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        worst[name] = {"route": route, "max_abs_err": err}
        cases.append(f"flash_attention/{name}")

    worst = {}
    for case, (b, sq, sk, h, d), causals, dtypes in (
            ("main", (1, 2048, 2048, 40, 128), (True,), None),
            # a rank's 20 of the 40 q heads on mesh_card_serve's (1, 2)
            ("tp_rank", (1, 2048, 2048, 20, 128), (True,), None),
            ("ragged", (1, 200, 200, 4, 64), (True, False), None),
            ("cross_lengths", (2, 96, 160, 2, 64), (False,), None),
            ("b2_d32", (2, 64, 64, 8, 32), (True, False), None),
            ("b2_d16", (2, 16, 16, 4, 16), (True, False), None),
            # the tensor-core route's edges, at phi3's head width
            ("sq96_sk160_d128", (2, 96, 160, 4, 128), (True, False),
             (torch.bfloat16,)),
            ("sq160_sk96_d128", (2, 160, 96, 4, 128), (True, False),
             (torch.bfloat16,)),
            ("b4_sq200_d128", (4, 200, 200, 40, 128), (True,),
             (torch.bfloat16,)),
            # one q tile of 8 rows: the engine's smallest prefill bucket
            ("sq8_d128", (1, 8, 8, 40, 128), (True, False),
             (torch.bfloat16,)),
            # stablelm-12b's 160-wide heads: its 2,048-token prefill, the
            # engine's smaller buckets, Sq != Sk both ways (bf16 on the
            # tensor cores: two 64-column boxes and a 32-column one)
            ("stablelm_d160", (1, 2048, 2048, 32, 160), (True,), None),
            ("bucket256_d160", (1, 256, 256, 32, 160), (True,),
             (torch.bfloat16,)),
            ("bucket512_d160", (1, 512, 512, 32, 160), (True,),
             (torch.bfloat16,)),
            ("bucket1024_d160", (1, 1024, 1024, 32, 160), (True,),
             (torch.bfloat16,)),
            ("sq96_sk160_d160", (2, 96, 160, 4, 160), (True, False), None),
            ("sq160_sk96_d160", (2, 160, 96, 4, 160), (True, False), None)):
        for dtype in dtypes or (torch.bfloat16, torch.float32):
            q, k, v = qkv(b, sq, sk, h, d, dtype)
            for causal in causals:
                hold(f"{case}_{'causal' if causal else 'full'}_"
                     f"{str(dtype).removeprefix('torch.')}", q, k, v, causal)
    for d, dtype in ((128, torch.bfloat16), (64, torch.bfloat16),
                     (64, torch.float32), (160, torch.bfloat16),
                     (160, torch.float32)):
        q, k, v = strided(2, 300, 8, d, dtype)
        check(not q.is_contiguous() and not k.is_contiguous(),
              "strided case made contiguous views")
        hold(f"strided_d{d}_causal_{str(dtype).removeprefix('torch.')}", q,
             k, v, True)

    # ---- timing at the engine's prefill buckets, bf16, causal ----
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, d = 1, 40, 128
    by_len = {}
    for s_ in (256, 512, 1024, 2048):
        q, k, v = qkv(b, s_, s_, h, d, torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, S, D)
        work = _flash_work(b, s_, h, d, 2)
        t = timer.ms(lambda: ops.flash_attention(q, k, v))
        by_len[s_] = {
            "kernel_ms": t,
            # cuDNN / flash SDPA on a (B, H, S, D) view: timed only, never
            # called by the port
            "library_ms": timer.ms(lambda: sdpa(qt, kt, vt, is_causal=True)),
            "tflops": work["flops"] / t / 1e9,
            "share_of_bound": work["bound_ms"] / t, **work}
    main = by_len[2048]
    q32, k32, v32 = (x.float() for x in (q, k, v))
    d160 = _flash_d160(qkv, timer)
    # host time per call at the 128-token bucket, where a prefill is
    # host-bound: the tensor-core route encodes three tensor maps a call
    s_ = 128
    q_, k_, v_ = qkv(b, s_, s_, h, d, torch.bfloat16)
    qt_, kt_, vt_ = (x.transpose(1, 2) for x in (q_, k_, v_))
    q32_, k32_, v32_ = (x.float() for x in (q_, k_, v_))
    host = {"shape": f"({b}, {s_}, {h}, {d}), causal",
            "tc_bf16": host_ms(lambda: ops.flash_attention(q_, k_, v_)),
            "scalar_f32": host_ms(
                lambda: ops.flash_attention(q32_, k32_, v32_)),
            "library_bf16": host_ms(
                lambda: sdpa(qt_, kt_, vt_, is_causal=True))}
    return {
        "shape": (f"phi3-medium-14b prefill: ({b}, 2048, {h}, {d}) bf16, "
                  "causal"),
        "max_abs_err_by_case": worst, "by_len": by_len,
        "host_ms_per_call": host,
        "kernel_ms": main["kernel_ms"],
        "plain_ms": timer.ms(lambda: ref.flash_attention_ref(q, k, v)),
        "library_ms": main["library_ms"],
        # the f32 route (the scalar kernel) at the main shape
        "f32_ms": timer.ms(lambda: ops.flash_attention(q32, k32, v32)),
        "d160": d160,
        **{key: main[key] for key in ("flops", "bytes", "ops_bound_ms",
                                      "bytes_bound_ms", "bound_ms",
                                      "bound_by", "tflops",
                                      "share_of_bound")},
    }


def _flash_d160(qkv, timer: Timer) -> dict:
    """flash_attention at stablelm-12b's head width (B 1, H 32, D 160,
    causal, bf16) timed at the engine's buckets 256..2,048 beside SDPA
    (``is_causal=True``; Hopper's SDPA takes head dims up to 256) and the
    bound; at 2,048 also the plain version and the f32 (scalar) route.
    Their unmasked pairs at 2,048 are phi3's 42.97 GFLOP, so the bound is
    the D = 128 kernel's."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, d = 1, 32, 160
    by_len = {}
    for s_ in (256, 512, 1024, 2048):
        q, k, v = qkv(b, s_, s_, h, d, torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        work = _flash_work(b, s_, h, d, 2)
        t = timer.ms(lambda: ops.flash_attention(q, k, v))
        by_len[s_] = {
            "kernel_ms": t,
            "library_ms": timer.ms(lambda: sdpa(qt, kt, vt, is_causal=True)),
            "tflops": work["flops"] / t / 1e9,
            "share_of_bound": work["bound_ms"] / t, **work}
    main = by_len[2048]
    q32, k32, v32 = (x.float() for x in (q, k, v))
    return {"shape": f"stablelm-12b prefill: ({b}, 2048, {h}, {d}) bf16, "
                     "causal",
            "route": ops.flash_route(torch.bfloat16, d),
            "by_len": by_len,
            "kernel_ms": main["kernel_ms"],
            "library_ms": main["library_ms"],
            "plain_ms": timer.ms(lambda: ref.flash_attention_ref(q, k, v)),
            "f32_ms": timer.ms(lambda: ops.flash_attention(q32, k32, v32)),
            **{key: main[key] for key in (
                "flops", "bytes", "ops_bound_ms", "bytes_bound_ms",
                "bound_ms", "bound_by", "tflops", "share_of_bound")}}


def _wkv_inputs(gen, b, s, h, e, dtype, lw_dtype=None, *, decay=(0.5, -1.0),
                bonus=0.1, state=0.1) -> list:
    """r, k, v (0.5 N), lw = -exp(a N + c), bonus and state (scaled N), as
    test_wkv_sweep draws them; r/k/v in ``dtype``, lw in ``lw_dtype``
    (default ``dtype``), bonus and state f32."""
    dev = gen.device
    rkv = [(torch.randn((b, s, h, e), generator=gen, device=dev) * 0.5)
           .to(dtype) for _ in range(3)]
    a, c = decay
    lw = -torch.exp(torch.randn((b, s, h, e), generator=gen, device=dev) * a
                    + c)
    u = torch.randn((h, e), generator=gen, device=dev) * bonus
    st = torch.randn((b, h, e, e), generator=gen, device=dev) * state
    return rkv + [lw.to(lw_dtype or dtype), u, st]


def _wkv_work(b, s, h, e, chunk, itemsize, lw_itemsize) -> tuple:
    """(bytes, FLOP) of one wkv call: r, k, v, lw read and out written
    once, bonus read, the state read and written; per (b, h) and chunk of
    n tokens, the products this data needs — the strictly lower qf kf^T and
    its product with v (n(n-1)/2 E MACs each), qf state and kdec^T v (n E^2
    each), the bonus term (2 n E) — at 2 FLOP per MAC."""
    n_el = b * s * h * e
    nbytes = n_el * (4 * itemsize + lw_itemsize) + 2 * b * h * e * e * 4 \
        + h * e * 4
    c, macs = min(chunk, s), 0
    for c0 in range(0, s, c):
        n = min(c, s - c0)
        macs += n * (n - 1) * e + 2 * n * e * e + 2 * n * e
    return nbytes, 2 * macs * b * h


def _wkv_bound(route, b, s, h, e, chunk, itemsize, lw_itemsize) -> dict:
    """The least time of one wkv call on its route: the larger of its bytes
    at the memory rate and its FLOP at the rate of the units the route's
    kernel computes on — the bf16 tensor cores (tc, 989 TFLOP/s) or the f32
    CUDA cores (scalar and step, 67 TFLOP/s)."""
    nbytes, flops = _wkv_work(b, s, h, e, chunk, itemsize, lw_itemsize)
    rate = HW.peak_flops if route == "tc" else F32_CORE_FLOPS
    t_ops, t_bytes = flops / rate * 1e3, bound_ms(nbytes)
    return {"flops": flops, "bytes": nbytes, "flop_rate": rate,
            "ops_bound_ms": t_ops, "bytes_bound_ms": t_bytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _scalar_wkv(args, chunk: int):
    """The scalar route's kernel (csrc/wkv.cu, the one kernel wkv had
    before the tc and step routes) launched directly, whatever the dtype:
    the in-call yardstick of the routes that replaced it at these shapes.
    Not counted as a launch of ops.wkv."""
    r, k, v, lw, u, st = args
    b, s, h, e = r.shape
    out = torch.empty_like(r)
    s_out = torch.empty_like(st)
    strides = [x for t in (r, k, v, lw, out) for x in t.stride()[:3]]
    err = _build.load("wkv")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
        st.data_ptr(), out.data_ptr(), s_out.data_ptr(), b, s, h, e, chunk,
        r.element_size(), lw.element_size(), *strides,
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"wkv.cu launch failed with cudaError {err}")
    return out, s_out


def _wkv_kernels(dev, gen, timer: Timer, errs: dict, cases: list) -> dict:
    """wkv against both plain versions (chunked: the kernels' own function;
    sequential: the reference's oracle) on the route ops.wkv_route gives
    each case, which its name carries: rwkv6-7b's 2,048-token prompt (bf16
    r/k/v with f32 lw as the model passes them, and with bf16 lw) and 4-slot
    decode step; the reference's sweep in f32 and bf16; chunk 1/16/20/48/64
    at E = 64; ragged S 2,047 and 100; a strided (B, H, S, E)-laid view; the
    step route at B 1 and 4; a tc prefill continued by 8 step-route tokens
    from its final state, against the sequential version over all of them;
    chunk 16 against 48; and clamped cases (chunk * |lw| > 80, f32 and bf16)
    held against the chunked version only, where the sequential recurrence
    differs. A misaligned view must raise on the tc route. Times of each
    route at the shape the main path gives it, beside the scalar kernel's
    (csrc/wkv.cu) at the same shape."""
    worst = {}

    def hold(name, got, want, tol, route):
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"wkv/{name}: {g.dtype}{tuple(g.shape)} vs "
                  f"{w.dtype}{tuple(w.shape)}")
            diff = (g.float() - w.float()).abs()
            bad = diff > tol + tol * w.float().abs()
            err = max(err, float(diff.max()))
            check(not bool(bad.any()) and bool(torch.isfinite(g).all()),
                  f"wkv/{name}: {int(bad.sum())} elements outside {tol} "
                  f"(max abs err {float(diff.max())})")
        errs[WKV_ROWS[route]] = max(errs[WKV_ROWS[route]], err)
        worst[name] = err
        cases.append(f"wkv/{name}")

    def run(case, args, chunk, sequential=True):
        """ops.wkv on ``args`` against the chunked (and sequential) plain
        version; the case's name gets its dtype and route."""
        r, lw = args[0], args[3]
        route = ops.wkv_route(r.dtype, r.shape[3], r.shape[1])
        tol = WKV_TOL[r.dtype]
        lw_name = ("" if lw.dtype == r.dtype else
                   "_lw_" + str(lw.dtype).removeprefix("torch."))
        name = (f"{case}_{str(r.dtype).removeprefix('torch.')}{lw_name}"
                f"_{route}")
        got = ops.wkv(*args, chunk=chunk)
        hold(f"{name}_vs_chunked", got,
             ref.wkv_chunked_ref(*args, chunk=chunk), tol, route)
        if sequential:
            hold(f"{name}_vs_sequential", got, ref.wkv_ref(*args), tol,
                 route)
        return got

    h, e = get_config(RWKV).n_heads, get_config(RWKV).head_dim
    bf16, f32 = torch.bfloat16, torch.float32
    # the model's shapes, and a rank's of them on rwkv6's (1, 2) serve mesh
    # (mesh_card_toy: 32 of the 64 heads; its device steps take the step
    # route, its 2,048-token prefill the tc route)
    shapes = {"prefill": (1, RWKV_PREFILL, h, e, 32),
              "decode": (SERVE_BATCH, 1, h, e, 32),
              "mesh_prefill_h32": (1, RWKV_PREFILL, h // 2, e, 32),
              "mesh_decode_h32": (SERVE_BATCH, 1, h // 2, e, 32),
              "sweep_e16_c16": (1, 64, 2, 16, 16),
              "sweep_e32_c32": (2, 100, 3, 32, 32),
              "sweep_e64_c32": (1, 31, 1, 64, 32)}
    for case, (b, s_, hh, ee, chunk) in shapes.items():
        for dtype in (bf16, f32):
            model_shape = case in ("prefill", "decode", "mesh_prefill_h32",
                                   "mesh_decode_h32")
            run(case, _wkv_inputs(gen, b, s_, hh, ee, dtype,
                                  f32 if model_shape else dtype), chunk)
    # the tc route: bf16 lw at the prompt, every chunk size, ragged lengths
    run("prefill", _wkv_inputs(gen, 1, RWKV_PREFILL, h, e, bf16, bf16), 32)
    for chunk in (16, 48, 64):
        run(f"chunk{chunk}", _wkv_inputs(gen, 2, 300, 4, 64, bf16, f32),
            chunk)
    # chunks that are not a multiple of the 16-row tile
    for chunk in (1, 20):
        run(f"chunk{chunk}", _wkv_inputs(gen, 2, 150, 4, 64, bf16, f32),
            chunk)
    run("ragged_s2047", _wkv_inputs(gen, 1, 2047, 8, 64, bf16, f32), 32)
    run("ragged_s100", _wkv_inputs(gen, 2, 100, 4, 64, bf16, f32), 32)
    # a view laid out (B, H, S, E), as strided in s and h as it gets
    args = _wkv_inputs(gen, 2, 200, 4, 64, bf16, f32)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in args[:4]]
    check(not views[0].is_contiguous(), "the strided case is contiguous")
    got = run("strided", views + args[4:], 32)
    want = ops.wkv(*args, chunk=32)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "wkv/strided: a strided view and its contiguous copy differ")
    # a rank's heads as a view of the whole model's (the 32 heads from 32
    # of a 64-head tensor: strided in s and b, offset by 32 heads) on the
    # step and tc routes, against the plain versions and bit for bit its
    # contiguous copy
    for s_ in (1, RWKV_PREFILL):
        args = _wkv_inputs(gen, SERVE_BATCH if s_ == 1 else 1, s_, h, e,
                           bf16, f32)
        views = [t[:, :, h // 2:] for t in args[:4]]
        check(not views[0].is_contiguous(), "the head slice is contiguous")
        rest = [args[4][h // 2:].contiguous(),
                args[5][:, h // 2:].contiguous()]
        got = run(f"head_slice_s{s_}", views + rest, 32)
        want = ops.wkv(*[t.contiguous() for t in views], *rest, chunk=32)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"wkv/head_slice_s{s_}: the head-sliced view and its "
              "contiguous copy differ")
    # the step route at B 1 and 4 (decode above) in both dtypes
    for dtype in (bf16, f32):
        run("step_b1", _wkv_inputs(gen, 1, 1, h, e, dtype, f32), 32)
    # a tc prefill continued by 8 step-route tokens from its final state
    args = _wkv_inputs(gen, 1, 308, 8, 64, bf16, f32)
    o, st = ops.wkv(*[t[:, :300] for t in args[:4]], *args[4:], chunk=32)
    outs = [o]
    for t in range(300, 308):
        o, st = ops.wkv(*[x[:, t:t + 1] for x in args[:4]], args[4], st)
        outs.append(o)
    hold("continuity_tc_then_8_step_bf16_vs_sequential",
         (torch.cat(outs, dim=1), st), ref.wkv_ref(*args), WKV_TOL[bf16],
         "step")
    # chunk invariance and the clamped cases (the chunked version only)
    args = _wkv_inputs(gen, 1, 96, 2, 16, f32, decay=(1.0, -1.5),
                       bonus=0.0, state=0.0)
    o16 = ops.wkv(*args, chunk=16)
    hold("chunk16_vs_chunk48_float32_scalar", o16, ops.wkv(*args, chunk=48),
         1e-4, "scalar")
    hold("chunk16_vs_chunked_float32_scalar", o16,
         ref.wkv_chunked_ref(*args, chunk=16), 1e-4, "scalar")
    seq_gap = {}
    for dtype in (f32, bf16):
        args = _wkv_inputs(gen, 1, 96, 4, 64, dtype, f32, decay=(0.1, 1.1),
                           bonus=0.2)
        check(float(-args[3][:, :32].sum(dim=1).min()) > 80,
              "the clamped case does not reach chunk * |lw| > 80")
        got = run("clamped", args, 32, sequential=False)
        seq_gap[str(dtype)] = float(
            (got[0].float() - ref.wkv_ref(*args)[0].float()).abs().max())
        check(seq_gap[str(dtype)] > 1e-1,
              f"clamped case: the sequential recurrence is only "
              f"{seq_gap[str(dtype)]} away, the clamps do not bite")
    # the tc route refuses a view its TMA maps cannot take
    args = _wkv_inputs(gen, 1, 64, 2, 64, bf16, f32)
    flat = torch.empty(args[0].numel() + 1, dtype=bf16, device=dev)
    odd = flat[1:].view(args[0].shape)
    try:
        ops.wkv(odd, *args[1:], chunk=32)
        check(False, "wkv/tc took a base pointer 2 bytes off alignment")
    except ValueError:
        cases.append("wkv/misaligned_bfloat16_tc_raises")

    res = {"wkv_max_abs_err_by_case": worst,
           "wkv_clamped_vs_sequential": seq_gap}
    timed = {"wkv_tc": ("prefill", (1, RWKV_PREFILL, h, e, 32), bf16, f32),
             "wkv_step": ("decode", (SERVE_BATCH, 1, h, e, 32), bf16, f32),
             "wkv": ("prefill", (1, RWKV_PREFILL, h, e, 32), f32, f32)}
    # a rank's shape on mesh_card_toy's (1, 2) mesh, beside each route's
    mesh_timed = {"wkv_tc": (1, RWKV_PREFILL, h // 2, e, 32),
                  "wkv_step": (SERVE_BATCH, 1, h // 2, e, 32)}
    for row, (b, s_, hh, ee, chunk) in mesh_timed.items():
        args = _wkv_inputs(gen, b, s_, hh, ee, bf16, f32)
        route = ops.wkv_route(bf16, ee, s_)
        res[f"{row}_mesh_h32"] = {
            "shape": f"{RWKV} on (1, 2), a rank's heads: ({b}, {s_}, {hh}, "
                     f"{ee}) bfloat16 r/k/v, float32 lw, chunk {chunk}; "
                     f"route {route}",
            "kernel_ms": timer.ms(lambda: ops.wkv(*args, chunk=chunk)),
            "plain_ms": timer.ms(
                lambda: ref.wkv_chunked_ref(*args, chunk=chunk), 10),
            **_wkv_bound(route, b, s_, hh, ee, chunk, 2, 4)}
    for row, (case, (b, s_, hh, ee, chunk), dtype, lw_dtype) in timed.items():
        args = _wkv_inputs(gen, b, s_, hh, ee, dtype, lw_dtype)
        route = ops.wkv_route(dtype, ee, s_)
        item = torch.tensor([], dtype=dtype).element_size()
        res[row] = {
            "shape": f"{RWKV} {case}: ({b}, {s_}, {hh}, {ee}) "
                     f"{str(dtype).removeprefix('torch.')} r/k/v, "
                     f"{str(lw_dtype).removeprefix('torch.')} lw, chunk "
                     f"{chunk}; route {route}",
            "kernel_ms": timer.ms(lambda: ops.wkv(*args, chunk=chunk)),
            "plain_ms": timer.ms(
                lambda: ref.wkv_chunked_ref(*args, chunk=chunk), 10),
            "library_ms": None,        # no single PyTorch call computes WKV
            "host_ms_per_call": host_ms(lambda: ops.wkv(*args, chunk=chunk)),
            **_wkv_bound(route, b, s_, hh, ee, chunk, item, 4)}
        if route != "scalar":
            # the scalar kernel at the same shape, in the same call
            res[row]["scalar_kernel_ms"] = timer.ms(
                lambda: _scalar_wkv(args, chunk))
    return res


def phase_parity() -> None:
    """Reduced parallax-lm at f32 on the CPU and on the card, the default
    RunConfig and local_agg=False (the no-LA ablation: the raw token stream
    is pushed through the plain accumulating scatter on both devices)."""
    cfg = reduced(get_config("parallax-lm"))
    shape = ShapeConfig("parity", 16, 4, "train")
    ds = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch)
    out = {}
    for name, la in (("local_agg", True), ("no_local_agg", False)):
        rc = RunConfig(param_dtype="float32", compute_dtype="float32",
                       local_agg=la)
        cpu = get_runner(cfg, shape, rc, seed=0, device="cpu")
        params = {k: p.detach().clone()
                  for k, p in named_parameters(cpu.model).items()}
        gpu = get_runner(cfg, shape, rc, device="cuda",
                         params={k: p.to("cuda") for k, p in params.items()})
        rows = []
        ops.reset_launch_counts()
        for i in range(3):
            b = ds.batch(i)
            mc, mg = cpu.run(b), gpu.run(b)
            lc, lg = float(mc["loss"]), float(mg["loss"])
            check(math.isclose(lc, lg, rel_tol=1e-4),
                  f"{name} step {i}: cpu loss {lc} vs card {lg}")
            for k in ("embed_rows", "embed_unique", "embed_dropped"):
                check(float(mc[k]) == float(mg[k]),
                      f"{name} step {i}: {k} cpu {float(mc[k])} vs card "
                      f"{float(mg[k])}")
            rows.append({"cpu": lc, "cuda": lg, "rel": abs(lc - lg) / abs(lc),
                         "embed_unique": float(mg["embed_unique"])})
        counts = ops.launch_counts()
        want = 3 if la else 0      # no-LA pushes through the plain scatter
        check(counts["embed_scatter_add"] == want
              and counts["embed_gather"] == 3,
              f"{name}: launches {counts}")
        out[name] = rows
    out["nmt"] = _nmt_parity()
    emit({"phase": "parity", **out})


def _nmt_parity() -> list:
    """Reduced parallax-nmt at f32, CPU against card, 3 steps: each step
    pulls and pushes both tables through the kernels on the card."""
    cfg = reduced(get_config("parallax-nmt"))
    shape = ShapeConfig("parity", 16, 4, "train")
    ds = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch,
                     is_encdec=True, src_zipf_a=0.0)
    rc = RunConfig(param_dtype="float32", compute_dtype="float32")
    cpu = get_runner(cfg, shape, rc, seed=0, device="cpu")
    gpu = get_runner(cfg, shape, rc, device="cuda", params={
        k: p.detach().to("cuda") for k, p in named_parameters(
            cpu.model).items()})
    rows = []
    ops.reset_launch_counts()
    for i in range(3):
        b = ds.batch(i)
        mc, mg = cpu.run(b), gpu.run(b)
        lc, lg = float(mc["loss"]), float(mg["loss"])
        check(math.isclose(lc, lg, rel_tol=1e-4),
              f"nmt step {i}: cpu loss {lc} vs card {lg}")
        for k in NMT_CENSUS:
            check(float(mc[k]) == float(mg[k]),
                  f"nmt step {i}: {k} cpu {float(mc[k])} vs card "
                  f"{float(mg[k])}")
        rows.append({"cpu": lc, "cuda": lg, "rel": abs(lc - lg) / abs(lc),
                     **{k: float(mg[k]) for k in NMT_CENSUS
                        if k.endswith("_unique")}})
    counts = ops.launch_counts()
    check(counts["embed_gather"] == 6 and counts["embed_scatter_add"] == 6,
          f"nmt parity: launches {counts}, want 2 gathers and 2 scatters "
          "a step")
    return rows


def _prompts(rng, lens, vocab: int) -> list:
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in lens]


def _serve_prompts(rng, vocab: int, n: int = 8) -> tuple:
    """The serve phase's traffic: ``n`` prompts of 200..1800 tokens."""
    lens = rng.integers(200, 1801, size=n)
    return lens, _prompts(rng, lens, vocab)


def _drain(sv, prompts, new: int) -> dict:
    """Submit ``prompts`` to a Server or ToyServer and serve them all."""
    for i, p in enumerate(prompts):
        sv.submit(Request(i, p, max_new_tokens=new))
    done = sv.run_until_drained()
    return {r.uid: r for r in done}


def phase_serve_parity() -> None:
    """Reduced phi3-medium-14b at f32 on the CPU and on the card, the same
    parameters and prompts, attention through flash_attention."""
    cfg = reduced(get_config("phi3-medium-14b"))
    rc = RunConfig(attention_impl="pallas", param_dtype="float32",
                   compute_dtype="float32")
    scfg = ServerConfig(max_batch=2, max_seq=64)
    cpu = Server(cfg, rc, scfg, seed=0, device="cpu")
    gpu = Server(cfg, rc, scfg, device="cuda",
                 params={k: p.to("cuda") for k, p in cpu.params.items()})
    prompts = _prompts(np.random.default_rng(0), (5, 23, 40, 11),
                       cfg.vocab_size)
    logit_diff = logit_max = 0.0
    for p in prompts:
        lb = bucket_len(len(p), scfg.max_seq)
        toks = np.zeros((1, lb), np.int32)
        toks[0, :len(p)] = p
        lc, _ = cpu.model.prefill_cache_fn(torch.from_numpy(toks))
        lg, _ = gpu.model.prefill_cache_fn(torch.from_numpy(toks).cuda())
        lg = lg.cpu()
        check(torch.allclose(lg, lc, rtol=1e-4, atol=1e-5),
              f"prefill logits (prompt {len(p)}): max abs diff "
              f"{float((lg - lc).abs().max())}")
        logit_diff = max(logit_diff, float((lg - lc).abs().max()))
        logit_max = max(logit_max, float(lc.abs().max()))
    ops.reset_launch_counts()
    got = _drain(gpu, prompts, 8)
    flash = ops.launch_counts()["flash_attention"]
    want = _drain(cpu, prompts, 8)
    cpu.close()
    gpu.close()
    check(flash == cfg.n_layers * gpu.stats["prefill_calls"],
          f"flash_attention launched {flash} times in "
          f"{gpu.stats['prefill_calls']} prefills")
    diffs = [(u, i, a, b) for u in want
             for i, (a, b) in enumerate(zip(got[u].out_tokens,
                                            want[u].out_tokens)) if a != b]
    check(all(len(got[u].out_tokens) == len(want[u].out_tokens) == 8
              for u in want), "a request did not complete on both devices")
    check(len(diffs) <= 2, f"greedy tokens differ at {diffs}")
    emit({"phase": "serve_parity", "prompts": [len(p) for p in prompts],
          "max_abs_logit_diff": logit_diff, "max_abs_logit": logit_max,
          "token_diffs": diffs,
          "tokens": {u: r.out_tokens for u, r in got.items()},
          "flash_launches": flash})


def _draw_rwkv_params(params: dict, seed: int = 0) -> None:
    """Draw the parameters that rwkv6's seeded init leaves constant
    (RWKV_DRAWN), in place, from a CPU generator, so the same values land
    on every device."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in params.items():
            for suffix, (scale, offset) in RWKV_DRAWN.items():
                if name.endswith(suffix):
                    x = torch.randn(p.shape, generator=gen) * scale + offset
                    p.copy_(x.to(p.dtype))


def _scaled_close(got, want, tol: float, what: str, rtol: float = 0.0
                  ) -> float:
    """|got - want| <= tol * max|want| + rtol * |want| elementwise; returns
    the max abs difference."""
    got, want = got.float().cpu(), want.float().cpu()
    diff = (got - want).abs()
    scale = float(want.abs().max()) or 1.0
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    check(bool((diff <= tol * scale + rtol * want.abs()).all()),
          f"{what}: max abs diff {float(diff.max())} at scale {scale}")
    return float(diff.max())


def phase_rwkv_parity() -> None:
    """Reduced rwkv6-7b at f32 on the CPU and on the card, the same
    parameters: the prefill step's logits and final carry, then ToyServer's
    greedy tokens."""
    cfg = reduced(get_config(RWKV))
    rc = RunConfig(param_dtype="float32", compute_dtype="float32")
    scfg = ServerConfig(max_batch=2, max_seq=64)
    cpu = ToyServer(cfg, rc, scfg, seed=0, device="cpu")
    _draw_rwkv_params(cpu.params)
    gpu = ToyServer(cfg, rc, scfg, device="cuda",
                    params={k: p.to("cuda") for k, p in cpu.params.items()})
    prompts = _prompts(np.random.default_rng(0), (5, 23, 40, 11),
                       cfg.vocab_size)
    diffs = {}
    for n in (1, 40, 70):
        toks = torch.from_numpy(np.random.default_rng(n).integers(
            0, cfg.vocab_size, (2, n)).astype(np.int32))
        lc, cc = make_prefill_step(cpu.model, cpu.rt, cpu.plan)(
            {"tokens": toks})
        lg, cg = make_prefill_step(gpu.model, gpu.rt, gpu.plan)(
            {"tokens": toks.cuda()})
        diffs[n] = [_scaled_close(g, c, 1e-4, f"prefill {what} ({n})",
                                  rtol=1e-4)
                    for what, g, c in zip(("logits", "tm_x", "state", "cm_x"),
                                          (lg, *cg), (lc, *cc))]
    ops.reset_launch_counts()
    got = _drain(gpu, prompts, 8)
    wkv_launches = ops.launch_counts()["wkv"]
    want = _drain(cpu, prompts, 8)
    steps = gpu.stats["decode_steps"] + sum(len(p) - 1 for p in prompts)
    check(wkv_launches == cfg.n_layers * steps,
          f"wkv launched {wkv_launches} times in {steps} device steps")
    token_diffs = [(u, i, a, b) for u in want
                   for i, (a, b) in enumerate(zip(got[u].out_tokens,
                                                  want[u].out_tokens))
                   if a != b]
    check(all(len(got[u].out_tokens) == len(want[u].out_tokens) == 8
              for u in want), "a request did not complete on both devices")
    check(len(token_diffs) <= 2, f"greedy tokens differ at {token_diffs}")
    emit({"phase": "rwkv_parity", "prefill_max_abs_diffs": diffs,
          "prompts": [len(p) for p in prompts], "token_diffs": token_diffs,
          "tokens": {u: r.out_tokens for u, r in got.items()},
          "wkv_launches": wkv_launches, "device_steps": steps})


def _dense_batches(steps: int, vocab: int = 0, seq: int = 0,
                   batch: int = 0) -> list:
    """Batches of dense_train's cell's data options (Zipf(1.3) tokens;
    SyntheticLM, seed 0); by default its own, over phi3's vocab."""
    ds = SyntheticLM(vocab or get_config(DENSE_ARCH).vocab_size,
                     seq or DENSE.shape.seq_len,
                     batch or DENSE.shape.global_batch, **DENSE.data)
    return [ds.batch(i) for i in range(steps)]


def phase_dense_parity() -> dict:
    """Reduced phi3 and reduced command-r (tied embeddings) at f32, the
    same parameters and batches, 3 steps on the CPU and on the card under
    naive and chunked attention (chunk 8 of 32 positions): losses within
    rtol 1e-4 (GEMM summation order differs on the card), the embed_*
    census equal, one gather and one one-pass scatter a step. Then reduced
    phi3 at bf16 under remat none, block and full on the card: equal
    losses."""
    shape = ShapeConfig("parity", 32, 4, "train")
    out, total = {}, None
    for arch in (DENSE_ARCH, "command-r-35b"):
        cfg = reduced(get_config(arch))
        batches = _dense_batches(3, cfg.vocab_size, 32, 4)
        for impl in ("naive", "chunked"):
            rc = RunConfig(**DENSE_F32, attention_impl=impl,
                           attention_chunk=8)
            cpu = get_runner(cfg, shape, rc, seed=0, device="cpu")
            gpu = get_runner(cfg, shape, rc, device="cuda", params={
                k: p.detach().to("cuda") for k, p in named_parameters(
                    cpu.model).items()})
            rows = []
            ops.reset_launch_counts()
            for i, b in enumerate(batches):
                mc, mg = cpu.run(b), gpu.run(b)
                lc, lg = float(mc["loss"]), float(mg["loss"])
                check(math.isclose(lc, lg, rel_tol=1e-4),
                      f"dense_parity {arch} {impl} step {i}: cpu loss {lc} "
                      f"vs card {lg}")
                for k in CENSUS:
                    check(float(mc[k]) == float(mg[k]),
                          f"dense_parity {arch} {impl} step {i}: {k} cpu "
                          f"{float(mc[k])} vs card {float(mg[k])}")
                rows.append({"cpu": lc, "cuda": lg,
                             "rel": abs(lc - lg) / abs(lc)})
            counts = ops.launch_counts()
            check(counts["embed_gather"] == counts["embed_gather_bulk"] == 3
                  and counts["embed_scatter_add"] == 3
                  and counts["embed_scatter_add_fused"] == 3,
                  f"dense_parity {arch} {impl}: launches {counts}")
            total = counts if total is None else {
                k: total[k] + v for k, v in counts.items()}
            out[f"{arch}/{impl}"] = rows
    # RunConfig.remat on the card: reduced phi3 at the default bf16 (chunked
    # attention) from the same parameters under none, block and full, with
    # deterministic algorithms (index_add_'s atomics aside, a recompute
    # reruns the same kernels): the losses bit for bit
    cfg = reduced(get_config(DENSE_ARCH))
    batches = _dense_batches(3, cfg.vocab_size, 32, 4)
    params = None
    remat = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for mode in ("none", "block", "full"):
            r = get_runner(cfg, shape, RunConfig(remat=mode), device="cuda",
                           seed=0, params=params)
            if params is None:
                params = {k: p.detach().clone() for k, p in
                          named_parameters(r.model).items()}
            ops.reset_launch_counts()
            remat[mode] = [float(r.run(b)["loss"]) for b in batches]
            counts = ops.launch_counts()
            total = {k: total[k] + v for k, v in counts.items()}
    finally:
        torch.use_deterministic_algorithms(False)
    check(remat["block"] == remat["none"] == remat["full"],
          f"dense_parity remat: {remat}")
    res = {"phase": "dense_parity", **out, "remat_bf16": remat,
           "launches": total}
    emit(res)
    return res


def phase_rwkv_recurrence(dev, n_tokens: int = 300) -> None:
    """rwkv6-7b at full width (d 4,096, 64 heads of 64), n_layers cut to 2
    so it runs in f32: the chunked prefill over one prompt and one-token
    decode steps over the same prompt compute one recurrence."""
    cfg = replace(get_config(RWKV), n_layers=2)
    rc = RunConfig(param_dtype="float32", compute_dtype="float32")
    rt = Runtime(cfg, rc, ShapeConfig("recurrence", n_tokens, 1, "decode"),
                 device=dev)
    model = build_model(cfg, rt)
    rt.plan = analyze(model, rt)
    init_params_(model, 0)
    model.requires_grad_(False)
    _draw_rwkv_params(named_parameters(model))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, n_tokens)).astype(np.int32)).to(dev)
    ops.reset_launch_counts()
    logits, carry = make_prefill_step(model, rt, rt.plan)({"tokens": toks})
    check(ops.launch_counts()["wkv"] == cfg.n_layers,
          f"prefill launched wkv {ops.launch_counts()['wkv']} times")
    cache = model.init_cache(1, n_tokens)
    step = make_decode_step(model, rt, rt.plan)
    for t in range(n_tokens):
        last, cache = step(cache, toks[:, t:t + 1], t)
    torch.cuda.synchronize()
    diffs = {"last_logits": _scaled_close(last[:, 0], logits[:, -1], 1e-4,
                                          "last logits")}
    for name, a, b in zip(("tm_x", "state", "cm_x"), carry, cache):
        for i in range(cfg.n_layers):
            diffs[f"{name}_{i}"] = _scaled_close(b[i], a[i], 1e-4,
                                                 f"layer {i} {name}")
    emit({"phase": "rwkv_recurrence", "tokens": n_tokens,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "max_abs_diffs": diffs,
          "logit_scale": float(logits[:, -1].abs().max())})


def phase_serve(dev, n_requests: int = 8, new: int = 16,
                arch: str = "phi3-medium-14b", phase: str = "serve") -> dict:
    """Full-width ``arch`` served on the card through the paged engine, bf16
    and attention "pallas": phi3-medium-14b (``serve``), stablelm-12b
    (``stablelm_serve``, its 160-wide heads on flash's tensor-core
    route), or the moe family at its published width with the layers cut
    to ``SERVE_LAYERS`` (``grok_serve``, ``llama4_serve``). Every prefill
    launches flash once a layer on the tc route; the peak memory at init
    and at serve stays under PEAK_LIMIT."""
    cfg = serve_config(arch)
    scfg = ServerConfig(max_batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sv = Server(cfg, RunConfig(attention_impl="pallas"), scfg, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    check(sv.rt.device.type == "cuda", f"served on {sv.rt.device}")
    rng = np.random.default_rng(0)
    lens, prompts = _serve_prompts(rng, cfg.vocab_size, n_requests)
    # the first call of each GEMM shape pays cuBLAS's heuristics: one short
    # request first, outside the counted run
    _drain(sv, _prompts(rng, (100,), cfg.vocab_size), 2)
    before = {k: sv.stats[k] for k in ("prefill_calls", "decode_steps")}
    sv.completed.clear()
    torch.cuda.reset_peak_memory_stats(dev)

    ops.reset_launch_counts()
    t = time.perf_counter()
    done = _drain(sv, prompts, new)
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    flash_tc = ops.flash_attention.launches_tc

    prefills = sv.stats["prefill_calls"] - before["prefill_calls"]
    steps = sv.stats["decode_steps"] - before["decode_steps"]
    serve_peak = torch.cuda.max_memory_allocated(dev)
    check(len(done) == n_requests, f"{len(done)} of {n_requests} completed")
    check(all(len(r.out_tokens) == new for r in done.values()),
          f"token counts {[len(r.out_tokens) for r in done.values()]}")
    check(sv.stats["cross_slot_mismatches"] == 0,
          f"{sv.stats['cross_slot_mismatches']} cross-slot mismatches")
    check(counts["flash_attention"] == cfg.n_layers * prefills,
          f"flash_attention launched {counts['flash_attention']} times in "
          f"{prefills} prefills")
    check(flash_tc == counts["flash_attention"],
          f"{counts['flash_attention'] - flash_tc} of "
          f"{counts['flash_attention']} prefill launches of flash_attention "
          "missed the tensor-core route")
    check(counts["embed_gather"] == prefills + steps,
          f"embed_gather launched {counts['embed_gather']} times in "
          f"{prefills} prefills + {steps} decode steps")
    check(counts["embed_gather_bulk"] == counts["embed_gather"],
          f"{counts['embed_gather'] - counts['embed_gather_bulk']} of "
          f"{counts['embed_gather']} gathers missed the bulk route")
    check(max(init_peak, serve_peak) < PEAK_LIMIT,
          f"{phase}: peak {init_peak} at init, {serve_peak} serving")
    ttft = sorted(r.ttft for r in done.values())
    # decode over the counted window: every token after a request's first
    # comes from a decode step, with later requests' prefills interleaved
    tokens = sum(len(r.out_tokens) for r in done.values())
    window_s = (max(r.token_times[-1] for r in done.values())
                - min(r.t_first for r in done.values()))
    gaps = sorted(b - a for r in done.values()
                  for a, b in zip(r.token_times, r.token_times[1:]))

    # device times of one prefill per bucket and of one synthetic decode
    # step over the full batch at lens 1024, on the engine's own steps
    # (after the counted run)
    timer = Timer(dev)
    prefill_ms = {}
    for lb in sorted(sv.stats["buckets"]):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, lb))
                                .astype(np.int32)).to(dev)
        prefill_ms[lb] = timer.ms(lambda: sv._prefill(
            sv.cache, sv.lens, sv.tok, toks, lb, 0, sv._gen), 3)
    active = torch.ones(scfg.max_batch, dtype=torch.bool, device=dev)
    sv.lens.fill_(1024)
    decode_ms = timer.ms(lambda: sv._decode(sv.cache, sv.lens, sv.tok,
                                             active, sv._gen), 10)
    moe = _moe_serve_numbers(sv, cfg, rng, decode_ms) \
        if cfg.family == "moe" else {}
    forced = _teacher_forced(sv, dict(enumerate(prompts)),
                             {u: r.out_tokens for u, r in done.items()},
                             keep=True) if phase == "serve" else None
    sv.close()
    res = {"phase": phase, "arch": cfg.name, "requests": n_requests,
           "n_layers": cfg.n_layers, **moe,
           "flash_route": ops.flash_route(sv.rt.dtype, cfg.head_dim),
           "prompt_lens": [int(x) for x in lens],
           "buckets": sorted(sv.stats["buckets"]),
           "prefill_calls": prefills, "decode_steps": steps,
           "launches": counts, "flash_attention_launches_tc": flash_tc,
           "ttft_ms_p50": ttft[len(ttft) // 2] * 1e3,
           "ttft_ms_max": ttft[-1] * 1e3,
           "prefill_ms_by_bucket": prefill_ms,
           "decode_step_ms_median": decode_ms,
           "decode_step_tokens_per_s": scfg.max_batch / (decode_ms / 1e3),
           "window_decode_tokens": tokens - n_requests,
           "window_decode_s": window_s,
           "window_decode_tokens_per_s": (tokens - n_requests) / window_s,
           "itl_ms_p50": gaps[len(gaps) // 2] * 1e3,
           "itl_ms_max": gaps[-1] * 1e3,
           "run_s": wall, "run_tokens_per_s": tokens / wall,
           "setup_s": setup_s, "init_peak_bytes": init_peak,
           "max_memory_allocated": serve_peak,
           "first_tokens": {u: r.out_tokens[:4] for u, r in done.items()},
           "teacher_forced": forced and {
               k: v for k, v in forced.items() if k != "logits"},
           "nvidia_smi": nvidia_smi(
               "clocks.sm,power.draw,power.limit,temperature.gpu")}
    emit(res)
    res["tokens"] = {u: list(r.out_tokens) for u, r in done.items()}
    res["teacher_forced_logits"] = forced and forced["logits"]
    return res


def _moe_serve_numbers(sv, cfg, rng, decode_ms: float) -> dict:
    """A moe serve path's routing and its decode step beside its byte
    floor. ``moe_dropped`` of one 2,048-token prefill (summed over the
    layers; the engine's prefill step does not return it). The floor: every
    weight but the embedding table read once over the card's memory rate —
    the dispatch computes every expert at a capacity of at least 4 slots,
    so a decode step reads every expert."""
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (1, SERVE_MAX_SEQ))
                            .astype(np.int32)).to(sv.rt.device)
    _, _, met = sv.model.prefill_fn({"tokens": toks})
    weights = sum(p.numel() * p.element_size()
                  for n, p in sv.params.items() if n != "embed")
    floor = bound_ms(weights)
    return {"cut": f"n_layers {cfg.n_layers} of "
                   f"{get_config(cfg.name).n_layers}",
            "params": sum(p.numel() for p in sv.params.values()),
            "moe_dropped_prefill_2048": int(met["moe_dropped"]),
            "moe_aux_prefill_2048": float(met["moe_aux"]),
            "decode_floor_bytes": weights, "decode_floor_ms": floor,
            "decode_share_of_floor": floor / decode_ms}


def phase_rwkv_serve(dev, n_requests: int = 8, new: int = 16) -> dict:
    """Full-width rwkv6-7b served on the card through ToyServer."""
    cfg = get_config(RWKV)
    scfg = ServerConfig(max_batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sv = ToyServer(cfg, RunConfig(), scfg, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    check(sv.rt.device.type == "cuda", f"served on {sv.rt.device}")
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 65, size=n_requests)
    prompts = _prompts(rng, lens, cfg.vocab_size)
    # the first call of each GEMM shape pays cuBLAS's heuristics: one short
    # request first, outside the counted run
    _drain(sv, _prompts(rng, (4,), cfg.vocab_size), 2)
    before = sv.stats["decode_steps"]
    sv.completed.clear()
    torch.cuda.reset_peak_memory_stats(dev)

    ops.reset_launch_counts()
    t = time.perf_counter()
    done = _drain(sv, prompts, new)
    wall = time.perf_counter() - t
    counts = ops.launch_counts()

    steps = sv.stats["decode_steps"] - before
    device_steps = steps + sum(len(p) - 1 for p in prompts)
    serve_peak = torch.cuda.max_memory_allocated(dev)
    check(len(done) == n_requests, f"{len(done)} of {n_requests} completed")
    check(all(len(r.out_tokens) == new for r in done.values()),
          f"token counts {[len(r.out_tokens) for r in done.values()]}")
    check(counts["wkv"] == cfg.n_layers * device_steps,
          f"wkv launched {counts['wkv']} times in {device_steps} device "
          "steps")
    check(counts["wkv_step"] == counts["wkv"],
          f"{counts['wkv'] - counts['wkv_step']} of {counts['wkv']} wkv "
          "launches of the serve loop missed the step route")
    check(counts["embed_gather"] == device_steps,
          f"embed_gather launched {counts['embed_gather']} times in "
          f"{device_steps} device steps")
    check(counts["embed_gather_bulk"] == counts["embed_gather"],
          f"{counts['embed_gather'] - counts['embed_gather_bulk']} of "
          f"{counts['embed_gather']} gathers missed the bulk route")
    check(max(init_peak, serve_peak) < PEAK_LIMIT,
          f"rwkv_serve: peak {init_peak} at init, {serve_peak} serving")
    ttft = sorted(r.ttft for r in done.values())
    tokens = sum(len(r.out_tokens) for r in done.values())
    window_s = (max(r.token_times[-1] for r in done.values())
                - min(r.t_first for r in done.values()))
    gaps = sorted(b - a for r in done.values()
                  for a, b in zip(r.token_times, r.token_times[1:]))

    # device times of one decode step over the 4 slots and of one
    # 2,048-token prefill (after the counted run)
    timer = Timer(dev)
    step_toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        SERVE_BATCH, 1)).astype(np.int32)).to(dev)
    decode_ms = timer.ms(lambda: sv.decode_step(sv.cache, step_toks, 0), 10)
    prefill = make_prefill_step(sv.model, sv.rt, sv.plan)
    ptoks = torch.from_numpy(_rwkv_prompt(cfg.vocab_size)).to(dev)
    ops.reset_launch_counts()
    logits, carry = prefill({"tokens": ptoks})
    torch.cuda.synchronize()
    prefill_counts = ops.launch_counts()
    check(prefill_counts["wkv"] == cfg.n_layers
          and prefill_counts["wkv_tc"] == cfg.n_layers,
          f"a {RWKV_PREFILL}-token prefill launched wkv "
          f"{prefill_counts['wkv']} times, {prefill_counts['wkv_tc']} on "
          "the tensor-core route")
    check(prefill_counts["embed_gather"] == 1
          and prefill_counts["embed_gather_bulk"] == 1,
          f"a {RWKV_PREFILL}-token prefill gathered "
          f"{prefill_counts['embed_gather']} times, "
          f"{prefill_counts['embed_gather_bulk']} on the bulk route")
    check(tuple(logits.shape) == (1, RWKV_PREFILL, cfg.vocab_size)
          and bool(torch.isfinite(logits).all())
          and all(bool(torch.isfinite(c).all()) for c in carry),
          "prefill logits or carry not finite, or of the wrong shape")
    del logits, carry
    prefill_ms = timer.ms(lambda: prefill({"tokens": ptoks}), 3)
    res = {"phase": "rwkv_serve", "arch": cfg.name, "requests": n_requests,
           "prompt_lens": [int(x) for x in lens],
           "decode_steps": steps, "device_steps": device_steps,
           # the path's launches: the serve loop's and the prefill's
           "launches": {k: counts[k] + prefill_counts[k] for k in counts},
           "serve_loop_launches": counts,
           "ttft_ms_p50": ttft[len(ttft) // 2] * 1e3,
           "ttft_ms_max": ttft[-1] * 1e3,
           "window_decode_tokens": tokens - n_requests,
           "window_decode_s": window_s,
           "window_decode_tokens_per_s": (tokens - n_requests) / window_s,
           "itl_ms_p50": gaps[len(gaps) // 2] * 1e3,
           "itl_ms_max": gaps[-1] * 1e3,
           "run_s": wall, "run_tokens_per_s": tokens / wall,
           "decode_step_ms_median": decode_ms,
           "decode_step_tokens_per_s": scfg.max_batch / (decode_ms / 1e3),
           "prefill_tokens": RWKV_PREFILL, "prefill_ms_median": prefill_ms,
           "prefill_launches": prefill_counts,
           "setup_s": setup_s, "init_peak_bytes": init_peak,
           "max_memory_allocated": serve_peak,
           "first_tokens": {u: r.out_tokens[:4] for u, r in done.items()},
           "nvidia_smi": nvidia_smi(
               "clocks.sm,power.draw,power.limit,temperature.gpu")}
    emit(res)
    # mesh_card_toy counts the tokens its bf16 mesh run picks otherwise
    return {**res,
            "tokens": {u: list(r.out_tokens) for u, r in done.items()}}


def _train(dev, rc: RunConfig, steps: int) -> dict:
    """``steps`` full-width parallax-lm steps on the card under ``rc``, the
    launch counts set to 0 just before them and read just after."""
    cfg = get_config("parallax-lm")
    shape = ShapeConfig("lm1b", seq_len=SEQ, global_batch=BATCH, kind="train")
    t0 = time.perf_counter()
    runner = get_runner(cfg, shape, rc, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ds = SyntheticLM(cfg.vocab_size, SEQ, BATCH)
    batches = [ds.batch(i) for i in range(steps)]
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms = [], []
    ops.reset_launch_counts()
    for b in batches:
        t = time.perf_counter()
        m = runner.run(b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    med = statistics.median(step_ms)
    return {"arch": cfg.name, "tokens_per_step": shape.tokens,
            "losses": losses, "step_ms": step_ms, "median_step_ms": med,
            "tokens_per_s": shape.tokens / (med / 1e3),
            "max_memory_allocated": peak, "launches": counts,
            "setup_s": build_s,
            "nvidia_smi": nvidia_smi(
                "clocks.sm,power.draw,power.limit,temperature.gpu")}


def phase_main(dev, steps: int = 10) -> dict:
    res = {"phase": "main", **_train(dev, RunConfig(), steps)}
    losses, counts = res["losses"], res["launches"]
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for k in PATH_KERNELS["main"]:
        check(counts[k] == steps,
              f"{k} launched {counts[k]} times in {steps} steps")
    check(counts["embed_gather_bulk"] == steps
          and counts["embed_scatter_add_fused"] == steps,
          f"main: {counts['embed_gather_bulk']} of {steps} gathers on the "
          f"bulk route, {counts['embed_scatter_add_fused']} of {steps} "
          "scatters on the one-pass kernel")
    emit(res)
    return res


def phase_main_no_la(dev, steps: int = 3) -> dict:
    """The no-LA ablation at full width: RunConfig(local_agg=False) pushes
    the raw 2,560-token stream, whose ids repeat, through the plain
    accumulating scatter (no kernel launch); the pull still gathers on the
    bulk route."""
    res = {"phase": "main_no_la",
           **_train(dev, RunConfig(local_agg=False), steps)}
    counts = res["launches"]
    check(counts["embed_scatter_add"] == 0,
          f"no-LA launched embed_scatter_add {counts['embed_scatter_add']} "
          "times: repeated ids must take the plain scatter")
    check(counts["embed_gather"] == steps
          and counts["embed_gather_bulk"] == steps,
          f"no-LA gathers: {counts['embed_gather']} launches, "
          f"{counts['embed_gather_bulk']} on the bulk route, in {steps} "
          "steps")
    emit(res)
    return res


def _nmt_setup() -> tuple:
    """Full-width parallax-nmt's cell (``profile_step.CELLS``): GNMT's
    batch 128 and length 50, the reference's two-table knobs (one device
    runs the same math; on (4, 1) embed goes to mpi_gatherv and enc_embed
    to the dense all-reduce), AdamW at 1e-4."""
    cell = CELLS["parallax-nmt"]
    return cell_config("parallax-nmt"), cell.shape, cell.run


def _nmt_batches(steps: int) -> list:
    """Zipf(1.3) targets and a uniform source stream (the near-dense
    table)."""
    cfg, shape, _ = _nmt_setup()
    ds = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch,
                     **CELLS["parallax-nmt"].data)
    return [ds.batch(i) for i in range(steps)]


def phase_nmt(dev, steps: int = 10) -> dict:
    """Full-width parallax-nmt, 10 steps on one card: both tables pulled
    through the bulk gather and pushed through the one-pass scatter every
    step. On one device the two-table knobs change no math: no capped
    buffer drops a row."""
    cfg, shape, rc = _nmt_setup()
    t0 = time.perf_counter()
    runner = get_runner(cfg, shape, rc, seed=0, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    r = _timed_steps(runner, _nmt_batches(steps), dev, NMT_CENSUS)
    losses, counts = r["losses"], r["launches"]
    check(all(math.isfinite(x) for x in losses), f"nmt losses {losses}")
    check(losses[-1] < losses[0], f"nmt loss did not fall: {losses}")
    check(all(c[f"{t}_dropped"] == 0.0 for c in r["census"]
              for t in ("embed", "enc_embed")),
          f"nmt dropped rows: {r['census']}")
    for k in ("embed_gather", "embed_gather_bulk", "embed_scatter_add",
              "embed_scatter_add_fused"):
        check(counts[k] == 2 * steps,
              f"nmt: {k} launched {counts[k]} times in {steps} steps, "
              "want 2 a step (one per table)")
    med = r["median_step_ms"]
    res = {"phase": "nmt", "arch": cfg.name,
           "tokens_per_step": shape.tokens, "plan": runner.plan.tables(),
           **r, "tokens_per_s": shape.tokens / (med / 1e3),
           "setup_s": setup_s, "seconds": time.perf_counter() - t0,
           "nvidia_smi": nvidia_smi(
               "clocks.sm,power.draw,power.limit,temperature.gpu")}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# the training driver: launch/train.py, runtime/trainer.py, checkpoints
# ---------------------------------------------------------------------------

TRAIN_STEPS = 12
TRAIN_ARGS = ["--arch", "parallax-lm", "--seq", str(SEQ), "--batch",
              str(BATCH), "--steps", str(TRAIN_STEPS), "--capacity-mode",
              "capped", "--capacity-factor", "1.5", "--replan-every", "4",
              "--replan-warmup", "2", "--zipf-a", "1.3", "--log-every", "4"]


def _summary(rec: dict) -> dict:
    """A launcher record's numbers: step times from the trainer's
    monitor (host clock, each step ending in the one metrics transfer)."""
    ms = [t * 1e3 for t in rec["step_time_s"]]
    return {"losses": rec["losses"], "step_ms": ms,
            "median_step_ms": statistics.median(ms),
            "tokens_per_s_median": statistics.median(rec["tokens_per_s"]),
            "seconds": rec["seconds"], "replans": rec["replans"],
            "plan0": rec["plan0"], "plan": rec["plan"]}


def _held_at(table, ids, rows) -> dict:
    """Both embed kernels against their plain versions on these inputs,
    bit for bit; -> their max abs errors."""
    got = ops.embed_gather(table, ids, 0)
    want = ref.embed_gather_ref(table, ids, 0)
    pushed = ops.embed_scatter_add(ids, rows, table.shape[0])
    plain = ref.embed_scatter_add_ref(ids, rows, table.shape[0])
    torch.cuda.synchronize()
    check(torch.equal(_bits(got), _bits(want)),
          "embed_gather differs from its plain version at the replanned "
          "capacity")
    check(torch.equal(_bits(pushed), _bits(plain)),
          "embed_scatter_add differs from its plain version at the "
          "replanned capacity")
    return {"embed_gather": float((got.float() - want.float()).abs().max()),
            "embed_scatter_add": float((pushed - plain).abs().max())}


def phase_train(dev, main_ms: float) -> dict:
    """Full-width parallax-lm through the launcher, ``launch.train.main``:
    12 steps of Zipf(1.3) batches from the uniform estimate's plan (capped
    x 1.5, capacity 2,560), a replan every 4 steps; then a static-plan run
    of the same 12 batches (not counted). Deterministic algorithms on.
    Then the first run once more with them off, as the launcher runs (not
    counted): its step median beside ``main_ms``, main's in this call."""
    from repro_torch.launch import train as launch_train
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        ad = launch_train.main(TRAIN_ARGS, device="cuda")
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        trainer = ad.pop("trainer")
        cap = trainer.plan.table_capacity["embed"]
        toks = SyntheticLM(VOCAB, SEQ, BATCH).batch(TRAIN_STEPS - 1)["tokens"]
        flat = torch.from_numpy(np.ascontiguousarray(toks)).reshape(-1)
        uids, _, _ = dedupe(flat.to(dev), cap, VOCAB, True)
        rows = torch.randn((cap, E), device=dev).to(torch.bfloat16)
        errs = _held_at(trainer.model.embed.detach(), uids, rows)
        history = ad["history"]
        del trainer, rows
        torch.cuda.empty_cache()
        static = launch_train.main(
            TRAIN_ARGS[:TRAIN_ARGS.index("--replan-every")]
            + TRAIN_ARGS[TRAIN_ARGS.index("--replan-warmup"):]
            + ["--replan-every", "0"], device="cuda")
        static.pop("trainer")
        torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    free = launch_train.main(TRAIN_ARGS, device="cuda")
    free.pop("trainer")
    torch.cuda.empty_cache()
    res = {"phase": "train", "args": TRAIN_ARGS, **_summary(ad),
           "static_losses": static["losses"], "launches": counts,
           "nondeterministic": {k: v for k, v in _summary(free).items()
                                if k in ("losses", "step_ms",
                                         "median_step_ms",
                                         "tokens_per_s_median")},
           "main_median_step_ms": main_ms,
           "max_memory_allocated": peak, "held_at_capacity": cap,
           "max_abs_err": errs,
           "dropped": [h["embed_dropped"] for h in history],
           "embed_rows": [h["embed_rows"] for h in history],
           "nvidia_smi": nvidia_smi(
               "clocks.sm,power.draw,power.limit,temperature.gpu")}
    check(len(ad["replans"]) >= 1, f"train: no replan fired {ad['replans']}")
    first = ad["replans"][0]
    caps = first["table_capacity"]
    uniq = [np.unique(SyntheticLM(VOCAB, SEQ, BATCH).batch(i)["tokens"]).size
            for i in range(first["step"])]
    check(caps[0]["embed"] == SEQ * BATCH
          and math.floor(1.5 * min(uniq)) <= caps[1]["embed"]
          <= math.ceil(1.5 * max(uniq)),
          f"train: capacity {caps} after batches of {uniq} unique ids")
    for k in ("embed_gather", "embed_gather_bulk", "embed_scatter_add",
              "embed_scatter_add_fused"):
        check(counts[k] == TRAIN_STEPS,
              f"train: {k} launched {counts[k]} times in {TRAIN_STEPS} steps")
    check(all(d == 0 for d in res["dropped"]),
          f"train: rows dropped {res['dropped']}")
    check(ad["losses"] == static["losses"],
          f"train: losses {ad['losses']} vs the static plan's "
          f"{static['losses']}")
    check(len(free["replans"]) >= 1
          and all(math.isfinite(x) for x in free["losses"]),
          f"train, deterministic algorithms off: replans {free['replans']}, "
          f"losses {free['losses']}")
    res["rebuild_ms"] = [r["rebuild_s"] * 1e3 for r in ad["replans"]]
    emit(res)
    return res


def phase_train_growth(dev) -> dict:
    """Full-width parallax-lm through ``Trainer``: the planner assumes the
    Zipf(1.3) skew at capacity factor 1.0; the first 4 of 10 batches draw
    uniform ids and overflow the buffer; a replan every 4 steps with drift
    50, so only the overflow growth can fire one."""
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = get_config("parallax-lm")
    shape = ShapeConfig("lm1b", seq_len=SEQ, global_batch=BATCH,
                        kind="train")
    rc = RunConfig(zipf_a=1.3, capacity_mode="capped", capacity_factor=1.0,
                   capacity_growth=1.5, overflow_tolerance=0.5)
    ds = SyntheticLM(VOCAB, SEQ, BATCH, zipf_a=1.3, burst_steps=4,
                     burst_zipf_a=0.0)
    t0 = time.perf_counter()
    t = Trainer(cfg, shape, rc, TrainerConfig(
        total_steps=10, replan_every=4, replan_warmup=2, replan_drift=50.0),
        ds, device=dev)
    cap0 = t.plan.table_capacity["embed"]
    steps = []
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()

    def on_metrics(step, m):
        steps.append({"step": step, "loss": m["loss"],
                      "capacity": m["embed_rows"],
                      "unique": m["embed_unique"],
                      "dropped": m["embed_dropped"],
                      "overflow": m.get("overflow", {}).get("embed", 0.0),
                      "step_ms": m["step_time_s"] * 1e3,
                      "launches": ops.launch_counts()})

    t.run(on_metrics=on_metrics)
    counts = ops.launch_counts()
    by_cap: dict = {}
    prev = {k: 0 for k in counts}
    for s in steps:
        c = by_cap.setdefault(str(int(s["capacity"])), {
            k: 0 for k in ("embed_gather_bulk", "embed_scatter_add_fused")})
        for k in c:
            c[k] += s["launches"][k] - prev[k]
        prev = s["launches"]
    diff = t.replan_history[0] if t.replan_history else {}
    res = {"phase": "train_growth", "capacity0": cap0,
           "capacity": t.plan.table_capacity["embed"],
           "grown": list(t.plan.grown_tables),
           "replan": {k: diff.get(k) for k in (
               "step", "capacity_grown", "capacity_drifted",
               "table_capacity", "rebuild_s")},
           "steps": [{k: v for k, v in s.items() if k != "launches"}
                     for s in steps],
           "launches": counts, "launches_by_capacity": by_cap,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "seconds": time.perf_counter() - t0}
    check(max(s["dropped"] for s in steps[:4]) > 0,
          f"train_growth: the burst dropped no row {res['steps']}")
    check(any(s["overflow"] > 0 for s in steps),
          "train_growth: the monitor never surfaced the overflow")
    check(bool(diff) and diff["capacity_grown"]
          and res["capacity"] > cap0 and res["grown"] == ["embed"],
          f"train_growth: no growth {res['replan']} {res['grown']}")
    check(all(s["dropped"] == 0 for s in steps[4:]),
          f"train_growth: rows dropped after the growth {res['steps']}")
    check(counts["embed_gather_bulk"] == counts["embed_scatter_add_fused"]
          == 10, f"train_growth: launches {counts}")
    del t
    emit(res)
    return res


def _train_work(cfg, shape) -> dict:
    """A training step's matmul parameters and counted operations, per
    family: 6 per matmul parameter and each row it multiplies (the forward
    and the backward's two products), plus the sequence mixing 4 times
    (the forward, the backward's two products and the block remat's
    recompute): plain attention's QK^T and P.V over every (q, k) pair (the
    causal mask removes none of them), the selective SSM's chunked products
    (chunk 128) and the WKV's (chunk 32), 2 operations per FMA. The
    encoder-decoder's encoder and cross K/V run over the S / 4 frames."""
    b, s = shape.global_batch, shape.seq_len
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    tok = b * s
    q_o, k_v, mlp = 2 * d * h * hd, 2 * d * kv * hd, 3 * d * f

    def pairs(sq, sk):
        return 4 * b * sq * sk * h * hd
    if cfg.family == "audio":
        se = s // 4
        enc, dec, cross = (cfg.enc_layers * (q_o + k_v + mlp),
                           cfg.n_layers * (2 * q_o + k_v + mlp),
                           cfg.n_layers * k_v)
        matmul = enc + dec + cross + v * d
        rows = (enc + cross) * b * se + (dec + v * d) * tok
        mix = (cfg.enc_layers * pairs(se, se)
               + cfg.n_layers * (pairs(s, s) + pairs(s, se)))
    elif cfg.family == "ssm":                           # rwkv6
        e, chunk = hd, 32
        matmul = cfg.n_layers * (6 * d * d + 2 * d * f + 128 * d) + v * d
        rows = matmul * tok
        mix = cfg.n_layers * tok * h * (4 * chunk * e + 4 * e * e)
    else:                                 # dense, vlm; hybrid adds the SSM
        per = q_o + k_v + mlp
        mix = cfg.n_layers * pairs(s, s)
        if cfg.family == "hybrid":
            n, chunk = cfg.ssm_state, 128
            per += 4 * d * d + 2 * d * n
            mix += cfg.n_layers * tok * (2 * chunk * n + 2 * chunk * d
                                         + 4 * n * d)
        matmul = cfg.n_layers * per + v * d
        rows = matmul * tok
    return {"matmul_params": matmul, "flops": 6 * rows + 4 * mix}


def phase_dense_train(dev, arch: str = DENSE_ARCH,
                      phase: str = "dense_train",
                      steps: int = DENSE_STEPS) -> dict:
    """``arch``'s cell (``profile_step.CELLS``) through
    ``runtime/trainer.py::Trainer``: the cell's RunConfig (RunConfig():
    bf16, AdamW at 1e-3, hybrid, remat block, chunked attention; chameleon
    at 1e-5), ShapeConfig("train", 512, 8) (launch/train.py's default seq
    and batch), 12 steps of Zipf(1.3) batches. ``dense_train``: phi3-medium-14b at its published width (d
    5,120; 40 q / 10 KV heads of 128; d_ff 17,920; vocab 100,352) with
    n_layers cut to 8 of 40; the slice-6 families' phases
    (``FAMILY_TRAIN``) at their cells' depths. Losses finite and falling;
    one bulk gather and one one-pass scatter a step; peak memory under
    72 GB; step median, tokens/s, TFLOP/s from counted operations."""
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cell = CELLS[arch]
    cfg, shape = cell_config(arch), cell.shape
    ds = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch,
                     **cell.data)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, shape, cell.run,
                      TrainerConfig(total_steps=steps, log_every=100),
                      ds, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated(dev)
    hist = []
    ops.reset_launch_counts()
    trainer.run(on_metrics=lambda step, m: hist.append(m))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    rc = trainer.rt.run_cfg
    plan = trainer.plan.tables()
    n_params = sum(p.numel() for p in trainer.model.parameters())
    del trainer
    torch.cuda.empty_cache()
    losses = [m["loss"] for m in hist]
    ms = [m["step_time_s"] * 1e3 for m in hist]
    med = statistics.median(ms[1:])
    work = _train_work(cfg, shape)
    full = get_config(arch).n_layers
    res = {"phase": phase, "arch": cfg.name,
           "cut": (f"n_layers {cfg.n_layers} of {full}"
                   if cfg.n_layers != full else "none"),
           "run_config": {k: getattr(rc, k) for k in (
               "param_dtype", "compute_dtype", "optimizer", "learning_rate",
               "comm_mode", "remat", "attention_impl")},
           "tokens_per_step": shape.tokens, "losses": losses, "step_ms": ms,
           "median_step_ms": med, "tokens_per_s": shape.tokens / med * 1e3,
           "tflops_per_s": work["flops"] / med / 1e9,
           "share_of_peak": work["flops"] / (med / 1e3) / HW.peak_flops,
           "params": n_params, **work, "plan": plan, "setup_s": setup_s,
           "setup_max_memory_allocated": setup_peak,
           "max_memory_allocated": peak, "launches": counts,
           "nvidia_smi": nvidia_smi(
               "clocks.sm,power.draw,power.limit,temperature.gpu")}
    check(rc.remat == "block" and rc.attention_impl == "chunked",
          f"{phase}: RunConfig {res['run_config']}")
    check(len(losses) == steps
          and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0],
          f"{phase}: losses {losses}")
    check(peak < PEAK_LIMIT, f"{phase}: peak {peak} B over {PEAK_LIMIT}")
    for k in ("embed_gather", "embed_gather_bulk", "embed_scatter_add",
              "embed_scatter_add_fused"):
        check(counts[k] == steps,
              f"{phase}: {k} launched {counts[k]} times in {steps} steps")
    check(counts["flash_attention"] == counts["wkv"] == 0,
          f"{phase}: a forward-only kernel ran in training: {counts}")
    emit(res)
    return res


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def phase_train_resume(dev) -> dict:
    """Full-width parallax-nmt (the ``nmt`` cell) through ``Trainer``: 6
    steps with a checkpoint every 3 into build/; a fresh trainer restores
    step 3 and trains to 6. Deterministic algorithms on: steps 4-6 and
    every parameter and moment at step 6 equal the uninterrupted run's
    bit for bit."""
    import shutil
    from repro_torch.checkpoint.ckpt import state_leaves
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg, shape, rc = _nmt_setup()
    ds = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch,
                     **CELLS["parallax-nmt"].data)
    d = ROOT / "build" / "ckpt_resume"
    shutil.rmtree(d, ignore_errors=True)
    tcfg = TrainerConfig(total_steps=6, ckpt_dir=str(d), ckpt_every=3)
    paths = {"launches": {}}

    def run(t):
        out = []
        ops.reset_launch_counts()
        t.run(on_metrics=lambda s, m: out.append(
            (s, m["loss"], m["step_time_s"] * 1e3)))
        for k, v in ops.launch_counts().items():
            paths["launches"][k] = paths["launches"].get(k, 0) + v
        return out

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        t1 = Trainer(cfg, shape, rc, tcfg, ds, device=dev)
        first = run(t1)
        want = {p: v.clone() if isinstance(v, torch.Tensor) else v
                for p, v in state_leaves(t1._canonical_state())}
        ck = {"snapshot_s": t1.ckpt.snapshot_seconds,
              "write_s": t1.ckpt.write_seconds,
              "bytes": _dir_bytes(d / "step_00000003"),
              "disk_bytes": _dir_bytes(d)}
        del t1
        torch.cuda.empty_cache()
        shutil.rmtree(d / "step_00000006")
        t2 = Trainer(cfg, shape, rc, tcfg, ds, device=dev)
        t = time.perf_counter()
        t2.maybe_restore()
        ck["restore_s"] = time.perf_counter() - t
        check(t2.step == 3, f"train_resume: restored step {t2.step}")
        second = run(t2)
        got = dict(state_leaves(t2._canonical_state()))
        same = {p: (torch.equal(_bits(v), _bits(got[p]))
                    if isinstance(v, torch.Tensor) else v == got[p])
                for p, v in want.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        del t2
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(d, ignore_errors=True)
    res = {"phase": "train_resume", "arch": cfg.name,
           "losses": [x[1] for x in first],
           "resumed_losses": [x[1] for x in second],
           "resumed_steps": [x[0] for x in second],
           "step_ms": [x[2] for x in first + second], "checkpoint": ck,
           "leaves": len(same), "max_memory_allocated": peak,
           "launches": paths["launches"]}
    check(res["resumed_steps"] == [4, 5, 6]
          and res["resumed_losses"] == res["losses"][3:],
          f"train_resume: {res['resumed_losses']} vs {res['losses'][3:]}")
    check(all(same.values()),
          f"train_resume: leaves differ {[p for p, v in same.items() if not v]}")
    emit(res)
    return res


# ---------------------------------------------------------------------------
# the mesh phases: ranks are spawned processes (launch/mesh.py::spawn)
# ---------------------------------------------------------------------------

def _main_batches(steps: int) -> list:
    """The main phase's batches (SyntheticLM, seed 0)."""
    ds = SyntheticLM(get_config("parallax-lm").vocab_size, SEQ, BATCH)
    return [ds.batch(i) for i in range(steps)]


def _timed_steps(runner, batches, dev, census_keys=CENSUS,
                 record_batch=None) -> dict:
    """Run ``batches`` through ``runner`` with every launch count set to 0
    just before and read just after: losses, step ms, launches, peak.
    ``record_batch``: one more step after those, outside the step times,
    losses, launches and peak, whose collectives are recorded
    (``collectives.record``), returned as ``record``."""
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms, census, norms = [], [], [], []
    ops.reset_launch_counts()
    for b in batches:
        t = time.perf_counter()
        m = runner.run(b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
        census.append({k: float(m[k]) for k in census_keys})
        if "grad_norm" in m:
            norms.append(float(m["grad_norm"]))
    out = {"losses": losses, "step_ms": step_ms, "census": census,
           "grad_norms": norms,
           "median_step_ms": statistics.median(step_ms),
           "launches": ops.launch_counts(),
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    if record_batch is not None:
        with coll.record() as rec:
            runner.run(record_batch)
        out["record"] = rec.by_kind_axes()
    return out


def _one_rank(rank: int, world: int, steps: int) -> dict:
    """Full-width parallax-lm, default RunConfig, on a (1, 1) mesh over a
    one-rank NCCL group: the same seed and batches as main."""
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    cfg = get_config("parallax-lm")
    shape = ShapeConfig("lm1b", seq_len=SEQ, global_batch=BATCH,
                        kind="train")
    runner = get_runner(cfg, shape, RunConfig(), mesh=mesh)
    out = _timed_steps(runner, _main_batches(steps), mesh.device)
    out["plan"] = runner.plan.tables()
    out["methods"] = runner.plan.methods()
    out["bucketed"] = runner.plan.bucket_plan is not None
    return out


def phase_mesh_one_rank(main_losses: list, steps: int = 3) -> dict:
    """The mesh path through a one-rank NCCL group must reproduce main's
    first ``steps`` losses bit for bit: every collective over a group of
    one is the identity, and the plan (mpi_gatherv, as the reference
    plans a 1 x 1 mesh) pushes through the plain scatter, which gives the
    one-pass kernel's bits for the unique ids of a dedupe buffer."""
    (res,) = spawn(_one_rank, 1, "nccl", "cuda", args=(steps,),
                   timeout=600)
    check(res["plan"]["embed"]["method"] == "mpi_gatherv",
          f"mesh_one_rank plan {res['plan']}")
    check(res["losses"] == main_losses[:steps],
          f"mesh_one_rank losses {res['losses']} vs main "
          f"{main_losses[:steps]}")
    counts = res["launches"]
    check(counts["embed_gather"] == steps
          and counts["embed_gather_bulk"] == steps
          and counts["embed_scatter_add"] == 0,
          f"mesh_one_rank launches {counts}")
    res = {"phase": "mesh_one_rank", "backend": "nccl", "world": 1,
           "mesh": [1, 1], "main_losses": main_losses[:steps], **res}
    emit(res)
    return res


MESH_FLAGS = {"hybrid": {}, "ps": {"comm_mode": "ps"},
              "mpi": {"comm_mode": "mpi"}, "no_la": {"local_agg": False},
              "no_opau": {"opau": False}, "no_opsw": {"opsw": False}}
MESH_F32 = dict(param_dtype="float32", compute_dtype="float32",
                wire_dtype="float32")


def _reduced():
    return (reduced(get_config("parallax-lm")),
            ShapeConfig("mesh", 32, 4, "train"))


def _reduced_batches() -> list:
    cfg, shape = _reduced()
    ds = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch)
    return [ds.batch(i) for i in range(3)]


def _card_rank(rank: int, world: int, named: dict, steps: int) -> dict:
    """One of four ranks on the one card over gloo: (a) reduced
    parallax-lm at f32 on a (2, 2) mesh under the six flag sets; (b)
    full-width parallax-lm, bf16, comm_mode ps on a (1, 4) mesh."""
    dev = torch.device("cuda", 0)
    mesh = make_mesh((2, 2), ("data", "model"), device=dev)
    cfg, shape = _reduced()
    out = {"reduced": {}}
    total = None
    for name, flags in MESH_FLAGS.items():
        runner = get_runner(cfg, shape, RunConfig(**MESH_F32, **flags),
                            mesh=mesh,
                            params=load_reference_params(named, dev))
        r = _timed_steps(runner, _reduced_batches(), dev)
        out["reduced"][name] = {
            "losses": r["losses"], "launches": r["launches"],
            "census": r["census"],
            "method": runner.plan.table_methods["embed"],
            "bucketed": runner.plan.bucket_plan is not None,
            "replicas": runner.rt.replicas}
        total = r["launches"] if total is None else {
            k: total[k] + v for k, v in r["launches"].items()}
    del runner
    torch.cuda.empty_cache()
    # (b): a new mesh over the same four ranks
    mesh = make_mesh((1, 4), ("data", "model"), device=dev)
    full = get_config("parallax-lm")
    lm1b = ShapeConfig("lm1b", seq_len=SEQ, global_batch=BATCH, kind="train")
    runner = get_runner(full, lm1b, RunConfig(comm_mode="ps"), mesh=mesh)
    r = _timed_steps(runner, _main_batches(steps), dev)
    out["full_ps"] = {**r, "plan": runner.plan.tables(),
                      "table_shard": list(runner.model.embed.shape),
                      "lstm_shards": {n: list(p.shape) for n, p in
                                      _lstm_leaves(runner.model).items()},
                      "model_index": mesh.coords["model"]}
    out["launches"] = {k: total[k] + v for k, v in r["launches"].items()}
    del runner
    torch.cuda.empty_cache()
    out["nmt"] = _nmt_card(rank, dev, steps)
    return out


def _apply_ms(runner, rank: int, dev, runs: int = 5):
    """The optimizer apply alone (``update_fused`` or ``update``), timed
    with CUDA events on rank 0 while the other ranks wait at a barrier, on
    the step's shapes and layout from random gradients (an elementwise
    apply's time does not depend on the values). Changes the state: it
    runs after the checks."""
    dist.barrier()
    ms = None
    if rank == 0:
        state, bp = runner.live_state, runner.plan.bucket_plan
        names = list(state.params)
        gen = torch.Generator(device=dev).manual_seed(1)
        grads = {n: torch.randn(p.shape, generator=gen, device=dev).mul_(
            1e-3).to(p.dtype) for n, p in state.params.items()}
        bufs = []
        for b in bp.buckets:
            members = [grads[names[i]] for i in b.idx]
            bufs.append(buckets._flat_wire(b, members, 1.0))
            grads.update(zip((names[i] for i in b.idx),
                             buckets._slice_back(b, bufs[-1], members)))
        opt = runner.optimizer
        fn = ((lambda: opt.update_fused(state, grads, bufs, bp))
              if runner.plan.fused_apply else
              (lambda: opt.update(state, grads)))
        times = []
        for _ in range(runs + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            fn()
            ev[1].record()
            torch.cuda.synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        ms = statistics.median(times[1:])          # the first warms up
    dist.barrier()
    return ms


def _nmt_card(rank: int, dev, steps: int) -> dict:
    """(c): full-width parallax-nmt, bf16, the two-table knobs, on a (4, 1)
    mesh over the same four ranks: 3 steps with the fused apply, then 3
    with fused_apply=False, from the same seed. Deterministic algorithms
    are on for both, so index_add_ (the segment sums and the gatherv
    push's repeats) adds in a fixed order and the two runs can be held bit
    for bit."""
    mesh = make_mesh((4, 1), ("data", "model"), device=dev)
    cfg, shape, rc = _nmt_setup()
    batches = _nmt_batches(steps)
    out, first = {}, None
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for fused in (True, False):
            runner = get_runner(cfg, shape, replace(rc, fused_apply=fused),
                                mesh=mesh, seed=0)
            r = _timed_steps(runner, batches, dev, NMT_CENSUS)
            own = {n: p.detach() for n, p in
                   named_parameters(runner.model).items()}
            if first is None:
                first = {n: p.clone() for n, p in own.items()}
            else:
                r["params_equal_fused"] = all(
                    torch.equal(_bits(first[n]), _bits(p))
                    for n, p in own.items())
            bp = runner.plan.bucket_plan
            r.update(plan=runner.plan.tables(),
                     fused_apply=runner.plan.fused_apply,
                     live_fused=is_fused(runner.live_state),
                     buckets=len(bp.buckets) if bp is not None else 0,
                     bucket_wire_bytes=bp.wire_bytes if bp else 0,
                     apply_ms=_apply_ms(runner, rank, dev))
            out["fused" if fused else "per_param"] = r
            del runner
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    out["launches"] = {k: v + out["per_param"]["launches"][k]
                       for k, v in out["fused"]["launches"].items()}
    return out


def _census(tokens: np.ndarray, method: str, bucketed: bool, n: int,
            local_agg: bool, vocab: int) -> dict:
    """The census the plan's exchange implies for one global batch: each
    replica's unique ids averaged over the replicas (a table on the dense
    exchange outside buckets: the global batch's)."""
    blocks = ([tokens] if method == "allreduce" and not bucketed
              else np.split(tokens, n))
    uniq = [np.unique(b).size if local_agg else b.size for b in blocks]
    t = blocks[0].size
    return {"embed_unique": float(np.mean(uniq)),
            "embed_rows": float(min(t, vocab) if local_agg else t),
            "embed_dropped": 0.0}


def phase_mesh_card(main_losses: list, nmt_losses: list,
                    steps: int = 3) -> dict:
    """Four ranks on the one card over gloo (NCCL takes one card per
    rank): (a) the reduced six flag sets on (2, 2) against the one-device
    card run on the same batches (the reference test's bar, 5e-4 + 1e-4 i)
    with the census the plan implies; (b) full-width ps on (1, 4): each
    rank pulls at row_offset m * 200,000 through the bulk gather and
    pushes through the one-pass scatter, 3 each, losses within rel 1e-2
    of main's; (c) full-width parallax-nmt on (4, 1): embed on
    mpi_gatherv, enc_embed on the dense all-reduce, the fused apply
    stamped; 3 steps fused and 3 per-param equal bit for bit (losses, rank
    0's parameters), losses within rel 1e-2 of nmt's. Gloo moves CUDA
    tensors through the host: its times are not a multi-GPU exchange
    time."""
    cfg, shape = _reduced()
    one = get_runner(cfg, shape, RunConfig(**MESH_F32), device="cuda")
    named = {k: p.detach().cpu().numpy()
             for k, p in named_parameters(one.model).items()}
    batches = _reduced_batches()
    single = []
    for b in batches:
        single.append(float(one.run(b)["loss"]))
    del one
    ranks = spawn(_card_rank, 4, "gloo", "cuda", args=(named, steps),
                  timeout=900)
    reduced_rows = {}
    for name, flags in MESH_FLAGS.items():
        rs = [r["reduced"][name] for r in ranks]
        got = rs[0]["losses"]
        check(all(r["losses"] == got for r in rs),
              f"mesh_card {name}: ranks disagree {[r['losses'] for r in rs]}")
        for i, (a, b) in enumerate(zip(got, single)):
            check(abs(a - b) < 5e-4 + 1e-4 * i,
                  f"mesh_card {name} step {i}: {got} vs one device {single}")
        reduced_rows[name] = {"losses": got, "method": rs[0]["method"],
                              "bucketed": rs[0]["bucketed"],
                              "max_abs_diff": max(abs(a - b) for a, b in
                                                  zip(got, single))}
        r0 = rs[0]
        want = [_census(b["tokens"], r0["method"], r0["bucketed"],
                        r0["replicas"], flags.get("local_agg", True),
                        cfg.vocab_size) for b in batches]
        check(all(r["census"] == want for r in rs),
              f"mesh_card {name}: census {[r['census'] for r in rs]} vs "
              f"{want}")
    full = [r["full_ps"] for r in ranks]
    for m, r in enumerate(sorted(full, key=lambda r: r["model_index"])):
        c = r["launches"]
        check(r["plan"]["embed"]["method"] == "ps"
              and r["table_shard"] == [VOCAB // 4, E],
              f"mesh_card full: plan {r['plan']}, shard {r['table_shard']}")
        # the LSTM at H/4 a rank: its units of each gate, its w_proj rows
        h = get_config("parallax-lm").d_ff
        check(r["lstm_shards"] == {"layers.bias": [1, h],
                                   "layers.w_h": [1, E, h],
                                   "layers.w_proj": [1, h // 4, E],
                                   "layers.w_x": [1, E, h]},
              f"mesh_card full: LSTM shards {r['lstm_shards']}")
        check(c["embed_gather_bulk"] == steps
              and c["embed_scatter_add_fused"] == steps,
              f"mesh_card full, model shard {m}: launches {c}")
        check(all(math.isfinite(x) for x in r["losses"]),
              f"mesh_card full: losses {r['losses']}")
        for a, b in zip(r["losses"], main_losses):
            check(abs(a - b) <= 1e-2 * abs(b),
                  f"mesh_card full: losses {r['losses']} vs main "
                  f"{main_losses[:steps]}")
    nmt = _check_nmt_card([r["nmt"] for r in ranks], nmt_losses, steps)
    launcher = _mesh_launcher()
    res = {"phase": "mesh_card", "backend": "gloo", "world": 4,
           "note": "4 ranks on one card over gloo, not a multi-GPU "
                   "exchange time",
           "nmt": nmt, "launcher": launcher,
           "reduced": {"mesh": [2, 2], "one_device": single,
                       "flag_sets": reduced_rows},
           "full_ps": {"mesh": [1, 4], "main_losses": main_losses[:steps],
                       "lstm_shards": full[0]["lstm_shards"],
                       "ranks": [{k: r[k] for k in (
                           "model_index", "losses", "step_ms",
                           "median_step_ms", "max_memory_allocated")}
                           for r in full]},
           "launches": ranks[0]["launches"],
           "launches_by_rank": [r["launches"] for r in ranks]}
    emit(res)
    return res


# mesh_card (d): the launcher's mesh path. Reduced parallax-lm (bf16, the
# launcher's defaults) on (4, 1), capped x 1.5, the reference test's link
# latency 0 (through --hw-profile): the uniform estimate plans embed on the
# bucketed dense all-reduce, the observed census on mpi_gatherv
LAUNCH_MESH_ARGS = ["--arch", "parallax-lm", "--reduced", "--seq", "20",
                    "--batch", "32", "--steps", "8", "--capacity-mode",
                    "capped", "--capacity-factor", "1.5", "--replan-warmup",
                    "2", "--devices", "4", "--mesh", "4x1", "--log-every",
                    "100"]


def _mesh_launcher() -> dict:
    """``launch.train.main([..., "--devices", "4", "--mesh", "4x1"])``
    twice (each spawns 4 ranks on the one card over gloo): a replan every
    4 steps, and the static plan. The replan flips embed's method; the
    losses stay within the reference's 5e-4 + 1e-4 i of the static
    run's."""
    from repro_torch.launch import train as launch_train
    prof = ROOT / "build" / "hw_link_latency_0.json"
    prof.parent.mkdir(parents=True, exist_ok=True)
    prof.write_text(json.dumps({"link_latency": 0.0}))
    argv = LAUNCH_MESH_ARGS + ["--hw-profile", str(prof)]
    steps = int(argv[argv.index("--steps") + 1])
    out = {"how": "launch.train.main --devices 4 --mesh 4x1 (its own spawn "
                  "of 4 gloo ranks on cuda:0)"}
    for name, every in (("adaptive", "4"), ("static", "0")):
        t = time.perf_counter()
        ranks = launch_train.main(argv + ["--replan-every", every],
                                  device="cuda")
        out[name] = {"seconds": time.perf_counter() - t,
                     "losses": ranks[0]["losses"],
                     "replans": ranks[0]["replans"],
                     "plan0": ranks[0]["plan0"], "plan": ranks[0]["plan"],
                     "median_step_ms": statistics.median(
                         x * 1e3 for x in ranks[0]["step_time_s"]),
                     "launches_by_rank": [r["launches"] for r in ranks]}
        check(all(r["losses"] == ranks[0]["losses"] for r in ranks),
              f"mesh launcher {name}: ranks disagree")
    ad, st = out["adaptive"], out["static"]
    flip = [r["step"] for r in ad["replans"]
            if ["embed", "allreduce", "mpi_gatherv"] in
            [list(f) for f in r["flips"]]]
    check(len(flip) == 1 and st["plan0"]["embed"]["method"] == "allreduce",
          f"mesh launcher: no method flip {ad['replans']}")
    # the all-reduce's push is one-pass; the gatherv push (after the flip)
    # takes the plain scatter
    for run, on_allreduce in ((ad, flip[0]), (st, steps)):
        for m, c in enumerate(run["launches_by_rank"]):
            check(c["embed_gather"] == c["embed_gather_bulk"] == steps
                  and c["embed_scatter_add"] == c["embed_scatter_add_fused"]
                  == on_allreduce,
                  f"mesh launcher rank {m}: launches {c}, want {steps} bulk "
                  f"gathers and {on_allreduce} one-pass pushes")
    out["launches"] = ad["launches_by_rank"][0]
    for i, (a, b) in enumerate(zip(ad["losses"], st["losses"])):
        check(math.isfinite(a) and abs(a - b) < 5e-4 + 1e-4 * i,
              f"mesh launcher step {i}: {ad['losses']} vs {st['losses']}")
    out["max_abs_diff"] = max(abs(a - b) for a, b in
                              zip(ad["losses"], st["losses"]))
    return out


# mesh_card (e): the dense transformer on (2, 2); command-r's tied table
# under the two flag sets the reference runs it with
DENSE_MESH_RUNS = ((DENSE_ARCH, ("hybrid", "ps", "mpi")),
                   ("command-r-35b", ("hybrid", "mpi")))


def _one_pass_pushes(method: str, steps: int) -> int:
    """The one-pass embed_scatter_add launches a table's push makes in
    ``steps`` steps on ``method``: a replica's deduped buffer (ps, the
    dense exchange's local scatter) takes the kernel once a step; the
    gather pushes (ps_gather, mpi_gatherv) scatter gathered buffers with
    repeats on the plain scatter."""
    return 0 if method in ("ps_gather", "mpi_gatherv") else steps


def _dense_mesh_setup(arch: str) -> tuple:
    cfg = reduced(get_config(arch))
    return (cfg, ShapeConfig("mesh", 32, 4, "train"),
            _dense_batches(3, cfg.vocab_size, 32, 4))


def _dense_card_rank(rank: int, world: int) -> dict:
    """One of four ranks on the one card over gloo: reduced phi3 and
    command-r at f32 on a (2, 2) mesh, 3 steps under each flag set, every
    rank drawing the seed-0 init."""
    dev = torch.device("cuda", 0)
    mesh = make_mesh((2, 2), ("data", "model"), device=dev)
    out, total = {}, None
    for arch, names in DENSE_MESH_RUNS:
        cfg, shape, batches = _dense_mesh_setup(arch)
        for name in names:
            runner = get_runner(cfg, shape,
                                RunConfig(**DENSE_F32, attention_impl="naive",
                                          **MESH_FLAGS[name]),
                                mesh=mesh, seed=0)
            r = _timed_steps(runner, batches, dev)
            out[f"{arch}/{name}"] = {
                "losses": r["losses"], "step_ms": r["step_ms"],
                "method": runner.plan.table_methods["embed"],
                "bucketed": runner.plan.bucket_plan is not None,
                "launches": r["launches"]}
            total = r["launches"] if total is None else {
                k: total[k] + v for k, v in r["launches"].items()}
    out["launches"] = total
    return out


def phase_mesh_card_dense() -> dict:
    """mesh_card (e): four gloo ranks on the one card, reduced phi3 under
    hybrid, ps and mpi and reduced command-r (tied) under hybrid and mpi on
    (2, 2), each against the one-device card run from the same seed-0 init
    and batches within 5e-4 + 1e-4 i (the reference test's bar)."""
    single = {}
    for arch, _ in DENSE_MESH_RUNS:
        cfg, shape, batches = _dense_mesh_setup(arch)
        one = get_runner(cfg, shape, RunConfig(**DENSE_F32,
                                               attention_impl="naive"),
                         device="cuda", seed=0)
        single[arch] = [float(one.run(b)["loss"]) for b in batches]
        del one
    torch.cuda.empty_cache()
    ranks = spawn(_dense_card_rank, 4, "gloo", "cuda", timeout=600)
    rows = {}
    for arch, names in DENSE_MESH_RUNS:
        for name in names:
            key = f"{arch}/{name}"
            rs = [r[key] for r in ranks]
            got = rs[0]["losses"]
            check(all(r["losses"] == got for r in rs),
                  f"mesh_card (e) {key}: ranks disagree "
                  f"{[r['losses'] for r in rs]}")
            for i, (a, b) in enumerate(zip(got, single[arch])):
                check(abs(a - b) < 5e-4 + 1e-4 * i,
                      f"mesh_card (e) {key} step {i}: {got} vs one device "
                      f"{single[arch]}")
            want = _one_pass_pushes(rs[0]["method"], len(got))
            for m, r in enumerate(rs):
                c = r["launches"]
                check(c["embed_scatter_add"] == c["embed_scatter_add_fused"]
                      == want,
                      f"mesh_card (e) {key} rank {m}: pushes {c}, want "
                      f"{want} one-pass on {r['method']}")
            rows[key] = {"losses": got, "method": rs[0]["method"],
                         "bucketed": rs[0]["bucketed"],
                         "median_step_ms": statistics.median(
                             rs[0]["step_ms"]),
                         "max_abs_diff": max(abs(a - b) for a, b in
                                             zip(got, single[arch]))}
    counts = ranks[0]["launches"]
    runs = sum(len(n) for _, n in DENSE_MESH_RUNS)
    check(counts["embed_gather"] == counts["embed_gather_bulk"] == 3 * runs,
          f"mesh_card (e): gathers {counts}")
    res = {"phase": "mesh_card_dense", "backend": "gloo", "world": 4,
           "mesh": [2, 2], "one_device": single, "runs": rows,
           "launches": counts,
           "launches_by_rank": [r["launches"] for r in ranks]}
    emit(res)
    return res


def _replay_rank(rank: int, world: int, phase: str) -> dict:
    """One rank of a phase of the adaptive_replan replay on the one card,
    its kernel launches counted from 0."""
    from repro_torch.benchmarks import adaptive_replan
    ops.reset_launch_counts()
    res = getattr(adaptive_replan, phase)(rank, world, "cuda")
    return {"result": res, "launches": ops.launch_counts()}


def _replay_pushes(key: str, res: dict) -> int:
    """The one-pass pushes a replay phase makes, from the plans it ran
    under: phase 1's static run on its first plan, the adaptive run on its
    first plan up to the replan and on the new one after; phase 2's tables
    on the plan of each replan window."""
    from repro_torch.benchmarks.adaptive_replan import (PROFILE_STEPS,
                                                        REPLAN_EVERY, STEPS)
    if key == "single_table":
        st, ad = res["static"], res["adaptive"]
        return (_one_pass_pushes(st["before"]["method"], STEPS)
                + _one_pass_pushes(ad["before"]["method"], PROFILE_STEPS)
                + _one_pass_pushes(ad["after"]["method"],
                                   STEPS - PROFILE_STEPS))
    return sum(_one_pass_pushes(t["method"], REPLAN_EVERY)
               for p in res["trajectory"] if p["step"] < STEPS
               for t in p["tables"].values())


def phase_replan_replay() -> dict:
    """The port's ``benchmarks/adaptive_replan.py`` replay, both phases on
    8 gloo ranks on the one card ((4 data x 2 model) meshes): reduced phi3
    at vocab 256, static against a replan after step 4 (ps -> ps_gather,
    the loss divergence < 5e-3); reduced parallax-nmt's two tables through
    a burst (different methods and capacities, the capacity grows). The
    replay's own checks (``adaptive_replan.check``). Gloo through the host,
    8 processes sharing the card: the step times are not exchange
    times."""
    from repro_torch.benchmarks import adaptive_replan
    world = adaptive_replan.MESH[0] * adaptive_replan.MESH[1]
    res, launches, seconds = {}, None, {}
    for key, phase in (("single_table", "single_table_rank"),
                       ("two_table", "two_table_rank")):
        t = time.perf_counter()
        ranks = spawn(_replay_rank, world, "gloo", "cuda", args=(phase,),
                      timeout=600)
        seconds[key] = time.perf_counter() - t
        res[key] = ranks[0]["result"]
        want = _replay_pushes(key, res[key])
        for m, r in enumerate(ranks):
            c = r["launches"]
            check(c["embed_scatter_add"] == c["embed_scatter_add_fused"]
                  == want,
                  f"replan_replay {key} rank {m}: pushes {c}, want {want} "
                  "one-pass")
        c = ranks[0]["launches"]
        launches = c if launches is None else {
            k: launches[k] + v for k, v in c.items()}
    adaptive_replan.report(res)
    adaptive_replan.check(res)
    single, two = res["single_table"], res["two_table"]
    check(single["adaptive"]["replan"]["flips"] == [["embed", "ps",
                                                     "ps_gather"]],
          f"replan_replay: flips {single['adaptive']['replan']}")
    out = {"phase": "replan_replay", "backend": "gloo", "world": world,
           "seconds": seconds,
           "single_table": {k: single[k] for k in (
               "alpha_uniform", "alpha_zipf_analytic",
               "max_loss_divergence")},
           "static": {k: single["static"][k] for k in (
               "before", "pre_ms", "post_ms")},
           "adaptive": {k: single["adaptive"][k] for k in (
               "before", "after", "replan", "observed_alpha", "pre_ms",
               "post_ms")},
           "two_table": {"final_tables": {
               t: {k: e[k] for k in ("method", "capacity", "grown")}
               for t, e in two["final_tables"].items()},
               "embed_capacity": [p["tables"]["embed"]["capacity"]
                                  for p in two["trajectory"]]},
           "launches": launches}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# stablelm-12b's 160-wide heads and the slice-6 families
# ---------------------------------------------------------------------------

def phase_stablelm_parity() -> dict:
    """stablelm-12b at its published width (d 5,120, 32 q / 8 KV heads of
    160, d_ff 13,824, vocab 100,352) with n_layers cut to 2, f32,
    attention "pallas": one 256-token prompt through Server on the CPU and
    on the card from the same parameters. Prefill logits within rtol 1e-4
    (atol 1e-4 of their max-abs scale; the card's f32 GEMMs sum in another
    order), at most 2 of 8 greedy tokens different (the reference's
    allowance for argmax near-ties); each card prefill launches flash once
    a layer, on the f32 (scalar) route at D 160."""
    cfg = replace(get_config(STABLELM), n_layers=2)
    rc = RunConfig(attention_impl="pallas", param_dtype="float32",
                   compute_dtype="float32")
    scfg = ServerConfig(max_batch=1, max_seq=512)
    cpu = Server(cfg, rc, scfg, seed=0, device="cpu")
    gpu = Server(cfg, rc, scfg, device="cuda",
                 params={k: p.to("cuda") for k, p in cpu.params.items()})
    prompt = _prompts(np.random.default_rng(0), (256,), cfg.vocab_size)
    toks = torch.from_numpy(prompt[0][None])
    lc, _ = cpu.model.prefill_cache_fn(toks)
    ops.reset_launch_counts()
    lg, _ = gpu.model.prefill_cache_fn(toks.cuda())
    lg = lg.cpu()
    scale = float(lc.abs().max())
    diff = float((lg - lc).abs().max())
    check(torch.allclose(lg, lc, rtol=1e-4, atol=1e-4 * scale),
          f"stablelm_parity: prefill logits max abs diff {diff} (scale "
          f"{scale})")
    got = _drain(gpu, prompt, 8)
    counts = ops.launch_counts()
    want = _drain(cpu, prompt, 8)
    cpu.close()
    gpu.close()
    differ = sum(a != b for a, b in zip(got[0].out_tokens,
                                        want[0].out_tokens))
    check(differ <= 2, f"stablelm_parity: {differ} of 8 greedy tokens "
          f"differ: {got[0].out_tokens} vs {want[0].out_tokens}")
    check(counts["flash_attention"] == cfg.n_layers * 2
          and counts["flash_attention_tc"] == 0,
          f"stablelm_parity: flash launches {counts} for 2 prefills of "
          f"{cfg.n_layers} layers on the scalar route")
    res = {"phase": "stablelm_parity", "arch": cfg.name,
           "cut": f"n_layers 2 of {get_config(STABLELM).n_layers}",
           "prompt_len": 256, "logits_max_abs_diff": diff,
           "logits_max_abs": scale, "tokens_cpu": want[0].out_tokens,
           "tokens_cuda": got[0].out_tokens, "tokens_differ": differ,
           "flash_route": ops.flash_route(torch.float32, cfg.head_dim),
           "launches": counts}
    emit(res)
    return res


def _family_data(cfg, seq: int, batch: int) -> SyntheticLM:
    """Zipf(1.3) tokens; the audio family's stub frames (B, seq // 4, d)."""
    audio = cfg.family == "audio"
    return SyntheticLM(cfg.vocab_size, seq, batch, zipf_a=1.3,
                       is_encdec=cfg.is_encdec,
                       frames_dim=cfg.d_model if audio else 0,
                       frames_len=max(seq // 4, 1))


def _family_prefill_decode(arch: str, new: int = 4) -> dict:
    """Reduced ``arch`` at f32 with attention "pallas" on the CPU and on
    the card from the same parameters: prefill logits (the encoder's and
    the cross attention's non-causal, Sq != Sk products go to flash for
    seamless), then ``new`` decode steps through the model's cache; all
    within rtol 1e-4 (atol 1e-4 of the logits' scale)."""
    cfg = reduced(get_config(arch))
    rc = RunConfig(attention_impl="pallas", param_dtype="float32",
                   compute_dtype="float32")
    shape = ShapeConfig("serve", 32, 2, "decode")
    models = {}
    for d in ("cpu", "cuda"):
        rt = Runtime(cfg, rc, shape, device=d)
        models[d] = build_model(cfg, rt)
        rt.plan = analyze(models[d], rt)
    init_params_(models["cpu"], 0)
    load_params_(models["cuda"], {k: p.detach().to("cuda") for k, p in
                                  named_parameters(models["cpu"]).items()})
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
             _family_data(cfg, 32, 2).batch(0).items() if k != "labels"}
    worst, flash = 0.0, 0
    outs = {}
    for d, m in models.items():
        if d == "cuda":
            ops.reset_launch_counts()
        logits, _, _ = m.prefill_fn({k: v.to(d) for k, v in batch.items()})
        steps = []
        cache = m.init_cache(2, 32)
        toks = batch["tokens"][:, :new].to(d)
        for i in range(new):
            lg, cache = m.decode_fn(cache, toks[:, i:i + 1], i)
            steps.append(lg)
        if d == "cuda":
            flash = ops.launch_counts()["flash_attention"]
        outs[d] = [logits] + steps
    for i, (a, b) in enumerate(zip(outs["cpu"], outs["cuda"])):
        b = b.cpu()
        scale = float(a.abs().max())
        diff = float((a - b).abs().max())
        check(torch.allclose(b, a, rtol=1e-4, atol=1e-4 * scale),
              f"families_parity {arch}: {'prefill' if i == 0 else 'decode'}"
              f" {i} logits max abs diff {diff} (scale {scale})")
        worst = max(worst, diff / scale)
    check(flash > 0, f"families_parity {arch}: no flash launch")
    return {"max_rel_diff": worst, "flash_launches": flash}


def phase_families_parity() -> dict:
    """Reduced seamless-m4t-medium, hymba-1.5b, chameleon-34b and rwkv6-7b
    at f32 (naive attention, no remat), the same parameters and Zipf(1.3)
    batches, 3 training steps on the CPU and on the card: losses within
    rtol 1e-4, the embed_* census equal, a bulk gather and a one-pass
    scatter a step, and neither forward-only kernel launched. Seamless and
    hymba also prefill and decode with attention "pallas" on both
    (``_family_prefill_decode``)."""
    shape = ShapeConfig("parity", 32, 4, "train")
    out, total = {}, None
    for arch in FAMILY_TRAIN.values():
        cfg = reduced(get_config(arch))
        ds = _family_data(cfg, 32, 4)
        batches = [ds.batch(i) for i in range(3)]
        rc = RunConfig(**DENSE_F32, attention_impl="naive")
        cpu = get_runner(cfg, shape, rc, seed=0, device="cpu")
        gpu = get_runner(cfg, shape, rc, device="cuda", params={
            k: p.detach().to("cuda") for k, p in named_parameters(
                cpu.model).items()})
        rows = []
        ops.reset_launch_counts()
        for i, b in enumerate(batches):
            mc, mg = cpu.run(b), gpu.run(b)
            lc, lg = float(mc["loss"]), float(mg["loss"])
            check(math.isclose(lc, lg, rel_tol=1e-4),
                  f"families_parity {arch} step {i}: cpu loss {lc} vs card "
                  f"{lg}")
            for k in CENSUS:
                check(float(mc[k]) == float(mg[k]),
                      f"families_parity {arch} step {i}: {k} cpu "
                      f"{float(mc[k])} vs card {float(mg[k])}")
            rows.append({"cpu": lc, "cuda": lg,
                         "rel": abs(lc - lg) / abs(lc)})
        counts = ops.launch_counts()
        check(counts["embed_gather"] == counts["embed_gather_bulk"] == 3
              and counts["embed_scatter_add"] == 3
              and counts["embed_scatter_add_fused"] == 3
              and counts["flash_attention"] == counts["wkv"] == 0,
              f"families_parity {arch}: launches {counts}")
        total = counts if total is None else {
            k: total[k] + v for k, v in counts.items()}
        out[arch] = {"train": rows}
        del cpu, gpu
    for arch in ("seamless-m4t-medium", "hymba-1.5b"):
        ops.reset_launch_counts()
        out[arch]["pallas_prefill_decode"] = _family_prefill_decode(arch)
        counts = ops.launch_counts()
        total = {k: total[k] + v for k, v in counts.items()}
    res = {"phase": "families_parity", **out, "launches": total}
    emit(res)
    return res


ENCDEC_MESH_RUNS = ("hybrid", "mpi")


def _encdec_mesh_setup() -> tuple:
    cfg = reduced(get_config("seamless-m4t-medium"))
    ds = _family_data(cfg, 32, 4)
    return (cfg, ShapeConfig("mesh", 32, 4, "train"),
            [ds.batch(i) for i in range(3)])


def _encdec_card_rank(rank: int, world: int) -> dict:
    """One of four ranks on the one card over gloo: reduced seamless at f32
    on (2, 2), 3 steps under the default flags and comm_mode mpi, every
    rank drawing the seed-0 init."""
    dev = torch.device("cuda", 0)
    mesh = make_mesh((2, 2), ("data", "model"), device=dev)
    cfg, shape, batches = _encdec_mesh_setup()
    out, total = {}, None
    for name in ENCDEC_MESH_RUNS:
        runner = get_runner(cfg, shape,
                            RunConfig(**DENSE_F32, attention_impl="naive",
                                      **MESH_FLAGS[name]),
                            mesh=mesh, seed=0)
        r = _timed_steps(runner, batches, dev)
        out[name] = {"losses": r["losses"], "step_ms": r["step_ms"],
                     "method": runner.plan.table_methods["embed"],
                     "launches": r["launches"]}
        total = r["launches"] if total is None else {
            k: total[k] + v for k, v in r["launches"].items()}
    out["launches"] = total
    return out


def phase_mesh_card_encdec() -> dict:
    """mesh_card (f): four gloo ranks on the one card, reduced seamless
    (the encoder-decoder) under the default flags and comm_mode mpi on
    (2, 2), against the one-device card run from the same seed-0 init and
    batches within 5e-4 + 1e-4 i (the reference test's bar)."""
    cfg, shape, batches = _encdec_mesh_setup()
    one = get_runner(cfg, shape, RunConfig(**DENSE_F32,
                                           attention_impl="naive"),
                     device="cuda", seed=0)
    single = [float(one.run(b)["loss"]) for b in batches]
    del one
    torch.cuda.empty_cache()
    ranks = spawn(_encdec_card_rank, 4, "gloo", "cuda", timeout=600)
    rows = {}
    for name in ENCDEC_MESH_RUNS:
        rs = [r[name] for r in ranks]
        got = rs[0]["losses"]
        check(all(r["losses"] == got for r in rs),
              f"mesh_card (f) {name}: ranks disagree "
              f"{[r['losses'] for r in rs]}")
        for i, (a, b) in enumerate(zip(got, single)):
            check(abs(a - b) < 5e-4 + 1e-4 * i,
                  f"mesh_card (f) {name} step {i}: {got} vs one device "
                  f"{single}")
        want = _one_pass_pushes(rs[0]["method"], len(got))
        for m, r in enumerate(rs):
            c = r["launches"]
            check(c["embed_scatter_add"] == c["embed_scatter_add_fused"]
                  == want,
                  f"mesh_card (f) {name} rank {m}: pushes {c}, want {want} "
                  f"one-pass on {r['method']}")
        rows[name] = {"losses": got, "method": rs[0]["method"],
                      "median_step_ms": statistics.median(rs[0]["step_ms"]),
                      "max_abs_diff": max(abs(a - b) for a, b in
                                          zip(got, single))}
    counts = ranks[0]["launches"]
    check(counts["embed_gather"] == counts["embed_gather_bulk"]
          == 3 * len(ENCDEC_MESH_RUNS), f"mesh_card (f): gathers {counts}")
    res = {"phase": "mesh_card_encdec", "backend": "gloo", "world": 4,
           "mesh": [2, 2], "arch": cfg.name, "one_device": single,
           "runs": rows, "launches": counts,
           "launches_by_rank": [r["launches"] for r in ranks]}
    emit(res)
    return res


def _moe_engine_parity(cfg) -> dict:
    """Reduced ``cfg`` through the paged engine on the CPU and on the card,
    f32 and attention "pallas", the same parameters: one 40-token prompt's
    bucket-padded prefill logits (its 24 pad tokens are routed too) within
    1e-4 of their scale, then 8 greedy tokens of it, at most 2 different
    (the reference's allowance for argmax near-ties)."""
    rc = RunConfig(attention_impl="pallas", param_dtype="float32",
                   compute_dtype="float32")
    scfg = ServerConfig(max_batch=1, max_seq=64)
    cpu = Server(cfg, rc, scfg, seed=0, device="cpu")
    gpu = Server(cfg, rc, scfg, device="cuda",
                 params={k: p.to("cuda") for k, p in cpu.params.items()})
    prompt = _prompts(np.random.default_rng(0), (40,), cfg.vocab_size)
    toks = torch.zeros((1, bucket_len(40, 64)), dtype=torch.int32)
    toks[0, :40] = torch.from_numpy(prompt[0])
    lc, _ = cpu.model.prefill_cache_fn(toks)
    lg, _ = gpu.model.prefill_cache_fn(toks.cuda())
    lg = lg.cpu()
    scale = float(lc.abs().max())
    diff = float((lg - lc).abs().max())
    check(torch.allclose(lg, lc, rtol=1e-4, atol=1e-4 * scale),
          f"moe_parity {cfg.name}: prefill logits max abs diff {diff} "
          f"(scale {scale})")
    got = _drain(gpu, prompt, 8)
    want = _drain(cpu, prompt, 8)
    cpu.close()
    gpu.close()
    differ = sum(a != b for a, b in zip(got[0].out_tokens,
                                        want[0].out_tokens))
    check(differ <= 2, f"moe_parity {cfg.name}: {differ} of 8 greedy tokens "
          f"differ: {got[0].out_tokens} vs {want[0].out_tokens}")
    return {"prompt_len": 40, "bucket": int(toks.shape[1]),
            "decode_steps": gpu.stats["decode_steps"],
            "logits_max_abs_diff": diff, "logits_max_abs": scale,
            "tokens_cpu": want[0].out_tokens,
            "tokens_cuda": got[0].out_tokens, "tokens_differ": differ}


def phase_moe_parity() -> dict:
    """Reduced grok-1-314b (4 experts, top-2) and llama4-maverick-400b-a17b
    (4 experts, top-1, the shared expert) at f32 (naive attention, no
    remat), the same parameters and Zipf(1.3) batches, 3 training steps on
    the CPU and on the card: losses within rtol 1e-4, moe_dropped and the
    embed_* census equal, a bulk gather and a one-pass scatter a step, no
    flash launch in training. Then each through the paged engine with
    attention "pallas" (``_moe_engine_parity``): 2 prefills of flash's
    scalar route (f32) a layer."""
    shape = ShapeConfig("parity", 32, 4, "train")
    out, total = {}, None
    for arch in (GROK, LLAMA4):
        cfg = reduced(get_config(arch))
        ds = _family_data(cfg, 32, 4)
        rc = RunConfig(**DENSE_F32, attention_impl="naive")
        cpu = get_runner(cfg, shape, rc, seed=0, device="cpu")
        gpu = get_runner(cfg, shape, rc, device="cuda", params={
            k: p.detach().to("cuda") for k, p in named_parameters(
                cpu.model).items()})
        rows = []
        ops.reset_launch_counts()
        for i in range(3):
            b = ds.batch(i)
            mc, mg = cpu.run(b), gpu.run(b)
            lc, lg = float(mc["loss"]), float(mg["loss"])
            check(math.isclose(lc, lg, rel_tol=1e-4),
                  f"moe_parity {arch} step {i}: cpu loss {lc} vs card {lg}")
            for k in CENSUS + ("moe_dropped",):
                check(float(mc[k]) == float(mg[k]),
                      f"moe_parity {arch} step {i}: {k} cpu "
                      f"{float(mc[k])} vs card {float(mg[k])}")
            rows.append({"cpu": lc, "cuda": lg, "rel": abs(lc - lg) / abs(lc),
                         "moe_dropped": float(mg["moe_dropped"]),
                         "moe_aux_cpu": float(mc["moe_aux"]),
                         "moe_aux_cuda": float(mg["moe_aux"])})
        del cpu, gpu
        engine = _moe_engine_parity(cfg)
        counts = ops.launch_counts()
        gathers = 3 + 2 + engine["decode_steps"]
        check(counts["embed_gather"] == counts["embed_gather_bulk"] == gathers
              and counts["embed_scatter_add"] == 3
              and counts["embed_scatter_add_fused"] == 3
              and counts["flash_attention"] == 2 * cfg.n_layers
              and counts["flash_attention_tc"] == 0,
              f"moe_parity {arch}: launches {counts} (3 training steps, "
              f"2 engine prefills, {engine['decode_steps']} decode steps)")
        total = counts if total is None else {
            k: total[k] + v for k, v in counts.items()}
        out[arch] = {"train": rows, "engine": engine}
    res = {"phase": "moe_parity", **out, "launches": total}
    emit(res)
    return res


# mesh_card (g): reduced grok-1 as tests/test_transform_correctness.py runs
# it (capacity factor 8: no drops; SGD at 0.3), f32, on (2, 2): the default
# moe_exec (ep: 2 of the 4 experts a rank) under hybrid and mpi, and tp
MOE_MESH_RUNS = {"hybrid": {}, "mpi": {"comm_mode": "mpi"},
                 "tp": {"moe_exec": "tp"}}
MOE_MESH_KW = dict(DENSE_F32, attention_impl="naive", optimizer="sgd",
                   learning_rate=0.3)


def _moe_mesh_setup() -> tuple:
    cfg = replace(reduced(get_config(GROK)), moe_capacity_factor=8.0)
    ds = SyntheticLM(cfg.vocab_size, 32, 4)
    return (cfg, ShapeConfig("mesh", 32, 4, "train"),
            [ds.batch(i) for i in range(3)])


def _moe_card_rank(rank: int, world: int, shape: tuple, runs: tuple) -> dict:
    """One of the ranks on the one card over gloo: reduced grok-1 on
    ``shape``, 3 steps under each of ``runs``, every rank drawing the
    seed-0 init; its expert leaves' shapes and bytes."""
    dev = torch.device("cuda", 0)
    mesh = make_mesh(shape, ("data", "model"), device=dev)
    cfg, sh, batches = _moe_mesh_setup()
    out, total = {}, None
    for name in runs:
        runner = get_runner(cfg, sh, RunConfig(**MOE_MESH_KW,
                                               **MOE_MESH_RUNS[name]),
                            mesh=mesh, seed=0)
        r = _timed_steps(runner, batches, dev)
        experts = {n: p for n, p in named_parameters(runner.model).items()
                   if n.split(".")[-1] in ("w_gate", "w_up", "w_down")}
        out[name] = {"losses": r["losses"], "step_ms": r["step_ms"],
                     "method": runner.plan.table_methods["embed"],
                     "exec": pick_exec_mode(cfg, runner.rt),
                     "w_gate_shape": list(experts["layers.moe.w_gate"]
                                          .shape),
                     "expert_bytes": sum(p.numel() * p.element_size()
                                         for p in experts.values()),
                     "launches": r["launches"]}
        total = r["launches"] if total is None else {
            k: total[k] + v for k, v in r["launches"].items()}
    out["launches"] = total
    return out


def phase_mesh_card_moe() -> dict:
    """mesh_card (g): four gloo ranks on the one card, reduced grok-1 on
    (2, 2). ep (hybrid, mpi) within 5e-4 + 1e-4 i of the one-device card
    run (the reference test's bar), each rank's w_gate holding 2 of the 4
    experts. tp holds every expert's d_ff/2 block a rank ((L, E, d, f/2)
    w_gate: the expert outputs summed over model) and routes each
    replica's rows whole, so it is held to the data-parallel (2, 1) run
    (two more ranks) within the same bar: its aux is averaged over the
    two data shards, as the JAX package's is on a (2, 1) mesh."""
    cfg, shape, batches = _moe_mesh_setup()
    one = get_runner(cfg, shape, RunConfig(**MOE_MESH_KW), device="cuda",
                     seed=0)
    single = [float(one.run(b)["loss"]) for b in batches]
    del one
    torch.cuda.empty_cache()
    ranks = spawn(_moe_card_rank, 4, "gloo", "cuda",
                  args=((2, 2), tuple(MOE_MESH_RUNS)), timeout=600)
    dp = spawn(_moe_card_rank, 2, "gloo", "cuda", args=((2, 1), ("hybrid",)),
               timeout=600)[0]["hybrid"]
    rows = {}
    e, f = cfg.n_experts, cfg.d_ff
    for name in MOE_MESH_RUNS:
        rs = [r[name] for r in ranks]
        got = rs[0]["losses"]
        check(all(r["losses"] == got for r in rs),
              f"mesh_card (g) {name}: ranks disagree "
              f"{[r['losses'] for r in rs]}")
        ep = name != "tp"
        want = single if ep else dp["losses"]
        for i, (a, b) in enumerate(zip(got, want)):
            check(abs(a - b) < 5e-4 + 1e-4 * i,
                  f"mesh_card (g) {name} step {i}: {got} vs "
                  f"{'one device' if ep else 'the (2, 1) mesh'} {want}")
        # ep: 2 of the 4 experts a rank; tp: every expert's d_ff/2 block
        check(all(r["exec"] == ("ep" if ep else "tp")
                  and r["w_gate_shape"][1] == (e // 2 if ep else e)
                  and r["w_gate_shape"][3] == (f if ep else f // 2)
                  for r in rs),
              f"mesh_card (g) {name}: {[r['w_gate_shape'] for r in rs]}")
        pushes = _one_pass_pushes(rs[0]["method"], len(got))
        for m, r in enumerate(rs):
            c = r["launches"]
            check(c["embed_scatter_add"] == c["embed_scatter_add_fused"]
                  == pushes,
                  f"mesh_card (g) {name} rank {m}: pushes {c}, want "
                  f"{pushes} one-pass on {r['method']}")
        rows[name] = {"losses": got, "method": rs[0]["method"],
                      "exec": rs[0]["exec"],
                      "w_gate_shape": rs[0]["w_gate_shape"],
                      "expert_bytes_per_rank": rs[0]["expert_bytes"],
                      "median_step_ms": statistics.median(rs[0]["step_ms"]),
                      "max_abs_diff": max(abs(a - b) for a, b in
                                          zip(got, want))}
    counts = ranks[0]["launches"]
    check(counts["embed_gather"] == counts["embed_gather_bulk"]
          == 3 * len(MOE_MESH_RUNS), f"mesh_card (g): gathers {counts}")
    res = {"phase": "mesh_card_moe", "backend": "gloo", "world": 4,
           "mesh": [2, 2], "arch": cfg.name, "one_device": single,
           "data_parallel_2x1": dp["losses"], "runs": rows,
           "launches": counts,
           "launches_by_rank": [r["launches"] for r in ranks]}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# the serve mesh and tensor-parallel blocks (two and four gloo ranks on the
# one card: their times are not exchange times)
# ---------------------------------------------------------------------------

SERVE_MESH = (1, 2)


def _param_bytes(sv) -> tuple:
    """(this rank's parameter bytes, the plan's parameter term: each
    leaf's whole bytes over the shards of its placement)."""
    whole = dict(sv.model.param_specs())
    got = want = 0
    for n, t in sv.params.items():
        p = sv.plan.params[n]
        shards = math.prod(sv.rt.mesh.axes_size(a) for a in p.held
                           if a is not None)
        got += t.numel() * t.element_size()
        want += math.prod(whole[n].shape) * t.element_size() // shards
    return got, want


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp(min=1e-30)))
                      - 7)


def _teacher_forced(sv, prompts: dict, tokens: dict,
                    keep: bool = False) -> dict:
    """Each request's prompt and its generated tokens through one
    cache-less prefill (``prefill_fn``, flash under "pallas"): the greedy
    token at every generated position against ``tokens`` (a run's
    decode-loop tokens). Where they differ, the gap between the largest
    logit and ``tokens``' one in bf16 steps of the row's largest magnitude
    (a near-tie is a step or two). ``keep``: the logits of the generated
    positions too (f32, {uid: (new, vocab)})."""
    from repro_torch.core import collectives as coll
    rt = sv.rt
    out = {"positions": 0, "differ": 0, "gap_steps": [], "scale_max": 0.0}
    if keep:
        out["logits"] = {}
    for u, toks in sorted(tokens.items()):
        prompt = prompts[u]
        seq = np.concatenate([prompt, np.asarray(toks[:-1], np.int32)])
        t = torch.from_numpy(seq[None]).to(rt.device)
        logits, _, _ = sv.model.prefill_fn({"tokens": t})
        logits = logits[0, len(prompt) - 1:].float()
        if rt.vocab_shards > 1:
            logits = coll.all_gather(logits, "model", rt.mesh, dim=-1)
        logits = logits[:, :rt.model_cfg.vocab_size]
        want = torch.tensor(toks, device=logits.device)
        scale = logits.abs().max(dim=-1).values
        gap = (logits.max(dim=-1).values
               - logits.gather(1, want[:, None])[:, 0]) / _bf16_step(scale)
        bad = logits.argmax(dim=-1) != want
        out["positions"] += len(toks)
        out["differ"] += int(bad.sum())
        out["gap_steps"] += gap[bad].tolist()
        out["scale_max"] = max(out["scale_max"], float(scale.max()))
        if keep:
            out["logits"][u] = logits.cpu().numpy()
    return out


def _serve_mesh_rank(rank: int, world: int, new: int,
                     serve_tokens: dict) -> dict:
    """One of two ranks on the one card over gloo: full-width
    phi3-medium-14b served on (1, 2) as ``serve`` serves it (the same
    seed, prompts and warm-up request), every rank holding half the q
    heads, half of d_ff and half the vocab rows, and the cache's positions
    [rank * 1,024, (rank + 1) * 1,024)."""
    dev = torch.device("cuda", 0)
    mesh = make_mesh(SERVE_MESH, ("data", "model"), device=dev)
    cfg = serve_config(DENSE_ARCH)
    scfg = ServerConfig(max_batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sv = Server(cfg, RunConfig(attention_impl="pallas"), scfg, mesh=mesh,
                seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    lens, prompts = _serve_prompts(rng, cfg.vocab_size)
    _drain(sv, _prompts(rng, (100,), cfg.vocab_size), 2)
    before = {k: sv.stats[k] for k in ("prefill_calls", "decode_steps")}
    sv.completed.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t = time.perf_counter()
    done = _drain(sv, prompts, new)
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    flash_tc = ops.flash_attention.launches_tc
    serve_peak = torch.cuda.max_memory_allocated(dev)
    ttft = sorted(r.ttft for r in done.values())
    timer = Timer(dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 2048))
                            .astype(np.int32)).to(dev)
    prefill_ms = timer.ms(lambda: sv._prefill(
        sv.cache, sv.lens, sv.tok, toks, 2048, 0, sv._gen), 3)
    active = torch.ones(sv._local, dtype=torch.bool, device=dev)
    sv.lens.fill_(1024)
    decode_ms = timer.ms(lambda: sv._decode(sv.cache, sv.lens, sv.tok,
                                             active, sv._gen), 10)
    got, want = _param_bytes(sv)
    forced = _teacher_forced(sv, dict(enumerate(prompts)), serve_tokens,
                             keep=rank == 0)
    return {"rank": rank, "teacher_forced": forced,
            "tokens": {u: list(r.out_tokens)
                                     for u, r in done.items()},
            "prefill_calls": sv.stats["prefill_calls"]
            - before["prefill_calls"],
            "decode_steps": sv.stats["decode_steps"] - before["decode_steps"],
            "cross_slot_mismatches": sv.stats["cross_slot_mismatches"],
            "launches": counts, "flash_attention_launches_tc": flash_tc,
            "cache_shape": list(sv.cache[0].shape),
            "wq_shape": list(sv.params["layers.attn.wq"].shape),
            "param_bytes": got, "plan_param_bytes": want,
            "setup_s": setup_s, "init_peak_bytes": init_peak,
            "max_memory_allocated": serve_peak, "run_s": wall,
            "ttft_ms_p50": ttft[len(ttft) // 2] * 1e3,
            "ttft_ms_max": ttft[-1] * 1e3,
            "prefill_2048_ms": prefill_ms, "decode_step_ms": decode_ms}


def phase_mesh_card_serve(serve: dict, new: int = 16) -> dict:
    """mesh_card (h): full-width phi3-medium-14b, all 40 layers, served on
    a (1, 2) mesh of two gloo ranks on the one card (bf16, attention
    "pallas", the 8 requests of ``serve``): the attention and MLP
    tensor-parallel over ``model``, each rank's decode cache (40, 4,
    1,024, 10, 128), its block of the positions. Every prefill launches
    flash once a layer on every rank on the tc route, at the rank's 20 q
    heads; every prefill and decode step one bulk gather of the rank's
    table. The tokens: every request's prompt and ``serve``'s greedy
    tokens through one cache-less prefill on the mesh
    (``_teacher_forced``): where the mesh's greedy token differs, the gap
    to ``serve``'s token is a near-tie, no wider than the gaps by which
    one device's own prefill and decode loop disagree (``serve``'s
    teacher-forced pass) and at least 2 bf16 steps of the row's scale. At
    bf16 the random-weight logits hold many such ties, so free-running
    runs diverge for good at the first: their first divergences, and the
    logits' largest deviation from one device's, are reported. Each
    rank's parameter bytes the plan's; the peaks under 72 GB."""
    cfg = serve_config(DENSE_ARCH)
    ranks = spawn(_serve_mesh_rank, 2, "gloo", "cuda",
                  args=(new, serve["tokens"]), timeout=900)
    r0 = ranks[0]
    check(all(r["tokens"] == r0["tokens"] for r in ranks),
          "mesh_card (h): the ranks' tokens differ")
    # free-running greedy tokens diverge for good at the first argmax
    # near-tie; the teacher-forced pass holds each position on its own
    differ = {u: next(i for i, (a, b) in enumerate(zip(
        toks, serve["tokens"][u])) if a != b)
        for u, toks in r0["tokens"].items() if toks != serve["tokens"][u]}
    forced = r0["teacher_forced"]
    mine = forced.pop("logits")
    logit_err = max(float(np.abs(mine[u] - w).max())
                    for u, w in serve["teacher_forced_logits"].items())
    # a near-tie: no wider than one device's own prefill and decode loop
    # disagree (serve's teacher-forced gaps), and at least 2 bf16 steps
    near = max([2.0] + serve["teacher_forced"]["gap_steps"])
    check(len(r0["tokens"]) == len(serve["tokens"]),
          f"mesh_card (h): {len(r0['tokens'])} requests served")
    check(all(g <= near for g in forced["gap_steps"]),
          f"mesh_card (h): greedy tokens off serve's by more than a "
          f"near-tie ({near} bf16 steps): gaps {forced['gap_steps']}")
    for r in ranks:
        m = r["rank"]
        c = r["launches"]
        check(r["cross_slot_mismatches"] == 0,
              f"mesh_card (h) rank {m}: cross-slot mismatches")
        check(c["flash_attention"] == cfg.n_layers * r["prefill_calls"]
              == r["flash_attention_launches_tc"],
              f"mesh_card (h) rank {m}: flash {c['flash_attention']} "
              f"launches ({r['flash_attention_launches_tc']} tc) in "
              f"{r['prefill_calls']} prefills")
        check(c["embed_gather"] == c["embed_gather_bulk"]
              == r["prefill_calls"] + r["decode_steps"],
              f"mesh_card (h) rank {m}: gathers {c}")
        check(r["param_bytes"] == r["plan_param_bytes"],
              f"mesh_card (h) rank {m}: {r['param_bytes']} parameter "
              f"bytes, the plan's {r['plan_param_bytes']}")
        check(r["cache_shape"] == [cfg.n_layers, SERVE_BATCH,
                                   SERVE_MAX_SEQ // 2, cfg.n_kv_heads,
                                   cfg.head_dim],
              f"mesh_card (h) rank {m}: cache {r['cache_shape']}")
        check(max(r["init_peak_bytes"], r["max_memory_allocated"])
              < PEAK_LIMIT, f"mesh_card (h) rank {m}: peaks "
              f"{r['init_peak_bytes']}, {r['max_memory_allocated']}")
    keys = ("param_bytes", "plan_param_bytes", "wq_shape", "cache_shape",
            "setup_s", "init_peak_bytes", "max_memory_allocated", "run_s",
            "ttft_ms_p50", "ttft_ms_max", "prefill_2048_ms",
            "decode_step_ms", "prefill_calls", "decode_steps")
    res = {"phase": "mesh_card_serve", "backend": "gloo", "world": 2,
           "mesh": list(SERVE_MESH), "arch": cfg.name,
           "n_layers": cfg.n_layers,
           "free_running_first_divergence": differ,
           "teacher_forced": forced,
           "serve_teacher_forced": serve["teacher_forced"],
           "teacher_forced_max_abs_err": logit_err,
           "near_tie_steps": near,
           "serve_prefill_2048_ms": serve["prefill_ms_by_bucket"].get(2048),
           "serve_decode_step_ms": serve["decode_step_ms_median"],
           "by_rank": [{k: r[k] for k in keys} for r in ranks],
           "launches": r0["launches"],
           "launches_by_rank": [r["launches"] for r in ranks],
           "flash_attention_launches_tc": r0["flash_attention_launches_tc"],
           "first_tokens": {u: t[:4] for u, t in r0["tokens"].items()},
           "nvidia_smi": nvidia_smi("power.limit")}
    emit(res)
    return res


TP_ARCHS = (DENSE_ARCH, "command-r-35b")
TP_SCFG = dict(max_batch=4, max_seq=64)
# prefill slot 0 (3 positions, all in the first rank's block) and slot 2
# (37: across the boundary at 32), then 4 decode steps over both
TP_SCRIPT = ((0, 3), (2, 37))
TP_DECODE = 4


def _tp_logits(sv, rng) -> dict:
    """The engine's own prefill and decode steps on TP_SCRIPT, the logits
    gathered whole (over the vocab shards and the data ranks)."""
    from repro_torch.core import collectives as coll
    rt, rec = sv.rt, []

    def whole(logits):
        if rt.vocab_shards > 1:
            logits = coll.all_gather(logits, "model", rt.mesh, dim=-1)
        return logits[..., :rt.model_cfg.vocab_size].float()

    pre, dec = sv.model.prefill_cache_fn, sv.model.decode_fn

    def prefill(tokens):
        logits, kv = pre(tokens)
        rec.append(whole(logits))
        return logits, kv

    def decode(cache, tokens, lens):
        logits, cache = dec(cache, tokens, lens)
        rec.append(_gather_slots(sv.rt, whole(logits)))
        return logits, cache

    sv.model.prefill_cache_fn, sv.model.decode_fn = prefill, decode
    out = {"prefill": {}, "decode": [], "tokens": []}
    try:
        for slot, n in TP_SCRIPT:
            prompt = rng.integers(1, rt.model_cfg.vocab_size, n)
            padded = torch.zeros((1, bucket_len(n, TP_SCFG["max_seq"])),
                                 dtype=torch.int32, device=rt.device)
            padded[0, :n] = torch.from_numpy(prompt)
            j = slot - sv._first
            if 0 <= j < sv._local:
                sv._prefill(sv.cache, sv.lens, sv.tok, padded, n, j, sv._gen)
                out["prefill"][slot] = rec[-1][0, :n].cpu().numpy()
            out["tokens"].append(
                _gather_slots(sv.rt, sv.tok)[:, 0].tolist())
        active = torch.zeros(TP_SCFG["max_batch"], dtype=torch.bool)
        active[[s for s, _ in TP_SCRIPT]] = True
        active = active[sv._first:sv._first + sv._local].to(rt.device)
        for _ in range(TP_DECODE):
            *_, toks = sv._decode(sv.cache, sv.lens, sv.tok, active, sv._gen)
            out["decode"].append(rec[-1][:, 0].cpu().numpy())
            out["tokens"].append(_gather_slots(sv.rt, toks).tolist())
    finally:
        sv.model.prefill_cache_fn, sv.model.decode_fn = pre, dec
    return out


def _tp_card_rank(rank: int, world: int) -> dict:
    """One of four ranks on the one card over gloo, (2, 2): reduced phi3
    and command-r at f32, 3 training steps with the layers tensor-parallel
    (plain and explicit_sp), then the serve mesh's logits."""
    dev = torch.device("cuda", 0)
    mesh = make_mesh((2, 2), ("data", "model"), device=dev)
    out, total = {}, None
    for arch in TP_ARCHS:
        cfg, shape, batches = _dense_mesh_setup(arch)
        for explicit_sp in (False, True):
            runner = get_runner(
                cfg, shape, RunConfig(**DENSE_F32, attention_impl="naive",
                                      explicit_sp=explicit_sp),
                mesh=mesh, seed=0)
            r = _timed_steps(runner, batches, dev)
            out[f"{arch}/{'sp' if explicit_sp else 'tp'}"] = {
                "losses": r["losses"], "step_ms": r["step_ms"],
                "method": runner.plan.table_methods["embed"],
                "wq_shape": list(runner.model.get_parameter(
                    "layers.attn.wq").shape)}
            total = r["launches"] if total is None else {
                k: total[k] + v for k, v in r["launches"].items()}
        ops.reset_launch_counts()
        sv = Server(cfg, RunConfig(**DENSE_F32, attention_impl="pallas"),
                    ServerConfig(**TP_SCFG), mesh=mesh, seed=0)
        logits = _tp_logits(sv, np.random.default_rng(0))
        logits["cache_shape"] = list(sv.cache[0].shape)
        out[f"{arch}/serve"] = logits
        total = {k: total[k] + v for k, v in ops.launch_counts().items()}
    out["launches"] = total
    return out


def phase_mesh_card_tp() -> dict:
    """mesh_card (i): four gloo ranks on the one card, (2, 2), reduced phi3
    and command-r (tied) at f32: 3 training steps with the attention and
    MLP tensor-parallel, plain and under explicit_sp (core/sp.py's
    sequence-parallel blocks), each within 5e-4 + 1e-4 i of the one-device
    card run; the serve mesh's prefill and decode logits (flash on the
    scalar route at each rank's 2 q heads) within rtol 1e-4 of a
    one-device card Server's (scaled by the largest logit), no greedy token
    different, each rank's cache (2, 2, 32, 2, 16)."""
    single, one_serve = {}, {}
    for arch in TP_ARCHS:
        cfg, shape, batches = _dense_mesh_setup(arch)
        one = get_runner(cfg, shape, RunConfig(**DENSE_F32,
                                               attention_impl="naive"),
                         device="cuda", seed=0)
        single[arch] = [float(one.run(b)["loss"]) for b in batches]
        del one
        sv = Server(cfg, RunConfig(**DENSE_F32, attention_impl="pallas"),
                    ServerConfig(**TP_SCFG), seed=0)
        one_serve[arch] = _tp_logits(sv, np.random.default_rng(0))
        sv.close()
    torch.cuda.empty_cache()
    ranks = spawn(_tp_card_rank, 4, "gloo", "cuda", timeout=600)
    rows = {}
    for arch in TP_ARCHS:
        for mode in ("tp", "sp"):
            key = f"{arch}/{mode}"
            got = ranks[0][key]["losses"]
            check(all(r[key]["losses"] == got for r in ranks),
                  f"mesh_card (i) {key}: ranks disagree")
            for i, (a, b) in enumerate(zip(got, single[arch])):
                check(abs(a - b) < 5e-4 + 1e-4 * i,
                      f"mesh_card (i) {key} step {i}: {got} vs one device "
                      f"{single[arch]}")
            rows[key] = {"losses": got, "method": ranks[0][key]["method"],
                         "wq_shape": ranks[0][key]["wq_shape"],
                         "median_step_ms": statistics.median(
                             ranks[0][key]["step_ms"]),
                         "max_abs_diff": max(abs(a - b) for a, b in
                                             zip(got, single[arch]))}
        want, err = one_serve[arch], 0.0
        for r in ranks:
            s = r[f"{arch}/serve"]
            check(s["tokens"] == want["tokens"],
                  f"mesh_card (i) {arch} serve: tokens {s['tokens']} vs one "
                  f"device {want['tokens']}")
            pairs = [(g, want["prefill"][k]) for k, g in s["prefill"].items()]
            pairs += list(zip(s["decode"], want["decode"]))
            for g, w in pairs:
                e = float(np.abs(g - w).max() / np.abs(w).max())
                check(e <= 1e-4, f"mesh_card (i) {arch} serve: logits "
                      f"{e} of their scale from one device")
                err = max(err, e)
            check(s["cache_shape"] == [2, 2, 32, 2, 16],
                  f"mesh_card (i) {arch}: cache {s['cache_shape']}")
        rows[f"{arch}/serve"] = {"max_scaled_err": err,
                                 "tokens": want["tokens"][-1]}
    counts = ranks[0]["launches"]
    pushes = sum(_one_pass_pushes(ranks[0][f"{a}/{m}"]["method"], 3)
                 for a in TP_ARCHS for m in ("tp", "sp"))
    check(counts["embed_scatter_add"] == counts["embed_scatter_add_fused"]
          == pushes, f"mesh_card (i): pushes {counts}, want {pushes}")
    check(counts["flash_attention"] > 0, f"mesh_card (i): flash {counts}")
    res = {"phase": "mesh_card_tp", "backend": "gloo", "world": 4,
           "mesh": [2, 2], "one_device": single, "runs": rows,
           "launches": counts,
           "launches_by_rank": [r["launches"] for r in ranks]}
    emit(res)
    return res


# ZeRO-1 and the dp dense strategy at full width
# (``profile_step.MESH_CELLS``: their cuts and knobs)
# 2 steps each: the script's mesh phases of the recurrent blocks, the tp
# experts and ToyServer add ~310 s, and a step of these two cells is
# 4-15 s of gloo's host staging
MESH_STEPS = 2
DP_RTOL = 2e-2              # the families' bf16 bar (test_torch_families)


def _cell_batches(name: str) -> list:
    cell = MESH_CELLS[name]
    ds = SyntheticLM(mesh_cell_config(name).vocab_size, cell.shape.seq_len,
                     cell.shape.global_batch, **cell.data)
    return [ds.batch(i) for i in range(MESH_STEPS)]


def _state_layout(runner) -> dict:
    """This rank's parameter and moment elements per leaf, and its
    parameter and moment bytes beside the plan's terms
    (``per_device_bytes``: the parameter term at the parameters' itemsize,
    the optimizer term at 8 bytes an element)."""
    plan, st = runner.plan, runner.state
    specs = flatten_specs(runner.model.specs())
    plans = [plan.params[n] for n, _ in specs]
    itemsize = torch.empty((), dtype=runner.rt.param_dtype).element_size()
    nbytes = lambda tree: sum(t.numel() * t.element_size()
                              for t in tree.values())
    return {
        "leaves": {n: {"param": st.params[n].numel(),
                       "whole": math.prod(spec.shape),
                       "m": st.m[n].numel(), "v": st.v[n].numel(),
                       "sparse": p.sparse}
                   for (n, spec), p in zip(specs, plans)},
        "param_bytes": nbytes(st.params),
        "plan_param_bytes": per_device_bytes(specs, plan.rules, plans,
                                             dtype_bytes=itemsize,
                                             opt_bytes=0),
        "moment_bytes": nbytes(st.m) + nbytes(st.v),
        "plan_moment_bytes": per_device_bytes(specs, plan.rules, plans,
                                              dtype_bytes=0)}


def _mesh_cell_rank(rank: int, world: int, name: str,
                    zero_stages: tuple) -> dict:
    """One gloo rank on the card of ``MESH_CELLS[name]``: MESH_STEPS from the
    seed-0 init at each of ``zero_stages`` in turn (the first run freed
    before the next), under deterministic algorithms. Each run's losses,
    step ms, launches (set to 0 just before its steps), layout, and peak
    memory at init and over the steps."""
    cell = MESH_CELLS[name]
    dev = torch.device("cuda", 0)
    mesh = make_mesh(cell.mesh, ("data", "model"), device=dev)
    cfg, batches = mesh_cell_config(name), _cell_batches(name)
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for z in zero_stages:
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            runner = get_runner(cfg, cell.shape,
                                replace(cell.run, zero_stage=z), mesh=mesh,
                                seed=0)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            init_peak = torch.cuda.max_memory_allocated(dev)
            r = _timed_steps(runner, batches, dev)
            r.update(_state_layout(runner), setup_s=setup_s,
                     init_max_memory_allocated=init_peak,
                     zero_stage=runner.plan.zero_stage,
                     fused_apply=runner.plan.fused_apply,
                     strategy=runner.rt.resolved_strategy,
                     batch_axes=list(runner.rt.batch_axes),
                     method=runner.plan.table_methods["embed"])
            out[z] = r
            del runner
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def _check_cell_rank(phase: str, m: int, r: dict, shards: int) -> None:
    """One rank's run: each dense leaf's moments 1/``shards`` of it (at
    zero_stage 1), the sparse table's whole, the bytes the plan's terms,
    and the embed kernels' launches as the plan's method predicts."""
    z = r["zero_stage"]
    for n, x in r["leaves"].items():
        want = x["param"] if x["sparse"] or z == 0 else x["param"] // shards
        check(x["m"] == x["v"] == want and (x["sparse"] or z == 0
                                            or want * shards == x["param"]),
              f"{phase} rank {m} zero {z}: {n} moments {x}, want {want}")
        check(x["param"] == x["whole"],
              f"{phase} rank {m}: {n} holds {x['param']} of {x['whole']}")
    check(r["param_bytes"] == r["plan_param_bytes"]
          and r["moment_bytes"] == r["plan_moment_bytes"],
          f"{phase} rank {m} zero {z}: bytes {r['param_bytes']} / "
          f"{r['moment_bytes']} vs the plan's {r['plan_param_bytes']} / "
          f"{r['plan_moment_bytes']}")
    check(r["method"] == "allreduce" and r["fused_apply"] == (z == 0),
          f"{phase} rank {m}: method {r['method']}, fused "
          f"{r['fused_apply']} at zero {z}")
    steps, c = len(r["losses"]), r["launches"]
    pushes = _one_pass_pushes(r["method"], steps)
    check(c["embed_gather"] == c["embed_gather_bulk"] == steps
          and c["embed_scatter_add"] == c["embed_scatter_add_fused"]
          == pushes,
          f"{phase} rank {m} zero {z}: launches {c}, want {steps} bulk "
          f"gathers and {pushes} one-pass pushes")
    check(all(math.isfinite(x) for x in r["losses"]),
          f"{phase} rank {m}: losses {r['losses']}")


def _cell_summary(r: dict) -> dict:
    return {k: r[k] for k in (
        "losses", "step_ms", "median_step_ms", "setup_s",
        "init_max_memory_allocated", "max_memory_allocated", "param_bytes",
        "moment_bytes", "plan_moment_bytes", "zero_stage", "fused_apply",
        "strategy", "batch_axes", "method")}


def phase_mesh_card_zero() -> dict:
    """mesh_card (j): ZeRO-1. phi3-medium-14b at its published width with
    2 of its 40 layers (``profile_step.MESH_CELLS``) on (2, 1), two gloo
    ranks on the card, the config's dtypes, 2 steps at zero_stage 1, then
    from the same init and batches at zero_stage 0 (the fused apply): the
    losses bit for bit equal (deterministic algorithms; every operation of
    the sharded update is elementwise), each rank's dense moments half of
    each leaf and the table's whole, its moment bytes the plan's
    optimizer term; each stage's per-rank peaks and step ms (gloo staged
    through the host: not exchange times)."""
    cell = MESH_CELLS["mesh_card_zero"]
    ranks = spawn(_mesh_cell_rank, math.prod(cell.mesh), "gloo", "cuda",
                  args=("mesh_card_zero", (1, 0)), timeout=900)
    want = ranks[0][1]["losses"]
    for m, r in enumerate(ranks):
        for z in (1, 0):
            check(r[z]["zero_stage"] == z and r[z]["strategy"] == "tp",
                  f"mesh_card (j) rank {m}: zero {r[z]['zero_stage']}, "
                  f"{r[z]['strategy']}")
            _check_cell_rank("mesh_card (j)", m, r[z], cell.mesh[0])
            check(r[z]["losses"] == want,
                  f"mesh_card (j) rank {m} zero {z}: losses "
                  f"{r[z]['losses']} vs zero 1 on rank 0 {want}")
        check(r[1]["moment_bytes"] < r[0]["moment_bytes"],
              f"mesh_card (j) rank {m}: moments {r[1]['moment_bytes']} vs "
              f"{r[0]['moment_bytes']}")
    res = {"phase": "mesh_card_zero", "backend": "gloo",
           "world": len(ranks), "mesh": list(cell.mesh),
           "arch": cell.arch, "cut": f"n_layers {cell.n_layers} of "
           f"{get_config(cell.arch).n_layers}",
           "shape": [cell.shape.seq_len, cell.shape.global_batch],
           "runs": {f"zero{z}": [_cell_summary(r[z]) for r in ranks]
                    for z in (1, 0)},
           "launches": {k: v + ranks[0][0]["launches"][k]
                        for k, v in ranks[0][1]["launches"].items()},
           "launches_by_rank": [{k: v + r[0]["launches"][k]
                                 for k, v in r[1]["launches"].items()}
                                for r in ranks]}
    emit(res)
    return res


def phase_mesh_card_dp() -> dict:
    """mesh_card (k): the dp dense strategy. hymba-1.5b whole on (2, 2),
    four gloo ranks on the card (``dense_strategy="dp"``: the model axis a
    batch axis, a row a rank; ZeRO-1 over both axes), the config's dtypes,
    seq 512, global batch 4, 2 steps: the ranks agree, every loss within
    rtol 2e-2 of the one-device card run from the same init and batches
    (made before the ranks start), each rank's dense moments a quarter of
    each leaf and the table's whole, its moment bytes the plan's term;
    per-rank peaks and step ms (gloo staged through the host)."""
    name = "mesh_card_dp"
    cell = MESH_CELLS[name]
    cfg, batches = mesh_cell_config(name), _cell_batches(name)
    one = get_runner(cfg, cell.shape, cell.run, device="cuda", seed=0)
    t = [time.perf_counter()]
    single = [float(one.run(b)["loss"]) for b in batches]
    one_s = time.perf_counter() - t[0]
    del one
    gc.collect()
    torch.cuda.empty_cache()
    ranks = spawn(_mesh_cell_rank, math.prod(cell.mesh), "gloo", "cuda",
                  args=(name, (1,)), timeout=900)
    got = ranks[0][1]["losses"]
    for m, rr in enumerate(ranks):
        r = rr[1]
        check(r["strategy"] == "dp" and r["batch_axes"] == ["data", "model"]
              and r["zero_stage"] == 1,
              f"mesh_card (k) rank {m}: {r['strategy']} over "
              f"{r['batch_axes']}, zero {r['zero_stage']}")
        _check_cell_rank("mesh_card (k)", m, r, math.prod(cell.mesh))
        check(r["losses"] == got, f"mesh_card (k) rank {m}: losses "
              f"{r['losses']} vs rank 0 {got}")
    gap = max(abs(a - b) / abs(b) for a, b in zip(got, single))
    check(gap <= DP_RTOL, f"mesh_card (k): losses {got} vs one device "
          f"{single}: rtol {gap}")
    res = {"phase": name, "backend": "gloo", "world": len(ranks),
           "mesh": list(cell.mesh), "arch": cell.arch, "cut": "none",
           "shape": [cell.shape.seq_len, cell.shape.global_batch],
           "one_device": single, "one_device_s": one_s, "rtol_gap": gap,
           "runs": {"zero1": [_cell_summary(r[1]) for r in ranks]},
           "launches": ranks[0][1]["launches"],
           "launches_by_rank": [r[1]["launches"] for r in ranks]}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# the recurrent blocks and the routed experts tensor-parallel over model
# (gloo ranks sharing the card: their times are staged through the host,
# not exchange times)
# ---------------------------------------------------------------------------

LSTM_MESH, LSTM_STEPS = (2, 2), 3
# the LSTM's leaves, by their last name, and the dimension each shards on
# lstm_hidden (the gate leaves' 4H gate-strided, w_proj's H rows)
LSTM_LEAVES = {"w_x": -1, "w_h": -1, "bias": -1, "w_proj": -2}
# mesh_card_lstm's bars against one device at bf16: the losses (a sum's
# order moves them by 1e-5) and the gradients' global norms
LSTM_LOSS_RTOL, LSTM_NORM_RTOL = 1e-4, 1e-2
# the all-reduces (sums) a step of each cell issues by axes, as the
# record of one step counts them: the LSTM's one forward and one backward
# of (B, P) a time step a layer over model, the dense exchange and the
# fused metrics over data (the counts a wrapper of all_reduce read before
# the record existed)
LSTM_ALL_REDUCES = {"parallax-lm": {"model": 44, "data": 6},
                    "parallax-nmt": {"model": 804, "data": 12}}
# the planted fault's cell: nmt's on (4, 1), where the plan buckets the
# dense exchange (the (2, 2) plans exchange tensor by tensor, where overlap
# moves nothing)
PLANTED_MESH = (4, 1)


def _lstm_cells() -> list:
    """mesh_card_lstm's runs: main's full-width parallax-lm (lm1b, 20 x
    128, RunConfig()) and nmt's full-width parallax-nmt (its cell: the
    two-table knobs, AdamW at 1e-4), 3 steps each."""
    lm = CELLS["parallax-lm"]
    return [("parallax-lm", get_config("parallax-lm"), lm.shape, lm.run,
             _main_batches(LSTM_STEPS), CENSUS),
            ("parallax-nmt", *_nmt_setup(), _nmt_batches(LSTM_STEPS),
             NMT_CENSUS)]


def _lstm_leaves(model) -> dict:
    return {n: p for n, p in named_parameters(model).items()
            if n.split(".")[-1] in LSTM_LEAVES}


def _all_reduces(record: dict) -> dict:
    """{axes: count} of the sum all-reduces in a ``by_kind_axes`` record."""
    return {k.split(" over ")[1]: v["count"] for k, v in record.items()
            if k.startswith("all-reduce over ")}


def _bits_sums(runner) -> list:
    """Each parameter's raw bits summed: a cheap witness that a step
    applied nothing (an optimizer update moves every sum)."""
    return [int(_bits(p.detach()).long().sum())
            for p in named_parameters(runner.model).values()]


def _planted_overlap(mesh, dev) -> dict:
    """The gate against a planted fault: nmt's cell on ``PLANTED_MESH``
    (full width, buckets), its plan's overlap flipped after the build, so
    the step keeps issuing each bucket inside the backward while the plan
    says after it. The first step must raise ContractViolation with
    exactly a schedule finding and apply nothing; with the plan put back
    the same step passes the gate, and its record checks clean under
    ``strict_dtype``."""
    cfg, shape, rc = _nmt_setup()
    batches = _nmt_batches(2)
    runner = get_runner(cfg, shape, replace(rc, verify_contract=True),
                        mesh=mesh, seed=0)
    bp = runner.plan.bucket_plan
    before = _bits_sums(runner)
    runner.plan.bucket_plan = replace(bp, overlap=not bp.overlap)
    try:
        runner.run(batches[0])
        flipped = None
    except ContractViolation as e:
        flipped = sorted({f.kind for f in e.findings})
    untouched = _bits_sums(runner) == before and \
        int(runner.live_state.step) == 0
    runner.plan.bucket_plan = bp
    ops.reset_launch_counts()
    with coll.record() as rec:
        loss = float(runner.run(batches[0])["loss"])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    strict = runner.check_contract(batches[1], strict_dtype=True)
    out = {"buckets": len(bp.buckets), "overlap": bp.overlap,
           "flipped_findings": flipped, "untouched": untouched,
           "loss": loss, "record": rec.by_kind_axes(),
           "strict_findings": [str(f) for f in strict],
           "outside": strict.outside, "launches": launches}
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _lstm_card_rank(rank: int, world: int, init: dict) -> dict:
    """One of four ranks on the card over gloo: each of ``_lstm_cells`` on
    (2, 2) from the seed-0 init, 3 steps under the verify gate (the first
    step's record checked against the plan before it applies). Each LSTM
    leaf's held shape and its gate-strided blocks gathered over ``model``
    at step 0 against the one-device leaf (``init``), the losses,
    launches, the record of a fourth step (outside the timed three) by
    kind and axes, a recorded step's
    findings under ``strict_dtype``, the layout and peaks. Then the
    planted fault (``_planted_overlap``) on a (4, 1) mesh of the same
    ranks."""
    from repro_torch.weights import gather_tensor
    dev = torch.device("cuda", 0)
    mesh = make_mesh(LSTM_MESH, ("data", "model"), device=dev)
    out = {}
    for key, cfg, shape, rc, batches, census in _lstm_cells():
        torch.cuda.reset_peak_memory_stats(dev)
        runner = get_runner(cfg, shape, replace(rc, verify_contract=True),
                            mesh=mesh, seed=0)
        torch.cuda.synchronize()
        init_peak = torch.cuda.max_memory_allocated(dev)
        whole = dict(runner.model.param_specs())
        leaves = {}
        for n, p in _lstm_leaves(runner.model).items():
            pp = runner.plan.params[n]
            full = gather_tensor(p.detach(), pp.held, mesh, pp.groups)
            leaves[n] = {"shape": list(p.shape),
                         "whole": list(whole[n].shape),
                         "groups": list(pp.groups),
                         "bitwise": torch.equal(_bits(full.cpu()),
                                                _bits(init[key][n]))}
        r = _timed_steps(runner, batches, dev, census,
                         record_batch=batches[-1])
        strict = runner.check_contract(batches[0], strict_dtype=True)
        r.update(_state_layout(runner), leaves=leaves,
                 init_max_memory_allocated=init_peak,
                 methods=dict(runner.plan.table_methods),
                 bucketed=runner.plan.bucket_plan is not None,
                 all_reduces_per_step=_all_reduces(r["record"]),
                 strict_findings=[str(f) for f in strict],
                 outside=strict.outside)
        out[key] = r
        del runner
        gc.collect()
        torch.cuda.empty_cache()
    out["planted"] = _planted_overlap(
        make_mesh(PLANTED_MESH, ("data", "model"), device=dev), dev)
    return out


def phase_mesh_card_lstm() -> dict:
    """mesh_card (l): the LSTM tensor-parallel over model. Full-width
    parallax-lm (1 layer of 2,048 units, proj 512, vocab 800,000; main's
    shape and RunConfig(), bf16) and full-width parallax-nmt (4 + 4 layers
    of 1,024; nmt's cell) on (2, 2), four gloo ranks on the card, 3 steps
    each, against a one-device card run from the same init and batches
    (made and freed before the ranks start): the ranks agree, the losses
    within rel ``LSTM_LOSS_RTOL`` and the gradients' global norms within
    rel ``LSTM_NORM_RTOL`` of one device; each LSTM leaf holds 1/2 of the
    whole on lstm_hidden (the gate leaves a rank's units of each of the
    four gates) and the blocks of a model pair gathered give the
    one-device leaf bit for bit at step 0; every rank pulls each table on
    the bulk route once a step and pushes one-pass as the plan's method
    predicts; its parameter bytes the plan's term. Every rank runs under
    the verify gate (``RunConfig.verify_contract``: the first step's
    record checked against the plan before it applies) and a recorded
    step checks clean under ``strict_dtype``; the record of a fourth step,
    run after the three timed ones (step 0 of those three carries the
    gate's own record), by kind
    and axes (count, payload and wire bytes, ms: gloo staged through the
    host, not exchange times) gives the all-reduces a step,
    ``LSTM_ALL_REDUCES`` (the LSTM's: one forward and one backward of (B,
    P) a time step a layer, over model). Then the planted fault on (4, 1)
    (``_planted_overlap``): exactly a schedule finding, nothing applied.
    Per rank: peaks, step ms."""
    single, norms, init = {}, {}, {}
    for key, cfg, shape, rc, batches, _ in _lstm_cells():
        one = get_runner(cfg, shape, rc, device="cuda", seed=0)
        init[key] = {n: p.detach().cpu().clone()
                     for n, p in _lstm_leaves(one.model).items()}
        ms = [one.run(b) for b in batches]
        single[key] = [float(m["loss"]) for m in ms]
        norms[key] = [float(m["grad_norm"]) for m in ms]
        del one, ms
        gc.collect()
        torch.cuda.empty_cache()
    ranks = spawn(_lstm_card_rank, math.prod(LSTM_MESH), "gloo", "cuda",
                  args=(init,), timeout=900)
    rows = {}
    for key, cfg, *_ in _lstm_cells():
        rs = [r[key] for r in ranks]
        got = rs[0]["losses"]
        gap = max(abs(a - b) / abs(b) for a, b in zip(got, single[key]))
        norm_gap = max(abs(a - b) / abs(b) for a, b in zip(
            rs[0]["grad_norms"], norms[key]))
        check(all(r["losses"] == got for r in rs)
              and len(rs[0]["grad_norms"]) == len(got)
              and gap <= LSTM_LOSS_RTOL and norm_gap <= LSTM_NORM_RTOL,
              f"mesh_card (l) {key}: the ranks' losses "
              f"{[r['losses'] for r in rs]} vs one device {single[key]}: "
              f"rel {gap} (bar {LSTM_LOSS_RTOL}); gradient norms "
              f"{rs[0]['grad_norms']} vs {norms[key]}: rel {norm_gap} (bar "
              f"{LSTM_NORM_RTOL})")
        tables = rs[0]["methods"]
        pushes = sum(_one_pass_pushes(m, len(got)) for m in tables.values())
        for m, r in enumerate(rs):
            for n, x in r["leaves"].items():
                d = LSTM_LEAVES[n.split(".")[-1]]
                want = list(x["whole"])
                want[d] //= LSTM_MESH[1]
                check(x["shape"] == want and x["bitwise"],
                      f"mesh_card (l) {key} rank {m}: {n} holds "
                      f"{x['shape']} of {x['whole']} (groups "
                      f"{x['groups']}), gathered bit for bit: "
                      f"{x['bitwise']}")
            c = r["launches"]
            check(c["embed_gather"] == c["embed_gather_bulk"]
                  == len(tables) * len(got)
                  and c["embed_scatter_add"] == c["embed_scatter_add_fused"]
                  == pushes,
                  f"mesh_card (l) {key} rank {m}: launches {c}, want "
                  f"{len(tables)} bulk gathers a step and {pushes} one-pass "
                  f"pushes on {tables}")
            check(r["param_bytes"] == r["plan_param_bytes"],
                  f"mesh_card (l) {key} rank {m}: {r['param_bytes']} "
                  f"parameter bytes, the plan's {r['plan_param_bytes']}")
            want = LSTM_ALL_REDUCES[key]
            got_ar = r["all_reduces_per_step"]
            check(r["strict_findings"] == []
                  and {a: got_ar.get(a, 0) for a in want} == want,
                  f"mesh_card (l) {key} rank {m}: the contract under "
                  f"strict_dtype {r['strict_findings']}; all-reduces a "
                  f"step {got_ar}, want {want}")
        rows[key] = {
            "one_device": single[key], "losses": got, "rel_gap": gap,
            "one_device_grad_norms": norms[key],
            "grad_norms": rs[0]["grad_norms"], "grad_norm_rel_gap": norm_gap,
            "methods": tables, "bucketed": rs[0]["bucketed"],
            "all_reduces_per_step": rs[0]["all_reduces_per_step"],
            "contract_findings": rs[0]["strict_findings"],
            "outside_contract": rs[0]["outside"],
            "leaves": {n: x["shape"] for n, x in rs[0]["leaves"].items()},
            "by_rank": [{k: r[k] for k in (
                "median_step_ms", "step_ms", "param_bytes",
                "plan_param_bytes", "moment_bytes",
                "init_max_memory_allocated", "max_memory_allocated",
                "record")}
                for r in rs]}
        emit({"phase": "mesh_card_lstm", "arch": key, **rows[key]})
    planted = [r["planted"] for r in ranks]
    for m, p in enumerate(planted):
        check(p["buckets"] >= 2 and p["flipped_findings"] == ["schedule"]
              and p["untouched"] and p["strict_findings"] == []
              and p["launches"]["embed_gather"] > 0
              and p["launches"]["embed_scatter_add"] > 0,
              f"mesh_card (l) planted fault rank {m}: {p['buckets']} "
              f"buckets, overlap {p['overlap']} flipped in the plan gave "
              f"{p['flipped_findings']} (want ['schedule']), nothing "
              f"applied: {p['untouched']}; restored: "
              f"{p['strict_findings']}, launches {p['launches']}")
    emit({"phase": "mesh_card_lstm", "planted": {
        "cell": "parallax-nmt", "mesh": list(PLANTED_MESH),
        "buckets": planted[0]["buckets"],
        "overlap_in_plan_flipped_to": not planted[0]["overlap"],
        "findings": planted[0]["flipped_findings"],
        "nothing_applied": [p["untouched"] for p in planted],
        "restored_findings": planted[0]["strict_findings"],
        "loss": planted[0]["loss"],
        "records_by_rank": [p["record"] for p in planted]}})
    # a rank's launches: the sum of its two runs'
    by_rank = [{k: sum(rank[key]["launches"][k] for key in rows)
                for k in rank[key]["launches"]} for rank in ranks]
    res = {"phase": "mesh_card_lstm", "backend": "gloo",
           "world": len(ranks), "mesh": list(LSTM_MESH), "runs": rows,
           "launches": by_rank[0], "launches_by_rank": by_rank}
    emit({k: v for k, v in res.items() if k != "runs"})
    return res


def phase_table3() -> dict:
    """Paper Table 3 on the card (``repro_torch.benchmarks.
    table3_transfer``): the embedding-only step of each method (ps,
    ps_gather and mpi_gatherv with local aggregation, ps without) at the
    paper's sizes (V 65,536, E 512, bf16, 256 x 256 uniform ids) on (2, 2)
    over 4 gloo ranks, each under a record: the wire bytes a replica
    against the cost model's formula plus its named terms (within 1 %,
    the benchmark raises otherwise), the (16, 16) formula beside, and each
    collective's ms. The ranks share the card over gloo, which stages the
    gathers through the host: those are not exchange times."""
    from repro_torch.benchmarks import table3_transfer
    res = table3_transfer.run(device="cuda")
    rows = {}
    for case, r in res["cases"].items():
        rows[case] = {
            "recorded_MB": r["recorded_bytes"] / 1e6,
            "analytic_MB": r["analytic_bytes"] / 1e6,
            "terms_MB": {k: v / 1e6 for k, v in r["terms"].items()},
            "rel_to_analytic_plus_terms": r["rel_to_analytic_plus_terms"],
            "analytic_16x16_MB": r["analytic_bytes_16x16"] / 1e6,
            "collectives_ms": [
                {"kind": c["kind"], "axes": c["axes"], "dtype": c["dtype"],
                 "MB": c["bytes"] / 1e6, "ms": c["ms"]}
                for c in r["collectives"]]}
    out = {"phase": "table3", "mesh": res["mesh"], "sizes": res["sizes"],
           "alpha": res["workload"]["alpha"],
           "alpha_16x16": res["workload_16x16"]["alpha"],
           "capacity": res["workload"]["capacity"],
           "note": "ms: gloo collectives staged through the host on one "
                   "card, not exchange times", "cases": rows}
    emit(out)
    return out


HYMBA = "hymba-1.5b"
# mesh_card_toy's cells (``profile_step.MESH_CELLS``): rwkv6 whole on
# (1, 2), hymba at 8 of 32 layers on (2, 2)
TOY_CELLS = {RWKV: "mesh_card_toy", HYMBA: "mesh_card_toy_hymba"}
# The bar of an f32 mesh against one device's f32 run (mesh_card_toy's
# logits and mesh_card_moe_tp's prefill): each row's largest |difference|
# over its largest |logit|. The two differ only in the order of their
# sums; a block missing from a rank's sum moves whole units of the scale.
MESH_F32_RTOL = 1e-3
# mesh_card_toy's f32 comparison: the first 2 of rwkv_serve's 8 prompts,
# 8 new tokens each, served one after the other, every device step's
# logits recorded
TOY_CHECK_REQUESTS, TOY_CHECK_NEW = 2, 8
# mesh_card_toy's bf16 timing run: the first 2 of rwkv_serve's 8 requests
# (8 cost 73 s and 50 s a rank over gloo's host staging)
TOY_TIMED_REQUESTS = 2
# the prefill positions whose logits mesh_card_toy compares for rwkv6
TOY_TAIL = 16
F32_RUN = dict(param_dtype="float32", compute_dtype="float32")


def _record_logits(sv) -> list:
    """Wrap a ToyServer's decode step to keep, for every device step, its
    whole logits (slots x vocab, f32 numpy; on a mesh gathered over the
    vocab shards and the data ranks, so every rank runs the same gathers)
    and which slots hold a request then."""
    from repro_torch.core import collectives as coll
    rec, step, rt = [], sv.decode_step, sv.rt

    def recorded(cache, toks, cache_len):
        logits, cache = step(cache, toks, cache_len)
        live = np.array([r is not None for r in sv.slot_req])
        x = logits[:, 0].float()
        if rt.mesh is not None:
            if rt.vocab_shards > 1:
                x = coll.all_gather(x, "model", rt.mesh, dim=-1)
            if rt.replicas > 1:
                x = coll.all_gather(x, tuple(rt.batch_axes), rt.mesh)
        # numpy: a rank's result travels through a queue, where a tensor
        # would be shared by a file descriptor its exiting process closes
        rec.append((x[:, :rt.model_cfg.vocab_size].cpu().numpy(), live))
        return logits, cache

    sv.decode_step = recorded
    return rec


def _row_rel(x, y) -> float:
    """The largest |x - y| over the largest |y| of any row (numpy in; 0
    for no rows)."""
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    return float(((x - y).abs().max(dim=-1).values
                  / y.abs().max(dim=-1).values).max()) if len(y) else 0.0


def _steps_rel(mine: list, want: list) -> dict:
    """Two ``_record_logits`` records of one schedule: the largest
    ``_row_rel`` over the rows of slots that hold a request (the logits
    the server serves from) and over the idle slots' rows, which step
    with token 0 and serve nothing."""
    live = idle = 0.0
    for (x, _), (y, m) in zip(mine, want):
        live = max(live, _row_rel(x[m], y[m]))
        idle = max(idle, _row_rel(x[~m], y[~m]))
    return {"live": live, "idle": idle}


def _toy_check(sv) -> list:
    """mesh_card_toy's f32 schedule: the first ``TOY_CHECK_REQUESTS`` of
    rwkv_serve's prompts, each submitted when the one before has drained,
    so each is served in slot 0 from the carry its predecessor left. (A
    request admitted beside another starts in a slot whose carry the
    idle steps with token 0 have drifted: rwkv6's logits there lie as far
    apart between one device's WKV kernel and its plain version as
    between any two runs.) -> each request's tokens."""
    rng = np.random.default_rng(0)
    prompts = _prompts(rng, rng.integers(16, 65, size=8),
                       sv.rt.model_cfg.vocab_size)
    out = []
    for i, p in enumerate(prompts[:TOY_CHECK_REQUESTS]):
        req = Request(i, p, max_new_tokens=TOY_CHECK_NEW)
        sv.submit(req)
        sv.run_until_drained()
        out.append(list(req.out_tokens))
    return out


def _toy_run(sv, dev, new: int) -> dict:
    """The first ``TOY_TIMED_REQUESTS`` of ``rwkv_serve``'s requests
    through a ToyServer: the same seeds and prompts, after the same short
    warm-up request: the run's launches (set to 0 just before it), TTFT,
    peak."""
    cfg = sv.rt.model_cfg
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 65, size=8)
    prompts = _prompts(rng, lens, cfg.vocab_size)[:TOY_TIMED_REQUESTS]
    _drain(sv, _prompts(rng, (4,), cfg.vocab_size), 2)
    before = sv.stats["decode_steps"]
    sv.completed.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t = time.perf_counter()
    done = _drain(sv, prompts, new)
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    steps = sv.stats["decode_steps"] - before
    ttft = sorted(r.ttft for r in done.values())
    return {"tokens": {u: list(r.out_tokens) for u, r in done.items()},
            "launches": counts, "decode_steps": steps,
            "device_steps": steps + sum(len(p) - 1 for p in prompts),
            "run_s": wall,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "ttft_ms_p50": ttft[len(ttft) // 2] * 1e3,
            "ttft_ms_max": ttft[-1] * 1e3}


def _toy_server(arch: str, mesh=None, params=None, f32: bool = False):
    """ToyServer of ``arch``'s mesh_card_toy cell (one device when
    ``mesh`` is None; f32 weights and compute under ``f32``)."""
    cell = MESH_CELLS[TOY_CELLS[arch]]
    rc = replace(cell.run, **F32_RUN) if f32 else cell.run
    kw = {"mesh": mesh} if mesh is not None else {}
    return ToyServer(mesh_cell_config(TOY_CELLS[arch]), rc,
                     ServerConfig(max_batch=cell.shape.global_batch,
                                  max_seq=cell.shape.seq_len),
                     params=params, seed=0, **kw)


def _rwkv_tail(sv) -> np.ndarray:
    """The last ``TOY_TAIL`` positions' whole logits of rwkv_serve's
    2,048-token prefill (f32 numpy)."""
    from repro_torch.core import collectives as coll
    cfg = sv.rt.model_cfg
    ptoks = torch.from_numpy(_rwkv_prompt(cfg.vocab_size)).to(sv.rt.device)
    logits, _ = make_prefill_step(sv.model, sv.rt, sv.plan)(
        {"tokens": ptoks})
    tail = logits[0, -TOY_TAIL:].float()
    if sv.rt.vocab_shards > 1:
        tail = coll.all_gather(tail, "model", sv.rt.mesh, dim=-1)
    return tail[:, :cfg.vocab_size].cpu().numpy()


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _vary_constant_leaves(sv) -> None:
    """Add seeded N(0, 0.1) noise to every leaf the init makes constant
    (zeros or ones: rwkv6's token-shift mixes, decay, LoRA B, bonus and
    group-norm weights, the norms), the same whole values on one device
    and on every rank (each adds its block). A fresh init holds them
    uniform over the channels, so no check of a served model could see a
    rank read another rank's channels of them."""
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for n, spec in sv.model.param_specs():
            if spec.init not in ("zeros", "ones"):
                continue
            noise = torch.randn(spec.shape, generator=gen).mul_(0.1)
            p = sv.params[n]
            if tuple(p.shape) != tuple(spec.shape):
                pp = sv.plan.params[n]
                noise = shard_tensor(noise, pp.held, sv.rt.mesh, pp.groups)
            p.add_(noise.to(p.device, p.dtype))


def _toy_card_rank(rank: int, world: int, arch: str, new: int,
                   params_path) -> dict:
    """One gloo rank on the card: ``arch``'s mesh_card_toy cell served by
    ToyServer twice. At f32, one device's weights (its seeded draw, or
    ``params_path``'s padded copy): the check's requests with every
    device step's logits recorded (rank 0 returns them), and for rwkv6
    the last positions of rwkv_serve's 2,048-token prefill. At bf16, the
    seeded draw: rwkv_serve's warm-up and its first 2 requests, the
    launches, TTFT and peaks, a decode step's time, the carry's and leaves' shapes;
    for rwkv6 the prefill's launches."""
    dev = torch.device("cuda", 0)
    mesh = make_mesh(MESH_CELLS[TOY_CELLS[arch]].mesh, ("data", "model"),
                     device=dev)
    params = None
    if params_path is not None:
        params = torch.load(params_path, map_location="cpu", mmap=True)
    sv = _toy_server(arch, mesh, params, f32=True)
    if params is None:          # a loaded copy holds one device's noise
        _vary_constant_leaves(sv)
    del params
    rec = _record_logits(sv)
    out = {"rank": rank, "f32_tokens": _toy_check(sv),
           "f32_steps": rec if rank == 0 else len(rec)}
    if arch == RWKV:
        out["f32_tail"] = _rwkv_tail(sv)
    del sv, rec
    _free()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sv = _toy_server(arch, mesh)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    out["init_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out.update(_toy_run(sv, dev, new))
    timer = Timer(dev)
    step_toks = torch.zeros((sv._local, 1), dtype=torch.int32, device=dev)
    out["decode_step_ms"] = timer.ms(
        lambda: sv.decode_step(sv.cache, step_toks, 64), 10)
    del timer
    out["cache"] = [list(c.shape) for c in sv.cache]
    out["shapes"] = {n: list(sv.params[n].shape) for n in (
        "layers.tm.w_r", "layers.cm.w_in", "layers.ssm.w_in",
        "layers.attn.wq") if n in sv.params}
    out["param_bytes"], out["plan_param_bytes"] = _param_bytes(sv)
    if arch == RWKV:
        ops.reset_launch_counts()
        _rwkv_tail(sv)
        out["prefill_launches"] = ops.launch_counts()
    return out


def _mesh_padded(sv, name: str) -> dict:
    """One device's weights (host copies) zero-padded at the end of each
    dimension the cell's mesh pads (the q heads to the model axis: ``wq``
    columns, ``wo`` rows; the vocab rows of the table and head), the
    whole shapes of a model planned on that mesh."""
    cell = MESH_CELLS[name]
    rt = Runtime(sv.rt.model_cfg, sv.rt.run_cfg, sv.rt.shape_cfg,
                 mesh=MeshShape(cell.mesh, ("data", "model")),
                 device="meta")
    out = {}
    for n, spec in build_model(rt.model_cfg, rt).param_specs():
        t = sv.params[n].detach().cpu()
        pad = [(0, w - h) for h, w in zip(t.shape, spec.shape)]
        out[n] = torch.nn.functional.pad(
            t, [x for p in reversed(pad) for x in p]) if any(
                b for _, b in pad) else t
    return out


def _plain_wkv_steps(arch: str) -> list:
    """One device's f32 run of the check's requests with every WKV on its
    plain version in place of the kernels (``_record_logits``'s record):
    how far two numerics alone put each row."""
    real = ops.wkv
    ops.wkv = lambda *args, chunk=32: ref.wkv_chunked_ref(*args,
                                                          chunk=chunk)
    try:
        sv = _toy_server(arch, f32=True)
        _vary_constant_leaves(sv)
        rec = _record_logits(sv)
        _toy_check(sv)
    finally:
        ops.wkv = real
    del sv
    _free()
    return rec


def _toy_reference(arch: str) -> dict:
    """One device's f32 run of ``arch``'s cell: the check's requests
    with every device step's logits recorded; rwkv6 also its prefill's
    last positions and the same run on the plain WKV. hymba's weights
    padded to the mesh's q heads, for the ranks, in a file under build/
    (a seeded draw at 26 q heads is another model than one at 25)."""
    sv = _toy_server(arch, f32=True)
    _vary_constant_leaves(sv)
    rec = _record_logits(sv)
    ref = {"tokens": _toy_check(sv), "steps": rec, "params_path": None}
    if arch == RWKV:
        ref["tail"] = _rwkv_tail(sv)
    else:
        ref["params_path"] = ROOT / "build" / "mesh_card_toy_hymba.pt"
        ref["params_path"].parent.mkdir(exist_ok=True)
        torch.save(_mesh_padded(sv, TOY_CELLS[arch]), ref["params_path"])
    del sv
    _free()
    if arch == RWKV:
        ref["plain_wkv_steps"] = _plain_wkv_steps(arch)
    return ref


def phase_mesh_card_toy(rwkv: dict = None, new: int = 16) -> dict:
    """mesh_card (m): ToyServer on process meshes (``profile_step.
    MESH_CELLS``): rwkv6-7b whole on (1, 2) (32 of 64 heads and 7,168 of
    d_ff 14,336 a rank) and hymba-1.5b at 8 of 32 layers on (2, 2) (800
    SSM channels and 13 padded q heads a rank). Each at f32 against one
    device's f32 run, made and freed before the ranks start (hymba's
    ranks load its weights padded; the constant leaves varied): the
    first 2 of rwkv_serve's prompts, 8 tokens each, one after the other
    (``_toy_check``); the same tokens on every rank, and every device
    step's logits of the slot that holds the request (rwkv6's 2,048-token
    prefill's last positions too) within ``MESH_F32_RTOL`` of each row's
    scale; the idle slots' rows printed beside one device's run on the
    plain WKV. Then at bf16, rwkv_serve's warm-up, its first 2 requests
    (``TOY_TIMED_REQUESTS``: the decode-step ms and TTFT cover these 2),
    seeds and ServerConfig: every rank launches wkv at its 32 heads, the
    step route once a layer a device step and the tc route once a layer
    in the prefill, and one gather a device step; the tokens that differ from
    rwkv_serve's are counted. Per rank: init peak, decode-step ms and
    TTFT (gloo staged through the host); the phase's seconds by arch."""
    rows, launches, by_rank = {}, None, []
    for arch, name in TOY_CELLS.items():
        t0 = time.perf_counter()
        cell = MESH_CELLS[name]
        cfg, mesh = mesh_cell_config(name), cell.mesh
        want = _toy_reference(arch)
        ranks = spawn(_toy_card_rank, math.prod(mesh), "gloo", "cuda",
                      args=(arch, new, want["params_path"]), timeout=900)
        if want["params_path"] is not None:
            want["params_path"].unlink()
        r0 = ranks[0]
        mine = r0.pop("f32_steps")
        gaps = _steps_rel(mine, want["steps"])
        # the idle slots' rows are printed, not held: stepped with token 0
        # from the start, rwkv6's drift apart between any two numerics
        # (one device on the plain WKV against its kernels about as far)
        idle = {"mesh": gaps["idle"]}
        if "plain_wkv_steps" in want:
            plain = _steps_rel(want["plain_wkv_steps"], want["steps"])
            idle.update(one_device_plain_wkv=plain["idle"],
                        one_device_plain_wkv_live=plain["live"])
        err = {"steps": [len(mine), len(want["steps"])],
               "decode": gaps["live"]}
        if arch == RWKV:
            err["prefill"] = _row_rel(r0.pop("f32_tail"), want["tail"])
        row = {"cell": name, "mesh": list(mesh),
               "cut": f"n_layers {cfg.n_layers} of "
                      f"{get_config(arch).n_layers}",
               "rtol": MESH_F32_RTOL, "f32_vs_one_device": err,
               "f32_idle_rows": idle,
               "by_rank": [{k: r[k] for k in (
                   "setup_s", "init_peak_bytes", "max_memory_allocated",
                   "decode_step_ms", "ttft_ms_p50", "ttft_ms_max", "run_s",
                   "param_bytes", "cache", "shapes")} for r in ranks]}
        if arch == RWKV and rwkv is not None:
            pairs = [(a, b) for u, toks in r0["tokens"].items()
                     for a, b in zip(toks, rwkv["tokens"][u])]
            row["bf16_tokens_differ"] = [sum(a != b for a, b in pairs),
                                         len(pairs)]
            row["one_device"] = {k: rwkv[k] for k in ("ttft_ms_p50",
                                                      "ttft_ms_max")}
        emit({"phase": "mesh_card_toy", "arch": arch, **row})
        check(len(mine) == len(want["steps"])
              and all((a == b).all() for (_, a), (_, b)
                      in zip(mine, want["steps"]))
              and all(r["f32_tokens"] == want["tokens"] for r in ranks)
              and all(v <= MESH_F32_RTOL for k, v in err.items()
                      if k != "steps"),
              f"mesh_card (m) {arch}: f32 on the mesh against one device: "
              f"{err} of the scale (bar {MESH_F32_RTOL}), tokens "
              f"{[r['f32_tokens'] for r in ranks]} vs {want['tokens']}")
        m = mesh[1]
        b = SERVE_BATCH // mesh[0]
        for r in ranks:
            rk, c = r["rank"], r["launches"]
            check(r["param_bytes"] == r["plan_param_bytes"],
                  f"mesh_card (m) {arch} rank {rk}: parameter bytes "
                  f"{r['param_bytes']}, the plan's {r['plan_param_bytes']}")
            check(c["embed_gather"] == r["device_steps"],
                  f"mesh_card (m) {arch} rank {rk}: {c['embed_gather']} "
                  f"gathers in {r['device_steps']} device steps")
            if arch == RWKV:
                h, e = cfg.n_heads // m, cfg.head_dim
                fc = r["prefill_launches"]
                check(r["shapes"]["layers.tm.w_r"][-1] == h * e
                      and r["shapes"]["layers.cm.w_in"][-1] == cfg.d_ff // m
                      and r["cache"][1] == [cfg.n_layers, b, h, e, e],
                      f"mesh_card (m) rwkv rank {rk}: {r['shapes']}, "
                      f"carry {r['cache']}")
                check(c["wkv"] == c["wkv_step"]
                      == cfg.n_layers * r["device_steps"]
                      and fc["wkv"] == fc["wkv_tc"] == cfg.n_layers,
                      f"mesh_card (m) rwkv rank {rk}: wkv {c} in "
                      f"{r['device_steps']} device steps, {fc} in the "
                      "prefill")
            else:
                check(r["shapes"]["layers.ssm.w_in"][-1] == cfg.d_model // m
                      and r["shapes"]["layers.attn.wq"][-1]
                      == -(-cfg.n_heads // m) * cfg.head_dim
                      and r["cache"][2] == [cfg.n_layers, b,
                                            cfg.d_model // m,
                                            cfg.ssm_state],
                      f"mesh_card (m) hymba rank {rk}: {r['shapes']}, "
                      f"carry {r['cache']}")
            check(max(r["init_peak_bytes"], r["max_memory_allocated"])
                  < PEAK_LIMIT, f"mesh_card (m) {arch} rank {rk}: peaks "
                  f"{r['init_peak_bytes']}, {r['max_memory_allocated']}")
        total = [dict(r["launches"]) for r in ranks]
        if arch == RWKV:
            total = [{k: v + r["prefill_launches"][k] for k, v in t.items()}
                     for t, r in zip(total, ranks)]
        by_rank += total
        launches = total[0] if launches is None else {
            k: launches[k] + v for k, v in total[0].items()}
        row["seconds"] = time.perf_counter() - t0
        emit({"phase": "mesh_card_toy", "arch": arch,
              "seconds": row["seconds"]})
        rows[arch] = row
    res = {"phase": "mesh_card_toy", "backend": "gloo",
           "launches": launches, "launches_by_rank": by_rank}
    emit(res)
    return {**res, "runs": rows}


MOE_TP_SEQ, MOE_TP_DECODE = 2048, 8


def _moe_tp_prefill(sv, toks) -> tuple:
    """(the prefill's whole logits (S, vocab), f32 numpy on the host,
    moe_dropped, moe_aux) of one cache-less prefill."""
    from repro_torch.core import collectives as coll
    logits, _, met = sv.model.prefill_fn({"tokens": toks})
    logits = logits[0]
    if sv.rt.vocab_shards > 1:
        logits = coll.all_gather(logits, "model", sv.rt.mesh, dim=-1)
    logits = logits[:, :sv.rt.model_cfg.vocab_size].float()
    return (logits.cpu().numpy(), int(met["moe_dropped"]),
            float(met["moe_aux"]))


def _moe_tp_server(mesh=None, f32: bool = False):
    cell = MESH_CELLS["mesh_card_moe_tp"]
    kw = {"mesh": mesh} if mesh is not None else {"device": "cuda"}
    rc = replace(cell.run, **F32_RUN) if f32 else cell.run
    return Server(mesh_cell_config("mesh_card_moe_tp"), rc,
                  ServerConfig(max_batch=SERVE_BATCH,
                               max_seq=cell.shape.seq_len), seed=0, **kw)


def _moe_tp_tokens(vocab: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, vocab, (1, MOE_TP_SEQ))
                            .astype(np.int32)).to(dev)


def _moe_tp_rank(rank: int, world: int) -> dict:
    """One gloo rank on the card: grok-1 at its published width, 2 of 64
    layers, moe_exec "tp", served by the paged engine on (1, 2). At bf16:
    the expert blocks, one 2,048-token prefill's routing metrics, then
    the engine's prefill of the same tokens into slot 0 and 8 decode
    steps, timed; launches, peaks. Then at f32 (the same seeded draw,
    its constant leaves varied as one device's; the ranks build in
    turn): the prefill's whole logits (rank 0 returns them) and routing
    metrics."""
    from repro_torch.core import collectives as coll
    dev = torch.device("cuda", 0)
    cell = MESH_CELLS["mesh_card_moe_tp"]
    mesh = make_mesh(cell.mesh, ("data", "model"), device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sv = _moe_tp_server(mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    toks = _moe_tp_tokens(sv.rt.model_cfg.vocab_size, dev)
    ops.reset_launch_counts()
    _, dropped, aux = _moe_tp_prefill(sv, toks)
    t = time.perf_counter()
    sv._prefill(sv.cache, sv.lens, sv.tok, toks, MOE_TP_SEQ, 0, sv._gen)
    active = torch.zeros(sv._local, dtype=torch.bool, device=dev)
    active[0] = True
    outs = []
    for _ in range(MOE_TP_DECODE):
        *_, out = sv._decode(sv.cache, sv.lens, sv.tok, active, sv._gen)
        outs.append(int(out[0]))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    counts = ops.launch_counts()
    flash_tc = ops.flash_attention.launches_tc
    length = int(sv.lens[0])
    timer = Timer(dev)
    decode_ms = timer.ms(lambda: sv._decode(sv.cache, sv.lens, sv.tok,
                                             active, sv._gen), 5)
    got, want = _param_bytes(sv)
    res = {"rank": rank, "moe_dropped": dropped, "moe_aux": aux,
           "decoded": outs, "launches": counts,
           "flash_attention_launches_tc": flash_tc, "lens": length,
           "experts": {n: list(sv.params[n].shape) for n in (
               "layers.moe.w_gate", "layers.moe.w_up", "layers.moe.w_down")},
           "param_bytes": got, "plan_param_bytes": want,
           "setup_s": setup_s, "init_peak_bytes": init_peak,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "run_s": run_s, "decode_step_ms": decode_ms}
    del sv, timer
    _free()
    torch.cuda.reset_peak_memory_stats(dev)
    # one rank's f32 init after the other's: each holds 23 GB of shards
    # and, while it draws, the stacked w_gate's 12.9 GB of f32 scratch;
    # two draws at once leave the card too little beside each other
    for turn in range(world):
        if turn == rank:
            sv = _moe_tp_server(mesh, f32=True)
            _vary_constant_leaves(sv)
            torch.cuda.empty_cache()
        coll.barrier(mesh)
    logits, res["f32_moe_dropped"], res["f32_moe_aux"] = _moe_tp_prefill(
        sv, toks)
    res["f32_logits"] = logits if rank == 0 else None
    res["f32_max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return res


def phase_mesh_card_moe_tp() -> dict:
    """mesh_card (n): the routed experts' d_ff tensor-parallel over model.
    grok-1 at its published width with 2 of its 64 layers
    (``profile_step.MESH_CELLS``), ``moe_exec="tp"``, served by the paged
    engine on (1, 2), two gloo ranks on the card: each rank holds
    (8, 6,144, 16,384) and (8, 16,384, 6,144) expert blocks. At f32, one
    2,048-token prefill's logits within ``MESH_F32_RTOL`` of each row's
    scale of a one-device f32 run of the same 2 layers (made and freed
    first, as a one-device bf16 one; moe_dropped of each is printed).
    At bf16, the engine's prefill of the same tokens and 8 decode steps:
    flash on the tc route at the rank's 24 q heads, one bulk gather a
    prefill and a decode step; parameter bytes the plan's term; per-rank
    peaks."""
    torch.cuda.reset_peak_memory_stats()
    ref = {}
    for key in ("bf16", "f32"):
        sv = _moe_tp_server(f32=key == "f32")
        if key == "f32":
            _vary_constant_leaves(sv)
        cfg = sv.rt.model_cfg
        ref[key] = _moe_tp_prefill(
            sv, _moe_tp_tokens(cfg.vocab_size, sv.rt.device))
        sv.close()              # its threads hold the engine
        del sv
        _free()
        if key == "bf16":
            torch.cuda.synchronize()
            one_peak = torch.cuda.max_memory_allocated()
    cell = MESH_CELLS["mesh_card_moe_tp"]
    ranks = spawn(_moe_tp_rank, math.prod(cell.mesh), "gloo", "cuda",
                  timeout=900)
    got, want = ranks[0].pop("f32_logits"), ref["f32"][0]
    err = {"row_rel": _row_rel(got, want),
           "frobenius": float(np.linalg.norm(got - want)
                              / np.linalg.norm(want)),
           "logit_scale": float(np.abs(want).max())}
    res = {"phase": "mesh_card_moe_tp", "backend": "gloo",
           "world": len(ranks), "mesh": list(cell.mesh), "arch": cfg.name,
           "cut": f"n_layers {cfg.n_layers} of {get_config(GROK).n_layers}",
           "prefill_tokens": MOE_TP_SEQ, "rtol": MESH_F32_RTOL,
           "f32_vs_one_device": err,
           "moe_dropped": {"one_device_bf16": ref["bf16"][1],
                           "one_device_f32": ref["f32"][1],
                           "mesh_bf16": [r["moe_dropped"] for r in ranks],
                           "mesh_f32": [r["f32_moe_dropped"] for r in ranks]},
           "moe_aux": {"one_device_bf16": ref["bf16"][2],
                       "one_device_f32": ref["f32"][2],
                       "mesh_bf16": [r["moe_aux"] for r in ranks],
                       "mesh_f32": [r["f32_moe_aux"] for r in ranks]},
           "one_device_peak_bytes": one_peak,
           "by_rank": [{k: r[k] for k in (
               "experts", "param_bytes", "setup_s", "init_peak_bytes",
               "max_memory_allocated", "f32_max_memory_allocated", "run_s",
               "decode_step_ms", "decoded")} for r in ranks],
           "launches": ranks[0]["launches"],
           "launches_by_rank": [r["launches"] for r in ranks]}
    emit(res)
    check(bool(np.isfinite(got).all())
          and err["row_rel"] <= MESH_F32_RTOL,
          f"mesh_card (n): f32 prefill logits {err} off one device's f32 "
          f"run (bar {MESH_F32_RTOL} of each row's scale)")
    m, f, d, e = cell.mesh[1], cfg.d_ff, cfg.d_model, cfg.n_experts
    for r in ranks:
        rk, c = r["rank"], r["launches"]
        check(r["experts"] == {
            "layers.moe.w_gate": [cfg.n_layers, e, d, f // m],
            "layers.moe.w_up": [cfg.n_layers, e, d, f // m],
            "layers.moe.w_down": [cfg.n_layers, e, f // m, d]},
            f"mesh_card (n) rank {rk}: experts {r['experts']}")
        check(r["param_bytes"] == r["plan_param_bytes"],
              f"mesh_card (n) rank {rk}: {r['param_bytes']} parameter "
              f"bytes, the plan's {r['plan_param_bytes']}")
        check(c["flash_attention"] == 2 * cfg.n_layers
              == r["flash_attention_launches_tc"],
              f"mesh_card (n) rank {rk}: flash {c['flash_attention']} "
              f"({r['flash_attention_launches_tc']} tc) in 2 prefills")
        check(c["embed_gather"] == c["embed_gather_bulk"]
              == 2 + MOE_TP_DECODE,
              f"mesh_card (n) rank {rk}: gathers {c}")
        check(r["decoded"] == ranks[0]["decoded"]
              and all(0 <= t < cfg.vocab_size for t in r["decoded"])
              and r["lens"] == MOE_TP_SEQ + MOE_TP_DECODE,
              f"mesh_card (n) rank {rk}: decoded {r['decoded']}, "
              f"length {r['lens']}")
        check(max(r["init_peak_bytes"], r["max_memory_allocated"],
                  r["f32_max_memory_allocated"]) < PEAK_LIMIT,
              f"mesh_card (n) rank {rk}: peaks {r['init_peak_bytes']}, "
              f"{r['max_memory_allocated']}, "
              f"{r['f32_max_memory_allocated']}")
    return res


def _check_nmt_card(ranks: list, nmt_losses: list, steps: int) -> dict:
    """mesh_card (c)'s checks, over every rank's record."""
    f0, p0 = ranks[0]["fused"], ranks[0]["per_param"]
    for m, r in enumerate(ranks):
        f, p = r["fused"], r["per_param"]
        methods = {t: f["plan"][t]["method"] for t in ("embed", "enc_embed")}
        check(methods == {"embed": "mpi_gatherv", "enc_embed": "allreduce"},
              f"mesh_card nmt rank {m}: plan {f['plan']}")
        check(f["fused_apply"] and f["live_fused"] and f["buckets"] > 0
              and not p["fused_apply"] and not p["live_fused"],
              f"mesh_card nmt rank {m}: fused_apply {f['fused_apply']} / "
              f"{p['fused_apply']}, buckets {f['buckets']}")
        check(f["losses"] == p["losses"] == f0["losses"],
              f"mesh_card nmt rank {m}: fused {f['losses']} vs per-param "
              f"{p['losses']} vs rank 0 {f0['losses']}")
        c = r["launches"]
        check(c["embed_gather"] == c["embed_gather_bulk"] == 4 * steps
              and c["embed_scatter_add"] == c["embed_scatter_add_fused"]
              == 2 * steps,
              f"mesh_card nmt rank {m}: launches {c}, want 2 bulk gathers "
              "and the enc_embed one-pass push a step")
    check(p0["params_equal_fused"],
          "mesh_card nmt: rank 0's parameters after 3 fused steps differ "
          "from the per-param run's")
    for a, b in zip(f0["losses"], nmt_losses):
        check(math.isfinite(a) and abs(a - b) <= 1e-2 * abs(b),
              f"mesh_card nmt: losses {f0['losses']} vs nmt "
              f"{nmt_losses[:steps]}")
    return {"mesh": [4, 1], "nmt_losses": nmt_losses[:steps],
            "losses": f0["losses"], "plan": f0["plan"],
            "buckets": f0["buckets"],
            "bucket_wire_bytes": f0["bucket_wire_bytes"],
            "fused_apply": f0["fused_apply"],
            "params_equal_fused": p0["params_equal_fused"],
            "apply_ms": {"fused": f0["apply_ms"],
                         "per_param": p0["apply_ms"]},
            "ranks": [{run: {k: r[run][k] for k in (
                "step_ms", "median_step_ms", "max_memory_allocated",
                "census")} for run in ("fused", "per_param")}
                for r in ranks],
            "launches": ranks[0]["launches"],
            "launches_by_rank": [r["launches"] for r in ranks]}


def main() -> None:
    t0 = time.perf_counter()
    seconds = {}

    def run(name: str, fn, *args):
        """One phase, its wall seconds recorded; the card's cache freed
        after it."""
        t = time.perf_counter()
        res = fn(*args)
        seconds[name] = time.perf_counter() - t
        torch.cuda.empty_cache()
        return res

    info = phase_banner()
    dev = torch.device("cuda", 0)
    run("build", phase_build)
    kern = run("kernels", phase_kernels, dev)
    run("parity", phase_parity)
    run("serve_parity", phase_serve_parity)
    run("rwkv_parity", phase_rwkv_parity)
    run("rwkv_recurrence", phase_rwkv_recurrence, dev)
    dense_parity = run("dense_parity", phase_dense_parity)
    main_res = run("main", phase_main, dev)
    paths = {"main": main_res["launches"],
             "dense_parity": dense_parity["launches"]}
    paths["main_no_la"] = run("main_no_la", phase_main_no_la,
                              dev)["launches"]
    nmt = run("nmt", phase_nmt, dev)
    paths["nmt"] = nmt["launches"]
    paths["train"] = run("train", phase_train, dev,
                         main_res["median_step_ms"])["launches"]
    paths["train_growth"] = run("train_growth", phase_train_growth,
                                dev)["launches"]
    paths["train_resume"] = run("train_resume", phase_train_resume,
                                dev)["launches"]
    dense = run("dense_train", phase_dense_train, dev)
    paths["dense_train"] = dense["launches"]
    paths["mesh_one_rank"] = run("mesh_one_rank", phase_mesh_one_rank,
                                 main_res["losses"])["launches"]
    card = run("mesh_card", phase_mesh_card, main_res["losses"],
               nmt["losses"])
    paths["mesh_card"] = card["launches"]
    paths["mesh_card_nmt"] = card["nmt"]["launches"]
    paths["mesh_launcher"] = card["launcher"]["launches"]
    paths["mesh_card_dense"] = run("mesh_card_dense",
                                   phase_mesh_card_dense)["launches"]
    paths["replan_replay"] = run("replan_replay",
                                 phase_replan_replay)["launches"]
    serve = run("serve", phase_serve, dev)
    paths["serve"] = serve["launches"]
    rwkv_serve = run("rwkv_serve", phase_rwkv_serve, dev)
    paths["rwkv_serve"] = rwkv_serve["launches"]
    paths["stablelm_parity"] = run("stablelm_parity",
                                   phase_stablelm_parity)["launches"]
    stablelm = run("stablelm_serve", phase_serve, dev, 8, 16, STABLELM,
                   "stablelm_serve")
    paths["stablelm_serve"] = stablelm["launches"]
    paths["families_parity"] = run("families_parity",
                                   phase_families_parity)["launches"]
    for phase, arch in FAMILY_TRAIN.items():
        paths[phase] = run(phase, phase_dense_train, dev, arch, phase,
                           FAMILY_STEPS)["launches"]
    paths["mesh_card_encdec"] = run("mesh_card_encdec",
                                    phase_mesh_card_encdec)["launches"]
    paths["moe_parity"] = run("moe_parity", phase_moe_parity)["launches"]
    moe_serve = {}
    for arch, phase in ((GROK, "grok_serve"), (LLAMA4, "llama4_serve")):
        moe_serve[phase] = run(phase, phase_serve, dev, 8, 16, arch, phase)
        paths[phase] = moe_serve[phase]["launches"]
    paths["mesh_card_moe"] = run("mesh_card_moe",
                                 phase_mesh_card_moe)["launches"]
    mesh_serve = run("mesh_card_serve", phase_mesh_card_serve, serve)
    mesh_tp = run("mesh_card_tp", phase_mesh_card_tp)
    paths["mesh_card_serve"] = mesh_serve["launches"]
    paths["mesh_card_tp"] = mesh_tp["launches"]
    mesh_zero = run("mesh_card_zero", phase_mesh_card_zero)
    mesh_dp = run("mesh_card_dp", phase_mesh_card_dp)
    paths["mesh_card_zero"] = mesh_zero["launches"]
    paths["mesh_card_dp"] = mesh_dp["launches"]
    mesh_lstm = run("mesh_card_lstm", phase_mesh_card_lstm)
    run("table3", phase_table3)
    mesh_toy = run("mesh_card_toy", phase_mesh_card_toy, rwkv_serve)
    mesh_moe_tp = run("mesh_card_moe_tp", phase_mesh_card_moe_tp)
    paths["mesh_card_lstm"] = mesh_lstm["launches"]
    paths["mesh_card_toy"] = mesh_toy["launches"]
    paths["mesh_card_moe_tp"] = mesh_moe_tp["launches"]
    for path, names in PATH_KERNELS.items():
        for name in names:
            check(paths[path][name] > 0, f"{name} not launched on {path}")
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "phase_seconds": seconds})
    print(info["nvidia_smi"], flush=True)
    rows = []
    for name, meta in KERNELS.items():
        k = kern[name]
        if name == "wkv":           # the scalar route: no path takes it
            by_path = {p: c["wkv"] - c["wkv_tc"] - c["wkv_step"]
                       for p, c in paths.items()}
        else:
            by_path = {p: c[name] for p, c in paths.items()
                       if name in PATH_KERNELS[p]}
        rows.append({"name": name, **meta,
                     "launches": sum(by_path.values()),
                     "launches_by_path": by_path,
                     "max_abs_err": kern["max_abs_err"][name],
                     "ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
                     "bound_ms": k["bound_ms"],
                     "bound_by": k.get("bound_by", "bytes"),
                     "library_ms": k["library_ms"],
                     "timed_at": k["shape"]})
        if name == "embed_gather":
            rows[-1]["launches_bulk"] = {
                p: c["embed_gather_bulk"] for p, c in paths.items()
                if name in PATH_KERNELS[p]}
            rows[-1].update({key: k[key] for key in ("element_ms",
                                                     "floor_ms")})
            rows[-1]["serve_shapes"] = kern["embed_gather_serve"]
            rows[-1]["rwkv_shapes"] = kern["embed_gather_rwkv"]
        if name in ("embed_gather", "embed_scatter_add"):
            rows[-1]["dense_train_shape"] = kern["dense_train_shape"][name]
        if name == "embed_scatter_add":
            rows[-1]["launches_fused"] = {
                p: c["embed_scatter_add_fused"] for p, c in paths.items()
                if name in PATH_KERNELS[p]}
            rows[-1].update({key: k[key] for key in (
                "dump_row_ms", "dump_row_kernel_ms", "fill_ms",
                "all_owned_ms", "none_owned_ms", "floor_ms")})
        if name in ("wkv", "wkv_tc", "wkv_step"):
            rows[-1].update({key: k[key] for key in (
                "host_ms_per_call", "scalar_kernel_ms", "ops_bound_ms",
                "bytes_bound_ms") if key in k})
        if name in ("wkv_tc", "wkv_step"):
            # a rank's 32 heads on mesh_card_toy's (1, 2) mesh: the time
            # at that shape and every rank's launches there
            rows[-1]["mesh_h32"] = {
                **{key: kern[f"{name}_mesh_h32"][key] for key in (
                    "shape", "kernel_ms", "plain_ms", "bound_ms",
                    "bound_by")},
                "launches_by_rank": [c[name] for c in
                                     mesh_toy["launches_by_rank"]]}
        if name == "flash_attention":
            rows[-1]["launches_tc"] = serve["flash_attention_launches_tc"]
            rows[-1]["by_len"] = {
                n: {key: r[key] for key in ("kernel_ms", "library_ms",
                                            "bound_ms", "tflops",
                                            "share_of_bound")}
                for n, r in k["by_len"].items()}
            rows[-1]["f32_ms"] = k["f32_ms"]
            rows[-1]["host_ms_per_call"] = k["host_ms_per_call"]
            # stablelm-12b's 160-wide heads: the tc route's time at its
            # prefill beside SDPA and the bound, and the D 160 launches
            rows[-1]["d160"] = {
                **{key: k["d160"][key] for key in (
                    "shape", "route", "kernel_ms", "plain_ms", "library_ms",
                    "f32_ms", "bound_ms", "bound_by", "tflops",
                    "share_of_bound")},
                "by_len": {n: {key: r[key] for key in (
                    "kernel_ms", "library_ms", "bound_ms", "tflops",
                    "share_of_bound")}
                    for n, r in k["d160"]["by_len"].items()},
                "launches": {p: paths[p]["flash_attention"] for p in (
                    "stablelm_serve", "stablelm_parity")},
                "launches_tc": stablelm["flash_attention_launches_tc"]}
            # the moe family's serve paths (D 128 bf16: the tc route)
            rows[-1]["moe_launches_tc"] = {
                p: r["flash_attention_launches_tc"]
                for p, r in moe_serve.items()}
    for row in rows:
        if row["name"] in ("embed_gather", "embed_scatter_add",
                           "flash_attention"):
            # the tensor-parallel, ZeRO-1 and dp paths' launches on
            # every rank
            row["mesh_launches_by_rank"] = {
                p: [c[row["name"]] for c in res["launches_by_rank"]]
                for p, res in (("mesh_card_serve", mesh_serve),
                               ("mesh_card_tp", mesh_tp),
                               ("mesh_card_zero", mesh_zero),
                               ("mesh_card_dp", mesh_dp),
                               ("mesh_card_lstm", mesh_lstm),
                               ("mesh_card_toy", mesh_toy),
                               ("mesh_card_moe_tp", mesh_moe_tp))}
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
