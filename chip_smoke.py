#!/usr/bin/env python3
"""Drives the PyTorch port (tuun_tpu_torch) on one CUDA card, end to end.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  0. device: the card's name and power limit; no CUDA -> exit 1.
  1. build: compile the hand-written kernels with nvcc, one process per
     source, all at once: the scans (csrc/scan.cu), the exact
     precisions' recurrence and df prefix sum (csrc/exact.cu) and the
     interval gates (csrc/lanes.cu).
  2. kernels: each kernel against its plain PyTorch version on the card,
     with timings; noise_torch against the numpy oracle's noise; sin at
     every NCO grid angle on the card against the CPU.
     The prefix sum and max from 128 up to 2^26 lanes, the affine scan
     (y and hist out) at J = 1..8 and up to 2^20 + 5 lanes within
     affine_tol(J) of its float64 plain version, a float16 control
     failing each bound, each also: on
     misaligned inputs (x[1:]; a[1:], ff[1:], live[1:]); exactly one CUDA
     kernel per call, no memset (torch.profiler, in a child process:
     `--profile launches`; a child whose profiler saw fewer kernels than
     the wrappers launched is run again, up to three children, while
     more device work than one kernel a call fails at once); the same
     bits on every
     call (the sum up to 2^26 lanes, the affine scan at 65536 and 2^20 + 5
     lanes); captured CUDA graphs on one stream, one per op (per J of the
     affine scan) at each of two lengths, each replayed three times in
     turns over new data; back-to-back calls on a second stream
     interleaved with the first (the affine scan's at the lengths where
     its geometry changes and at 2^20 + 5, AFFINE_STREAM_SIZES).  At the
     main path's shapes each is timed three ways: events around
     back-to-back calls (cuda_ms, which reads
     the slower of host and device), device time alone (replays of a
     captured graph) and host time per call.  The voices x lanes forms
     at PREFIX_ROWS / AFFINE_ROWS: against their plain versions, each row
     bit for bit against a single call, one kernel per call, the same
     bits on repeat, a captured graph replayed, timed the same three
     ways beside B single calls.  The deep affine scan (fast mode's
     feedback at 8 < J <= 16) at J = 9, 12, 16 from 1000 to 2^20 + 5
     lanes and on misaligned inputs, against its float64 plain version
     within DEEP_AFFINE_TOL with a float16 control that must fail each
     bound, the same bits on 50 calls, one call the bits of the same lanes
     in calls of whole tiles chained by hist (a tracker's window against
     its blocks), graphs at two lengths replayed in turns, J = 17 refused,
     and its rows form at DEEP_ROWS as the other rows forms are held; one
     kernel a call.  sin's sign at all 2^24 NCO
     grid angles must equal the phase's top bit on the card (the analytic
     Reset tiers rest on it).
 2b. lanes: the interval gates (csrc/lanes.cu via engine/lane_ops.py,
     the engine's `_gate` and `_mask` on the card) through vmap's batching
     rule, bit for bit the plain four-op chain (two broadcast compares,
     `&`, `where`) at LANE_SHAPES, (256, 2^20) to one voice and a width
     that is no multiple of 4: every operand form against every other
     (a tensor of rows, a shared lane vector, one value a row, a shared
     0-dim tensor, an immediate), each end batched or shared, edge
     intervals (empty, s < 0, e > n, s > e, e = n), operands with the
     voice axis second, misaligned or expanded, the mask form, one voice
     unbatched; one kernel a call and no other device work
     (torch.profiler, in process: this phase runs before any other
     session of the process), the launches counted; a gate and a mask
     captured in a CUDA graph replayed three times over new inputs, the
     capture recording their launches and no scan call; a float64
     operand refused; device times at (256, 2^20) in turns against the
     chain (kernel, chain, chain, kernel) beside the bytes bound (the
     output and, for each lane, the operand it selects where that is a
     tensor; the mask 1 B a lane); then each benchmark cell
     (portbench/harness.py, 1 s, traced) with the gates' launches in its
     slice, which must show them engaged.  Phase 3's main path must
     launch both.
  3. main path: the batch CLI (python -m tuun_tpu_torch, which streams at
     sync_interval=16: the fused step and 16-block lookahead windows as
     CUDA graph replays) renders W1-W3, W5 (bench.py's marks_4_40), W6
     (poly_16) and W2g (a reset no analytic tier takes) at 48 kHz in
     65536-sample blocks (W1 also with the default --precompute true, as
     W1p).  The valid samples the engine itself reported, as the tracker
     resolved them on every path (Voice.produced), and the WAV's length,
     must equal the native oracle's length; the first 2 s must match the
     port's numpy oracle (a copy of tuun_tpu's, held equal to it by
     tests/test_torch_frontend.py) within the fast-mode tolerances stated
     below.  Each workload logs how its blocks were served (per voice,
     fused, a window opened or served) and the captures and replays.  W5
     and W6 must compile to a timeline (W6 with its 16 tones in one
     stacked chord) and give the same bits on both renders: they capture
     inline (fuse_blocking), so both renders take the same paths.  Every
     kernel must have launched in this phase (a graph replay counts the
     launches its capture recorded): its counts are the `launches` of the
     kernels line.
  4. cross-device: W1's first 2 s rendered on the CPU (plain scans, CPU
     sin) against the card's render.
  5. engine: filter_4_3 (W4) through CompiledVoice.render_block in 8
     blocks of 2^20 lanes, the first block checked against the native
     oracle; its launches are reported on a line of their own.
  6. profiles: for W1 and W2 with the analytic Reset tiers and with them
     forced off, and for W3, W5, W6 and W2g, one engine render of the
     piece's first 16 blocks (CompiledVoice, 65536-lane blocks, warm; W1
     has 8), all in one child process and its first torch.profiler
     session (`--profile W1,W1:generic,...`), each in a range of its
     own: device events per block and the device's idle share.
  7. reloc_fast: W1, W2, W5 and W6 rendered warm through CompiledVoice in
     65536-lane blocks with EngineConfig(reloc_fast=True) and with the
     default, in turns (default, fast, fast, default).
  8. voice groups: G1, bench.py's polyphony lane (256 FM voices through
     CompiledVoice.batched_render_fn at 2^17 lanes, block 0 against the
     256 voices rendered one by one, then timed), and G2, polyphonic
     tracker sessions (Tracker.play / render_block at 48 kHz, 1024- and
     65536-sample blocks, three instruments whose notes join and retire)
     against the sum of every voice's own render, with every group render
     launching each scan's voices x lanes form as often as one voice
     launches its single form.  Their launches are the counts of the
     voices x lanes forms.  The live-block session is then timed in
     turns against the per-voice loop that groups replace (groups, loop;
     the loop's mix held to the same bound).  These run with the fused
     step off (the per-call path).  Then the streaming path:
     G2 at the live block with the fused step on, at sync_interval 1 and
     4 (windows of 4 blocks, prefetch on), each mix held to the same
     bound (its FM term scaled to the window's length), every block's
     path and the capture, replay, window and prefetch counters logged;
     G3, a stable set of G2's instruments held 5 s, in turns (the per-call
     path, fused, sync_interval=4, per-call), where the fused step and
     windows must engage (a fused block one dispatch, a served block none);
     and a capture check against the eager path (a replay while another
     tracker captures, a same-key set swapped in, a window interrupted by a
     play).  The pools of each tracker's live graphs are logged as it
     closes (CLI runs, G2 and G3 sessions), and the allocator's after the
     CLI runs and after G2 and G3.  Then profiles of G1, one G1 voice
     alone and the first third of G2's live-block session in one child's
     profiler session (`--profile G1,G1one,G2`), and phase 2's one-launch
     calls counted under an in-process profiler session (logged, not
     held: the child of phase 2 holds them).
  9. live edits (session): the port's TuunSession, Player.stop and web
     server at the server's defaults (44.1 kHz, 1024-sample blocks, fast,
     unpaced), on the card at sync_interval 1 and 32.  S1: the slider
     demos' vibrato, filter and gain programs and a 20-note score (a
     timeline), each ~10 s with a slider move every 8 blocks (the score:
     one, late, which replays it through state_at), then Player.stop:
     `$330 * gain` equals its piecewise-linear gain times sin(2 pi 330 t)
     (phase 3's FM bound), each ramp block monotone, the 50 ms stop ramp
     then exact zeros, every voice retired within 2 sync_interval blocks
     of the ramp's end (the reference's lazy rule).  S2: keys
     instruments: pm_piano_keys (an 8-note chord, staggered note-offs, a
     second chord), G2's FM voice and its W2g-like voice as keys (4 notes
     each, alone then grouped), with inline captures: one dispatch a block
     again 3 blocks after every burst of commands, the fused step served.
     At sync_interval 32 (windows interrupted by every command) each mix
     equals sync_interval 1's within phase 8's interrupt bound; at
     sync_interval 1 the card equals the port's own CPU run of the same
     scripts within phase 4's envelope (S1's programs cut to their first
     96 blocks on the CPU).  S3: the web server on
     127.0.0.1:0 through http.client: an install streamed to its end bit
     for bit a direct session's, a slider move's monotone ramp, keys
     note_on/note_off, stop ending a live stream, an unknown id's 404.
     Logged: per session x realtime, p50/p99 block ms, blocks by path,
     captures; per modify p50/p99 ms and its op_log phases; state_at's
     replay; each kernel's launches in the phase (the kernels line's
     `session_launches`; every scan kernel must launch); and, not held, the
     filter program with wide moves (Q 2 at 100 Hz) against a float64
     scan.

 10. the live-coding REPL (repl), at its defaults (44.1 kHz, 1024-sample
     blocks, fast, tempo 90) on the card.  R1: examples/song.tuun (a copy)
     through Repl.dispatch: plays A1-A4 (A1 at the next measure), A2's
     cutoff moved within 630 Hz-5 kHz, A5's piano chord and note-offs, a
     W2g-like keys program added in a new slot in edit mode and an FM keys
     program over A4 through `edit` (each alone, then a chord), `key`
     chords in edit mode, midi gestures through the simulated Launchkey,
     undo/redo, a render to a WAV, view, stop, save, status (~20 s of
     audio, offline at sync_interval 1): every mix finite numpy, sound
     while programs play, exact zeros after the stop ramp, the WAV the
     rendered mix, no error in the log; the first R1_CPU_LINES commands on
     the port's CPU within phase 4's envelope.  R2 (a child: `--live`):
     the Repl, the background prewarm and `audio start FIFO` with a
     reader, ~15 s of plays, slider moves every 0.5 s and a keys chord
     through pump.call, `audio stop`: no pump error, no command timed out,
     the bytes read equal blocks_out x 1024 x 4, finite sound, every
     COMMON_EXPRS structure warmed with no failure; logged: underruns and
     worst lateness at RING_BLOCKS, blocks against the wall clock, p50/p99
     tracker_load and dispatch ms, the prewarm's seconds, the first play's
     time to sound, stall notes, captures.  R3: `python -m tuun_tpu_torch
     --ui true song.tuun` in a child, stdin `play A2`, `render 1 OUT.wav`,
     `quit`: exit 0 and 43 x 1024 finite samples.  Each kernel's launches
     in R1 and R2 are the kernels line's `repl_launches`; every scan
     kernel must launch.
 11. the exact precisions (exact), on the card at full shapes; every
     failure fails the run (no budget stop, no caught exception).  First
     the two kernels of csrc/exact.cu against their plain versions: the
     linear recurrence (K1, exact mode's IIR) in f32 and f64 at J = 1, 2,
     3, 8, 9, 12, 16 (the chain form), 17, 32, 64 (the wide form), 96,
     128, 257, 4096 (the streamed form), bit for bit the plain version
     (past J = 96 its numpy twin, recurrence_np) at 1000 and 4101 lanes
     (aligned and on a[1:], ff[1:], live[1:]) and at 2^17 + 5 lanes for J =
     2, and at 2^17 + 5 lanes for every J (16389 at J = 4096) each lane the
     step from its own history (which makes it the plain version's bits by
     induction), the same bits on a repeat; at REC_PATTERN_JS on
     REC_PATTERNS' dead lanes (all live, all dead, one dead lane at each
     place of a 32-lane group, dead runs across stage ends, the mixed
     default) at REC_PATTERN_N lanes, aligned and on [1:] views, bit for
     bit the plain version and the one-step check, and the patterns as the
     rows of one rows call; its rows form row for row a single call; the df
     prefix sum (K2, exact_df's phase) at 2^10 to 2^20 lanes within 2^-40
     of sum |x| of the float64 cumsum (as its plain doubling scan is), 10^3
     below the f32 cumsum's drift, the same bits on 20 repeats and as the
     numpy model of its grouping (df_model), its rows
     form row for row a single call, two rows calls at once on two
     streams whose grids fit the card one at a time but not together, in
     a child process that must answer within DF_STREAMS_TIMEOUT (every
     call the bits of the same call alone); both captured in CUDA graphs
     replayed in turns; each timed at 2^17 lanes, 1024 lanes and (8, 1024) (events,
     device, host, the plain version, and for K2 torch.cumsum in float64).
     Then the path, whose launches, and only those, make each kernel's
     `exact_launches`: the fuzz gate (bench.py's fuzz_tpu lane on the port:
     seeds 5000-5015 at depth 4/5, 4 const-jitter variants, n = 256, sr =
     4, blocks (256, 97, 64); fast with the statistical gates, exact_df and
     exact at atol 2e-4 / rtol 1e-3; all 64 cases with no failure), the
     shape gate (nco, fm, filter and reset at 2^17 lanes and 44.1 kHz,
     offline and in 1024-lane blocks, in exact_df and exact, within
     SHAPE_TOL), the long render (LONGSONG_EXPR, 64 s at 44.1 kHz in
     2^17-lane blocks, exact_df, against the native oracle within
     LONGRENDER_TOL), G2's live-block session cut to its first third
     (EXACT_SESSION) in exact_df with the fused step at sync_interval 1 and
     4 (the mix against its voices' own renders, phase 8's bound), and W2
     and W3 through the CLI in exact_df and exact against the oracle over 2
     s.  Every kernel on this path must launch: all but the float64
     recurrence (the reference's IIR is float32 in both exact precisions,
     so no engine path runs it), the fast mode's voices x lanes forms of
     the prefix sum and affine scan (fast groups only: phase 8) and the
     deep affine scan (fast filters deeper than 8 coefficients: phase 12).

 12. the tools and fast-mode filters deeper than the affine scan
     (tools), on the card at full size; every failure fails the run.
     Deep filters: the ramp of tests/test_torch_stream.py's _deep through
     J = 9, 12 and 16 feedback coefficients (past the affine scan's
     MAX_J = 8: fast mode runs the deep affine scan) and 17, 96 and 128
     (past its MAX_DEEP_J = 16: the linear recurrence's wide and streamed
     forms), 2^17 samples at 48 kHz in
     65536- and 1024-lane blocks, each within DEEP_TOL of scale of the
     native oracle, reaching its kernel and not the other, the time a
     block logged; four J = 12 voices in one group through the fast
     Tracker at 1024-sample blocks, the fused step at sync_interval 4
     (captured inline, replayed), the mix against the voices' own renders
     within phase 8's bound, the group on the deep scan's rows form.
     The corpus:
     tools/web_checker over web/index.html and docs/*.md rendering every
     example (22050 samples at 44.1 kHz, bench.py's corpus lane) against
     the native oracle on the card: none fails, at least 6 pass, the same
     labels as on the CPU; with --reference DIR, also every example of
     the reference system's docs/ and web/ pages in the checkout at DIR
     (none by default).  tools/profile in this process at its defaults
     on harmonica(1.0, 440), W3's FM voice and W2g: its lines parse, and
     its census names each expression's scans.  tools/scope on a clipping
     lpf: a PNG that decodes, its clip count the render's.  tools/spectra:
     the flute and ukulele of tests/test_instruments.py at 44.1 kHz fast
     on their f0 and envelope targets and within the fast-mode envelope
     of their CPU exact renders.  The path's launches, and only those,
     are each kernel's `tools_launches`; every kernel of TOOLS_KERNELS
     must launch.  Then (not counted) the recurrence at J = 12 on 2^17 +
     5 lanes, each lane the plain version's step, and the single-voice
     times of the deep affine scan at J = 9, 12, 16 (2^17, 65536 and 1024
     lanes)
     beside the recurrence at the same J and the affine scan at J = 8,
     at 2^17 lanes.

 13. the mesh paths (mesh): tuun_tpu_torch.parallel and Tracker(mesh=)
     on meshes whose positions are all cuda:0 (and, with more than one
     card visible, a mesh across the cards); every failure fails the run.
     M1: G1's 256 voices through render_voices_meshed on a (4, 1) mesh
     (the stateful path) and a (2, 2) mesh (the lane-sharded path: G1 is
     relocatable), 10 blocks of 2^17 lanes, each mix against the meshless
     group's within phase 8's G1 bound; then a block's time on each mesh
     beside the meshless batched_render_fn's, in turns.  M3: G2's first
     third at 1024-sample blocks, its FM notes amp-marked, on a meshed
     Tracker (default_mesh(4)) and a meshless one, fuse off, levels on, at
     sync_interval 1 and 4, one FM note halved by a modify at block 12:
     the same length and modified voice, the mix within two summation
     orders of each block's voices (their peaks from the levels) plus
     G2's FM tolerance, at sync_interval 1 the levels within that
     tolerance, every rows kernel launched on the mesh; and an exact_df
     group of 8 FM voices on a (4, 1) mesh against its meshless group.
     M2: graft_entry.dryrun_multichip(8) on the card (tuun_tpu's three
     checks: the meshed mix against a one-position mesh, lane sharding on
     the (4, 2) mesh, the live meshed tracker with a timeline score, a
     modify and levels against the meshless one).  The meshed renders'
     launches, and only those, are each kernel's `mesh_launches`; the
     three rows kernels must launch.

The second-last line is the JSON list of kernels; the last line is
{"ok": true, "device": {...}}.  `--phase kernels` stops after phase 2;
`--phase stream` runs only phase 8's capture check, G3 and G2's
streaming sessions; `--phase session` only phase 9; `--phase repl` only
phase 10; `--phase exact` only phase 11 (after phase 2's one-kernel-a-
call check in a child); `--phase tools` only phase 12; `--phase mesh`
only phase 13; `--phase deep` only phase 2's deep affine scan checks and
phase 12's deep times; `--phase lanes` only phase 2b.

`--phase times [--tree DIR]` runs only the scans at the shapes whose time
is split (the prefix sum and max at SPLIT_SIZES and at the live block's
1024 lanes, the affine scan at AFFINE_SPLIT and its rows form at
AFFINE_ROWS_SPLIT, the deep affine scan at DEEP_SPLIT where the tree has
one, the linear recurrence at REC_TIMES on all-live and phase 11's mixed
lanes, the df prefix sum at DF_TIMES): each held to its bound (a tree
whose affine scan returns the J planes of h to those; the recurrence to
the one-step check), kernels per call (torch.profiler) and the three
times of phase 2, one JSON line a shape, the affine scan's beside the
bound of y out (4J + 9 bytes a lane), the recurrence's beside its chain
model, the prefix scans at the live block beside torch.cumsum and
torch.cummax.
With --tree, the kernels are those of the checkout at DIR (its
tuun_tpu_torch package, imported first), so that two
commits are compared with one set of inputs and clocks, each in its own
process and in turns (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SR = 48000
BUFFER = 65536
# The main path's block is the CLI buffer: every kernel time in the JSON
# line is taken at this length (J = 2 for the affine scan: lpf).
MAIN_N = BUFFER

W1_EXPR = "harmonica(10.0, 440)"
# bench.py:87-96's score workloads, as its expressions build them.
MARKS_4_40 = "<[" + ", ".join(
    ["0 | fin(time - 0.5) | seq(time - 0.5)"] * 160) + "]>"
POLY_16 = "{[" + ", ".join(f"$({600 + 60 * i}) + $({1200 + 35 * i})"
                           for i in range(16)) + "]} | fin(time - 80)"
# Workloads of phase 3: (name, expression, --precompute, kernels it must
# reach).  The 60-80 s pieces run with --precompute false: with the
# default true, the precompute pass bakes a finite piece to at most 10 s
# (the reference's cap), so they would be cut and rendered only by the
# bake.  W1 is 10 s long and runs both ways; with the default (W1p) the
# engine renders it in the bake and the tracker plays the baked samples.
# Every Reset of W1 and W2 takes an analytic tier, so they reach no
# running max; W2g's outer reset(triangle(...)) is one that every tier
# rejects, which keeps the prefix max on the path.  W5's silent segments
# are one step sum (the prefix sum); W6's chord reaches no scan.
WORKLOADS = [
    ("W1", W1_EXPR, "false", ("affine_scan_f32",)),
    ("W1p", W1_EXPR, None, ("affine_scan_f32",)),
    ("W2", "sawtooth(110) | lpf(0.7, 2000) | fin(time - 60)", "false",
     ("affine_scan_f32",)),
    ("W3", "sine(2*pi*(220 + 30*$(5)), 0) * 0.5 | fin(time - 60)", "false",
     ("prefix_sum_f32",)),
    ("W5", MARKS_4_40, "false", ("prefix_sum_f32",)),
    ("W6", POLY_16, "false", ()),
    ("W2g", "reset(triangle(110), time * -110) * 2 | lpf(0.7, 2000) "
     "| fin(time - 60)", "false", ("affine_scan_f32", "prefix_max_f32")),
]
# Rendered twice in phase 3, these must give the same bits both times.
REPEATABLE = ("W5", "W6")
PREFIX_SECONDS = 2.0

# Affine-scan error bound per feedback depth J, as a fraction of the
# output's scale max(1, max|y|), f32 kernel against the f64 recurrence
# (y and hist; or, for a checkout whose affine scan returns the J planes
# of h, as --phase times --tree may time, those planes).
# Each is about 10x the largest error the first (three-launch) kernel
# showed over N = 65536, 2^20 and 2^20+5 on an H100 (700 W): J=1 6.4e-8,
# J=2 7.9e-7, J=3 2.0e-4, J=4 1.1e-4, J=8 1.9e-5 (J=3 is held at 5x).  The
# single-pass kernel that replaced it errs as much: 6.9e-8, 7.2e-7, 2.1e-4
# (on a[1:]), 1.1e-4 and 1.8e-5 in one run.  Composing companion maps
# amplifies rounding by the maps' transient growth, large for
# filter_4_3's near-repeated pole pair (|p| = 0.896, 0.896, 0.801), hence
# the spread.  The float16 control errs 1e-3 (J=1) to 0.25 (J=3) of scale.
AFFINE_TOL = {1: 1e-6, 2: 1e-5, 3: 1e-3, 4: 1e-3, 8: 2e-4}


def affine_tol(J: int) -> float:
    """AFFINE_TOL's bound at depth J: its own, or at J = 5-7 that of the
    nearest deeper J it holds (J = 8's)."""
    return AFFINE_TOL[min(k for k in AFFINE_TOL if k >= J)]

# Prefix-scan lengths of phase 2: up to 2^26 lanes, where the look-back
# runs over many waves of blocks (16,384 tiles of 4096 lanes on 132 SMs).
PREFIX_SIZES = (128, MAIN_N, 1 << 20, 3 * (1 << 20) + 37, 1 << 26)
# Lengths whose time is also split into device time and host time.
SPLIT_SIZES = (MAIN_N, 1 << 20)
# Affine-scan depths and lengths of phase 2 (2^20: filter_4_3's blocks;
# + 5: a ragged last tile), and the (J, N) whose time is split: the CLI's
# block at J = 1, 2, 3, 8, filter_4_3's 2^20, and J = 5-8 at 2^17 (beside
# the deep form's J = 9-16 there).
AFFINE_JS = (1, 2, 3, 4, 5, 6, 7, 8)
AFFINE_SIZES = (MAIN_N, 1 << 20, (1 << 20) + 5)
AFFINE_SPLIT = ((2, MAIN_N), (1, MAIN_N), (3, MAIN_N), (8, MAIN_N),
                (2, 1 << 20), (3, 1 << 20), (5, 1 << 17), (6, 1 << 17),
                (7, 1 << 17), (8, 1 << 17))
# The rows form's (B, N, J) whose time is split: the live block's groups
# (8 lpf voices; a J = 3 section over 64) and 32 voices at the CLI's block.
AFFINE_ROWS_SPLIT = ((8, 1024, 2), (64, 1024, 3), (32, MAIN_N, 2))
# Lengths where the affine scan's geometry changes (one tile, 1024 lanes;
# the look-back's fan, past 65536): its second-stream check runs at each,
# and at 2^20 + 5 (two levels of look-back records, a ragged tile).
AFFINE_CROSSOVERS = (1025, MAIN_N + 1)
AFFINE_STREAM_SIZES = AFFINE_CROSSOVERS + ((1 << 20) + 5,)
GRAPH_CALLS = 50
# H100 SXM memory rate (NVIDIA data sheet): each kernel's bound is the
# bytes it must move over it (8 a lane for the prefix scans, 4J + 9 for
# the affine scan: a, ff and live read once, y written once).
HBM_BYTES_PER_S = 3.35e12

REPLACES = {
    "prefix_sum_f32": "tuun_tpu/engine/pallas_ops.py:149",
    "prefix_max_f32": "tuun_tpu/engine/pallas_ops.py:156",
    "affine_scan_f32": "tuun_tpu/engine/pallas_ops.py:301",
    # The voices x lanes forms: the same Pallas kernels under the group's
    # jax.vmap (tuun_tpu/tracker.py:409-410), which adds a grid axis.
    "prefix_sum_rows_f32": "tuun_tpu/engine/pallas_ops.py:149",
    "prefix_max_rows_f32": "tuun_tpu/engine/pallas_ops.py:156",
    "affine_scan_rows_f32": "tuun_tpu/engine/pallas_ops.py:301",
}
# The voices x lanes forms of phase 2, as (B voices, N lanes[, J]): the
# live block at bench.py's 256 voices, a 32-voice group at the offline
# block, bench.py's polyphony lane (256 voices at 2^17); for the affine
# scan lpf (J = 2) at the offline block for 32 voices and for a group of
# 4, the live block's lpf for a group of 8 (G2's harmonica and W2g groups
# of 2-6 voices: one tile a row, no look-back), and a J = 3 section on the
# live block.  The first of each is the kernels line's shape.
PREFIX_ROWS = ((32, MAIN_N), (256, 1024), (256, 1 << 17))
AFFINE_ROWS = ((32, MAIN_N, 2), (4, MAIN_N, 2), (8, 1024, 2), (64, 1024, 3))

# The deep affine scan (csrc/scan.cu's affine_deep_pass): fast mode's
# feedback at MAX_J < J <= MAX_DEEP_J = 16, which tuun_tpu runs as an
# associative scan of companion maps (its Pallas kernel takes J <= 4).
DEEP_KERNELS = ("affine_scan_deep_f32", "affine_scan_deep_rows_f32")
REPLACES.update({k: "tuun_tpu/engine/graph.py:893" for k in DEEP_KERNELS})
# Its depths and lengths in phase 2: one tile, the render's block (render()
# and the CLI scan 65536-lane blocks, as phase 12's deep_offline does),
# 2^17 (the length PERF.md compares with the recurrence), 1024 tiles (a
# chain of 32 anchors) and a ragged last tile.
DEEP_KERNEL_JS = (9, 12, 16)
DEEP_SIZES = (1000, 1 << 16, 1 << 17, 1 << 20, (1 << 20) + 5)
# Error bound per J, as a fraction of the output's scale max(1, max|y|),
# f32 kernel against the float64 plain version on affine_input's stable
# sections: about 10x the largest error the kernel showed over
# DEEP_SIZES, a[1:] and the rows shapes on an H100 (700 W).  The float16
# control errs 5.6e-3 to 1.6e-2 of scale there and must fail each bound.
DEEP_AFFINE_TOL = {9: 3e-5, 12: 2e-5, 16: 2e-5}
# (J, N, block): a call over N lanes must give the bits of calls over its
# blocks of whole tiles, each from the last one's hist, as a tracker's
# lookahead window of blocks does (phase 12's deep session at 1024-lane
# blocks, sync_interval 4; T1's 65536-lane blocks).
DEEP_BLOCK_CALLS = ((12, 4096, 1024), (16, 1 << 17, 1 << 16),
                    (9, 40 * 1024, 1024))
# The rows form: T1's group (4 J = 12 voices at the live block) and 8
# J = 16 voices at T1's block.  The first is the kernels line's shape.
DEEP_ROWS = ((4, 1024, 12), (8, 1 << 17, 16))
# (J, N) of the single form whose time is split three ways: the render's
# block and 2^17 at each J (the first is the kernels line's shape) and the
# live block.
DEEP_SPLIT = ((16, 1 << 16), (9, 1 << 16), (12, 1 << 16), (16, 1 << 17),
              (9, 1 << 17), (12, 1 << 17), (9, 1024), (12, 1024), (16, 1024))


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean time of fn() over `iters` back-to-back calls: CUDA events
    around the run, after one warm-up call.  Where the host issues calls
    more slowly than the device runs them, this times the host."""
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


def graph_ms(torch, fn, calls: int = GRAPH_CALLS, replays: int = 5) -> float:
    """Device time of one fn() alone: CUDA events around replays of a
    CUDA graph that holds `calls` captured calls, so that no host work is
    timed.  One call on the capture stream first, outside the capture."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    del g
    return start.elapsed_time(end) / (replays * calls)


def host_us(torch, fn, calls: int = 200) -> float:
    """Host time of one fn() call: the wall time of issuing `calls` calls
    back to back, without waiting for the device (which drains after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


# Poles of the all-pole sections deeper than filter_4_3 (stable_feedback):
# the first J, then a real tail from -0.5 up; conjugate pairs are whole at
# every J the phases use (4, 8, 9, 12, 16, 17).
POLES = [0.9, 0.8, 0.5 + 0.3j, 0.5 - 0.3j, -0.6, 0.7j, -0.7j, 0.3, -0.4,
         0.2 + 0.5j, 0.2 - 0.5j, -0.85, 0.35, -0.45, 0.15, -0.2]


def stable_feedback(J: int):
    """Feedback coefficients a_1..a_J of a stable all-pole section."""
    import numpy as np
    if J == 1:
        return np.array([-0.5])  # filter_1_1 (bench.py:75)
    if J == 2:  # lpf(0.7, 2000) at 48 kHz, as std.tuun computes it
        w0 = 2 * math.pi * 2000 / SR
        alpha = math.sin(w0) / (2 * 0.7)
        a0 = 1 + alpha
        return np.array([-2 * math.cos(w0) / a0, (1 - alpha) / a0])
    if J == 3:  # filter_4_3 (bench.py:80-83)
        return np.array([-2.5610316, 2.2132402, -0.6435727])
    if J > 32:
        # Past 32 the poles below leave the unit circle.  A section whose
        # sum |a_j| is 0.9 is stable for every pole, and stays so under
        # recurrence_input's jitter; every a_j is nonzero.
        k = np.arange(1, J + 1)
        w = np.cos(0.7 * k) * 0.97 ** k
        return 0.9 * w / np.abs(w).sum()
    roots = POLES + [-0.5 + 0.05 * k for k in range(J - len(POLES))]
    return np.real(np.poly(roots[:J]))[1:]


def phase_kernels(torch, np, scan_ops, results):
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    # -- prefix sum and max --------------------------------------------
    for n in PREFIX_SIZES:
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
        err = check_prefix(torch, np, scan_ops, "sum", x,
                           scan_ops.prefix_sum_f32(x), f"n={n}")
        plain_err = float((scan_ops.prefix_sum_ref(x).double()
                           - torch.cumsum(x.double(), 0)).abs().max())
        iters = 200 if n <= 65536 else 50 if n <= 4 << 20 else 10
        split = n in SPLIT_SIZES
        row = prefix_times(torch, scan_ops.prefix_sum_f32,
                           scan_ops.prefix_sum_ref, x, iters, split)
        log(f"prefix_sum_f32 n={n}: max_abs_err={err:.3e} (plain cumsum "
            f"{plain_err:.3e}) {format_times(row)}")
        results["prefix_sum_f32"].append(dict(row, n=n, err=err))

        for xm in (x, prefix_input(torch, np, rng, "max", n)):
            check_prefix(torch, np, scan_ops, "max", xm,
                         scan_ops.prefix_max_f32(xm), f"n={n}")
        row = prefix_times(torch, scan_ops.prefix_max_f32,
                           scan_ops.prefix_max_ref, x, iters, split)
        log(f"prefix_max_f32 n={n}: bit-identical to cummax (also on a "
            f"rising input) {format_times(row)}")
        results["prefix_max_f32"].append(dict(row, n=n, err=0.0))
        del x, xm
    # Misaligned inputs (x[1:] of a fresh tensor: 4 bytes past a 16-byte
    # boundary) take the kernel's scalar loads.
    for n in (1000, 1 << 20):
        errs = []
        for op, fn in prefix_ops(scan_ops):
            x = prefix_input(torch, np, rng, op, n + 1)[1:]
            check(x.data_ptr() % 16 != 0, "the x[1:] input is 16-byte aligned")
            errs.append(check_prefix(torch, np, scan_ops, op, x, fn(x),
                                     f"x[1:], n={n}"))
        log(f"prefix sum/max on x[1:] of {n + 1} lanes: sum max_abs_err="
            f"{errs[0]:.3e}, max bit-identical to cummax")
    # The sentinel case of the reset edge scan.
    x = torch.full((5000,), -3.0e18, device=dev)
    x[5], x[4100] = 7.0, 9.0
    check(torch.equal(scan_ops.prefix_max_f32(x), torch.cummax(x, 0).values),
          "prefix_max: -3e18 sentinel case differs from cummax")
    check_prefix_repeatable(torch, np, scan_ops, rng)
    check_prefix_graph(torch, np, scan_ops, rng, (3 * (1 << 20) + 37, 1 << 22))
    check_prefix_streams(torch, np, scan_ops, rng, 1 << 22)

    # -- affine scan ----------------------------------------------------
    for J in AFFINE_JS:
        for n in AFFINE_SIZES:
            args = affine_input(torch, np, rng, J, n)
            y, hist = scan_ops.affine_scan_f32(*args)
            err, scale, ref = check_affine(torch, scan_ops, args, y, hist,
                                           f"n={n}")
            plain_y, _ = scan_ops.affine_y_ref(*args)
            plain_err = float((plain_y.double() - ref).abs().max())
            del plain_y
            # Control: the same scan with maps and history in float16
            # must fail the bound, or the bound could not tell a
            # half-precision kernel from a right one.
            a, ff, live, h0 = args
            ctl, _ = scan_ops.affine_y_ref(a.half(), ff.half(), live,
                                           h0.half())
            ctl_err = float((ctl.double() - ref).abs().max())
            bound = affine_tol(J) * scale
            check(not ctl_err <= bound,
                  f"affine_scan J={J} n={n}: the float16 control "
                  f"({ctl_err:.3e}) passes the bound {bound:.3e}")
            del ctl, ref
            row = affine_times(torch, scan_ops, args,
                               split=(J, n) in AFFINE_SPLIT)
            log(f"affine_scan_f32 J={J} n={n}: max_abs_err={err:.3e} "
                f"= {err / scale:.2e} of scale {scale:.3g} (bound "
                f"{affine_tol(J):g}; plain {plain_err:.3e}, float16 "
                f"control {ctl_err / scale:.2e} of scale) "
                f"{format_times(row)}")
            results["affine_scan_f32"].append(dict(row, n=n, err=err, J=J))
            del args, a, ff, live, h0
    # Misaligned inputs (a[1:], ff[1:], live[1:] of fresh tensors) take
    # the kernel's scalar loads.
    for J in (2, 3):
        for n in (1000, 1 << 20):
            args = affine_input(torch, np, rng, J, n, offset=1)
            check(all(x.data_ptr() % 16 != 0 for x in args[:3]),
                  "the a[1:] / ff[1:] / live[1:] inputs are 16-byte aligned")
            err, scale, _ = check_affine(torch, scan_ops, args,
                                         *scan_ops.affine_scan_f32(*args),
                                         f"a[1:], ff[1:], n={n}")
            log(f"affine_scan_f32 J={J} on a[1:], ff[1:], live[1:] of {n + 1} "
                f"lanes: max_abs_err={err:.3e} = {err / scale:.2e} of scale")
    # In a child: the first profiler session of a process that has run no
    # graph or second stream (events went missing once after both).
    check_launches_in_child()
    check_affine_repeatable(torch, np, scan_ops, rng)
    check_affine_graph(torch, np, scan_ops, rng, (MAIN_N, (1 << 20) + 5))
    for n in AFFINE_STREAM_SIZES:
        check_affine_streams(torch, np, scan_ops, rng, n)
    phase_rows(torch, np, scan_ops, rng, results)
    t0 = time.perf_counter()
    phase_deep(torch, np, scan_ops, results)
    log(f"phase 2, the deep affine scan's checks: "
        f"{time.perf_counter() - t0:.1f} s")


def rows_input(torch, np, rng, op, B, n):
    """[B, n] rows: unit normal noise, on a ramp for the max (as
    prefix_input), each row its own draw."""
    x = rng.standard_normal((B, n))
    if op == "max":
        x += np.linspace(0, 50, n)
    return torch.from_numpy(x.astype(np.float32)).cuda()


def affine_rows_input(torch, np, rng, J, B, n):
    """affine_input for B rows, each row its own ff, live and h0."""
    a = np.broadcast_to(stable_feedback(J).astype(np.float32),
                        (B, n, J)).copy()
    ff = rng.standard_normal((B, n)).astype(np.float32)
    live = rng.random((B, n)) > 0.1
    h0 = rng.standard_normal((B, J)).astype(np.float32)
    return tuple(torch.from_numpy(x).cuda() for x in (a, ff, live, h0))


def check_prefix_rows(torch, np, scan_ops, op, x, got, what) -> float:
    """check_prefix on every row: the sum within 16 eps * running sum|x|
    of its row, the max bit-identical to torch.cummax(x, -1)."""
    if op == "max":
        check(torch.equal(got.view(torch.int32),
                          scan_ops.prefix_max_ref(x).view(torch.int32)),
              f"prefix_max rows {what}: not bit-identical to torch.cummax")
        return 0.0
    eps = float(np.finfo(np.float32).eps)
    bound = 16 * eps * torch.cumsum(x.double().abs(), -1)
    err = (got.double() - torch.cumsum(x.double(), -1)).abs()
    check(bool((err <= bound).all()),
          f"prefix_sum rows {what}: error {float(err.max()):.3e} above "
          f"16 eps sum|x|")
    return float(err.max())


def rows_times(torch, fn, ref, single, args, iters, B, plain_calls=(5, 2, 20)):
    """As prefix_times with the split, for a rows form, plus B single
    calls on the rows one after another (singles_ms by events,
    singles_device_ms from a graph of them, singles_host_us).  The plain
    version's device time is a graph of plain_calls[0] calls replayed
    plain_calls[1] times, its host time the mean of plain_calls[2]."""
    rows = [tuple(a[r] for a in args) for r in range(B)]

    def singles():
        for r in rows:
            single(*r)
    return {"ms": cuda_ms(torch, lambda: fn(*args), iters),
            "plain_ms": cuda_ms(torch, lambda: ref(*args), max(iters // 5, 2)),
            "device_ms": graph_ms(torch, lambda: fn(*args)),
            "plain_device_ms": graph_ms(torch, lambda: ref(*args),
                                        calls=plain_calls[0],
                                        replays=plain_calls[1]),
            "host_us": host_us(torch, lambda: fn(*args)),
            "plain_host_us": host_us(torch, lambda: ref(*args),
                                     calls=plain_calls[2]),
            "singles_ms": cuda_ms(torch, singles, 3),
            "singles_device_ms": graph_ms(torch, singles, calls=2, replays=2),
            "singles_host_us": host_us(torch, singles, calls=3)}


def phase_rows(torch, np, scan_ops, rng, results) -> None:
    """The voices x lanes forms at PREFIX_ROWS and AFFINE_ROWS: against
    their plain versions (torch.cumsum / cummax along the rows, the
    batched affine_y_ref in float64 within affine_tol), every row
    bit for bit against a single call on it, the same bits on 20 calls,
    one captured graph replayed three times over new data, and timed
    three ways beside B single calls.  (One kernel per call: check_one_
    launch.)"""
    s = torch.cuda.Stream()
    for B, n in PREFIX_ROWS:
        for op, single in prefix_ops(scan_ops):
            fn = getattr(scan_ops, f"prefix_{op}_rows_f32")
            x = rows_input(torch, np, rng, op, B, n)
            got = fn(x)
            err = check_prefix_rows(torch, np, scan_ops, op, x, got,
                                    f"B={B} n={n}")
            diff = sum(not torch.equal(got[r], single(x[r]))
                       for r in range(B))
            check(diff == 0, f"prefix_{op} rows B={B} n={n}: {diff} rows "
                  f"differ from a single call on the row")
            first = got.view(torch.int32)
            rep = sum(not torch.equal(fn(x).view(torch.int32), first)
                      for _ in range(19))
            check(rep == 0, f"prefix_{op} rows B={B} n={n}: {rep} of 19 "
                  f"repeats differ")
            static = torch.zeros_like(x)
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                fn(static)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=s):
                out = fn(static)
            for r in range(3):
                static.copy_(rows_input(torch, np, rng, op, B, n))
                g.replay()
                torch.cuda.synchronize()
                check_prefix_rows(torch, np, scan_ops, op, static, out,
                                  f"B={B} n={n} graph replay {r}")
            del g
            row = rows_times(torch, fn, scan_ops.prefix_sum_ref if op == "sum"
                             else scan_ops.prefix_max_ref, single, (x,), 50, B)
            log(f"prefix_{op}_rows_f32 B={B} n={n}: max_abs_err={err:.3e}, "
                f"rows bit-identical to single calls, 20 calls the same bits, "
                f"graph replays right; {format_times(row)}; {B} single calls "
                f"{row['singles_ms']:.4f} ms (device {row['singles_device_ms']:.4f}"
                f" ms, host {row['singles_host_us']:.1f} us)")
            results[f"prefix_{op}_rows_f32"].append(dict(row, n=n, B=B,
                                                         err=err))
            del x, got, static, out
    for B, n, J in AFFINE_ROWS:
        args = affine_rows_input(torch, np, rng, J, B, n)
        y, hist = scan_ops.affine_scan_rows_f32(*args)
        err, scale = check_affine_rows(torch, scan_ops, args, y, hist,
                                       f"B={B} n={n}")
        diff = 0
        for r in range(B):
            y1, hist1 = scan_ops.affine_scan_f32(*(a[r] for a in args))
            diff += not (torch.equal(y[r], y1) and torch.equal(hist[r], hist1))
        check(diff == 0, f"affine rows B={B} n={n} J={J}: {diff} rows "
              f"differ from a single call on the row")
        first = torch.cat([y.view(-1), hist.view(-1)]).view(torch.int32)
        rep = sum(not torch.equal(torch.cat(
            [x.view(-1) for x in scan_ops.affine_scan_rows_f32(*args)]).view(
            torch.int32), first) for _ in range(19))
        check(rep == 0, f"affine rows B={B} n={n}: {rep} of 19 repeats differ")
        static = tuple(a.clone() for a in args)
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            scan_ops.affine_scan_rows_f32(*static)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=s):
            out = scan_ops.affine_scan_rows_f32(*static)
        for r in range(3):
            for dst, src in zip(static[1:], affine_rows_input(
                    torch, np, rng, J, B, n)[1:]):
                dst.copy_(src)
            g.replay()
            torch.cuda.synchronize()
            check_affine_rows(torch, scan_ops, static, *out,
                              f"B={B} n={n} graph replay {r}")
        del g
        row = rows_times(torch, scan_ops.affine_scan_rows_f32,
                         scan_ops.affine_y_ref, scan_ops.affine_scan_f32,
                         args, 20, B)
        log(f"affine_scan_rows_f32 B={B} n={n} J={J}: max_abs_err={err:.3e} "
            f"= {err / scale:.2e} of scale (bound {affine_tol(J):g}), rows "
            f"bit-identical to single calls, 20 calls the same bits, graph "
            f"replays right; {format_times(row)}; {B} single calls "
            f"{row['singles_ms']:.4f} ms (device {row['singles_device_ms']:.4f}"
            f" ms, host {row['singles_host_us']:.1f} us)")
        results["affine_scan_rows_f32"].append(dict(row, n=n, B=B, J=J,
                                                    err=err))
        del args, y, hist, static, out


def check_affine_rows(torch, scan_ops, args, y, hist, what):
    """check_affine over B rows (the batched float64 plain version)."""
    err, scale, _ = check_affine(torch, scan_ops, args, y, hist,
                                 f"rows {what}")
    return err, scale


def affine_input(torch, np, rng, J, n, offset=0):
    """(a, ff, live, h0) on the card: a stable all-pole section's
    coefficients on every lane, unit normal ff, 10% dead lanes, and a
    random entering history.  With offset=1, a, ff and live are views
    [1:] of tensors one lane longer (4J, 4 and 1 bytes past a 16-byte
    boundary)."""
    a = np.broadcast_to(stable_feedback(J).astype(np.float32),
                        (n + offset, J)).copy()
    ff = rng.standard_normal(n + offset).astype(np.float32)
    live = rng.random(n + offset) > 0.1
    h0 = rng.standard_normal(J).astype(np.float32)
    a, ff, live = (torch.from_numpy(x).cuda()[offset:] for x in (a, ff, live))
    return a, ff, live, torch.from_numpy(h0).cuda()


def check_affine(torch, scan_ops, args, y, hist, what):
    """Holds (y, hist), single or rows, to the float64 plain version on the
    same inputs, within affine_tol(J) of the output's scale: y against
    h[..., 0] on live lanes (0 on dead ones), or, where a checkout's scan
    returns the J planes of h (y has a's shape), h against them.  Returns
    (max error, scale, the float64 output it was held to)."""
    a, ff, live, h0 = args
    J = a.shape[-1]
    ref, ref_hist = scan_ops.affine_scan_ref(a.double(), ff.double(), live,
                                             h0.double())
    if y.shape != a.shape:
        ref = torch.where(live, ref[..., 0], 0.0)
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.abs().max()))
    err = float((y.double() - ref).abs().max())
    herr = float((hist.double() - ref_hist).abs().max())
    bound = affine_tol(J) * scale
    check(err <= bound and herr <= bound,
          f"affine_scan J={J} {what}: error {err:.3e} (hist {herr:.3e}) "
          f"above {affine_tol(J):g} * {scale:.3g}")
    return err, scale, ref


def affine_times(torch, scan_ops, args, split):
    """As prefix_times, for the affine scan; the plain version (a doubling
    composition, ~55 ms a call at 2^20 lanes) is timed over fewer calls."""
    n = args[0].shape[0]
    big = n > MAIN_N
    fn = lambda: scan_ops.affine_scan_f32(*args)  # noqa: E731
    ref = lambda: scan_ops.affine_y_ref(*args)  # noqa: E731
    row = {"ms": cuda_ms(torch, fn, 10 if big else 50),
           "plain_ms": cuda_ms(torch, ref, 2 if big else 10)}
    if split:
        row.update(device_ms=graph_ms(torch, fn),
                   plain_device_ms=graph_ms(torch, ref, calls=2 if big else 10,
                                            replays=2),
                   host_us=host_us(torch, fn),
                   plain_host_us=host_us(torch, ref, calls=5 if big else 50))
    return row


def affine_bound_us(B: int, n: int, J: int) -> float:
    """The affine scan's bytes bound: 4J + 9 bytes a lane (a, ff and live
    read once, y written once) over the HBM rate."""
    return (4 * J + 9) * B * n / HBM_BYTES_PER_S * 1e6


def phase_times(torch, np, scan_ops, label: str) -> None:
    """The scans alone, for comparing two trees: the prefix sum and max at
    the live block and SPLIT_SIZES, the affine scan at AFFINE_SPLIT's
    shapes and its rows form at AFFINE_ROWS_SPLIT's, the deep affine scan
    at DEEP_SPLIT's (where the tree has it), the linear recurrence at
    REC_TIMES on each of REC_TIMES_LIVE and the df prefix sum at
    DF_TIMES, each held to its bound (each tree to its own contract; the
    recurrence to the one-step check, the df sum to DF_REL_TOL), kernels
    per call counted over all of them in this process's one profiler
    session, then timed three ways (device time alone among them).  Logs
    one JSON line per shape, the affine scan's beside the bound of y out
    (4J + 9 bytes a lane) whatever the tree returns, the recurrence's
    beside its chain model."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(0)
    prefix = [(op, fn, n, prefix_input(torch, np, rng, op, n))
              for n in (LIVE_BLOCK_N,) + SPLIT_SIZES
              for op, fn in prefix_ops(scan_ops)]
    for op, fn, n, x in prefix:
        check_prefix(torch, np, scan_ops, op, x, fn(x), "(--phase times)")
    inputs = [affine_input(torch, np, rng, J, n) for J, n in AFFINE_SPLIT]
    for args in inputs:
        check_affine(torch, scan_ops, args, *scan_ops.affine_scan_f32(*args),
                     "(--phase times)")
    rows = [affine_rows_input(torch, np, rng, J, B, n)
            for B, n, J in AFFINE_ROWS_SPLIT]
    for args in rows:
        check_affine(torch, scan_ops, args,
                     *scan_ops.affine_scan_rows_f32(*args), "(--phase times)")
    # The deep scan, where the tree timed has one.
    deep = [(J, n, deep_input(torch, np, rng, J, n)) for J, n in DEEP_SPLIT] \
        if hasattr(scan_ops, "affine_scan_deep_f32") else []
    for J, n, args in deep:
        check_deep(torch, scan_ops, args,
                   *scan_ops.affine_scan_deep_f32(*args), "(--phase times)")
    rec = [(B, n, J, dt, pat, recurrence_input(
        torch, np, rng, J, n, torch.float32 if dt == "f32" else torch.float64,
        None if B == 1 else B, dead=pat))
        for B, n, J, dt in REC_TIMES for pat in REC_TIMES_LIVE]
    for B, n, J, dt, pat, args in rec:
        check(recurrence_one_step_rows(torch, args,
                                       *rec_call(scan_ops, args)()),
              f"linear_recurrence ({B}, {n}) J={J} {dt} {pat} (--phase "
              f"times): a lane is not the step from its own history")
    df = [(B, n, df_input(torch, np, rng, n, None if B == 1 else B))
          for B, n in DF_TIMES]
    for B, n, args in df:
        check_df(torch, *args, *df_call(scan_ops, args)(),
                 f"({B}, {n}) (--phase times)")
    calls = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            for _, fn, _, x in prefix:
                fn(x)
            for args in inputs:
                scan_ops.affine_scan_f32(*args)
            for args in rows:
                scan_ops.affine_scan_rows_f32(*args)
            for _, _, args in deep:
                scan_ops.affine_scan_deep_f32(*args)
            for *_, args in rec:
                rec_call(scan_ops, args)()
            for *_, args in df:
                df_call(scan_ops, args)()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    per_call = len(names) / (calls * (len(inputs) + len(rows) + len(prefix)
                                      + len(deep) + len(rec) + len(df)))
    for op, fn, n, x in prefix:
        ref = scan_ops.prefix_sum_ref if op == "sum" \
            else scan_ops.prefix_max_ref
        row = prefix_times(torch, fn, ref, x, 200, split=True)
        if n == LIVE_BLOCK_N:
            lib = (lambda: torch.cumsum(x, 0)) if op == "sum" \
                else (lambda: torch.cummax(x, 0))
            row["library_device_ms"] = graph_ms(torch, lib)
        bound_us = 8 * n / HBM_BYTES_PER_S * 1e6
        log(json.dumps(dict(
            row, tree=label, op=f"prefix_{op}_f32", n=n,
            kernels_per_call=per_call, bound_us=bound_us,
            share_of_bound=bound_us / (row["device_ms"] * 1e3))))
    for (J, n), args in zip(AFFINE_SPLIT, inputs):
        row = affine_times(torch, scan_ops, args, split=True)
        bound_us = affine_bound_us(1, n, J)
        log(json.dumps(dict(
            row, tree=label, op="affine_scan_f32", J=J, n=n,
            kernels_per_call=per_call, kernels=sorted(set(names)),
            bound_us=bound_us,
            share_of_bound=bound_us / (row["device_ms"] * 1e3))))
    for (B, n, J), args in zip(AFFINE_ROWS_SPLIT, rows):
        fn = lambda: scan_ops.affine_scan_rows_f32(*args)  # noqa: E731
        row = {"ms": cuda_ms(torch, fn, 50), "device_ms": graph_ms(torch, fn),
               "host_us": host_us(torch, fn)}
        bound_us = affine_bound_us(B, n, J)
        log(json.dumps(dict(
            row, tree=label, op="affine_scan_rows_f32", B=B, J=J, n=n,
            kernels_per_call=per_call, bound_us=bound_us,
            share_of_bound=bound_us / (row["device_ms"] * 1e3))))
    for J, n, args in deep:
        row = deep_kernel_times(torch, scan_ops, args, split=True)
        bound_us = deep_bound(1, n, J)["bound_ms"] * 1e3
        log(json.dumps(dict(
            row, tree=label, op="affine_scan_deep_f32", J=J, n=n,
            kernels_per_call=per_call, bound_us=bound_us,
            share_of_bound=bound_us / (row["device_ms"] * 1e3))))
    for B, n, J, dt, pat, args in rec:
        row = dict(rec_kernel_times(torch, rec_call(scan_ops, args), n),
                   **rec_bound(B, n, J, dt))
        log(json.dumps(dict(
            row, tree=label, op=f"linear_recurrence_{dt}", B=B, n=n, J=J,
            live=pat, kernels_per_call=per_call,
            share_of_chain=row["chain_bound_ms"] / row["device_ms"],
            cycles_per_lane=row["device_ms"] * 1e-3 * SM_CLOCK_HZ / n)))
    for B, n, args in df:
        fn = df_call(scan_ops, args)
        row = dict(ms=cuda_ms(torch, fn, 50 if n > 4096 else 200),
                   device_ms=graph_ms(torch, fn), host_us=host_us(torch, fn),
                   bound_us=B * n * 16 / HBM_BYTES_PER_S * 1e6)
        log(json.dumps(dict(row, tree=label, op="df_prefix_sum_f32", B=B,
                            n=n, kernels_per_call=per_call,
                            share_of_bound=row["bound_us"]
                            / (row["device_ms"] * 1e3))))


def tree_scan_ops(tree: Path):
    """engine/scan_ops.py of the checkout at `tree`, imported from that
    checkout's package (first on the path, before this process imports
    the package); it builds that checkout's csrc/scan.cu.  A checkout
    whose plain (y, hist) version has its older name gets it under
    affine_y_ref too."""
    sys.path.insert(0, str(tree))
    from tuun_tpu_torch.engine import scan_ops as mod
    if not hasattr(mod, "affine_y_ref"):
        mod.affine_y_ref = mod.affine_scan_deep_ref
    return mod


def check_affine_repeatable(torch, np, scan_ops, rng) -> None:
    """The affine scan gives the same bits on every call of one input: the
    look-back's grouping is fixed, not set by which tiles finish first."""
    for J, n in ((2, MAIN_N), (3, (1 << 20) + 5)):
        args = affine_input(torch, np, rng, J, n)
        y1, hist1 = scan_ops.affine_scan_f32(*args)
        first = torch.cat([y1.view(-1), hist1]).view(torch.int32)
        differ = sum(not torch.equal(torch.cat(
            [x.view(-1) for x in scan_ops.affine_scan_f32(*args)]).view(
            torch.int32), first) for _ in range(199))
        check(differ == 0, f"affine_scan J={J} n={n}: {differ} of 199 "
              f"repeats differ from the first call")
        log(f"affine_scan J={J} n={n}: 200 calls on one input, all the same "
            f"bits (y and hist)")


def check_affine_graph(torch, np, scan_ops, rng, sizes) -> None:
    """For J = 2 and 3, one CUDA graph per length, all captured on one
    stream, each after a plain call at its length on that stream (the
    longest first, so that the stream's scratch holds it).  Replayed in
    turns, three times each, over new ff, live and h0 copied into the
    static inputs; each replay is held to AFFINE_TOL."""
    s = torch.cuda.Stream()
    graphs = []
    for J in (2, 3):
        for n in sorted(sizes, reverse=True):
            static = affine_input(torch, np, rng, J, n)
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                scan_ops.affine_scan_f32(*static)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=s):
                out = scan_ops.affine_scan_f32(*static)
            graphs.append((J, n, g, static, out))
    for r in range(3):
        for J, n, g, static, _ in graphs:
            for dst, src in zip(static[1:], affine_input(torch, np, rng, J,
                                                         n)[1:]):
                dst.copy_(src)
            g.replay()
        torch.cuda.synchronize()
        for J, n, _, static, out in graphs:
            check_affine(torch, scan_ops, static, *out,
                         f"graph replay {r}, n={n}")
    del graphs
    log(f"affine_scan J=2, 3 captured in CUDA graphs on one stream at "
        f"n={sizes}: 3 replays each, in turns, over new data within "
        f"AFFINE_TOL")


def check_affine_streams(torch, np, scan_ops, rng, n) -> None:
    """Two back-to-back calls on a second stream interleaved with two on
    the first: each stream has its own scratch, so all four are right."""
    main, side = torch.cuda.current_stream(), torch.cuda.Stream()
    for J in (2, 3):
        inputs = [affine_input(torch, np, rng, J, n) for _ in range(4)]
        side.wait_stream(main)
        outs = []
        for i in range(2):
            outs.append(scan_ops.affine_scan_f32(*inputs[2 * i]))
            with torch.cuda.stream(side):
                outs.append(scan_ops.affine_scan_f32(*inputs[2 * i + 1]))
        main.wait_stream(side)
        torch.cuda.synchronize()
        for i, (args, got) in enumerate(zip(inputs, outs)):
            check_affine(torch, scan_ops, args, *got,
                         f"{'second' if i % 2 else 'first'} stream, call "
                         f"{i // 2}")
    log(f"affine_scan J=2, 3: two calls on a second stream interleaved with "
        f"two on the first, n={n}: all within AFFINE_TOL")


def deep_input(torch, np, rng, J, n, misalign=False, B=None):
    """(a, ff, live, h0) on the card as affine_input makes them (a stable
    J-deep section on every lane, unit normal ff, 10% dead lanes, a random
    entering history), with B, B rows.  With misalign (one row only), a is
    a view 4 bytes into a buffer of n J + 1 floats and ff and live are
    views [1:], so none is 16-byte aligned."""
    lead = () if B is None else (B,)
    a = np.broadcast_to(stable_feedback(J).astype(np.float32), (*lead, n, J))
    ff = rng.standard_normal((*lead, n + misalign)).astype(np.float32)
    live = rng.random((*lead, n + misalign)) > 0.1
    h0 = rng.standard_normal((*lead, J)).astype(np.float32)
    if misalign:
        flat = np.concatenate([np.zeros(1, np.float32), a.reshape(-1)])
        return (torch.from_numpy(flat).cuda()[1:].view(n, J),
                torch.from_numpy(ff).cuda()[1:],
                torch.from_numpy(live).cuda()[1:], torch.from_numpy(h0).cuda())
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).cuda()
                 for x in (a, ff, live, h0))


def check_deep(torch, scan_ops, args, y, hist, what):
    """Holds (y, hist), single or rows, to the float64 plain version on the
    same inputs within DEEP_AFFINE_TOL[J] of the output's scale, and the
    same scan in float16 must fail that bound.  Returns (max error,
    scale, float16 error)."""
    a, ff, live, h0 = args
    J = a.shape[-1]
    ref, ref_hist = scan_ops.affine_y_ref(a.double(), ff.double(),
                                                  live, h0.double())
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.abs().max()))
    err = max(float((y.double() - ref).abs().max()),
              float((hist.double() - ref_hist).abs().max()))
    bound = DEEP_AFFINE_TOL[J] * scale
    check(err <= bound, f"affine_scan_deep J={J} {what}: error {err:.3e} "
          f"above {DEEP_AFFINE_TOL[J]:g} * {scale:.3g}")
    ctl, _ = scan_ops.affine_y_ref(a.half(), ff.half(), live,
                                           h0.half())
    ctl_err = float((ctl.double() - ref).abs().max())
    check(not ctl_err <= bound, f"affine_scan_deep J={J} {what}: the "
          f"float16 control ({ctl_err:.3e}) passes the bound {bound:.3e}")
    return err, scale, ctl_err


def deep_bound(B: int, n: int, J: int) -> dict:
    """The least time for the deep scan's work on the card: the bytes it
    must move (a 4J, ff 4, live 1 read, y 4 written a lane) over the
    memory rate, or its operations (J multiply-adds a lane) over the
    float32 peak, whichever is larger."""
    bytes_ms = B * n * (4 * J + 9) / HBM_BYTES_PER_S * 1e3
    ops_ms = B * n * 2 * J / PEAK_FLOPS["f32"] * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def deep_kernel_times(torch, scan_ops, args, split, rows=False):
    """As affine_times, for the deep scan (single or rows form)."""
    B = args[1].shape[0] if rows else 1
    big = B * args[1].shape[-1] >= 1 << 20
    kernel = scan_ops.affine_scan_deep_rows_f32 if rows \
        else scan_ops.affine_scan_deep_f32
    fn = lambda: kernel(*args)  # noqa: E731
    ref = lambda: scan_ops.affine_y_ref(*args)  # noqa: E731
    row = {"ms": cuda_ms(torch, fn, 10 if big else 50),
           "plain_ms": cuda_ms(torch, ref, 2 if big else 10)}
    if split:
        row.update(device_ms=graph_ms(torch, fn),
                   plain_device_ms=graph_ms(torch, ref, calls=2, replays=2),
                   host_us=host_us(torch, fn),
                   plain_host_us=host_us(torch, ref, calls=5 if big else 20))
    return row


def deep_same_bits(torch, fn, args, calls: int) -> int:
    """How many of `calls` repeats of fn(*args) differ from the first."""
    first = torch.cat([x.reshape(-1) for x in fn(*args)]).view(torch.int32)
    return sum(not torch.equal(torch.cat(
        [x.reshape(-1) for x in fn(*args)]).view(torch.int32), first)
        for _ in range(calls))


def phase_deep(torch, np, scan_ops, results) -> None:
    """The deep affine scan on the card (part of phase 2): the single form
    at DEEP_KERNEL_JS x DEEP_SIZES and on misaligned inputs against the
    float64 plain version within DEEP_AFFINE_TOL (a float16 control
    failing each bound), timed (three ways at DEEP_SPLIT); the same bits
    on repeated calls; CUDA graphs captured on one stream at two lengths,
    replayed in turns over new data; a depth past MAX_DEEP_J refused;
    the rows form at DEEP_ROWS against the plain version, each row the
    bits of a single call, the same bits on repeat, a graph replayed,
    timed beside B single calls.  (One kernel per call: check_one_
    launch.)"""
    rng = np.random.default_rng(9)
    name = "affine_scan_deep_f32"
    shapes = [(J, n) for J in DEEP_KERNEL_JS for n in DEEP_SIZES]
    shapes += [s for s in DEEP_SPLIT if s not in shapes]
    for J, n in shapes:
        args = deep_input(torch, np, rng, J, n)
        err, scale, ctl = check_deep(torch, scan_ops, args,
                                     *scan_ops.affine_scan_deep_f32(*args),
                                     f"n={n}")
        row = deep_kernel_times(torch, scan_ops, args,
                                split=(J, n) in DEEP_SPLIT)
        log(f"{name} J={J} n={n}: max_abs_err={err:.3e} = {err / scale:.2e} "
            f"of scale {scale:.3g} (bound {DEEP_AFFINE_TOL[J]:g}; float16 "
            f"control {ctl / scale:.2e} of scale) {format_times(row)}")
        results[name].append(dict(row, B=1, n=n, J=J, err=err,
                                  **deep_bound(1, n, J)))
        del args
    for J in DEEP_KERNEL_JS:
        for n in (1000, (1 << 16) + 3):
            args = deep_input(torch, np, rng, J, n, misalign=True)
            check(all(x.data_ptr() % 16 != 0 for x in args[:3]),
                  "the deep scan's misaligned inputs are 16-byte aligned")
            err, scale, _ = check_deep(torch, scan_ops, args,
                                       *scan_ops.affine_scan_deep_f32(*args),
                                       f"misaligned, n={n}")
            log(f"{name} J={J} on a, ff, live 4 bytes past a 16-byte "
                f"boundary, n={n}: max_abs_err={err:.3e} = "
                f"{err / scale:.2e} of scale")
    for J, n in ((12, 1 << 17), (16, (1 << 20) + 5)):
        args = deep_input(torch, np, rng, J, n)
        differ = deep_same_bits(torch, scan_ops.affine_scan_deep_f32, args,
                                49)
        check(differ == 0, f"{name} J={J} n={n}: {differ} of 49 repeats "
              f"differ from the first call")
    log(f"{name}: 50 calls at J=12 n=2^17 and J=16 n=2^20+5 on one input "
        f"each, all the same bits (y and hist)")
    for J, n, block in DEEP_BLOCK_CALLS:
        args = deep_input(torch, np, rng, J, n)
        y, hist = scan_ops.affine_scan_deep_f32(*args)
        h, parts = args[3], []
        for s0 in range(0, n, block):
            yb, h = scan_ops.affine_scan_deep_f32(
                *(x[s0:s0 + block] for x in args[:3]), h)
            parts.append(yb)
        check(torch.equal(torch.cat(parts).view(torch.int32),
                          y.view(torch.int32))
              and torch.equal(h.view(torch.int32), hist.view(torch.int32)),
              f"{name} J={J}: {n} lanes in {block}-lane calls, each from "
              f"the last one's hist, differ from one call")
    log(f"{name}: one call equals the same lanes in calls of whole tiles "
        f"chained by hist, bit for bit, at {DEEP_BLOCK_CALLS}")
    check_deep_graph(torch, np, scan_ops, rng)
    J = scan_ops.MAX_DEEP_J + 1
    try:
        scan_ops.affine_scan_deep_f32(*deep_input(torch, np, rng, J, 64))
        refused = False
    except NotImplementedError:
        refused = True
    check(refused, f"{name} took J={J}, past MAX_DEEP_J")
    s = torch.cuda.Stream()
    rows_name = "affine_scan_deep_rows_f32"
    for B, n, J in DEEP_ROWS:
        args = deep_input(torch, np, rng, J, n, B=B)
        y, hist = scan_ops.affine_scan_deep_rows_f32(*args)
        err, scale, _ = check_deep(torch, scan_ops, args, y, hist,
                                   f"rows B={B} n={n}")
        diff = 0
        for r in range(B):
            y1, h1 = scan_ops.affine_scan_deep_f32(*(x[r] for x in args))
            diff += not (torch.equal(y[r], y1) and torch.equal(hist[r], h1))
        check(diff == 0, f"{rows_name} B={B} n={n} J={J}: {diff} rows differ "
              f"from a single call on the row")
        rep = deep_same_bits(torch, scan_ops.affine_scan_deep_rows_f32, args,
                             19)
        check(rep == 0, f"{rows_name} B={B} n={n}: {rep} of 19 repeats "
              f"differ")
        static = tuple(x.clone() for x in args)
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            scan_ops.affine_scan_deep_rows_f32(*static)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=s):
            out = scan_ops.affine_scan_deep_rows_f32(*static)
        for k in range(3):
            for dst, src in zip(static[1:], deep_input(torch, np, rng, J, n,
                                                       B=B)[1:]):
                dst.copy_(src)
            g.replay()
            torch.cuda.synchronize()
            check_deep(torch, scan_ops, static, *out,
                       f"rows B={B} n={n} graph replay {k}")
        del g
        # From 2^20 lanes in all a plain scan of maps takes ~0.1 s a
        # call: its device and host times take fewer calls there.
        row = rows_times(torch, scan_ops.affine_scan_deep_rows_f32,
                         scan_ops.affine_y_ref,
                         scan_ops.affine_scan_deep_f32, args, 20, B,
                         (2, 1, 5) if B * n >= 1 << 20 else (5, 2, 20))
        log(f"{rows_name} B={B} n={n} J={J}: max_abs_err={err:.3e} = "
            f"{err / scale:.2e} of scale (bound {DEEP_AFFINE_TOL[J]:g}), rows "
            f"bit-identical to single calls, 20 calls the same bits, graph "
            f"replays right; {format_times(row)}; {B} single calls "
            f"{row['singles_ms']:.4f} ms (device {row['singles_device_ms']:.4f}"
            f" ms, host {row['singles_host_us']:.1f} us)")
        results[rows_name].append(dict(row, B=B, n=n, J=J, err=err,
                                       **deep_bound(B, n, J)))
        del args, y, hist, static, out


def check_deep_graph(torch, np, scan_ops, rng) -> None:
    """The deep scan at J = 9, 2^20 + 5 lanes (past the first scratch's
    tiles) and J = 16, 2^17 lanes, each captured in a CUDA graph on one
    stream after a plain call there (the longest first, so that the
    stream's scratch holds it), replayed in turns three times over new
    ff, live and h0, each replay held to DEEP_AFFINE_TOL."""
    s = torch.cuda.Stream()
    graphs = []
    for J, n in ((9, (1 << 20) + 5), (16, 1 << 17)):
        static = deep_input(torch, np, rng, J, n)
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            scan_ops.affine_scan_deep_f32(*static)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=s):
            out = scan_ops.affine_scan_deep_f32(*static)
        graphs.append((J, n, g, static, out))
    for k in range(3):
        for J, n, g, static, _ in graphs:
            for dst, src in zip(static[1:],
                                deep_input(torch, np, rng, J, n)[1:]):
                dst.copy_(src)
            g.replay()
        torch.cuda.synchronize()
        for J, n, _, static, out in graphs:
            check_deep(torch, scan_ops, static, *out,
                       f"graph replay {k}, n={n}")
    del graphs
    log("affine_scan_deep_f32 J=9 n=2^20+5 and J=16 n=2^17 captured in "
        "CUDA graphs on one stream: 3 replays each, in turns, over new data "
        "within DEEP_AFFINE_TOL")


def check_prefix(torch, np, scan_ops, op, x, got, what) -> float:
    """Holds `got`, the "sum" or "max" scan of x, to its reference: the
    sum within 16 eps * running sum|x| of the float64 prefix, the max
    bit-identical to torch.cummax.  Returns the sum's largest error."""
    if op == "max":
        check(torch.equal(got.view(torch.int32),
                          scan_ops.prefix_max_ref(x).view(torch.int32)),
              f"prefix_max {what}: not bit-identical to torch.cummax")
        return 0.0
    # Any summation order is within (#roundings) * eps * sum|x| of the
    # exact prefix.  A lane's value takes 16 in-thread roundings, 8 in
    # the block scan and 2 for the folds, plus the carry's: 8 in its tree
    # and one per anchor tile passed (one per 256 tiles), at the scale of
    # the running sum, where they mostly cancel: 16 eps * running sum|x|
    # is a strict bound in practice (tests/test_torch_scan_ops.py holds a
    # model of this order to it at up to 3*2^20+37 lanes).
    eps = float(np.finfo(np.float32).eps)
    bound = 16 * eps * torch.cumsum(x.double().abs(), 0)
    err = (got.double() - torch.cumsum(x.double(), 0)).abs()
    check(bool((err <= bound).all()),
          f"prefix_sum {what}: error {float(err.max()):.3e} above "
          f"16 eps sum|x|")
    return float(err.max())


def prefix_times(torch, fn, ref, x, iters, split):
    """{ms, plain_ms} by cuda_ms; with split, also device_ms,
    plain_device_ms (graph_ms), host_us and plain_host_us."""
    row = {"ms": cuda_ms(torch, lambda: fn(x), iters),
           "plain_ms": cuda_ms(torch, lambda: ref(x), iters)}
    if split:
        row.update(device_ms=graph_ms(torch, lambda: fn(x)),
                   plain_device_ms=graph_ms(torch, lambda: ref(x)),
                   host_us=host_us(torch, lambda: fn(x)),
                   plain_host_us=host_us(torch, lambda: ref(x)))
    return row


def format_times(row) -> str:
    text = f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms"
    if "device_ms" in row:
        text += (f"; device alone (graph of {GRAPH_CALLS}) kernel "
                 f"{row['device_ms']:.4f} ms, plain "
                 f"{row['plain_device_ms']:.4f} ms; host per call kernel "
                 f"{row['host_us']:.1f} us, plain "
                 f"{row['plain_host_us']:.1f} us")
    return text


def one_launch_calls(torch, np, scan_ops, rng) -> list:
    """The calls of check_one_launch, as (fn, args, kernel, tag): the
    prefix scans from 128 to 2^26 lanes and on x[1:]; the affine scan at
    J = 2 and 8 at every length of phase 2, on one tile (1000 lanes), and
    on a[1:], ff[1:], live[1:]; the voices x lanes forms at every shape of
    phase_rows; the deep affine scan at J = 9 and 16 and its rows form;
    phase 11's kernels (exact_one_launch_calls)."""
    from tuun_tpu_torch.engine import kernels
    xs = [torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
          for n in PREFIX_SIZES]
    xs.append(torch.from_numpy(
        rng.standard_normal(4097).astype(np.float32)).cuda()[1:])
    sym = kernels.KERNEL_SYMBOLS
    prefix = (("prefix_sum_f32", "SumOp"), ("prefix_max_f32", "MaxOp"))
    calls = [(getattr(scan_ops, key), (x,), sym[key], op)
             for x in xs for key, op in prefix]
    for J in (2, 8):
        for n, offset in [(n, 0) for n in AFFINE_SIZES + (1000,)] + [
                (1000, 1), (1 << 20, 1)]:
            calls.append((scan_ops.affine_scan_f32,
                          affine_input(torch, np, rng, J, n, offset),
                          sym["affine_scan_f32"], f"<{J},"))
    # The voices x lanes forms, at every shape of phase_rows.
    for B, n in PREFIX_ROWS:
        x = rows_input(torch, np, rng, "sum", B, n)
        calls += [(getattr(scan_ops, f"{key[:10]}_rows_f32"), (x,),
                   sym[f"{key[:10]}_rows_f32"], op) for key, op in prefix]
    for B, n, J in AFFINE_ROWS:
        calls.append((scan_ops.affine_scan_rows_f32,
                      affine_rows_input(torch, np, rng, J, B, n),
                      sym["affine_scan_rows_f32"], f"<{J},"))
    # The deep affine scan at J = 9 and 16: one tile, the render's block,
    # 2^17, a ragged 2^20 + 5, misaligned; its rows form at DEEP_ROWS (one
    # kernel per J, affine_deep_pass<J>, for both forms).
    for J in (9, 16):
        for n, mis in ((1000, False), (1 << 16, False), (1 << 17, False),
                       ((1 << 20) + 5, False), (1000, True)):
            calls.append((scan_ops.affine_scan_deep_f32,
                          deep_input(torch, np, rng, J, n, mis),
                          sym["affine_scan_deep_f32"], f"<{J}>"))
    for B, n, J in DEEP_ROWS:
        calls.append((scan_ops.affine_scan_deep_rows_f32,
                      deep_input(torch, np, rng, J, n, B=B),
                      sym["affine_scan_deep_rows_f32"], f"<{J}>"))
    return calls + exact_one_launch_calls(torch, np, scan_ops, rng)


def profile_calls(torch, scan_ops, calls, rounds: int = 1):
    """Every call once (so that each stream's scratch exists), then
    `rounds` times under torch.profiler.  Returns the device kernels the
    profiler saw, in the order they started, the host-side kernel launch
    calls it saw (cudaLaunchKernel or cuLaunchKernel), and the launches
    the wrappers counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tuun_tpu_torch.engine import kernels
    for fn, args, _, _ in calls:
        fn(*args)
    torch.cuda.synchronize()
    before = sum(kernels.launches.values())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            for fn, args, _, _ in calls:
                fn(*args)
        torch.cuda.synchronize()
    events = prof.events()
    device = [e.name for e in sorted(
        (e for e in events if e.device_type == DeviceType.CUDA),
        key=lambda e: e.time_range.start)]
    host = [e.name for e in events if e.device_type == DeviceType.CPU
            and "LaunchKernel" in e.name]
    return device, host, sum(kernels.launches.values()) - before


def check_one_launch(torch, np, scan_ops, rng) -> dict:
    """Every call of one_launch_calls is one CUDA kernel: no memset, no
    set-up or second kernel (torch.profiler).  More device work than
    that fails here.  Fewer kernels than calls is returned, not failed:
    the row names each (kernel, tag) that came up short, the calls whose
    kernel the profiler did not see (in call order), and the host's and
    the wrappers' counts of launches, for check_launches_in_child."""
    calls = one_launch_calls(torch, np, scan_ops, rng)
    names, host, counted = profile_calls(torch, scan_ops, calls)
    pairs = sorted({(k, t) for _, _, k, t in calls})
    seen, want = {}, {}
    for kernel, tag in pairs:
        key = f"{kernel} {tag}"
        want[key] = sum(k == kernel and t == tag for _, _, k, t in calls)
        seen[key] = sum(kernel in k and tag in k for k in names)
    other = sorted({k for k in names
                    if not any(kernel in k and tag in k
                               for kernel, tag in pairs)})
    extra = {k: [seen[k], want[k]] for k in want if seen[k] > want[k]}
    check(not extra and not other,
          f"scan calls ran more device work than one kernel each: "
          f"[seen, calls] {extra}; other device work {other}")
    short = {k: [seen[k], want[k]] for k in want if seen[k] < want[k]}
    if not short:
        check(len(names) == len(calls),
              f"{len(names)} device kernels for {len(calls)} calls")
    # The calls whose kernel is missing: the device kernels, in the order
    # they started, matched to the calls in order.
    missing, i = [], 0
    for c, (_, _, kernel, tag) in enumerate(calls):
        if i < len(names) and kernel in names[i] and tag in names[i]:
            i += 1
        else:
            missing.append(c)
    if not short:
        log(f"one launch per call: {len(names)} calls (prefix sum/max at "
            f"{len(PREFIX_SIZES) + 1} lengths from 128 to 2^26 and x[1:]; "
            f"affine scan at J = 2, 8 from 1000 to 2^20 + 5 lanes and on "
            f"a[1:]; the voices x lanes forms at {PREFIX_ROWS} and "
            f"{AFFINE_ROWS}; the deep affine scan at J = 9, 16 from 1000 to "
            f"2^20 + 5 lanes and misaligned, its rows form at {DEEP_ROWS}; "
            f"the linear recurrence in f32 and f64 at J = 2, "
            f"9 and its rows form; the df prefix sum from 1000 to 2^20 "
            f"lanes and its rows form) ran exactly one kernel each, no "
            f"memset")
    return dict(profile=LAUNCH_PROFILE, ok=not short, calls=len(calls),
                device_kernels=len(names), host_launch_calls=len(host),
                wrapper_launches=counted, short=short,
                missing_calls=missing)


def check_launches_in_child() -> None:
    """check_one_launch in a child process: the first profiler session
    of a process that has run no graph or second stream (kernel events
    went missing after both).  This card's profiler has also lost kernel
    records in a fresh process: where it saw fewer kernels than calls
    while the wrappers counted every launch, a new child runs the check
    again, up to LAUNCH_ATTEMPTS children.  The same short count in
    every child, or a wrapper that did not count its launch, fails."""
    for attempt in range(1, LAUNCH_ATTEMPTS + 1):
        row = profile_in_child([LAUNCH_PROFILE])[0]
        if row["ok"]:
            return
        check(row["wrapper_launches"] == row["calls"],
              f"one-launch check: the wrappers counted "
              f"{row['wrapper_launches']} launches for {row['calls']} calls")
        log(f"one-launch check, child {attempt} of {LAUNCH_ATTEMPTS}: the "
            f"profiler saw {row['device_kernels']} kernels for "
            f"{row['calls']} calls, each of which its wrapper launched "
            f"([seen, calls] {row['short']}, calls missing "
            f"{row['missing_calls']})")
    check(False, f"one-launch check: fewer kernels than calls in all "
          f"{LAUNCH_ATTEMPTS} children, the last {json.dumps(row)}")


def launches_in_process(torch, np, scan_ops) -> dict:
    """check_one_launch's calls, three rounds, under this process's first
    torch.profiler session, after every phase (graphs, second streams):
    where, in phase 2, the count once came up short.  Logged, not held:
    check_one_launch holds the count in a child.  Where the device
    kernels fall short of the host's launch calls and the wrappers'
    counts, the profiler lost a record of a kernel that was launched."""
    calls = one_launch_calls(torch, np, scan_ops, np.random.default_rng(1))
    kernels, host, counted = profile_calls(torch, scan_ops, calls, rounds=3)
    row = dict(calls=3 * len(calls), wrapper_launches=counted,
               device_kernels=len(kernels), host_launch_calls=len(host),
               host_launch_names=sorted(set(host)))
    log(f"in-process launch count {json.dumps(row)}")
    return row


def check_prefix_repeatable(torch, np, scan_ops, rng) -> None:
    """The prefix sum gives the same bits on every call of one input: the
    look-back's grouping is fixed, not set by which tiles finish first."""
    for n, calls in ((MAIN_N, 200), (3 * (1 << 20) + 37, 200), (1 << 26, 20)):
        x = prefix_input(torch, np, rng, "sum", n)
        first = scan_ops.prefix_sum_f32(x).view(torch.int32)
        differ = sum(not torch.equal(scan_ops.prefix_sum_f32(x).view(
            torch.int32), first) for _ in range(calls - 1))
        check(differ == 0, f"prefix_sum n={n}: {differ} of {calls - 1} "
              f"repeats differ from the first call")
        log(f"prefix_sum n={n}: {calls} calls on one input, all the same bits")
        del x, first


def check_prefix_graph(torch, np, scan_ops, rng, sizes) -> None:
    """Each prefix op captured into one CUDA graph per length, all on one
    stream, each capture after a plain call at its length on that stream.
    The graphs are replayed in turns, three times each, over new data
    copied into their static inputs: each replay finds the scratch the
    run before it left, and no later call or capture freed memory that
    an earlier graph uses."""
    s = torch.cuda.Stream()
    for op, fn in prefix_ops(scan_ops):
        graphs = []
        for n in sizes:
            static_x = torch.zeros(n, device="cuda")
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                fn(static_x)  # the stream's scratch, outside the capture
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=s):
                static_out = fn(static_x)
            graphs.append((n, g, static_x, static_out))
        for r in range(3):
            for n, g, static_x, _ in graphs:
                static_x.copy_(prefix_input(torch, np, rng, op, n))
                g.replay()
            torch.cuda.synchronize()
            for n, _, static_x, static_out in graphs:
                check_prefix(torch, np, scan_ops, op, static_x, static_out,
                             f"graph replay {r}, n={n}")
        del graphs
    log(f"prefix sum/max captured in CUDA graphs on one stream at n={sizes}: "
        f"3 replays each, in turns, over new data match the plain versions")


def check_prefix_streams(torch, np, scan_ops, rng, n) -> None:
    """Two back-to-back calls on a second stream, interleaved with two on
    the first: each stream has its own scratch, so all four are right."""
    main, side = torch.cuda.current_stream(), torch.cuda.Stream()
    for op, fn in prefix_ops(scan_ops):
        xs = [prefix_input(torch, np, rng, op, n) for _ in range(4)]
        side.wait_stream(main)
        outs = []
        for i in range(2):
            outs.append(fn(xs[2 * i]))
            with torch.cuda.stream(side):
                outs.append(fn(xs[2 * i + 1]))
        main.wait_stream(side)
        torch.cuda.synchronize()
        for i, (x, got) in enumerate(zip(xs, outs)):
            check_prefix(torch, np, scan_ops, op, x, got,
                         f"{'second' if i % 2 else 'first'} stream, call "
                         f"{i // 2}")
    log(f"prefix sum/max: two calls on a second stream interleaved with two "
        f"on the first, n={n}: all right")


def prefix_ops(scan_ops):
    return (("sum", scan_ops.prefix_sum_f32), ("max", scan_ops.prefix_max_f32))


def prefix_input(torch, np, rng, op, n):
    """Unit normal noise for the sum (as its bound assumes); for the max,
    the same on a ramp from 0 to 50, so that the running max changes in
    every tile and each tile's carry from the look-back decides lanes."""
    x = rng.standard_normal(n)
    if op == "max":
        x += np.linspace(0, 50, n)
    return torch.from_numpy(x.astype(np.float32)).cuda()


# ---------------------------------------------------------------------------
# The interval gates (csrc/lanes.cu via engine/lane_ops.py): the lanes phase
# ---------------------------------------------------------------------------

LANE_KERNELS = ("interval_gate", "interval_mask")
# (rows, lanes) of their checks: the offline cells' window (256 voices x
# 16 x 65536 lanes), one block of it, the live block's group of 8, one
# voice (also unbatched), and a width that is no multiple of 4 (the
# kernels' scalar accesses).  The first is the timed shape.
LANE_SHAPES = ((256, 1 << 20), (256, 65536), (8, 1024), (1, 65536),
               (8, 1025))
# An operand's forms (tests/test_torch_lane_ops.py's): a tensor of rows,
# a lane vector every row shares, one value a row, one 0-dim tensor every
# row shares, an immediate.
LANE_FORMS = ("rows", "lanes", "row_scalar", "scalar", "immediate")
# The benchmark's cells whose windows the gates must reach.
LANE_CELLS = ("fm_vibrato.offline", "saw_lpf.offline")


def lane_intervals(torch, rng, rows: int, n: int):
    """One [s, e) a row, int64 on the card: the whole block, empty, s < 0,
    e > n, s > e, e = n, inside it, then random ends over [-n/4, 5n/4)."""
    fixed = [(0, n), (n // 3, n // 3), (-7, n // 2), (n // 4, n + 9),
             (n // 2, n // 5), (n // 3, n), (5, n - 3)]
    ends = rng.integers(-(n // 4), n + n // 4, size=(rows, 2))
    pairs = [fixed[r] if r < len(fixed) else tuple(ends[r])
             for r in range(rows)]
    s = torch.tensor([p[0] for p in pairs], dtype=torch.int64).cuda()
    e = torch.tensor([p[1] for p in pairs], dtype=torch.int64).cuda()
    return s, e


def lane_operand(torch, form: str, rows: int, n: int, seed: int):
    """(the operand, its vmap in_dim, its value as [rows, n] broadcasts
    it in the plain chain)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if form == "rows":
        x = torch.randn(rows, n, generator=g, device="cuda")
        return x, 0, x
    if form == "lanes":
        x = torch.randn(n, generator=g, device="cuda")
        return x, None, x
    if form == "row_scalar":
        x = torch.randn(rows, generator=g, device="cuda")
        return x, 0, x[:, None]
    if form == "scalar":
        x = torch.randn((), generator=g, device="cuda")
        return x, None, x
    return 0.25 + seed, None, 0.25 + seed


_LANE_IDX: dict = {}


def lane_idx(torch, n: int):
    """A block's lane index on the card, made once a width (as a render
    makes its Ctx's once): no arange kernel beside a timed or counted
    call."""
    if n not in _LANE_IDX:
        _LANE_IDX[n] = torch.arange(n, device="cuda")
    return _LANE_IDX[n]


def lane_chain(torch, n, s, e, a, b):
    """The plain four-op chain the engine ran before: two broadcast
    compares, their `&`, the `where` (s, e [rows] or 0-dim)."""
    idx = lane_idx(torch, n)
    lo = s[:, None] if s.dim() else s
    hi = e[:, None] if e.dim() else e
    m = (idx >= lo) & (idx < hi)
    return m if a is None else torch.where(m, a, b)


def vmapped_gate(torch, lane_ops, n, args):
    """lane_ops.interval_gate (or interval_mask, for two args) under
    torch.func.vmap, as a group's render calls it: args are (value,
    in_dim) of s, e[, a, b]; a voice axis of its own where vmap batches
    none of them."""
    idx = lane_idx(torch, n)
    fn = lane_ops.interval_gate if len(args) == 4 else lane_ops.interval_mask
    rows = next(x.shape[d] for x, d in args if d is not None)
    tensors = [x for x, _ in args if isinstance(x, torch.Tensor)]
    dims = [d for x, d in args if isinstance(x, torch.Tensor)]

    def one(*ts):
        it = iter(ts)
        return fn(idx, *[next(it) if isinstance(x, torch.Tensor) else x
                         for x, _ in args])
    return torch.func.vmap(one, in_dims=tuple(dims))(*tensors).reshape(
        rows, n)


def check_lane_shape(torch, np, lane_ops, rows: int, n: int) -> int:
    """Every operand form x form, each end batched or shared, and the
    mask: bit for bit the chain at (rows, n); returns the calls made."""
    rng = np.random.default_rng(rows * 7 + n)
    s, e = lane_intervals(torch, rng, rows, n)
    # Shared ends: s < 0, e > n.
    s1 = torch.tensor(-7, dtype=torch.int64, device="cuda")
    e1 = torch.tensor(n + 9, dtype=torch.int64, device="cuda")
    ops = {f: lane_operand(torch, f, rows, n, i)
           for i, f in enumerate(LANE_FORMS)}
    ops_b = {f: lane_operand(torch, f, rows, n, 10 + i)
             for i, f in enumerate(LANE_FORMS)}
    calls = 0
    for (sv, ds), (ev, de) in (((s, 0), (e, 0)), ((s, 0), (e1, None)),
                               ((s1, None), (e, 0))):
        for fa in LANE_FORMS:
            for fb in LANE_FORMS:
                a, da, ca = ops[fa]
                b, db, cb = ops_b[fb]
                got = vmapped_gate(torch, lane_ops, n,
                                   [(sv, ds), (ev, de), (a, da), (b, db)])
                want = lane_chain(torch, n, sv, ev, ca, cb).expand(rows, n)
                check(torch.equal(got, want),
                      f"interval_gate ({rows}, {n}) {fa} / {fb}, ends "
                      f"{'batched' if ds == 0 else 'shared'} / "
                      f"{'batched' if de == 0 else 'shared'}: differs "
                      f"from the chain at "
                      f"{int((got != want).sum())} lanes")
                calls += 1
        got = vmapped_gate(torch, lane_ops, n, [(sv, ds), (ev, de)])
        check(torch.equal(got, lane_chain(torch, n, sv, ev, None, None)
                          .expand(rows, n)),
              f"interval_mask ({rows}, {n}) differs from the chain")
        calls += 1
    # Layouts a batching rule may receive: the voice axis second, lanes
    # off a 16-byte boundary, lanes expanded from one value.
    base = torch.randn(rows, n + 1, device="cuda")
    for what, x, d, c in (
            ("voices second", base[:, :n].t().contiguous(), 1, base[:, :n]),
            ("misaligned", base[:, 1:], 0, base[:, 1:]),
            ("expanded", base[:, :1].expand(rows, n), 0, base[:, :1])):
        got = vmapped_gate(torch, lane_ops, n, [(s, 0), (e, 0), (x, d),
                                                (0.0, None)])
        check(torch.equal(got, lane_chain(torch, n, s, e, c, 0.0)
                          .expand(rows, n)),
              f"interval_gate ({rows}, {n}) on {what} operands differs")
        calls += 1
    if rows == 1:  # a single voice: the unbatched call
        idx = lane_idx(torch, n)
        a = ops["rows"][0][0]
        got = lane_ops.interval_gate(idx, s[0], e[0], a, 0.0)
        check(torch.equal(got, lane_chain(torch, n, s[0], e[0], a, 0.0)),
              f"interval_gate on one voice ({n}) differs")
        got = lane_ops.interval_mask(idx, s[0], 7)
        check(torch.equal(got, lane_chain(torch, n, s[0], torch.tensor(
            7, device="cuda"), None, None)), "interval_mask on one voice")
        calls += 2
    torch.cuda.synchronize()
    return calls


def lane_kernels_per_call(torch, lane_ops, n: int, rows: int) -> dict:
    """The device kernels of LANE_CALLS gate and mask calls under
    torch.profiler: each call one kernel of csrc/lanes.cu, nothing else
    (no memset, no copy).  A session may drop an event, so one fewer seen
    than launched passes; more device work than one kernel a call, or
    another kernel, fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tuun_tpu_torch.engine import kernels
    s = torch.arange(rows, device="cuda") * 3
    e = s + n // 2
    a = torch.randn(rows, n, device="cuda")
    calls = [lambda: vmapped_gate(torch, lane_ops, n, [(s, 0), (e, 0),
                                                        (a, 0), (0.0, None)]),
             lambda: vmapped_gate(torch, lane_ops, n, [(s, 0), (e, 0)])]
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    before = {k: kernels.launches[k] for k in LANE_KERNELS}
    rounds = 8
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            for fn in calls:
                fn()
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if ev.device_type == DeviceType.CUDA]
    gate = sum("interval_gate_kernel" in x for x in names)
    mask = sum("interval_mask_kernel" in x for x in names)
    launched = {k: kernels.launches[k] - before[k]
                for k in LANE_KERNELS}
    row = dict(calls=2 * rounds, launched=launched, gate_kernels=gate,
               mask_kernels=mask, other=len(names) - gate - mask)
    check(launched == {"interval_gate": rounds, "interval_mask": rounds},
          f"lanes: launches counted {launched} for {rounds} calls each")
    check(row["other"] == 0 and rounds - 1 <= gate <= rounds
          and rounds - 1 <= mask <= rounds,
          f"lanes: not one kernel a call: {row} {names[:6]}")
    return row


def lane_graph_replays(torch, scan_ops, lane_ops, rows: int, n: int) -> dict:
    """A gate and a mask captured in one CUDA graph inside a capture's
    graph_scope, replayed three times over new ends and operands copied
    into the static inputs, each replay bit for bit the chain; the
    capture records their launches, and no scan call (so no marker)."""
    from tuun_tpu_torch.engine import kernels
    rng = np.random.default_rng(5)
    s, e = lane_intervals(torch, rng, rows, n)
    a = torch.randn(rows, n, device="cuda")
    b = torch.randn(n, device="cuda")

    def step():
        return (vmapped_gate(torch, lane_ops, n, [(s, 0), (e, 0), (a, 0),
                                                  (b, None)]),
                vmapped_gate(torch, lane_ops, n, [(s, 0), (e, 0)]))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    owner = object()
    with torch.cuda.stream(stream):
        step()
        g = torch.cuda.CUDAGraph()
        with kernels.graph_scope(owner, record=True) as rec:
            g.capture_begin()
            out = step()
            g.capture_end()
    torch.cuda.synchronize()
    check(rec == [] and dict(rec.launches) == {"interval_gate": 1,
                                               "interval_mask": 1},
          f"lanes capture recorded {list(rec)} {dict(rec.launches)}")
    for k in range(3):
        s2, e2 = lane_intervals(torch, np.random.default_rng(100 + k),
                                rows, n)
        s.copy_(s2.flip(0))
        e.copy_(e2.flip(0))
        a.copy_(torch.randn(rows, n, device="cuda"))
        g.replay()
        torch.cuda.synchronize()
        check(torch.equal(out[0], lane_chain(torch, n, s, e, a, b)),
              f"lanes graph replay {k}: the gate differs from the chain")
        check(torch.equal(out[1], lane_chain(torch, n, s, e, None, None)),
              f"lanes graph replay {k}: the mask differs from the chain")
    scan_ops.release_scratch(owner)
    return dict(replays=3, launches=dict(rec.launches))


def lane_bound_ms(rows: int, n: int, s, e, a_form: str, b_form: str,
                  out_bytes: int = 4) -> float:
    """The least time the card could take: the output written once and,
    per lane, the operand it selects read once where that is a tensor
    (a lane vector once for all rows, one value a row once a row), over
    HBM_BYTES_PER_S.  s, e: each row's ends as Python ints."""
    inside = sum(max(0, min(hi, n) - max(lo, 0)) for lo, hi in zip(s, e))
    total = rows * n * out_bytes
    for form, lanes in ((a_form, inside), (b_form, rows * n - inside)):
        if form == "rows":
            total += 4 * lanes
        elif form == "lanes":
            total += 4 * n
        elif form == "row_scalar":
            total += 4 * rows
    return total / HBM_BYTES_PER_S * 1e3


def lane_times(torch, lane_ops, rows: int, n: int) -> list:
    """Device time (replays of captured graphs) of the kernel and of the
    plain chain at (rows, n), in turns (kernel, chain, chain, kernel),
    beside the bytes bound: the engine's commonest gate (a tensor of rows
    and 0.0, every row live: 8 B a lane), two tensors of rows over random
    intervals (still 8 B a lane: each lane reads the one it selects; the
    four-op chain reads both), a shared lane vector and one value a row,
    and the mask (1 B a lane)."""
    rng = np.random.default_rng(9)
    full = (torch.zeros(rows, dtype=torch.int64, device="cuda"),
            torch.full((rows,), n, dtype=torch.int64, device="cuda"))
    rand = lane_intervals(torch, rng, rows, n)
    a = torch.randn(rows, n, device="cuda")
    b = torch.randn(rows, n, device="cuda")
    v = torch.randn(n, device="cuda")
    c = torch.randn(rows, device="cuda")
    cases = (("rows / 0.0, live", full, (a, 0, a), (0.0, None, 0.0),
              "rows", "immediate"),
             ("rows / rows, random", rand, (a, 0, a), (b, 0, b),
              "rows", "rows"),
             ("lanes / row scalar, random", rand, (v, None, v),
              (c, 0, c[:, None]), "lanes", "row_scalar"),
             ("mask, random", rand, None, None, None, None))
    out = []
    for what, (s, e), A, B, fa, fb in cases:
        if A is None:
            def kern():
                vmapped_gate(torch, lane_ops, n, [(s, 0), (e, 0)])

            def chain():
                lane_chain(torch, n, s, e, None, None)
            bound = lane_bound_ms(rows, n, s.tolist(), e.tolist(), None,
                                  None, out_bytes=1)
        else:
            def kern(A=A, B=B):
                vmapped_gate(torch, lane_ops, n, [(s, 0), (e, 0), A[:2],
                                                  B[:2]])

            def chain(A=A, B=B):
                lane_chain(torch, n, s, e, A[2], B[2])
            bound = lane_bound_ms(rows, n, s.tolist(), e.tolist(), fa, fb)
        k1 = graph_ms(torch, kern, calls=10, replays=3)
        c1 = graph_ms(torch, chain, calls=10, replays=3)
        c2 = graph_ms(torch, chain, calls=10, replays=3)
        k2 = graph_ms(torch, kern, calls=10, replays=3)
        out.append(dict(case=what, rows=rows, n=n, bound_ms=bound,
                        device_ms=[k1, k2], chain_ms=[c1, c2],
                        share_pct=[100 * bound / k1, 100 * bound / k2],
                        chain_share_pct=[100 * bound / c1,
                                         100 * bound / c2]))
        log(f"lanes times {json.dumps(out[-1])}")
    return out


def load_harness():
    """portbench/harness.py, loaded by path (it finds its own files)."""
    import importlib.util
    path = Path(__file__).resolve().parent / "portbench" / "harness.py"
    spec = importlib.util.spec_from_file_location("portbench_harness", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look themselves up
    spec.loader.exec_module(mod)
    return mod


def lanes_in_cells(lane_ops) -> dict:
    """Each benchmark cell run once, traced, for 1 s through the
    benchmark's harness: the gates' launches in the traced slice (4
    windows of 16 blocks, replays counting their captures' launches) by
    the program's own counters, which must show the kernels engaged,
    beside the slice's device operations a block and the run's check."""
    harness = load_harness()
    rows = {}
    for i, name in enumerate(LANE_CELLS):
        cell = harness.load_cell(harness.ROOT, name)
        res = harness.run_cell(cell, 3100000001 + i, 1.0, True,
                               time.perf_counter())
        tr = res["run"].trace
        windows = tr.blocks // int(cell.traffic["sync_interval"])
        lo, hi = tr.slice_us
        ops = [ev for ev in tr.device_events if ev[2] > lo and ev[1] < hi]
        rows[name] = dict(
            correct=bool(res["checks"]["correct"]),
            mix_err=res["checks"]["mix_err"], blocks=tr.blocks,
            windows=windows,
            launches={k: tr.launches.get(k, 0) for k in LANE_KERNELS},
            per_window={k: tr.launches.get(k, 0) / windows
                        for k in LANE_KERNELS},
            kernels_per_block=len(ops) / tr.blocks,
            gate_device_ms=sum(ev[2] - ev[1] for ev in ops
                               if "interval_" in ev[0]) / 1e3)
        log(f"lanes in {name} {json.dumps(rows[name])}")
        check(rows[name]["correct"], f"lanes: {name} not correct")
        check(tr.launches.get("interval_gate", 0) > 0,
              f"lanes: no interval_gate launch in {name}'s windows")
    return rows


def phase_lanes(torch, np, scan_ops) -> dict:
    """The interval gates on the card: bit for bit the plain chain at
    LANE_SHAPES for every operand form, edge intervals and layout, one
    kernel a call, a captured graph replayed, a float64 operand refused,
    the device times at the first shape beside the chain's and the bytes
    bound, and the gates' launches in the benchmark's cells."""
    from tuun_tpu_torch.engine import graph, lane_ops
    lane_ops.load_library()
    t0 = time.perf_counter()
    row = dict(per_call=lane_kernels_per_call(torch, lane_ops, 65536, 8))
    log(f"lanes one kernel a call {json.dumps(row['per_call'])}")
    calls = {f"{r}x{n}": check_lane_shape(torch, np, lane_ops, r, n)
             for r, n in LANE_SHAPES}
    log(f"lanes bit for bit the chain: {json.dumps(calls)} calls by shape "
        f"in {time.perf_counter() - t0:.1f} s")
    row["graph"] = lane_graph_replays(torch, scan_ops, lane_ops, 8, 65536)
    ctx = graph.Ctx(1024, "cuda")
    try:
        graph._gate(ctx, ctx.zero, ctx.end,
                    torch.ones(1024, dtype=torch.float64, device="cuda"), 0.0)
        check(False, "lanes: a float64 operand was not refused")
    except ValueError:
        pass
    row["times"] = lane_times(torch, lane_ops, *LANE_SHAPES[0])
    row["cells"] = lanes_in_cells(lane_ops)
    return row


def phase_noise(torch, np):
    # noise_np is the port's copy of the oracle's noise, held bit-identical
    # to tuun_tpu's by tests/test_torch_noise.py.
    from tuun_tpu_torch.noisegen import noise_np, noise_torch
    idx = np.arange(1 << 20, dtype=np.int64) + (2 ** 31 - 1000)
    seed, uid = 0xDEADBEEF, 0x9E3779B9
    got = noise_torch(seed, uid, torch.from_numpy(idx).cuda()).cpu().numpy()
    want = noise_np(seed, uid, idx.astype(np.uint32))
    check(np.array_equal(got.view(np.int32), want.view(np.int32)),
          "noise_torch on CUDA differs from noise_np")
    log("noise_torch: bit-identical to noise_np over 2^20 indices")


def phase_sin(torch):
    """sin at all 2^24 NCO grid angles (the angles every constant-
    frequency sine takes in fast mode), on the card against the CPU.  The
    analytic Reset tiers take edges from the phase's top bit where the
    generic tiers take them from sin's sign, so on the card sin(angle) >= 0
    must hold exactly when the phase is below 2^31: checked."""
    from tuun_tpu_torch.engine.graph import _nco_angle
    ph = torch.arange(1 << 24, dtype=torch.int64) << 8
    below = ph < 2 ** 31
    ang_cpu = _nco_angle(ph)
    ang_gpu = _nco_angle(ph.cuda())
    sin_cpu = torch.sin(ang_cpu)
    sin_gpu = torch.sin(ang_gpu).cpu()
    ang_diff = int((ang_gpu.cpu().view(torch.int32)
                    != ang_cpu.view(torch.int32)).sum())
    val_diff = int((sin_gpu.view(torch.int32)
                    != sin_cpu.view(torch.int32)).sum())
    ulps = (sin_gpu.view(torch.int32).long()
            - sin_cpu.view(torch.int32).long()).abs().max()
    bad_gpu = int(((sin_gpu >= 0) != below).sum())
    log(f"sin at 2^24 NCO grid angles: angles differ card vs CPU at "
        f"{ang_diff}; sin values differ at {val_diff} (max {int(ulps)} "
        f"ulp); sign != (phase < 2^31) at {bad_gpu} on the card, "
        f"{int(((sin_cpu >= 0) != below).sum())} on the CPU")
    check(bad_gpu == 0, f"sin's sign differs from the phase's top bit at "
          f"{bad_gpu} grid angles on the card: the analytic Reset tiers "
          f"would move edges")


def fast_mode_errors(got, ref):
    """Deviation statistics of a fast-mode render against the oracle."""
    import numpy as np
    err = np.abs(got.astype(np.float64) - ref)
    peak = max(float(np.abs(ref).max()), 1e-6)
    large = err > 0.05 * peak
    edges = np.diff(np.concatenate(([0], large.view(np.int8), [0])))
    runs = np.flatnonzero(edges == -1) - np.flatnonzero(edges == 1)
    return dict(max_abs=float(err.max()), median=float(np.median(err)),
                peak=peak, frac_large=float(large.mean()),
                max_run=int(runs.max()) if len(runs) else 0)


# Fast-mode tolerances against the oracle (f64 phase, sequential
# IIR in the reference op order), per workload class:
#  * FM (W3): the f32 prefix-sum phase within one 65536-lane block reaches
#    |phase| ~ 2.2e3 rad (ulp 2.4e-4); a few ulp at amplitude 0.5 keeps
#    every sample within 2e-3.
#  * Reset + filter (W1, W2): the fast NCO quantizes each frequency to a
#    32-bit phase increment, so its reset edges drift from the f64
#    oracle's by one sample at a time, and the filter smears each moved
#    edge over a few samples.  The JAX engine's fast mode deviates from the
#    oracle identically (CPU, the same first 2 s at 48 kHz: 2.71% of
#    harmonica(10.0, 440)'s samples and 0.24% of the filtered saw's off by
#    > 5% of peak, longest runs 11 and 12; the port on the CPU matches JAX
#    fast within 1.1e-6).  A wrong boundary or state carry corrupts a
#    contiguous run instead.  Bounds: median
#    |err| <= 1e-3 * peak, at most 3% of samples off by > 5% of peak, no
#    such run longer than 64 samples.
TOL_FM_MAX_ABS = 2e-3


def check_fast_mode(name, stats, fm: bool):
    if fm:
        check(stats["max_abs"] <= TOL_FM_MAX_ABS,
              f"{name}: max error {stats['max_abs']:.3e} above "
              f"{TOL_FM_MAX_ABS}")
        return
    check(stats["median"] <= 1e-3 * stats["peak"]
          and stats["frac_large"] <= 3e-2 and stats["max_run"] <= 64,
          f"{name}: fast-mode deviation outside tolerance: {stats}")


class TrackerRuns:
    """While active, records every Tracker built (optionally pinning its
    `fuse_blocking`), every voice one activates and, for every block it
    renders, how it was served: "pervoice" (one call per member), "fused"
    (one replay of the fused step's graph), "open" (a lookahead window
    opened: one replay), "served" (a window's later block: no call) or
    "idle" (no voice), with its dispatches.  The engine's valid samples are
    read from what the tracker resolved (Voice.produced): on the fused and
    window paths no CompiledVoice.render_block runs, and a replay runs no
    Python at all."""

    def __init__(self, fuse_blocking=None):
        self.fuse_blocking = fuse_blocking

    def __enter__(self):
        import torch
        from tuun_tpu_torch.tracker import Tracker
        self.trackers, self.voices, self.blocks = [], [], []
        self.walls = []  # (a capture was running, seconds) per block
        self.pools = []  # each closed tracker's live graphs' pools
        self._saved = (Tracker.__init__, Tracker._activate,
                       Tracker.render_block, Tracker.close)
        init, activate, render, close = self._saved
        runs = self

        def init_(tracker, *a, **k):
            init(tracker, *a, **k)
            if runs.fuse_blocking is not None:
                tracker.fuse_blocking = runs.fuse_blocking
            runs.trackers.append(tracker)

        def activate_(tracker, p, block_start):
            voice = activate(tracker, p, block_start)
            runs.voices.append(voice)
            return voice

        def close_(tracker):
            runs.pools.append(tracker_pools(torch, tracker))
            close(tracker)

        def render_(tracker):
            opens, replays = tracker.window_opens, tracker.replays
            busy = tracker.captures_started > tracker.captures_finished
            t0 = time.perf_counter()
            out = render(tracker)
            runs.walls.append((busy, time.perf_counter() - t0))
            status = out[1]
            if tracker.window_opens > opens:
                path = "open"
            elif status.dispatches == 0:
                path = "served" if status.voices else "idle"
            elif tracker.replays > replays:
                path = "fused"
            else:
                path = "pervoice"
            runs.blocks.append((path, status.dispatches))
            return out
        Tracker.__init__, Tracker._activate = init_, activate_
        Tracker.render_block, Tracker.close = render_, close_
        return self

    def __exit__(self, *exc):
        from tuun_tpu_torch.tracker import Tracker
        (Tracker.__init__, Tracker._activate, Tracker.render_block,
         Tracker.close) = self._saved

    def paths(self) -> dict:
        """Blocks per path, the dispatches of each path's blocks, and the
        tracker's capture, replay, window and prefetch counters."""
        out = {k: sum(p == k for p, _ in self.blocks)
               for k in ("pervoice", "fused", "open", "served", "idle")}
        out["dispatches"] = {k: sorted({d for p, d in self.blocks if p == k})
                             for k in out if out[k]}
        for name in ("captures_started", "captures_finished", "replays",
                     "window_opens", "prefetch_hits", "prefetch_misses"):
            out[name] = sum(getattr(t, name) for t in self.trackers)
        out["capture_s"] = [x for t in self.trackers
                            for x in t.capture_seconds]
        if self.pools:  # at the first close, the session's end
            out["graphs"] = self.pools[0]
        # What a capture costs the serve thread: the blocks rendered while
        # one of the tracker's captures ran, beside the others.
        for key, busy in (("blocks_capturing", True),
                          ("blocks_not_capturing", False)):
            ms = sorted(w * 1e3 for b, w in self.walls if b == busy)
            if ms:
                out[key] = dict(n=len(ms), p50_ms=ms[len(ms) // 2],
                                max_ms=ms[-1])
        return out


def check_paths(name, paths) -> None:
    """A fused block is one dispatch, a window's opening block one and
    every block it serves none."""
    d = paths["dispatches"]
    check(d.get("fused", [1]) == [1] and d.get("open", [1]) == [1]
          and d.get("served", [0]) == [0],
          f"{name}: dispatches per path {d}")


def tracker_pools(torch, tracker) -> dict:
    """The bytes and count of the memory pools of a tracker's live CUDA
    graphs (each captured session step has its own)."""
    pools = {ent["step"]._graph.pool()
             for ent in tracker._fused_cache.values()
             if ent["fn"] is not None and ent["step"].captured}
    segs = [sg for sg in torch.cuda.memory_snapshot()
            if tuple(sg.get("segment_pool_id", ())) in pools]
    return dict(graph_pool_bytes=sum(sg["total_size"] for sg in segs),
                graphs=len(pools))


def graph_memory(torch) -> dict:
    """The allocator's reserved and allocated bytes, and the bytes and
    count of its private pools (CUDA graphs' memory), after freeing what
    nothing holds: the pools left are those of graphs still alive."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    stats = torch.cuda.memory_stats()
    pools = [sg for sg in torch.cuda.memory_snapshot()
             if tuple(sg.get("segment_pool_id", (0, 0))) != (0, 0)]
    return dict(reserved_bytes=stats.get("reserved_bytes.all.current", 0),
                allocated_bytes=stats.get("allocated_bytes.all.current", 0),
                graph_pool_bytes=sum(sg["total_size"] for sg in pools),
                graph_pools=len({tuple(sg["segment_pool_id"])
                                 for sg in pools}))


def phase_main_path(torch, np, scan_ops, tmp: Path):
    from tuun_tpu_torch import cli, native, optimizer, oracle
    from tuun_tpu_torch.engine import kernels
    from tuun_tpu_torch.evaluator import Evaluator
    from tuun_tpu_torch.expr import ESeq
    from tuun_tpu_torch.player import build_top_level_waveform
    from tuun_tpu_torch.wav import read_wav

    ev = Evaluator(SR, 90, cli.DEFAULT_LIBRARY)
    summary = []
    for name, expr, precompute, needs in WORKLOADS:
        before = dict(kernels.launches)
        out = tmp / f"{name}.wav"
        argv = ["--expr", expr, "--sample_rate", str(SR), "--buffer_size",
                str(BUFFER), "--device", "cuda", "--render-out", str(out),
                "-O", str(tmp), "--quiet"]
        if precompute is not None:
            argv += ["--precompute", precompute]
        value = ev.evaluate_source(expr, opens=("std",))
        if isinstance(value, ESeq):
            value = value.waveform
        top = build_top_level_waveform(optimizer.optimize(value.waveform),
                                       0.0)
        want_len = native.NativeOracle(top, SR).length(700 * SR)
        if name in REPEATABLE:
            check_timeline(name, top)
        # Two runs: the first pays first-use costs (the evaluator's stdlib
        # load, CUDA context warm-up, allocator growth), the second is the
        # steady state a batch of renders sees.  Each CLI run builds its
        # own tracker, so each captures its session steps anew.  W5 and W6
        # capture inline (fuse_blocking), so that both renders serve the
        # same blocks from the same paths and can give the same bits (a
        # window renders 16 blocks in one call, which rounds differently
        # from 16 block renders); the rest capture on the worker, as the
        # CLI does.
        walls, bits, paths = [], [], []
        for _ in range(2):
            with TrackerRuns(True if name in REPEATABLE else None) as runs:
                t0 = time.perf_counter()
                rc = cli.main(argv)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            check(rc == 0, f"{name}: the CLI exited {rc}")
            paths.append(runs.paths())
            check_paths(name, paths[-1])
            if name in REPEATABLE:
                bits.append(read_wav(out)[0].view(np.int32))
            # The tracker's one voice must end exactly where the oracle
            # does (not run past it, not stop short), by the valid ends
            # the tracker resolved on every path.
            produced = [v.produced for v in runs.voices]
            check(len(produced) == 1 and produced[0] == want_len,
                  f"{name}: the engine reported {produced} valid samples "
                  f"per voice, the oracle's length is {want_len}")
        if name in REPEATABLE:
            check(np.array_equal(bits[0], bits[1]),
                  f"{name}: two renders differ at "
                  f"{int((bits[0] != bits[1]).sum())} samples")
        got, sr = read_wav(out)
        check(sr == SR and np.isfinite(got).all(),
              f"{name}: bad WAV (sr {sr}, finite {np.isfinite(got).all()})")
        check(len(got) == want_len,
              f"{name}: {len(got)} samples, the oracle says {want_len}")
        m = int(PREFIX_SECONDS * SR)
        ref = oracle.render(top, m, SR, seed=1)
        stats = fast_mode_errors(got[:m], ref)
        check_fast_mode(name, stats, fm=name == "W3")
        for k in needs:
            check(kernels.launches[k] > before[k],
                  f"{name}: kernel {k} was never launched")
        seconds = len(got) / SR
        log(f"{name} paths " + json.dumps(dict(workload=name, cold=paths[0],
                                               warm=paths[1])))
        log(f"{name} {expr!r} --precompute {precompute or 'true (default)'}"
            f": engine valid samples {produced[0]}, WAV {len(got)} "
            f"samples, oracle {want_len} ({seconds:.1f} s audio); "
            f"wall cold {walls[0]:.3f} s = {seconds / walls[0]:.1f}x "
            f"realtime, warm {walls[1]:.3f} s = {seconds / walls[1]:.1f}x "
            f"realtime; "
            f"first {PREFIX_SECONDS:.0f} s vs oracle: max_abs "
            f"{stats['max_abs']:.3e}, median {stats['median']:.3e}, "
            f"off>5%peak {stats['frac_large']:.2e}, max run "
            f"{stats['max_run']}"
            + ("; the same bits on both renders" if name in REPEATABLE
               else ""))
        summary.append((name, seconds / walls[1]))
    return summary


def check_timeline(name, top) -> None:
    """`top` compiles to a timeline; for W6, its 16 tones are one stacked
    chord (one evaluation of the tone over a [16, n] parameter table)."""
    from tuun_tpu_torch.engine import CompiledVoice, EngineConfig
    from tuun_tpu_torch.engine.timeline import CTimeline, _Chord
    voice = CompiledVoice(top, EngineConfig(SR, "fast", "cuda"))
    tl = next((n for n in iter_nodes(voice.root)
               if isinstance(n, CTimeline)), None)
    check(voice._has_timeline and tl is not None,
          f"{name}: did not compile to a timeline")
    P = voice.params()
    plan = tl._plan_for(P, voice.lits_for(P))
    if name == "W6":
        check([(type(x), getattr(x, "count", 1)) for x in plan.items]
              == [(_Chord, 16)], f"W6: not one chord of 16: {plan.items}")
    else:
        check(plan.const is not None, f"{name}: no step sum")
    log(f"{name}: a timeline of {len(tl.infos)} leaves, "
        f"{'one chord of 16 stacked tones' if name == 'W6' else 'a step sum'}"
        f", total {plan.total} samples")


def workload_waveform(expr):
    """The optimized IR of a workload expression (port front end, 48 kHz)
    and its length from the native oracle."""
    from tuun_tpu_torch import cli, native, optimizer
    from tuun_tpu_torch.evaluator import Evaluator
    from tuun_tpu_torch.expr import ESeq
    value = Evaluator(SR, 90, cli.DEFAULT_LIBRARY).evaluate_source(
        expr, opens=("std",))
    if isinstance(value, ESeq):
        value = value.waveform
    w = optimizer.optimize(value.waveform)
    return w, native.NativeOracle(w, SR).length(700 * SR)


def engine_render(torch, voice, P, total: int):
    """The whole piece through CompiledVoice.render_block in MAIN_N-lane
    blocks from a fresh state, without reading anything back; returns
    (blocks, the last block's samples)."""
    st = voice.init(P)
    done = blocks = 0
    while done < total:
        m = min(MAIN_N, total - done)
        y, _, st, _ = voice.render_block(P, st, MAIN_N, 0, m)
        done += m
        blocks += 1
    torch.cuda.synchronize()
    return blocks, y


class GenericTiers:
    """While active, every Reset compiles to the generic sampled-sign
    tiers: the "before" of the analytic tiers."""

    def __enter__(self):
        from tuun_tpu_torch.engine.graph import CReset
        self._saved = {k: CReset.__dict__[k] for k in (
            "_analytic_ok", "_wrap_edge_info", "_wrap_edge_info_pwm")}
        CReset._analytic_ok = staticmethod(lambda t, c: False)
        CReset._wrap_edge_info = classmethod(lambda cls, t, c: None)
        CReset._wrap_edge_info_pwm = classmethod(lambda cls, t, c: None)
        return self

    def __exit__(self, *exc):
        from tuun_tpu_torch.engine.graph import CReset
        for k, v in self._saved.items():
            setattr(CReset, k, v)


PROFILES = (("W1", False), ("W1", True), ("W2", False), ("W2", True),
            ("W3", False), ("W5", False), ("W6", False), ("W2g", False))
# A profile name's suffix that forces the generic Reset tiers.
GENERIC = ":generic"


# Blocks each workload profile renders (at most): the first 16 of the
# piece (cut from the whole piece to keep the run's time).
PROFILE_BLOCKS = 16


def workload_profile(torch, name: str, generic: bool):
    """(meta, run) for the profile of workload `name`'s first
    PROFILE_BLOCKS blocks through CompiledVoice (warm): run() renders
    them and returns (blocks, {})."""
    from tuun_tpu_torch.engine import CompiledVoice, EngineConfig
    from tuun_tpu_torch.engine.graph import CReset
    expr = next(e for n, e, _, _ in WORKLOADS if n == name)
    w, total = workload_waveform(expr)
    total = min(total, PROFILE_BLOCKS * MAIN_N)
    cfg = EngineConfig(SR, "fast", "cuda")
    if generic:
        with GenericTiers():
            voice = CompiledVoice(w, cfg)
    else:
        voice = CompiledVoice(w, cfg)
    resets = [n for n in iter_nodes(voice.root) if isinstance(n, CReset)]
    P = voice.params(1)
    engine_render(torch, voice, P, total)  # warm: plans, allocator
    meta = dict(profile=name, tiers="generic" if generic else "default",
                analytic_resets=sum(r.analytic for r in resets),
                generic_resets=sum(not r.analytic for r in resets),
                audio_seconds=total / SR)
    return meta, lambda: (engine_render(torch, voice, P, total)[0], {})


def profile_session(torch, scan_ops, runs) -> list:
    """Every (meta, run) of `runs` once, in turn, under one torch.profiler
    session (the process's first: a later session may lose kernel
    events), each inside a record_function range of its own and ended by
    a synchronize, so that its device events are those that start in
    its range.  One row per run: device events, their summed time, the
    wall, the device's idle share and the scan launches, per block."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from tuun_tpu_torch.engine import kernels
    walls, scans, outs = [], [], []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i, (_, run) in enumerate(runs):
            torch.cuda.synchronize()
            kernels.reset_launches()
            with record_function(f"smoke_run_{i}"):
                t0 = time.perf_counter()
                outs.append(run())  # ends synchronized
                walls.append(time.perf_counter() - t0)
            scans.append(dict(kernels.launches))
    events = prof.events()
    spans = {e.name: (e.time_range.start, e.time_range.end) for e in events
             if e.name.startswith("smoke_run_")
             and e.device_type == DeviceType.CPU}
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith("smoke_run_")]
    rows = []
    for i, ((meta, _), (blocks, extra)) in enumerate(zip(runs, outs)):
        lo, hi = spans[f"smoke_run_{i}"]
        evs = [e for e in device if lo <= e.time_range.start < hi]
        busy_ms = sum(e.time_range.elapsed_us() for e in evs) / 1e3
        n_kernels = sum(not e.name.startswith(("Memcpy", "Memset"))
                        for e in evs)
        rows.append(dict(meta, blocks=blocks, device_events=len(evs),
                         kernels=n_kernels, events_per_block=len(evs) / blocks,
                         device_busy_ms=busy_ms, wall_ms=walls[i] * 1e3,
                         idle_share=1.0 - busy_ms / (walls[i] * 1e3),
                         scan=scans[i], **extra))
    return rows


def iter_nodes(node):
    """Every node of a compiled tree, timeline leaves included."""
    from tuun_tpu_torch.engine.graph import Node
    from tuun_tpu_torch.engine.timeline import CTimeline
    yield node
    for attr in ("a", "b", "inner", "trigger", "pos", "neg", "freq",
                 "phase", "length"):
        child = getattr(node, attr, None)
        if isinstance(child, Node):
            yield from iter_nodes(child)
    for child in list(getattr(node, "ffs", ())) + list(getattr(node, "fbs",
                                                               ())):
        yield from iter_nodes(child)
    if isinstance(node, CTimeline):
        for info in node.infos:
            yield from iter_nodes(info.node)


def profile_in_child(names) -> list:
    """`chip_smoke.py --profile NAME[,NAME...]` in a child process, whose
    first torch.profiler session takes them all (a process's later
    sessions may lose kernel events; each process costs ~25 s to start);
    one JSON row each."""
    argv = [sys.executable, str(Path(__file__).resolve()), "--profile",
            ",".join(names)]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"profile {names}: exit "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    rows = [json.loads(x) for x in proc.stdout.strip().splitlines()[-len(
        names):]]
    log(f"profiles of {names}: child process {time.perf_counter() - t0:.1f}"
        f" s")
    for row in rows:
        log(f"profile {json.dumps(row)}")
    return rows


def phase_profiles() -> None:
    """PROFILES in one child process, one profiler session.  With the
    analytic tiers, W1 and W2 must launch no running max; with them
    forced off, they must."""
    rows = profile_in_child([name + (GENERIC if generic else "")
                             for name, generic in PROFILES])
    for (name, generic), row in zip(PROFILES, rows):
        if name in ("W1", "W2"):
            maxes = row["scan"]["prefix_max_f32"]
            check((maxes > 0) == generic
                  and (row["generic_resets"] > 0) == generic,
                  f"profile {name}: tiers {row['tiers']} with "
                  f"{row['generic_resets']} generic resets launched "
                  f"{maxes} running maxes")


def phase_reloc_fast(torch) -> list:
    """W1, W2, W5 and W6 warm through CompiledVoice in MAIN_N-lane blocks,
    the default config against EngineConfig(reloc_fast=True), in turns
    (default, fast, fast, default), one warm-up render each first.  The
    last blocks of the two paths must agree within 4 f32 spacings of the
    output's scale (the fast path evaluates the same closures; a timeline
    takes its broadcast form there)."""
    import numpy as np
    from tuun_tpu_torch.engine import CompiledVoice, EngineConfig
    rows = []
    for name in ("W1", "W2", "W5", "W6"):
        expr = next(e for n, e, _, _ in WORKLOADS if n == name)
        w, total = workload_waveform(expr)
        voices = {flag: CompiledVoice(w, EngineConfig(SR, "fast", "cuda",
                                                      reloc_fast=flag))
                  for flag in (False, True)}
        params = {flag: v.params(1) for flag, v in voices.items()}
        last = {flag: engine_render(torch, v, params[flag], total)[1]
                for flag, v in voices.items()}
        diff = float((last[True] - last[False]).abs().max())
        scale = max(1.0, float(last[False].abs().max()))
        check(diff <= 4 * float(np.spacing(np.float32(scale))),
              f"{name}: reloc_fast's last block differs by {diff:.3e}")
        walls = {False: [], True: []}
        for flag in (False, True, True, False):
            t0 = time.perf_counter()
            engine_render(torch, voices[flag], params[flag], total)
            walls[flag].append(time.perf_counter() - t0)
        seconds = total / SR
        row = dict(reloc=name, relocatable=voices[True].relocatable,
                   fast_default=voices[True].fast_default,
                   default_s=walls[False], reloc_fast_s=walls[True],
                   default_x=[seconds / t for t in walls[False]],
                   reloc_fast_x=[seconds / t for t in walls[True]],
                   last_block_diff=diff)
        log(f"reloc_fast {json.dumps(row)}")
        rows.append(row)
    return rows


# -- phase 8: voice groups ----------------------------------------------

# bench.py:181-227's polyphony lane: 256 same-structure FM voices, consts
# jittered by 1 + 0.001 i, one batched render per 2^17-lane block.
G1_EXPR = ("sine(2*pi * 220, 3 * sine(2*pi * 222, 0)) * 0.01"
           " | fin(time - 3600)")
G1_VOICES = 256
G1_BLOCK = 1 << 17
G1_BLOCKS = 10
# The jittered consts move each voice's Fin cutoff, so the voices share
# no literal cutoffs: the stateful path, the one bench.py's call takes.
G1_FAST = False
# G2: a polyphonic tracker session at 48 kHz, three instruments, each a
# template of (frequency, seconds) and the pitches its notes cycle
# through.  Every Reset trigger's consts key the compiled structure
# (engine.structure_key, as in tuun_tpu), so harmonica and W2g notes
# share a structure, and group, only at one pitch; FM notes group at
# every pitch.  The harmonica reaches the affine scan (lpf) and the
# analytic Reset tiers, FM the prefix sum, W2g the prefix max (a Reset
# no analytic tier takes) and the affine scan.
G2_INSTRUMENTS = (
    ("harmonica", "harmonica({d}, {f})", (440.0, 660.0)),
    ("fm", "sine(2*pi*({f} + 30*$(5)), 0) * 0.5 | fin(time - {d})",
     (220.0, 247.0, 277.0, 330.0)),
    ("w2g", "reset(triangle({f}), time * -{f}) * 2 | lpf(0.7, 2000) "
     "| fin(time - {d})", (110.0, 165.0)),
)
# (block, notes per instrument, seconds over which notes start, note
# lengths in seconds, mix tolerance): the live block for ~2 s, the
# offline block for ~10 s.  A group sums its FM voices' phase increments
# (the block's phase advance, ~2 pi 280 Hz * block / 48 kHz: 38 rad at
# 1024 lanes, 2.4e3 rad at 65536) in another order than one voice's sum,
# which moves that voice's f32 phase by a few ulp of it (3.8e-6 and
# 2.4e-4 rad) each block; at amplitude 0.5 the tolerance is 8 such ulp
# (1.5e-5 at 1024 lanes, measured 1.1e-6; 1e-3 at 65536, measured 2.4e-4
# on the CPU).
G2_SESSIONS = ((1024, 24, 1.6, (0.12, 0.18, 0.24, 0.3), 1.5e-5),
               (65536, 20, 8.5, (0.6, 0.9, 1.2, 1.5), 1e-3))
# Scan kernels and their voices x lanes forms.
ROWS_OF = {"prefix_sum_f32": "prefix_sum_rows_f32",
           "prefix_max_f32": "prefix_max_rows_f32",
           "affine_scan_f32": "affine_scan_rows_f32"}
# The fast mode's kernels (csrc/scan.cu), which phases 3-10 drive.
SCAN_KERNELS = tuple(ROWS_OF) + tuple(ROWS_OF.values())


def g1_voices(torch, np, device="cuda"):
    """(compiled voice, per-voice params, stacked params) of G1."""
    from tuun_tpu_torch.engine import CompiledVoice, EngineConfig
    from tuun_tpu_torch.engine.graph import params_from_numpy, stack_params
    w, _ = workload_waveform(G1_EXPR)
    voice = CompiledVoice(w, EngineConfig(SR, "fast", device))
    base = voice.params()
    params = [params_from_numpy(
        np.asarray(base.host.consts) * np.float32(1.0 + 0.001 * i),
        base.host.fixeds, i, device) for i in range(G1_VOICES)]
    return voice, params, stack_params(params)


def g1_render(torch, voice, bP, blocks: int):
    """`blocks` G1 blocks from a fresh group state; returns the last
    mix and the wall time (synchronized)."""
    fn = voice.batched_render_fn(G1_BLOCK, fast=G1_FAST)
    starts = torch.zeros(G1_VOICES, dtype=torch.int64, device="cuda")
    e = torch.full((), G1_BLOCK, dtype=torch.int64, device="cuda")
    bst = voice.batched_init(bP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(blocks):
        mix, v, bst, _ = fn(bP, bst, starts, e)
    torch.cuda.synchronize()
    return mix, v, time.perf_counter() - t0


def phase_g1(torch, np) -> dict:
    """G1: 256 voices through batched_render_fn at 2^17 lanes.  Block 0:
    each voice's row against its own render_block (within 4 f32 spacings
    of the row's scale), and the mix against the sum of the 256 voices
    rendered one by one, within 2 (B - 1) eps sum|y| (any two summation
    orders of B terms differ by at most that) plus the rows' bound.
    Then G1_BLOCKS blocks timed, best of two passes from a fresh state."""
    voice, params, bP = g1_voices(torch, np)
    rows_fn = voice.batched_render_fn(G1_BLOCK, fast=G1_FAST, mix=False)
    starts = torch.zeros(G1_VOICES, dtype=torch.int64, device="cuda")
    e = torch.full((), G1_BLOCK, dtype=torch.int64, device="cuda")
    rows, _, _, _ = rows_fn(bP, voice.batched_init(bP), starts, e)
    mix0, _, _ = g1_render(torch, voice, bP, 1)
    ref = torch.zeros(G1_BLOCK, dtype=torch.float32, device="cuda")
    mag = torch.zeros(G1_BLOCK, dtype=torch.float64, device="cuda")
    row_err = 0.0
    for i, P in enumerate(params):
        y, v, _, _ = voice.render_block(P, voice.init(P), G1_BLOCK)
        ref += y
        mag += y.double().abs()
        row_err = max(row_err, float((rows[i] - y).abs().max()))
    scale = float(rows.abs().max())
    row_tol = 4 * float(np.spacing(np.float32(scale)))
    check(row_err <= row_tol, f"G1: a voice's row differs from its own "
          f"render by {row_err:.3e} (bound {row_tol:.3e})")
    eps = float(np.finfo(np.float32).eps)
    bound = 2 * (G1_VOICES - 1) * eps * mag + G1_VOICES * row_tol
    diff = (mix0.double() - ref.double()).abs()
    check(bool(torch.isfinite(mix0).all()) and bool((diff <= bound).all()),
          f"G1: block 0's mix differs from the sum of the voices by "
          f"{float(diff.max()):.3e}")
    walls = [g1_render(torch, voice, bP, G1_BLOCKS)[2] for _ in range(2)]
    best = min(walls)
    audio = G1_BLOCKS * G1_BLOCK / SR
    row = dict(group="G1", voices=G1_VOICES, block=G1_BLOCK,
               blocks=G1_BLOCKS, walls_s=walls,
               mvoice_samples_per_s=G1_VOICES * G1_BLOCKS * G1_BLOCK / best
               / 1e6, mix_x_realtime=audio / best,
               block0_row_err=row_err, block0_mix_err=float(diff.max()),
               block0_mix_scale=float(mix0.abs().max()))
    log(f"groups {json.dumps(row)}")
    return row


def g2_notes(session):
    """[(id, instrument, expression, start sample)] of one G2 session:
    note j of instrument k at pitch j mod its pitches, length j mod 4 of
    the session's lengths, starting at j / notes of the span, offset by
    37 k + 11 j samples (so that starts fall mid-block)."""
    block, count, span, lengths, _ = session
    notes = []
    for k, (name, template, pitches) in enumerate(G2_INSTRUMENTS):
        for j in range(count):
            expr = template.format(f=pitches[j % len(pitches)],
                                   d=lengths[j % len(lengths)])
            start = int(SR * span * j / count) + 37 * k + 11 * j
            notes.append((f"{name}{j}", name, expr, start))
    return notes


class GroupCalls:
    """While active, records every VoiceGroup.render (structure, voices,
    the scan launches it made) and every voice the tracker activates."""

    def __enter__(self):
        from tuun_tpu_torch import tracker as T
        from tuun_tpu_torch.engine import kernels
        self.groups, self.voices = [], []
        self._saved = (T.VoiceGroup.render, T.Tracker._activate)
        g_render, activate = self._saved
        launches = kernels.launches

        def group_render(group, *a, **k):
            before = dict(launches)
            out = g_render(group, *a, **k)
            self.groups.append((id(group.compiled), len(group.voices),
                                {k: launches[k] - before[k]
                                 for k in launches}))
            return out

        def activate_(tracker, p, block_start):
            voice = activate(tracker, p, block_start)
            self.voices.append(voice)
            return voice
        T.VoiceGroup.render = group_render
        T.Tracker._activate = activate_
        return self

    def __exit__(self, *exc):
        from tuun_tpu_torch import tracker as T
        T.VoiceGroup.render, T.Tracker._activate = self._saved


class NoGroups:
    """While active, the tracker renders every active voice on its own
    (the per-voice loop that voice groups replace)."""

    def __enter__(self):
        from tuun_tpu_torch.tracker import Tracker
        self._saved = Tracker._rebuild_groups

        def singles(tracker):
            tracker._singles, tracker._groups = list(tracker.active), []
            tracker._groups_dirty = False
        Tracker._rebuild_groups = singles
        return self

    def __exit__(self, *exc):
        from tuun_tpu_torch.tracker import Tracker
        Tracker._rebuild_groups = self._saved


def g2_waveforms(notes):
    """The optimized IR of each distinct expression of `notes`."""
    return {expr: workload_waveform(expr)[0]
            for expr in sorted({n[2] for n in notes})}


def g2_session(torch, session, waves, fuse=False, sync_interval=1,
               precision="fast"):
    """One G2 session through Tracker.play / render_block until every
    voice has retired.  Returns (the mix, per-block host seconds, per-block
    (dispatches, voices, group sizes), the session's wall seconds).  With
    sync_interval > 1 the blocks come back on the card and are copied to
    the host once the last is rendered; the wall includes that copy."""
    import numpy as np
    from tuun_tpu_torch.tracker import Tracker
    block = session[0]
    t = Tracker(SR, block, precision=precision, device="cuda",
                sync_interval=sync_interval)
    t.fuse = fuse
    for wid, _, expr, start in g2_notes(session):
        t.play(wid, waves[expr], start=start)
    out, walls, shape = [], [], []
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    while t.active or t.pending:
        t0 = time.perf_counter()
        y, status = t.render_block()
        walls.append(time.perf_counter() - t0)
        out.append(y)
        shape.append((status.dispatches, status.voices,
                      sorted(len(g.voices) for g in t._groups)))
    mix = np.concatenate([y if isinstance(y, np.ndarray)
                          else y.cpu().numpy() for y in out])
    wall = time.perf_counter() - t_start
    t.close()
    return mix, walls, shape, wall


# Phase 8's profiles, in child processes (--profile NAME[,NAME]): G1's
# group of 256 and one G1 voice alone, and G2's live-block session cut to
# its first third (8 notes an instrument over 0.53 s; the whole session's
# 221k device events took most of the run's time to read).
GROUP_PROFILES = ("G1", "G1one", "G2")
G2_PROFILE_SESSION = (1024, 8, 0.53) + G2_SESSIONS[0][3:]
# Phase 2's count of kernels per call, in a child of its own, and the
# most children that check_launches_in_child runs.
LAUNCH_PROFILE = "launches"
LAUNCH_ATTEMPTS = 3


def group_profile(torch, name: str):
    """(meta, run) for the profile of three G1 blocks of the group (G1)
    or of one of its voices alone (G1one), or of G2's cut session at the
    live block (G2), warm."""
    import numpy as np
    if name == "G2":
        session = G2_PROFILE_SESSION
        waves = g2_waveforms(g2_notes(session))

        def run():
            mix, walls, shape, _ = g2_session(torch, session, waves)
            torch.cuda.synchronize()
            return len(walls), dict(
                audio_s=len(mix) / SR,
                dispatches_per_block=float(np.mean([x[0] for x in shape])),
                voices_per_block=float(np.mean([x[1] for x in shape])))
    else:
        voice, params, bP = g1_voices(torch, np)
        n = G1_BLOCK
        if name == "G1":
            fn = voice.batched_render_fn(n, fast=G1_FAST)
            starts = torch.zeros(G1_VOICES, dtype=torch.int64, device="cuda")
            e = torch.full((), n, dtype=torch.int64, device="cuda")
            state = voice.batched_init(bP)

            def step(st):
                return fn(bP, st, starts, e)[2]
        else:
            P = params[0]
            state = voice.init(P)

            def step(st):
                return voice.render_block(P, st, n)[2]

        def run():
            st = state
            for _ in range(3):
                st = step(st)
            torch.cuda.synchronize()
            return 3, dict(audio_s=3 * n / SR,
                           voices=G1_VOICES if name == "G1" else 1)
    run()  # warm: caches, allocator, kernel libraries
    return dict(profile=name), run


def g2_reference(torch, np, voices, block, total):
    """The sum of each voice's own render_block, placed at its start: its
    first block at the block holding its start (s = start mod block),
    then whole blocks, until its exact length or its valid end."""
    ref = np.zeros(total, np.float64)
    mag = np.zeros(total, np.float64)
    for voice in voices:
        cv, P = voice.compiled, voice.params
        st = cv.init(P)
        k, s = divmod(voice.start, block)
        while True:
            y, v, st, _ = cv.render_block(P, st, block, s, block,
                                          fast=voice.fast, lits=voice.lits)
            seg = y.double().cpu().numpy()
            ref[k * block:(k + 1) * block] += seg
            mag[k * block:(k + 1) * block] += np.abs(seg)
            k, s = k + 1, 0
            if int(v) < block or (voice.total_len is not None and k * block
                                  >= voice.start + voice.total_len):
                break
    return ref, mag


def phase_g2(torch, np, scan_ops, session) -> dict:
    """G2 at one block size: the tracker's mix against the sum of every
    voice's own render (within 2 (V - 1) eps sum|y|, the gap between any
    two summation orders, plus the session's FM tolerance, G2_SESSIONS),
    groups formed, changed and retired, and per group render each scan
    launched in its voices x lanes form exactly as often as one voice of
    that structure launches its single form, whatever the group's size.
    Then timed in turns against the per-voice loop (NoGroups)."""
    from tuun_tpu_torch.engine import kernels
    block, tol = session[0], session[4]
    waves = g2_waveforms(g2_notes(session))
    with GroupCalls() as calls:
        mix, walls, shape, _ = g2_session(torch, session, waves)
    group_calls, voices = calls.groups, calls.voices
    ref, mag = g2_reference(torch, np, voices, block, len(mix))
    eps = float(np.finfo(np.float32).eps)
    bound = 2 * (len(voices) - 1) * eps * mag + tol
    diff = np.abs(mix.astype(np.float64) - ref)
    check(np.isfinite(mix).all() and bool((diff <= bound).all()),
          f"G2 block {block}: the mix differs from the per-voice sum by "
          f"{diff.max():.3e} at sample {int(diff.argmax())}")
    # One voice's single-form launches per render, per structure.
    per_voice = {}
    for voice in voices:
        cv, P = voice.compiled, voice.params
        if id(cv) not in per_voice:
            st = cv.init(P)  # a filter's init renders (its delay line)
            before = dict(kernels.launches)
            cv.render_block(P, st, block, fast=voice.fast, lits=voice.lits)
            per_voice[id(cv)] = {k: kernels.launches[k] - before[k]
                                 for k in ROWS_OF}
    sizes = {}
    for cid, B, d in group_calls:
        want = {ROWS_OF[k]: c for k, c in per_voice[cid].items()}
        got = {k: d[k] for k in want}
        check(got == want and all(d[k] == 0 for k in ROWS_OF),
              f"G2 block {block}: a group of {B} launched {d}, one voice of "
              f"its structure {per_voice[cid]}")
        sizes.setdefault(cid, set()).add(B)
    launched = {k: sum(d[k] for _, _, d in group_calls)
                for k in ROWS_OF.values()}
    check(all(launched.values()), f"G2 block {block}: a voices x lanes "
          f"form never launched: {launched}")
    changed = sum(a[2] != b[2] for a, b in zip(shape, shape[1:]))
    check(max(len(x) for x in sizes.values()) >= 2 and changed >= 2,
          f"G2 block {block}: groups never changed size ({sizes})")
    # The groups against the per-voice loop they replace, a fresh session
    # each, in turns (groups, loop); the loop's mix is held to the same
    # bound, and it renders every voice on its own.  At the live block
    # only, one turn each: the offline block's turns and the second pair
    # were cut to keep the run's time (PERF.md).
    turns = {"groups": [], "pervoice": []}
    for grouped in (True, False) if block == 1024 else ():
        with contextlib.nullcontext() if grouped else NoGroups():
            m, w, sh, _ = g2_session(torch, session, waves)
        if not grouped:
            d = np.abs(m.astype(np.float64) - ref) if len(m) == len(ref) \
                else np.full(1, np.inf)
            check(np.isfinite(m).all() and bool((d <= bound).all()),
                  f"G2 block {block}, per-voice loop: the mix differs from "
                  f"the per-voice sum by {d.max():.3e}")
            check(not any(x[2] for x in sh),
                  f"G2 block {block}: the per-voice loop formed groups")
        turns["groups" if grouped else "pervoice"].append(dict(
            x_realtime=len(m) / SR / sum(w),
            block_ms_p50=float(np.percentile(w, 50) * 1e3),
            block_ms_p99=float(np.percentile(w, 99) * 1e3)))
    if turns["groups"]:
        log(f"groups-vs-pervoice {json.dumps(dict(block=block, **turns))}")
    audio = len(mix) / SR
    row = dict(group="G2", block=block, voices=len(voices),
               blocks=len(walls), audio_s=audio, wall_s=sum(walls),
               x_realtime=audio / sum(walls),
               block_ms_p50=float(np.percentile(walls, 50) * 1e3),
               block_ms_p99=float(np.percentile(walls, 99) * 1e3),
               max_err=float(diff.max()), peak=float(np.abs(ref).max()),
               group_renders=len(group_calls),
               dispatches_per_block=float(np.mean([x[0] for x in shape])),
               voices_per_block=float(np.mean([x[1] for x in shape])),
               max_voices=max(x[1] for x in shape),
               group_sizes_seen=[sorted(v) for v in sizes.values()],
               regroups=changed, rows_launches=launched,
               per_voice_launches=[per_voice[cid] for cid in sizes])
    log(f"groups {json.dumps(row)}")
    return row


def g2_bound(np, ref, mag, voices, tol):
    """Phase 8's bound on a session's mix against every voice's own
    render: the gap between two summation orders of the voices, plus the
    session's FM tolerance."""
    eps = float(np.finfo(np.float32).eps)
    return 2 * (len(voices) - 1) * eps * mag + tol


def check_mix(np, what, mix, ref, bound) -> float:
    """The mix against the per-voice sum within `bound`; a deferred-sync
    session may render whole silent blocks past the end (its voices
    retire at sync points), which must be zeros."""
    tail = mix[len(ref):]
    diff = np.abs(mix[:len(ref)].astype(np.float64) - ref) \
        if len(mix) >= len(ref) and not tail.any() else np.full(1, np.inf)
    check(np.isfinite(mix).all() and bool((diff <= bound).all()),
          f"{what}: the mix differs from the per-voice sum by "
          f"{diff.max():.3e} at sample {int(diff.argmax())}")
    return float(diff.max())


def session_row(np, mix, walls, shape, wall) -> dict:
    return dict(x_realtime=len(mix) / SR / wall,
                block_ms_p50=float(np.percentile(walls, 50) * 1e3),
                block_ms_p99=float(np.percentile(walls, 99) * 1e3),
                dispatches_per_block=float(np.mean([x[0] for x in shape])),
                blocks=len(walls))


# The streaming settings of phase 8: (name, fuse, sync_interval).  The
# per-call path (fuse off, a read every block), the fused step at the
# tracker's default sync_interval=1, and the live stream's
# sync_interval=4 (tuun_tpu/audio.py:161), where lookahead windows of
# K = 4 blocks and their prefetch engage.
STREAM_MODES = (("percall", False, 1), ("fused", True, 1),
                ("window", True, 4))


def stream_tol(tol: float, sync_interval: int) -> float:
    """A session's FM tolerance when windows render sync_interval blocks
    in one call: FM's f32 phase error grows with the phase a render
    advances (G2_SESSIONS), so with the render's length."""
    return tol * sync_interval


def phase_g2_stream(torch, np, session) -> dict:
    """G2 at the live block with the fused step on, at sync_interval 1
    and 4: each mix against every voice's own render within phase 8's
    bound (the FM term scaled to the window's length), and per block how
    it was served, with the capture, replay, window and prefetch
    counters."""
    block, tol = session[0], session[4]
    waves = g2_waveforms(g2_notes(session))
    rows = {}
    for name, fuse, si in STREAM_MODES[1:]:
        with TrackerRuns() as runs:
            mix, walls, shape, wall = g2_session(
                torch, session, waves, fuse=fuse, sync_interval=si)
        ref, mag = g2_reference(torch, np, runs.voices, block, len(mix))
        err = check_mix(np, f"G2 {name}", mix, ref,
                        g2_bound(np, ref, mag, runs.voices,
                                 stream_tol(tol, si)))
        paths = runs.paths()
        check_paths(f"G2 {name}", paths)
        rows[name] = dict(session_row(np, mix, walls, shape, wall),
                          sync_interval=si, max_err=err, paths=paths,
                          per_block="".join(p[0] for p, _ in runs.blocks))
    rows["memory"] = graph_memory(torch)
    log(f"G2 stream {json.dumps(dict(block=block, **rows))}")
    return rows


# G3: a stable live set, G2's three instruments started together at
# sample 0 and held for G3_SECONDS at the live block: 4 FM notes at four
# pitches (one group of 4), 2 harmonica and 2 W2g-like notes at two pitches
# each (lone voices: their Reset triggers key the structure).  It exists to
# show the fused step and windows engaged; it is a check, not a bench cell.
G3_SECONDS = 5.0
G3_BLOCK = 1024
# Its FM notes' highest frequency, 330 Hz + 30 Hz of modulation.
G3_FM_TOP_HZ = 360.0


def fm_drift_tol(np, renders: int, lanes: int, voices: int = 4) -> float:
    """What G3's FM voices may drift from their own renders: a render's
    phase advance is summed in another order by a group (or over a
    window's lanes), which moves each voice's f32 phase accumulator by up
    to 2 ulp of that advance per render, and the moves add up over the
    session (G2_SESSIONS' tolerance is 8 such ulp: its notes last at
    most 14 blocks).  At amplitude 0.5, for `voices` FM voices."""
    advance = 2 * math.pi * G3_FM_TOP_HZ * lanes / SR
    ulp = float(np.spacing(np.float32(advance)))
    return voices * 0.5 * renders * 2 * ulp


def g3_notes():
    notes = []
    for name, template, pitches in G2_INSTRUMENTS:
        for j, f in enumerate(pitches):
            notes.append((f"g3{name}{j}", template.format(f=f, d=G3_SECONDS),
                          0))
    return notes


def g3_session(torch, np, waves, fuse: bool, sync_interval: int):
    """One G3 turn, paced as a live stream is: no block is rendered
    before its audio time (block i at i * block / SR after the start).
    Returns (mix, per-block host seconds, shape, wall, runs, blocks that
    finished after their deadline)."""
    from tuun_tpu_torch.tracker import Tracker
    period = G3_BLOCK / SR
    with TrackerRuns() as runs:
        t = Tracker(SR, G3_BLOCK, precision="fast", device="cuda",
                    sync_interval=sync_interval)
        t.fuse = fuse
        for wid, expr, start in g3_notes():
            t.play(wid, waves[expr], start=start)
        out, walls, shape = [], [], []
        late = 0
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        while t.active or t.pending:
            ahead = t_start + len(walls) * period - time.perf_counter()
            if ahead > 0:
                time.sleep(ahead)
            t0 = time.perf_counter()
            y, status = t.render_block()
            t1 = time.perf_counter()
            walls.append(t1 - t0)
            late += t1 > t_start + len(walls) * period
            out.append(y)
            shape.append((status.dispatches, status.voices))
        mix = np.concatenate([y if isinstance(y, np.ndarray)
                              else y.cpu().numpy() for y in out])
        wall = time.perf_counter() - t_start
        t.close()
    return mix, walls, shape, wall, runs, late


def phase_g3(torch, np) -> dict:
    """G3 in turns, each paced at real time as a live stream: the
    per-call path, the fused step, sync_interval=4, the per-call path
    again.  Each mix against every voice's own render within phase 8's
    bound, its FM term the drift of fm_drift_tol over the session's
    renders; the fused turn's mix bit for bit the per-call path's (the
    same kernels in the same order), the windowed turn's within the
    windows' drift of it.  A fused block is one dispatch and a served
    window block none; the fused turn must replay a captured step and
    the windowed turn serve blocks from windows, or the graphs never
    engaged."""
    waves = {expr: workload_waveform(expr)[0]
             for _, expr, _ in g3_notes()}
    blocks = int(math.ceil(G3_SECONDS * SR / G3_BLOCK))
    turns = {name: [] for name, _, _ in STREAM_MODES}
    ref = base = None
    for name, fuse, si in STREAM_MODES + STREAM_MODES[:1]:
        mix, walls, shape, wall, runs, late = g3_session(torch, np, waves,
                                                         fuse, si)
        if ref is None:
            ref, mag = g2_reference(torch, np, runs.voices, G3_BLOCK,
                                    len(mix))
            base = mix
        win = fm_drift_tol(np, -(-blocks // si), si * G3_BLOCK) \
            if si > 1 else 0.0
        tol = fm_drift_tol(np, blocks, G3_BLOCK) + win
        err = check_mix(np, f"G3 {name}", mix, ref,
                        g2_bound(np, ref, mag, runs.voices, tol))
        if name == "fused":
            check(np.array_equal(mix, base),
                  "G3 fused: the mix differs from the per-call path's")
        if si > 1:
            check_mix(np, f"G3 {name} against the per-call path", mix, base,
                      win)
        paths = runs.paths()
        check_paths(f"G3 {name}", paths)
        if fuse:
            check(paths["captures_finished"] >= 1 and paths["fused"] > 0,
                  f"G3 {name}: the fused step never engaged: {paths}")
        if si > 1:
            check(paths["served"] > 0, f"G3 {name}: no window: {paths}")
        # Paced, the wall is the audio's length: its x realtime is the
        # host's, the audio over the blocks' render time.
        turns[name].append(dict(session_row(np, mix, walls, shape,
                                            sum(walls)),
                                wall_s=wall, late_blocks=late,
                                max_err=err, bound=tol, paths=paths))
    turns["memory"] = graph_memory(torch)
    log(f"G3 {json.dumps(dict(block=G3_BLOCK, seconds=G3_SECONDS, **turns))}")
    return turns


def state_leaves(torch, tracker):
    """Every voice's state leaves, in activation order, after the groups
    write theirs back."""
    from tuun_tpu_torch.engine.capture import flatten
    tracker._materialize_groups()
    return [flatten(v.state)[1] for v in tracker.active]


def phase_capture_check(torch, np) -> None:
    """The hazards of captured steps, each against the eager per-voice
    path (fuse off) on the same notes:
    (1) a captured fused step replays while a second tracker's capture
        warms up on its worker (every block's mix and, after, every
        state bit for bit);
    (2) the set is swapped for a same-key one (same structures, other FM
        pitches): the cached step is replayed, not captured again, over
        the new voices' params and states (bit for bit);
    (3) a play interrupts a window mid-way: the served blocks replay from
        the window's inputs (within the windows' bound; states within
        2e-4, integers exactly)."""
    from tuun_tpu_torch.tracker import Tracker
    notes = [(wid, expr, s) for wid, expr, s in g3_notes()]
    swap = [(wid + "b", expr.replace("sine(2*pi*(2", "sine(2*pi*(3"), s)
            for wid, expr, s in notes]
    extra = ("g3late", G2_INSTRUMENTS[1][1].format(f=392.0, d=1.0))
    waves = {expr: workload_waveform(expr)[0]
             for expr in {e for _, e, _ in notes + swap} | {extra[1]}}

    def tracker(fuse, si=1, block=G3_BLOCK):
        t = Tracker(SR, block, precision="fast", device="cuda",
                    sync_interval=si)
        t.fuse, t.fuse_blocking = fuse, True
        return t

    def play(t, ns):
        for wid, expr, start in ns:
            t.play(wid, waves[expr], start=t.now + start)

    def host(y):
        return y if isinstance(y, np.ndarray) else y.cpu().numpy()

    # (1) Replays of A's step while B's capture warms up on a worker.
    A, E = tracker(True), tracker(False)
    for t in (A, E):
        play(t, notes)
    for _ in range(4):
        check(np.array_equal(A.render_block()[0], E.render_block()[0]),
              "capture check: a fused block differs from the eager one")
    check(A.captures_finished >= 1 and A.replays >= 1,
          "capture check: A's fused step did not engage")
    # Whether a replay of A lands inside B's capture is up to the threads'
    # timing: a capture that ends before A's next block overlaps nothing
    # (seen on a fast host).  So up to three fresh Bs, until one capture
    # has a replay inside it.
    overlapped = attempts = 0
    while not overlapped and attempts < 3:
        attempts += 1
        B = tracker(True, block=BUFFER)
        B.fuse_blocking = False
        play(B, notes + [(f"{w}x", e, 0) for w, e, _ in notes])
        deadline = time.perf_counter() + 120
        while not B.captures_finished and time.perf_counter() < deadline:
            if not B.captures_started:
                B.render_block()
            elif overlapped < 50:
                replays = A.replays
                ya, yb = A.render_block()[0], E.render_block()[0]
                overlapped += A.replays > replays and not B.captures_finished
                check(np.array_equal(ya, yb), "capture check: a replay "
                      "during another capture differs from the eager block")
            else:
                time.sleep(0.01)
        B.close()  # waits for the capture
        check(B.captures_finished == 1,
              "capture check: the second tracker's capture did not finish")
    check(overlapped >= 1,
          f"capture check: {overlapped} replays overlapped {attempts} "
          f"captures")
    sa, se = state_leaves(torch, A), state_leaves(torch, E)
    check(all(torch.equal(x, y) for la, le in zip(sa, se)
              for x, y in zip(la, le)),
          "capture check: states after the replays differ")
    # (2) The same key, other voices: the cached step replays.
    started, replays = A.captures_started, A.replays
    for t in (A, E):
        t.stop_all()
        play(t, swap)
    for _ in range(6):
        check(np.array_equal(A.render_block()[0], E.render_block()[0]),
              "capture check: a swapped set's block differs")
    swapped = A.replays - replays
    check(A.captures_started == started and swapped >= 5,
          f"capture check: the swapped set captured "
          f"{A.captures_started - started} steps, replayed {swapped}")
    sa, se = state_leaves(torch, A), state_leaves(torch, E)
    check(all(torch.equal(x, y) for la, le in zip(sa, se)
              for x, y in zip(la, le)),
          "capture check: the swapped set's states differ")
    A.close()
    # (3) A play interrupts a window.
    W, E = tracker(True, 4), tracker(False)
    for t in (W, E):
        play(t, notes)
    got, want = [], []
    for _ in range(40):
        got.append(host(W.render_block()[0]))
        want.append(E.render_block()[0])
        if W._window is not None and W._window["k"] == 2:
            break
    check(W._window is not None, "capture check: no window opened")
    for t in (W, E):
        play(t, [(extra[0], extra[1], 0)])
    check(W._window is None, "capture check: the play did not interrupt")
    for _ in range(8):
        got.append(host(W.render_block()[0]))
        want.append(E.render_block()[0])
    got, want = np.concatenate(got), np.concatenate(want)
    # Phase 8's bound with every voice's |y| at most 2 (W2g's gain), so
    # sum |y| <= 2 V, and the FM term of a 4-block window.
    V = len(notes) + 1
    bound = 2 * (V - 1) * float(np.finfo(np.float32).eps) * 2 * V \
        + stream_tol(G2_SESSIONS[0][4], 4)
    diff = float(np.abs(got.astype(np.float64) - want).max())
    check(diff <= bound, f"capture check: the interrupted window differs "
          f"by {diff:.3e} (bound {bound:.3e})")
    # Mid-window, the states stand at the window's start: replay what it
    # served to bring them to the block the eager tracker is at.
    W._interrupt_window()
    sw, se = state_leaves(torch, W), state_leaves(torch, E)
    worst = 0.0
    for lw, le in zip(sw, se):
        for x, y in zip(lw, le):
            if x.is_floating_point():
                worst = max(worst, float((x.double() - y.double()).abs()
                                         .max()))
            else:
                check(torch.equal(x, y), "capture check: an integer state "
                      "differs after the interrupt")
    check(worst <= 2e-4, f"capture check: states differ by {worst:.3e}")
    W.close()
    log(f"capture check: {overlapped} replays of a captured step during "
        f"another tracker's capture ({attempts} captures tried), the same "
        f"bits and states as the "
        f"eager path; a same-key set swapped in replayed the cached step "
        f"({swapped} replays, no new capture), the same bits and "
        f"states; a play interrupting a window at block 2 of 4: mix "
        f"within {diff:.3e}, float states within {worst:.3e}")


def phase_cross_device(torch, np, tmp: Path):
    """W1's first 2 s rendered through the CLI on the CPU (plain scans,
    CPU sin) against the card's render from phase 3.  The two differ in
    sin's last bit (at 18% of the NCO grid angles on an H100) and in the
    scans' summation order; the filter's feedback carries each such
    difference into every later sample (on an H100, 700 W: 97% of the
    samples differ, by at most 1.3e-6).  A reset edge moved by either
    would show as a sample off by > 5% of peak.  Bound: no such sample,
    and max |diff| <= 1e-4 of peak."""
    from tuun_tpu_torch import cli
    from tuun_tpu_torch.wav import read_wav
    out = tmp / "W1_cpu.wav"
    t0 = time.perf_counter()
    rc = cli.main(["--expr", W1_EXPR, "--sample_rate", str(SR),
                   "--buffer_size", str(BUFFER), "--precompute", "false",
                   "--device", "cpu", "--duration", str(PREFIX_SECONDS),
                   "--render-out", str(out), "-O", str(tmp), "--quiet"])
    wall = time.perf_counter() - t0
    check(rc == 0, f"W1 on the CPU: the CLI exited {rc}")
    m = int(PREFIX_SECONDS * SR)
    cpu, _ = read_wav(out)
    card, _ = read_wav(tmp / "W1.wav")
    check(len(cpu) >= m, f"W1 on the CPU: only {len(cpu)} samples")
    stats = fast_mode_errors(card[:m], cpu[:m].astype(np.float64))
    differ = float(np.mean(card[:m] != cpu[:m]))
    check(stats["frac_large"] == 0.0
          and stats["max_abs"] <= 1e-4 * stats["peak"],
          f"W1 card vs CPU: {stats}")
    log(f"W1 card vs CPU, first {PREFIX_SECONDS:.0f} s: {differ:.2%} of "
        f"samples differ, max |diff| {stats['max_abs']:.3e} (peak "
        f"{stats['peak']:.3g}), off>5%peak {stats['frac_large']:.2e}; "
        f"CPU render {wall:.2f} s")


def phase_engine(torch, np):
    """filter_4_3 (bench.py:80-83) through CompiledVoice.render_block in
    8 blocks of 2^20 lanes on the card."""
    from tuun_tpu_torch import ir, native
    from tuun_tpu_torch.engine import CompiledVoice, EngineConfig
    C = ir.Const
    w = ir.Filter(ir.Time(),
                  (C(0.00107949), C(0.00323847), C(0.00323847),
                   C(0.00107949)),
                  (C(-2.5610316), C(2.2132402), C(-0.6435727)))
    n = 1 << 20
    voice = CompiledVoice(w, EngineConfig(SR, "fast", device="cuda"))
    P = voice.params()
    st = voice.init(P)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = None
    for b in range(8):
        y, v, st, _ = voice.render_block(P, st, n)
        if b == 0:
            first = y
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(int(v) == n, f"filter_4_3: valid end {int(v)} != {n}")
    got = first.cpu().numpy()
    ref = native.render(w, n, SR)
    err = float(np.abs(got.astype(np.float64) - ref).max())
    scale = max(1.0, float(np.abs(ref).max()))
    # The affine scan's J=3 tolerance of phase 2.
    check(np.isfinite(got).all() and err <= AFFINE_TOL[3] * scale,
          f"filter_4_3: first block error {err:.3e} (scale {scale:.3g})")
    seconds = 8 * n / SR
    log(f"W4 filter_4_3 engine: 8 x 2^20 lanes ({seconds:.1f} s audio) in "
        f"{wall:.3f} s wall = {seconds / wall:.1f}x realtime; first block "
        f"vs oracle max_abs {err:.3e} (scale {scale:.3g})")
    return ("W4", seconds / wall)


# -- phase 9: live edits through the port's sessions and web server --------
#
# The live-edit path (Tracker.modify and carry_state, Player.stop,
# TuunSession, tools/web_demo.py) at the web server's defaults: 44.1 kHz,
# 1024-sample blocks, fast precision, unpaced.
LIVE_SR = 44100
LIVE_BLOCK = 1024
LIVE_INTERVALS = (1, 32)  # the default, and docs/serving.md's production
STOP_SAMPLES = 2205  # the Player's 50 ms stop ramp at 44.1 kHz
S1_BLOCKS = 431  # 10 s
S1_MOVE_EVERY = 8
S1_NORMS = (0.9, 0.2, 0.65, 0.35, 1.0, 0.05, 0.5)
# The filter's moves, cutoff and Q in turn, keep it within 630 Hz-5 kHz
# and Q 0.38-0.83: a sharper resonance is where f32 scans lose digits
# (measured apart: S1_STIFF_BLOCKS).
S1_FILTER_NORMS = (0.8, 0.2, 0.45, 0.3, 0.65, 0.1, 0.5, 0.25, 0.9, 0.35,
                   0.55, 0.15)
S1_GAIN0 = 0.4
_SCALE = [220 * 2 ** (i / 12) for i in (0, 2, 4, 5, 7, 9, 11, 12)]
# A score of 20 quarter notes (10 s at the session's tempo, 120) with a
# live detune: a timeline, so that its one move, late in the piece,
# rebuilds the voice's node tree by replaying it from sample 0 (state_at).
S1_SCORE = "<[" + ", ".join(
    f"$({f:.3f} * pow(2, detune/12)) * Qw * 0.3"
    for f in (_SCALE * 3)[:20]) + "]>"
# examples/slider-demos.tuun's slider programs (no file is read at run
# time), and the score: (name, expression, sliders, labels moved in turn,
# the normalized values they move to in turn, blocks, blocks at which a
# slider moves).  The score's run ends before its last note does, so that
# the stop finds it playing.
S1_PROGRAMS = (
    ("vibrato", "sine(2*pi * 330, depth * sine(2*pi * $rate, 0))",
     '["rate:5:0.5:12", "depth:0.3:0:1"]', ("rate", "depth"), S1_NORMS,
     S1_BLOCKS, tuple(range(S1_MOVE_EVERY, S1_BLOCKS, S1_MOVE_EVERY))),
    ("filter", "sawtooth(110) | lpf(Q, cutoff)",
     '["cutoff:0.5:fn(x) => 80 * pow(100, x)", "Q:0.707:0.2:2"]',
     ("cutoff", "Q"), S1_FILTER_NORMS, S1_BLOCKS,
     tuple(range(S1_MOVE_EVERY, S1_BLOCKS, S1_MOVE_EVERY))),
    ("gain", "$330 * gain", f'["gain:{S1_GAIN0}:0:1"]', ("gain",),
     S1_NORMS, S1_BLOCKS,
     tuple(range(S1_MOVE_EVERY, S1_BLOCKS, S1_MOVE_EVERY))),
    ("score", S1_SCORE, '["detune:0:0:12"]', ("detune",), S1_NORMS, 400,
     (392,)),
)
# The CPU runs the first this many blocks of each S1 program (11 moves)
# and then stops it, to hold the card's run of the same script to.
S1_CPU_BLOCKS = 96
# Logged, not held: the filter program with S1_NORMS' wide moves (down to
# 100 Hz at Q 2, poles at 0.9964) for this many blocks, on the card at
# each of LIVE_INTERVALS and on the CPU, each against the CPU's plain
# scan run in float64.
S1_STIFF_BLOCKS = 120
# S2's keys instruments: (name, expression, opens, [(block, "on"|"off",
# key)]).
# pm_piano_keys: an 8-note chord held 2 s (one group), staggered note-offs
# (each splices Rw(0.2, 1.0) under Terminator: the voice leaves the
# group), a second chord released at once.  Its notes phase-modulate NCO
# carriers and reach no scan; G2's FM voice and its W2g-like voice as
# keys instruments (4 notes each, started 8 blocks apart: alone, then
# grouped) reach the prefix sum, the prefix max and the affine scan, in
# single and voices x lanes forms.
_CHORD1 = (60, 64, 67, 71, 72, 76, 79, 83)
_CHORD2 = (57, 60, 64, 69, 72, 76, 81, 84)
_QUAD = (45, 52, 57, 61)
S2_INSTRUMENTS = (
    ("pm_piano", "pm_piano_keys", ("std", "pm_synth"),
     [(0, "on", k) for k in _CHORD1]
     + [(86 + 4 * i, "off", k) for i, k in enumerate(_CHORD1)]
     + [(130, "on", k) for k in _CHORD2]
     + [(173, "off", k) for k in _CHORD2]),
    ("fm_keys", "fn(k, v) => (sine(2*pi*(@k + 30*$(5)), 0) * 0.5 * v, "
     "Rw(0.2, 1.0))", ("std",),
     [(8 * i, "on", k) for i, k in enumerate(_QUAD)]
     + [(60 + 4 * i, "off", k) for i, k in enumerate(_QUAD)]),
    ("w2g_keys", "fn(k, v) => (reset(triangle(110), time * -(@k)) * 2 * v "
     "| lpf(0.7, 2000), Rw(0.2, 1.0))", ("std",),
     [(8 * i, "on", k) for i, k in enumerate(_QUAD)]
     + [(60 + 4 * i, "off", k) for i, k in enumerate(_QUAD)]),
)
# Blocks after a burst of commands by which a stable set renders in one
# dispatch again: the set is new at the burst's block, and the fused step
# serves from fuse_after (2) blocks on.
S2_SETTLE = 3
MODIFY_PHASES = ("interrupt", "materialize", "splice", "state_at", "carry",
                 "marks")


def live_session(device, sync_interval: int):
    from tuun_tpu_torch.session import TuunSession
    return TuunSession(sample_rate=LIVE_SR, block_size=LIVE_BLOCK,
                       precision="fast", device=device,
                       sync_interval=sync_interval)


def _timed_block(s, blocks, walls) -> bool:
    """One process(): its block and host seconds; False once it returns
    None (every voice retired)."""
    t0 = time.perf_counter()
    y = s.process()
    if y is None:
        return False
    walls.append(time.perf_counter() - t0)
    blocks.append(y)
    return True


def _modifies(s) -> list:
    """The session's modify records since the last call (op_log is a ring
    of 256: read it after each program)."""
    ops = [op for op in s.tracker.op_log if op[0] == "modify"]
    s.tracker.op_log.clear()
    return ops


def s1_run(device, sync_interval: int, programs=S1_PROGRAMS) -> dict:
    """S1: each program of S1_PROGRAMS installed in turn on one session,
    its sliders moved in turn to its values at its move blocks, then
    Player.stop and blocks until process() returns None.  Per program:
    the mix, the block at which the stop came, the blocks after it, the
    moves (block, label, value), the host seconds of every block and the
    modify records."""
    from tuun_tpu_torch.ids import WaveformId
    s = live_session(device, sync_interval)
    out = {}
    for name, expr, sliders, labels, norms, blocks_n, moves_at in programs:
        s.install(expr, sliders=sliders)
        blocks, walls, moves = [], [], []
        for k in range(blocks_n):
            if k in moves_at:
                j = len(moves)
                label = labels[j % len(labels)]
                s.update_slider_normalized(label, norms[j % len(norms)])
                moves.append((k, label, s._last_slider_values[label]))
            check(_timed_block(s, blocks, walls),
                  f"S1 {name}: the stream ended at block {k}")
        s.player.stop(WaveformId.program(0))
        while _timed_block(s, blocks, walls):
            pass
        check(not s.tracker.active and not s.tracker.pending,
              f"S1 {name}: voices left after the stream ended")
        out[name] = dict(mix=np.concatenate(blocks), stop=blocks_n,
                         tail=len(blocks) - blocks_n, moves=moves,
                         walls=walls, modifies=_modifies(s))
    s.tracker.close()
    return out


def s2_run(device, sync_interval: int, runs=None) -> dict:
    """S2: each keys instrument of S2_INSTRUMENTS installed in turn, its
    notes played and released at their blocks, then blocks until
    process() returns None.  The fused step is captured inline
    (fuse_blocking), so that it engages at the same blocks on every run.
    Per instrument: the mix, the host seconds and (with `runs`, a
    TrackerRuns) the path and dispatches of every block, and the modify
    records."""
    s = live_session(device, sync_interval)
    s.tracker.fuse_blocking = True
    out = {}
    for name, expr, opens, script in S2_INSTRUMENTS:
        check(s.install(expr, opens=opens) == "keys",
              f"S2 {name}: not a keys instrument")
        blocks, walls, paths = [], [], []
        last = max(b for b, _, _ in script)
        k = 0
        while True:
            for when, what, key in script:
                if when == k:
                    if what == "on":
                        s.note_on(key, 100)
                    else:
                        s.note_off(key)
            if _timed_block(s, blocks, walls):
                if runs is not None:
                    paths.append(runs.blocks[-1])
            elif k > last:
                break
            else:  # no voice until the next note: silence, as the server
                blocks.append(np.zeros(LIVE_BLOCK, np.float32))
                paths.append(("idle", 0))
            k += 1
        check(not s.tracker.active and not s.tracker.pending,
              f"S2 {name}: voices left after the stream ended")
        out[name] = dict(mix=np.concatenate(blocks), walls=walls,
                         modifies=_modifies(s), paths=paths)
    s.tracker.close()
    return out


def _gain_envelope(run) -> np.ndarray:
    """The gain program's expected envelope before the stop: S1_GAIN0,
    then a one-block linear ramp from each value to the next at each
    move's block."""
    env = np.full(run["stop"] * LIVE_BLOCK, S1_GAIN0, np.float64)
    ramp = np.arange(LIVE_BLOCK) / LIVE_BLOCK
    prev = S1_GAIN0
    for k, _, value in run["moves"]:
        a = k * LIVE_BLOCK
        env[a:a + LIVE_BLOCK] = prev + (value - prev) * ramp
        env[a + LIVE_BLOCK:] = value
        prev = value
    return env


def check_s1(run, si: int) -> dict:
    """S1's own checks on one run; returns their numbers."""
    worst = {}
    for name, r in run.items():
        mix, stop = r["mix"], r["stop"] * LIVE_BLOCK
        check(np.isfinite(mix).all(), f"S1 {name}: not finite")
        # The stop: the 50 ms ramp, then exact zeros; the voice retires
        # by its valid end, which the tracker reads at one sync and
        # applies at the next (tuun_tpu's rule): within 2 sync_interval
        # blocks of the ramp's end.
        check(not mix[stop + STOP_SAMPLES:].any(),
              f"S1 {name}: non-zero samples after the stop ramp")
        ramp_blocks = -(-STOP_SAMPLES // LIVE_BLOCK)
        check(ramp_blocks <= r["tail"] <= ramp_blocks + 2 * si + 1,
              f"S1 {name}: retired {r['tail']} blocks after the stop "
              f"(sync_interval {si})")
        if name != "gain":
            continue
        n = np.arange(len(mix), dtype=np.float64)
        sin = np.sin(2 * math.pi * 330 * n / LIVE_SR)
        env = _gain_envelope(r)
        err = np.abs(mix[:stop] - env * sin[:stop])
        check(err.max() <= TOL_FM_MAX_ABS, f"S1 gain: {err.max():.3e} off "
              f"gain x sin(2 pi 330 t) (bound {TOL_FM_MAX_ABS})")
        # Each ramp block: the gain seen where |sin| > 0.5 moves one way.
        steps = 0.0
        for k, _, value in r["moves"]:
            a = k * LIVE_BLOCK
            lanes = np.abs(sin[a:a + LIVE_BLOCK]) > 0.5
            seen = mix[a:a + LIVE_BLOCK][lanes] / sin[a:a + LIVE_BLOCK][lanes]
            d = np.diff(seen) * np.sign(value - env[a - 1])
            steps = min(steps, float(d.min()))
        check(steps >= -4 * TOL_FM_MAX_ABS,
              f"S1 gain: a ramp block turns back by {-steps:.3e}")
        # The stop ramp: under the last gain's linearly falling envelope.
        fall = r["moves"][-1][2] * (1 - np.arange(STOP_SAMPLES)
                                    / STOP_SAMPLES)
        over = np.abs(mix[stop:stop + STOP_SAMPLES]) - fall
        check(over.max() <= TOL_FM_MAX_ABS,
              f"S1 gain: the stop ramp exceeds its envelope by "
              f"{over.max():.3e}")
        worst = dict(gain_max_err=float(err.max()), ramp_turn=-steps)
    return worst


def compare_runs(what, a, b, bound_of) -> dict:
    """Each program's mix of run `a` against run `b`: equal within
    bound_of(name) over their common length, zeros past it."""
    errs = {}
    for name in a:
        x, y = a[name]["mix"], b[name]["mix"]
        n = min(len(x), len(y))
        d = np.abs(x[:n].astype(np.float64) - y[:n])
        check(not x[n:].any() and not y[n:].any(),
              f"{what} {name}: the longer run has sound past the other")
        check(d.max() <= bound_of(name, y[:n]),
              f"{what} {name}: differs by {d.max():.3e} at sample "
              f"{int(d.argmax())}")
        errs[name] = float(d.max())
    return errs


def card_vs_cpu(a, b, prefix: bool = False) -> dict:
    """Phase 4's envelope: no sample off by > 5% of peak, max |diff| <=
    1e-4 of peak; the whole mixes, or (prefix) the CPU run's samples
    before its stop, the card's run of the same script cut shorter."""
    out = {}
    for name in a:
        x, y = a[name]["mix"], b[name]["mix"]
        if prefix:
            n = b[name]["stop"] * LIVE_BLOCK
            x, y = x[:n], y[:n]
        check(len(x) == len(y), f"card vs CPU {name}: {len(x)} samples "
              f"on the card, {len(y)} on the CPU")
        stats = fast_mode_errors(x, y.astype(np.float64))
        check(stats["frac_large"] == 0.0
              and stats["max_abs"] <= 1e-4 * stats["peak"],
              f"card vs CPU {name}: {stats}")
        out[name] = stats["max_abs"]
    return out


def interrupt_bound(voices: int, si: int) -> float:
    """Phase 8's bound for a window interrupted by a command, with
    `voices` voices of |y| <= 2: two summation orders, plus G2's FM term
    scaled to the window."""
    eps = float(np.finfo(np.float32).eps)
    return 2 * (voices - 1) * eps * 2 * voices \
        + stream_tol(G2_SESSIONS[0][4], si)


def modify_stats(ops) -> dict:
    """p50/p99 of each modify's milliseconds and of each of its phases."""
    def pct(xs):
        xs = np.asarray(xs) * 1e3
        return dict(p50=float(np.percentile(xs, 50)),
                    p99=float(np.percentile(xs, 99)), max=float(xs.max()))
    out = dict(n=len(ops), total_ms=pct([op[2] for op in ops]))
    for ph in MODIFY_PHASES:
        xs = [op[3][ph] for op in ops if ph in op[3]]
        if xs:
            out[ph + "_ms"] = dict(pct(xs), n=len(xs))
    return out


def live_row(runs, run, audio_s) -> dict:
    """One session's numbers: x realtime over the blocks' host time, p50
    and p99 block ms, blocks by path, dispatches a block, captures and
    their seconds, and the modifies' p50/p99 with their phases."""
    walls = [w for r in run.values() for w in r["walls"]]
    return dict(x_realtime=audio_s / sum(walls),
                block_ms_p50=float(np.percentile(walls, 50) * 1e3),
                block_ms_p99=float(np.percentile(walls, 99) * 1e3),
                blocks=len(walls),
                program_block_ms_p50={
                    name: float(np.percentile(r["walls"], 50) * 1e3)
                    for name, r in run.items()},
                dispatches_per_block=float(np.mean(
                    [d for _, d in runs.blocks])),
                paths=runs.paths(),
                modify=modify_stats([op for r in run.values()
                                     for op in r["modifies"]]))


def s3_server(torch) -> dict:
    """S3: the port's web server on 127.0.0.1:0 on the card, at its
    defaults, through http.client: the calls tests/test_web_demo.py
    makes."""
    import http.client
    import threading
    from tuun_tpu_torch.tools.web_demo import TuunWebServer
    srv = TuunWebServer(("127.0.0.1", 0), device="cuda")
    check(srv.sample_rate == LIVE_SR and srv.block_size == LIVE_BLOCK,
          "S3: the server's defaults moved")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def conn():
        return http.client.HTTPConnection("127.0.0.1", srv.server_port,
                                          timeout=60)

    def post(path, body):
        c = conn()
        c.request("POST", path, json.dumps(body),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        out = json.loads(r.read())
        c.close()
        return r.status, out

    def stream(iid, n=None):
        """Reads the stream to its end (or n samples)."""
        c = conn()
        c.request("GET", f"/api/stream?id={iid}")
        r = c.getresponse()
        data = b""
        while n is None or len(data) < 4 * n:
            chunk = r.read(4 * LIVE_BLOCK)
            if not chunk:
                break
            data += chunk
        c.close()
        got = np.frombuffer(data, dtype="<f4")
        return got if n is None else got[:n]

    t0 = time.perf_counter()
    try:
        # A waveform streamed to its end, bit for bit a direct session.
        expr = "$440 | fin(time - 0.5)"
        status, out = post("/api/install", {"id": "s3a", "expression": expr})
        check(status == 200 and out["kind"] == "waveform",
              f"S3 install: {status} {out}")
        got = stream("s3a")
        s = live_session("cuda", 1)
        s.install(expr)
        direct = []
        while (y := s.process()) is not None:
            direct.append(y)
        direct = np.concatenate(direct)
        s.tracker.close()
        check(len(got) == len(direct) and np.array_equal(got, direct),
              f"S3: the stream ({len(got)} samples) is not the direct "
              f"session's ({len(direct)})")
        # A slider install and one move: a monotone one-block ramp.
        status, out = post("/api/install", {
            "id": "s3b", "expression": "gain | fin(time - 10)",
            "sliders": '["gain:0.25:0:1"]'})
        check(status == 200 and out["sliders"][0]["value"] == 0.25,
              f"S3 slider install: {status} {out}")
        c = conn()
        c.request("GET", "/api/stream?id=s3b")
        r = c.getresponse()
        first = np.frombuffer(r.read(4 * LIVE_BLOCK), dtype="<f4")
        status, out = post("/api/slider", {"id": "s3b", "label": "gain",
                                           "normalized": 1.0})
        check(status == 200 and out["value"] == 1.0, f"S3 slider: {out}")
        chunks = [first]
        for _ in range(200):
            chunk = np.frombuffer(r.read(4 * LIVE_BLOCK), dtype="<f4")
            chunks.append(chunk)
            if len(chunk) and abs(chunk[-1] - 1.0) <= 1e-6:
                break
        c.close()
        ramp = np.concatenate(chunks)
        check(abs(first - 0.25).max() <= 1e-6 and abs(ramp[-1] - 1.0) <= 1e-6
              and np.diff(ramp).min() >= -1e-6 and ramp.max() <= 1 + 1e-6,
              "S3: the slider's ramp is not a monotone 0.25 -> 1 ramp")
        # Keys: note_on streams the note, note_off is accepted.
        status, out = post("/api/install", {
            "id": "s3c", "expression": "fn(k, v) => ($(110 * v) | "
            "fin(time - 5), 0 | fin(time - 0))"})
        check(status == 200 and out["kind"] == "keys", f"S3 keys: {out}")
        status, _ = post("/api/note_on", {"id": "s3c", "key": 60,
                                          "velocity": 127})
        got = stream("s3c", LIVE_BLOCK)
        want = np.sin(2 * math.pi * 110 * np.arange(LIVE_BLOCK) / LIVE_SR)
        check(status == 200 and abs(got - want).max() <= TOL_FM_MAX_ABS,
              "S3: the keys note is not $(110)")
        status, _ = post("/api/note_off", {"id": "s3c", "key": 60})
        check(status == 200, "S3: note_off failed")
        # stop ends a live stream.
        post("/api/install", {"id": "s3d", "expression": "$220"})
        read = []
        reader = threading.Thread(target=lambda: read.append(stream("s3d")),
                                  daemon=True)
        reader.start()
        time.sleep(0.5)
        status, out = post("/api/stop", {"id": "s3d"})
        reader.join(timeout=30)
        check(status == 200 and not reader.is_alive() and read
              and len(read[0]) > 0, "S3: stop did not end the live stream")
        # An unknown id: 404, and no session made.
        before = set(srv.instances)
        status, _ = post("/api/slider", {"id": "ghost", "label": "x",
                                         "normalized": 0.5})
        check(status == 404 and set(srv.instances) == before,
              "S3: an unknown id did not 404")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    return dict(seconds=time.perf_counter() - t0,
                stopped_stream_samples=len(read[0]))


def stiff_filter(scan_ops) -> dict:
    """S1_STIFF_BLOCKS' runs: max |diff| / peak of each against the CPU's
    plain scan in float64 (logged)."""
    prog = [("filter", S1_PROGRAMS[1][1], S1_PROGRAMS[1][2],
             S1_PROGRAMS[1][3], S1_NORMS, S1_STIFF_BLOCKS,
             tuple(range(S1_MOVE_EVERY, S1_STIFF_BLOCKS, S1_MOVE_EVERY)))]
    runs = {f"card si={si}": s1_run("cuda", si, prog)
            for si in LIVE_INTERVALS}
    runs["cpu"] = s1_run("cpu", 1, prog)
    plain = scan_ops.affine_scan_ref

    def f64(a, ff, live, h0):
        hs, h = plain(a.double(), ff.double(), live, h0.double())
        return hs.float(), h.float()
    scan_ops.affine_scan_ref = f64
    try:
        ref = s1_run("cpu", 1, prog)["filter"]["mix"].astype(np.float64)
    finally:
        scan_ops.affine_scan_ref = plain
    peak = float(np.abs(ref).max())
    out = {}
    for name, r in runs.items():
        mix = r["filter"]["mix"]
        n = min(len(mix), len(ref))
        check(np.isfinite(mix).all(), f"stiff filter {name}: not finite")
        out[name] = float(np.abs(mix[:n] - ref[:n]).max()) / peak
    log(f"stiff filter (S1's filter program down to 100 Hz at Q 2): max "
        f"|diff| / peak against a float64 scan {out} (the per-thread "
        f"register-map affine scan erred 7.5e-3 on the card)")
    return dict(peak=peak, rel_err_vs_f64=out)


def phase_session(torch, scan_ops) -> dict:
    """Phase 9: S1 and S2 on the card at each of LIVE_INTERVALS and on
    the CPU at sync_interval 1, S3 on the card.  Returns each scan's
    launches in the phase's card runs."""
    from tuun_tpu_torch.engine import kernels
    kernels.reset_launches()
    rows = {}
    s1, s2 = {}, {}
    for si in LIVE_INTERVALS:
        with TrackerRuns() as runs:
            s1[si] = s1_run("cuda", si)
        rows[f"S1 si={si}"] = dict(check_s1(s1[si], si), **live_row(
            runs, s1[si], sum(len(r["mix"]) for r in s1[si].values())
            / LIVE_SR))
        with TrackerRuns() as runs:
            s2[si] = s2_run("cuda", si, runs)
        rows[f"S2 si={si}"] = live_row(
            runs, s2[si], sum(len(r["mix"]) for r in s2[si].values())
            / LIVE_SR)
    launched = dict(kernels.launches)
    # One dispatch a block again once each burst of commands has passed
    # (the fused step, or the one group a chord forms), and the fused
    # step served while released notes left their groups.
    for name, _, _, script in S2_INSTRUMENTS:
        paths = s2[1][name]["paths"]
        for k in sorted({b + S2_SETTLE for b, _, _ in script}):
            check(paths[k][1] == 1, f"S2 {name}: {paths[k][1]} dispatches "
                  f"at block {k}, {S2_SETTLE} blocks after a burst")
    check(any(p == "fused" for r in s2[1].values() for p, _ in r["paths"]),
          "S2: the fused step never served")
    # sync_interval 32, its windows interrupted by every command, against
    # sync_interval 1.
    last = LIVE_INTERVALS[-1]
    rows["S1 windows vs si=1"] = compare_runs(
        "S1 windows", s1[last], s1[1],
        lambda name, y: interrupt_bound(1, last))
    rows["S2 windows vs si=1"] = compare_runs(
        "S2 windows", s2[last], s2[1],
        lambda name, y: interrupt_bound(len(_CHORD1), last))
    # The card against the port's own CPU run of the same scripts.
    t0 = time.perf_counter()
    cpu1 = s1_run("cpu", 1, tuple(
        p[:5] + (S1_CPU_BLOCKS, tuple(k for k in p[6] if k < S1_CPU_BLOCKS))
        for p in S1_PROGRAMS))
    cpu2 = s2_run("cpu", 1)
    check_s1(cpu1, 1)
    rows["card vs CPU"] = dict(S1=card_vs_cpu(s1[1], cpu1, prefix=True),
                               S2=card_vs_cpu(s2[1], cpu2),
                               cpu_seconds=time.perf_counter() - t0)
    rows["stiff filter"] = stiff_filter(scan_ops)
    kernels.reset_launches()
    rows["S3"] = s3_server(torch)
    for k, c in kernels.launches.items():
        launched[k] += c
    score = [op for op in s1[1]["score"]["modifies"] if "state_at" in op[3]]
    check(score, "S1 score: the detune move did not replay state_at")
    rows["state_at"] = dict(
        voice_seconds=S1_PROGRAMS[-1][6][0] * LIVE_BLOCK / LIVE_SR,
        ms={si: [op[3]["state_at"] * 1e3 for op in s1[si]["score"]
                 ["modifies"] if "state_at" in op[3]]
            for si in LIVE_INTERVALS})
    for name, row in rows.items():
        log(f"session {name} {json.dumps(row)}")
    log(f"launch counts of phase 9 (the card's sessions): {launched}")
    for k in SCAN_KERNELS:
        check(launched[k] > 0, f"phase 9: kernel {k} was never launched")
    return launched


# -- phase 10: the live-coding REPL ----------------------------------------

REPL_SR = 44100
REPL_BLOCK = 1024
SONG = Path(__file__).resolve().parent / "examples" / "song.tuun"
# G2's FM voice and its W2g-like voice as keys instruments (phase 9's S2).
FM_KEYS = ("fn(k, v) => (sine(2*pi*(@k + 30*$(5)), 0) * 0.5 * v, "
           "Rw(0.2, 1.0))")
W2G_KEYS = ("fn(k, v) => (reset(triangle(110), time * -(@k)) * 2 * v "
            "| lpf(0.7, 2000), Rw(0.2, 1.0))")
# R1: examples/song.tuun through the REPL's commands, ~20 s of audio.  A1
# at the next measure, A2-A4 at once; A2's cutoff moves within phase 9's
# non-stiff range (630 Hz-5 kHz); A5's pm_piano_keys chord and its
# note-offs; a W2g-like keys program added in a new slot (A6) in edit
# mode and an FM keys program over A4 through `edit`, each played alone,
# then as a chord (the scans' rows forms and the prefix max, which
# pm_piano_keys never reaches); A2 edited with `key` chords; midi
# gestures (A2's cutoff on a knob, a pad); undo/redo; a render to a WAV;
# view; stop; save; status; quit.  The CPU runs the commands before
# R1_CPU_LINES (the first 6.5 s: A1-A4, the cutoff moves, the piano
# chord) to hold the card's renders to.
R1_SCRIPT = (
    "play A1 measure", "play A2", "play A3", "play A4", "render 2",
    "slider A2 cutoff 900", "render 1", "slider A2 cutoff 3000", "render 1",
    "keys A5", "on 60 100", "on 64 90", "on 67 80", "render 1", "off 64",
    "render 0.5", "off 60", "off 67", "render 1",
    "select A5", "key down enter", f"type {W2G_KEYS}", "key escape",
    "keys A6", "on 45 100", "render 0.5", "on 52 100", "render 0.5",
    "on 57 100", "on 61 100", "render 1", "off 45", "off 52", "off 57",
    "off 61", "render 1",
    f"edit A4 {FM_KEYS}", "keys A4", "on 45 100", "render 0.5",
    "on 52 100", "render 0.5", "on 57 100", "on 61 100", "render 1",
    "off 45", "off 52", "off 57", "off 61", "render 1",
    "edit A2", "key C-e backspace", "type 4", "key escape", "play A2",
    "render 1",
    "midi connect", "select A2", "midi encoder 0 20", "midi pad top 0",
    "render 1", "undo A2", "redo A2", "slider A2 cutoff 4500", "render 1",
    "render 3 OUT", "view 1 10", "stop", "render 0.5", "save", "status",
)
R1_CPU_LINES = 19


def r1_run(device, lines, workdir: Path) -> dict:
    """R1's commands on a Repl(sample_rate=44100, tempo=90,
    buffer_size=1024) on `device`, in `workdir` (captures land there; the
    edits save its copy of song.tuun).  Returns the log, every render's
    mix, the WAV's path and each command's seconds."""
    import io
    from tuun_tpu_torch.repl import Repl
    workdir.mkdir(parents=True, exist_ok=True)
    song = workdir / "song.tuun"
    song.write_text(SONG.read_text())
    wav = workdir / "out.wav"
    out = io.StringIO()
    walls = []
    with contextlib.chdir(workdir):
        r = Repl(sample_rate=REPL_SR, tempo=90, buffer_size=REPL_BLOCK,
                 out=out, device=device)
        r.dispatch(f"load {song}")
        for line in lines:
            t0 = time.perf_counter()
            r.dispatch(line.replace("OUT", str(wav)))
            walls.append((line[:24], time.perf_counter() - t0))
        rendered = list(r.rendered)
        r.dispatch("quit")
    return dict(log=out.getvalue(), rendered=rendered, wav=wav,
                walls=walls)


def r1_renders(lines) -> list:
    return [line for line in lines if line.startswith(("render", "view"))]


def check_r1(run, lines) -> dict:
    """R1's checks: no error in the log, every render's mix numpy and
    finite, sound in every render before `stop`, exact zeros after the
    stop ramp, the WAV the rendered mix."""
    log_text = run["log"]
    check("error:" not in log_text and "usage error" not in log_text
          and "unknown command" not in log_text,
          f"R1: the log reports an error:\n{log_text[-3000:]}")
    renders = r1_renders(lines)
    mixes = run["rendered"]
    check(len(mixes) == len(renders),
          f"R1: {len(mixes)} mixes for {len(renders)} renders")
    for line, mix in zip(renders, mixes):
        check(isinstance(mix, np.ndarray) and mix.dtype == np.float32,
              f"R1 {line}: the mix is {type(mix)}")
        check(np.isfinite(mix).all(), f"R1 {line}: not finite")
    playing = len(r1_renders(lines[:lines.index("stop")])) \
        if "stop" in lines else len(renders)
    for line, mix in zip(renders[:playing], mixes[:playing]):
        check(float(np.abs(mix).max()) > 0.01,
              f"R1 {line}: silent while programs play")
    if playing < len(renders):
        stopped = mixes[playing]
        check(not stopped[3 * REPL_BLOCK:].any(),
              "R1: sound after the stop ramp")
    if "render 3 OUT" in lines:
        from tuun_tpu_torch.wav import read_wav
        wav, sr = read_wav(run["wav"])
        mix = mixes[renders.index("render 3 OUT")]
        check(sr == REPL_SR and len(wav) == len(mix)
              and np.array_equal(wav, mix),
              f"R1: the WAV holds {len(wav)} samples, the render "
              f"{len(mix)}")
    return dict(samples=sum(len(m) for m in mixes),
                peak=float(max(np.abs(m).max() for m in mixes)))


def r2_live() -> dict:
    """R2 (in a child process: `--live`): a Repl on the card, the
    background prewarm, `audio start FIFO` with a reader thread draining
    it, then ~15 s of plays, slider moves every 0.5 s and a keys chord,
    each through pump.call, then `audio status` and `audio stop`."""
    import io
    import threading
    from tuun_tpu_torch import prewarm
    from tuun_tpu_torch.engine import kernels
    from tuun_tpu_torch.repl import Repl
    kernels.reset_launches()
    workdir = Path(tempfile.mkdtemp(prefix="tuun_r2_"))
    song = workdir / "song.tuun"
    song.write_text(SONG.read_text())
    fifo = workdir / "pcm.fifo"
    os.mkfifo(fifo)
    pcm = bytearray()
    first_sound = []

    def reader():
        with open(fifo, "rb") as f:
            while True:
                chunk = f.read(REPL_BLOCK * 4)
                if not chunk:
                    return
                if not first_sound and np.frombuffer(
                        chunk[:len(chunk) // 4 * 4], "<f4").any():
                    first_sound.append(time.perf_counter())
                pcm.extend(chunk)
    reading = threading.Thread(target=reader, daemon=True)
    reading.start()
    out = io.StringIO()
    started = time.perf_counter()
    with contextlib.chdir(workdir), TrackerRuns() as runs:
        r = Repl(sample_rate=REPL_SR, tempo=90, buffer_size=REPL_BLOCK,
                 out=out)
        r.dispatch(f"load {song}")
        warm = {}

        def warmed(n, failures):
            warm.update(n=n, failures=[(t, repr(e)) for t, e in failures],
                        seconds=time.perf_counter() - started)
        # As repl.main: TUUN_PREWARM=0 turns the prewarm off.
        warming = None
        if os.environ.get("TUUN_PREWARM", "1").lower() not in ("0", "off"):
            warming = prewarm.start_background(r.tracker, r.evaluator,
                                               on_done=warmed)
        r.dispatch(f"audio start {fifo}")
        check(r.pump is not None and r.pump.alive,
              f"R2: audio did not start:\n{out.getvalue()}")
        pump = r.pump
        loads, stalls = [], []
        observe = pump.on_status

        def on_status(status):
            loads.append(status.tracker_load)
            observe(status)
        pump.on_status = on_status
        note = pump.on_stall
        pump.on_stall = lambda waited: (stalls.append(waited), note(waited))
        t_live = time.perf_counter()
        script = [(0.0, "play A2")]
        script += [(0.5 * (i + 1), f"slider A2 cutoff {c}") for i, c in
                   enumerate([900, 1500, 2500, 4000, 3000, 1800, 1200, 700,
                              1000, 2000, 3500, 5000, 2200, 1400, 800,
                              1600, 2400, 3200, 4200, 2800])]
        script += [(3.0, "play A3"), (5.0, "play A1 measure"),
                   (6.0, "keys A5"), (6.2, "on 60 100"), (6.2, "on 64 90"),
                   (6.2, "on 67 80"), (8.5, "off 64"), (9.0, "off 60"),
                   (9.0, "off 67"), (9.5, "play A4"), (12.0, "stop A2")]
        script.sort(key=lambda x: x[0])
        dispatches = []
        t_play = None
        for at, line in script:
            wait = t_live + at - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            t0 = time.perf_counter()
            if t_play is None:
                t_play = t0
            r.dispatch(line)
            dispatches.append((line, time.perf_counter() - t0))
        time.sleep(max(0.0, t_live + 15.0 - time.perf_counter()))
        error = pump.error
        r.dispatch("audio status")
        # What held the audio thread: the command path's slowest entries
        # (activations with their compile, modifies, window opens).
        slow = sorted(r.tracker.op_log, key=lambda op: -op[2])[:8]
        slow_ops = [(op, block, round(total * 1e3, 1),
                     {k: round(v * 1e3, 1) for k, v in phases.items()})
                    for op, block, total, phases in slow]
        r.dispatch("audio stop")
        wall = time.perf_counter() - pump._t0
        stats = pump.stats()
        error = error or pump.error
        reading.join(timeout=30)
        if warming is not None:
            warming.join(timeout=600)
        r.dispatch("quit")
        # Blocks by path and the blocks rendered while a capture ran.
        paths = runs.paths()
    log_text = out.getvalue()
    check(error is None, f"R2: the pump failed: {error!r}")
    check(not reading.is_alive(), "R2: the FIFO reader did not finish")
    check("audio thread busy:" not in log_text,
          f"R2: a command timed out:\n{log_text[-3000:]}")
    check("error:" not in log_text and "usage error" not in log_text,
          f"R2: the log reports an error:\n{log_text[-3000:]}")
    check(len(pcm) == stats["blocks_out"] * REPL_BLOCK * 4,
          f"R2: read {len(pcm)} bytes for {stats['blocks_out']} blocks")
    samples = np.frombuffer(bytes(pcm), "<f4")
    check(np.isfinite(samples).all(), "R2: the PCM is not finite")
    check(first_sound and float(np.abs(samples).max()) > 0.01,
          "R2: the PCM stayed silent after the first play")
    check(warming is None or (warm.get("failures") == [] and warm.get(
        "n", 0) >= len(prewarm.COMMON_EXPRS)), f"R2: the prewarm: {warm}")
    walls = np.asarray([w for _, w in dispatches]) * 1e3
    return dict(
        blocks_out=stats["blocks_out"], wall_s=wall,
        blocks_by_wall=wall * REPL_SR / REPL_BLOCK,
        underruns=stats["underruns"], worst_late_ms=stats["worst_late_ms"],
        ring_ms=stats["latency_ms"],
        tracker_load_p50=float(np.percentile(loads, 50)),
        tracker_load_p99=float(np.percentile(loads, 99)),
        dispatch_ms_p50=float(np.percentile(walls, 50)),
        dispatch_ms_p99=float(np.percentile(walls, 99)),
        dispatch_ms_max=float(walls.max()),
        slowest_dispatch=max(dispatches, key=lambda d: d[1])[0],
        prewarm_s=warm.get("seconds"), prewarm_warmed=warm.get("n"),
        first_sound_ms=(first_sound[0] - t_play) * 1e3,
        stall_notes=stalls, peak=float(np.abs(samples).max()),
        launches=dict(kernels.launches), slow_ops=slow_ops, paths=paths)


def r3_cli(tmp: Path) -> dict:
    """R3: `python -m tuun_tpu_torch --ui true song.tuun` in a child on the
    default device, stdin `play A2`, `render 1 OUT.wav`, `quit`."""
    song = tmp / "song.tuun"
    song.write_text(SONG.read_text())
    wav = tmp / "r3.wav"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tuun_tpu_torch", "--ui", "true", str(song)],
        input=f"play A2\nrender 1 {wav}\nquit\n", capture_output=True,
        text=True, timeout=300, cwd=tmp,
        env=dict(os.environ, TUUN_PREWARM="0",
                 PYTHONPATH=str(Path(__file__).resolve().parent)))
    check(proc.returncode == 0, f"R3: exit {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    check("error" not in proc.stdout, f"R3: {proc.stdout[-3000:]}")
    from tuun_tpu_torch.wav import read_wav
    samples, sr = read_wav(wav)
    # `render 1` renders whole blocks: int(44100 / 1024) of 1024 samples.
    want = int(REPL_SR / REPL_BLOCK) * REPL_BLOCK
    check(sr == REPL_SR and len(samples) == want,
          f"R3: {len(samples)} samples at {sr} Hz, want {want}")
    check(np.isfinite(samples).all() and np.abs(samples).max() > 0.01,
          "R3: the WAV is not finite or silent")
    return dict(samples=len(samples), seconds=time.perf_counter() - t0)


def live_in_child() -> dict:
    """R2 in a child process (`chip_smoke.py --live`): its JSON row."""
    argv = [sys.executable, str(Path(__file__).resolve()), "--live"]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0, f"R2: exit {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    row["child_s"] = time.perf_counter() - t0
    return row


def phase_repl(torch, scan_ops, build_s: float) -> dict:
    """Phase 10: R1 on the card and its first R1_CPU_LINES on the CPU, R2
    in a child, R3 in a child.  Returns each scan's launches in R1 and
    R2."""
    from tuun_tpu_torch.engine import kernels
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        kernels.reset_launches()
        t0 = time.perf_counter()
        card = r1_run("cuda", R1_SCRIPT, tmp / "card")
        r1_s = time.perf_counter() - t0
        launched = dict(kernels.launches)
        rows["R1"] = dict(check_r1(card, R1_SCRIPT), seconds=r1_s,
                          launches=launched,
                          slowest=sorted(card["walls"],
                                         key=lambda w: -w[1])[:5])
        t0 = time.perf_counter()
        cpu = r1_run("cpu", R1_SCRIPT[:R1_CPU_LINES], tmp / "cpu")
        check_r1(cpu, R1_SCRIPT[:R1_CPU_LINES])
        x = np.concatenate(card["rendered"][:len(cpu["rendered"])])
        y = np.concatenate(cpu["rendered"])
        stats = fast_mode_errors(x, y.astype(np.float64))
        check(len(x) == len(y) and stats["frac_large"] == 0.0
              and stats["max_abs"] <= 1e-4 * stats["peak"],
              f"R1 card vs CPU: {stats}")
        rows["R1 card vs CPU"] = dict(stats, samples=len(y),
                                      cpu_seconds=time.perf_counter() - t0)
        rows["R2"] = live_in_child()
        rows["R3"] = r3_cli(tmp)
    rows["nvcc build of phase 1 (s)"] = build_s
    for name, row in rows.items():
        log(f"repl {name} {json.dumps(row)}")
    for k, c in rows["R2"]["launches"].items():
        launched[k] += c
    log(f"launch counts of phase 10 (R1 and R2): {launched}")
    for k in SCAN_KERNELS:
        check(launched[k] > 0, f"phase 10: kernel {k} was never launched")
    return launched


# ---------------------------------------------------------------------------
# Phase 11: the exact precisions (exact and exact_df)
# ---------------------------------------------------------------------------

# The two kernels of phase 11, and what each replaces (neither was a
# Pallas kernel: the TPU ran both as XLA scans).
EXACT_KERNELS = ("linear_recurrence_f32", "linear_recurrence_f64",
                 "linear_recurrence_rows_f32", "linear_recurrence_rows_f64",
                 "df_prefix_sum_f32", "df_prefix_sum_rows_f32")
REPLACES.update({k: "tuun_tpu/engine/graph.py:852" for k in EXACT_KERNELS
                 if k.startswith("linear")})
REPLACES.update({k: "tuun_tpu/engine/df32.py:118" for k in EXACT_KERNELS
                 if k.startswith("df")})
EXACT_SOURCE = "tuun_tpu_torch/csrc/exact.cu"
# The kernels no engine path reaches: the reference's IIR rounds in float32
# in both exact precisions (oracle.py:330-337; the JAX engine's scan
# carries float32), so the engine runs the float32 recurrence, and the
# float64 forms are held and timed by the kernel checks alone.  The fast
# kernels' voices x lanes forms serve only fast-mode groups (phase 8).
EXACT_OFF_PATH = ("linear_recurrence_f64", "linear_recurrence_rows_f64",
                  "prefix_sum_rows_f32", "affine_scan_rows_f32")
# The recurrence's depths and lengths: every J the engine renders (the
# fuzz trees' 1-2, lpf's 2, filter_4_3's 3, MAX_J, and the deeper filters
# 9, 12 and 16 of both modes: the history in registers up to J = 16), 17,
# 32 and 64, the wide form's (its first depth, the deepest of its
# 8-product windows, and one past its unrolled depths, where a loop reads
# the products: recurrence_wide_window), and 96, 128, 257 and 4096, the
# streamed form's (J > REC_WIDE_MAX_J: its first depth, a whole number of
# product slots, one product past them, the deepest).
# Up to REC_PLAIN_N lanes every result is held
# bit for bit against the plain version; at REC_LONG_N the plain version
# (a Python loop over lanes, ~5-40 us a lane on the host) runs only at
# J = 2, and every J is held by the one-step check, on fewer lanes where
# a's values would pass REC_LONG_VALUES.  The plain version takes ~10 us
# a lane and feedback coefficient on the host, so past REC_PLAIN_MAX_J
# its numpy twin (recurrence_np: the same ops in the same order, each
# rounded in the inputs' type; tests/test_torch_recurrence.py holds it to
# the plain version bit for bit) stands in for it.
REC_JS = (1, 2, 3, 8, 9, 12, 16, 17, 32, 64, 96, 128, 257, 4096)
REC_PLAIN_N = (1000, 4096 + 5)
REC_LONG_N = (1 << 17) + 5
REC_LONG_VALUES = 1 << 26
REC_PLAIN_MAX_J = 96
# The df prefix sum's lengths, and its bound against the float64 cumsum,
# as a fraction of sum |x|: the CPU's plain scan and JAX's df_cumsum err
# 2-3e-14 of it at 2^10-2^20 lanes of FM phase increments (df_div_f32 of
# 2 pi (220 + 55 sin) / 44100), ~40x under 2^-40 = 9.1e-13.
DF_SIZES = (1 << 10, (1 << 12) + 3, 1 << 14, 1 << 17, 1 << 20)
DF_REL_TOL = 2.0 ** -40
# The rows form's shapes in phase 11, (B, N).
DF_ROWS = ((8, 1024), (4, (1 << 17) + 3), (32, 65536), (64, 65536),
           (8, 1 << 20))
# Shapes of the times, (B, N): the long render's and the shape gate's
# offline block, the live block, and a live group of 8 (rows forms).
EXACT_MAIN_N = 1 << 17
EXACT_TIMES = ((1, EXACT_MAIN_N), (1, 1024), (8, 1024))
# The dead-lane patterns' length (REC_PATTERNS, phase 11): past four of the
# chain form's stages at every J and type, one dead lane at each place of
# a 32-lane group in "stride", ragged (a tail past the last 16-lane grain).
# Its depths: REC_JS' forms, and the edges of the wide form's windows (34,
# its last unrolled depth; 35, its first looped one; 95, its deepest).
REC_PATTERN_N = 2205
REC_PATTERN_JS = (1, 2, 8, 16, 17, 32, 34, 35, 64, 95, 96, 128, 257, 4096)
# --phase times: the recurrence at the main path's shapes, (B, N, J, type):
# the long render's and the shape gate's 2^17-lane blocks, the CLI's 65536,
# the live block and a live group of 8, at lpf's J = 2 and filter_4_3's J
# = 3, the deep filters' J = 9, 12, 16 at 2^17, the wide form's J = 17,
# 24, 32 and 64 and the streamed form's J = 96, 128 and 256 at the same
# four shapes in f32, J = 17, 32 and 96 at 2^17 in f64, and J = 4096 at
# 1024 lanes in both; on all-live lanes (the path's: lanes die only past
# a voice's fin) and on phase 11's mixed input.
REC_MAIN = ((1, EXACT_MAIN_N), (1, 65536), (1, 1024), (8, 1024))
REC_TIMES = tuple((B, n, J, dt) for dt in ("f32", "f64") for J in (2, 3)
                  for B, n in REC_MAIN) + tuple(
    (1, EXACT_MAIN_N, J, "f32") for J in (9, 12, 16)) + tuple(
    (B, n, J, "f32") for J in (17, 24, 32, 64, 96, 128, 256)
    for B, n in REC_MAIN) + tuple(
    (1, EXACT_MAIN_N, J, "f64") for J in (17, 32, 96)) + tuple(
    (1, 1024, 4096, dt) for dt in ("f32", "f64"))
REC_TIMES_LIVE = ("live", "mixed")
# The live block: the single-form prefix scans and the df sum are timed
# there too, the prefix scans beside torch.cumsum / torch.cummax.
LIVE_BLOCK_N = 1024
# --phase times: the df sum at (B, N): the live block, a live group of 8,
# the long render's block, 2^20, and two grids past what the card holds
# at once (DF_ROWS' last two: the tile counter's).
DF_TIMES = ((1, LIVE_BLOCK_N), (8, LIVE_BLOCK_N), (1, EXACT_MAIN_N),
            (1, 1 << 20), (64, 65536), (8, 1 << 20))
# The df sum's two-stream check (phase 11, a child process that must
# answer within DF_STREAMS_TIMEOUT seconds): two rows calls of
# DF_STREAMS_N lanes a row, each grid as many whole rows as the card
# holds at once and the two together past it, DF_STREAMS_ROUNDS calls on
# each of two streams that one event releases at once, every call the
# bits of the same call alone.
DF_STREAMS_N = EXACT_MAIN_N
DF_STREAMS_ROUNDS = 20
DF_STREAMS_TIMEOUT = 300
# H100 SXM peaks (NVIDIA data sheet, 700 W) for the operations bound, and
# the dependent chain's model: one f32 (f64) multiply or subtract takes 4
# (8) cycles of latency at the 1.98 GHz boost clock.
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}
CHAIN_CYCLES = {"f32": 4, "f64": 8}
SM_CLOCK_HZ = 1.98e9

EXACT_SR = 44100
EXACT_ATOL, EXACT_RTOL = 2e-4, 1e-3
# bench.py:848-1014's gates, copied (bench.py imports jax): the four
# production-shape classes and their bounds, and the 64-second score.
SHAPE_TOL = {"nco": 2e-4, "fm": 2e-4, "filter": 2e-4, "reset": 2e-4}
LONGSONG_EXPR = "<[" + ", ".join(
    seg for f_lead, f_fm, f_pad in (
        (440.37, 220.11, 110.0), (329.63, 164.81, 82.41),
        (493.88, 246.94, 123.47), (392.0, 196.0, 98.0))
    for seg in (
        f"sine(2*pi * {f_lead}, 0) * 0.4 | ADSR(0.01, 0.3, 0.2, 0.5, 3.0)"
        " | fin(time - 4) | seq(time - 4)",
        f"sine(2*pi * {f_fm}, 4 * sine(2*pi * 3.7, 0)) * 0.3"
        " | fin(time - 4) | seq(time - 4)",
        f"(sawtooth({f_pad}) + sawtooth({f_pad * 1.003:.5f})) * 0.25"
        " | lpf(0.7, 1200) | fin(time - 4) | seq(time - 4)",
        "noise * 0.2 | moving_average(4) | fin(time - 4) | seq(time - 4)",
    )) + "]>"
LONGRENDER_TOL = 2e-4
# The workloads of phase 3 driven through the CLI in both exact
# precisions, each held over its first PREFIX_SECONDS to the strict bound.
EXACT_CLI = ("W2", "W3")


# Dead-lane patterns of recurrence_input: "mixed" (5% dead lanes and a
# dead run of 64: ~19% of 32-lane groups all live), every lane live (the
# path's: lanes die only past a voice's fin), every lane dead, "stride"
# (one dead lane in 65: its place in a 32-lane group steps by one each
# time, the groups between all live) and "stage_ends" (dead runs of 128
# lanes across the chain form's first stage's end and its fourth's, each
# a whole group of the chain's (64 lanes at most) dead on either side).
REC_PATTERNS = ("mixed", "live", "dead", "stride", "stage_ends")
# The chain form's staging (csrc/exact.cu, J <= REC_REG_J; its constants
# of these names, which tests/test_torch_recurrence.py holds these to): a
# ring of REC_STAGES stage buffers of S lanes, S the largest power of two
# up to REC_MAX_STAGE whose ring fits REC_BUDGET bytes; a row's stages
# are its head where it has one (the lanes before the first whose live
# byte starts a REC_GRAIN-byte grain), then REC_FIRST lanes, then twice as
# many each time up to S.
REC_REG_J = 16
REC_STAGES = 4
REC_FIRST = 64
REC_MAX_STAGE = 1024
REC_BUDGET = 48 * 1024
REC_GRAIN = 16
# The wide form (REC_REG_J < J <= REC_WIDE_MAX_J; exact.cu's kRecWide*
# constants): the same ring and stage order, S from REC_WIDE_BUDGET, which
# also holds REC_WIDE_BUFS product buffers of REC_WIDE_PS items (a window,
# recurrence_wide_window, then one item) and a history of 2J + S items; a
# thread of the chain warp forms recurrence_wide_slots(J) of a lane's J - 2
# products a[j] h[j], j >= 2.  Up to REC_WIDE_UNROLLED_J a lane's chain
# runs unrolled.
REC_WIDE_MAX_J = 95
REC_WIDE_UNROLLED_J = 34
REC_WIDE_BUDGET = 200 * 1024
REC_WIDE_BUFS = 4
REC_WIDE_PS = 100
# The streamed form (REC_WIDE_MAX_J < J <= MAX_RECURRENCE_J; exact.cu's
# kRecStream* constants): the same stage order, the stages holding ff, y
# and live; a's rows stream in blocks of recurrence_stream_block_lanes
# lanes (at least REC_STREAM_ROW_BYTES, or one lane) into
# recurrence_stream_bufs buffers (REC_STREAM_BUFS, halved down to
# REC_STREAM_MIN_BUFS while the smallest stages do not fit); two product
# buffers of recurrence_stream_window items; the history of 2J + S items;
# REC_STREAM_BARS bytes of mbarriers first; all within REC_STREAM_BUDGET.
REC_STREAM_BUDGET = 200 * 1024
REC_STREAM_THREADS = 96
REC_STREAM_BUFS = 4
REC_STREAM_MIN_BUFS = 2
REC_STREAM_ROW_BYTES = 4096
REC_STREAM_BARS = 128


def recurrence_stream_block_lanes(J: int, itemsize: int) -> int:
    """Lanes of a block of a's rows in the streamed form."""
    return max(1, REC_STREAM_ROW_BYTES // (J * itemsize))


def recurrence_stream_block_bytes(J: int, itemsize: int) -> int:
    """Bytes of an a buffer: a block's rows rounded out to 16-byte
    grains (up to 15 bytes either side)."""
    rows = recurrence_stream_block_lanes(J, itemsize) * J * itemsize
    return -(-rows // 16) * 16 + 32


def recurrence_stream_window(J: int) -> int:
    """Items of a product buffer: a lane's J - 2 products, 32 a slot."""
    return -(-(J - 2) // 32) * 32


def recurrence_stream_bytes(J: int, S: int, bufs: int, itemsize: int) -> int:
    """The streamed form's shared memory at depth J with stages of S
    lanes and `bufs` a buffers: mbarriers, product buffers, a buffers, the
    ring of stages (ff, y, live), the history."""
    return (REC_STREAM_BARS + 2 * recurrence_stream_window(J) * itemsize
            + bufs * recurrence_stream_block_bytes(J, itemsize)
            + REC_STAGES * S * (2 * itemsize + 1) + (2 * J + S) * itemsize)


def recurrence_stream_bufs(J: int, itemsize: int) -> int:
    """The streamed form's a buffers at depth J."""
    bufs = REC_STREAM_BUFS
    while bufs > REC_STREAM_MIN_BUFS and recurrence_stream_bytes(
            J, REC_FIRST, bufs, itemsize) > REC_STREAM_BUDGET:
        bufs //= 2
    return bufs


def recurrence_stage_lanes(J: int, itemsize: int) -> int:
    """Lanes of a full stage at depth J, items of `itemsize` bytes: a
    stage buffer holds (J + 2) items (a, ff, y) and a live byte a lane;
    past REC_REG_J the wide form's (recurrence_wide_bytes), past
    REC_WIDE_MAX_J the streamed form's (recurrence_stream_bytes)."""
    lane_bytes = (J + 2) * itemsize + 1
    s = REC_MAX_STAGE
    if J > REC_WIDE_MAX_J:
        bufs = recurrence_stream_bufs(J, itemsize)
        while s > REC_FIRST and recurrence_stream_bytes(
                J, s, bufs, itemsize) > REC_STREAM_BUDGET:
            s //= 2
        return s
    if J > REC_REG_J:
        while s > REC_FIRST and recurrence_wide_bytes(J, s, itemsize) \
                > REC_WIDE_BUDGET:
            s //= 2
        return s
    while s > REC_FIRST and REC_STAGES * s * lane_bytes > REC_BUDGET:
        s //= 2
    return s


def recurrence_wide_bytes(J: int, S: int, itemsize: int) -> int:
    """The wide form's shared memory at depth J with stages of S lanes:
    the ring of stages, the product buffers and the history."""
    return REC_STAGES * S * ((J + 2) * itemsize + 1) + itemsize * (
        REC_WIDE_BUFS * REC_WIDE_PS + 2 * J + S)


def recurrence_wide_window(J: int, itemsize: int) -> tuple:
    """The wide form's window of a lane's J - 2 products a[j] h[j], j >=
    2, at depth J: (items, the first 16-byte chunk the chain reads,
    unrolled).  Up to REC_WIDE_UNROLLED_J the products rounded up to a
    multiple of 8, read from chunk 0 out of registers; past it room for
    REC_WIDE_MAX_J's products, read by a loop from the chunk the products
    start in.  The products end the window; the items before them in its
    chunks are 0."""
    V = 16 // itemsize
    if J <= REC_WIDE_UNROLLED_J:
        return -(-(J - 2) // 8) * 8, 0, True
    chunks = -(-(REC_WIDE_MAX_J - 2) // V)
    return chunks * V, chunks - -(-(J - 2) // V), False


def recurrence_wide_slots(J: int) -> int:
    """Products of a lane (J - 2) a thread of the chain warp forms, at
    most: one where unrolled, three past it."""
    return 1 if J <= REC_WIDE_UNROLLED_J else 3


def recurrence_head(live_addr: int) -> int:
    """Lanes of the head of a row whose live bytes start at `live_addr`."""
    return -live_addr % REC_GRAIN


def recurrence_stages(n: int, head: int, S: int) -> list:
    """(first lane, lanes) of a row's stages, in the order they run."""
    out, st = [], 0
    length, g = (min(n, head), -1) if head else (min(n, REC_FIRST), 0)
    while st < n:
        out.append((st, length))
        st += length
        g += 1
        length = min(n - st, min(S, REC_FIRST << g) if g < 16 else S)
    return out


def rec_live(np, rng, pattern, n, J, itemsize, offset=0):
    """One row's live lanes (n of them, after `offset` live lanes that a
    [offset:] view drops) in `pattern`; "stage_ends" finds the stage ends
    of the kernel's staging, recurrence_stages, for a row whose live bytes
    start `offset` bytes past a 16-byte boundary."""
    if pattern == "mixed":
        live = rng.random(n) > 0.05
        live[n // 3:n // 3 + 64] = False
    elif pattern in ("live", "dead"):
        live = np.full(n, pattern == "live")
    elif pattern == "stride":
        live = np.arange(n) % 65 != 64
    elif pattern == "stage_ends":
        live = np.ones(n, bool)
        S = recurrence_stage_lanes(J, itemsize)
        stages = recurrence_stages(n, recurrence_head(offset), S)
        for st, length in stages[:4:3]:
            live[max(0, st + length - 64):st + length + 64] = False
    else:
        raise ValueError(f"unknown live pattern {pattern!r}")
    return np.concatenate([np.ones(offset, bool), live])


def recurrence_input(torch, np, rng, J, n, dtype, B=None, offset=0,
                     device="cuda", dead="mixed"):
    """(a, ff, live, h0) on `device`: a stable all-pole section with a
    per-lane jitter of 1e-3 (a time-varying filter), unit normal ff, dead
    lanes in the pattern `dead` (REC_PATTERNS; with B, one a row or one
    for all), a random entering history.  With B, B rows; with offset=1
    (single rows only), a, ff and live are views [1:] of tensors one lane
    longer."""
    lead = () if B is None else (B,)
    a = stable_feedback(J) + 1e-3 * rng.standard_normal((*lead, n + offset,
                                                         J))
    ff = rng.standard_normal((*lead, n + offset))
    if dead == "mixed":
        live = rng.random((*lead, n + offset)) > 0.05
        live[..., n // 3:n // 3 + 64] = False
    else:
        pats = [dead] * (B or 1) if isinstance(dead, str) else list(dead)
        item = 4 if dtype == torch.float32 else 8
        live = np.stack([rec_live(np, rng, p, n, J, item, offset)
                         for p in pats]).reshape(*lead, n + offset)
    h0 = rng.standard_normal((*lead, J))

    def card(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return (card(a).to(dtype)[..., offset:, :],
            card(ff).to(dtype)[..., offset:], card(live)[..., offset:],
            card(h0).to(dtype))


def bits(torch, x):
    """x's bits as integers (torch.equal on floats takes -0 == +0)."""
    return x.view(torch.int32 if x.element_size() == 4 else torch.int64)


def recurrence_one_step(torch, args, y, hist) -> bool:
    """Whether every lane of (y, hist) is the recurrence's step from the
    kernel's own history: h[j] = the (j+1)-th live y before the lane (h0
    before the first), y = where(live, ff - a_0 h_0 - ... , 0) in the
    reference's op order, each op its own kernel.  Equal at every lane,
    by induction y is the sequential result bit for bit."""
    a, ff, live, h0 = args
    J = a.shape[1]
    li = live.to(torch.int64)
    before = torch.cumsum(li, 0) - li
    ext = torch.cat([h0.flip(0), y[live]])
    j = torch.arange(J, device=y.device)
    hs = ext[(J - 1) + before[:, None] - j[None, :]]
    acc = ff.clone()
    for k in range(J):
        acc = acc - a[:, k] * hs[:, k]
    want = torch.where(live, acc, torch.zeros_like(acc))
    want_hist = ext[(J - 1) + int(li.sum()) - j]
    return torch.equal(bits(torch, want), bits(torch, y)) \
        and torch.equal(bits(torch, want_hist), bits(torch, hist))


def check_recurrence_plain(torch, scan_ops, args, y, hist, what) -> None:
    """(y, hist) bit for bit against the plain version on the same inputs
    (run on host copies: its Python loop over lanes launches ~3J ops a
    lane, and IEEE rounding makes the host's bits the card's)."""
    cpu = [x.cpu() for x in args]
    if cpu[0].dim() == 3:
        ry, rh = scan_ops.linear_recurrence_rows(*cpu)
    else:
        ry, rh = scan_ops.linear_recurrence(*cpu)
    same = torch.equal(bits(torch, ry), bits(torch, y.cpu())) \
        and torch.equal(bits(torch, rh), bits(torch, hist.cpu()))
    bad = int((bits(torch, ry) != bits(torch, y.cpu())).sum())
    check(same, f"linear_recurrence {what}: {bad} lanes differ from the "
          f"plain version")


def recurrence_np(np, a, ff, live, h0) -> tuple:
    """The plain version's numpy twin on arrays (a [..., N, J], ff and
    live [..., N], h0 [..., J]; leading axes are rows side by side), in
    a's type: a lane's products a[j] h[j] each rounded on its own, then
    ff minus them in order by subtract.accumulate, each difference
    rounded on its own; a dead lane yields 0 and keeps the history.
    Returns (y, hist)."""
    lead, (n, J) = a.shape[:-2], a.shape[-2:]
    a = a.reshape(-1, n, J)
    ff, live = ff.reshape(-1, n), live.reshape(-1, n)
    h = h0.reshape(-1, J).astype(a.dtype)
    y = np.zeros(ff.shape, a.dtype)
    terms = np.empty((a.shape[0], J + 1), a.dtype)
    for i in range(n):
        terms[:, 0] = ff[:, i]
        np.multiply(a[:, i], h, out=terms[:, 1:])
        acc = np.subtract.accumulate(terms, axis=1)[:, -1]
        lv = live[:, i]
        y[lv, i] = acc[lv]
        h[lv] = np.concatenate([acc[lv, None], h[lv, :-1]], 1)
    return y.reshape(*lead, n), h.reshape(*lead, J)


def plain_rows(torch, scan_ops, singles) -> tuple:
    """The plain version of single calls of one length, each (a, ff, live,
    h0), as the rows of one call on host copies (its loop over lanes
    costs the same for one row as for many): (y, hist), a row a call.
    Past REC_PLAIN_MAX_J its numpy twin, recurrence_np."""
    rows = [torch.stack([args[k] for args in singles]).cpu()
            for k in range(4)]
    if rows[0].shape[-1] <= REC_PLAIN_MAX_J:
        return scan_ops.linear_recurrence_rows(*rows)
    y, hist = recurrence_np(np, *(x.numpy() for x in rows))
    return torch.from_numpy(y), torch.from_numpy(hist)


def check_recurrence_patterns(torch, np, scan_ops, rng, dtype) -> None:
    """At each of REC_PATTERN_JS, REC_PATTERNS' dead lanes at
    REC_PATTERN_N lanes: each pattern in a single call, aligned and on
    [1:] views, and all of them as the rows of one rows call, bit for bit
    the plain version (one batched call on host copies of both offsets'
    rows) and each lane the step from its own history."""
    sfx = "f32" if dtype == torch.float32 else "f64"
    n, k_p = REC_PATTERN_N, len(REC_PATTERNS)
    for J in REC_PATTERN_JS:
        inputs = [[recurrence_input(torch, np, rng, J, n, dtype,
                                    offset=offset, dead=p)
                   for p in REC_PATTERNS] for offset in (0, 1)]
        all_y, all_h = plain_rows(torch, scan_ops, inputs[0] + inputs[1])
        for offset, single in enumerate(inputs):
            want_y = all_y[offset * k_p:(offset + 1) * k_p]
            want_h = all_h[offset * k_p:(offset + 1) * k_p]
            outs = [scan_ops.linear_recurrence(*args) for args in single]
            if offset == 0:
                rows_args = tuple(torch.stack([args[k] for args in single])
                                  for k in range(4))
                outs.append(scan_ops.linear_recurrence_rows(*rows_args))
            torch.cuda.synchronize()
            for k, (y, hist) in enumerate(outs):
                what = f"{sfx} J={J} off={offset} " + (
                    REC_PATTERNS[k] if k < len(REC_PATTERNS) else "as rows")
                wy, wh = (want_y, want_h) if y.dim() == 2 else \
                    (want_y[k], want_h[k])
                bad = int((bits(torch, y.cpu()) != bits(torch, wy)).sum())
                check(bad == 0 and torch.equal(bits(torch, hist.cpu()),
                                               bits(torch, wh)),
                      f"linear_recurrence {what}: {bad} lanes differ from "
                      f"the plain version")
                args = single[k] if k < len(single) else rows_args
                check(recurrence_one_step_rows(torch, args, y, hist),
                      f"linear_recurrence {what}: one-step check failed")
    log(f"linear_recurrence_{sfx}: at J = {REC_PATTERN_JS} on dead-lane "
        f"patterns {REC_PATTERNS} at {n} lanes (each alone, aligned and on "
        f"[1:] views, and as the rows of one call) bit for bit the plain "
        f"version, every lane the step from its own history")


def rec_bound(B: int, n: int, J: int, sfx: str) -> dict:
    """The recurrence's bounds on (B, n) at depth J: bytes (a, ff and live
    read once, h0 read and y and hist written once) or operations (J
    products and J differences a lane), the larger; and the dependent
    chain's model, (J + 1) roundings a lane at CHAIN_CYCLES and
    SM_CLOCK_HZ, rows side by side."""
    item = 4 if sfx == "f32" else 8
    lane_bytes = item * (J + 2) + 1
    bytes_ms = B * (n * lane_bytes + 2 * J * item) / HBM_BYTES_PER_S * 1e3
    ops_ms = B * n * 2 * J / PEAK_FLOPS[sfx] * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                chain_bound_ms=n * (J + 1) * CHAIN_CYCLES[sfx] / SM_CLOCK_HZ
                * 1e3)


def rec_kernel_times(torch, fn, n) -> dict:
    """Events, device time alone and host µs of one recurrence call."""
    big = n > 4096
    return dict(ms=cuda_ms(torch, fn, 5 if big else 50),
                device_ms=graph_ms(torch, fn, calls=5 if big else 50,
                                   replays=2 if big else 5),
                host_us=host_us(torch, fn, calls=20 if big else 200))


def rec_call(scan_ops, args):
    """The recurrence's single or rows entry on args, as a closure."""
    if args[1].dim() == 1:
        return lambda: scan_ops.linear_recurrence(*args)
    return lambda: scan_ops.linear_recurrence_rows(*args)


def rec_times(torch, np, scan_ops, dtype, B, n, rng):
    """The recurrence at J = 2 on (B, n): events, device and host time,
    the plain version once on the card, the bound (bytes or operations)
    and the dependent chain's time."""
    args = recurrence_input(torch, np, rng, 2, n, dtype,
                            None if B == 1 else B)
    ref = lambda: scan_ops.linear_recurrence_ref(*args)  # noqa: E731
    sfx = "f32" if dtype == torch.float32 else "f64"
    return dict(B=B, n=n, J=2, dtype=sfx,
                **rec_kernel_times(torch, rec_call(scan_ops, args), n),
                plain_ms=cuda_ms(torch, ref, 1), **rec_bound(B, n, 2, sfx),
                library_ms=None)


def recurrence_one_step_rows(torch, args, y, hist) -> bool:
    """recurrence_one_step on one row or on each of B rows."""
    if args[1].dim() == 1:
        return recurrence_one_step(torch, args, y, hist)
    return all(recurrence_one_step(torch, tuple(x[r] for x in args), y[r],
                                   hist[r]) for r in range(y.shape[0]))


def df_input(torch, np, rng, n, B=None, offset=0):
    """FM phase increments as exact_df makes them: df_div_f32 of 2 pi (220
    + 55 sin(0.001 i + phase)) by 44100, each row its own phase."""
    from tuun_tpu_torch.engine import df32
    lead = () if B is None else (B,)
    ph = rng.uniform(0, 6, lead + (1,)) if lead else rng.uniform(0, 6)
    i = np.arange(n + offset)
    f = (2 * np.pi * (220 + 55 * np.sin(0.001 * i + ph))).astype(np.float32)
    f = torch.from_numpy(np.ascontiguousarray(f)).cuda()
    sr = torch.full((), float(EXACT_SR), dtype=torch.float32, device="cuda")
    xh, xl = df32.df_div_f32(f, sr)
    return xh[..., offset:], xl[..., offset:]


# The df prefix sum's tiles (csrc/exact.cu's df_tile and launches, which
# tests/test_torch_df32.py holds these to): (lanes a row at most, threads,
# lanes a thread); an anchor every `threads` tiles.
DF_GEOMETRY = ((1024, 256, 4), (4096, 512, 8), (1 << 18, 256, 8),
               (None, 512, 8))


def df_geometry(n: int) -> tuple:
    """(threads, lanes a thread) of the df sum's tiles for rows of n."""
    return next((th, it) for top, th, it in DF_GEOMETRY
                if top is None or n <= top)


def df_add_np(np, xh, xl, yh, yl):
    """df32.df_add on numpy float32 arrays, each op rounded on its own."""
    s = xh + yh
    bb = s - xh
    err = (xh - (s - bb)) + (yh - bb)
    te = err + (xl + yl)
    s2 = s + te
    return s2, te - (s2 - s)


def df_model(np, xh, xl):
    """The df prefix sum of each row of float32 (xh, xl) [..., n] in the
    kernel's grouping, in numpy: a thread's lanes folded in turn, a
    shuffle scan a warp, the warp totals scanned alike, the tile's
    aggregate (an anchor's inclusive prefix) and a look-back taking a
    record a thread, a shuffle-down tree a warp and the warps' partials in
    turn; (0, 0) where the kernel holds it.  Returns (oh, ol)."""
    f32 = np.float32
    xh, xl = np.asarray(xh, f32), np.asarray(xl, f32)
    lead, n = xh.shape[:-1], xh.shape[-1]
    threads, items = df_geometry(n)
    tile, warps = threads * items, threads // 32
    tiles = -(-n // tile)
    pad = tiles * tile - n

    def padded(x):
        return np.concatenate([x.reshape(-1, n), np.zeros((x.size // n, pad),
                                                          f32)], -1)
    rows = xh.size // n
    h = padded(xh).reshape(rows, tiles, warps, 32, items)
    l = padded(xl).reshape(rows, tiles, warps, 32, items)
    for k in range(1, items):
        h[..., k], l[..., k] = df_add_np(np, h[..., k - 1], l[..., k - 1],
                                         h[..., k], l[..., k])

    def scan(vh, vl, width):  # Hillis-Steele along the last axis
        for d in (1, 2, 4, 8, 16):
            if d >= width:
                break
            nh, nl = df_add_np(np, vh[..., :-d], vl[..., :-d], vh[..., d:],
                               vl[..., d:])
            vh = np.concatenate([vh[..., :d], nh], -1)
            vl = np.concatenate([vl[..., :d], nl], -1)
        return vh, vl
    ih, il = scan(h[..., -1], l[..., -1], 32)
    wh, wl = scan(ih[..., -1], il[..., -1], warps)
    # Each thread's carry: its warp's, then (lane > 0) its own.
    ch = np.broadcast_to(np.concatenate(
        [np.zeros((rows, tiles, 1), f32), wh[..., :-1]], -1)[..., None],
        ih.shape).copy()
    cl = np.broadcast_to(np.concatenate(
        [np.zeros((rows, tiles, 1), f32), wl[..., :-1]], -1)[..., None],
        il.shape).copy()
    has = np.zeros(ih.shape, bool)
    has[:, :, 1:, :] = True
    eh, el = ih[..., :-1], il[..., :-1]  # lane k's exclusive: lane k - 1
    jh, jl = df_add_np(np, ch[..., 1:], cl[..., 1:], eh, el)
    own = has[..., 1:]
    ch[..., 1:] = np.where(own, jh, eh)
    cl[..., 1:] = np.where(own, jl, el)
    has[..., 1:] = True
    if tiles > 1:
        th, tl = wh[..., -1], wl[..., -1]  # tile totals
        rec_h, rec_l = np.zeros((rows, tiles), f32), np.zeros((rows, tiles),
                                                              f32)
        for t in range(tiles):  # every row at once
            bh = bl = np.zeros(rows, f32)
            if t > 0:
                a = (t - 1) // threads * threads
                words = t - a
                vh = np.zeros((rows, threads), f32)
                vl = np.zeros((rows, threads), f32)
                vh[:, :words], vl[:, :words] = rec_h[:, a:t], rec_l[:, a:t]
                vh = vh.reshape(rows, warps, 32)
                vl = vl.reshape(rows, warps, 32)
                for d in (1, 2, 4, 8, 16):
                    nh, nl = df_add_np(np, vh[..., :-d], vl[..., :-d],
                                       vh[..., d:], vl[..., d:])
                    vh = np.concatenate([nh, vh[..., 32 - d:]], -1)
                    vl = np.concatenate([nl, vl[..., 32 - d:]], -1)
                bh, bl = vh[:, 0, 0], vl[:, 0, 0]
                for w in range(1, -(-words // 32)):
                    bh, bl = df_add_np(np, bh, bl, vh[:, w, 0], vl[:, w, 0])
            if t % threads:
                rec_h[:, t], rec_l[:, t] = th[:, t], tl[:, t]
            elif t:
                rec_h[:, t], rec_l[:, t] = df_add_np(np, bh, bl, th[:, t],
                                                     tl[:, t])
            else:
                rec_h[:, t], rec_l[:, t] = th[:, t], tl[:, t]
            if t > 0:
                bh, bl = bh[:, None, None], bl[:, None, None]
                gh, gl = df_add_np(np, bh, bl, ch[:, t], cl[:, t])
                ch[:, t] = np.where(has[:, t], gh, bh)
                cl[:, t] = np.where(has[:, t], gl, bl)
                has[:, t] = True
    oh, ol = df_add_np(np, ch[..., None], cl[..., None], h, l)
    oh = np.where(has[..., None], oh, h)
    ol = np.where(has[..., None], ol, l)
    return (oh.reshape(rows, -1)[:, :n].reshape(*lead, n),
            ol.reshape(rows, -1)[:, :n].reshape(*lead, n))


def check_df(torch, xh, xl, oh, ol, what) -> float:
    """(oh, ol) against the float64 cumsum of xh + xl within DF_REL_TOL of
    sum |x|, per row; returns the error as a fraction of that."""
    x = xh.double() + xl.double()
    ref = torch.cumsum(x, -1)
    err = (oh.double() + ol.double() - ref).abs().amax(-1)
    scale = x.abs().sum(-1)
    rel = float((err / scale).max())
    check(rel <= DF_REL_TOL and bool(torch.isfinite(oh).all()),
          f"df_prefix_sum {what}: error {rel:.3e} of sum|x| above "
          f"{DF_REL_TOL:.3e}")
    return rel


def df_call(scan_ops, args):
    """The df sum's single or rows entry on (xh, xl), as a closure."""
    if args[0].dim() == 1:
        return lambda: scan_ops.df_prefix_sum_f32(*args)
    return lambda: scan_ops.df_prefix_sum_rows_f32(*args)


def df_times(torch, np, scan_ops, B, n, rng):
    xh, xl = df_input(torch, np, rng, n, None if B == 1 else B)
    fn = df_call(scan_ops, (xh, xl))
    ref = lambda: scan_ops.df_prefix_sum_ref(xh, xl)  # noqa: E731
    x64 = xh.double() + xl.double()
    lib = lambda: torch.cumsum(x64, -1)  # noqa: E731
    big = n > 4096
    bytes_ms = B * n * 16 / HBM_BYTES_PER_S * 1e3
    # 11 float32 operations a df_add, one df_add a lane at the least.
    ops_ms = B * n * 11 / PEAK_FLOPS["f32"] * 1e3
    return dict(B=B, n=n,
                ms=cuda_ms(torch, fn, 50 if big else 200),
                device_ms=graph_ms(torch, fn),
                host_us=host_us(torch, fn),
                plain_ms=cuda_ms(torch, ref, 10 if big else 50),
                library_ms=cuda_ms(torch, lib, 50 if big else 200),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def df_resident(scan_ops, n: int) -> int:
    """Blocks of the df sum's kernel for rows of n lanes that the card
    holds at once (exact.cu's tuun_df_resident)."""
    import ctypes
    lib = scan_ops.load_exact_library()
    lib.tuun_df_resident.argtypes = [ctypes.c_longlong]
    lib.tuun_df_resident.restype = ctypes.c_longlong
    return int(lib.tuun_df_resident(n))


def df_streams(torch, np, scan_ops) -> dict:
    """Two df rows calls at once on two streams (the `--df-streams`
    child): each grid as many whole rows of DF_STREAMS_N lanes as the card
    holds at once, so that the two together do not fit; both streams held
    behind one event until a spin kernel ends, then DF_STREAMS_ROUNDS
    calls on each; every call's bits against the same call alone.  Logs
    the two streams' time together beside one stream's alone."""
    n = DF_STREAMS_N
    tiles = -(-n // scan_ops.load_exact_library().tuun_df_tile(n))
    resident = df_resident(scan_ops, n)
    B = resident // tiles
    check(B >= 1 and 2 * B * tiles > resident,
          f"df two-stream check: {resident} resident blocks give no rows "
          f"count whose grid fits alone and not twice")
    rng = np.random.default_rng(21)
    xs = [df_input(torch, np, rng, n, B) for _ in range(2)]
    want = [scan_ops.df_prefix_sum_rows_f32(*x) for x in xs]
    streams = [torch.cuda.Stream() for _ in xs]
    for s, x in zip(streams, xs):  # each stream's scratch, made here
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            scan_ops.df_prefix_sum_rows_f32(*x)
    torch.cuda.synchronize()
    gate, go = torch.cuda.Stream(), torch.cuda.Event()
    with torch.cuda.stream(gate):
        torch.cuda._sleep(int(0.05 * SM_CLOCK_HZ))
        go.record(gate)
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
             for _ in streams]
    outs = [[] for _ in streams]
    for s, (start, _) in zip(streams, marks):
        s.wait_event(go)
        start.record(s)
    for _ in range(DF_STREAMS_ROUNDS):
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[k].append(scan_ops.df_prefix_sum_rows_f32(*xs[k]))
    for s, (_, end) in zip(streams, marks):
        end.record(s)
    torch.cuda.synchronize()
    bad = sum(not all(torch.equal(bits(torch, o), bits(torch, w))
                      for o, w in zip(out, want[k]))
              for k in range(2) for out in outs[k])
    both = max(marks[0][0].elapsed_time(end) for _, end in marks)
    # One stream's calls alone, queued behind a spin kernel as above.
    alone = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.cuda.stream(streams[0]):
        torch.cuda._sleep(int(0.05 * SM_CLOCK_HZ))
        alone[0].record(streams[0])
        for _ in range(DF_STREAMS_ROUNDS):
            scan_ops.df_prefix_sum_rows_f32(*xs[0])
        alone[1].record(streams[0])
    torch.cuda.synchronize()
    return dict(ok=bad == 0, n=n, rows=B, tiles_a_grid=B * tiles,
                resident_blocks=resident, calls=2 * DF_STREAMS_ROUNDS,
                bad_calls=bad, both_ms=both,
                one_stream_ms=alone[0].elapsed_time(alone[1]),
                device=torch.cuda.get_device_name(0))


def df_streams_in_child() -> dict:
    """df_streams in a child process (`--df-streams`): a grid that never
    finishes hangs the child, not this run, and fails the phase at
    DF_STREAMS_TIMEOUT seconds, as does a call that differs."""
    argv = [sys.executable, str(Path(__file__).resolve()), "--df-streams"]
    try:
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=DF_STREAMS_TIMEOUT)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"df two-stream check: no answer from the child "
                           f"in {DF_STREAMS_TIMEOUT} s (a grid that never "
                           f"finished)") from None
    check(proc.returncode == 0, f"df two-stream check: exit "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    check(row["ok"], f"df two-stream check: {row['bad_calls']} of "
          f"{row['calls']} calls differ from the same call alone: "
          f"{json.dumps(row)}")
    log(f"df_prefix_sum_rows_f32 on two streams at once ({row['rows']} "
        f"rows of {row['n']} lanes a grid, {row['tiles_a_grid']} tiles "
        f"each, {row['resident_blocks']} blocks resident): every call the "
        f"bits of the same call alone {json.dumps(row)}")
    return row


def exact_graph_check(torch, np, scan_ops, rng) -> None:
    """Both kernels, single and rows forms, captured in CUDA graphs on one
    stream (after a plain call each on it, so that the df scratch exists),
    replayed in turns three times over new data copied into the static
    inputs, each replay equal to an eager call on the same data."""
    s = torch.cuda.Stream()
    cases = []
    for B, n in ((1, EXACT_MAIN_N), (8, 1024)):
        rec = recurrence_input(torch, np, rng, 2, n, torch.float32,
                               None if B == 1 else B)
        rfn = scan_ops.linear_recurrence if B == 1 \
            else scan_ops.linear_recurrence_rows
        cases.append((rfn, rec, lambda r=rng, n=n, B=B: recurrence_input(
            torch, np, r, 2, n, torch.float32, None if B == 1 else B)))
        dfx = df_input(torch, np, rng, n, None if B == 1 else B)
        dfn = scan_ops.df_prefix_sum_f32 if B == 1 \
            else scan_ops.df_prefix_sum_rows_f32
        cases.append((dfn, tuple(x.clone() for x in dfx),
                      lambda r=rng, n=n, B=B: df_input(
                          torch, np, r, n, None if B == 1 else B)))
    graphs = []
    for fn, static, fresh in cases:
        static = tuple(x.clone() for x in static)
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            fn(*static)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=s):
            out = fn(*static)
        graphs.append((fn, static, fresh, g, out))
    torch.cuda.synchronize()
    for turn in range(3):
        for fn, static, fresh, g, out in graphs:
            new = fresh()
            for dst, src in zip(static, new):
                dst.copy_(src)
            g.replay()
            want = fn(*static)
            torch.cuda.synchronize()
            check(all(torch.equal(bits(torch, o), bits(torch, w))
                      for o, w in zip(out, want)),
                  f"{fn.__name__} graph replay {turn}: differs from an "
                  f"eager call")
    log(f"exact kernels: {len(graphs)} graphs (recurrence and df sum, "
        f"single at {EXACT_MAIN_N} lanes and rows at (8, 1024)) on one "
        f"stream, replayed in turns 3 times over new data: each replay "
        f"equal to an eager call")


def phase_exact_kernels(torch, np, scan_ops, results) -> None:
    """K1 (the linear recurrence) and K2 (the df prefix sum) against their
    plain versions, repeat bits, rows against single calls, graphs, and
    times at EXACT_TIMES; logs the seconds of each part."""
    rng = np.random.default_rng(11)
    secs = {}
    mark = [time.perf_counter()]

    def took(part):
        now = time.perf_counter()
        secs[part] = secs.get(part, 0.0) + now - mark[0]
        mark[0] = now
    # -- K1 ------------------------------------------------------------
    for dtype in (torch.float32, torch.float64):
        sfx = "f32" if dtype == torch.float32 else "f64"
        for J in REC_JS:
            for n in REC_PLAIN_N:
                pair = [recurrence_input(torch, np, rng, J, n, dtype,
                                         offset=offset) for offset in (0, 1)]
                want_y, want_h = plain_rows(torch, scan_ops, pair)
                for offset, args in enumerate(pair):
                    y, hist = scan_ops.linear_recurrence(*args)
                    bad = int((bits(torch, y.cpu())
                               != bits(torch, want_y[offset])).sum())
                    check(bad == 0 and torch.equal(
                        bits(torch, hist.cpu()), bits(torch, want_h[offset])),
                        f"linear_recurrence {sfx} J={J} n={n} off={offset}: "
                        f"{bad} lanes differ from the plain version")
                    check(recurrence_one_step(torch, args, y, hist),
                          f"linear_recurrence {sfx} J={J} n={n}: one-step "
                          f"check failed")
            took(f"plain J={J}")
            long_n = min(REC_LONG_N, REC_LONG_VALUES // J + 5)
            args = recurrence_input(torch, np, rng, J, long_n, dtype,
                                    offset=1)
            y, hist = scan_ops.linear_recurrence(*args)
            again = scan_ops.linear_recurrence(*args)
            check(recurrence_one_step(torch, args, y, hist),
                  f"linear_recurrence {sfx} J={J} n={long_n}: a lane "
                  f"is not the step from its own history")
            check(torch.equal(bits(torch, y), bits(torch, again[0]))
                  and torch.equal(bits(torch, hist), bits(torch, again[1])),
                  f"linear_recurrence {sfx} J={J}: a repeat differs")
            if J == 2:
                check_recurrence_plain(torch, scan_ops, args, y, hist,
                                       f"{sfx} J=2 n={long_n}")
            scale = max(1.0, float(y.abs().max()))
            log(f"linear_recurrence_{sfx} J={J}: bit for bit the plain "
                f"version" + ("" if J <= REC_PLAIN_MAX_J else
                              " (its numpy twin)")
                + f" at {REC_PLAIN_N} lanes (aligned and on a[1:], "
                f"ff[1:], live[1:])" + (f" and at {long_n}" if J == 2
                                        else "")
                + f"; every lane the step from its own history at "
                f"{long_n} lanes on a[1:], the same bits on a repeat "
                f"(max |y| {scale:.3g})")
            took(f"long J={J}")
        check_recurrence_patterns(torch, np, scan_ops, rng, dtype)
        took("patterns")
        # Rows: each row the bits of a single call on it.
        for B, n in ((8, 1024), (4, 65536 + 3)):
            args = recurrence_input(torch, np, rng, 3, n, dtype, B)
            y, hist = scan_ops.linear_recurrence_rows(*args)
            for r in range(B):
                ys, hs = scan_ops.linear_recurrence(
                    *(x[r].contiguous() for x in args))
                check(torch.equal(bits(torch, ys), bits(torch, y[r]))
                      and torch.equal(bits(torch, hs), bits(torch, hist[r])),
                      f"linear_recurrence_rows_{sfx} ({B}, {n}): row {r} "
                      f"differs from a single call")
            if n <= 1024:
                check_recurrence_plain(torch, scan_ops, args, y, hist,
                                       f"rows {sfx} ({B}, {n})")
        log(f"linear_recurrence_rows_{sfx}: every row of (8, 1024) and "
            f"(4, 65539) at J = 3 bit for bit a single call on it (and the "
            f"plain version at (8, 1024))")
        for B, n in EXACT_TIMES:
            row = rec_times(torch, np, scan_ops, dtype, B, n, rng)
            key = f"linear_recurrence_{'rows_' if B > 1 else ''}{sfx}"
            results[key].append(dict(row, err=0.0))
            log(f"{key} {json.dumps(row)}")
        took("rows and times")
    # -- K2 ------------------------------------------------------------
    errs = {}
    for n in DF_SIZES:
        for offset in (0, 1):
            xh, xl = df_input(torch, np, rng, n, offset=offset)
            oh, ol = scan_ops.df_prefix_sum_f32(xh, xl)
            rel = check_df(torch, xh, xl, oh, ol,
                           f"n={n} off={offset}")
            ph, pl = scan_ops.df_prefix_sum_ref(xh, xl)
            plain = check_df(torch, xh, xl, ph, pl,
                             f"plain n={n}")
            vs_plain = float((oh.double() + ol.double() - ph.double()
                              - pl.double()).abs().max())
            f32 = float((torch.cumsum(xh, 0).double() - torch.cumsum(
                xh.double() + xl.double(), 0)).abs().max())
            abs_err = float((oh.double() + ol.double() - torch.cumsum(
                xh.double() + xl.double(), 0)).abs().max())
            check(abs_err < 1e-4 and (n < 1 << 17 or abs_err < f32 / 1e3),
                  f"df_prefix_sum n={n}: {abs_err:.3e} rad, f32 cumsum "
                  f"{f32:.3e}")
            same = sum(not (torch.equal(bits(torch, oh), bits(torch, o2))
                            and torch.equal(bits(torch, ol), bits(torch, l2)))
                       for o2, l2 in (scan_ops.df_prefix_sum_f32(xh, xl)
                                      for _ in range(20)))
            check(same == 0, f"df_prefix_sum n={n}: {same} of 20 repeats "
                  f"differ")
            mh, ml = df_model(np, xh.cpu().numpy(), xl.cpu().numpy())
            check(np.array_equal(mh.view(np.int32),
                                 oh.cpu().numpy().view(np.int32))
                  and np.array_equal(ml.view(np.int32),
                                     ol.cpu().numpy().view(np.int32)),
                  f"df_prefix_sum n={n} off={offset}: not the bits of its "
                  f"grouping's model (df_model)")
            errs[(n, offset)] = vs_plain
            log(f"df_prefix_sum_f32 n={n} off={offset}: {rel:.3e} of sum|x|"
                f" ({abs_err:.3e} rad; plain {plain:.3e} of sum|x|, "
                f"{vs_plain:.3e} rad from the kernel; f32 cumsum {f32:.3e} "
                f"rad), the same bits on 20 repeats and as df_model")
    # (64, 65536) and (8, 2^20): grids of 2048 tiles, past what the card
    # holds at once (528-1056 blocks), which take their tiles from the
    # tile counter; a one-row call on either holds its whole grid.
    took("df sizes")
    for B, n in DF_ROWS:
        xh, xl = df_input(torch, np, rng, n, B)
        oh, ol = scan_ops.df_prefix_sum_rows_f32(xh, xl)
        check_df(torch, xh, xl, oh, ol, f"rows ({B}, {n})")
        mh, ml = df_model(np, xh.cpu().numpy(), xl.cpu().numpy())
        check(np.array_equal(mh.view(np.int32),
                             oh.cpu().numpy().view(np.int32))
              and np.array_equal(ml.view(np.int32),
                                 ol.cpu().numpy().view(np.int32)),
              f"df_prefix_sum_rows ({B}, {n}): not the bits of its "
              f"grouping's model (df_model)")
        for r in range(B):
            sh, sl = scan_ops.df_prefix_sum_f32(xh[r].contiguous(),
                                                xl[r].contiguous())
            check(torch.equal(bits(torch, sh), bits(torch, oh[r]))
                  and torch.equal(bits(torch, sl), bits(torch, ol[r])),
                  f"df_prefix_sum_rows ({B}, {n}): row {r} differs from a "
                  f"single call")
    log(f"df_prefix_sum_rows_f32: every row of {DF_ROWS} bit for bit a "
        f"single call on it and df_model, within the bound")
    took("df rows")
    df_streams_in_child()
    took("df two streams")
    for B, n in EXACT_TIMES:
        row = df_times(torch, np, scan_ops, B, n, rng)
        key = "df_prefix_sum_rows_f32" if B > 1 else "df_prefix_sum_f32"
        results[key].append(dict(row, err=max(errs.values())))
        log(f"{key} {json.dumps(row)}")
    exact_graph_check(torch, np, scan_ops, rng)
    took("df times and graphs")
    log("phase 11 kernel checks seconds (both types): " + ", ".join(
        f"{part} {t:.1f}" for part, t in secs.items()))


def exact_one_launch_calls(torch, np, scan_ops, rng) -> list:
    """The recurrence and the df sum for check_one_launch: each form and
    type at one tile and at many, on a[1:], and the rows forms."""
    from tuun_tpu_torch.engine import kernels
    calls, sym = [], kernels.KERNEL_SYMBOLS
    for dtype, name in ((torch.float32, "float"), (torch.float64, "double")):
        # J = 12: a register-history depth past the affine scan's (fast
        # mode's deep filters); 17: the wide form; 96: the streamed form.
        for J, tag in ((2, 2), (12, 12), (17, 0), (96, 0)):
            for n, off in ((1000, 0), (REC_LONG_N, 1)):
                calls.append((scan_ops.linear_recurrence, recurrence_input(
                    torch, np, rng, J, n, dtype, offset=off),
                    sym["linear_recurrence_f32"], f"<{name}, {tag}>"))
        calls.append((scan_ops.linear_recurrence_rows, recurrence_input(
            torch, np, rng, 2, 1024, dtype, 8),
            sym["linear_recurrence_rows_f32"], f"<{name}, 2>"))
    for n, B, off in ((1000, None, 0), (EXACT_MAIN_N, None, 1),
                      (1 << 20, None, 0), (1024, 8, 0), (65536, 32, 0),
                      (1 << 20, 8, 0)):
        fn = scan_ops.df_prefix_sum_f32 if B is None \
            else scan_ops.df_prefix_sum_rows_f32
        calls.append((fn, df_input(torch, np, rng, n, B, off),
                      sym["df_prefix_sum_f32"], "df_prefix_sum"))
    return calls


def shape_programs(ir):
    """bench.py's four production-shape classes (fixed structures, non-
    round frequencies so that phase-increment rounding shows), in `ir`."""
    C = ir.Const

    def mul(a, b):
        return ir.BinaryPointOp(ir.Operator.MULTIPLY, a, b)

    def add(a, b):
        return ir.BinaryPointOp(ir.Operator.ADD, a, b)

    tau = 2 * math.pi
    nco = add(ir.Sine(C(tau * 440.37), C(0.0)),
              add(mul(ir.Sine(C(tau * 554.12), C(0.0)), C(0.5)),
                  mul(ir.Sine(C(tau * 659.93), C(0.0)), C(0.25))))
    fm = ir.Sine(add(C(tau * 220.11),
                     mul(ir.Sine(C(tau * 3.7), C(0.0)), C(tau * 55.3))),
                 C(0.0))
    filt = ir.Filter(ir.Sine(C(tau * 330.41), C(0.0)),
                     [C(0.21), C(0.34), C(0.21)], [C(0.45), C(-0.22)])
    saw = mul(add(ir.Reset(ir.Sine(C(tau * 441.3), C(0.0)),
                           mul(C(-441.3), ir.Time())),
                  C(0.5)), C(2.0))
    return {"nco": nco, "fm": fm, "filter": filt, "reset": saw}


def gate_fuzz(device, seed0=5000, n_structs=16, n_variants=4, n=256, sr=4):
    """bench.py's fuzz_tpu lane (bench.py:704-846) on the port: seed-logged
    random trees (fuzzgen), n_structs structures at depth 4/5 x n_variants
    const-jittered variants, rendered on `device` in three precisions
    against the per-sample oracle: fast with the differential suite's
    statistical gates (exact length, finite, median error < 1e-3 scale,
    < 10% of samples off by > 5% of scale), exact_df and exact at the
    strict tolerances (atol 2e-4, rtol 1e-3).  No budget stop; a render
    that raises is not caught.  Returns (ok, fail, skip, failures)."""
    import random

    from tuun_tpu_torch import fuzzgen, ir, optimizer, oracle
    from tuun_tpu_torch.engine import render

    ok = fail = skip = 0
    failures = []
    class_counts: dict = {}
    cases = []
    for si in range(n_structs):
        seed = seed0 + si
        w0 = fuzzgen.random_waveform(random.Random(seed), depth=4 + seed % 2)
        block = (n, 97, 64)[si % 3]  # full-piece, odd, and small blocks
        for vi in range(n_variants):
            wv = w0 if vi == 0 else fuzzgen.jitter_consts(
                w0, random.Random(seed * 1000 + vi))
            cases.append((seed, vi, wv, block))
    for seed, vi, w, block in cases:
        try:
            ref0 = oracle.render(w, n, sr, seed=seed)
        except AssertionError:
            skip += 1  # reference-undefined (see below)
            continue
        if not np.all(np.isfinite(ref0)) or \
                fuzzgen.ill_conditioned(w, n, sr, seed):
            skip += 1
            continue
        has_noise = any(isinstance(x, ir.Noise) for x in w.walk())
        for x in w.walk():
            cname = type(x).__name__
            class_counts[cname] = class_counts.get(cname, 0) + 1
        form = w if has_noise else optimizer.optimize(w)
        try:
            ref = oracle.render(form, n, sr, seed=seed, block=block)
        except AssertionError:
            # A non-monotone Fin length inside a Filter: the reference
            # panics on the same program at the same segmentation.
            skip += 1
            continue
        err = None
        got = render(form, n, sr, precision="fast", seed=seed, block=block,
                     device=device)
        if len(got) != len(ref):
            err = f"fast length {len(got)} != {len(ref)}"
        elif len(got):
            if not np.all(np.isfinite(got)):
                err = "fast non-finite samples"
            else:
                d = np.abs(np.asarray(got, np.float64) - ref)
                scale = max(1.0, float(np.abs(ref).max()))
                med = float(np.median(d))
                frac = float(np.mean(d > 0.05 * scale))
                if med > 1e-3 * scale:
                    err = f"fast median error {med:.5f} (scale {scale:.3g})"
                elif frac > 0.1:
                    err = f"fast {frac * 100:.1f}% samples off >5% of scale"
        for prec in ("exact_df", "exact"):
            if err is not None:
                break
            got = render(form, n, sr, precision=prec, seed=seed,
                         block=block, device=device)
            if len(got) != len(ref):
                err = f"{prec} length {len(got)} != {len(ref)}"
            elif len(got) and not np.allclose(got, ref, atol=EXACT_ATOL,
                                              rtol=EXACT_RTOL):
                d = np.abs(np.asarray(got, np.float64) - ref)
                err = f"{prec} strict diff: max {float(d.max()):.2e}"
        if err:
            fail += 1
            failures.append((f"{seed}/v{vi}", err))
        else:
            ok += 1
    classes = " ".join(f"{k}:{v}" for k, v in sorted(
        class_counts.items(), key=lambda kv: -kv[1]))
    log(f"# fuzz: {ok} ok / {fail} fail / {skip} skip "
        f"({ok + fail + skip}/{len(cases)} cases: {n_structs} structures "
        f"(seeds {seed0}..{seed0 + n_structs - 1}, depth=4/5) x "
        f"{n_variants} const-jitter variants, n={n}, sr={sr}, blocks per "
        f"struct%3 of {(n, 97, 64)}, fast+exact_df+exact on {device}; node "
        f"classes [{classes}])")
    for case, msg in failures[:8]:
        log(f"#   fuzz FAIL seed={case}: {msg}")
    return ok, fail, skip, failures


def gate_shapes(device, n=1 << 17, sr=EXACT_SR,
                precisions=("exact_df", "exact")) -> bool:
    """bench.py's production-shape tier (bench.py:848-955) on the port:
    the nco, fm, filter and reset classes in each precision, one n-lane
    render (offline) and n / 1024 state-carried 1024-lane blocks
    (stream), against the oracle within SHAPE_TOL of scale."""
    from tuun_tpu_torch import ir, oracle
    from tuun_tpu_torch.engine import render

    fail = ok = 0
    lines = []
    for cname, w in shape_programs(ir).items():
        ref = np.asarray(oracle.render(w, n, sr, seed=0), np.float64)
        tol = SHAPE_TOL[cname]
        for prec in precisions:
            for shape_name, blk in (("offline", n), ("stream", 1024)):
                got = render(w, n, sr, precision=prec, seed=0, block=blk,
                             device=device)
                err = None
                if len(got) != len(ref):
                    err = f"length {len(got)} != {len(ref)}"
                elif not np.all(np.isfinite(got)):
                    err = "non-finite samples"
                else:
                    d = np.abs(np.asarray(got, np.float64) - ref)
                    scale = max(1.0, float(np.abs(ref).max()))
                    mx, med = float(d.max()), float(np.median(d))
                    if mx > tol * scale:
                        err = (f"max err {mx:.2e} > {tol:.0e}*{scale:.2f} "
                               f"(median {med:.2e})")
                    else:
                        lines.append(f"{cname}/{shape_name}/{prec} "
                                     f"max={mx:.1e} med={med:.1e}")
                if err:
                    fail += 1
                    lines.append(f"{cname}/{shape_name}/{prec} FAIL: {err}")
                else:
                    ok += 1
    log(f"# fuzz_shapes: {ok} ok / {fail} fail ({'+'.join(precisions)} on "
        f"{device}, n={n} sr={sr}, offline 1x{n}-lane + streaming "
        f"{n // 1024}x1024-lane; strict per-class bounds "
        f"{sorted(SHAPE_TOL.items())})")
    for ln in lines:
        log(f"#   fuzz_shapes {ln}")
    return fail == 0


def gate_longrender(device, sr=EXACT_SR, n=None, block=1 << 17):
    """bench.py's long render (bench.py:957-1014) on the port: the
    64-second four-class score from source through the evaluator, the
    optimizer and the engine in exact_df, against the native oracle
    sample by sample within LONGRENDER_TOL of scale.  Returns (passed,
    row)."""
    from tuun_tpu_torch import cli, native, optimizer
    from tuun_tpu_torch.engine import render
    from tuun_tpu_torch.evaluator import Evaluator
    from tuun_tpu_torch.expr import ESeq, EWaveform

    out = Evaluator(sr, 120, cli.DEFAULT_LIBRARY).evaluate_source(
        LONGSONG_EXPR, opens=("std",))
    if isinstance(out, ESeq):
        out = out.waveform
    check(isinstance(out, EWaveform), f"longsong eval: {out!r}")
    form = optimizer.optimize(out.waveform)
    if n is None:
        n = 64 * sr + sr // 2  # past the score's end: lengths must agree
    t0 = time.perf_counter()
    ref = native.render(form, n, sr, seed=0)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = render(form, n, sr, precision="exact_df", seed=0, block=block,
                 device=device)
    t_engine = time.perf_counter() - t0
    err = None
    mx = med = 0.0
    scale = 1.0
    if len(got) != len(ref):
        err = f"length {len(got)} != {len(ref)}"
    elif not np.all(np.isfinite(got)):
        err = "non-finite samples"
    else:
        d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
        scale = max(1.0, float(np.abs(ref).max()))
        mx, med = float(d.max()), float(np.median(d))
        if mx > LONGRENDER_TOL * scale:
            err = f"max err {mx:.2e} > {LONGRENDER_TOL:.0e}*{scale:.2f}"
    log(f"# longrender: {'FAIL ' + err if err else 'PASS'} - {len(ref)} "
        f"samples ({len(ref) / sr:.1f}s at {sr} Hz) of the 4-class score, "
        f"exact_df on {device} vs native oracle: max {mx:.1e} median "
        f"{med:.1e} (scale {scale:.2f}, bound {LONGRENDER_TOL:.0e}); engine "
        f"{t_engine:.1f}s native {t_native:.1f}s")
    return err is None, dict(samples=len(ref), max=mx, median=med,
                             scale=scale, engine_s=t_engine,
                             native_s=t_native)


# G2's live-block session cut to its first third, as its profile is (8
# notes an instrument over 0.53 s): in exact_df the whole session's two
# runs took 54.5 s on the H100, and half of it 62.4 s on a slower host,
# most of what a full run took over its time budget of about 560 s.
EXACT_SESSION = G2_PROFILE_SESSION


def exact_session(torch, np) -> dict:
    """EXACT_SESSION in exact_df with the fused step on, at sync_interval
    1 and 4: each mix against the sum of its voices' own renders within
    phase 8's bound, the blocks' paths logged."""
    session = EXACT_SESSION
    block, tol = session[0], session[4]
    waves = g2_waveforms(g2_notes(session))
    rows = {}
    for si in (1, 4):
        with TrackerRuns() as runs:
            mix, walls, shape, wall = g2_session(
                torch, session, waves, fuse=True, sync_interval=si,
                precision="exact_df")
        ref, mag = g2_reference(torch, np, runs.voices, block, len(mix))
        err = check_mix(np, f"exact_df session sync_interval={si}", mix, ref,
                        g2_bound(np, ref, mag, runs.voices,
                                 stream_tol(tol, si)))
        paths = runs.paths()
        check_paths(f"exact_df session sync_interval={si}", paths)
        rows[si] = dict(session_row(np, mix, walls, shape, wall),
                        max_err=err, voices=len(runs.voices),
                        max_group=max(max(x[2], default=0) for x in shape),
                        paths={k: v for k, v in paths.items()
                               if k in ("pervoice", "fused", "open",
                                        "served", "replays",
                                        "captures_finished")})
    log(f"exact_df session {json.dumps(rows)}")
    return rows


def exact_cli(np, tmp: Path) -> None:
    """W2 and W3 through the CLI in exact_df and exact (48 kHz, 65536-
    sample blocks, --precompute false): the WAV's length the native
    oracle's, its first PREFIX_SECONDS within the strict bound of the
    oracle."""
    from tuun_tpu_torch import cli, oracle
    from tuun_tpu_torch.player import build_top_level_waveform
    from tuun_tpu_torch.wav import read_wav
    exprs = {name: expr for name, expr, _, _ in WORKLOADS}
    m = int(PREFIX_SECONDS * SR)
    for name in EXACT_CLI:
        w, want_len = workload_waveform(exprs[name])
        top = build_top_level_waveform(w, 0.0)
        ref = oracle.render(top, m, SR, seed=1).astype(np.float64)
        scale = max(1.0, float(np.abs(ref).max()))
        for prec in ("exact_df", "exact"):
            out = tmp / f"{name}_{prec}.wav"
            t0 = time.perf_counter()
            rc = cli.main(["--expr", exprs[name], "--sample_rate", str(SR),
                           "--buffer_size", str(BUFFER), "--device", "cuda",
                           "--precision", prec, "--precompute", "false",
                           "--render-out", str(out), "-O", str(tmp),
                           "--quiet"])
            wall = time.perf_counter() - t0
            check(rc == 0, f"{name} {prec}: the CLI exited {rc}")
            got, sr = read_wav(out)
            check(sr == SR and len(got) == want_len
                  and np.isfinite(got).all(),
                  f"{name} {prec}: {len(got)} samples at {sr} Hz, the "
                  f"oracle's length is {want_len}")
            d = np.abs(got[:m].astype(np.float64) - ref)
            check(bool(np.all(d <= EXACT_ATOL * scale + EXACT_RTOL
                              * np.abs(ref))),
                  f"{name} {prec}: max error {d.max():.3e} against the "
                  f"oracle")
            log(f"{name} {prec} through the CLI: {len(got)} samples "
                f"({len(got) / SR:.1f} s) in {wall:.1f} s; first "
                f"{PREFIX_SECONDS:.0f} s vs oracle max {d.max():.2e} median "
                f"{float(np.median(d)):.2e}")


class LaunchLengths:
    """While active, counts the recurrence's and the df sum's launches by
    (entry, rows, lanes): an eager call as it launches, a call that a CUDA
    graph captures as it is recorded; a graph's replays relaunch what its
    capture recorded and are counted by entry alone (the graph keeps its
    own copy of the counts, not the shapes).  The launches are
    scan_ops'; the capture's recording and the replays' count are
    kernels'."""
    WRAPPED = ("_recurrence_launch", "_df_launch")
    WATCHED = ("linear_recurrence_f32", "linear_recurrence_f64",
               "linear_recurrence_rows_f32", "linear_recurrence_rows_f64",
               "df_prefix_sum_f32", "df_prefix_sum_rows_f32")

    def __init__(self, scan_ops, kernels):
        self.ops = scan_ops
        self.kernels = kernels
        self.eager = {}
        self.captured = {}
        self.replayed = {}

    def _launch(self, fn):
        def launch(*args):
            # (a, ff, live, h0, rows, entry) or (xh, xl, rows, entry)
            key = (args[-1], args[-2], args[1].shape[-1])
            rec = getattr(self.kernels._tls, "recording", None)
            table = self.eager if rec is None else self.captured
            table[key] = table.get(key, 0) + 1
            return fn(*args)
        return launch

    def _replayed(self, fn):
        def count(recorded):
            for k, c in recorded.items():
                if k in self.WATCHED:
                    self.replayed[k] = self.replayed.get(k, 0) + c
            return fn(recorded)
        return count

    def __enter__(self):
        self.saved = {k: getattr(self.ops, k) for k in self.WRAPPED}
        self.counted = self.kernels.count_launches
        for k in self.WRAPPED:
            setattr(self.ops, k, self._launch(self.saved[k]))
        self.kernels.count_launches = self._replayed(self.counted)
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(self.ops, k, fn)
        self.kernels.count_launches = self.counted

    def table(self) -> dict:
        """{"eager": [[entry, rows, lanes, launches], ...] and "captured"
        likewise, most first; "replayed": {entry: launches}}."""
        def rows(t):
            return sorted(([*k, c] for k, c in t.items()),
                          key=lambda r: (-r[3], r[0], r[1], r[2]))
        return dict(eager=rows(self.eager), captured=rows(self.captured),
                    replayed=dict(sorted(self.replayed.items())))


def phase_exact(torch, np, scan_ops, results, tmp: Path) -> dict:
    """Phase 11: the kernel checks, then the path (the three gates, the
    exact_df session, W2 and W3 through the CLI), whose launches, and
    only those, make each kernel's `exact_launches`; the recurrence's and
    the df sum's are also logged by length."""
    from tuun_tpu_torch.engine import kernels
    phase_exact_kernels(torch, np, scan_ops, results)
    kernels.reset_launches()
    with LaunchLengths(scan_ops, kernels) as lengths:
        t0 = time.perf_counter()
        ok, fail, skip, failures = gate_fuzz("cuda")
        check(fail == 0 and ok >= 32, f"fuzz gate: {ok} ok, {fail} fail, "
              f"{skip} skip: {failures[:8]}")
        t1 = time.perf_counter()
        check(gate_shapes("cuda"), "shape gate failed")
        t2 = time.perf_counter()
        passed, row = gate_longrender("cuda")
        check(passed, f"long render failed: {row}")
        t3 = time.perf_counter()
        exact_session(torch, np)
        t4 = time.perf_counter()
        exact_cli(np, tmp)
        t5 = time.perf_counter()
    counts = dict(kernels.launches)
    log(f"phase 11 seconds: fuzz {t1 - t0:.1f}, shapes {t2 - t1:.1f}, long "
        f"render {t3 - t2:.1f}, session {t4 - t3:.1f}, cli {t5 - t4:.1f}")
    log(f"launch counts of phase 11: {counts}")
    log(f"phase 11's recurrence and df sum launches by length ([entry, "
        f"rows, lanes, launches]; replays of captured graphs by entry): "
        f"{json.dumps(lengths.table())}")
    # The deep affine scan serves only fast filters deeper than MAX_J, which
    # phase 11's path does not render (phase 12 does).
    for k, c in counts.items():
        if k not in EXACT_OFF_PATH + DEEP_KERNELS:
            check(c > 0, f"kernel {k} was never launched in phase 11")
    return counts


def exact_kernel_rows(results, counts, tools, mesh) -> list:
    """The kernels line's rows of K1 and K2: the main shape's times (J = 2
    at EXACT_MAIN_N lanes; (8, 1024) for the rows forms), and phase 11's,
    phase 12's and phase 13's launches."""
    rows = []
    for k in EXACT_KERNELS:
        main = results[k][0]
        rows.append({
            "name": k, "route": "cuda", "source": EXACT_SOURCE,
            "replaces": REPLACES[k], "launches": counts[k],
            "exact_launches": counts[k], "tools_launches": tools[k],
            "mesh_launches": mesh[k],
            "on_path": k not in EXACT_OFF_PATH,
            "max_abs_err": max(r["err"] for r in results[k]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "device_ms": main["device_ms"], "host_us": main["host_us"],
            "shape": [main["B"], main["n"]],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "chain_bound_ms": main.get("chain_bound_ms"),
            "library_ms": main["library_ms"]})
    return rows


def deep_kernel_rows(results, phases) -> list:
    """The kernels line's rows of the deep affine scan: phase 2's times at
    the main shape (J = 16 at 65536 lanes, the render's block; rows (4,
    1024, 12), T1's group), and phase 12's launches, the path that reaches it
    (`launches`), beside each phase's of `phases` ({"main": phases 3 and
    8, "session", "repl", "exact", "tools", "mesh"}: name -> counts)."""
    rows = []
    for k, (B, n, J) in zip(DEEP_KERNELS, ((1,) + DEEP_SPLIT[0][::-1],
                                           DEEP_ROWS[0])):
        main = next(r for r in results[k]
                    if (r["B"], r["n"], r["J"]) == (B, n, J))
        rows.append({
            "name": k, "route": "cuda",
            "source": "tuun_tpu_torch/csrc/scan.cu",
            "replaces": REPLACES[k], "launches": phases["tools"][k],
            **{f"{phase}_launches": c[k] for phase, c in phases.items()},
            "max_abs_err": max(r["err"] for r in results[k]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "device_ms": main["device_ms"],
            "plain_device_ms": main["plain_device_ms"],
            "host_us": main["host_us"], "shape": [B, n, J],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            # PyTorch has no IIR: no single call computes the scan.
            "library_ms": None})
    return rows


# ---------------------------------------------------------------------------
# Phase 12: fast-mode filters deeper than the affine scan, and the tools
# ---------------------------------------------------------------------------

# Fast mode runs J = 9, 12, 16 on the deep affine scan and deeper filters
# (past MAX_DEEP_J) on the linear recurrence: 17 on its wide form, 96 and
# 128 on its streamed form.
DEEP_JS = (9, 12, 16, 17, 96, 128)
DEEP_N = 1 << 17
DEEP_BLOCKS = (65536, 1024)
# Against the native oracle, as a fraction of the render's peak: the
# bound tests/test_torch_stream.py holds the port and tuun_tpu's fast
# mode to (tuun_tpu's composed maps err 8.7e-7 to 3.3e-6 of scale there;
# the recurrence rounds as the oracle does).
DEEP_TOL = 1e-5
DEEP_REC_N = (1 << 17) + 5
# The deep voice group's session: (sample rate, block, note seconds,
# sync_interval), four J = 12 voices in one group, the fused step on.
DEEP_SESSION = (SR, 1024, 0.5, 4)
# The tools' rate (web_checker's and scope's default) and the corpus
# lane's render length (bench.py:1105's defaults).
TOOLS_SR = 44100
CORPUS_SAMPLES = 22050
# profile's expressions and the kernels each block must launch: the
# affine scan (harmonica's lpf), W3's FM voice (the prefix sum), W2g (an
# outer reset no analytic tier takes: the prefix max, and lpf).
PROFILE_EXPRS = (
    ("harmonica(1.0, 440)", ("affine_scan_f32",)),
    ("sine(2*pi*(220 + 30*$(5)), 0) * 0.5", ("prefix_sum_f32",)),
    ("reset(triangle(110), time * -110) * 2 | lpf(0.7, 2000)",
     ("prefix_max_f32", "affine_scan_f32")))
SCOPE_EXPR = "(square(220) | lpf(0.7, 2000)) * 1.5"
# tests/test_instruments.py's programs: (name, expression, seconds,
# opens).  They reach no scan kernel: their carriers are NCOs, and
# pm_ukulele modulates phase, not frequency.
INSTRUMENTS = (
    ("flute", "$546 | ADSR(0.32, 0.0, 1.0, 1.25, 0.18)", 2.2, ("std",)),
    ("ukulele", "pm_ukulele(10, 0.41, 0.2)(2.0, 276)", 3.0,
     ("std", "pm_synth")))
# The kernels phase 12's path must launch: the deep filters' (the deep
# scan alone and in the group, the recurrence past J = 16) and the
# tools'.
TOOLS_KERNELS = ("prefix_sum_f32", "prefix_max_f32", "affine_scan_f32",
                 "affine_scan_deep_f32", "affine_scan_deep_rows_f32",
                 "linear_recurrence_f32")


def deep_filter(ir, J, inner, b=(0.5, 0.25)):
    """inner through a J-deep all-pole section (stable_feedback(J)) with
    feed-forward b."""
    a = stable_feedback(J)
    return ir.Filter(inner, tuple(ir.Const(float(x)) for x in b),
                     tuple(ir.Const(float(x)) for x in a))


def deep_offline(device, n=DEEP_N, blocks=DEEP_BLOCKS) -> dict:
    """The ramp of tests/test_torch_stream.py's _deep through each of
    DEEP_JS feedback coefficients in fast mode, n samples in each block
    size, each within DEEP_TOL of scale of the native oracle; on the card
    each render must reach the deep affine scan (J <= MAX_DEEP_J) or the
    linear recurrence (past it), and not the other.  Logs the error and
    the engine's wall time a block."""
    from tuun_tpu_torch import ir, native
    from tuun_tpu_torch.engine import kernels
    from tuun_tpu_torch.engine import render, scan_ops
    sr = SR
    rows = {}
    for J in DEEP_JS:
        deep = J <= scan_ops.MAX_DEEP_J
        route = ("affine_scan_deep_f32", "linear_recurrence_f32")[not deep]
        other = ("affine_scan_deep_f32", "linear_recurrence_f32")[deep]
        w = deep_filter(ir, J, ir.Fin(ir.BinaryPointOp(
            ir.Operator.SUBTRACT, ir.Time(), ir.Const(40.0)), ir.Time()))
        ref = native.render(w, n, sr).astype(np.float64)
        check(len(ref) == n, f"deep J={J}: the oracle gave {len(ref)} "
              f"samples, not {n}")
        scale = max(1.0, float(np.abs(ref).max()))
        for block in blocks:
            # A warm-up block first: the time is the render's, not the
            # first call's set-up.
            render(w, block, sr, precision="fast", block=block,
                   device=device)
            before = dict(kernels.launches)
            t0 = time.perf_counter()
            got = render(w, n, sr, precision="fast", block=block,
                         device=device)
            wall = time.perf_counter() - t0
            if device == "cuda":
                went = {k: kernels.launches[k] - before[k]
                        for k in (route, other)}
                check(went[route] > 0 and went[other] == 0,
                      f"deep J={J} in {block}-lane blocks launched {went}")
            check(len(got) == n and bool(np.isfinite(got).all()),
                  f"deep J={J} in {block}-lane blocks: {len(got)} samples")
            err = float(np.abs(got - ref).max()) / scale
            check(err <= DEEP_TOL, f"deep J={J} in {block}-lane blocks: "
                  f"{err:.3e} of scale from the oracle, above {DEEP_TOL}")
            rows[f"J{J}/{block}"] = dict(
                err_of_scale=err, scale=scale,
                ms_per_block=wall * 1e3 / -(-n // block))
    log(f"deep fast filters ({n} samples at {sr} Hz, {device}): "
        f"{json.dumps(rows)}")
    return rows


def deep_recurrence_bits(torch, scan_ops, device, n=DEEP_REC_N) -> None:
    """The recurrence at J = 12 on n float32 lanes, each lane the step
    from its own history (so the plain version's bits, by induction)."""
    args = recurrence_input(torch, np, np.random.default_rng(12), 12, n,
                            torch.float32, device=device)
    y, hist = scan_ops.linear_recurrence(*args)
    check(recurrence_one_step(torch, args, y, hist),
          f"linear_recurrence J=12 at {n} lanes: not the plain version's "
          f"bits")
    log(f"linear_recurrence J=12 at {n} lanes ({device}): each lane the "
        f"plain version's step")


def deep_session(torch, scan_ops, device, session=DEEP_SESSION) -> dict:
    """Four J = 12 voices that differ only in constants (one group)
    through the fast Tracker with the fused step at the session's
    sync_interval (captured inline): the mix against the sum of each
    voice's own render within phase 8's bound (no FM term); on the card
    the group's renders reach the deep scan's rows form."""
    from tuun_tpu_torch import ir
    from tuun_tpu_torch.player import build_top_level_waveform
    from tuun_tpu_torch.tracker import Tracker
    sr, block, seconds, si = session
    t = Tracker(sr, block, precision="fast", device=device,
                sync_interval=si)
    t.fuse_blocking = True
    with GroupCalls() as calls:
        for i in range(4):
            sine = ir.Sine(ir.Const(2 * math.pi * (220 + 55 * i)),
                           ir.Const(0.0))
            inner = ir.Fin(ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                                            ir.Const(seconds)), sine)
            w = deep_filter(ir, 12, inner, b=(0.05 + 0.01 * i, 0.02))
            t.play(f"deep{i}", build_top_level_waveform(w, 0.0),
                   start=37 * i)
        out = []
        while t.active or t.pending:
            out.append(t.render_block()[0])
        mix = np.concatenate([y if isinstance(y, np.ndarray)
                              else y.cpu().numpy() for y in out])
        counters = dict(blocks=len(out), replays=t.replays,
                        window_opens=t.window_opens,
                        captures=t.captures_finished)
        t.close()
        ref, mag = g2_reference(torch, np, calls.voices, block, len(mix))
    if device == "cuda":
        check(counters["replays"] > 0, f"deep session: the fused step never "
              f"replayed: {counters}")
    groups = [g[1] for g in calls.groups]
    check(len(calls.voices) == 4 and max(groups, default=0) == 4,
          f"deep session: group sizes {sorted(set(groups))} of "
          f"{len(calls.voices)} voices, not one group of 4")
    if device == "cuda":
        # The blocks rendered call by call, before the fused step engages.
        went = {k: sum(g[2][k] for g in calls.groups) for k in
                ("affine_scan_deep_rows_f32", "linear_recurrence_rows_f32")}
        check(went["affine_scan_deep_rows_f32"] > 0
              and went["linear_recurrence_rows_f32"] == 0,
              f"deep session: the group's renders launched {went}")
    err = check_mix(np, f"deep session sync_interval={si}", mix, ref,
                    g2_bound(np, ref, mag, calls.voices, 0.0))
    row = dict(counters, max_err=err, peak=float(np.abs(ref).max()))
    log(f"deep session (4 J=12 voices, {block}-sample blocks, "
        f"sync_interval {si}, {device}): {json.dumps(row)}")
    return row


def deep_times(torch, scan_ops) -> dict:
    """Single-voice times at DEEP_N lanes, at each J of DEEP_JS that the
    deep affine scan takes: the recurrence, which fast mode ran there
    before the deep scan, and the deep scan (also at T1's blocks, 65536
    and 1024 lanes); and the affine scan at J = 8 (events, device time
    alone, host us), each with its bytes bound and, for the recurrence,
    its chain model."""
    rng = np.random.default_rng(16)
    rows = {}
    for J in (J for J in DEEP_JS if J <= scan_ops.MAX_DEEP_J):
        args = recurrence_input(torch, np, rng, J, DEEP_N, torch.float32)
        fn = lambda a=args: scan_ops.linear_recurrence(*a)  # noqa: E731
        rows[f"recurrence J={J}"] = dict(
            ms=cuda_ms(torch, fn, 5),
            device_ms=graph_ms(torch, fn, calls=5, replays=2),
            host_us=host_us(torch, fn, calls=20),
            bound_ms=DEEP_N * (4 * (J + 2) + 1) / HBM_BYTES_PER_S * 1e3,
            chain_bound_ms=DEEP_N * (J + 1) * CHAIN_CYCLES["f32"]
            / SM_CLOCK_HZ * 1e3)
        for n in (DEEP_N,) + DEEP_BLOCKS:
            args = deep_input(torch, np, rng, J, n)
            fn = lambda a=args: scan_ops.affine_scan_deep_f32(*a)  # noqa
            row = dict(ms=cuda_ms(torch, fn, 50),
                       device_ms=graph_ms(torch, fn),
                       host_us=host_us(torch, fn), **deep_bound(1, n, J))
            row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
            rows[f"deep J={J} n={n}"] = row
    args = affine_input(torch, np, rng, 8, DEEP_N)
    fn = lambda: scan_ops.affine_scan_f32(*args)  # noqa: E731
    rows["affine J=8"] = dict(
        ms=cuda_ms(torch, fn, 50), device_ms=graph_ms(torch, fn),
        host_us=host_us(torch, fn),
        bound_ms=DEEP_N * (8 * 8 + 5) / HBM_BYTES_PER_S * 1e3)
    log(f"deep times at {DEEP_N} lanes: {json.dumps(rows)}")
    return rows


def corpus_files() -> list:
    root = Path(__file__).resolve().parent
    return [root / "web" / "index.html", *sorted((root / "docs").glob("*.md"))]


def tools_corpus(device, render_samples=CORPUS_SAMPLES,
                 reference=None) -> dict:
    """web_checker over web/index.html and docs/*.md, rendering every
    example (fast, render_samples at 44.1 kHz) against the native oracle:
    none fails, at least 6 pass; on the card also the same labels as the
    CPU's in this process.  With `reference` (a checkout of the reference
    system, given by --reference), also its docs/ and web/ pages: none
    fails."""
    from tuun_tpu_torch.tools import web_checker
    t0 = time.perf_counter()
    report = web_checker.check_files(corpus_files(),
                                     render_samples=render_samples,
                                     device=device)
    wall = time.perf_counter() - t0
    check(not report.failed and len(report.ok) >= 6,
          f"corpus on {device}: {len(report.ok)} ok, "
          f"{len(report.skipped)} skipped, failed {report.failed}")
    row = dict(ok=len(report.ok), skipped=len(report.skipped), failed=0,
               seconds=wall)
    if device != "cpu":
        cpu = web_checker.check_files(corpus_files(),
                                      render_samples=render_samples,
                                      device="cpu")
        check((cpu.ok, cpu.skipped, cpu.failed)
              == (report.ok, report.skipped, report.failed),
              f"corpus: {device}'s labels {report} differ from the CPU's "
              f"{cpu}")
    row["reference"] = None
    if reference is not None:
        docs = Path(reference) / "docs"
        check(docs.is_dir(), f"--reference: {docs} is not a directory")
        files = sorted(docs.glob("**/*.md")) + sorted(docs.glob("**/*.html"))
        files += sorted((Path(reference) / "web").glob("*.html"))
        ref = web_checker.check_files(files, render_samples=render_samples,
                                      device=device)
        check(not ref.failed, f"reference docs on {device}: failed "
              f"{ref.failed}")
        row["reference"] = dict(ok=len(ref.ok), skipped=len(ref.skipped))
    log(f"corpus ({render_samples} samples a block, {device}): "
        f"{json.dumps(row)}")
    return row


PROFILE_LINES = {
    "first": r"compile\+first block: ([\d.]+)s \(device=(.+)\)$",
    "steady": r"steady block: ([\d.]+) ms -> ([\d.]+) Msamples/s "
              r"\((\d+)x realtime@(\d+)\)$",
    "census": r"(?:device events|cpu operators): (\d+)/block  top: (\{.*\})$",
    "kernels": r"hand-written kernels: (\{.*\})  profiler saw: (\d+) of "
               r"(\d+)$",
    "busy": r"device busy: ([\d.]+) ms of ([\d.]+) ms wall \(([\d.]+)%\)$",
}


def parse_profile(text: str) -> dict:
    """profile.main's printed lines as numbers; every group must be
    there."""
    import re
    found = {}
    for line in text.splitlines():
        for key, pat in PROFILE_LINES.items():
            m = re.match(pat, line)
            if m:
                found[key] = m.groups()
    check(set(found) == set(PROFILE_LINES),
          f"profile: lines missing: {sorted(set(PROFILE_LINES) - set(found))}"
          f" in {text!r}")
    return dict(first_s=float(found["first"][0]), device=found["first"][1],
                steady_ms=float(found["steady"][0]),
                msamples_s=float(found["steady"][1]),
                x_realtime=int(found["steady"][2]),
                events=int(found["census"][0]),
                top=json.loads(found["census"][1]),
                launched=json.loads(found["kernels"][0]),
                profiler_saw=int(found["kernels"][1]),
                busy_ms=float(found["busy"][0]),
                wall_ms=float(found["busy"][1]))


def tools_profile(device, extra=()) -> list:
    """tools.profile.main in this process on each expression (its
    defaults: 2^17-lane blocks, 12 of them, 48 kHz): rc 0, its lines
    parse, a steady block takes time, and on the card the wrappers'
    census names the kernels the expression reaches."""
    import io
    from tuun_tpu_torch.tools import profile
    rows = []
    for expr, kernels in PROFILE_EXPRS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = profile.main(["--expr", expr, "--device", device, *extra])
        check(rc == 0, f"profile {expr!r}: exit {rc}")
        row = parse_profile(buf.getvalue())
        check(row["steady_ms"] > 0, f"profile {expr!r}: {row}")
        if device == "cuda":
            check(all(row["launched"].get(k, 0) > 0 for k in kernels),
                  f"profile {expr!r}: the census {row['launched']} lacks "
                  f"{kernels}")
        log(f"profile {expr!r} ({device}): {json.dumps(row)}")
        rows.append(row)
    return rows


def read_png(path: Path):
    """(width, height, RGB pixels) of an 8-bit RGB PNG whose rows all use
    filter 0, as scope writes them; every chunk's CRC checked."""
    import struct
    import zlib
    data = path.read_bytes()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: no PNG signature")
    pos, chunks = 8, {}
    while pos < len(data):
        (size,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + size]
        (crc,) = struct.unpack(">I", data[pos + 8 + size:pos + 12 + size])
        check(zlib.crc32(kind + body) & 0xFFFFFFFF == crc,
              f"{path}: bad CRC in {kind!r}")
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + size
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    check((depth, color) == (8, 2), f"{path}: not 8-bit RGB")
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    check(raw.size == h * (3 * w + 1), f"{path}: {raw.size} bytes of pixels")
    rows = raw.reshape(h, 3 * w + 1)
    check(not rows[:, 0].any(), f"{path}: a row filter other than 0")
    return w, h, rows[:, 1:].reshape(h, w, 3)


def tool_render(expr, seconds, opens=("std",), sr=TOOLS_SR,
                precision="fast", device="cuda"):
    """The engine's render of a Tuun expression (port front end, tempo
    120), as tests/test_instruments.py renders its programs."""
    from tuun_tpu_torch import cli, optimizer
    from tuun_tpu_torch.engine import render
    from tuun_tpu_torch.evaluator import Evaluator
    from tuun_tpu_torch.expr import ESeq
    value = Evaluator(sr, 120, cli.DEFAULT_LIBRARY).evaluate_source(
        expr, opens=opens)
    w = value.waveform.waveform if isinstance(value, ESeq) \
        else value.waveform
    return render(optimizer.optimize(w), int(seconds * sr), sr,
                  precision=precision, block=2048, device=device)


def tools_scope(device, tmp: Path, seconds=1.0) -> dict:
    """scope's --expr on SCOPE_EXPR (clipping: peak ~1.6) writes a PNG that
    decodes to the stated size with red where samples clip; its views'
    clip count equals the count in the engine's own render."""
    from tuun_tpu_torch.tools import scope
    out = tmp / "scope.png"
    rc = scope.main([str(out), "--expr", SCOPE_EXPR, "--seconds",
                     str(seconds), "--device", device])
    check(rc == 0, f"scope: exit {rc}")
    w, h, px = read_png(out)
    check((w, h) == (scope.WIDTH, 2 * scope.PANEL), f"scope: {w} x {h}")
    views = scope.scope_views(scope.render_expr(
        SCOPE_EXPR, TOOLS_SR, 120, seconds, device), TOOLS_SR)
    samples = tool_render(SCOPE_EXPR, seconds, device=device)
    clips = int((np.abs(samples) > 1.0).sum())
    red = int((px == np.array(scope.CLIP, np.uint8)).all(-1).sum())
    check(int(views["clipped"].sum()) == clips and clips > 0 and red > 0,
          f"scope: {int(views['clipped'].sum())} clipped in the views, "
          f"{clips} in the render, {red} red pixels")
    row = dict(png_bytes=out.stat().st_size, size=[w, h], clipped=clips,
               peak=views["peak"], red_pixels=red)
    log(f"scope ({device}): {json.dumps(row)}")
    return row


def tools_spectra(device, sr=TOOLS_SR) -> dict:
    """The flute and ukulele programs in fast mode on `device` held to
    tests/test_instruments.py's f0 and envelope targets, and to their CPU
    exact renders within the fast-mode envelope (phase 3's bounds)."""
    from tuun_tpu_torch.tools.spectra import estimate_f0, summarize_envelope
    rows = {}
    for name, expr, seconds, opens in INSTRUMENTS:
        y = tool_render(expr, seconds, opens, sr, "fast", device)
        ref = tool_render(expr, seconds, opens, sr, "exact", "cpu")
        f0 = estimate_f0(y, sr)
        env = summarize_envelope(y, sr)
        if name == "flute":
            # 1.75 s to a sample: the envelope's segment ends round to
            # whole samples (77176 at 44.1 kHz in both precisions and in
            # tuun_tpu's fast mode; 14000 at test_instruments.py's 8 kHz).
            check(abs(len(y) - 1.75 * sr) <= 1
                  and abs(f0 - 546) / 546 < 0.01
                  and 0.2 < env.attack_seconds < 0.45
                  and 1.6 < env.duration_seconds <= 1.8,
                  f"flute: {len(y)} samples, f0 {f0}, {env}")
        else:
            check(abs(f0 - 276) / 276 < 0.02 and env.attack_seconds < 0.1
                  and env.decay_to_half_seconds is not None
                  and env.decay_to_half_seconds < 1.0,
                  f"ukulele: f0 {f0}, {env}")
        check(len(y) == len(ref), f"{name}: {len(y)} samples, the CPU's "
              f"exact render {len(ref)}")
        stats = fast_mode_errors(y, ref.astype(np.float64))
        check_fast_mode(f"{name} ({device} fast vs CPU exact)", stats,
                        fm=False)
        rows[name] = dict(f0=f0, attack_s=env.attack_seconds,
                          decay_to_half_s=env.decay_to_half_seconds,
                          duration_s=env.duration_seconds, **stats)
    log(f"instruments ({sr} Hz, {device}): {json.dumps(rows)}")
    return rows


def phase_tools(torch, np, scan_ops, tmp: Path, reference=None) -> dict:
    """Phase 12: the deep fast filters offline and as a group, the corpus,
    profile, scope and spectra, whose launches, and only those, make each
    kernel's `tools_launches`; then the recurrence's bits at J = 12 and
    the deep times (the deep scan beside the recurrence and the affine
    scan), which the counts leave out."""
    from tuun_tpu_torch.engine import kernels
    kernels.reset_launches()
    marks = [time.perf_counter()]
    deep_offline("cuda")
    deep_session(torch, scan_ops, "cuda")
    marks.append(time.perf_counter())
    tools_corpus("cuda", reference=reference)
    marks.append(time.perf_counter())
    tools_profile("cuda")
    marks.append(time.perf_counter())
    tools_scope("cuda", tmp)
    tools_spectra("cuda")
    marks.append(time.perf_counter())
    counts = dict(kernels.launches)
    log(f"launch counts of phase 12: {counts}")
    for k in TOOLS_KERNELS:
        check(counts[k] > 0, f"kernel {k} was never launched in phase 12")
    deep_recurrence_bits(torch, scan_ops, "cuda")
    deep_times(torch, scan_ops)
    marks.append(time.perf_counter())
    log("phase 12 seconds: " + ", ".join(
        f"{name} {b - a:.1f}" for name, a, b in zip(
            ("deep filters", "corpus", "profile", "scope and spectra",
             "bits and times"), marks, marks[1:])))
    return counts


# ---------------------------------------------------------------------------
# Phase 13: the mesh paths
# ---------------------------------------------------------------------------

# M1's meshes on one card, as (voice, time): four voice shards, and two
# voice shards of two time shards each (default_mesh(4)), where G1's
# relocatable voices render lane-sharded.
MESH_SHAPES = ((4, 1), (2, 2))
# M2: tuun_tpu's dryrun at its own size.
MESH_DRYRUN_POSITIONS = 8
# M3: G2's first third at the live block (G2_PROFILE_SESSION: 8 notes an
# instrument over 0.53 s, ~50 blocks of 1024), its FM notes with a marked
# amplitude; before block MESH_MODIFY_BLOCK the first FM note still
# sounding drops to half.
MESH_SESSION = G2_PROFILE_SESSION
MESH_MODIFY_BLOCK = 12
# The exact_df group: G2's FM instrument at its 4 pitches, twice, on a
# (4, 1) mesh, in MESH_EXACT_BLOCKS blocks of 1024.
MESH_EXACT_VOICES = 8
MESH_EXACT_BLOCKS = 8
# The kernels that phase 13's meshed paths must launch: every voice shard
# renders its rows through batched_render_fn.
MESH_KERNELS = tuple(ROWS_OF.values())


def mesh_of(shape, device="cuda"):
    """A (voice, time) mesh of `shape` whose every position is one device
    (cuda:0 on the card)."""
    from tuun_tpu_torch.parallel import Mesh
    dev = "cuda:0" if device == "cuda" else device
    v, t = shape
    return Mesh([[dev] * t for _ in range(v)])


def synchronize(torch, device) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def jittered(ir, w, r: float):
    """w with every const scaled by r in float32, as g1_voices scales G1's
    consts: params_for then gives g1_voices' params exactly."""
    if isinstance(w, ir.Const):
        return ir.Const(float(np.float32(w.value) * np.float32(r)))
    return w.replace_children([jittered(ir, c, r) for c in w.children()])


def group_reference(torch, voice, bP, block: int, blocks: int, fast):
    """A meshless group's mix over `blocks` blocks from a fresh state
    (batched_render_fn's rows, summed as its mix sums them), sum |y| over
    the voices, and the largest |y|, on the host."""
    B = bP.consts.shape[0]
    fn = voice.batched_render_fn(block, fast=fast, mix=False)
    starts = torch.zeros(B, dtype=torch.int64, device=bP.device)
    e = torch.full((), block, dtype=torch.int64, device=bP.device)
    bst = voice.batched_init(bP)
    mix, mag, scale = [], [], 0.0
    for _ in range(blocks):
        rows, _, bst, _ = fn(bP, bst, starts, e)
        mix.append(rows.sum(0).cpu().numpy())
        mag.append(rows.double().abs().sum(0).cpu().numpy())
        scale = max(scale, float(rows.abs().max()))
    return np.concatenate(mix), np.concatenate(mag), scale


def counted(counts, fn, *args, **kw):
    """fn(*args, **kw) with the launch counts set to 0 just before it and
    added to `counts` just after: a meshed path's launches."""
    from tuun_tpu_torch.engine import kernels
    kernels.reset_launches()
    out = fn(*args, **kw)
    for k in counts:
        counts[k] += kernels.launches[k]
    return out


def m1_step(voice, params, mesh, device):
    """One warm G1 block on `mesh` through the path render_voices_meshed
    takes there (lane-sharded when the time axis is over 1), as a
    function."""
    from tuun_tpu_torch.parallel import VoiceShards
    shards = VoiceShards(voice, params, mesh, device)
    lane = voice.relocatable and mesh.shape["time"] > 1
    fn = shards.lane_fn(G1_BLOCK, None) if lane else \
        shards.render_fn(G1_BLOCK, G1_FAST, None)
    args = shards.args([0] * len(params), G1_BLOCK)
    state = [shards.init_states()]

    def step():
        _, _, state[0], _, _ = fn(state[0], args)
    return step, lane


def phase_m1(torch, np, scan_ops, counts, device="cuda") -> dict:
    """M1: G1's voices through render_voices_meshed, twice, on each mesh
    of MESH_SHAPES (and, with more than one card, on default_mesh() across
    the cards), G1_BLOCKS blocks, each mix held to the meshless group's
    within phase 8's G1 bound: 2 (B - 1) eps sum |y| (two summation
    orders) plus B row tolerances.  Then a block's time on each mesh
    beside the meshless group's, warm, in turns (meshless, the meshes,
    the meshes again in reverse, meshless)."""
    from tuun_tpu_torch import ir
    from tuun_tpu_torch.engine import kernels
    from tuun_tpu_torch.parallel import default_mesh, render_voices_meshed
    voice, params, bP = g1_voices(torch, np, device)
    base, _ = workload_waveform(G1_EXPR)
    waves = [jittered(ir, base, 1.0 + 0.001 * i) for i in range(G1_VOICES)]
    total = G1_BLOCKS * G1_BLOCK
    ref, mag, scale = group_reference(torch, voice, bP, G1_BLOCK, G1_BLOCKS,
                                      G1_FAST)
    eps = float(np.finfo(np.float32).eps)
    row_tol = 4 * float(np.spacing(np.float32(scale)))
    bound = 2 * (G1_VOICES - 1) * eps * mag + G1_VOICES * row_tol
    meshes = {str(s): mesh_of(s, device) for s in MESH_SHAPES}
    cards = torch.cuda.device_count() if device == "cuda" else 0
    if cards > 1:
        meshes[f"cards{cards}"] = default_mesh()
    rows = {}
    for name, mesh in meshes.items():
        walls = []
        for _ in range(2):  # the first call takes the kernels' first use
            t0 = time.perf_counter()
            mix = counted(counts, render_voices_meshed, waves, total, SR,
                          mesh=mesh, block=G1_BLOCK, device=device)
            walls.append(time.perf_counter() - t0)
        check(mix.shape == (total,) and bool(np.isfinite(mix).all()),
              f"M1 {name}: {mix.shape} samples, finite "
              f"{np.isfinite(mix).all()}")
        diff = np.abs(mix.astype(np.float64) - ref)
        check(bool((diff <= bound).all()),
              f"M1 {name}: the meshed mix differs from the meshless group's "
              f"by {diff.max():.3e} at sample {int(diff.argmax())}")
        rows[name] = dict(shape=mesh.shape, max_err=float(diff.max()),
                          bits_equal=bool(np.array_equal(mix, ref)),
                          call_walls_s=walls,
                          launches_per_block={
                              k: v / G1_BLOCKS
                              for k, v in kernels.launches.items() if v})
    fn = voice.batched_render_fn(G1_BLOCK, fast=G1_FAST)
    starts = torch.zeros(G1_VOICES, dtype=torch.int64, device=device)
    e = torch.full((), G1_BLOCK, dtype=torch.int64, device=device)
    gstate = [voice.batched_init(bP)]

    def meshless():
        _, _, gstate[0], _ = fn(bP, gstate[0], starts, e)
    steps = {"meshless": meshless}
    for name, mesh in meshes.items():
        steps[name], rows[name]["lane_sharded"] = m1_step(voice, params,
                                                          mesh, device)
    walls = {k: [] for k in steps}
    for name in list(steps) + list(steps)[::-1]:
        steps[name]()  # warm
        synchronize(torch, device)
        t0 = time.perf_counter()
        for _ in range(G1_BLOCKS):
            steps[name]()
        synchronize(torch, device)
        walls[name].append(time.perf_counter() - t0)
    audio = G1_BLOCKS * G1_BLOCK / SR
    times = {k: dict(ms_per_block=[w * 1e3 / G1_BLOCKS for w in v],
                     mix_x_realtime=audio / min(v))
             for k, v in walls.items()}
    out = dict(voices=G1_VOICES, block=G1_BLOCK, blocks=G1_BLOCKS,
               cards=cards, meshes=rows, times=times)
    log(f"mesh M1 {json.dumps(out)}")
    return out


def marked_fm(ir, w):
    """An FM note with a marked amplitude (1.0), the target of M3's
    modify: all such notes keep one structure, so they still group."""
    return ir.BinaryPointOp(ir.Operator.MULTIPLY, w,
                            ir.Marked("amp", ir.Const(1.0)))


def mesh_session(torch, waves, mesh, sync_interval: int, device="cuda"):
    """MESH_SESSION through a Tracker (meshed or not) at levels=True with
    the fused step off, FM notes amp-marked; before block
    MESH_MODIFY_BLOCK the first FM note still active drops to half.
    Returns (the mix, per block its Status.voice_levels and largest group,
    the modified id, the host seconds of each block)."""
    from tuun_tpu_torch import ir
    from tuun_tpu_torch.tracker import Tracker
    t = Tracker(SR, MESH_SESSION[0], precision="fast", device=device,
                sync_interval=sync_interval, levels=True, mesh=mesh)
    t.fuse = False
    for wid, name, expr, start in g2_notes(MESH_SESSION):
        w = waves[expr]
        t.play(wid, marked_fm(ir, w) if name == "fm" else w, start=start)
    out, levels, walls, modified = [], [], [], None
    while t.active or t.pending:
        if len(out) == MESH_MODIFY_BLOCK:
            # Still sounding: at sync_interval 4 a voice past its end may
            # not have retired yet.
            modified = next(v.id for v in t.active if v.id.startswith("fm")
                            and v.start + v.total_len > t.now)
            t.modify(modified, "amp", ir.Const(0.5))
        t0 = time.perf_counter()
        y, status = t.render_block()
        walls.append(time.perf_counter() - t0)
        out.append(y)
        levels.append((dict(status.voice_levels),
                       max((len(g.voices) for g in t._groups), default=0)))
    mix = np.concatenate([y if isinstance(y, np.ndarray)
                          else y.cpu().numpy() for y in out])
    t.close()
    return mix, levels, modified, walls


def session_bound(np, levels, n: int, tol: float, total: int):
    """Per sample of `total`, phase 8's bound on two summation orders of a
    block's voices, 2 (V - 1) eps sum |y| + tol, with sum |y| bounded by
    the per-voice peaks in the Status of the block and of the block
    before (a voice that retires in a block is gone from that block's
    Status); blocks past `levels` (silent: a deferred sync retires its
    voices later) get tol."""
    eps = float(np.finfo(np.float32).eps)
    out = np.full(max(total, len(levels) * n), tol)
    prev = {}
    for b, (lv, _) in enumerate(levels):
        voices = len({**prev, **lv})
        mag = sum(p for _, p in prev.values()) + sum(p for _, p in lv.values())
        out[b * n:(b + 1) * n] = 2 * max(voices - 1, 0) * eps * mag + tol
        prev = lv
    return out[:total]


def voiced_length(np, x) -> int:
    """The index of the last sample of x that is not exactly 0, plus 1."""
    nz = np.flatnonzero(x)
    return int(nz[-1]) + 1 if nz.size else 0


def check_mesh_mix(np, what, got, ref, got_mod, ref_mod, bound_levels,
                   n: int, tol: float):
    """M3's comparison of a meshed session's mix with the meshless one's:
    the same voice modified, the same voiced length, every sample up to
    the shorter length within session_bound, every sample past it exactly
    0.  The count of trailing silent blocks is not compared: with
    deferred sync, how many a session renders before its last voice
    retires is set by when the fetch worker's valid ends land (as in
    tuun_tpu).  Returns |got - ref| up to the shorter length."""
    m = min(len(got), len(ref))
    check(got_mod == ref_mod
          and voiced_length(np, got) == voiced_length(np, ref),
          f"M3 {what}: {len(got)} samples, voiced "
          f"{voiced_length(np, got)}, modified {got_mod}; meshless "
          f"{len(ref)}, voiced {voiced_length(np, ref)}, {ref_mod}")
    diff = np.abs(got[:m].astype(np.float64) - ref[:m])
    bound = session_bound(np, bound_levels, n, tol, m)
    check(bool(np.isfinite(got).all()) and bool((diff <= bound).all()),
          f"M3 {what}: the meshed mix differs from the meshless by "
          f"{diff.max():.3e} at sample {int(diff.argmax())}")
    check(not got[m:].any() and not ref[m:].any(),
          f"M3 {what}: a sample past the shorter length ({m}) is not 0")
    return diff


def phase_m3(torch, np, scan_ops, counts, device="cuda") -> dict:
    """M3: the meshed tracker on default_mesh(4) (two voice shards of two
    time shards) against the meshless one on MESH_SESSION at
    sync_interval 1 and 4, each with a modify and levels, held by
    check_mesh_mix to the meshless sync_interval=1 run's levels; at
    sync_interval 1 every block's levels within G2's FM tolerance of the
    meshless ones, and every rows kernel launched on the mesh at each
    sync_interval (on the card)."""
    from tuun_tpu_torch.parallel import default_mesh
    waves = g2_waveforms(g2_notes(MESH_SESSION))
    n, tol = MESH_SESSION[0], MESH_SESSION[4]
    mesh = default_mesh(4, device)
    bound_levels = None
    rows = {}
    for si in (1, 4):
        ref, ref_lv, ref_mod, ref_walls = mesh_session(torch, waves, None,
                                                       si, device)
        if si == 1:
            bound_levels = ref_lv
        before = dict(counts)
        got, got_lv, got_mod, walls = counted(
            counts, mesh_session, torch, waves, mesh, si, device)
        launched = {k: counts[k] - before[k] for k in MESH_KERNELS}
        diff = check_mesh_mix(np, f"sync_interval={si}", got, ref, got_mod,
                              ref_mod, bound_levels, n, tol)
        lv_err = 0.0
        if si == 1:
            for (a, _), (b, _) in zip(got_lv, ref_lv):
                check(set(a) == set(b), f"M3: levels of {sorted(a)} against "
                      f"{sorted(b)}")
                for vid in a:
                    lv_err = max([lv_err] + [abs(x - y) for x, y in
                                             zip(a[vid], b[vid])])
            check(lv_err <= tol, f"M3: levels differ by {lv_err:.3e}")
        if device == "cuda":
            check(all(launched.values()), f"M3 sync_interval={si}: a rows "
                  f"kernel never launched on the mesh: {launched}")
        audio = len(got) / SR
        rows[si] = dict(blocks=len(walls), voices=len(g2_notes(MESH_SESSION)),
                        max_group=max(g for _, g in got_lv),
                        modified=got_mod, max_err=float(diff.max()),
                        bits_equal=bool(np.array_equal(got[:len(diff)],
                                                       ref[:len(diff)])),
                        levels_err=lv_err, launches=launched,
                        x_realtime=audio / sum(walls),
                        meshless_x_realtime=audio / sum(ref_walls),
                        block_ms_p50=float(np.percentile(walls, 50) * 1e3),
                        block_ms_p99=float(np.percentile(walls, 99) * 1e3))
    log(f"mesh M3 {json.dumps(rows)}")
    return rows


def phase_mesh_exact(torch, np, scan_ops, counts, device="cuda") -> dict:
    """One exact_df meshed group: G2's FM voices at its 4 pitches, twice,
    on a (4, 1) mesh through render_voices_meshed, against the meshless
    group within two summation orders (2 (B - 1) eps sum |y|) plus G2's
    FM tolerance."""
    from tuun_tpu_torch.engine import CompiledVoice, EngineConfig
    from tuun_tpu_torch.engine.graph import stack_params
    from tuun_tpu_torch.parallel import render_voices_meshed
    _, template, pitches = G2_INSTRUMENTS[1]
    n, tol = MESH_SESSION[0], MESH_SESSION[4]
    waves = [workload_waveform(template.format(
        f=pitches[i % len(pitches)], d=1.0))[0]
        for i in range(MESH_EXACT_VOICES)]
    before = dict(counts)
    mix = counted(counts, render_voices_meshed, waves,
                  MESH_EXACT_BLOCKS * n, SR, mesh=mesh_of((4, 1), device),
                  precision="exact_df", block=n, device=device)
    launched = {k: counts[k] - before[k] for k in counts
                if counts[k] > before[k]}
    voice = CompiledVoice(waves[0], EngineConfig(SR, "exact_df", device))
    bP = stack_params([voice.params_for(w, seed=i)
                       for i, w in enumerate(waves)])
    ref, mag, _ = group_reference(torch, voice, bP, n, MESH_EXACT_BLOCKS,
                                  False)
    eps = float(np.finfo(np.float32).eps)
    diff = np.abs(mix.astype(np.float64) - ref) if mix.shape == ref.shape \
        else np.full(1, np.inf)
    check(bool((diff <= 2 * (len(waves) - 1) * eps * mag + tol).all()),
          f"M3 exact_df group: the meshed mix differs from the meshless by "
          f"{diff.max():.3e}")
    row = dict(voices=len(waves), blocks=MESH_EXACT_BLOCKS,
               max_err=float(diff.max()),
               bits_equal=bool(np.array_equal(mix, ref)), launches=launched)
    log(f"mesh exact_df {json.dumps(row)}")
    return row


def phase_mesh(torch, np, scan_ops, device="cuda") -> dict:
    """Phase 13: M1 (G1 through render_voices_meshed on two meshes), M3
    (the meshed tracker, and an exact_df meshed group), then M2
    (graft_entry.dryrun_multichip(8) on `device`).  Each meshed render's
    launches are counted from zero and summed into each kernel's
    `mesh_launches`; on the card every rows kernel of MESH_KERNELS must
    have launched.  The meshless references, and M2 (whose dryrun renders
    its own), are not counted."""
    from tuun_tpu_torch import graft_entry
    from tuun_tpu_torch.engine import kernels
    counts = {k: 0 for k in kernels.launches}
    marks = [time.perf_counter()]
    phase_m1(torch, np, scan_ops, counts, device)
    marks.append(time.perf_counter())
    phase_m3(torch, np, scan_ops, counts, device)
    phase_mesh_exact(torch, np, scan_ops, counts, device)
    marks.append(time.perf_counter())
    log(f"launch counts of phase 13's meshed paths: {counts}")
    if device == "cuda":
        for k in MESH_KERNELS:
            check(counts[k] > 0, f"kernel {k} was never launched in phase 13")
    dry = graft_entry.dryrun_multichip(MESH_DRYRUN_POSITIONS, device=device)
    log(f"mesh M2 {json.dumps(dry)}")
    marks.append(time.perf_counter())
    log("phase 13 seconds: " + ", ".join(
        f"{name} {b - a:.1f}" for name, a, b in zip(
            ("M1", "M3", "M2"), marks, marks[1:])))
    return counts


def log_phase(started: float, name: str) -> None:
    log(f"phase {name} done at {time.perf_counter() - started:.1f} s")


def main(argv) -> int:
    ap = argparse.ArgumentParser(description="Drives the port on one card.")
    ap.add_argument("--phase", choices=("kernels", "times", "deep", "stream",
                                        "session", "repl", "exact",
                                        "tools", "mesh", "lanes"),
                    help="kernels: stop after phase 2; times: only the "
                    "single-voice scans' times; deep: only phase 2's deep "
                    "affine scan checks and phase 12's deep times; "
                    "stream: only phase 8's "
                    "capture check, G3 and G2's streaming sessions; "
                    "session: only phase 9's live sessions and server; "
                    "repl: only phase 10's REPL; exact: only phase 11's "
                    "exact precisions; tools: only phase 12's tools and "
                    "deep fast filters; mesh: only phase 13's mesh paths; "
                    "lanes: only phase 2b's interval gates "
                    "(see the module docstring)")
    ap.add_argument("--tree", type=Path,
                    help="with --phase times: time the kernels of the "
                    "checkout at this directory")
    ap.add_argument("--profile",
                    help="NAME[,NAME...]: profile these workloads (W1, "
                    "W1:generic for the analytic Reset tiers off, ..., G1, "
                    "G1one, G2) in one profiler session and print a JSON "
                    "row each (phases 6 and 8 run them in children), or "
                    "`launches`: phase 2's one-kernel-a-call check")
    ap.add_argument("--df-streams", action="store_true",
                    help="phase 11's two-stream check of the df sum alone, "
                    "in this process (phase 11 runs it in a child), and "
                    "print its JSON row")
    ap.add_argument("--live", action="store_true",
                    help="phase 10's R2 alone, in this process (phase 10 "
                    "runs it in a child), and print its JSON row")
    ap.add_argument("--reference", type=Path,
                    help="phase 12: also check every example of the "
                    "reference system's docs/ and web/ pages in the "
                    "checkout at this directory (none by default)")
    args = ap.parse_args(argv)
    if args.tree is not None and args.phase != "times":
        ap.error("--tree needs --phase times")
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import numpy as np
    if args.tree is not None:
        scan_ops = tree_scan_ops(args.tree.resolve())
        # A checkout from before engine/kernels.py builds in scan_ops.
        kernels = getattr(scan_ops, "kernels", scan_ops)
    else:
        from tuun_tpu_torch.engine import kernels, scan_ops
    if args.live:
        print(json.dumps(r2_live()), flush=True)
        return 0
    if args.df_streams:
        print(json.dumps(df_streams(torch, np, scan_ops)), flush=True)
        return 0
    if args.profile == LAUNCH_PROFILE:
        scan_ops.load_library()
        print(json.dumps(check_one_launch(torch, np, scan_ops,
                                          np.random.default_rng(0))),
              flush=True)
        return 0
    if args.profile is not None:
        runs = []
        for spec in args.profile.split(","):
            name = spec[:-len(GENERIC)] if spec.endswith(GENERIC) else spec
            if name in GROUP_PROFILES:
                runs.append(group_profile(torch, name))
            elif name in {n for n, _ in PROFILES}:
                runs.append(workload_profile(torch, name,
                                             spec.endswith(GENERIC)))
            else:
                ap.error(f"--profile: unknown {spec!r}")
        for row in profile_session(torch, scan_ops, runs):
            print(json.dumps(row), flush=True)
        return 0

    started = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} (torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])

    t0 = time.perf_counter()
    libs = kernels.build_libraries()
    scan_ops.load_exact_library()
    scan_ops.load_library()
    build_s = time.perf_counter() - t0
    log(f"build: {', '.join(lib.name for lib in libs)} in {build_s:.1f} s "
        f"(one nvcc a source or part, at once)")
    if args.phase == "times":
        phase_times(torch, np, scan_ops, str(args.tree or "."))
        return 0
    if args.phase == "deep":
        phase_deep(torch, np, scan_ops, {k: [] for k in kernels.launches})
        deep_times(torch, scan_ops)
        log_phase(started, "2 (deep) and 12's deep times")
        return 0
    if args.phase == "stream":
        phase_capture_check(torch, np)
        phase_g3(torch, np)
        phase_g2_stream(torch, np, G2_SESSIONS[0])
        return 0
    if args.phase == "session":
        phase_session(torch, scan_ops)
        return 0
    if args.phase == "repl":
        phase_repl(torch, scan_ops, build_s)
        return 0
    if args.phase == "exact":
        check_launches_in_child()
        with tempfile.TemporaryDirectory() as tmp:
            phase_exact(torch, np, scan_ops,
                        {k: [] for k in kernels.launches}, Path(tmp))
        log_phase(started, "11")
        return 0
    if args.phase == "tools":
        with tempfile.TemporaryDirectory() as tmp:
            phase_tools(torch, np, scan_ops, Path(tmp), args.reference)
        log_phase(started, "12")
        return 0
    if args.phase == "mesh":
        phase_mesh(torch, np, scan_ops)
        log_phase(started, "13")
        return 0
    if args.phase == "lanes":
        phase_lanes(torch, np, scan_ops)
        log_phase(started, "2b")
        return 0

    results = {k: [] for k in kernels.launches}
    phase_kernels(torch, np, scan_ops, results)
    phase_noise(torch, np)
    phase_sin(torch)
    log_phase(started, "2")
    if args.phase == "kernels":
        return 0
    lanes = phase_lanes(torch, np, scan_ops)
    log_phase(started, "2b")

    # The launches of the main path, and only those, make the counts.
    kernels.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        summary = phase_main_path(torch, np, scan_ops, Path(tmp))
        counts = {k: kernels.launches[k]
                  for k in tuple(ROWS_OF) + LANE_KERNELS}
        # The deep scan's path is phase 12; the main path reaches it only
        # through a filter deeper than MAX_J (none of its workloads).
        deep_main = {"affine_scan_deep_f32":
                     kernels.launches["affine_scan_deep_f32"]}
        log(f"launch counts of the main path (phase 3): {counts}, "
            f"{deep_main}")
        log(f"memory after the CLI runs {json.dumps(graph_memory(torch))}")
        log_phase(started, "3")
        for k, c in counts.items():
            check(c > 0, f"kernel {k} was never launched on the main path")
        phase_cross_device(torch, np, Path(tmp))
    kernels.reset_launches()
    summary.append(phase_engine(torch, np))
    log_phase(started, "4-5")
    log(f"launch counts of W4 (phase 5, not in the kernels line): "
        f"{dict(kernels.launches)}")
    log("x realtime (warm): " + ", ".join(f"{n} {x:.1f}" for n, x in summary))
    phase_profiles()
    log_phase(started, "6")
    phase_reloc_fast(torch)
    log_phase(started, "7")

    # Phase 8, the voice groups: the path of the voices x lanes forms,
    # whose launches, and only those, make their counts.
    kernels.reset_launches()
    phase_g1(torch, np)
    for session in G2_SESSIONS:
        phase_g2(torch, np, scan_ops, session)
    log_phase(started, "8, G1 and G2")
    phase_g2_stream(torch, np, G2_SESSIONS[0])
    log_phase(started, "8, G2 streaming")
    phase_g3(torch, np)
    log_phase(started, "8, G3")
    phase_capture_check(torch, np)
    log_phase(started, "8, capture check")
    counts.update({k: kernels.launches[k] for k in ROWS_OF.values()})
    deep_main["affine_scan_deep_rows_f32"] = kernels.launches[
        "affine_scan_deep_rows_f32"]
    log(f"launch counts of the voices x lanes forms (phase 8): "
        f"{ {k: counts[k] for k in ROWS_OF.values()} }, {deep_main}")
    for k in ROWS_OF.values():
        check(counts[k] > 0, f"kernel {k} was never launched by the groups")
    profile_in_child(list(GROUP_PROFILES))
    launches_in_process(torch, np, scan_ops)
    log_phase(started, "8, profiles")
    session = phase_session(torch, scan_ops)
    log_phase(started, "9")
    repl = phase_repl(torch, scan_ops, build_s)
    log_phase(started, "10")
    with tempfile.TemporaryDirectory() as tmp:
        exact = phase_exact(torch, np, scan_ops, results, Path(tmp))
    log_phase(started, "11")
    with tempfile.TemporaryDirectory() as tmp:
        tools = phase_tools(torch, np, scan_ops, Path(tmp), args.reference)
    log_phase(started, "12")
    mesh = phase_mesh(torch, np, scan_ops)
    log_phase(started, "13")

    kernel_rows = []
    for k in SCAN_KERNELS:
        rows = results[k]
        affine = k.startswith("affine")
        # The main path's shape: MAIN_N lanes (J = 2, lpf, for the affine
        # scan), B = 32 voices for the voices x lanes forms.  Bytes each
        # input read once, each output written once (the affine scan: a,
        # ff and live in, y out, 4J + 9 a lane).
        main_row = next(r for r in rows if r["n"] == MAIN_N
                        and r.get("J", 2) == 2)
        lane_bytes = 4 * 2 + 9 if affine else 8
        kernel_rows.append({
            "name": k, "route": "cuda",
            "source": "tuun_tpu_torch/csrc/scan.cu",
            "replaces": REPLACES[k], "launches": counts[k],
            "session_launches": session[k],
            "repl_launches": repl[k],
            "exact_launches": exact[k],
            "tools_launches": tools[k],
            "mesh_launches": mesh[k],
            "max_abs_err": max(r["err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "device_ms": main_row["device_ms"],
            "plain_device_ms": main_row["plain_device_ms"],
            "host_us": main_row["host_us"],
            "bound_ms": main_row.get("B", 1) * lane_bytes * MAIN_N
            / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            # The plain versions of the prefix scans are single PyTorch
            # calls (torch.cumsum, torch.cummax along the lanes); no
            # single call computes the affine scan.
            "library_ms": None if affine else main_row["plain_ms"]})
    kernel_rows += exact_kernel_rows(results, exact, tools, mesh)
    for k in LANE_KERNELS:
        # The timed case of each: the engine's commonest gate, the mask.
        t = lanes["times"][0 if k == "interval_gate" else -1]
        kernel_rows.append({
            "name": k, "route": "cuda",
            "source": "tuun_tpu_torch/csrc/lanes.cu",
            "replaces": "none (XLA fused the JAX engine's interval masks)",
            "launches": counts[k], "session_launches": session.get(k),
            "repl_launches": repl.get(k), "exact_launches": exact.get(k),
            "tools_launches": tools.get(k), "mesh_launches": mesh.get(k),
            "max_abs_err": 0.0, "rows": t["rows"], "n": t["n"],
            "device_ms": min(t["device_ms"]),
            "plain_device_ms": min(t["chain_ms"]),
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": None})
    kernel_rows += deep_kernel_rows(results, dict(
        main=deep_main, session=session, repl=repl, exact=exact,
        tools=tools, mesh=mesh))
    log(f"elapsed: {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
