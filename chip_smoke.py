#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's batched decode, encode and transcode paths,
its workloads, its serving frontend and its LM serving and training paths
(every family) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--src DIR]

Run from the root of a checkout; it builds the CUDA kernels from
``src/repro_torch/kernels/csrc`` on first use.  ``--src`` drives the
``repro_torch`` of another checkout's ``src`` with this script's checks
(e.g. a parent commit, to compare kernels on one card; their outputs'
digests below must then match).  Phases, one JSON line each:

  1. device — the card (and, on its own line, ``nvidia-smi``'s name and
     power limit); fails when no CUDA device is present;
  2. build  — the ``nvcc`` build of the kernel library, in seconds;
  3. data   — per archival domain, tables calibrated on a 2**18-sample
     strip, and 4 distinct 2**18-sample signals host-encoded per plan key
     for 8 plan keys (the four domains in v2, plus v3 with delta or
     linear2 prediction and zero planes), replicated to 128 containers per
     key: 1024 containers, 2**28 samples, 1 GiB of f32 output in 8 buckets;
     plus one layer's K cache of an 8B-class model (batch 8 x 8 KV heads x
     128 head dims at 4096 tokens), encoded to fixed-rate levels
     u8[8192, 256, 16] by ``BatchEncoder().encode_fixed`` (K5);
  4. check  — every CUDA kernel against its plain PyTorch version on the
     card, at the main paths' shapes: K1's symbols and the v3 stage's levels
     exactly, the LUT-iDCT's and K3's floats within ``max|d| <= 1e-5 *
     max|plain|``; then K2 as a whole (its three kernels in a row); the
     v3 stage also on one full-size synthetic bucket per archive v3 width
     (2**20 windows, linear2, 2 and all bands predicted) whose segments
     stress its tiled scan (``adversarial_v3``), exactly.  The
     encode kernels at one archive bucket per plan key (128 rows of 2**18
     samples) and K5 on the KV block: with an identity basis (the
     coefficients are the inputs) ``encode_levels``' and ``dct_quant``'s
     outputs exactly; with the DCT basis the flip rule — the kernels sum the
     DCT in another order than the plain cuBLAS product, so a level may
     differ by exactly 1, in at most 1e-5 of the cells, before prediction;
     ``symlen_pack`` fed the plain grid: every output exactly, and in exact
     mode (one chunk per row) on each bucket's distinct rows, each row's
     words and sidecar equal to the host packer ``pack_symlen_np`` of its
     valid symbols; ``symlen_pack`` on the adversarial layouts of
     ``tests/_pack_layouts.py`` at archive shape (128 rows x 8192 windows,
     the archive's e by turns), at chunks 1, 63, 1000, 1024 and 4097
     against the plain version exactly, and in exact mode (4 rows) against
     Algorithm 1 of each row's valid symbols;
     K6's whole tile (``huffman_decode_tile``) on each archive bucket
     exactly, and compacted (``compact_padded_scatter``) equal to K1's dense
     output; K1 and K6 on the adversarial layouts of
     ``tests/_symlen_layouts.py`` (each l_max of 1, 2, 8, 12, 13 and 16
     under each layout, at enough words that every warp of K1 walks more
     than 4 tiles; K1 at num_symbols below, at and past the
     total) against the plain versions exactly, and K6 compacted equal to
     K1; the decode table both run on, built on the card for every l_max
     in [1, 16] (three codes each), equal to the plain table entry by
     entry; ``encode_levels_gather`` on one bucket per plan key, its rows
     gathered from that bucket's decoded windows, equal to
     ``encode_levels`` on the materialized rows exactly, with the DCT and
     the identity basis; the DCT + quantize layouts of
     ``tests/_levels_layouts.py`` at archive width (8192 + 3 windows a row,
     each archive (n, e) under v2, delta and linear2 with zero planes, and
     linear2 on every band; counts ending mid-block, mid-window and 0;
     gather starts off a 16-byte boundary, lens of 0, mid-window and the
     full width, shared runs; enough rows that every persistent CTA walks
     more than 4 tiles): ``encode_levels`` with the identity basis
     exactly and the DCT basis by the flip rule (and every row without a
     flipped level exactly), ``encode_levels_gather`` equal to
     ``encode_levels`` on the gathered rows bit for bit; K5 on (16, 16)
     layouts from an aligned start and from one sample on.  Every level in
     every band (levels [256, E], row r level r; the basis [I_E | 0], so
     the output's first E columns are the dequant table): the LUT-iDCT
     equal to each archive plan's LUT exactly, K3 within the float bound of
     the plain ``dequantize`` for the KV table and each archive plan's.
     The check line carries a ``sha256`` of each archive bucket's K1
     output, K6 tile and ``lut_idct`` output, of K3's KV output and of its
     every-level tables, of each archive bucket's ``encode_levels``
     outputs (grid, zrow, zcol, ncoded, DCT basis), of each gather
     bucket's, and of K5's KV levels, so that a later build of these
     kernels can be compared byte for byte;
  5. main   — with every launch counter set to 0: ``BatchDecoder().decode
     (archive).to_host()`` and ``decode_fixed`` of the KV block, then the
     counters (K2's ``symlen_decode`` and ``lut_idct`` once per bucket,
     ``v3_unpredict`` once per v3 bucket, K3's ``idct_dequant`` once), and
     the decoded signals against the host reference ``codec.decode``;
  6. encode — with every launch counter set to 0: ``BatchEncoder().encode
     (the archive's 1024 signals, 1 GiB of f32).to_host()`` and
     ``encode_fixed`` of the KV block, then the counters (``encode_levels``
     and ``symlen_pack`` once per bucket, ``dct_quant`` once); the
     containers decoded by ``BatchDecoder`` against the host decode of
     their host-encoded twins wherever no level flipped, and exact mode
     (``chunk_size=None``) on the 32 distinct signals byte for byte against
     the host encoder;
  7. staged — with every launch counter set to 0: the staged decode (K6's
     tile, then ``compact_padded_scatter``) of every archive bucket, the
     path on which K6 holds K1; its symbols against K1's;
  8. transcode — with every launch counter set to 0: ``Transcoder()`` over
     the whole archive in one call, each container to its twin coding (id
     d <-> d + 4: v2 -> v3 and v3 -> v2 in one batch), ``transcode()``
     under ``torch.cuda.set_sync_debug_mode("error")``; the drained bytes
     against ``BatchEncoder().encode(BatchDecoder().decode(archive)
     .to_host())`` on the card; the counters (``symlen_decode`` and
     ``lut_idct`` once per decode bucket, ``v3_unpredict`` once per v3
     source bucket, ``encode_levels_gather`` and ``symlen_pack`` once per
     encode bucket, ``encode_levels`` never); then the 512 v2 signals
     encoded on the card and transcoded to v3 as an ``EncodedBatch``,
     against draining and transcoding the containers; and
     ``codec.transcode`` of one container against the host round trip
     ``encode(decode(c))`` where no level flipped (the flip rule above);
     the main, encode and transcode lines carry a ``sha256`` of their
     drained results;
  9. workloads — (``workloads_phase()``) one layer of granite-8b.  The
     KV codec: the data phase's K cache as a bf16 ``[8, 4096, 8, 128]``
     block, ``KVCacheCodec.calibrate`` on it, ``compress`` levels equal to
     ``encode_fixed`` of the same channel rows under the same tables
     exactly, ``decompress`` within the KV block's relative-rms bound, then
     (after that warm call) one ``compress`` and one ``decompress`` under
     ``torch.cuda.set_sync_debug_mode("error")`` with every launch counter
     set to 0: one ``dct_quant`` and one ``idct_dequant``; CUDA-event ms of
     both beside K5's, K3's and the two transpose copies'.  The
     checkpoint: one decoder layer's training state on the card (q, k, v,
     o, gate, up, down and two norms, with Adam m and v, f32, and an int32
     counter: 218.1 M parameters, 654 M f32 elements) through
     ``save_checkpoint(compress=True)`` and ``restore_latest`` with every
     launch counter set to 0 before each: the manifest (v2, one
     ``state.fptc``, the counter raw), every leaf back on the card within
     relative rms 0.02, the blob under 0.8 of the float bytes,
     ``encode_levels`` and ``symlen_pack`` once per encode bucket and
     ``symlen_decode`` and ``lut_idct`` once per decode bucket, every call
     of the four (recorded where the engines call them) against its plain
     version by the serve phase's rules, each kernel's ms and bound at
     n = e = 64, l_max 12, and the save and restore walls split into
     their steps;
 10. serve  — the port's ``ServingFrontend`` on the card, under the
     reference's serving setup: ``build_domain_tables()`` (the four paper
     domains), the mix decode 0.6 / encode 0.3 / transcode 0.1, log-normal
     sizes (median 16 windows, sigma 0.75, clip 256), SLO 250 ms, flush
     slack 50 ms, ``max_batch`` 64, queue bound 1024; the engines warmed
     as the reference warms them (``warm_lattice``: per (domain, kind) of
     a 0.5 s stream at 800 requests/s, one engine call at every policy
     edge up to the fill target).  (a) with every launch counter set to 0, a 400
     requests/s stream for 2 s: every response equal to
     ``offline_expected`` (the offline engines on the card) — samples bit
     for bit, containers byte for byte — nothing shed, expired or failed,
     and ``symlen_decode`` / ``lut_idct`` launched once per decoder bucket,
     ``symlen_pack`` and ``encode_levels`` + ``encode_levels_gather`` once
     per encoder bucket (the engines' own ``stats.dispatches``), each of
     the five at least once, no other kernel; and every call the engines
     made of the five wrappers in that run (its inputs and output cloned
     where the engines call it) against its plain version on the same
     inputs, by the check phase's rules: K1's symbols and the pack's
     outputs exactly, ``lut_idct`` within ``REL_TOL``, ``encode_levels``
     and its gather arm by the flip rule outside the deadzone class
     ``DEADZONE`` (a cell in it on both sides within 2 levels: the
     transcoder's re-encode of a decoded level 128 is zero but for float
     noise, whose sign picks 127 or 129) — the oracle above runs the same
     kernels, so it alone could not see a kernel fault at the serving
     shapes; (b) the load sweep, arms
     ``microbatch`` (``max_batch`` 64) and ``batch1`` (``max_batch`` 1),
     at 25-800 requests/s for 2 s each and doubling past 800 while the
     arm sustains (cap 6400), each ``microbatch`` point replayed once
     through a fresh frontend before its timed replay, as the reference
     does (its summary kept as ``cold``): p50/p95/p99 sojourn ms, achieved
     requests/s, shed, batches, mean batch size, fill and deadline
     dispatches and the deadline share, deadline misses, p50/p99 of each
     request's admission lag (scheduled arrival to the return of its
     submit) and flush-to-result time, and each arm's
     knee (the highest load with p99 within the SLO, nothing shed, every
     admitted request completed; ``microbatch``'s also on the cold
     passes) — printed, not checked;
     then the overload point: decode at 2000 requests/s for 0.5 s (8
     windows, ``max_batch`` 8, queue bound 16), the rate doubled until it
     sheds (cap 32000), every admitted request completed at each rate and
     the last one shedding; (c) chaos: 2400 requests/s for 2 s (8 windows, domains 2
     and 3), 5% of the containers corrupted, transient faults, a device
     loss and latency injected, every outcome typed, nothing hung or
     dropped, every clean result equal to the offline engines; one hung
     dispatch cut by the watchdog resolves as ``DispatchFailedError`` and
     the frontend serves on; (d) the HTTP service (``launch.serve``'s
     server on 127.0.0.1, port 0): encode, the decode of its answer and a
     transcode equal to the offline engines, one corrupt blob per
     ``CONTAINER_FAULTS`` class answered 422 with its expected fault
     class, 400s and a 404, ``/healthz`` and ``/statz``;
 11. times  — per kernel, CUDA-event ms after warm-up beside the plain
     version's ms and the card's bound for the same work; per encode
     bucket (``k4_by_bucket``) ``encode_levels``' ms and bound beside
     ``symlen_pack``'s, chunked and exact; and per kernel the CUDA kernels
     one wrapper call puts on the card (``grids_per_call``), counted by
     ``torch.profiler`` over one call on the first bucket that runs it.

 12. tune   — (``tune_phase()``; skipped under ``--src``, whose port may
     predate it; last, so that the phases before it, the times among
     them, run in the process state they ran in before the phase was
     added) the host's copy of the launchers' tile rules
     (``kernels/tiles.py``) against the built library's at every (E, N)
     from 1 to 128 and every register tile, and every v3 tile at every
     E; with a fresh ``TuningCache`` in a temporary directory,
     ``tune_decode_bucket`` on one v2 and one v3 archive bucket and
     ``tune_encode_bucket`` on one archive encode bucket: every candidate
     launch shape's CUDA-event ms beside the cost model's prediction, its
     outputs' ``sha256`` equal to the kernels' own picks', the winner
     beside the pick; every archive bucket under every legal shape equal
     to its pick on the card (``lut_idct``, the v3 stage,
     ``encode_levels``); then that cache as the default, with a shape other
     than the pick stored under every other key the engines consult: the
     archive decode, encode and transcode with the main, encode and
     transcode phases' ``sha256`` and launch counts, and the cache hit;
     then cold again: the decode and encode under ``policy=
     "cost-balanced"`` with ``p2``'s digests, decode, encode and transcode
     over ``devices=(cuda:0, cuda:0)`` with one shard's (the encoder's
     ``stats.dispatches`` twice one shard's), and a new bucket shape's
     first call less its warm call (``compile_cost_s``), on slices of one
     plan key.
 13. lm     — (``lm_phase()``; skipped when the driven port has no
     ``repro_torch.models``; after the tune phase, so that every earlier phase
     measures in the process state it had before; the model freed before the
     kernels line) granite-8b at full width (36 layers, d 4096, 32 / 8 heads of
     128, d_ff 14336, vocab 49152; 8.25 G bf16 parameters drawn on the card
     from ``--seed``), with bf16 reduced-precision reductions off and TF32
     off, batch 8 x 4096 random prompt tokens, 32 greedy tokens, through
     ``family_run`` (phase 15 lists what it holds and prints): 72
     ``dct_quant`` and 72 ``idct_dequant`` launches on the model's K and V
     ``[8, 4096, 8, 128]`` blocks.
 14. train  — (``train_phase()``; skipped when the driven port has no
     ``repro_torch.distributed.optimizer``) granite-8b at full width with its
     depth cut to 2 layers (838.9 M bf16 parameters drawn on the card from
     ``--seed``, fp32 Adam m and v: an 8.39 GB state; the cut keeps the
     state's compressed save and restore near a minute each), batch 2 x 4096
     tokens from ``TokenPipeline``, TF32 and bf16 reduced-precision reductions
     off, ``make_train_step`` (remat per layer, AdamW at ``TRAIN_OPT``).
     Held: (a) run A, four steps from the seed's weights: every loss and grad
     norm finite; (c) run B from the same weights: steps 0-1, then with every
     launch counter at 0 ``save_checkpoint(compress=True)`` of
     ``train_state_tree`` (the reference's ``{"params", "m", "v"}`` layout),
     the live weights, m and v overwritten with NaN, ``restore_latest``,
     ``load_train_state`` (``AdamW.project`` lifts the v the lossy blob
     brought back negative) and steps 2-3: the manifest v2 with one
     ``state.fptc``, the bf16 weights raw and bit-equal, every compressed
     leaf within relative rms ``TRAIN_CKPT_GUARD`` (a guard against a broken
     codec; each leaf's and the state's printed against the reference's
     0.02, which this real state meets at most leaves only),
     ``encode_levels`` and ``symlen_pack`` once per encode bucket and
     ``symlen_decode`` and
     ``lut_idct`` once per decode bucket (one engine call per 2**30 samples:
     ``workloads.engine_calls``), every call of the four timed by CUDA events
     and held at once against its plain version by the serve phase's rules
     (``ckpt_kernels_held``), and B's step-3 loss within ``TRAIN_RESUME_TOL``
     of A's; (b) from the same weights, 8 steps on one repeated batch: the
     last loss below the first; (d) the smoke granite drawn on the CPU, 3
     steps there and 3 on the card: the losses within
     ``TRAIN_CARD_CPU_LOSS_TOL`` and the weights' change within
     ``TRAIN_CARD_CPU_CHANGE_TOL``.  Printed: step ms by CUDA events (steps
     1-3 of run A) beside the step's bound (``train_bound``), one more step
     under ``torch.profiler``, peak memory in the steps, the save and the
     restore, the save and restore walls split into their steps (with and
     without the in-line checks), the blob's bytes against the float bytes,
     and each checkpoint kernel's ms (warm, and its path call's own) and
     bound at the train state's shapes.
 15. families — (``families_phase()``; skipped when the driven port has no
     ``repro_torch.models.ssm``) the MoE, MLA, hybrid, RWKV and
     encoder-decoder families, one model at a time, each freed before the
     next, TF32 and bf16 reduced-precision reductions off, weights drawn on
     the card from ``--seed`` (``FAMILIES``): deepseek-v3 at full width
     cut to 4 layers (3 dense, 1 MoE of 256 experts, top 8, and the shared
     expert; 15.1 G parameters), batch 2 x 4096; llama4-scout at full
     width cut to 4 layers (16 experts, top 1, and the shared expert; 10.9
     G), batch 8 x 4096; hymba-1.5b whole (32 layers), batch 8 x 2048,
     twice its 1024-token window, so the ring wraps; rwkv6-3b whole (32
     layers, 40 heads of 64; 3.07 G), batch 8 x 512 (the prompt cut:
     ``FAMILIES``); whisper-tiny whole
     (4 + 4 layers), batch 32 x 64 tokens over 1500 frames drawn N(0, 1)
     from the seed; 32 greedy tokens each.  For each model (``family_run``,
     as for granite in phase 13): finite logits; prefill ms and decode ms a
     token by CUDA events after a warm call, 12 generated ids of 4 rows,
     beside their bounds (``family_bounds``: the matmuls as the port
     computes them, a MoE layer's experts at E x C slots with the routed T
     x k pairs beside them, at 989 TFLOP/s bf16, RWKV's wkv recurrence at
     67 TFLOP/s fp32; decode at the bytes read once, all experts and the
     experts a step routes to, RWKV's state read and written, whisper's
     cross cache read); one prefill and one decode step under
     ``torch.profiler``; peak memory; the (token, k) pairs each MoE layer
     dropped in each call; the last token's logits of ``prefill(S)``
     against ``prefill(S - 1)`` + ``decode_step`` within
     ``LM_CONSISTENCY_TOL`` (the hybrid within ``HYBRID_CONSISTENCY_TOL``);
     the model's own cache through ``serve_lm.compress_cache``
     (``family_kv``) with every launch counter at 0: one K5 and one K3
     launch a block (MLA's ``ckv``/``kr`` latents, the k/v caches, the
     hybrid's ring over its valid slots, whisper's self k/v and its cross
     ck/cv over their 93 whole windows of 1500 frames: 8 + 8, 8 + 8, 64 +
     64 and 16 + 16; RWKV's state has no block and none), each held at once
     against its plain version (K5's levels exactly, K3 within
     ``REL_TOL``), the cache's bytes before and after, the states, the
     slots past S and a cross block's 12 raw slots untouched, one decode
     step on the restored cache within ``LM_DRIFT_TOL`` (the same with one
     table per key calibrated on layer 0 is reported, not held), the
     codec's ms on one block; the model's smoke config built on the CPU,
     prefill + 4 decode steps there and, moved to the card, on the card,
     within ``LM_CARD_CPU_TOL``.
 16. families_train — (``families_train_phase()``; skipped unless the
     driven port trains whisper-tiny, ``port_trains``: its ``launch.train``
     has no ``untrained`` or ``untrained(get_arch("whisper-tiny"))`` is
     empty) the MoE, MLA and encoder-decoder families trained at full
     width, one model at a time, each freed before the next, TF32 and bf16
     reduced-precision reductions off, weights drawn on the card from
     ``--seed``, ``make_train_step`` at ``TRAIN_OPT`` (``FT_RUNS``):
     whisper-tiny whole (4 + 4 layers, 72.7 M parameters), batch 16 x 448
     tokens (Whisper's decoder length) over 1500 frames drawn N(0, 1) from
     the seed; deepseek-v3 cut to its first 2 layers (both dense MLA
     layers; 3.60 G), batch 2 x 2048; llama4-scout cut to 1 MoE layer (16
     experts, top 1, the shared expert; 4.27 G), batch 2 x 2048.  For each
     (``family_train_run``): run A's four steps (every loss and grad norm
     finite; each step's MoE dropped pairs), step ms by CUDA events (steps
     1-3) beside ``train_bound``, one more step under ``torch.profiler``,
     peak memory, 8 steps on one repeated batch (the last loss below the
     first).  whisper-tiny also run B, phase 14's resume through a
     compressed checkpoint after step 1 (``compressed_resume``: every K4
     and K1 / ``lut_idct`` call held at once against its plain version, the
     launch counts, every raw leaf bit for bit, every compressed leaf
     within ``TRAIN_CKPT_GUARD``), B's step-3 loss within
     ``TRAIN_RESUME_TOL`` of A's, printed beside step 3's own change.
     llama4-scout also, before its m and v exist, one batch's gradients
     with remat on, on again and off (``grads_twice``): the losses bit for
     bit, every leaf within ``FT_REPEAT_TOL``, and each MoE layer's
     ``dropped`` and ``experts_hit`` the same in every forward, the
     recomputed ones included (``MoeStatsLog``).  Then the smoke
     deepseek-v3 (MLA + MoE) and whisper-tiny, 3 steps on the CPU and on
     the card (``smoke_card_vs_cpu``, as phase 14's granite), and the
     smoke deepseek-v3's compressed resume on the card (``smoke_resume``:
     its expert stacks' m and v through K4 and K1 / ``lut_idct``).
 17. scan_train — (``scan_train_phase()``; skipped unless the driven port
     trains rwkv6-3b and hymba-1.5b, ``port_trains``) the hybrid SSM and
     RWKV families trained at full width, as phase 16 trains its models
     (``family_train_run``; ``ST_RUNS``): hymba-1.5b (d 1600, 25 / 5 heads
     of 64, d_ff 5504, window 1024, Mamba d_in 3200, N 16, vocab 32001)
     and rwkv6-3b (d 2560, 40 heads of 64, d_ff 8960, vocab 65536), each
     cut to 4 of its 32 layers, batch 2 x 2048 tokens: 16 chunks of each
     scan, each chunk checkpointed (``ssm.chunk_remat``) inside its
     checkpointed layer.  For each: one batch's gradients with the layer
     and chunk remat on, on again, and both off (``grads_twice``): losses
     and every leaf bit for bit, each pass's peak memory above its start;
     run A's four steps (finite), step ms by CUDA events beside
     ``train_bound`` (the recurrences' fp32 operations at 67 TFLOP/s in
     five passes, ``recurrence_ops``) and each step's time in Python's
     collector (``gc_cost``), one step under ``torch.profiler`` at 2 x
     ``ST_PROFILE_SEQ`` on the same weights (its own CUDA-event ms beside
     it), peak memory, ``ST_MEMO_STEPS`` steps on one repeated batch (the
     last loss below the first).  hymba-1.5b also run B, the compressed
     resume after step 1 (``compressed_resume``): its fp32 SSM weights
     (``A_log``, ``D``, ``dt_bias``) raw and bit-equal as every weight is
     (``convert.save_train_state``), their m and v among the compressed
     leaves, each named with its relative rms; B's step-3 loss within
     ``TRAIN_RESUME_TOL`` of A's.
     Then the smoke hymba and rwkv6-3b at 2 x 256, 3 steps on the CPU and
     on the card (``smoke_card_vs_cpu``), so both sides take the chunked
     path.

 18. mesh_train — (``mesh_train_phase()``; skipped when the driven port
     has no ``repro_torch.launch.mesh``) the multi-device layer's ``pod``
     and ``data`` axes on two spawned ranks of the one card, both on
     ``cuda:0`` in a gloo group (NCCL takes one rank a device; gloo moves
     CUDA tensors itself, ``MT_WIRE``), TF32 and bf16 reduced-precision
     reductions off, granite-8b's width cut to 2 layers (phase 14's
     cell), a global batch of 2 x 4096 from ``TokenPipeline``, one row a
     rank.  (a) In the parent first, the one-process oracle
     (``pod_oracle``: each replica's gradients in turn, ``replica_sum``
     on the stacked tree of the reference's leaves, ``AdamW.update``),
     freed; then ``pod`` 2, ``truncate_int8``, 3 steps on the ranks
     (``mesh_pod_run``): losses,
     every weight and every residual bit for bit the oracle's (sha256 a
     leaf); the wire bytes a step against f32, the compressor's and its
     collectives' ms, step ms against ``train_bound``, peak memory.  (b)
     FSDP over ``data`` 2, 4 steps (``mesh_fsdp_run``): the losses (steps
     1-3) and every step's grad norm within ``LM_CARD_CPU_TOL`` of phase
     14's run A, each rank's parameters, m and v about half the state;
     after step 1 the state gathered whole and saved compressed by rank
     0, every K4 call held at once to its plain version.  (c) In the
     parent, a one-rank group and mesh (``mesh_resume``):
     ``restore_latest`` (K1 and ``lut_idct`` held), ``remesh``,
     ``load_train_state``, steps 2-3; step 3 within ``TRAIN_RESUME_TOL``
     of (b)'s.  A failed rank fails the phase.

Then the ``{"kernels": [...]}`` line (K5's and K3's entries also carry
the LM path's launches, ``lm_launches``, and the families phase's,
``families_launches``; the four checkpoint kernels' the
train phase's, ``train_launches`` and ``train_max_abs_err``, the
families train phase's, ``families_train_launches`` and
``families_train_max_abs_err``, the scan train phase's,
``scan_train_launches`` and ``scan_train_max_abs_err``, and the mesh
train phase's, ``mesh_train_launches`` and ``mesh_train_max_abs_err``),
and last
``{"ok": true, "device": ...}``.  Any failed check exits non-zero before
the last line.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the card's published peaks (H100 SXM data sheet): device-memory rate and
# fp32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
REL_TOL = 1e-5  # floats: max|kernel - plain| <= REL_TOL * max|plain|
FLIP_SHARE = 1e-5  # DCT basis: at most this share of levels one level off
# the quantizer's deadzone class: a coefficient that is zero but for float
# noise (a decoded level 128's re-encode) lands on 127, 128 or 129 by the
# noise's sign, so two summation orders may put it up to 2 levels apart
DEADZONE = (127, 128, 129)

ARCHIVAL = [  # (domain, dataset, v3 predictor)
    ("biomedical", "mitbih", "delta"),
    ("seismic", "seismic", "delta"),
    ("power", "load_power", "linear2"),
    ("meteorological", "temperature", "linear2"),
]
# the CUDA kernels, each under its launch counter's name: K1's decode (also
# K2's first stage), K2's two later stages, K3, K4's two stages, and K5
SOURCES = {
    "symlen_decode": ("src/repro_torch/kernels/csrc/symlen_decode.cu",
                      "src/repro/kernels/huffman_decode.py:297"),
    "v3_unpredict": ("src/repro_torch/kernels/csrc/decode_fused.cu",
                     "src/repro/kernels/decode_fused.py:305"),
    "lut_idct": ("src/repro_torch/kernels/csrc/decode_fused.cu",
                 "src/repro/kernels/decode_fused.py:305"),
    "idct_dequant": ("src/repro_torch/kernels/csrc/idct_dequant.cu",
                     "src/repro/kernels/idct_dequant.py:104"),
    "encode_levels": ("src/repro_torch/kernels/csrc/encode_fused.cu",
                      "src/repro/kernels/encode_fused.py:283"),
    "symlen_pack": ("src/repro_torch/kernels/csrc/encode_fused.cu",
                    "src/repro/kernels/encode_fused.py:283"),
    "encode_levels_gather": ("src/repro_torch/kernels/csrc/encode_fused.cu",
                             "src/repro/kernels/encode_fused.py:283"),
    "dct_quant": ("src/repro_torch/kernels/csrc/dct_quant.cu",
                  "src/repro/kernels/dct_quant.py:123"),
    "symlen_tile": ("src/repro_torch/kernels/csrc/symlen_tile.cu",
                    "src/repro/kernels/huffman_decode.py:359"),
}
# the path whose launch counts each kernel's entry reports
PATH_OF = {"symlen_decode": "main", "v3_unpredict": "main",
           "lut_idct": "main", "idct_dequant": "main",
           "encode_levels": "encode", "symlen_pack": "encode",
           "dct_quant": "encode", "encode_levels_gather": "transcode",
           "symlen_tile": "staged"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean ms per call by CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


PROFILER_SESSIONS = 3  # a session that records no device event is rerun


def profiled_events(fn):
    """The device events (kernels and copies, from ``key_averages``) of one
    call of ``fn`` under ``torch.profiler``, and the sessions it took.  A
    session now and then records no device event at all (seen for
    ``symlen_tile`` and ``symlen_pack``, unchanged code): such a session
    is run again, up to ``PROFILER_SESSIONS`` in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for session in range(1, PROFILER_SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if "CUDA" in str(getattr(ev, "device_type", ""))]
        if events:
            break
    return events, session


def grids_per_call(name: str, fn) -> float:
    """The CUDA kernels (not copies or memsets) that one call of ``fn`` puts
    on the card, by ``torch.profiler``, over the wrapper calls of ``name``
    that the launch counter saw in it (a counter counts wrapper calls, and
    a wrapper may launch several kernels)."""
    import torch

    from repro_torch.kernels import ops

    fn()
    torch.cuda.synchronize()
    before = ops.LAUNCHES[name]
    events, sessions = profiled_events(fn)
    calls = (ops.LAUNCHES[name] - before) // sessions
    grids = sum(ev.count for ev in events
                if not ev.key.startswith(("Memcpy", "Memset")))
    check(calls > 0 and grids > 0, f"{name}: the profiler saw {grids} "
          f"kernels in {calls} wrapper calls")
    return grids // calls if grids % calls == 0 else grids / calls


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def int_err(a, b) -> float:
    """max|a - b| of two integer tensors (0 when they are equal)."""
    return float((a.int() - b.int()).abs().max()) if a.numel() else 0.0


def flip_stats(got, want) -> dict:
    """The flip rule's numbers for two level tensors: differing cells, the
    largest difference, and whether the rule holds."""
    d = (got.int() - want.int()).abs()
    flips = int((d > 0).sum())
    worst = int(d.max()) if d.numel() else 0
    return {"cells": d.numel(), "flips": flips, "max_abs_err": worst,
            "ok": worst <= 1 and flips <= FLIP_SHARE * d.numel()}


def container_levels(c, tab):
    """A container's quantized levels [num_windows, e] (v3: un-predicted),
    by the port's host decoder."""
    import numpy as np
    import torch

    from repro_torch.core import quantize, symlen

    syms = symlen.unpack_symlen_np(
        symlen.PackedStream(c.words, c.symlen.astype(np.int32),
                            c.num_symbols), tab.book)
    nw, e = c.num_windows, c.e
    if c.coding == (0, 0, False):
        return syms.reshape(nw, e).astype(np.int64)
    idx, seg = symlen.v3_expand_index([(nw, c.zrow, c.zcol)], e)
    grid = quantize.expand_coded_stream(
        torch.from_numpy(syms), torch.from_numpy(idx)).reshape(nw, e)
    return quantize.unpredict_levels(
        grid, torch.from_numpy(seg), c.coding[0], c.coding[1]
    ).numpy().astype(np.int64)


def adversarial_v3(num_windows: int, e: int, tile: int, seed: int):
    """A synthetic v3 bucket for K2's v3 stage: (dense u8, idx i32[W * e],
    seg i32[W]) with every segment layout that stresses a tiled scan — 4
    tiles of single-window segments, one segment across 64 tiles, 16 tiles
    each with heads on, one before and one after every tile's first window,
    then random lengths (1 window to 3 tiles, every 4th 8192 windows, the
    archive's signal), and 1000 trailing padding windows; about 15% of the
    live cells suppressed (idx -1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pad = 1000
    live = num_windows - pad
    head = np.zeros(num_windows, dtype=bool)
    head[:4 * tile] = True  # singles
    head[4 * tile] = True  # one segment over tiles 4-67
    for i, shift in enumerate((0, -1, 1)):  # heads on / before / after
        lo = (68 + 16 * i) * tile
        head[lo] = True
        head[lo + tile + shift:lo + 16 * tile:tile] = True
    lens = rng.integers(1, 3 * tile, size=live // tile + 1)
    lens[::4] = 8192
    starts = 116 * tile + np.cumsum(np.concatenate([[0], lens]))
    head[starts[starts < live]] = True
    head[live:] = True  # padding: single-window segments
    seg = np.maximum.accumulate(
        np.where(head, np.arange(num_windows), 0)).astype(np.int32)
    coded = rng.random((num_windows, e)) >= 0.15
    coded[live:] = False
    flat = coded.ravel()
    idx = np.where(flat, np.cumsum(flat) - 1, -1).astype(np.int32)
    dense = rng.integers(0, 256, size=int(flat.sum()), dtype=np.uint8)
    return dense, idx, seg


def valid_slots(grid, zrow, zcol, counts, coding):
    """bool[K, Wp * E] (numpy): the slots a coding enters into the stream —
    v2 the first ``count``, v3 the true windows less the zero planes."""
    import numpy as np

    k, wp, e = grid.shape
    counts = np.asarray(counts, np.int64)
    if tuple(coding) == (0, 0, False):
        return np.arange(wp * e)[None, :] < counts[:, None]
    valid = np.repeat((np.arange(wp)[None, :] < (counts // e)[:, None])
                      [:, :, None], e, axis=2)
    if zrow is not None:
        valid &= ~np.asarray(zrow)[:, :, None] & ~np.asarray(zcol)[:, None, :]
    return valid.reshape(k, -1)


def host_pack(symbols, codes, lengths):
    """Algorithm 1 over one symbol stream, a code of length 0 (a histogram
    gap) counted in its word and emitting nothing, as the chunked pack
    treats it: (words uint64[W], symlen int32[W])."""
    import numpy as np

    codes, lengths = list(map(int, codes)), list(map(int, lengths))
    words, sls = [], []
    buf = bit = cnt = 0
    for s in symbols.tolist():
        n = lengths[s]
        if bit + n > 64:
            words.append(buf)
            sls.append(cnt)
            buf = bit = cnt = 0
        if n:
            buf |= codes[s] << (64 - bit - n)
        bit += n
        cnt += 1
    if cnt:
        words.append(buf)
        sls.append(cnt)
    return np.array(words, np.uint64), np.array(sls, np.int32)


def exact_rows_equal(parts, want) -> bool:
    """Exact-mode parts ``(hi, lo, symlen, wpc, bad)`` with one chunk per
    row against per-row ``(words, symlen)``: the words, the sidecar, and
    zeros past them."""
    import numpy as np

    hi, lo, sl, wpc = (t.cpu().numpy() for t in parts[:4])
    for r, (words, sls) in enumerate(want):
        w = int(wpc[r, 0])
        got = (hi[r, 0].view(np.uint32).astype(np.uint64) << np.uint64(32)
               | lo[r, 0].view(np.uint32).astype(np.uint64))
        if not (w == words.size and np.array_equal(got[:w], words)
                and np.array_equal(sl[r, 0, :w], sls)
                and not got[w:].any() and not sl[r, 0, w:].any()):
            return False
    return True


def digest(tensors) -> str:
    """sha256 of tensors' bytes in order (None as a marker), so that a
    later build can be compared byte for byte."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(b"none" if t is None else t.contiguous().cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def host_digest(items) -> str:
    """sha256 of host results' bytes in order: decoded numpy signals, or
    containers (their wire bytes)."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for x in items:
        h.update(x.to_bytes() if hasattr(x, "to_bytes")
                 else np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


def outputs_equal(got, want) -> bool:
    """Tuples of tensors (or None) equal element for element."""
    import torch

    return len(got) == len(want) and all(
        (g is None and w is None) or (
            g is not None and w is not None and g.dtype == w.dtype
            and bool(torch.equal(g, w)))
        for g, w in zip(got, want))


# the serve phase: the reference's serving setup (bench_serving.py's full
# run) on the port's frontend, its engines on the card
SERVE_SLO_MS, SERVE_SLACK_MS = 250.0, 50.0
SERVE_TRAFFIC = {"mix": {"decode": 0.6, "encode": 0.3, "transcode": 0.1},
                 "median_windows": 16, "sigma": 0.75, "max_windows": 256}
SERVE_LOADS = (25.0, 50.0, 100.0, 200.0, 400.0, 800.0)
SERVE_LOAD_CAP = 6400.0
OVERLOAD_CAP = 32000.0
# the kernels a served request runs: decode K1 + lut_idct, encode
# encode_levels + symlen_pack, transcode K1 + lut_idct +
# encode_levels_gather + symlen_pack
SERVE_KERNELS = ("symlen_decode", "lut_idct", "encode_levels",
                 "encode_levels_gather", "symlen_pack")


def sustains(point: dict) -> bool:
    """bench_serving's knee rule for one load point: p99 within the SLO,
    nothing shed, every admitted request completed."""
    return (point["p99_ms"] <= SERVE_SLO_MS and point["shed"] == 0
            and point["completed"] == point["submitted"] > 0)


def same_result(got, want) -> bool:
    """A served response against the offline engines': f32 samples bit for
    bit (dtype, shape and bytes), containers byte for byte."""
    import numpy as np

    if isinstance(want, (bytes, bytearray)):
        return got.to_bytes() == bytes(want)
    return (isinstance(got, np.ndarray) and got.dtype == want.dtype
            and got.shape == want.shape and got.tobytes() == want.tobytes())


def served_vs_plain(name: str, calls, plain, min_flips: int = 0) -> dict:
    """One path kernel's calls from a serve run, each ``(args, kwargs,
    output)``, against its plain version on the same inputs, by the check
    phase's rules: ``lut_idct`` within ``REL_TOL``, ``encode_levels`` and
    its gather arm by the flip rule over all the calls' levels outside the
    deadzone class (a cell in ``DEADZONE`` on both sides within 2 levels;
    at most ``max(min_flips, FLIP_SHARE * cells)`` flips), rows that agree
    equal in every output, K1 and the pack exactly."""
    import torch

    res = {"calls": len(calls), "max_abs_err": 0.0, "ok": True}
    flips = deadzone = cells = 0
    for args, kw, out in calls:
        want = plain(*args, **kw)
        if name == "lut_idct":
            err = rel_err(out, want)
            res["rel_err"] = max(res.get("rel_err", 0.0), err)
            res["max_abs_err"] = max(res["max_abs_err"],
                                     float((out - want).abs().max()))
            res["ok"] &= err <= REL_TOL
        elif name.startswith("encode_levels"):
            got, exp = out[0].int(), want[0].int()
            zone = torch.tensor(DEADZONE, dtype=got.dtype, device=got.device)
            d = (got - exp).abs()
            dz = torch.isin(got, zone) & torch.isin(exp, zone)
            flips += int((d[~dz] > 0).sum())
            deadzone += int((d[dz] > 0).sum())
            cells += d.numel()
            res["max_abs_err"] = max(res["max_abs_err"], int_err(got, exp))
            if d.numel():
                res["ok"] &= (int(d.masked_fill(~dz, 0).max()) <= 2
                              and int(d.masked_fill(dz, 0).max()) <= 1)
            clean = (d == 0).reshape(d.shape[0], -1).all(1)
            res["ok"] &= all(
                (a is None and c is None)
                or bool(torch.equal(a[clean], c[clean]))
                for a, c in zip(out, want))
        elif name == "symlen_decode":
            equal = outputs_equal((out,), (want,))
            res["ok"] &= equal
            res["max_abs_err"] = max(res["max_abs_err"], int_err(out, want)
                                     if out.shape == want.shape
                                     else float("inf"))
        else:
            equal = outputs_equal(out, want)
            res["ok"] &= equal
            if not equal:
                res["max_abs_err"] = float("inf")
    if name.startswith("encode_levels"):
        res.update(flips=flips, deadzone_moves=deadzone, cells=cells)
        res["ok"] &= flips <= max(min_flips, FLIP_SHARE * cells)
    return res


def path_hooks(names):
    """``(module, attribute, counter name, plain version)`` of the named
    path kernels' wrappers, for :func:`recorded`."""
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels import encode_fused as ef
    from repro_torch.kernels import huffman_decode as hd

    hooks = [(hd, "huffman_decode_dense", "symlen_decode",
              hd.huffman_decode_plain),
             (df, "lut_idct", "lut_idct", df.lut_idct_plain),
             (ef, "encode_levels", "encode_levels", ef.encode_levels_plain),
             (ef, "encode_levels_gather", "encode_levels_gather",
              ef.encode_levels_gather_plain),
             (ef, "symlen_pack", "symlen_pack", ef.symlen_pack_plain)]
    return [h for h in hooks if h[2] in names]


@contextlib.contextmanager
def recorded(hooks):
    """Record every call of the hooked wrappers where the engines call
    them: its inputs (cloned before the call) and its output (cloned after
    it), under its counter's name, to hold against the plain version once
    the run is over.  Yields ``{name: [(args, kwargs, output), ...]}``;
    the kwargs leave out the launch shape (``rw``), which the plain
    versions do not take."""
    import torch

    calls = {name: [] for _, _, name, _ in hooks}

    def snap(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        return tuple(map(snap, x)) if isinstance(x, tuple) else x

    def recorder(fn, name):
        def rec(*args, **kw):
            ins = (snap(args),
                   {k: snap(v) for k, v in kw.items() if k != "rw"})
            out = fn(*args, **kw)
            calls[name].append((*ins, snap(out)))
            return out
        return rec

    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in hooks]
    for (mod, attr, fn), (_, _, name, _) in zip(saved, hooks):
        setattr(mod, attr, recorder(fn, name))
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def open_loop(fe, requests) -> list:
    """Submit ``requests`` to ``fe`` at their arrival times (open loop, as
    ``traffic.replay`` does) and return each request's future, or the
    admission error it raised."""
    start = time.monotonic()
    futures = []
    for r in requests:
        delay = start + r.arrival - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        try:
            if r.kind == "decode":
                futures.append(fe.submit_decode(r.container))
            elif r.kind == "encode":
                futures.append(fe.submit_encode(r.signal, r.domain_id))
            else:
                futures.append(fe.submit_transcode(r.container,
                                                   r.dst_domain_id))
        except Exception as err:  # a typed rejection, checked by the caller
            futures.append(err)
    fe.flush()
    return futures


def warm_lattice(tables, engines: dict, requests, max_batch: int) -> None:
    """bench_serving's ``_warm``: per (domain, kind) of ``requests`` one
    engine call at every policy bucket edge up to the fill target (the
    frontend's micro-batches pad onto those edges), transcodes per (source,
    target) pair, each drained."""
    from repro_torch.serving import policy_fill_target

    dec, enc, tr = (engines["decoder"], engines["encoder"],
                    engines["transcoder"])
    policy = dec.scheduler.policy
    edges, k = [], 1
    while k <= policy_fill_target(policy, max_batch):
        edges.append(k)
        k = policy.round(k + 1)
    by_dom_c, by_dom_s, tr_pairs = {}, {}, {}
    for r in requests:
        if r.kind == "decode":
            by_dom_c.setdefault(r.domain_id, []).append(r.container)
        elif r.kind == "encode":
            by_dom_s.setdefault(r.domain_id, []).append(r.signal)
        else:
            tr_pairs.setdefault((r.domain_id, r.dst_domain_id),
                                []).append(r.container)
    for d, cs in by_dom_c.items():
        for k in edges:
            if len(cs) >= k:
                dec.decode(cs[:k], tables[d]).to_host()
    for d, ss in by_dom_s.items():
        for k in edges:
            if len(ss) >= k:
                enc.encode(ss[:k], tables[d]).to_host()
    for (src, dst), cs in tr_pairs.items():
        for k in edges:
            if len(cs) >= k:
                tr.transcode(cs[:k], tables[src], tables[dst],
                             dst_domain_ids=[dst] * k).to_host()


def serve_phase(smi: str) -> dict:
    """Phase 10: the port's serving frontend on the card (see the module
    docstring): byte identity and launch counts, the load sweep, overload,
    chaos, the watchdog, and the HTTP service.  Returns its JSON line."""
    import http.client
    import threading

    import numpy as np
    import torch

    from repro_torch.core import DOMAIN_DEFAULTS, calibrate, encode
    from repro_torch.data import make_signal
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_server
    from repro_torch.serving import (
        BatchDecoder,
        BatchEncoder,
        FrontendConfig,
        RetryPolicy,
        ServingFrontend,
        TrafficConfig,
        Transcoder,
        build_domain_tables,
        generate,
        replay,
        settle_heap,
    )
    from repro_torch.serving import engine as engine_mod
    from repro_torch.testing.faults import (
        CONTAINER_FAULTS,
        EXPECTED_FAULT,
        DispatcherFaultInjector,
        chaos_replay,
        corrupt,
        offline_expected,
    )

    t_phase = time.perf_counter()
    secs = {}
    tables = build_domain_tables()
    dec, enc = BatchDecoder(), BatchEncoder()
    engines = {"decoder": dec, "encoder": enc,
               "transcoder": Transcoder(decoder=dec, encoder=enc)}

    def config(**kw) -> "FrontendConfig":
        base = dict(max_batch=64, max_queue_depth=1024,
                    default_slo_ms=SERVE_SLO_MS,
                    flush_slack_ms=SERVE_SLACK_MS)
        base.update(kw)
        return FrontendConfig(**base)

    def stream(rps, duration_s=2.0, seed=None, **kw):
        traffic = {**SERVE_TRAFFIC, **kw}
        return generate(TrafficConfig(
            rate=rps, duration_s=duration_s,
            seed=42 + int(rps) if seed is None else seed, **traffic),
            tables)

    # the reference's warm-up (bench_serving._warm): one engine call at
    # every policy edge up to the fill target, per (domain, kind) of a
    # 0.5 s stream at the sweep's top load
    t0 = time.perf_counter()
    warm_lattice(tables, engines, stream(800.0, 0.5, seed=99), 64)
    # as launch.serve does once warm: full collections skip the heap built
    # so far (their 140-170 ms stop-the-world pauses broke the SLO below
    # the knee, F2); undone at the phase's end
    frozen = settle_heap()
    secs["warm"] = time.perf_counter() - t0

    # -- 9a. byte identity and launch counts ----------------------------------
    t0 = time.perf_counter()
    reqs = stream(400.0, seed=1)
    torch.cuda.synchronize()
    d0, e0 = dec.stats.dispatches, enc.stats.dispatches
    d2h = {"s": 0.0, "calls": 0}
    d2h_lock = threading.Lock()
    start_d2h = engine_mod._start_d2h

    def timed_d2h(tensors):  # the drain's pinned allocations and copies
        t = time.perf_counter()
        try:
            return start_d2h(tensors)
        finally:
            with d2h_lock:
                d2h["s"] += time.perf_counter() - t
                d2h["calls"] += 1

    # every call of the five path wrappers, recorded where the engines call
    # them, to hold against the plain version once the run is over
    hooks = path_hooks(SERVE_KERNELS)
    ops.reset_launches()
    engine_mod._start_d2h = timed_d2h
    try:
        with recorded(hooks) as served:
            t_run = time.perf_counter()
            with ServingFrontend(tables, config=config(), **engines) as fe:
                futures = open_loop(fe, reqs)
                results = [f.result(timeout=120)
                           if not isinstance(f, Exception) else f
                           for f in futures]
                st = fe.stats_snapshot()
            run_s = time.perf_counter() - t_run
    finally:
        engine_mod._start_d2h = start_d2h
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    buckets = {"decoder": dec.stats.dispatches - d0,
               "encoder": enc.stats.dispatches - e0}
    rejected = [r for r in results if isinstance(r, Exception)]
    check(not rejected and st.shed == 0 and st.rejected_expired == 0
          and st.failed == 0 and st.completed == st.admitted == len(reqs),
          f"identity run: {len(rejected)} rejected, stats {st}")
    want = {k: 0 for k in launches}
    want.update(symlen_decode=buckets["decoder"],
                lut_idct=buckets["decoder"], symlen_pack=buckets["encoder"])
    got = dict(launches)
    levels = got.pop("encode_levels") + got.pop("encode_levels_gather")
    for k in ("encode_levels", "encode_levels_gather"):
        want.pop(k)
    check(got == want and levels == buckets["encoder"]
          and all(launches[k] > 0 for k in SERVE_KERNELS),
          f"serve launch counts {launches} against the engines' buckets "
          f"{buckets}")
    # each served bucket's kernel output against its plain version on the
    # card, on the inputs the path gave it
    vs_plain = {}
    for _, _, name, plain in hooks:
        vs_plain[name] = served_vs_plain(name, served.pop(name), plain)
        check(vs_plain[name]["ok"]
              and vs_plain[name]["calls"] == launches[name],
              f"{name} at the serve path's shapes against its plain "
              f"version: {vs_plain[name]}, {launches[name]} launches")
    expected = offline_expected(reqs, tables)
    mism = [i for i, r in enumerate(results)
            if not same_result(r, expected[i])]
    check(not mism, f"{len(mism)} of {len(reqs)} served responses differ "
          f"from the offline engines (first {mism[:5]})")
    kinds = {k: sum(r.kind == k for r in reqs)
             for k in ("decode", "encode", "transcode")}
    identity = {"requests": len(reqs), "kinds": kinds, "identical": len(reqs),
                "batches": st.batches, "mean_batch": st.mean_batch_size,
                "deadline_misses": st.deadline_misses, "wall_s": run_s,
                "launches": launches, "engine_buckets": buckets,
                "kernels_vs_plain": vs_plain,
                "drain_start_d2h_s": d2h["s"], "drain_start_d2h_calls":
                d2h["calls"]}
    del results, expected, futures
    secs["identity"] = time.perf_counter() - t0

    # -- 9b. the load sweep, two arms, and the overload point -----------------
    t0 = time.perf_counter()
    sweep, knees, cold_knees, streams = {}, {}, {}, {}

    def summary(fe, rep, rps):
        st = fe.stats_snapshot()
        point = rep.summary()
        point.update(rep.timings())
        point.update(offered_rps=rps, fill_target=fe.fill_target,
                     batches=st.batches, mean_batch=st.mean_batch_size,
                     fill_dispatches=st.fill_dispatches,
                     deadline_dispatches=st.deadline_dispatches,
                     deadline_share=st.deadline_dispatches
                     / max(st.batches, 1),
                     deadline_misses=st.deadline_misses)
        return point

    for arm in ("microbatch", "batch1"):
        loads, points = list(SERVE_LOADS), []
        cfg = config(max_batch=1 if arm == "batch1" else 64)
        for rps in loads:
            if rps not in streams:
                streams[rps] = stream(rps)
            cold = None
            if arm != "batch1":
                # bench_serving's per-point warm pass (same stream, its
                # result discarded from the knee): micro-batch compositions
                # are timing-dependent, so the lattice can miss a shape
                with ServingFrontend(tables, config=cfg, **engines) as fe:
                    cold = summary(fe, replay(fe, streams[rps]), rps)
            with ServingFrontend(tables, config=cfg, **engines) as fe:
                point = summary(fe, replay(fe, streams[rps]), rps)
            if cold is not None:
                point["cold"] = cold
            points.append(point)
            if rps == loads[-1] and sustains(point) and rps < SERVE_LOAD_CAP:
                loads.append(2 * rps)
        sweep[arm] = points
        knees[arm] = max([p["offered_rps"] for p in points if sustains(p)],
                         default=0.0)
        if arm != "batch1":
            cold_knees[arm] = max([p["offered_rps"] for p in points
                                   if sustains(p["cold"])], default=0.0)
    secs["sweep"] = time.perf_counter() - t0
    # overload: bench_serving's point (2000 requests/s of decode for 0.5 s,
    # 8 windows, max_batch 8, queue bound 16), doubled until it sheds: the
    # card may sustain 2000 (capped at 32000); every admitted request must
    # resolve at every rate
    t0 = time.perf_counter()
    overload, rps = [], 2000.0
    while True:
        burst = stream(rps, 0.5, seed=7, mix={"decode": 1.0},
                       fixed_windows=8)
        with ServingFrontend(tables, config=config(
                max_batch=8, max_queue_depth=16, flush_slack_ms=2.0),
                **engines) as fe:
            rep = replay(fe, burst)
        overload.append({**rep.summary(), "offered_rps": rps,
                         "queue_bound": 16, "requests": len(burst)})
        check(rep.completed == rep.submitted and rep.failed == 0,
              f"overload at {rps:g}/s: {rep.completed} of {rep.submitted} "
              f"admitted completed, {rep.failed} failed")
        if rep.shed > 0 or rps >= OVERLOAD_CAP:
            break
        rps *= 2
    check(overload[-1]["shed"] > 0,
          f"overload: nothing shed up to {rps:g} requests/s")
    secs["overload"] = time.perf_counter() - t0

    # -- 9c. chaos, then one hung dispatch under the watchdog -----------------
    t0 = time.perf_counter()
    creqs = generate(TrafficConfig(
        rate=2400.0, duration_s=2.0, fixed_windows=8,
        mix={"decode": 0.5, "encode": 0.3, "transcode": 0.2},
        domains=(2, 3), seed=31), tables)
    cexp = offline_expected(creqs, tables)
    inj = DispatcherFaultInjector(fail_on={3, 11}, latency_on={6: 0.05},
                                  device_loss_on={17})
    with ServingFrontend(tables, config=config(
            max_queue_depth=8192, default_slo_ms=600_000.0),
            fault_injector=inj, **engines) as fe:
        rep = chaos_replay(fe, creqs, corrupt_frac=0.05, seed=31,
                           expected=cexp, result_timeout_s=120.0)
        st = fe.stats_snapshot()
    chaos = {k: getattr(rep, k) for k in (
        "total", "clean", "corrupted", "ok", "poisoned", "dispatch_failed",
        "rejected", "untyped_failures", "hangs", "clean_mismatches",
        "clean_ok")}
    chaos.update(accounted=rep.accounted, quarantined=st.quarantined,
                 retries=st.retries, retry_successes=st.retry_successes,
                 injected=[list(x) for x in inj.injected])
    check(rep.accounted == rep.total == len(creqs) and rep.hangs == 0
          and rep.untyped_failures == 0 and rep.clean_mismatches == 0
          and rep.poisoned == rep.corrupted > 0 and rep.clean_ok == rep.clean
          and len(inj.injected) >= 3, f"chaos contract broken: {chaos}")
    del cexp
    wreqs = generate(TrafficConfig(
        rate=200.0, duration_s=0.5, fixed_windows=8, mix={"decode": 1.0},
        domains=(2,), seed=32), tables)
    wexp = offline_expected(wreqs, tables)
    hang = DispatcherFaultInjector(hang_on={2}, hang_timeout_s=120.0)
    try:
        with ServingFrontend(tables, config=config(
                max_batch=8, max_queue_depth=4096, default_slo_ms=600_000.0,
                retry=RetryPolicy(max_retries=1, base_backoff_ms=1.0),
                watchdog_timeout_ms=500.0, watchdog_poll_ms=25.0),
                pipeline=False, fault_injector=hang) as fe:
            rep = chaos_replay(fe, wreqs, corrupt_frac=0.0, seed=32,
                               expected=wexp, result_timeout_s=120.0)
            again = fe.submit_decode(wreqs[0].container)
            fe.flush()
            again_ok = same_result(again.result(timeout=60), wexp[0])
            st = fe.stats_snapshot()
            health = fe.health()
    finally:
        hang.release()  # the abandoned dispatcher finishes its stale call
    for t in threading.enumerate():
        if t.name == "fptc-frontend-dispatch":
            t.join(timeout=30)
    watchdog = {"requests": len(wreqs), "ok": rep.ok,
                "dispatch_failed": rep.dispatch_failed, "hangs": rep.hangs,
                "untyped_failures": rep.untyped_failures,
                "watchdog_restarts": st.watchdog_restarts,
                "health": health["status"], "serves_after": again_ok}
    check(rep.accounted == rep.total and rep.hangs == 0
          and rep.untyped_failures == 0 and rep.clean_mismatches == 0
          and rep.dispatch_failed > 0
          and rep.ok + rep.dispatch_failed == rep.total
          and st.watchdog_restarts == 1 and health["status"] == "degraded"
          and again_ok and any(k == "hang" for _, k in hang.injected),
          f"watchdog case: {watchdog}")
    secs["chaos"] = time.perf_counter() - t0

    # -- 9d. the HTTP service -------------------------------------------------
    t0 = time.perf_counter()
    off_dec, off_enc = BatchDecoder(pipeline=False), BatchEncoder(
        pipeline=False)
    off_tr = Transcoder(decoder=off_dec, encoder=off_enc)
    sig = make_signal("load_power", 16 * tables[2].config.n, seed=5)
    v3_tab = calibrate(make_signal("load_power", 65536, seed=1002),
                       DOMAIN_DEFAULTS["power"].replace(
                           predictor="delta", predict_bands=2,
                           zero_planes=True), domain_id=2)
    blob_v3 = encode(sig, v3_tab).to_bytes()
    statuses = {}
    fe = ServingFrontend(tables, config=config(), **engines)
    server = make_server(fe, "127.0.0.1", 0)
    serving = threading.Thread(target=server.serve_forever,
                               name="fptc-http", daemon=True)
    serving.start()

    def call(method, path, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", server.server_port,
                                          timeout=60)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    try:
        code, blob = call("POST", "/v1/encode?domain_id=2",
                          sig.astype("<f4").tobytes())
        want = off_enc.encode([sig], tables[2]).to_host()[0]
        check(code == 200 and blob == want.to_bytes(),
              f"HTTP encode: {code}, equal {blob == want.to_bytes()}")
        code, raw = call("POST", "/v1/decode", blob)
        want_d = off_dec.decode([want], tables[2]).to_host()[0]
        check(code == 200 and raw == want_d.astype("<f4").tobytes(),
              f"HTTP decode: {code}")
        code, tblob = call("POST", "/v1/transcode?dst=3", blob)
        want_t = off_tr.transcode([want], tables[2], tables[3],
                                  dst_domain_ids=[3]).to_host()[0]
        check(code == 200 and tblob == want_t.to_bytes(),
              f"HTTP transcode: {code}")
        statuses.update(encode=200, decode=200, transcode=200)
        for fault in CONTAINER_FAULTS:
            src = blob_v3 if fault == "reserved-flags" else blob
            code, body = call("POST", "/v1/decode",
                              corrupt(src, fault, seed=13))
            rec = json.loads(body)
            check(code == 422 and rec["fault"] in EXPECTED_FAULT[fault],
                  f"HTTP {fault}: {code} {rec}")
            statuses[fault] = [code, rec["fault"]]
        code, _ = call("POST", "/v1/transcode", blob)
        check(code == 400, f"transcode without dst: {code}")
        code2, _ = call("POST", "/v1/decode", blob,
                        {"X-FPTC-Deadline-Ms": "0"})
        check(code2 == 400, f"expired deadline: {code2}")
        code3, _ = call("GET", "/v1/nowhere")
        check(code3 == 404, f"unknown route: {code3}")
        statuses.update(no_dst=code, expired=code2, unknown_route=code3)
        code, body = call("GET", "/healthz")
        check(code == 200 and json.loads(body)["status"] == "ok",
              f"/healthz: {code} {body[:200]}")
        code2, body2 = call("GET", "/statz")
        statz = json.loads(body2)
        check(code2 == 200 and statz["stats"]["completed"] >= 3,
              f"/statz: {code2} {body2[:200]}")
        statuses.update(healthz=code, statz=code2)
    finally:
        server.shutdown()
        server.server_close()
        serving.join(timeout=30)
        fe.close()
    secs["http"] = time.perf_counter() - t0
    engines["transcoder"].close()
    gc.unfreeze()
    return {"phase": "serve", "nvidia_smi": smi, "heap_frozen": frozen,
            "config": {"slo_ms": SERVE_SLO_MS,
                       "flush_slack_ms": SERVE_SLACK_MS, "max_batch": 64,
                       "max_queue_depth": 1024, "duration_s": 2.0,
                       **SERVE_TRAFFIC},
            "identity": identity, "sweep": sweep, "knees_rps": knees,
            "cold_knees_rps": cold_knees,
            "overload": overload, "chaos": chaos, "watchdog": watchdog,
            "http": statuses, "seconds_by_step": secs,
            "seconds": time.perf_counter() - t_phase}


# the tune phase: the tuning cache's sweeps on archive buckets, the engines
# with a warm cache, the cost-balanced ladder, and two shards on one card
def tune_phase(tables, archive, signals, doms, twin, buckets, ebuckets, dec,
               enc, ref) -> dict:
    """The tuning layer on the card (the phases' docstring, phase 12).
    ``ref`` maps "main", "encode" and "transcode" to that phase's
    (sha256 of its drained results, launch counts)."""
    import statistics
    import tempfile

    import torch

    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels import encode_fused as ef
    from repro_torch.kernels import ops, tiles
    from repro_torch.serving import BatchDecoder, BatchEncoder, Transcoder
    from repro_torch.tuning import autotune, default_cost_model

    t_phase = time.perf_counter()
    cm = default_cost_model("cuda")
    cache = autotune.TuningCache(tempfile.mkdtemp(prefix="fptc_tune_"))
    backend = autotune.backend_key("cuda")

    # -- the host's copy of the launchers' tile rules (kernels/tiles.py,
    # which the cost model charges and the CPU's tests use) against the
    # built library's, at every (E, N) and tile the launchers take
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    rules = {"idct": 0, "levels": 0, "v3": 0}
    for e in range(1, 129):
        for n in range(1, 129):
            for rw in (0, 4, 8, 2):
                got = tiles.launcher_idct_tile(e, n, rw, optin)
                want = tiles.idct_tile_shape(e, n, rw, optin)
                check(got == want, f"lut_idct's tile at E={e}, N={n}, "
                      f"rw={rw}: the library's {got}, tiles.py's {want}")
                rules["idct"] += 1
            for rw in (0, 1, 2, 4, 8):
                got = tiles.launcher_dct_tile(n, e, rw)
                want = tiles.dct_tile_shape(n, e, rw)
                check(got == want, f"levels_kernel's tile at N={n}, E={e}, "
                      f"rw={rw}: the library's {got}, tiles.py's {want}")
                rules["levels"] += 1
        for t in (*range(0, 4097, 128), 300, -256):
            check(tiles.launcher_v3_tile_ok(t, e) == tiles.v3_tile_ok(t, e),
                  f"the v3 tile {t} at E={e}: the library and tiles.py "
                  "disagree")
            rules["v3"] += 1

    def label(b):
        return "/".join(f"{k}={v}" for k, v in sorted(b.items()))

    # -- (a) the sweeps: every candidate timed, predicted, and its outputs
    # held to the cold default's (the kernels' own picks) by sha256
    sweeps = []
    v2 = next(b for b in buckets if b["v3"] is None)
    v3 = next(b for b in buckets if b["v3"] is not None)
    for b in (v2, v3):
        p = b["plan"]
        bucket = {"args": (b["words"], b["symlen"], p.tables, p.lut,
                           p.basis, b["v3"]),
                  "kw": dict(l_max=p.l_max, max_symlen=b["ms"],
                             num_windows=b["nw"], n=p.n, e=p.e,
                             coding=p.coding)}
        words = int(b["words"].shape[0])

        def run(blocks, bucket=bucket):
            return df.decode_fused(
                *bucket["args"], **bucket["kw"], idct_rw=blocks["idct_rw"],
                v3_tile_windows=blocks.get("v3_tile_windows", 0))

        cold = digest([run({"idct_rw": 0})])
        timed = {}
        best = autotune.tune_decode_bucket(
            tables[p.domain_id], num_words=words, num_windows=b["nw"],
            bucket=bucket, cache=cache, trials=5,
            record=lambda bl, t: timed.__setitem__(label(bl), t))
        cands = []
        for blocks in autotune.decode_block_candidates(p.n, p.e, p.coding):
            sha = digest([run(blocks)])
            check(sha == cold, f"decode {p.coding} at {blocks}: outputs "
                  "differ from the kernels' own picks")
            cands.append({"blocks": blocks, "ms": timed[label(blocks)] * 1e3,
                          "predicted_ms": 1e3 * cm.decode_bucket_cost(
                              words, b["nw"], e=p.e, n=p.n,
                              max_symlen=b["ms"], **blocks),
                          "sha256_equal": True})
        pick = {"idct_rw": tiles.idct_tile_shape(p.e, p.n).rw}
        if b["v3"] is not None:
            pick["v3_tile_windows"] = tiles.v3_tile_windows(p.e)
        sweeps.append({"kind": "decode", "plan_key": str(b["grp"].plan_key),
                       "shape": [words, b["nw"]], "candidates": cands,
                       "winner": best, "pick": pick,
                       "pick_ms": timed[label(pick)] * 1e3})
    eb = ebuckets[0]
    p = eb["plan"]
    wpr = eb["x"].shape[1] // p.n
    bucket = {"args": (eb["x"], eb["counts"], p.tables, p.basis),
              "kw": dict(n=p.n, e=p.e, chunk_size=eb["chunk"],
                         check_gaps=p.has_gaps, coding=p.coding)}
    timed = {}
    best = autotune.tune_encode_bucket(
        tables[p.domain_id], rows=eb["x"].shape[0], num_windows=wpr,
        chunk_size=eb["chunk"], bucket=bucket, cache=cache, trials=5,
        record=lambda bl, t: timed.__setitem__(label(bl), t))
    cold = digest(ef.encode_fused(*bucket["args"], **bucket["kw"],
                                  levels_rw=0))
    cands = []
    for blocks in autotune.encode_block_candidates(p.n, p.e):
        sha = digest(ef.encode_fused(*bucket["args"], **bucket["kw"],
                                     levels_rw=blocks["levels_rw"]))
        check(sha == cold, f"encode at {blocks}: outputs differ from the "
              "kernel's own pick")
        cands.append({"blocks": blocks, "ms": timed[label(blocks)] * 1e3,
                      "predicted_ms": 1e3 * cm.encode_bucket_cost(
                          eb["x"].shape[0], wpr, e=p.e, n=p.n,
                          levels_rw=blocks["levels_rw"]),
                      "sha256_equal": True})
    pick = {"levels_rw": tiles.dct_tile_shape(p.n, p.e).rw}
    sweeps.append({"kind": "encode", "plan_key": str(
        (p.domain_id, p.n, p.e, p.l_max, p.coding)),
        "shape": list(eb["x"].shape), "candidates": cands, "winner": best,
        "pick": pick, "pick_ms": timed[label(pick)] * 1e3})
    # every archive bucket under every legal shape, against the pick, on
    # the card: lut_idct (its bit contract) and levels_kernel
    same = {"lut_idct": True, "encode_levels": True, "v3_unpredict": True}
    for b in buckets:
        p = b["plan"]
        lv = df.bucket_levels(b["words"], b["symlen"], p.tables, b["v3"],
                              l_max=p.l_max, max_symlen=b["ms"],
                              num_windows=b["nw"], e=p.e, coding=p.coding)
        want = df.lut_idct(lv, p.lut, p.basis)
        for rw in tiles.idct_rws(p.e, p.n):
            same["lut_idct"] &= bool(torch.equal(
                df.lut_idct(lv, p.lut, p.basis, rw=rw), want))
        if b["v3"] is not None:
            for t in tiles.v3_tiles(p.e):
                same["v3_unpredict"] &= bool(torch.equal(df.bucket_levels(
                    b["words"], b["symlen"], p.tables, b["v3"], l_max=p.l_max,
                    max_symlen=b["ms"], num_windows=b["nw"], e=p.e,
                    coding=p.coding, v3_tile_windows=t), lv))
    for b in ebuckets:
        p = b["plan"]
        kw = dict(n=p.n, e=p.e, coding=p.coding)
        want = ef.encode_levels(b["x"], b["counts"], p.tables.quant, p.basis,
                                **kw)
        for rw in tiles.levels_rws(p.n, p.e):
            got = ef.encode_levels(b["x"], b["counts"], p.tables.quant,
                                   p.basis, rw=rw, **kw)
            same["encode_levels"] &= outputs_equal(got, want)
    check(all(same.values()), f"a launch shape changes outputs: {same}")

    # -- (b) the engines with that cache as the default, and a shape other
    # than the kernels' pick under every other key they consult: the
    # phases' results and launch counts
    forced = 0
    for b in buckets:
        p = b["plan"]
        key = df.tuning_plan_key(p.n, p.e, p.l_max, b["ms"], p.coding)
        shape = (int(b["words"].shape[0]), b["nw"])
        if cache.lookup("decode", backend, key, shape) is None:
            pick = tiles.idct_tile_shape(p.e, p.n).rw
            blocks = {"idct_rw": next(
                (r for r in tiles.idct_rws(p.e, p.n) if r != pick), pick)}
            if b["v3"] is not None:
                pick = tiles.v3_tile_windows(p.e)
                blocks["v3_tile_windows"] = next(
                    t for t in tiles.v3_tiles(p.e) if t != pick)
            cache.store("decode", backend, key, shape, blocks)
            forced += 1
    for b in ebuckets:
        p = b["plan"]
        key = ef.tuning_plan_key(p.n, p.e, b["chunk"], p.coding)
        shape = tuple(b["x"].shape)
        rws = [r for r in tiles.levels_rws(p.n, p.e)
               if r != tiles.dct_tile_shape(p.n, p.e).rw]
        if cache.lookup("encode", backend, key, shape) is None and rws:
            cache.store("encode", backend, key, shape, {"levels_rw": rws[0]})
            forced += 1
    autotune.set_default_cache(cache)
    hits0 = cache.hits
    warm = {}
    tc = Transcoder(decoder=dec, encoder=enc)
    for name, fn in (
        ("main", lambda: dec.decode(archive, tables).to_host()),
        ("encode", lambda: enc.encode(signals, tables,
                                      domain_ids=doms).to_host()),
        ("transcode", lambda: tc.transcode(archive, tables, tables,
                                           dst_domain_ids=twin).to_host()),
    ):
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        sha = host_digest(fn())
        got = {k: v for k, v in ops.LAUNCHES.items() if v}
        want = {k: v for k, v in ref[name][1].items()
                if v and k not in ("idct_dequant", "dct_quant")}
        check(sha == ref[name][0], f"warm-cache {name} differs from the "
              "cold phase's results")
        check(got == want, f"warm-cache {name} launches {got} != {want}")
        warm[name] = {"wall_s": time.perf_counter() - t0, "sha256": sha,
                      "launches": got}
    warm_hits = cache.hits - hits0
    check(warm_hits > 0, "the engines never consulted the warm cache")

    # -- (c) cold again: the cost-balanced ladder and two shards on one card
    autotune.set_default_cache(None)
    policy = {}
    cb_dec = BatchDecoder(policy="cost-balanced")
    cb_enc = BatchEncoder(policy="cost-balanced")
    for name, fn in (
        ("main", lambda: cb_dec.decode(archive, tables).to_host()),
        ("encode", lambda: cb_enc.encode(signals, tables,
                                         domain_ids=doms).to_host()),
    ):
        sha = host_digest(fn())
        check(sha == ref[name][0], f"cost-balanced {name} differs from p2")
        policy[name] = sha
    policy["multipliers"] = list(cb_dec.scheduler.policy.multipliers)
    cb_dec.close()
    cb_enc.close()
    two = ("cuda:0", "cuda:0")
    sh_dec, sh_enc = BatchDecoder(devices=two), BatchEncoder(devices=two)
    sh_tc = Transcoder(decoder=sh_dec, encoder=sh_enc)
    shards = {}
    for name, fn in (
        ("main", lambda: sh_dec.decode(archive, tables).to_host()),
        ("encode", lambda: sh_enc.encode(signals, tables,
                                         domain_ids=doms).to_host()),
        ("transcode", lambda: sh_tc.transcode(archive, tables, tables,
                                              dst_domain_ids=twin).to_host()),
    ):
        t0 = time.perf_counter()
        sha = host_digest(fn())
        check(sha == ref[name][0], f"two shards' {name} differs from one's")
        shards[name] = {"wall_s": time.perf_counter() - t0, "sha256": sha}
    n_buckets = len(buckets)
    shards["decode_dispatches"] = sh_dec.stats.dispatches
    shards["encode_dispatches"] = sh_enc.stats.dispatches
    check(sh_enc.stats.dispatches == 2 * 2 * n_buckets,
          f"two shards ran {sh_enc.stats.dispatches} encode buckets for "
          f"{n_buckets} keys (encode and transcode)")
    sh_dec.close()
    sh_enc.close()
    # a new bucket shape's first call less its warm call (the cost the
    # cost-balanced ladder trades padding against): decodes of slices of
    # one plan key at bucket edges the archive never made
    firsts = []
    for size in (3, 5, 9, 17):
        sub = [c for c in archive if c.domain_id == 2][:size]
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            dec.decode(sub, tables).to_host()
            walls.append(time.perf_counter() - t0)
        firsts.append({"containers": size, "first_s": walls[0],
                       "warm_s": walls[1]})
    compile_cost_s = statistics.median(
        f["first_s"] - f["warm_s"] for f in firsts)
    prof = cm.profile
    return {"phase": "tune", "seconds": time.perf_counter() - t_phase,
            "tile_rules_equal": rules, "sweeps": sweeps, "same_under_every_shape": same,
            "cache_entries": len(cache), "forced_entries": forced,
            "warm": warm, "warm_hits": warm_hits, "policy": policy,
            "shards": shards, "compile_cost_s": compile_cost_s,
            "new_shape_calls": firsts,
            "cost_model": {"peak_flops": prof.peak_flops,
                           "hbm_bps": prof.hbm_bps,
                           "dispatch_overhead_s": prof.dispatch_overhead_s,
                           "step_overhead_s": prof.step_overhead_s,
                           "compile_cost_s": prof.compile_cost_s,
                           "edges_per_octave": cm.edges_per_octave()}}


# the workloads phase: one decoder layer of granite-8b
# (src/repro/configs/granite_8b.py: d_model 4096, 8 KV heads of 128, d_ff
# 14336), its K cache at batch 8 and its training state
GRANITE = {"d_model": 4096, "kv_heads": 8, "head_dim": 128, "d_ff": 14336}
KV_BATCH = 8
CKPT_KERNELS = ("encode_levels", "symlen_pack", "symlen_decode", "lut_idct")


def kv_cache(seed: int):
    """One layer's K cache of granite-8b at batch 8 and 4096 tokens, as
    f32 channel rows [batch 8 x KV heads 8 x head dim 128, 4096 tokens]:
    a random walk along the tokens plus a channel offset, from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tokens = 4096
    channels = KV_BATCH * GRANITE["kv_heads"] * GRANITE["head_dim"]
    kv = np.cumsum(rng.standard_normal((channels, tokens), dtype=np.float32),
                   axis=1) * np.float32(0.05)
    kv += rng.standard_normal((channels, 1)).astype(np.float32)
    return kv


def granite_layer_state(seed: int) -> dict:
    """One granite-8b decoder layer's training state on the card, made with
    numpy from ``seed``: its parameters ~ N(0, 0.02) with Adam m and v as
    random walks along the flattened axis scaled to max-abs 1e-3 and 1e-6,
    all f32, and a raw int32 step counter."""
    import numpy as np
    import torch

    h, kv, f = (GRANITE["d_model"], GRANITE["kv_heads"] * GRANITE["head_dim"],
                GRANITE["d_ff"])
    shapes = {"q": (h, h), "k": (kv, h), "v": (kv, h), "o": (h, h),
              "gate": (f, h), "up": (f, h), "down": (h, f),
              "attn_norm": (h,), "mlp_norm": (h,)}
    rng = np.random.default_rng(seed)
    tree = {"params": {}, "m": {}, "v": {}}
    for name, shape in shapes.items():
        for part, scale in (("params", 0.02), ("m", 1e-3), ("v", 1e-6)):
            x = rng.standard_normal(shape, dtype=np.float32)
            if part == "params":
                x *= np.float32(scale)
            else:
                flat = x.reshape(-1)
                np.cumsum(flat, out=flat)
                x *= np.float32(scale / float(np.abs(flat).max()))
            tree[part][name] = torch.from_numpy(x).cuda()
    tree["step"] = torch.tensor(1000, dtype=torch.int32, device="cuda")
    return tree


@contextlib.contextmanager
def timers(specs):
    """Accumulate the wall seconds of each ``(module, attribute, key)``
    function's calls while the block runs.  Yields ``{key: seconds}``."""
    secs = {key: 0.0 for _, _, key in specs}
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in specs]

    def timed(fn, key):
        def run(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                secs[key] += time.perf_counter() - t
        return run

    for (mod, attr, fn), (_, _, key) in zip(saved, specs):
        setattr(mod, attr, timed(fn, key))
    try:
        yield secs
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def path_kernel_bound(name: str, args, kw):
    """(bytes, operations) of one path kernel call, each input read once
    and each output written once (the times phase's counts)."""
    if name == "encode_levels":
        x = args[0]
        k, wp = x.shape[0], x.shape[1] // kw["n"]
        small = 4 * kw["n"] * kw["e"] + 8 * kw["e"] + 8 + 4 * k
        return (4 * x.numel() + k * wp * kw["e"] + small,
                2.0 * k * wp * kw["n"] * kw["e"])
    if name == "symlen_pack":
        grid, chunk = args[0], kw["chunk_size"]
        k, sp = grid.shape[0], grid[0].numel()
        slots = k * (-(-sp // chunk)) * chunk
        return (grid.numel() + 4 * k + 12 * 256 + 12 * slots
                + 4 * slots // chunk + k, 0.0)
    if name == "symlen_decode":
        return 9 * args[0].shape[0] + kw["num_symbols"], 0.0
    levels, lut, basis = args  # lut_idct
    nw, e = levels.shape
    n = basis.shape[1]
    return (levels.numel() + 4 * lut.numel() + 4 * e * n + 4 * nw * n,
            2.0 * nw * e * n)


# per row-parallel path kernel, the positional arguments whose leading axis
# is the call's rows (the pack's zrow and zcol may be None)
ROW_ARGS = {"encode_levels": (0, 1), "symlen_pack": (0, 1, 2, 3),
            "lut_idct": (0,)}


def row_slices(name: str, calls, max_elems: int = 1 << 27) -> list:
    """The recorded ``calls`` of a row-parallel kernel as calls on blocks
    of rows (views), each output cut the same way, so that a plain version
    run on one block at a time stays within the card's memory at the
    checkpoint's shapes (the plain pack alone holds several int64 copies of
    its input).  Other kernels' calls pass through whole."""
    if name not in ROW_ARGS:
        return list(calls)
    out = []
    for args, kw, res in calls:
        rows = args[0].shape[0]
        step = max(1, max_elems // max(args[0][0].numel(), 1))
        for lo in range(0, rows, step):
            cut = slice(lo, lo + step)
            a = tuple(x[cut] if i in ROW_ARGS[name] and x is not None else x
                      for i, x in enumerate(args))
            r = (tuple(None if t is None else t[cut] for t in res)
                 if isinstance(res, tuple) else res[cut])
            out.append((a, kw, r))
    return out


def workloads_phase(smi: str, kv_gpu, enc, seed: int) -> dict:
    """Phase 9: the workloads (M8) at granite-8b's width (see the module
    docstring): ``KVCacheCodec`` on one layer's K cache, then a compressed
    checkpoint of one decoder layer's training state.  Returns its JSON
    line."""
    import shutil
    import tempfile

    import torch

    from repro_torch.core import dct
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.kernels import dct_quant as dq
    from repro_torch.kernels import idct_dequant as idq
    from repro_torch.kernels import ops
    from repro_torch.serving import KVCacheCodec
    from repro_torch.serving import workloads as wl
    from repro_torch.serving.engine import p2

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    # -- the KV codec: one layer's K cache, bf16 [B, T, H, D] ---------------
    channels, tokens = kv_gpu.shape
    b, h, d = KV_BATCH, GRANITE["kv_heads"], GRANITE["head_dim"]
    block = kv_gpu.reshape(b, h, d, tokens).permute(0, 3, 1, 2).to(
        torch.bfloat16).contiguous()
    codec = KVCacheCodec(encoder=enc)
    t0 = time.perf_counter()
    tab = codec.calibrate(block, layer="k")
    calibrate_s = time.perf_counter() - t0
    n, e = tab.config.n, tab.config.e
    ckv = codec.compress(block, layer="k")
    out = codec.decompress(ckv, layer="k")
    torch.cuda.synchronize()
    strips = block.movedim(1, -1).float().reshape(channels, tokens)
    want = enc.encode_fixed(strips, tab)
    check(ckv.levels.dtype == torch.uint8
          and tuple(ckv.levels.shape) == (b, h, d, tokens // n, e)
          and torch.equal(ckv.levels.reshape(want.shape), want),
          "KVCacheCodec.compress levels differ from encode_fixed's")
    check(out.dtype == torch.bfloat16 and out.shape == block.shape
          and out.is_contiguous(), f"decompress gave {out.dtype} "
          f"{tuple(out.shape)}")
    kv_rel = float(torch.linalg.vector_norm((out - block).float())
                   / torch.linalg.vector_norm(block.float()))
    check(bool(torch.isfinite(out).all()) and kv_rel < 0.05,
          f"KVCacheCodec reconstruction off: relative rms {kv_rel}")
    # warm above; now one compress and one decompress with host syncs
    # refused, each one K5 and one K3 launch
    ops.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ckv2 = codec.compress(block, layer="k")
        out2 = codec.decompress(ckv2, layer="k")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    kv_launches = dict(ops.LAUNCHES)
    check(kv_launches == {k: int(k in ("dct_quant", "idct_dequant"))
                          for k in kv_launches},
          f"KV codec launch counts {kv_launches}")
    check(torch.equal(ckv2.levels, ckv.levels) and torch.equal(out2, out),
          "KVCacheCodec is not deterministic")
    del ckv2, out2, want
    plan = enc.plan_for(tab)
    q, x = plan.tables.quant, codec.channel_strips(block)
    lv, ibasis = ckv.levels.reshape(-1, e), dct.idct_basis(n, e,
                                                           device="cuda")
    xdec = codec.decoder.decode_fixed(ckv.levels, tab, length=tokens)
    back = torch.empty_like(block)
    kv_ms = {
        "compress": cuda_ms(lambda: codec.compress(block, layer="k")),
        "decompress": cuda_ms(lambda: codec.decompress(ckv, layer="k")),
        "transpose_in": cuda_ms(lambda: codec.channel_strips(block)),
        "dct_quant": cuda_ms(lambda: dq.dct_quant(
            x.reshape(-1, n), q, e=e, basis=plan.basis)),
        "idct_dequant": cuda_ms(lambda: idq.idct_dequant(lv, q, ibasis)),
        "transpose_out": cuda_ms(lambda: back.copy_(xdec.movedim(-1, 1))),
    }
    # bf16 in and u8 out (or back): the codec's bytes as one function
    cells = block.numel()
    kv_bound = {
        "compress": bound_ms(3 * cells, 2.0 * cells * e)[0],
        "decompress": bound_ms(3 * cells, 2.0 * cells * e)[0],
        "dct_quant": bound_ms(5 * cells + 4 * n * e, 2.0 * cells * e)[0],
        "idct_dequant": bound_ms(5 * cells + 4 * n * e, 2.0 * cells * e)[0],
    }
    kv_line = {"shape": list(block.shape), "dtype": "bfloat16",
               "levels": list(ckv.levels.shape), "bytes_in": 2 * cells,
               "bytes_levels": ckv.nbytes, "ratio": ckv.ratio,
               "calibrate_s": calibrate_s, "rel_rms_err": kv_rel,
               "levels_equal_encode_fixed": True, "launches": kv_launches,
               "sync_debug_mode": "error", "ms": kv_ms,
               "bound_ms": kv_bound}
    del block, strips, out, ckv, x, lv, xdec, back
    torch.cuda.empty_cache()

    # -- the checkpoint: one decoder layer's training state -----------------
    t0 = time.perf_counter()
    tree = granite_layer_state(seed)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    leaves = [(part, k, t) for part in ("params", "m", "v")
              for k, t in tree[part].items()]
    float_bytes = sum(t.numel() * 4 for _, _, t in leaves)
    n_params = sum(t.numel() for t in tree["params"].values())
    tmp = tempfile.mkdtemp(prefix="fptc_ckpt_")
    save_specs = [(ckpt, "calibrate_train_state", "calibrate"),
                  (wl, "shard_state", "shard"),
                  (ckpt, "state_to_containers", "shard_encode")]
    restore_specs = [(ckpt, "_read_containers", "read_crc"),
                     (ckpt, "state_from_containers", "decode_unshard"),
                     (wl, "unshard_state", "unshard"),
                     (ckpt, "_place", "to_device")]
    try:
        torch.cuda.synchronize()
        ops.reset_launches()
        with recorded(path_hooks(CKPT_KERNELS)) as calls:
            with timers(save_specs) as ssec:
                t0 = time.perf_counter()
                path = ckpt.save_checkpoint(tmp, 1, tree, compress=True)
                save_s = time.perf_counter() - t0
            save_launches = dict(ops.LAUNCHES)
            ops.reset_launches()
            with timers(restore_specs) as rsec:
                t0 = time.perf_counter()
                step, got = ckpt.restore_latest(tmp, tree)
                torch.cuda.synchronize()
                restore_s = time.perf_counter() - t0
            restore_launches = dict(ops.LAUNCHES)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        files = sorted(os.listdir(path))
        disk = {name: os.path.getsize(os.path.join(path, name))
                for name in files}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    state = manifest["state"]
    step_entry = manifest["leaves"]["['step']"]
    check(manifest["version"] == 2 and state["file"] == "state.fptc"
          and step_entry["dtype"] == "int32" and "codec" not in step_entry
          and files == sorted(["manifest.json", "state.fptc",
                               step_entry["file"] + ".npy"])
          and all(manifest["leaves"][f"['{p}']['{k}']"]["codec"]
                  == "fptc_state" for p, k, _ in leaves),
          f"checkpoint manifest: version {manifest['version']}, files "
          f"{files}")
    lengths = [s for leaf in state["leaves"] for s in leaf["lengths"]]
    enc_buckets = len({p2(-(-s // ckpt.CKPT_CODEC_CONFIG.n))
                       for s in lengths})
    # one plan key (the train_state tables): one decode bucket
    want = {k: 0 for k in save_launches}
    want.update(encode_levels=enc_buckets, symlen_pack=enc_buckets)
    check(save_launches == want, f"save launch counts {save_launches} != "
          f"{want}")
    want = {k: 0 for k in restore_launches}
    want.update(symlen_decode=1, lut_idct=1)
    check(restore_launches == want, f"restore launch counts "
          f"{restore_launches} != {want}")
    check(step == 1 and int(got["step"]) == 1000 and got["step"].is_cuda,
          f"restored step {step}, counter {got['step']}")
    rel = {}
    for part, k, t in leaves:
        r = got[part][k]
        check(r.is_cuda and r.dtype == t.dtype and r.shape == t.shape,
              f"restored {part}.{k}: {r.device} {r.dtype} {tuple(r.shape)}")
        rel[f"{part}.{k}"] = float(torch.linalg.vector_norm(r - t)
                                   / torch.linalg.vector_norm(t))
    worst = max(rel.values())
    check(worst < 0.02, f"checkpoint leaves off: relative rms {rel}")
    check(disk["state.fptc"] < 0.8 * float_bytes,
          f"state.fptc {disk['state.fptc']} B of {float_bytes} float bytes")
    del got, tree, leaves, r, t
    torch.cuda.empty_cache()
    # every recorded call against its plain version, after its time
    launches = {**save_launches, **{k: v for k, v in restore_launches.items()
                                    if v}}
    kernels = {}
    for mod, attr, name, plain in path_hooks(CKPT_KERNELS):
        rows = calls.pop(name)
        check(bool(rows), f"no {name} call recorded on the checkpoint path")
        if not rows:
            continue
        fn = getattr(mod, attr)
        per_call = []  # (ms, bytes, operations) of each call
        for args, kw, _ in rows:
            per_call.append((cuda_ms(lambda: fn(*args, **kw), reps=3),
                             *path_kernel_bound(name, args, kw)))
        res = served_vs_plain(name, row_slices(name, rows), plain)
        res["calls"] = len(rows)
        check(res["ok"] and res["calls"] == launches[name],
              f"{name} at the checkpoint's shapes against its plain "
              f"version: {res}, {launches[name]} launches")
        total = bound_ms(sum(c[1] for c in per_call),
                         sum(c[2] for c in per_call))
        kernels[name] = {
            **res, "ms": sum(c[0] for c in per_call), "bound_ms": total[0],
            "bound_by": total[1],
            "by_call": [{"input_shape": list(a[0].shape), "ms": c[0],
                         "bound_ms": bound_ms(c[1], c[2])[0]}
                        for (a, _, _), c in zip(rows, per_call)]}
        del rows, args, kw
        torch.cuda.empty_cache()
    del calls
    torch.cuda.empty_cache()
    encode_s = ssec["shard_encode"] - ssec["shard"]
    decode_s = rsec["decode_unshard"] - rsec["unshard"]
    return {
        "phase": "workloads", "nvidia_smi": smi, "kv": kv_line,
        "checkpoint": {
            "model": "granite-8b, one decoder layer: params, Adam m and v "
            "(f32), an int32 step", "parameters": n_params,
            "float_elements": float_bytes // 4, "float_bytes": float_bytes,
            "shards": len(lengths), "encode_buckets": enc_buckets,
            "make_s": make_s, "save_s": save_s, "restore_s": restore_s,
            "save_split_s": {
                "calibrate": ssec["calibrate"], "shard": ssec["shard"],
                "encode": encode_s,
                "write": save_s - ssec["calibrate"] - ssec["shard_encode"]},
            "restore_split_s": {
                "read_crc": rsec["read_crc"], "decode": decode_s,
                "unshard": rsec["unshard"], "to_device": rsec["to_device"],
                "other": restore_s - rsec["read_crc"]
                - rsec["decode_unshard"] - rsec["to_device"]},
            "disk_bytes": disk, "ratio": disk["state.fptc"] / float_bytes,
            "rel_rms_err": rel, "max_rel_rms_err": worst,
            "save_launches": save_launches,
            "restore_launches": restore_launches, "kernels": kernels},
        "seconds": time.perf_counter() - t_phase}


# -- 13. lm: granite-8b served at full width ---------------------------------
# the card's bf16 dense tensor-core peak (H100 SXM data sheet)
PEAK_BF16_PER_S = 989e12
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "granite-8b", 8, 4096, 32
# prefill(S) against prefill(S - 1) + decode_step at full width, relative
# L2 of the last token's logits: bf16 noise in two summation orders, about
# 10x what lm_conditioning.py measures at 2-4 of granite-8b's layers on
# the CPU (0.0050-0.0053)
LM_CONSISTENCY_TOL = 0.05
LM_DRIFT_TOL = 0.15  # the reference's bound (tests/test_serving.py:80)
LM_CARD_CPU_TOL = 2.0 ** -6  # the CPU parity tests' bound (2 bf16 ulps)
LM_SMOKE_STEPS = 4
# hymba-1.5b's gap at its 32 layers on the H100: 0.0713 with the
# reference's decode conv, 0.0712 with the conv summed tap by tap as the
# prefill sums it (``lm_conditioning.py --arch hymba-15b [--decode-conv
# taps]``; PERF.md): R11 is not what makes it, its cause is not
# known.  The bound keeps a 1.4x margin over both readings and fails a
# change that doubles the gap.
HYBRID_CONSISTENCY_TOL = 0.10


def rel_l2(got, want) -> float:
    import torch

    return float(torch.linalg.vector_norm((got - want).float())
                 / torch.linalg.vector_norm(want.float()))


@contextlib.contextmanager
def kv_kernels_held():
    """Every K5 and K3 call the KV codec makes while the block runs, held
    at once against its plain version on the same inputs: K5's levels
    exactly, K3's floats within ``REL_TOL``.  Yields the running tally."""
    from repro_torch.kernels import dct_quant as dq
    from repro_torch.kernels import idct_dequant as idq
    from repro_torch.serving import batch_decode, batch_encode

    tally = {"dct_quant": {"calls": 0, "cells": 0, "flips": 0,
                           "max_abs_err": 0},
             "idct_dequant": {"calls": 0, "max_abs_err": 0.0,
                              "rel_err": 0.0}}
    k5, k3 = batch_encode.dct_quant, batch_decode.idct_dequant

    def held_k5(windows, quant, *, e, basis, exact=False):
        out = k5(windows, quant, e=e, basis=basis, exact=exact)
        want = dq.dct_quant_plain(windows, quant, basis)
        t = tally["dct_quant"]
        t["calls"] += 1
        t["cells"] += out.numel()
        t["flips"] += int((out != want).sum())
        t["max_abs_err"] = max(t["max_abs_err"], int_err(out, want))
        return out

    def held_k3(levels, quant, basis):
        out = k3(levels, quant, basis)
        want = idq.idct_dequant_plain(levels, quant, basis)
        t = tally["idct_dequant"]
        t["calls"] += 1
        t["rel_err"] = max(t["rel_err"], rel_err(out, want))
        t["max_abs_err"] = max(t["max_abs_err"],
                               float((out - want).abs().max()))
        return out

    batch_encode.dct_quant, batch_decode.idct_dequant = held_k5, held_k3
    try:
        yield tally
    finally:
        batch_encode.dct_quant, batch_decode.idct_dequant = k5, k3


def device_profile(fn, ms: float, top: int = 6) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (``profiled_events``):
    the device time of its kernels and copies, their count, the share of
    ``ms`` (the call's unprofiled CUDA-event time) the device sat idle,
    and the ``top`` kernels by device time."""
    events, sessions = profiled_events(fn)
    dev = {ev.key: ev.self_device_time_total / 1e3 for ev in events}
    device_ms = sum(dev.values())
    return {"device_ms": device_ms,
            "kernels": sum(ev.count for ev in events),
            "idle_share": max(0.0, 1.0 - device_ms / ms),
            "sessions": sessions,
            "top_ms": sorted(([k[:80], v] for k, v in dev.items()),
                             key=lambda kv: -kv[1])[:top]}


@contextlib.contextmanager
def exact_bf16_sums():
    """bf16 matmuls with fp32 reductions (TF32 stays as ``main`` set it)
    while the block runs.  Yields the settings, for the phase's line."""
    import torch

    mm = torch.backends.cuda.matmul
    reduced = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield {"allow_tf32": mm.allow_tf32,
               "allow_bf16_reduced_precision_reduction": False,
               "allow_bf16_reduced_precision_reduction_before": reduced}
    finally:
        mm.allow_bf16_reduced_precision_reduction = reduced


RUN_WHAT = {
    "what": "CUDA events after one warm call; decode over the greedy steps "
    "through make_serve_fns, argmax on the card; bounds as family_bounds "
    "counts them; moe_dropped: (token, k) pairs each MoE layer dropped in "
    "each call",
    "profile_what": "torch.profiler over one call: device ms of its kernels "
    "and copies, their count, idle share of the unprofiled ms, the top "
    "kernels by device ms"}


def lm_phase(smi: str, seed: int) -> dict:
    """Phase 13: the LM serving path (M10a) on the card, granite-8b whole
    through ``family_run`` (see the module docstring).  Returns its JSON
    line; frees the model before it returns."""
    from repro_torch.configs import get_arch

    t_phase = time.perf_counter()
    with exact_bf16_sums() as precision:
        run = family_run(LM_ARCH, get_arch(LM_ARCH), LM_BATCH, LM_PROMPT,
                         LM_GEN, seed)
    return {"phase": "lm", "nvidia_smi": smi, "precision": precision,
            **RUN_WHAT, **run, "seconds": time.perf_counter() - t_phase}


# -- 14. train: granite-8b trained at full width, 2 layers --------------------
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = "granite-8b", 2, 2, 4096
TRAIN_OPT = dict(base_lr=3e-4, warmup=2, total_steps=100)
TRAIN_STEPS, TRAIN_MEMO_STEPS = 4, 8
# B's step-3 loss (resumed through the compressed checkpoint after step 1)
# against A's (never interrupted), relative.  A lossy m and v this early
# (two steps of sign-like updates) moves the next steps' losses by the
# order of the choice of how the restored v is brought back
# (train_resume_probe.py on the H100: AdamW.project puts steps 3-5 0.9%,
# 1.1% and 0.1% from A's, a floor at a steady gradient's v/m**2 0.3-0.5%;
# v's absolute value, or m zeroed where v came back negative, diverge to
# losses of 116-259; a raw checkpoint resumes bit for bit).  2**-6 is
# about an eighth of step 3's own loss change
TRAIN_RESUME_TOL = 2.0 ** -6
# a compressed leaf's relative rms: the reference's bound (its test's, on
# one smooth tensor; the workloads phase holds it on a synthetic state) is
# reported here, leaf by leaf and over the state, not held: on this real
# Adam state after 2 steps the unembedding's m comes back at 0.030 and the
# state at 0.022 (PERF.md).  What is held is the resumed loss
# (TRAIN_RESUME_TOL) and, against a broken codec (errors near 1), every
# leaf within TRAIN_CKPT_GUARD
TRAIN_CKPT_REL_RMS = 0.02
TRAIN_CKPT_GUARD = 0.05
# the smoke granite's 3 steps on the card against the CPU: each loss
# relative, and the weights' change over the 3 steps relative L2 (the CPU
# trajectory bounds of tests/test_torch_train.py)
TRAIN_CARD_CPU_LOSS_TOL = 2.0 ** -8
TRAIN_CARD_CPU_CHANGE_TOL = 2.0 ** -2


def recurrence_ops(cfg, tokens: int) -> float:
    """The fp32 operations of one forward of every layer's recurrence over
    ``tokens`` tokens: RWKV's wkv ``5 hd^2 + 4 hd`` a head and token (as
    ``family_bounds`` counts it), the hybrid's SSM scan ``d_in (7 N + 1)``
    a token (over ``d_in x N``: ``dt A``, its exp, the input term ``dt x
    B``, the decay's multiply-add, the ``C . h`` contraction; ``dt x`` over
    ``d_in``); 0 for a family with neither."""
    from repro_torch.models import ssm as ssm_mod

    if cfg.family == "ssm":
        hd = cfg.rwkv_head_size
        per = cfg.d_model // hd * (5 * hd * hd + 4 * hd)
    elif cfg.hybrid_parallel:
        d_in, _, n, _ = ssm_mod._dims(cfg)
        per = d_in * (7 * n + 1)
    else:
        return 0.0
    return float(cfg.num_layers * tokens * per)


def train_bound(model, tokens: int, b: int, s: int) -> dict:
    """The card's least time for one train step: the matmul operations at
    the bf16 peak, the layers' as ``forward_ops`` counts a forward over
    the batch (the weights at every token, a MoE layer's experts at its
    ``E * C`` slots, the attention's unmasked S x S score rectangle as the
    reference computes it, MLA's qk ``nope + rope`` and v ``v_dim``,
    whisper's encoder and cross k/v at its frames, its F x F encoder and
    S x F cross rectangles) in four passes: the forward, the
    rematerialized forward and twice in the backward; the unembedding at
    every token forward and twice backward; beside them the recurrences'
    fp32 operations (``recurrence_ops``) at the fp32 peak in the same four
    passes and, when the scan checkpoints its chunks
    (``s % 128 == 0 and s > 128``), a fifth, the chunks' recompute;
    against the bytes (the weights, m and v read once and written once,
    the tokens and labels, whisper's frames), the larger."""
    cfg = model.cfg
    dense, slots, routed, attn, _ = forward_ops(model, b, tokens, s, s)
    unembed = 2.0 * cfg.d_model * cfg.vocab_size * tokens
    ops_ = 4.0 * (dense + slots + attn) + 3.0 * unembed
    fp32_ops = (4.0 + (s % 128 == 0 and s > 128)) * recurrence_ops(
        cfg, tokens)
    nbytes = 2 * sum(p.numel() * (p.element_size() + 8)
                     for p in model.parameters()) + 8 * tokens
    if cfg.family == "audio":
        nbytes += 2 * b * cfg.encoder_seq * cfg.d_model
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = (ops_ / PEAK_BF16_PER_S + fp32_ops / PEAK_FP32_PER_S) * 1e3
    return {"ms": max(tb, to), "by": "bytes" if tb >= to else "operations",
            "bytes": nbytes, "operations": ops_, "fp32_operations": fp32_ops,
            "routed_operations": 4.0 * (dense + routed + attn)
            + 3.0 * unembed, "moe_slot_operations": 4.0 * slots}


@contextlib.contextmanager
def ckpt_kernels_held(names):
    """Every call of the named checkpoint-path kernels while the block
    runs, where the engines call it: CUDA-event ms of the call itself
    (``first_ms``), then the call held at once against its plain version
    on the same inputs (on blocks of rows, ``row_slices``) by the serve
    phase's rules (``encode_levels``: at most ``max(1, FLIP_SHARE *
    cells)`` flips a call, and ``FLIP_SHARE`` of all the block's cells),
    its ms over 2 more calls after a warm one (the launch
    counters put back), and its bytes and operations
    (``path_kernel_bound``).  Held at once, not recorded: clones of a train
    state's buckets would not fit beside it.  Yields ``{name: tally}`` and,
    under ``"check_s"``, the host seconds the checks and the timing took
    (to take out of the walls)."""
    import torch

    from repro_torch.kernels import ops

    hooks = path_hooks(names)
    tally = {name: {"calls": 0, "ok": True, "max_abs_err": 0.0, "ms": 0.0,
                    "first_ms": 0.0, "bytes": 0.0, "operations": 0.0,
                    "flips": 0, "cells": 0, "results": [], "by_call": []}
             for name in names}
    tally["check_s"] = 0.0

    def holder(fn, name, plain):
        def run(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            stop.record()
            stop.synchronize()
            t0 = time.perf_counter()
            kwp = {k: v for k, v in kw.items() if k != "rw"}
            res = served_vs_plain(name, row_slices(
                name, [(args, kwp, out)]), plain, min_flips=1)
            nb, ops_ = path_kernel_bound(name, args, kwp)
            first_ms = start.elapsed_time(stop)
            counts = dict(ops.LAUNCHES)  # the timing's launches are not
            ms = cuda_ms(lambda: fn(*args, **kw), reps=2)  # the path's
            ops.LAUNCHES.update(counts)
            t = tally[name]
            t["calls"] += 1
            t["ok"] &= res["ok"]
            t["max_abs_err"] = max(t["max_abs_err"], res["max_abs_err"])
            t["flips"] += res.get("flips", 0)
            t["cells"] += res.get("cells", 0)
            t["results"].append(res)
            t["ms"] += ms
            t["bytes"] += nb
            t["operations"] += ops_
            t["first_ms"] += first_ms
            t["by_call"].append({"input_shape": list(args[0].shape),
                                 "ms": ms, "first_ms": first_ms,
                                 "bound_ms": bound_ms(nb, ops_)[0]})
            torch.cuda.synchronize()
            tally["check_s"] += time.perf_counter() - t0
            return out
        return run

    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in hooks]
    for (mod, attr, fn), (_, _, name, plain) in zip(saved, hooks):
        setattr(mod, attr, holder(fn, name, plain))
    try:
        yield tally
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    for name in names:
        t = tally[name]
        t["ok"] &= t["flips"] <= FLIP_SHARE * t["cells"]


def train_batches(cfg, b: int, s: int, seed: int, n: int, device) -> list:
    """``n`` batches of ``TokenPipeline`` tokens (``launch.train``'s
    ``make_batch``), the audio family's frames N(0, 1) drawn on ``device``
    from ``seed + i`` in place of the launcher's zeros."""
    import torch

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.train import make_batch

    pipe = TokenPipeline(cfg.vocab_size, b, s, seed=seed)
    out = []
    for i in range(n):
        batch = make_batch(cfg, pipe, i)
        if cfg.family == "audio":
            batch["frames"] = torch.randn(
                tuple(batch["frames"].shape), device=device,
                generator=torch.Generator(device=device).manual_seed(
                    seed + i)).to(torch.bfloat16)
        out.append(batch)
    return out


def smoke_card_vs_cpu(arch: str, seed: int, b: int = 2, s: int = 64
                      ) -> dict:
    """The smoke ``arch`` drawn on the CPU from ``seed``, 3 train steps
    there and 3 on the card from the same draw: the losses within
    ``TRAIN_CARD_CPU_LOSS_TOL`` and the weights' change within
    ``TRAIN_CARD_CPU_CHANGE_TOL`` (phases 14 and 16)."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.distributed.optimizer import AdamW, AdamWConfig
    from repro_torch.distributed.train import make_train_step
    from repro_torch.models import build_model

    smoke = get_smoke(arch)
    batches = train_batches(smoke, b, s, seed, 3, "cpu")
    arms = {}
    for dev in ("cpu", "cuda"):
        small = build_model(smoke, device="cpu",
                            generator=torch.Generator().manual_seed(seed))
        start_w = {n: p.detach().float().clone()
                   for n, p in small.named_parameters()}
        sts = make_train_step(small, AdamW(AdamWConfig(**TRAIN_OPT)), dev)
        sst, losses = sts.init(), []
        for batch in batches:
            sst, met = sts.step_fn(sst, batch)
            losses.append(float(met["loss"]))
        arms[dev] = (losses, {n: p.detach().float().cpu() - start_w[n]
                              for n, p in small.named_parameters()})
    (lc, dc), (lg, dg) = arms["cpu"], arms["cuda"]
    loss_rel = max(abs(g - c) / abs(c) for g, c in zip(lg, lc))
    num = sum(float(torch.sum((dg[n] - dc[n]) ** 2)) for n in dc)
    den = sum(float(torch.sum(dc[n] ** 2)) for n in dc)
    change_rel = (num / den) ** 0.5
    check(loss_rel <= TRAIN_CARD_CPU_LOSS_TOL
          and change_rel <= TRAIN_CARD_CPU_CHANGE_TOL,
          f"smoke {arch}'s 3 steps, card against CPU: losses {lg} vs "
          f"{lc} ({loss_rel}), weights' change {change_rel}")
    return {"arch": smoke.name, "steps": 3, "losses_cpu": lc,
            "losses_card": lg, "loss_rel": loss_rel,
            "change_rel_l2": change_rel,
            "tol": [TRAIN_CARD_CPU_LOSS_TOL, TRAIN_CARD_CPU_CHANGE_TOL]}


def compressed_resume(model, st, opt, tmp: str, step: int) -> tuple:
    """A train state's resume through a compressed checkpoint on the card
    (phases 14, 16 and 17): with every launch counter at 0,
    ``save_train_state(compress=True)`` at ``step`` (the weights raw), every
    K4 call held at once against its plain version (``ckpt_kernels_held``);
    the live weights, m and v overwritten with NaN; ``restore_latest`` with
    every K1 / ``lut_idct`` call held the same way, and
    ``load_train_state``.  Held: the manifest (v2, one
    ``state.fptc``, m and v's leaves of 4096 elements or more in it, every
    other leaf a raw ``.npy``), the launch counts (K4 once per encode
    bucket, K1 and ``lut_idct`` once per engine call:
    ``workloads.engine_calls``), every raw leaf bit for bit, every
    compressed leaf within ``TRAIN_CKPT_GUARD`` (each leaf's relative rms
    and the state's reported against the reference's
    ``TRAIN_CKPT_REL_RMS``), the blob under 0.8 of the compressed leaves'
    float bytes.  Returns the restored ``OptState`` and the report: the
    save and restore walls split into their steps (with and without the
    in-line checks), peak memory in each, the bytes, each kernel's ms and
    bound at the state's shapes."""
    import torch

    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.kernels import ops
    from repro_torch.models import convert
    from repro_torch.models.convert import (
        load_train_state,
        train_state_tree,
    )
    from repro_torch.serving import workloads as wl
    from repro_torch.serving.engine import p2

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    save_specs = [(ckpt, "calibrate_train_state", "calibrate"),
                  (wl, "shard_state", "shard"),
                  (ckpt, "state_to_containers", "shard_encode")]
    restore_specs = [(ckpt, "_read_containers", "read_crc"),
                     (ckpt, "state_from_containers", "decode_unshard"),
                     (wl, "unshard_state", "unshard"),
                     (ckpt, "_place", "to_device")]
    # a port that predates save_train_state saves the whole tree; no fp32
    # weight of the states its phases save reaches the codec's 4096 elements
    save = getattr(convert, "save_train_state", lambda d, s, m, o, **kw:
                   ckpt.save_checkpoint(d, s, train_state_tree(m, o), **kw))
    ops.reset_launches()
    with ckpt_kernels_held(CKPT_KERNELS) as held_save, \
            timers(save_specs) as ssec:
        t0 = time.perf_counter()
        path = save(tmp, step, model, st, compress=True)
        save_s = time.perf_counter() - t0
    save_launches = dict(ops.LAUNCHES)
    peak_save = torch.cuda.max_memory_allocated()
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    files = sorted(os.listdir(path))
    disk = {name: os.path.getsize(os.path.join(path, name))
            for name in files}
    # what was saved, kept to compare; then the live state overwritten
    saved = _tree_map(lambda t: t.clone(), train_state_tree(model, st))
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float("nan"))
        for t in (*st.m.values(), *st.v.values()):
            t.fill_(float("nan"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with ckpt_kernels_held(CKPT_KERNELS) as held_restore, \
            timers(restore_specs) as rsec:
        t0 = time.perf_counter()
        got_step, got = ckpt.restore_latest(tmp, saved)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    restore_launches = dict(ops.LAUNCHES)
    peak_restore = torch.cuda.max_memory_allocated()
    state = manifest["state"]
    check(manifest["version"] == 2 and state["file"] == "state.fptc"
          and got_step == step, f"checkpoint: version "
          f"{manifest['version']}, state {state.get('file')}, step "
          f"{got_step}")
    leaves = manifest["leaves"]
    compressed = {k for k, e in leaves.items()
                  if e.get("codec") == "fptc_state"}
    raw_leaves = set(leaves) - compressed
    check(compressed == {k for k, e in leaves.items()
                         if not k.startswith("['params']")
                         and math.prod(e["shape"]) >= 4096}
          and files == sorted(["manifest.json", "state.fptc"]
                              + [leaves[k]["file"] + ".npy"
                                 for k in raw_leaves]),
          f"checkpoint files {files}, compressed leaves {sorted(compressed)}")
    lengths = [n for leaf in state["leaves"] for n in leaf["lengths"]]
    calls = wl.engine_calls(lengths)
    enc_buckets = sum(
        len({p2(-(-n // ckpt.CKPT_CODEC_CONFIG.n)) for n in lengths[c]})
        for c in calls)
    want = {k: 0 for k in save_launches}
    want.update(encode_levels=enc_buckets, symlen_pack=enc_buckets)
    check(save_launches == want, f"checkpoint save launch counts "
          f"{save_launches} != {want}")
    want = {k: 0 for k in restore_launches}
    want.update(symlen_decode=len(calls), lut_idct=len(calls))
    check(restore_launches == want, f"checkpoint restore launch counts "
          f"{restore_launches} != {want}")
    rel, raw_equal, sums = {}, True, {"m": [0.0, 0.0], "v": [0.0, 0.0]}
    float_bytes = 0
    for (key, a), (_, r) in zip(_flat(saved), _flat(got)):
        check(r.is_cuda and r.dtype == a.dtype and r.shape == a.shape,
              f"restored {key}: {r.device} {r.dtype} {tuple(r.shape)}")
        if "['" + "']['".join(key.split(".")) + "']" not in compressed:
            raw_equal &= bool(torch.equal(r, a))
            continue
        err = float(torch.linalg.vector_norm(r - a)) ** 2
        ref = float(torch.linalg.vector_norm(a)) ** 2
        rel[key] = (err / ref) ** 0.5
        sums[key.split(".")[0]][0] += err
        sums[key.split(".")[0]][1] += ref
        float_bytes += a.numel() * a.element_size()
    check(len(rel) == len(compressed), f"{len(rel)} compressed leaves "
          f"restored of {len(compressed)}")
    worst = max(rel.values())
    part_rel = {part: (e / r) ** 0.5 for part, (e, r) in sums.items()}
    state_rel = (sum(e for e, _ in sums.values())
                 / sum(r for _, r in sums.values())) ** 0.5
    check(raw_equal, "a raw leaf did not come back bit for bit")
    check(worst < TRAIN_CKPT_GUARD, f"checkpoint leaves off: relative rms "
          f"{state_rel} (m, v: {part_rel}; by leaf {rel})")
    check(disk["state.fptc"] < 0.8 * float_bytes,
          f"state.fptc {disk['state.fptc']} B of {float_bytes} float bytes")
    negative_v = sum(int((t < 0).sum()) for _, t in _flat(got["v"]))
    st = load_train_state(got, model, st, got_step, opt)
    del got, saved
    launches = {**save_launches, **{k: v for k, v in
                                    restore_launches.items() if v}}
    kernels = {}
    for name in CKPT_KERNELS:
        t = (held_save if name.startswith(("encode", "symlen_pack"))
             else held_restore)[name]
        check(t["ok"] and t["calls"] == launches[name] > 0,
              f"{name} at the train state's shapes against its plain "
              f"version: {t['calls']} calls, {launches[name]} launches, "
              f"{t['results']}")
        total = bound_ms(t["bytes"], t["operations"])
        extra = {}
        if name == "encode_levels":
            extra = {k: sum(r[k] for r in t["results"])
                     for k in ("flips", "deadzone_moves", "cells")}
        kernels[name] = {"launches": launches[name], "calls": t["calls"],
                         "ok": t["ok"], "max_abs_err": t["max_abs_err"],
                         **extra, "ms": t["ms"], "first_ms": t["first_ms"],
                         "bound_ms": total[0], "bound_by": total[1],
                         "by_call": t["by_call"]}
    save_check = held_save["check_s"]
    restore_check = held_restore["check_s"]
    report = {
        "manifest_version": manifest["version"], "files": len(files),
        "leaves": len(leaves), "compressed": len(compressed),
        "engine_calls": len(calls), "shards": len(lengths),
        "encode_buckets": enc_buckets, "save_launches": save_launches,
        "restore_launches": restore_launches,
        "save_s": save_s, "restore_s": restore_s,
        "save_check_s": save_check, "restore_check_s": restore_check,
        "save_s_less_checks": save_s - save_check,
        "restore_s_less_checks": restore_s - restore_check,
        "save_split_s": {
            "calibrate": ssec["calibrate"], "shard": ssec["shard"],
            "encode_with_checks": ssec["shard_encode"] - ssec["shard"],
            "write": save_s - ssec["calibrate"] - ssec["shard_encode"]},
        "restore_split_s": {
            "read_crc": rsec["read_crc"],
            "decode_with_checks": rsec["decode_unshard"] - rsec["unshard"],
            "unshard": rsec["unshard"], "to_device": rsec["to_device"],
            "other": restore_s - rsec["read_crc"]
            - rsec["decode_unshard"] - rsec["to_device"]},
        "disk_bytes": {"state.fptc": disk["state.fptc"],
                       "raw_npy": sum(v for k, v in disk.items()
                                      if k.endswith(".npy"))},
        "float_bytes": float_bytes,
        "ratio": disk["state.fptc"] / float_bytes,
        "state_rel_rms_err": state_rel, "part_rel_rms_err": part_rel,
        "max_rel_rms_err": worst, "rel_rms_err": rel,
        "rel_rms_reported_against": TRAIN_CKPT_REL_RMS,
        "leaves_over_it": sorted(k for k, v in rel.items()
                                 if v >= TRAIN_CKPT_REL_RMS),
        "rel_rms_guard": TRAIN_CKPT_GUARD,
        "restored_v_negative": negative_v,
        "peak_save": peak_save, "peak_restore": peak_restore,
        "kernels": kernels}
    return st, report


def train_phase(smi: str, seed: int) -> dict:
    """Phase 14: LM training (M10b) on the card (see the module docstring).
    Returns its JSON line; frees the model before it returns."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed.optimizer import AdamW, AdamWConfig
    from repro_torch.distributed.train import make_train_step
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    precision = {
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "allow_bf16_reduced_precision_reduction": False}
    b, s = TRAIN_BATCH, TRAIN_SEQ
    tmp = tempfile.mkdtemp(prefix="fptc_train_")
    try:
        # -- granite-8b at full width, 2 layers, weights from the seed -----
        full = get_arch(TRAIN_ARCH)
        check(full.d_model == 4096 and full.num_heads == 32
              and full.num_kv_heads == 8 and full.head_dim == 128
              and full.d_ff == 14336 and full.vocab_size == 49152,
              f"{TRAIN_ARCH} is not at full width: {full}")
        cfg = full.replace(num_layers=TRAIN_LAYERS)
        gen = torch.Generator(device="cuda")
        t0 = time.perf_counter()
        model = build_model(cfg, device="cuda",
                            generator=gen.manual_seed(seed))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        opt = AdamW(AdamWConfig(**TRAIN_OPT))
        ts = make_train_step(model, opt)
        batches = train_batches(cfg, b, s, seed, TRAIN_STEPS + 1, "cuda")
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)

        def restart():
            with torch.no_grad():
                model.init_weights(gen.manual_seed(seed))
            return ts.init()

        # -- (a) run A: steps 0-3 from the seed's weights, timed -----------
        st, run_a, step_ms = ts.init(), [], []
        for i in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            start.record()
            st, met = ts.step_fn(st, batches[i])
            stop.record()
            stop.synchronize()
            if i:  # step 0 warms
                step_ms.append(start.elapsed_time(stop))
            run_a.append((float(met["loss"]), float(met["grad_norm"])))
        check(all(np.isfinite(x) for r in run_a for x in r),
              f"run A: a loss or grad norm is not finite: {run_a}")
        # one more step under the profiler (not part of any check)
        profile = device_profile(
            lambda: ts.step_fn(st, batches[TRAIN_STEPS]),
            sum(step_ms) / len(step_ms), top=12)
        bound = train_bound(model, b * s, b, s)
        peak_steps = torch.cuda.max_memory_allocated()

        # -- (c) run B: steps 0-1, the compressed checkpoint, 2-3 ----------
        st = restart()
        run_b = []
        for i in range(2):
            st, met = ts.step_fn(st, batches[i])
            run_b.append(float(met["loss"]))
        st, resume = compressed_resume(model, st, opt, tmp, 2)
        for i in range(2, TRAIN_STEPS):
            st, met = ts.step_fn(st, batches[i])
            run_b.append(float(met["loss"]))
        resume_rel = abs(run_b[3] - run_a[3][0]) / abs(run_a[3][0])
        check(all(np.isfinite(run_b)) and resume_rel <= TRAIN_RESUME_TOL,
              f"resumed run B's step-3 loss {run_b} against run A's "
              f"{[r[0] for r in run_a]}: relative {resume_rel} > "
              f"{TRAIN_RESUME_TOL}")

        # -- (b) one repeated batch, 8 steps: the loss falls ---------------
        st = restart()
        memo = []
        for _ in range(TRAIN_MEMO_STEPS):
            st, met = ts.step_fn(st, batches[0])
            memo.append(float(met["loss"]))
        check(np.isfinite(memo).all() and memo[-1] < memo[0],
              f"one repeated batch: the loss did not fall: {memo}")
        del st, met, model, ts, batches
        gc.collect()
        torch.cuda.empty_cache()

        # -- (d) the smoke granite: 3 steps on the CPU and on the card -----
        card_vs_cpu = smoke_card_vs_cpu(TRAIN_ARCH, seed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "phase": "train", "nvidia_smi": smi, "arch": TRAIN_ARCH,
        "config": {"layers": cfg.num_layers, "full_layers": full.num_layers,
                   "d_model": cfg.d_model, "heads": cfg.num_heads,
                   "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
                   "d_ff": cfg.d_ff, "vocab": cfg.vocab_size},
        "parameters": n_params, "batch": b, "seq": s,
        "optimizer": TRAIN_OPT, "precision": precision, "init_s": init_s,
        "run_a": [{"loss": l, "grad_norm": g} for l, g in run_a],
        "step_ms": step_ms, "step_ms_what": "CUDA events around "
        "step_fn, steps 1-3 of run A (step 0 warms); loss and grad norm "
        "read after each",
        "bound_ms": bound["ms"], "bound_by": bound["by"],
        "bound_operations": bound["operations"],
        "bound_bytes": bound["bytes"], "profile": profile,
        "profile_what": "torch.profiler over one more step: device ms, "
        "kernels, idle share of the mean step ms, top kernels",
        "max_memory_allocated": {"steps": peak_steps,
                                 "save": resume.pop("peak_save"),
                                 "restore": resume.pop("peak_restore")},
        "memorize": {"losses": memo, "ratio": memo[-1] / memo[0]},
        "resume": {"run_b": run_b, "run_a_step3": run_a[3][0],
                   "rel": resume_rel, "tol": TRAIN_RESUME_TOL, **resume},
        "card_vs_cpu_smoke": card_vs_cpu,
        "seconds": time.perf_counter() - t_phase}


# -- 15. families: the MoE, MLA, hybrid, RWKV and encoder-decoder families -
# (arch, layers kept (None: all), batch, prompt tokens, generated tokens).
# rwkv6-3b's prompt is cut to 512: its prefill is two launches a step of
# the wkv loop, and the profiler's pass over a 2048-token prefill (138194
# kernels) took 172 s of its run on the H100 (``families_probe.py
# rwkv6-3b:2048``)
FAMILIES = (("deepseek-v3-671b", 4, 2, 4096, 32),
            ("llama4-scout-17b-a16e", 4, 8, 4096, 32),
            ("hymba-15b", None, 8, 2048, 32),
            ("rwkv6-3b", None, 8, 512, 32),
            ("whisper-tiny", None, 32, 64, 32))


def family_config(arch: str, layers):
    """``arch`` at full width, its depth cut to ``layers`` (None: whole)."""
    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    return cfg if layers is None else cfg.replace(num_layers=layers)


def full_width(arch: str, cfg) -> None:
    """Fail unless ``cfg`` is ``arch`` at its full width (its depth may be
    cut)."""
    from repro_torch.configs import get_arch

    full = get_arch(arch)
    for key in ("d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
                "vocab_size", "moe_num_experts", "moe_top_k", "moe_d_ff",
                "mla_kv_lora_rank", "ssm_state", "window", "rwkv_head_size",
                "encoder_seq"):
        check(getattr(cfg, key) == getattr(full, key),
              f"{arch}: {key} {getattr(cfg, key)} is not the full width's "
              f"{getattr(full, key)}")


def forward_ops(model, b: int, tokens: int, keys: int, q: int):
    """``(dense, slots, routed, attn, expert_bytes)`` of one forward pass
    of every layer of ``model`` over ``tokens`` tokens, ``q`` queries a
    row against ``keys`` keys (``family_bounds``' and ``train_bound``'s
    count): the dense matmuls at every token (whisper's encoder and cross
    k/v projections at its b x F frames, when ``q > 1``), a MoE layer's
    experts at its ``E * C`` slots as computed and the routed ``T * k``
    pairs beside them, the attention's score and value products over the
    rectangle computed (MLA: qk ``nope + rope``, v ``v_dim``, or its
    absorbed decode over the latent when ``q == 1``; whisper's cross
    rectangle over the frames and, when ``q > 1``, its encoder's F x F),
    and the bytes of the expert stacks."""
    from repro_torch.models import transformer as tfm

    cfg = model.cfg
    h = cfg.num_heads
    audio = cfg.family == "audio"
    frames = cfg.encoder_seq if audio else 0
    enc_layers = cfg.encoder_layers if audio else 0
    dense = slots = routed = expert_bytes = 0
    for stack, _, layer in model.layers():
        for name, p in layer.named_parameters():
            if p.dim() < 2 or name.endswith(("conv_w", "A_log", "tm.u")):
                continue
            if layer.kind == "moe" and name in ("ffn.wi", "ffn.wg",
                                                "ffn.wo"):
                per = p[0].numel()
                slots += 2.0 * cfg.moe_num_experts * tfm.moe_capacity(
                    cfg, tokens) * per
                routed += 2.0 * tokens * cfg.moe_top_k * per
                expert_bytes += p.numel() * p.element_size()
            elif stack == "encoder" or name in ("cross.wk", "cross.wv"):
                dense += 2.0 * b * frames * p.numel() * (q > 1)
            else:
                dense += 2.0 * tokens * p.numel()
    if cfg.family == "ssm":
        return dense, slots, routed, 0.0, expert_bytes
    if cfg.mla:
        nope, rpe = cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim
        per = (2.0 * (nope + rpe + cfg.mla_v_dim) if q > 1 else
               2.0 * (2 * cfg.mla_kv_lora_rank + rpe))
    else:
        per = 4.0 * cfg.head_dim
    attn = cfg.num_layers * b * h * q * (keys + frames) * per
    if q > 1:  # the encoder's bidirectional F x F
        attn += enc_layers * b * h * frames * frames * per
    return dense, slots, routed, attn, expert_bytes


def family_bounds(model, b: int, s: int, t: int, hit=None) -> dict:
    """The card's least time for a prefill of ``s`` tokens and one decode
    step over ``t`` positions, the larger of two times: every weight
    matrix's product with the tokens it meets at the bf16 peak (a MoE
    layer's experts at its ``E * C`` slots, as computed, the routed ``T *
    k`` pairs beside them; whisper's encoder and cross k/v projections at
    its frames), the attention's score and value products over the
    rectangle computed (MLA: qk ``nope + rope``, v ``v_dim``; its absorbed
    decode over the latent; the hybrid's ring over its slots; whisper's
    bidirectional F x F encoder and its S x F cross rectangle), RWKV's wkv
    recurrence at the fp32 peak (``5 hd^2 + 4 hd`` a head and token), the
    last token's unembedding; against the bytes read once at 3.35 TB/s
    (the weights but the embedding and the position tables, the frames,
    the cache written or read, the SSM or RWKV state, the logits).  The
    attention counts the whole S x S score rectangle, as the reference
    computes it (a causal kernel could skip half).  ``hit``: experts a
    decode step routes to, for its bound on what the data needs (None:
    every expert)."""
    from repro_torch.models import ssm as ssm_mod

    cfg = model.cfg
    tables = ("embed", "pos_embed", "enc_pos_embed")
    table_bytes = sum(model[k].numel() * model[k].element_size()
                      for k in tables if k in model)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    ring = min(t, cfg.window) if cfg.family == "hybrid" else t
    frames = cfg.encoder_seq if cfg.family == "audio" else 0

    unembed = 2.0 * b * cfg.d_model * cfg.vocab_size
    if cfg.mla:
        per_token = 2 * (cfg.mla_kv_lora_rank + cfg.mla_qk_rope_dim)
    elif cfg.family == "ssm":
        per_token = 0
    else:
        per_token = 2 * 2 * cfg.num_kv_heads * cfg.head_dim
    cache_token = cfg.num_layers * b * per_token  # bytes a position
    cross = cache_token * frames  # whisper's ck/cv, written once, read
    state = 0
    if cfg.hybrid_parallel:
        d_in, _, n, k = ssm_mod._dims(cfg)
        state = cfg.num_layers * b * (4 * d_in * n + 2 * (k - 1) * d_in)
    if cfg.family == "ssm":
        hd = cfg.rwkv_head_size
        heads = cfg.d_model // hd
        state = cfg.num_layers * b * (4 * heads * hd * hd + 2 * 2
                                      * cfg.d_model)

    def recurrence(tokens):  # the hybrid's scan is not counted here
        return recurrence_ops(cfg, tokens) if cfg.family == "ssm" else 0.0

    def bound(nbytes, ops, fp32_ops):
        tb = nbytes / PEAK_BYTES_PER_S * 1e3
        to = (ops / PEAK_BF16_PER_S + fp32_ops / PEAK_FP32_PER_S) * 1e3
        return {"ms": max(tb, to), "by": "bytes" if tb >= to else
                "operations", "bytes": nbytes, "operations": ops,
                "fp32_operations": fp32_ops}

    # prefill: every query over the keys the mask keeps in the rectangle
    # computed (the whole S x S; the ring's window still computes S x S)
    dense, slots, routed, attn, expert_bytes = forward_ops(
        model, b, b * s, s, s)
    pre_bytes = (weight_bytes - table_bytes + 8 * b * s
                 + 2 * b * frames * cfg.d_model + cross
                 + cache_token * min(s, ring) + state
                 + 2 * b * cfg.vocab_size)
    prefill = bound(pre_bytes, dense + slots + attn + unembed,
                    recurrence(b * s))
    prefill["routed_operations"] = dense + routed + attn + unembed
    prefill["moe_slot_operations"] = slots
    prefill["moe_routed_operations"] = routed
    dense, slots, routed, attn, _ = forward_ops(model, b, b, ring, 1)
    dec_bytes = (weight_bytes - table_bytes + cache_token * (ring + 1)
                 + cross + 2 * state + 2 * b * cfg.vocab_size)
    decode = bound(dec_bytes, dense + slots + attn + unembed, recurrence(b))
    decode["weights_only_ms"] = ((weight_bytes - table_bytes)
                                 / PEAK_BYTES_PER_S * 1e3)
    decode["state_bytes"] = state
    decode["cross_cache_bytes"] = cross
    if hit is not None and expert_bytes:
        need = dec_bytes - expert_bytes + expert_bytes * hit / (
            cfg.moe_num_experts * sum(lay.kind == "moe"
                                      for _, _, lay in model.layers()))
        decode["experts_hit"] = hit
        decode["bytes_experts_hit"] = need
        decode["ms_experts_hit"] = max(need / PEAK_BYTES_PER_S * 1e3,
                                       decode["operations"]
                                       / PEAK_BF16_PER_S * 1e3)
    return {"prefill": prefill, "decode_step": decode,
            "weight_bytes": weight_bytes, "expert_bytes": expert_bytes}


def moe_drops(model) -> dict:
    """Each MoE layer's last call's dropped pairs and experts hit (0-d
    tensors on the card)."""
    return {f"{g}.{li}": dict(layer.moe_stats)
            for g, li, layer in model.layers() if layer.kind == "moe"}


def _ints(drops: dict) -> dict:
    return {k: {s: int(v) for s, v in d.items()} for k, d in drops.items()}


def family_kv(arch: str, cfg, cache, s: int, first, decode_fn, clone,
              device: str) -> dict:
    """The model's own prefilled cache through ``serve_lm.compress_cache``
    (phases 13 and 15; see the module docstring): every block's K5 and K3
    launch held to its plain version, what it must leave raw untouched,
    the logits' drift after it.  RWKV's cache is its state, with no
    token-axis block: nothing is compressed."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve_lm import (
        cache_blocks,
        compress_cache,
        compressible,
    )
    from repro_torch.models.api import CROSS_KEYS, STATE_KEYS
    from repro_torch.serving import KVCacheCodec

    cache_bytes = sum(t.numel() * t.element_size() for _, t in _flat(cache))
    blocks = list(cache_blocks(cache, s))
    n_blocks = len(blocks)
    want = 0 if cfg.family == "ssm" else 2 * cfg.num_layers * (
        2 if cfg.cross_attention else 1)
    check(n_blocks == want, f"{arch}: {n_blocks} cache blocks, {want} "
          f"expected of {cfg.num_layers} layers")
    if not blocks:
        return {"blocks": 0, "cache_bytes": cache_bytes, "launches": {},
                "what": "no token-axis block: the cache is the model's "
                "state, kept raw"}
    n = KVCacheCodec(device=device).config.n

    def raw_part(key, t):  # what compress_cache must leave as it was
        if key in STATE_KEYS:
            return t
        if key in CROSS_KEYS:
            return t[:, :, t.shape[2] - t.shape[2] % n:]
        return t[:, :, s:]

    with torch.inference_mode():
        ref, _ = decode_fn(clone(cache), first, s)
        restored = clone(cache)
        ops.reset_launches()
        with kv_kernels_held() as held:
            t0 = time.perf_counter()
            raw, comp = compress_cache(KVCacheCodec(device=device), restored,
                                       s)
            torch.cuda.synchronize()
            sweep_s = time.perf_counter() - t0
        kv_launches = dict(ops.LAUNCHES)
        check(kv_launches == {k: n_blocks * (k in ("dct_quant",
                                                   "idct_dequant"))
                              for k in kv_launches},
              f"{arch}: KV cache launch counts {kv_launches}, {n_blocks} "
              f"blocks")
        check(held["dct_quant"]["calls"] == n_blocks
              and held["dct_quant"]["flips"] == 0,
              f"{arch}: K5 on the model's cache against its plain "
              f"version: {held['dct_quant']}")
        check(held["idct_dequant"]["calls"] == n_blocks
              and held["idct_dequant"]["rel_err"] <= REL_TOL,
              f"{arch}: K3 on the model's cache against its plain "
              f"version: {held['idct_dequant']}")
        kept = dict(blocks)
        block_err = max(rel_l2(blk, kept[name])
                        for name, blk in cache_blocks(restored, s))
        untouched = all(
            torch.equal(raw_part(key.split(".")[-1], got),
                        raw_part(key.split(".")[-1], t))
            for (key, t), (_, got) in zip(_flat(cache), _flat(restored)))
        check(untouched, f"{arch}: compress_cache touched a state, the "
              f"slots past S or a cross block's raw tail")
        got, _ = decode_fn(restored, first, s)
        drift = rel_l2(got, ref)
        check(drift < LM_DRIFT_TOL, f"{arch}: decode on the restored "
              f"cache: logit drift {drift} >= {LM_DRIFT_TOL}")
        del restored, got
        # one table per (group, key) calibrated on layer 0 and shared by
        # every layer (the reference example's flow): reported, not held
        shared, codec = clone(cache), KVCacheCodec(device=device)
        for name, blk in cache_blocks(shared, s):
            blk, table = compressible(name, blk, n), name[:-1]
            if name[-1] == 0:
                codec.calibrate(blk, layer=table)
            blk.copy_(codec.decompress(codec.compress(blk, layer=table),
                                       layer=table))
        got, _ = decode_fn(shared, first, s)
        shared_drift = rel_l2(got, ref)
        del shared, got, ref
        # the codec's ms on one block: the first key's last layer
        key = blocks[0][0][:-1]
        one = [blk for name, blk in blocks if name[:-1] == key][-1]
        codec = KVCacheCodec(device=device)
        codec.calibrate(one, layer="one")
        ckv = codec.compress(one, layer="one")
        kv_ms = {"compress": cuda_ms(lambda: codec.compress(
                     one, layer="one")),
                 "decompress": cuda_ms(lambda: codec.decompress(
                     ckv, layer="one"))}
        kv_bound = bound_ms(3 * one.numel(),
                            2.0 * one.numel() * codec.config.e)[0]
    return {"blocks": n_blocks, "cache_bytes": cache_bytes,
            "prefilled_bytes": raw, "compressed_bytes": comp,
            "ratio": comp / raw,
            "tables": "one per block (group, key, layer), each calibrated "
            "on its own block; a cross block's whole windows, its tail raw",
            "sweep_s": sweep_s,
            "sweep_what": "calibrate, compress, decompress and both plain "
            "checks of every block",
            "launches": kv_launches, "k5_vs_plain": held["dct_quant"],
            "k3_vs_plain": held["idct_dequant"],
            "max_block_rel_l2": block_err, "drift_rel_l2": drift,
            "drift_tol": LM_DRIFT_TOL,
            "layer0_tables_drift_rel_l2": shared_drift,
            "ms_per_block": kv_ms, "bound_ms_per_block": kv_bound}


def family_run(arch: str, cfg, b: int, s: int, gen: int, seed: int,
               device: str = "cuda") -> dict:
    """One model served on the card: granite-8b in phase 13, each family
    in phase 15 (see the module docstring).  Frees the model before it
    returns."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.distributed.train import make_serve_fns
    from repro_torch.models import build_model

    t_run = time.perf_counter()
    full_width(arch, cfg)
    max_len = s + gen
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    parts, mark = {}, [time.perf_counter()]  # the run's seconds by part

    def lap(name: str) -> None:
        now = time.perf_counter()
        parts[name], mark[0] = now - mark[0], now
    n_params = sum(p.numel() for p in model.parameters())
    for _, _, layer in model.layers():
        if layer.kind == "moe":
            layer.moe_stats = {}  # each call's drops, on the card
    prefill_fn, decode_fn = make_serve_fns(model)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    batch = {"tokens": tokens}
    if cfg.family == "audio":  # whisper's frames, N(0, 1) from the seed
        batch["frames"] = torch.randn(
            (b, cfg.encoder_seq, cfg.d_model), device=device,
            generator=torch.Generator(device=device).manual_seed(seed)
        ).to(torch.bfloat16)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    prefill_fn(batch, max_len)  # warm
    torch.cuda.synchronize()
    start.record()
    logits, cache = prefill_fn(batch, max_len)
    stop.record()
    stop.synchronize()
    prefill_ms = start.elapsed_time(stop)
    drops = {"prefill": _ints(moe_drops(model))}
    check(tuple(logits.shape) == (b, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{arch}: prefill logits {tuple(logits.shape)}, finite "
          f"{bool(torch.isfinite(logits).all())}")
    first = logits.argmax(-1, keepdim=True)

    def clone(c):  # a decode step writes the cache and the SSM state
        return _tree_map(lambda t: t.clone(), c)

    prefilled = clone(cache)  # for the consistency and the KV checks
    decode_fn(clone(cache), first, s)  # warm
    torch.cuda.synchronize()
    outs, tok, step_drops = [first], first, []
    start.record()
    for i in range(gen - 1):
        step_logits, cache = decode_fn(cache, tok, s + i)
        tok = step_logits.argmax(-1, keepdim=True)
        outs.append(tok)
        step_drops.append(moe_drops(model))
    stop.record()
    stop.synchronize()
    decode_ms = start.elapsed_time(stop) / (gen - 1)
    drops["decode"] = [_ints(d) for d in step_drops]
    generated = torch.cat(outs, dim=1).cpu()
    check(bool(torch.isfinite(step_logits).all()),
          f"{arch}: decode logits are not finite")
    hit = None
    if drops["decode"] and drops["decode"][-1]:
        hit = sum(d["experts_hit"] for d in drops["decode"][-1].values())
    bounds = family_bounds(model, b, s, s + gen // 2, hit)
    lap("serve")
    profiles = {"decode_step": device_profile(
        lambda: decode_fn(cache, tok, max_len - 1), decode_ms)}
    lap("profile_decode_step")
    profiles["prefill"] = device_profile(lambda: prefill_fn(batch, max_len),
                                         prefill_ms)
    lap("profile_prefill")

    # -- prefill(S) against prefill(S - 1) + one decode step ---------------
    del cache
    _, part = prefill_fn({**batch, "tokens": tokens[:, :s - 1]}, max_len)
    step, part = decode_fn(part, tokens[:, s - 1:], s - 1)
    consistency = rel_l2(step, logits)
    tol = HYBRID_CONSISTENCY_TOL if cfg.hybrid_parallel else \
        LM_CONSISTENCY_TOL
    check(consistency < tol, f"{arch}: prefill vs prefill + decode_step: "
          f"relative L2 {consistency} >= {tol}")
    del part, step
    torch.cuda.empty_cache()
    lap("consistency")

    # -- the model's own cache through K5 / K3 -----------------------------
    cache = prefilled
    kv = family_kv(arch, cfg, cache, s, first, decode_fn, clone, device)
    lap("kv")
    peak = torch.cuda.max_memory_allocated()
    layers = [layer.kind for _, _, layer in model.layers()]
    del cache, logits, model, prefill_fn, decode_fn, first, tok, outs
    del step_logits, step_drops
    gc.collect()
    torch.cuda.empty_cache()

    # -- the smoke model on the CPU against the card -----------------------
    smoke = get_smoke(arch)
    small = build_model(smoke, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    sb, ss = 2, 32
    sbatch = {"tokens": torch.from_numpy(rng.integers(0, smoke.vocab_size,
                                                      (sb, ss)))}
    if smoke.family == "audio":
        sbatch["frames"] = torch.from_numpy(rng.standard_normal(
            (sb, smoke.encoder_seq, smoke.d_model))).to(torch.bfloat16)
    arms = {}
    for dev in ("cpu", device):
        p_fn, d_fn = make_serve_fns(small, dev)
        lg, c = p_fn(sbatch, ss + LM_SMOKE_STEPS)
        arm = [lg.float().cpu()]
        for i in range(LM_SMOKE_STEPS):
            want = (arms["cpu"] if arms else arm)[i].argmax(-1, keepdim=True)
            lg, c = d_fn(c, want, ss + i)
            arm.append(lg.float().cpu())
        arms["card" if arms else "cpu"] = arm
    card_cpu = [rel_l2(g, w) for g, w in zip(arms["card"], arms["cpu"])]
    check(max(card_cpu) <= LM_CARD_CPU_TOL,
          f"{arch}: smoke model on the card against the CPU: {card_cpu}")
    del small
    gc.collect()
    lap("card_vs_cpu_smoke")
    return {
        "arch": arch, "layers": layers,
        "config": {"layers": cfg.num_layers, "d_model": cfg.d_model,
                   "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
                   "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
                   "vocab": cfg.vocab_size, "experts": cfg.moe_num_experts,
                   "top_k": cfg.moe_top_k, "expert_d_ff": cfg.moe_d_ff,
                   "mla": cfg.mla, "window": cfg.window,
                   "ssm_state": cfg.ssm_state,
                   "rwkv_head_size": (cfg.rwkv_head_size
                                      if cfg.family == "ssm" else None),
                   "encoder_layers": cfg.encoder_layers,
                   "encoder_seq": (cfg.encoder_seq if cfg.cross_attention
                                   else None)},
        "parameters": n_params, "weight_bytes": bounds["weight_bytes"],
        "expert_bytes": bounds["expert_bytes"],
        "batch": b, "prompt": s, "generated": gen, "max_len": max_len,
        "init_s": init_s,
        "prefill_ms": prefill_ms, "prefill_tok_s": b * s / (prefill_ms / 1e3),
        "prefill_bound": bounds["prefill"],
        "decode_ms_per_token": decode_ms,
        "decode_tok_s": b / (decode_ms / 1e3),
        "decode_bound": bounds["decode_step"],
        "profile": profiles, "max_memory_allocated": peak,
        "moe_dropped": drops,
        "generated_ids": generated[:4, :12].tolist(),
        "consistency_rel_l2": consistency, "consistency_tol": tol,
        "kv": kv,
        "card_vs_cpu_smoke": {"arch": smoke.name, "batch": sb, "prompt": ss,
                              "decode_steps": LM_SMOKE_STEPS,
                              "rel_l2": card_cpu, "tol": LM_CARD_CPU_TOL},
        "seconds": time.perf_counter() - t_run, "seconds_by_part": parts}


def families_phase(smi: str, seed: int, device: str = "cuda") -> dict:
    """Phase 15: the MoE, MLA, hybrid, RWKV and encoder-decoder families
    (M10c) on the card, one model at a time (see the module docstring).
    Returns its JSON line."""
    t_phase = time.perf_counter()
    with exact_bf16_sums() as precision:
        runs = [family_run(arch, family_config(arch, layers), b, s, gen,
                           seed, device)
                for arch, layers, b, s, gen in FAMILIES]
    launches = {k: sum(r["kv"]["launches"].get(k, 0) for r in runs)
                for k in ("dct_quant", "idct_dequant")}
    held = [r["kv"] for r in runs if r["kv"]["blocks"]]
    max_abs = {"dct_quant": max(kv["k5_vs_plain"]["max_abs_err"]
                                for kv in held),
               "idct_dequant": max(kv["k3_vs_plain"]["max_abs_err"]
                                   for kv in held)}
    return {"phase": "families", "nvidia_smi": smi, "precision": precision,
            **RUN_WHAT, "runs": runs, "launches": launches, "max_abs_err": max_abs,
            "seconds": time.perf_counter() - t_phase}


# -- 16. families_train: the MoE, MLA and encoder-decoder families trained --
# (arch, layers kept (None: all), batch, sequence).  whisper-tiny whole at
# Whisper's decoder length over its 1500 frames; deepseek-v3's first two
# layers (both dense MLA layers: moe_first_dense is 3) at 2 x 2048, half
# phase 14's batch, as 128 heads' fp32 scores are 4x granite's 32; one
# MoE layer of llama4-scout (16 experts, top 1, the shared expert)
FT_RUNS = (("whisper-tiny", None, 16, 448),
           ("deepseek-v3-671b", 2, 2, 2048),
           ("llama4-scout-17b-a16e", 1, 2, 2048))
FT_RESUME = "whisper-tiny"  # trained through a compressed resume (run B)
FT_REMAT = "llama4-scout-17b-a16e"  # remat on/off and a repeated backward
FT_SMOKE = ("deepseek_v3_671b", "whisper_tiny")  # card against the CPU
FT_SMOKE_RESUME = "deepseek_v3_671b"  # a compressed resume of its experts
# one batch's gradients on the card taken twice on the same weights, and
# with remat on against off: each leaf's relative L2 (0: bit for bit)
FT_REPEAT_TOL = 0.0


class MoeStatsLog(dict):
    """A MoE layer's ``moe_stats`` that also logs every write: under remat
    a training step writes each key twice, in the forward and in the
    backward's recomputed forward."""

    def __init__(self):
        super().__init__()
        self.log = []

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.log.append((key, value))


@contextlib.contextmanager
def chunk_remat_off():
    """The scans' per-chunk checkpointing (``ssm.chunk_remat``) off while
    the block runs (a port without it has none to turn off)."""
    from repro_torch.models import ssm as ssm_mod

    if not hasattr(ssm_mod, "chunk_remat"):
        yield
        return
    saved = ssm_mod.chunk_remat
    ssm_mod.chunk_remat = lambda s: False
    try:
        yield
    finally:
        ssm_mod.chunk_remat = saved


@contextlib.contextmanager
def gc_cost():
    """What Python's cyclic collector takes while the block runs: its
    seconds (``s``) and collections by generation, and the objects it
    tracked at the start (``objects``: a full collection walks them all,
    so a heap that earlier phases left behind makes each one longer)."""
    rec = {"s": 0.0, "collections": [0, 0, 0],
           "objects": len(gc.get_objects())}
    began = [0.0]

    def watch(phase, info):
        if phase == "start":
            began[0] = time.perf_counter()
        else:
            rec["s"] += time.perf_counter() - began[0]
            rec["collections"][info["generation"]] += 1

    gc.callbacks.append(watch)
    try:
        yield rec
    finally:
        gc.callbacks.remove(watch)


def grads_twice(model, batch, moe_layers) -> dict:
    """One batch's loss and gradients on the seed's weights, three times:
    remat on, remat on again, remat off (the layers' and the scans'
    per-chunk remat: ``chunk_remat_off``), each pass's peak memory above
    what it started with (``peak_added``, so the first pass's gradients,
    held to compare, count in none).  Held: the losses bit for bit, each
    gradient leaf within ``FT_REPEAT_TOL`` of the first (relative L2; 0:
    bit for bit), and each MoE layer's routing (``dropped``,
    ``experts_hit``) the same in every forward, the backward's recomputed
    forward included."""
    import torch

    params = [p for _, p in model.named_parameters()]
    names = [n for n, _ in model.named_parameters()]
    first = None
    out = {}
    for arm, remat in (("remat", True), ("again", True), ("no_remat", False)):
        for layer in moe_layers:
            layer.moe_stats.log.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with contextlib.nullcontext() if remat else chunk_remat_off():
            loss = model.loss(batch, remat=remat)
            grads = torch.autograd.grad(loss, params)
        loss = loss.detach()
        peak = torch.cuda.max_memory_allocated() - held
        routing = []  # each layer's writes of each key, in order
        for layer in moe_layers:
            writes = {}
            for k, v in layer.moe_stats.log:
                writes.setdefault(k, []).append(int(v))
            routing.append(writes)
        if first is None:
            first = (loss, grads)
            out[arm] = {"loss": float(loss), "routing": routing,
                        "peak_added": peak}
            continue
        rels = [0.0 if torch.equal(g, f) else rel_l2(g, f)
                for g, f in zip(grads, first[1])]
        worst = max(range(len(rels)), key=rels.__getitem__)
        out[arm] = {"loss": float(loss),
                    "loss_equal": bool(torch.equal(loss, first[0])),
                    "leaves_equal": sum(r == 0.0 for r in rels),
                    "leaves": len(rels), "max_rel_l2": rels[worst],
                    "worst_leaf": names[worst], "routing": routing,
                    "peak_added": peak}
        del grads
    seen = [{k: {v for arm in out.values() for v in arm["routing"][li]
                 .get(k, [])} for k in ("dropped", "experts_hit")}
            for li in range(len(moe_layers))]
    out["routing_same"] = all(len(vals) == 1 for layer in seen
                              for vals in layer.values())
    # each key written in the forward and again in the recomputed forward
    out["recomputed_routing_seen"] = all(
        len(writes) == 2 for arm in ("remat", "again")
        for layer in out[arm]["routing"] for writes in layer.values())
    for arm in ("again", "no_remat"):
        a = out[arm]
        check(a["loss_equal"] and a["max_rel_l2"] <= FT_REPEAT_TOL,
              f"gradients {arm} against the first remat pass: {a}")
    check(out["routing_same"] and out["recomputed_routing_seen"],
          f"MoE routing differs between passes, or a recomputed forward "
          f"wrote none: {out}")
    del first
    return out


def family_train_run(arch: str, layers, b: int, s: int, seed: int,
                     tmp: str, *, resume: bool = False, twice: bool = False,
                     profile_seq=None,
                     memo_steps: int = TRAIN_MEMO_STEPS) -> dict:
    """One family trained at full width on the card (phases 16 and 17; see
    the module docstring): with ``resume`` run B through a compressed
    checkpoint, with ``twice`` ``grads_twice``, with ``profile_seq`` the
    profiled step over ``b x profile_seq`` tokens of the same weights
    (timed by CUDA events on its own for the idle share), ``memo_steps``
    steps on one repeated batch.  Frees the model before it returns."""
    import numpy as np
    import torch

    from repro_torch.distributed.optimizer import AdamW, AdamWConfig
    from repro_torch.distributed.train import make_train_step
    from repro_torch.models import build_model

    t_run = time.perf_counter()
    cfg = family_config(arch, layers)
    full_width(arch, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", generator=gen.manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    moe_layers = [layer for _, _, layer in model.layers()
                  if layer.kind == "moe"]
    for layer in moe_layers:
        layer.moe_stats = MoeStatsLog()
    opt = AdamW(AdamWConfig(**TRAIN_OPT))
    ts = make_train_step(model, opt)
    batches = train_batches(cfg, b, s, seed, TRAIN_STEPS + 1, "cuda")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    out = {"arch": arch, "layers": [lay.kind for _, _, lay in
                                    model.layers()],
           "config": {"layers": cfg.num_layers, "d_model": cfg.d_model,
                      "heads": cfg.num_heads, "head_dim": cfg.head_dim,
                      "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
                      "experts": cfg.moe_num_experts, "top_k": cfg.moe_top_k,
                      "mla": cfg.mla, "encoder_layers": cfg.encoder_layers},
           "parameters": n_params, "batch": b, "seq": s, "init_s": init_s}

    def dropped():
        return {f"{g}.{li}": {k: int(v) for k, v in layer.moe_stats.items()}
                for g, li, layer in model.layers() if layer.kind == "moe"}

    if twice:  # before m and v exist: two gradient sets fit
        out["grads_twice"] = grads_twice(model, batches[0], moe_layers)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # -- run A: four steps from the seed's weights, timed ------------------
    st, run_a, step_ms, drops = ts.init(), [], [], []
    host = {"gc_ms": [], "gc_full": [], "cuda_mallocs": []}
    with gc_cost() as gcs:
        for i in range(TRAIN_STEPS):
            gc_s, full = gcs["s"], gcs["collections"][2]
            mallocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
            torch.cuda.synchronize()
            start.record()
            st, met = ts.step_fn(st, batches[i])
            stop.record()
            stop.synchronize()
            if i:  # step 0 warms
                step_ms.append(start.elapsed_time(stop))
                host["gc_ms"].append((gcs["s"] - gc_s) * 1e3)
                host["gc_full"].append(gcs["collections"][2] - full)
                host["cuda_mallocs"].append(torch.cuda.memory_stats().get(
                    "num_device_alloc", 0) - mallocs)
            run_a.append((float(met["loss"]), float(met["grad_norm"])))
            drops.append(dropped())
    host["gc_objects"] = gcs["objects"]
    check(all(np.isfinite(x) for r in run_a for x in r),
          f"{arch} run A: a loss or grad norm is not finite: {run_a}")
    profiled, profile_ms = batches[TRAIN_STEPS], sum(step_ms) / len(step_ms)
    if profile_seq is not None:
        profiled = train_batches(cfg, b, profile_seq, seed, 1, "cuda")[0]
        for _ in range(2):  # the first warms the new shape
            torch.cuda.synchronize()
            start.record()
            ts.step_fn(st, profiled)
            stop.record()
            stop.synchronize()
        profile_ms = start.elapsed_time(stop)
        out["profile_seq"] = profile_seq
        out["profile_step_ms"] = profile_ms
        out["profile_bound_ms"] = train_bound(model, b * profile_seq, b,
                                              profile_seq)["ms"]
    profile = device_profile(lambda: ts.step_fn(st, profiled), profile_ms,
                             top=16)
    bound = train_bound(model, b * s, b, s)
    out.update(run_a=[{"loss": l, "grad_norm": g} for l, g in run_a],
               moe_dropped=drops, step_ms=step_ms, step_host=host,
               bound_ms=bound["ms"],
               bound_by=bound["by"], bound=bound, profile=profile,
               peak_steps=torch.cuda.max_memory_allocated())

    def restart():
        nonlocal st
        st = None  # the old m and v go first: two of scout's do not fit
        gc.collect()
        with torch.no_grad():
            model.init_weights(gen.manual_seed(seed))
        return ts.init()

    # -- run B: steps 0-1, the compressed checkpoint, steps 2-3 ------------
    if resume:
        st = restart()
        run_b = []
        for i in range(2):
            st, met = ts.step_fn(st, batches[i])
            run_b.append(float(met["loss"]))
        st, resume = compressed_resume(model, st, opt, tmp, 2)
        for i in range(2, TRAIN_STEPS):
            st, met = ts.step_fn(st, batches[i])
            run_b.append(float(met["loss"]))
        a3, a2 = run_a[3][0], run_a[2][0]
        resume_rel = abs(run_b[3] - a3) / abs(a3)
        check(all(np.isfinite(run_b)) and resume_rel <= TRAIN_RESUME_TOL,
              f"{arch}: resumed run B's step-3 loss {run_b} against run "
              f"A's {[r[0] for r in run_a]}: relative {resume_rel} > "
              f"{TRAIN_RESUME_TOL}")
        out["resume"] = {"run_b": run_b, "run_a_step3": a3,
                         "rel": resume_rel, "tol": TRAIN_RESUME_TOL,
                         "step3_change_rel": abs(a3 - a2) / abs(a2),
                         **resume}

    # -- one repeated batch, 8 steps: the loss falls ------------------------
    st = restart()
    memo = []
    for _ in range(memo_steps):
        st, met = ts.step_fn(st, batches[0])
        memo.append(float(met["loss"]))
    check(np.isfinite(memo).all() and memo[-1] < memo[0],
          f"{arch}: one repeated batch: the loss did not fall: {memo}")
    out["memorize"] = {"losses": memo, "ratio": memo[-1] / memo[0]}
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del st, met, model, ts, batches, moe_layers
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_run
    return out


def smoke_resume(arch: str, seed: int, tmp: str) -> dict:
    """The smoke ``arch`` on the card: 2 train steps, ``compressed_resume``
    (a MoE model's expert stacks ``[L, E, d, f]`` and their m and v
    through K4 and K1 / ``lut_idct``), 2 more steps: finite."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.distributed.optimizer import AdamW, AdamWConfig
    from repro_torch.distributed.train import make_train_step
    from repro_torch.models import build_model

    cfg = get_smoke(arch)
    model = build_model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed))
    opt = AdamW(AdamWConfig(**TRAIN_OPT))
    ts = make_train_step(model, opt)
    batches = train_batches(cfg, 2, 64, seed, 4, "cuda")
    st, losses = ts.init(), []
    for batch in batches[:2]:
        st, met = ts.step_fn(st, batch)
        losses.append(float(met["loss"]))
    st, report = compressed_resume(model, st, opt, tmp, 2)
    groups = sorted({g for g, _, layer in model.layers()
                     if layer.kind == "moe"})
    experts = [f"{part}.{g}.ffn.{w}" for part in ("m", "v") for g in groups
               for w in ("wi", "wg", "wo")]
    check(all(k in report["rel_rms_err"] for k in experts),
          f"{arch}: the expert stacks' m and v were not all compressed: "
          f"{experts} of {sorted(report['rel_rms_err'])}")
    for batch in batches[2:]:
        st, met = ts.step_fn(st, batch)
        losses.append(float(met["loss"]))
    check(np.isfinite(losses).all(), f"{arch} resumed: {losses}")
    del model, ts, st
    return {"arch": cfg.name, "losses": losses, "expert_leaves": experts,
            **report}


def port_trains(arch: str) -> bool:
    """Whether the driven port's ``launch.train`` trains ``arch``: it
    imports, and it has no ``untrained`` (every family trains) or
    ``untrained(get_arch(arch))`` is empty."""
    try:
        from repro_torch.configs import get_arch
        from repro_torch.launch import train
    except ImportError:
        return False
    untrained = getattr(train, "untrained", None)
    return untrained is None or not untrained(get_arch(arch))


def families_train_phase(smi: str, seed: int) -> dict:
    """Phase 16: the MoE, MLA and encoder-decoder families trained on the
    card (see the module docstring).  Returns its JSON line."""
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="fptc_ftrain_")
    try:
        with exact_bf16_sums() as precision:
            runs = [family_train_run(arch, layers, b, s, seed,
                                     os.path.join(tmp, arch),
                                     resume=arch == FT_RESUME,
                                     twice=arch == FT_REMAT)
                    for arch, layers, b, s in FT_RUNS]
            smoke = {arch: smoke_card_vs_cpu(arch, seed) for arch in FT_SMOKE}
            resume = smoke_resume(FT_SMOKE_RESUME, seed,
                                  os.path.join(tmp, "smoke"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    held = [r["resume"]["kernels"] for r in runs if "resume" in r]
    held.append(resume["kernels"])
    launches = {k: sum(h[k]["launches"] for h in held) for k in CKPT_KERNELS}
    max_abs = {k: max(h[k]["max_abs_err"] for h in held)
               for k in CKPT_KERNELS}
    return {"phase": "families_train", "nvidia_smi": smi,
            "precision": precision, "optimizer": TRAIN_OPT, "runs": runs,
            "step_ms_what": "CUDA events around step_fn, steps 1-3 of run "
            "A (step 0 warms); profile: one more step under torch.profiler",
            "card_vs_cpu_smoke": smoke, "smoke_resume": resume,
            "launches": launches, "max_abs_err": max_abs,
            "seconds": time.perf_counter() - t_phase}


# -- 17. scan_train: the hybrid SSM and RWKV families trained -----------------
# (arch, layers kept, batch, sequence): both at full width cut to 4 of
# their 32 layers, 2 x 2048 tokens: hymba's window twice over, 16 chunks of
# each scan, so that the chunk remat applies
ST_RUNS = (("hymba-15b", 4, 2, 2048),
           ("rwkv6-3b", 4, 2, 2048))
ST_RESUME = "hymba-15b"  # trained through a compressed resume (run B)
# the profiled step's tokens a row, on the same weights: the profiler's
# pass over a step's kernels costs far more than the step (at 2 x 512,
# 14.8 s over hymba's 21819 kernels and 37.7 s over rwkv6-3b's 33538,
# PERF.md), and a scan's kernels grow with S.  256 still checkpoints two
# chunks
ST_PROFILE_SEQ = 256
# steps on one repeated batch, cut from phases 14 and 16's 8 to hold the
# phase's time (an rwkv6-3b step took 3.3-6.5 s); the loss falls in 4
ST_MEMO_STEPS = 4
ST_SMOKE = ("hymba_15b", "rwkv6_3b")  # card against the CPU
ST_SMOKE_SEQ = 256  # two checkpointed chunks on both sides
SSM_FP32 = ("A_log", "D", "dt_bias")  # the hybrid's fp32 SSM leaves


def scan_train_phase(smi: str, seed: int) -> dict:
    """Phase 17: the hybrid SSM and RWKV families trained on the card (see
    the module docstring).  Returns its JSON line."""
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="fptc_strain_")
    try:
        with exact_bf16_sums() as precision:
            runs = [family_train_run(arch, layers, b, s, seed,
                                     os.path.join(tmp, arch),
                                     resume=arch == ST_RESUME, twice=True,
                                     profile_seq=ST_PROFILE_SEQ,
                                     memo_steps=ST_MEMO_STEPS)
                    for arch, layers, b, s in ST_RUNS]
            smoke = {arch: smoke_card_vs_cpu(arch, seed, s=ST_SMOKE_SEQ)
                     for arch in ST_SMOKE}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    resume = next(r["resume"] for r in runs if "resume" in r)
    fp32 = {k: v for k, v in resume["rel_rms_err"].items()
            if k.split(".")[-2] == "ssm" and k.split(".")[-1] in SSM_FP32}
    check(all(any(k.startswith(part + ".") and k.endswith("." + leaf)
                  for k in fp32) for part in ("m", "v") for leaf in SSM_FP32),
          f"{ST_RESUME}: the fp32 SSM leaves' m and v were not all "
          f"compressed: {sorted(fp32)}")
    resume["ssm_fp32_rel_rms_err"] = fp32
    held = resume["kernels"]
    return {"phase": "scan_train", "nvidia_smi": smi,
            "precision": precision, "optimizer": TRAIN_OPT, "runs": runs,
            "step_ms_what": "CUDA events around step_fn, steps 1-3 of run "
            "A (step 0 warms); profile: one step under torch.profiler over "
            f"{ST_PROFILE_SEQ} tokens a row, its idle share against that "
            "step's own CUDA-event ms (profile_step_ms); step_host: each "
            "timed step's ms in Python's collector, its full collections, "
            "the caching allocator's device allocations",
            "card_vs_cpu_smoke": smoke,
            "launches": {k: held[k]["launches"] for k in CKPT_KERNELS},
            "max_abs_err": {k: held[k]["max_abs_err"] for k in CKPT_KERNELS},
            "seconds": time.perf_counter() - t_phase}


# -- 18. mesh_train: two ranks on the one card, pod-compressed and FSDP ------
# granite-8b at full width, 2 layers (phase 14's cell), a global batch of 2
# x 4096; one row a rank
MT_POD_STEPS, MT_FSDP_STEPS, MT_SAVE_AFTER = 3, 4, 1
MT_MODE = "truncate_int8"
MT_TIMEOUT_S = 900  # a rank's collectives' and the parent's wait
MT_DEVICE = "cuda"  # every rank's, the one card
MT_WIRE = ("gloo's own CUDA path: ProcessGroupGloo stages CUDA tensors "
           "through host memory itself; the port makes no host copy")


def _mesh_setup(port: int, rank: int, world: int):
    """This process's gloo group (``world`` ranks on 127.0.0.1, every one
    on ``cuda:0``) and phase 14's precision settings."""
    import datetime

    import torch
    import torch.distributed as dist

    if MT_DEVICE == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=MT_TIMEOUT_S))


def _mesh_rank(rank: int, port: int, src: str, jobs, q) -> None:
    """A spawned rank of phase 18: runs the named jobs of this module in
    order and sends ``(rank, error, results)`` (host values only)."""
    import traceback

    try:
        sys.path.insert(0, src)
        import torch.distributed as dist

        _mesh_setup(port, rank, 2)
        try:
            out = [globals()[name](**kw) for name, kw in jobs]
        finally:
            dist.destroy_process_group()
        q.put((rank, None, out))
    except BaseException:  # noqa: BLE001 - the parent fails the phase
        q.put((rank, traceback.format_exc(), None))


def mesh_ranks(src: str, jobs) -> list:
    """Two spawned ranks running ``jobs``; ``[results of rank 0, of rank
    1]``.  A failed or silent rank fails the phase; nothing is retried."""
    import multiprocessing as mp
    import queue
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_mesh_rank, args=(r, port, src, jobs, q))
             for r in range(2)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        for _ in procs:
            rank, err, out = q.get(timeout=MT_TIMEOUT_S)
            if err:
                errors.append(f"rank {rank}: {err}")
            else:
                got[rank] = out
    except queue.Empty:
        errors.append(f"ranks {sorted({0, 1} - set(got))} sent nothing in "
                      f"{MT_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    check(not errors, "phase 18's ranks: " + "\n".join(errors))
    return [got[0], got[1]]


def _leaf_digests(tree) -> dict:
    """sha256 of each tensor's bytes (bf16 through its bit pattern), by
    name."""
    import torch

    return {n: digest([t.detach().view(torch.int16)
                       if t.dtype == torch.bfloat16 else t.detach()])
            for n, t in tree.items()}


def _mesh_model(seed: int):
    import torch

    from repro_torch.models import build_model

    cfg = family_config(TRAIN_ARCH, TRAIN_LAYERS)
    full_width(TRAIN_ARCH, cfg)
    return cfg, build_model(cfg, device=MT_DEVICE, generator=torch.Generator(
        device=MT_DEVICE).manual_seed(seed))


def pod_oracle(seed: int) -> dict:
    """(a)'s one-process oracle on the card: each replica's gradients in
    turn (one row of the global batch each), ``replica_sum`` on the
    stacked tree (the reference's leaves, a stack's layers in one),
    ``AdamW.update``; the losses and the digests of the final weights and
    of each replica's residual."""
    import torch

    from repro_torch.distributed.compression import (
        CompressionConfig,
        GradCompressor,
    )
    from repro_torch.distributed.optimizer import AdamW, AdamWConfig
    from repro_torch.models.convert import stack_layers, unstack_layers

    cfg, model = _mesh_model(seed)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt = AdamW(AdamWConfig(**TRAIN_OPT))
    comp = GradCompressor(CompressionConfig(mode=MT_MODE))
    st = opt.init(params, with_residual=True, replicas=2)
    losses = []
    for batch in train_batches(cfg, 2, TRAIN_SEQ, seed, MT_POD_STEPS, "cpu"):
        per, grads = [], []
        for p in range(2):
            loss = model.loss({k: v[p:p + 1].to(MT_DEVICE)
                               for k, v in batch.items()})
            per.append(loss.detach())
            grads.append(list(torch.autograd.grad(loss,
                                                  list(params.values()))))
        stacked = {}
        for i, n in enumerate(params):  # one leaf's two copies at a time
            stacked[n] = torch.stack([grads[0][i], grads[1][i]])
            grads[0][i] = grads[1][i] = None
        del grads
        tree = stack_layers(model, stacked, layer_axis=1)
        del stacked
        mean, res = comp.replica_sum(tree, stack_layers(
            model, st.residual, layer_axis=1))
        del tree
        _, st, _ = opt.update(params, st, unstack_layers(mean, model),
                              unstack_layers(res, model, layer_axis=1))
        del mean, res
        losses.append(float(torch.stack(per).mean()))
    out = {"losses": losses, "params": _leaf_digests(params),
           "residual": [_leaf_digests({n: r[p] for n, r in
                                       st.residual.items()})
                        for p in range(2)]}
    del model, params, st
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_pod_run(seed: int) -> dict:
    """(a) on a rank: ``pod`` 2, one replica a rank, ``MT_POD_STEPS``
    steps on its row; then the compressor and its collectives timed on
    one more backward's gradients."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.tree import tree_leaves
    from repro_torch.distributed import compression as cm
    from repro_torch.distributed.compression import CompressionConfig
    from repro_torch.distributed.optimizer import AdamW, AdamWConfig
    from repro_torch.distributed.train import make_train_step
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.convert import stack_layers

    torch.cuda.reset_peak_memory_stats()
    cfg, model = _mesh_model(seed)
    bound = train_bound(model, TRAIN_SEQ, 1, TRAIN_SEQ)
    mesh = make_local_mesh(pod=2, device_type=MT_DEVICE)
    ts = make_train_step(model, AdamW(AdamWConfig(**TRAIN_OPT)), mesh,
                         compression=CompressionConfig(mode=MT_MODE))
    check(ts.compressor is not None and ts.replicas == 2 and ts.layouts
          is None, "pod 2 did not give the pod-compressed step")
    batches = train_batches(cfg, 2, TRAIN_SEQ, seed, MT_POD_STEPS, "cpu")
    st, losses, step_ms = ts.init(), [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, met = ts.step_fn(st, ts.local_batch(batch))
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak_steps = torch.cuda.max_memory_allocated()
    params = dict(model.named_parameters())
    out = {"losses": losses, "step_ms": step_ms, "params":
           _leaf_digests(params), "residual": _leaf_digests(
               {n: r[0] for n, r in st.residual.items()})}
    # the compressor and its collectives, on one more backward's gradients
    local = {k: v.to(MT_DEVICE)
             for k, v in ts.local_batch(batches[-1]).items()}
    loss = model.loss(local)
    # the reference's leaves, as the step passes them
    grads = stack_layers(model, dict(zip(params, torch.autograd.grad(
        loss, list(params.values())))))
    residual = stack_layers(model, st.residual, layer_axis=1)
    del loss
    coll = [0.0]

    def synced(fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                coll[0] += time.perf_counter() - t
        return run

    saved = cm._gather, cm._pmax
    cm._gather, cm._pmax = synced(cm._gather), synced(cm._pmax)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts.compressor.replica_sum_ranks(grads, residual,
                                        group=mesh.get_group("pod"))
        torch.cuda.synchronize()
        comp_ms = (time.perf_counter() - t0) * 1e3
    finally:
        cm._gather, cm._pmax = saved
    c = ts.compressor.config
    sizes = [g.numel() for g in tree_leaves(grads)]
    wire = sum(ts.compressor.wire_bytes(n) if n >= c.min_size else 2 * n
               for n in sizes)
    del grads, residual
    out.update({
        "compressor_ms": comp_ms - coll[0] * 1e3,
        "collective_ms": coll[0] * 1e3,
        "wire_bytes": wire, "f32_bytes": 4 * sum(sizes),
        "wire_ratio": wire / (4 * sum(sizes)),
        "bound_ms": bound["ms"], "bound_by": bound["by"],
        "max_memory_allocated": peak_steps,
        "max_memory_allocated_with_timing":
            torch.cuda.max_memory_allocated(),
        "rank": dist.get_rank()})
    del model, params, st, ts
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ckpt_want(path: str) -> tuple:
    """``(engine calls, encode buckets)`` of a compressed checkpoint's
    manifest: K1 and ``lut_idct`` launch once a call on restore, K4 once
    an encode bucket on save."""
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.serving import workloads as wl
    from repro_torch.serving.engine import p2

    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    lengths = [n for leaf in manifest["state"]["leaves"]
               for n in leaf["lengths"]]
    calls = wl.engine_calls(lengths)
    buckets = sum(len({p2(-(-n // ckpt.CKPT_CODEC_CONFIG.n))
                       for n in lengths[c]}) for c in calls)
    return len(calls), buckets


def _held(tally, launches: dict, names) -> dict:
    """Each named kernel's calls, all held to their plain version, one a
    launch; its errors, ms and bound."""
    out = {}
    for name in names:
        t = tally[name]
        ok = t["ok"]
        check(ok and t["calls"] == launches[name] > 0,
              f"{name} at the train state's shapes against its plain "
              f"version: {t['calls']} calls, {launches[name]} launches, "
              f"{t['results']}")
        total = bound_ms(t["bytes"], t["operations"])
        out[name] = {"launches": launches[name], "calls": t["calls"],
                     "ok": ok, "max_abs_err": t["max_abs_err"],
                     **({"flips": t["flips"], "cells": t["cells"]}
                        if name == "encode_levels" else {}),
                     "ms": t["ms"], "first_ms": t["first_ms"],
                     "bound_ms": total[0], "bound_by": total[1]}
    return out


def mesh_fsdp_run(seed: int, ckpt_dir: str) -> dict:
    """(b) on a rank: FSDP over ``data`` 2, ``MT_FSDP_STEPS`` steps on its
    row of each global batch; after step ``MT_SAVE_AFTER`` the state
    gathered whole and saved compressed by rank 0 (every K4 call held at
    once to its plain version)."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.optimizer import AdamW, AdamWConfig
    from repro_torch.distributed.train import make_train_step
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.convert import save_train_state

    torch.cuda.reset_peak_memory_stats()
    cfg, model = _mesh_model(seed)
    bound = train_bound(model, TRAIN_SEQ, 1, TRAIN_SEQ)
    whole = sum(p.numel() * (p.element_size() + 8)
                for p in model.parameters())
    mesh = make_local_mesh(data=2, device_type=MT_DEVICE)
    ts = make_train_step(model, AdamW(AdamWConfig(**TRAIN_OPT)), mesh)
    check(ts.layouts is not None, "data 2 did not give the FSDP step")
    st = ts.init()
    resident = (sum(p.numel() * p.element_size() for p in model.parameters())
                + sum(t.numel() * t.element_size() for t in
                      (*st.m.values(), *st.v.values())))
    rank = dist.get_rank()
    batches = train_batches(cfg, 2, TRAIN_SEQ, seed, MT_FSDP_STEPS, "cpu")
    losses, norms, step_ms, save = [], [], [], None
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, met = ts.step_fn(st, ts.local_batch(batch))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i != MT_SAVE_AFTER:
            continue
        peak_steps = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        whole_p, whole_st = ts.full_state(st)
        gather_s = time.perf_counter() - t0
        if rank == 0:
            ops.reset_launches()
            with ckpt_kernels_held(CKPT_KERNELS[:2]) as held:
                t0 = time.perf_counter()
                path = save_train_state(ckpt_dir, i + 1, model, whole_st,
                                        compress=True, device=MT_DEVICE,
                                        params=whole_p)
                save_s = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            calls, buckets = _ckpt_want(path)
            want = {k: 0 for k in launches}
            want.update(encode_levels=buckets, symlen_pack=buckets)
            check(launches == want, f"(b)'s save launch counts {launches} "
                  f"!= {want}")
            save = {"step": i + 1, "gather_s": gather_s, "save_s": save_s,
                    "save_check_s": held["check_s"],
                    "save_s_less_checks": save_s - held["check_s"],
                    "engine_calls": calls, "encode_buckets": buckets,
                    "launches": launches,
                    "kernels": _held(held, launches, CKPT_KERNELS[:2]),
                    "max_memory_allocated": torch.cuda.max_memory_allocated()}
        del whole_p, whole_st
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    out = {"losses": losses, "grad_norms": norms, "step_ms": step_ms,
           "resident_bytes": resident, "whole_state_bytes": whole,
           "resident_share": resident / whole, "bound_ms": bound["ms"],
           "bound_by": bound["by"], "max_memory_allocated": peak_steps,
           "max_memory_allocated_after_save":
               torch.cuda.max_memory_allocated(), "save": save, "rank": rank}
    del model, st, ts
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_resume(seed: int, ckpt_dir: str, uninterrupted: list) -> dict:
    """(c) in the parent: a one-rank gloo group and mesh, the newest
    checkpoint restored (every K1 / ``lut_idct`` call held at once to its
    plain version), ``remesh``-ed onto the mesh, loaded, and the steps
    after it taken on the global batches."""
    import socket

    import torch
    import torch.distributed as dist

    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed.elastic import remesh
    from repro_torch.distributed.optimizer import AdamW, AdamWConfig
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.distributed.train import make_train_step
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.convert import load_train_state

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    _mesh_setup(port, 0, 1)
    try:
        cfg, model = _mesh_model(seed)
        mesh = make_local_mesh(data=1, device_type=MT_DEVICE)
        opt = AdamW(AdamWConfig(**TRAIN_OPT))
        ts = make_train_step(model, opt, mesh)
        specs = model.param_specs()
        like = {"params": specs, "m": specs, "v": specs}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with ckpt_kernels_held(CKPT_KERNELS[2:]) as held:
            t0 = time.perf_counter()
            step, host = ckpt.restore_latest(ckpt_dir, like,
                                             device=MT_DEVICE)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        calls, _ = _ckpt_want(os.path.join(ckpt_dir, f"step_{step:012d}"))
        want = {k: 0 for k in launches}
        want.update(symlen_decode=calls, lut_idct=calls)
        check(launches == want, f"(c)'s restore launch counts {launches} "
              f"!= {want}")
        t0 = time.perf_counter()
        placed = remesh(host, like, ShardingPolicy(mesh))
        del host
        local = _tree_map(lambda d: d.to_local(), placed)
        del placed
        st = load_train_state(local, model, ts.init(), step, opt)
        del local
        place_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        batches = train_batches(cfg, 2, TRAIN_SEQ, seed, MT_FSDP_STEPS,
                                "cpu")
        losses = []
        for batch in batches[step:]:
            st, met = ts.step_fn(st, batch)
            losses.append(float(met["loss"]))
        del model, st, ts
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    last = uninterrupted[-1]
    rel = abs(losses[-1] - last) / abs(last)
    check(all(math.isfinite(x) for x in losses) and rel <= TRAIN_RESUME_TOL,
          f"(c)'s resumed losses {losses} against (b)'s {uninterrupted}: "
          f"step {MT_FSDP_STEPS - 1} relative {rel} > {TRAIN_RESUME_TOL}")
    return {"step": step, "losses": losses, "uninterrupted": uninterrupted,
            "rel": rel, "tol": TRAIN_RESUME_TOL,
            "own_change": abs(last - uninterrupted[-2]) / abs(last),
            "restore_s": restore_s, "restore_check_s": held["check_s"],
            "restore_s_less_checks": restore_s - held["check_s"],
            "remesh_load_s": place_s, "engine_calls": calls,
            "launches": launches,
            "kernels": _held(held, launches, CKPT_KERNELS[2:]),
            "max_memory_allocated": peak}


def mesh_train_phase(smi: str, seed: int, src: str, run_a: list) -> dict:
    """Phase 18: the multi-device layer (M10d, ``pod`` and ``data``) on two
    ranks of the one card (see the module docstring).  ``run_a``: phase
    14's one-device ``(loss, grad_norm)`` a step on the same weights and
    global batches."""
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="fptc_mesh_")
    try:
        with exact_bf16_sums() as precision:
            t0 = time.perf_counter()
            oracle = pod_oracle(seed)
            oracle_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ranks = mesh_ranks(src, [
                ("mesh_pod_run", {"seed": seed}),
                ("mesh_fsdp_run", {"seed": seed, "ckpt_dir": tmp})])
            ranks_s = time.perf_counter() - t0
            pod = [r[0] for r in ranks]
            fsdp = [r[1] for r in ranks]
            # (a) bit for bit
            for r, out in enumerate(pod):
                diff_p = sorted(n for n, d in out["params"].items()
                                if d != oracle["params"][n])
                diff_r = sorted(n for n, d in out["residual"].items()
                                if d != oracle["residual"][r][n])
                check(out["losses"] == oracle["losses"] and not diff_p
                      and not diff_r, f"(a) rank {r} against the oracle: "
                      f"losses {out['losses']} vs {oracle['losses']}, "
                      f"weights differ {diff_p}, residuals differ {diff_r}")
            # (b) against phase 14's one-device run A
            gaps = [abs(l - a) / abs(a) for l, (a, _) in
                    zip(fsdp[0]["losses"], run_a)]
            check(all(out["losses"] == fsdp[0]["losses"] for out in fsdp)
                  and max(gaps[1:]) <= LM_CARD_CPU_TOL,
                  f"(b)'s FSDP losses {[o['losses'] for o in fsdp]} against "
                  f"the one-device run {run_a}: gaps {gaps}")
            # the norm's shares-weighted sum of squares across the ranks
            norm_gaps = [abs(g - a) / abs(a) for g, (_, a) in
                         zip(fsdp[0]["grad_norms"], run_a)]
            check(all(out["grad_norms"] == fsdp[0]["grad_norms"]
                      for out in fsdp)
                  and len(norm_gaps) == MT_FSDP_STEPS
                  and max(norm_gaps) <= LM_CARD_CPU_TOL,
                  f"(b)'s FSDP grad norms {[o['grad_norms'] for o in fsdp]} "
                  f"against the one-device run {run_a}: gaps {norm_gaps}")
            check(all(0.45 <= out["resident_share"] <= 0.55 for out in fsdp),
                  f"(b)'s ranks hold {[o['resident_share'] for o in fsdp]} "
                  "of the state")
            t0 = time.perf_counter()
            resume = mesh_resume(seed, tmp, fsdp[0]["losses"])
            resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    save = fsdp[0]["save"]
    kernels = {**save["kernels"], **resume["kernels"]}
    for out in pod:
        out["params"] = out["residual"] = None
    return {
        "phase": "mesh_train", "nvidia_smi": smi, "arch": TRAIN_ARCH,
        "layers": TRAIN_LAYERS, "global_batch": [2, TRAIN_SEQ],
        "rank_batch": [1, TRAIN_SEQ], "ranks": 2, "device": "cuda:0",
        "backend": "gloo", "wire": MT_WIRE, "precision": precision,
        "optimizer": TRAIN_OPT,
        "pod_compressed": {
            "mode": MT_MODE, "steps": MT_POD_STEPS,
            "oracle_losses": oracle["losses"], "bit_for_bit": True,
            "ranks": pod},
        "fsdp": {"steps": MT_FSDP_STEPS,
                 "one_device_losses": [a for a, _ in run_a],
                 "one_device_grad_norms": [g for _, g in run_a],
                 "gaps": gaps, "grad_norm_gaps": norm_gaps,
                 "tol": LM_CARD_CPU_TOL, "ranks": fsdp},
        "resume": resume,
        "launches": {k: v["launches"] for k, v in kernels.items()},
        "max_abs_err": {k: v["max_abs_err"] for k, v in kernels.items()},
        "step_ms_what": "host clock around step_fn with the card "
        "synchronized, every step (step 0 warms); compressor_ms and "
        "collective_ms: one more call of replica_sum_ranks, its all-gathers "
        "and max timed with the card synchronized around each",
        "seconds_split": {"oracle": oracle_s, "ranks": ranks_s,
                          "resume": resume_s},
        "seconds": time.perf_counter() - t_phase}


def _flat(tree, prefix=""):
    """``(key, tensor)`` of a nested dict's leaves, keys sorted."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(_flat(v, f"{prefix}{k}."))
        else:
            out.append((prefix + k, v))
    return out


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--src", default=os.path.join(HERE, "src"),
                    help="the src directory whose repro_torch is driven "
                    "(default: this checkout's)")
    args = ap.parse_args()

    # -- 1. device -----------------------------------------------------------
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    src = os.path.abspath(args.src)
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"{src}/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    import numpy as np

    from repro_torch.core import DOMAIN_DEFAULTS, calibrate, codec, decode
    from repro_torch.core import dct, encode, quantize, symlen
    from repro_torch.data import make_signal
    from repro_torch.kernels import dct_quant as dq
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels import encode_fused as ef
    from repro_torch.kernels import huffman_decode as hd
    from repro_torch.kernels import idct_dequant as idq
    from repro_torch.kernels import ops
    from repro_torch.serving import (
        DEFAULT_CHUNK_SIZE,
        BatchDecoder,
        BatchEncoder,
        Transcoder,
        streams_from_containers,
    )
    from repro_torch.serving.engine import symlen_bucket

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from _pack_layouts import CHUNKS as PACK_CHUNKS
    from _pack_layouts import LAYOUTS as PACK_LAYOUTS
    from _pack_layouts import pack_case
    from _levels_layouts import BIG, CODINGS as LEVEL_CODINGS
    from _levels_layouts import dct_case, levels_case, walk_rows
    from _idct_layouts import every_level
    from _symlen_layouts import BIG as SYMLEN_BIG
    from _symlen_layouts import L_MAXES as SYMLEN_L_MAXES
    from _symlen_layouts import LAYOUTS as SYMLEN_LAYOUTS
    from _symlen_layouts import num_symbols_cases, symlen_case

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    ops.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "log_lines": len(ops.build_log().splitlines())})

    # -- 3. data ---------------------------------------------------------------
    t0 = time.perf_counter()
    samples, distinct, replicas = 1 << 18, 4, 32
    tables, keys, pool = {}, [], {}
    for d, (dom, ds, pred) in enumerate(ARCHIVAL):
        strip = make_signal(ds, samples, seed=args.seed * 1000 + d)
        sigs = [make_signal(ds, samples, seed=args.seed * 1000 + 100 + 8 * d + i)
                for i in range(distinct)]
        for v3, did in ((False, d), (True, d + len(ARCHIVAL))):
            cfg = DOMAIN_DEFAULTS[dom]
            if v3:
                cfg = cfg.replace(predictor=pred, predict_bands=2,
                                  zero_planes=True)
            tab = calibrate(strip, cfg, domain_id=did, seed=args.seed)
            tables[did] = tab
            cs = [encode(s, tab) for s in sigs]
            keys.append(cs[0].plan_key)
            pool[did] = (cs, sigs)
    # the archive interleaves the plan keys: 8 keys x 4 signals x 32
    archive, source = [], []
    for _ in range(replicas):
        for did, (cs, _) in pool.items():
            for i, c in enumerate(cs):
                archive.append(c)
                source.append((did, i))
    n_out = sum(c.signal_length for c in archive)
    kv = kv_cache(args.seed)
    channels, tokens = kv.shape
    kv_tab = calibrate(kv.ravel(), DOMAIN_DEFAULTS["kv"], domain_id=8,
                       seed=args.seed)
    kv_gpu = torch.from_numpy(kv).cuda()
    enc = BatchEncoder()
    kv_levels = enc.encode_fixed(kv_gpu, kv_tab)  # u8[channels, 256, 16]
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "containers": len(archive), "plan_keys": len(keys),
          "samples_out": n_out, "bytes_out": 4 * n_out,
          "archive_bytes": sum(c.compressed_bytes for c in archive),
          "kv_levels": list(kv_levels.shape)})

    # -- 4. kernels vs plain, at the main path's shapes -------------------------
    t0 = time.perf_counter()
    groups, _ = streams_from_containers(archive)
    dec = BatchDecoder()
    by_key = {c.plan_key: c for c in archive}
    buckets = []
    for grp in groups:
        plan = dec.plan_for(by_key[grp.plan_key], tables)
        nw = dec.scheduler.round(grp.total_windows)
        v3 = None
        if grp.v3_idx is not None:
            v3 = (torch.from_numpy(grp.v3_idx).cuda(),
                  torch.from_numpy(grp.v3_seg).cuda())
        buckets.append(dict(
            grp=grp, plan=plan, v3=v3, nw=nw,
            words=grp.words.cuda(), symlen=grp.symlen.cuda(),
            ms=symlen_bucket(grp.max_symlen),
        ))
    # each CUDA kernel against its plain version on the same inputs, then K2
    # (its three kernels in a row) against its plain version as a whole
    checks = {"symlen_decode": [], "v3_unpredict": [], "lut_idct": [],
              "decode_fused": [], "idct_dequant": [], "encode_levels": [],
              "symlen_pack": [], "dct_quant": [], "symlen_tile": [],
              "encode_levels_gather": [], "symlen_lut": []}
    digests = {"symlen_decode": [], "symlen_tile": [], "lut_idct": [],
               "idct_dequant": [], "encode_levels": [],
               "encode_levels_gather": [], "dct_quant": []}
    for b in buckets:
        p, kw = b["plan"], dict(l_max=b["plan"].l_max, max_symlen=b["ms"])
        key = str(b["grp"].plan_key)
        nsym = b["nw"] * p.e
        k1 = hd.huffman_decode_dense(b["words"], b["symlen"], p.tables,
                                     num_symbols=nsym, **kw)
        k1p = hd.huffman_decode_plain(b["words"], b["symlen"], p.tables,
                                      num_symbols=nsym, **kw)
        digests["symlen_decode"].append({"plan_key": key,
                                         "sha256": digest([k1])})
        lv_kw = dict(num_windows=b["nw"], e=p.e, coding=p.coding, **kw)
        lvp = df.bucket_levels_plain(b["words"], b["symlen"], p.tables,
                                     b["v3"], **lv_kw)
        if b["v3"] is not None:
            v3_kw = dict(num_windows=b["nw"], e=p.e, pred_id=p.coding[0],
                         bands=p.coding[1])
            un = df.v3_expand_unpredict_cuda(k1p, *b["v3"], **v3_kw)
            unp = df.v3_expand_unpredict_plain(k1p, *b["v3"], **v3_kw)
            cv = {"plan_key": key, "equal": bool(torch.equal(un, unp)),
                  "max_abs_err": int_err(un, unp)}
            checks["v3_unpredict"].append(cv)
            check(cv["equal"], f"v3 levels differ from plain: {cv}")
        li = df.lut_idct(lvp, p.lut, p.basis)
        lip = df.lut_idct_plain(lvp, p.lut, p.basis)
        digests["lut_idct"].append({"plan_key": key, "sha256": digest([li])})
        lv = df.bucket_levels(b["words"], b["symlen"], p.tables, b["v3"],
                              **lv_kw)
        f_kw = dict(n=p.n, **lv_kw)
        k2 = df.decode_fused(b["words"], b["symlen"], p.tables, p.lut,
                             p.basis, b["v3"], **f_kw)
        k2p = df.decode_fused_plain(b["words"], b["symlen"], p.tables, p.lut,
                                    p.basis, b["v3"], **f_kw)
        torch.cuda.synchronize()
        c1 = {"plan_key": key, "symbols": nsym,
              "equal": bool(torch.equal(k1, k1p)),
              "max_abs_err": int_err(k1, k1p)}
        cl = {"plan_key": key, "max_abs_err": float((li - lip).abs().max()),
              "rel_err": rel_err(li, lip),
              "finite": bool(torch.isfinite(li).all())}
        c2 = {"plan_key": key,
              "levels_equal": bool(torch.equal(lv, lvp)),
              "max_abs_err": float((k2 - k2p).abs().max()),
              "rel_err": rel_err(k2, k2p),
              "finite": bool(torch.isfinite(k2).all())}
        # K6: the whole tile against its plain version, and compacted
        # against K1's dense output
        tile = hd.huffman_decode_tile(b["words"], p.tables, **kw)
        tilep = hd.huffman_decode_tile_plain(b["words"], p.tables, **kw)
        compact = symlen.compact_padded_scatter(tile.T, b["symlen"], nsym)
        torch.cuda.synchronize()
        c6 = {"plan_key": key, "slots": tile.numel(),
              "equal": bool(torch.equal(tile, tilep)),
              "max_abs_err": int_err(tile, tilep),
              "compact_equals_k1": bool(torch.equal(
                  compact.to(torch.uint8), k1))}
        checks["symlen_tile"].append(c6)
        digests["symlen_tile"].append({"plan_key": key,
                                       "sha256": digest([tile])})
        check(c6["equal"] and c6["compact_equals_k1"],
              f"K6 tile differs: {c6}")
        del tile, tilep, compact
        checks["symlen_decode"].append(c1)
        checks["lut_idct"].append(cl)
        checks["decode_fused"].append(c2)
        check(c1["equal"], f"K1 symbols differ from plain: {c1}")
        check(cl["finite"] and cl["rel_err"] <= REL_TOL,
              f"LUT-iDCT differs from plain: {cl}")
        check(c2["levels_equal"] and c2["finite"]
              and c2["rel_err"] <= REL_TOL, f"K2 differs from plain: {c2}")
    # the v3 stage on one full-size synthetic bucket per archive v3 width:
    # 2**20 windows, linear2, the archive's 2 predicted bands and all e
    for e in sorted({k[2] for k in keys if tuple(k[4]) != (0, 0, False)}):
        adv = [torch.from_numpy(a).cuda() for a in adversarial_v3(
            1 << 20, e, df.v3_tile_windows(e), seed=args.seed + e)]
        for bands in (2, e):
            v3_kw = dict(num_windows=1 << 20, e=e, pred_id=2, bands=bands)
            un = df.v3_expand_unpredict_cuda(*adv, **v3_kw)
            unp = df.v3_expand_unpredict_plain(*adv, **v3_kw)
            cv = {"plan_key": f"adversarial e={e} linear2 bands={bands}",
                  "equal": bool(torch.equal(un, unp)),
                  "max_abs_err": int_err(un, unp)}
            checks["v3_unpredict"].append(cv)
            check(cv["equal"], f"v3 levels differ from plain: {cv}")
        del adv, un, unp
    # K1 and K6 on the adversarial layouts of tests/_symlen_layouts.py at
    # SYMLEN_BIG words (every warp of K1 walks more than 4 tiles): K1 at
    # num_symbols below, at and past the total, K6's whole tile, and K6
    # compacted against K1
    t_sl = time.perf_counter()

    def layout_tables(lengths, l_max):
        from repro_torch.core.calibration import DomainTables
        from repro_torch.core.config import CodecConfig
        from repro_torch.core.huffman import codebook_from_lengths
        from repro_torch.core.quantize import quant_table_from_arrays

        return DomainTables(
            config=CodecConfig(n=8, e=8, b1=0, b2=8, l_max=l_max),
            quant=quant_table_from_arrays(np.zeros(8), np.ones(8), 50.0,
                                          0.0),
            book=codebook_from_lengths(lengths, l_max),
        ).device_tables("cuda")

    for l_max in SYMLEN_L_MAXES:
        for layout in SYMLEN_LAYOUTS:
            c = symlen_case(l_max, layout, SYMLEN_BIG, seed=args.seed)
            tabs = layout_tables(c["lengths"], l_max)
            lw = torch.from_numpy(c["words"].view(np.int64)).cuda()
            ls = torch.from_numpy(c["symlen"]).cuda()
            kw = dict(l_max=l_max, max_symlen=c["max_symlen"])
            name = f"layout l_max={l_max} {layout}"
            for nsym in num_symbols_cases(c["total"]):
                a = hd.huffman_decode_dense(lw, ls, tabs, num_symbols=nsym,
                                            **kw)
                ap = hd.huffman_decode_plain(lw, ls, tabs, num_symbols=nsym,
                                             **kw)
                cc = {"plan_key": name, "symbols": nsym,
                      "equal": bool(torch.equal(a, ap)),
                      "max_abs_err": int_err(a, ap)}
                checks["symlen_decode"].append(cc)
                check(cc["equal"], f"K1 differs from plain: {cc}")
            nsym = max(1, c["total"])
            t6 = hd.huffman_decode_tile(lw, tabs, **kw)
            t6p = hd.huffman_decode_tile_plain(lw, tabs, **kw)
            cc = {"plan_key": name, "slots": t6.numel(),
                  "equal": bool(torch.equal(t6, t6p)),
                  "max_abs_err": int_err(t6, t6p),
                  "compact_equals_k1": bool(torch.equal(
                      symlen.compact_padded_scatter(t6.T, ls, nsym).to(
                          torch.uint8),
                      hd.huffman_decode_dense(lw, ls, tabs, num_symbols=nsym,
                                              **kw)))}
            checks["symlen_tile"].append(cc)
            check(cc["equal"] and cc["compact_equals_k1"],
                  f"K6 tile differs: {cc}")
            del a, ap, t6, t6p
    # the decode table both run on, built on the card by K1's first kernel
    # for every l_max in [1, 16] (three codes each), against the plain table
    # entry by entry (a port without it, driven by --src, skips this)
    for l_max in range(1, 17) if hasattr(hd, "decode_lut") else ():
        for layout in ("stream", "one_bit", "random"):
            tabs = layout_tables(symlen_case(l_max, layout, 1)["lengths"],
                                 l_max)
            got = hd.decode_lut(tabs, l_max=l_max)
            want = hd.decode_lut_plain(tabs, l_max=l_max)
            cc = {"l_max": l_max, "code": layout, "entries": got.numel(),
                  "equal": bool(torch.equal(got, want)),
                  "max_abs_err": int_err(got, want)}
            checks["symlen_lut"].append(cc)
            check(cc["equal"], f"decode table differs from plain: {cc}")
    symlen_layouts_s = time.perf_counter() - t_sl
    kv_flat = kv_levels.reshape(-1, 16)
    kv_q = kv_tab.device_tables("cuda").quant
    kv_basis = dct.idct_basis(16, 16, device="cuda")
    k3 = idq.idct_dequant(kv_flat, kv_q, kv_basis)
    k3p = idq.idct_dequant_plain(kv_flat, kv_q, kv_basis)
    torch.cuda.synchronize()
    c3 = {"shape": list(kv_levels.shape),
          "max_abs_err": float((k3 - k3p).abs().max()),
          "rel_err": rel_err(k3, k3p), "finite": bool(torch.isfinite(k3).all())}
    checks["idct_dequant"].append(c3)
    digests["idct_dequant"].append({"shape": list(kv_levels.shape),
                                    "sha256": digest([k3])})
    check(c3["finite"] and c3["rel_err"] <= REL_TOL,
          f"K3 differs from plain: {c3}")
    # every level in every band: levels [256, E] whose row r holds level r,
    # the basis [I_E | 0], so out[:, :E] is the dequant table: lut_idct's
    # equal to each archive plan's LUT exactly (+-0 alike), K3's within the
    # float bound of the plain dequantize for the KV table and each archive
    # plan's; the pad columns zero
    plans = [("kv", kv_q, None, 16, 16)] + [
        (str(b["grp"].plan_key), b["plan"].tables.quant, b["plan"].lut,
         b["plan"].e, b["plan"].n) for b in buckets]
    for name, q, lut, e, n in plans:
        lv_all, eye = (torch.from_numpy(a).cuda() for a in every_level(e, n))
        if lut is not None:
            ev = df.lut_idct(lv_all, lut, eye)
            ce = {"plan_key": f"every level {name}",
                  "equal_lut": bool(torch.equal(ev[:, :e], lut.T))
                  and not bool(ev[:, e:].any()),
                  "max_abs_err": float((ev[:, :e] - lut.T).abs().max())}
            checks["lut_idct"].append(ce)
            check(ce["equal_lut"], f"LUT-iDCT is not its LUT: {ce}")
        ev = idq.idct_dequant(lv_all, q, eye)
        evp = quantize.dequantize(lv_all, q)
        ce = {"shape": f"every level {name}",
              "max_abs_err": float((ev[:, :e] - evp).abs().max()),
              "rel_err": rel_err(ev[:, :e], evp),
              "zero_pad": not bool(ev[:, e:].any())}
        checks["idct_dequant"].append(ce)
        digests["idct_dequant"].append({"shape": ce["shape"],
                                        "sha256": digest([ev])})
        check(ce["rel_err"] <= REL_TOL and ce["zero_pad"],
              f"K3's dequant differs from plain: {ce}")
    # the encode kernels: one archive bucket per plan key, as the engine
    # stages it (128 rows of 2**18 samples, chunk 1024), and K5 on the KV
    # block.  Identity basis: exact; DCT basis: the flip rule, on levels
    # before prediction (a v3 grid is un-predicted row by row first)
    ebuckets = []
    for did, (cs, sigs) in pool.items():
        plan = enc.plan_for(tables[did])
        rows = np.stack(sigs * replicas)
        ebuckets.append(dict(
            did=did, plan=plan, x=torch.from_numpy(rows).cuda(),
            counts=torch.full((rows.shape[0],), samples // plan.n * plan.e,
                              dtype=torch.int32, device="cuda"),
            chunk=min(DEFAULT_CHUNK_SIZE, samples // plan.n * plan.e),
        ))
    for b in ebuckets:
        p, x, counts = b["plan"], b["x"], b["counts"]
        q = p.tables.quant
        key = str((p.domain_id, p.n, p.e, p.l_max, p.coding))
        # identity basis: windows of E samples, so coefficients = samples
        wid = samples // p.e * p.e
        xi = x[:, :wid].contiguous()
        ci = torch.full_like(counts, wid)
        eye = torch.eye(p.e, device="cuda")
        id_kw = dict(n=p.e, e=p.e, coding=p.coding)
        gi = ef.encode_levels(xi, ci, q, eye, **id_kw)
        gip = ef.encode_levels_plain(xi, ci, q, eye, **id_kw)
        kw = dict(n=p.n, e=p.e, coding=p.coding)
        g = ef.encode_levels(x, counts, q, p.basis, **kw)
        gp = ef.encode_levels_plain(x, counts, q, p.basis, **kw)
        digests["encode_levels"].append({"plan_key": key,
                                         "sha256": digest(g)})
        lp = quantize.quantize(x.reshape(x.shape[0], -1, p.n) @ p.basis, q)
        lk = g[0]
        if p.coding != (0, 0, False):
            nwp = lk.shape[1]
            seg = (torch.arange(lk.shape[0] * nwp, device="cuda")
                   // nwp * nwp)
            lk = quantize.unpredict_levels(
                lk.reshape(-1, p.e), seg, p.coding[0], p.coding[1]
            ).reshape(lk.shape)
        fl = flip_stats(lk, lp)
        clean = (lk == lp).reshape(lk.shape[0], -1).all(dim=1)
        rows_equal = all(
            (a is None and c is None) or bool(torch.equal(a[clean], c[clean]))
            for a, c in zip(g, gp))
        pack_kw = dict(chunk_size=b["chunk"], coding=p.coding,
                       check_gaps=p.has_gaps)
        pk = ef.symlen_pack(*gp[:3], counts, p.tables.codes,
                            p.tables.lengths, **pack_kw)
        pkp = ef.symlen_pack_plain(*gp[:3], counts, p.tables.codes,
                                   p.tables.lengths, **pack_kw)
        torch.cuda.synchronize()
        ce = {"plan_key": key, "identity_equal": outputs_equal(gi, gip),
              "flips": fl["flips"], "cells": fl["cells"],
              "max_abs_err": fl["max_abs_err"], "flip_rule": fl["ok"],
              "clean_rows_equal": rows_equal,
              "clean_rows": int(clean.sum())}
        # exact mode (one chunk per row) on the bucket's distinct rows
        # against the host packer of each row's valid symbols
        gx = [t if t is None else t[:distinct] for t in gp[:3]]
        px = ef.symlen_pack(*gx, counts[:distinct], p.tables.codes,
                            p.tables.lengths, chunk_size=gx[0].shape[1] * p.e,
                            coding=p.coding, check_gaps=p.has_gaps)
        gxh = [t if t is None else t.cpu().numpy() for t in gx]
        vx = valid_slots(*gxh, counts[:distinct].cpu().numpy(), p.coding)
        host_rows = []
        for r in range(distinct):
            ps = symlen.pack_symlen_np(gxh[0][r].ravel()[vx[r]],
                                       tables[b["did"]].book)
            host_rows.append((ps.words, ps.symlen))
        equal = outputs_equal(pk, pkp)
        cp = {"plan_key": key, "equal": equal,
              "chunks": int(pk[3].numel()),
              "words": int(pk[3].sum()),
              "exact_rows_equal_host": exact_rows_equal(px, host_rows),
              "max_abs_err": 0.0 if equal else float("inf")}
        checks["encode_levels"].append(ce)
        checks["symlen_pack"].append(cp)
        check(ce["identity_equal"], f"encode_levels (identity) differs: {ce}")
        check(ce["flip_rule"] and rows_equal,
              f"encode_levels breaks the flip rule: {ce}")
        check(cp["equal"], f"symlen_pack differs from plain: {cp}")
        check(cp["exact_rows_equal_host"],
              f"exact-mode symlen_pack differs from pack_symlen_np: {cp}")
        del gi, gip, g, gp, lk, lp, pk, pkp, px
    # the pack on the adversarial layouts of tests/_pack_layouts.py at
    # archive shape, the archive's e by turns
    t1 = time.perf_counter()
    arch_e = sorted({k[2] for k in keys})
    for i, name in enumerate(PACK_LAYOUTS):
        e = arch_e[i % len(arch_e)]
        for chunk in PACK_CHUNKS:
            case = pack_case(name, chunk, rows=128,
                             windows=samples // keys[0][1], e=e,
                             seed=args.seed)
            rows = 128 if chunk is not None else distinct
            ins = [None if case[f] is None else torch.from_numpy(
                case[f][:rows] if f not in ("codes", "lengths") else case[f]
            ).cuda() for f in ("grid", "zrow", "zcol", "counts", "codes",
                               "lengths")]
            kw = dict(chunk_size=case["chunk"], coding=case["coding"])
            got = ef.symlen_pack(*ins, **kw)
            if chunk is None:  # Algorithm 1 of each row's valid symbols
                vx = valid_slots(*(None if a is None else a[:rows] for a in (
                    case["grid"], case["zrow"], case["zcol"])),
                    case["counts"][:rows], case["coding"])
                flat = case["grid"][:rows].reshape(rows, -1)
                equal = exact_rows_equal(got, [
                    host_pack(flat[r][vx[r]], case["codes"], case["lengths"])
                    for r in range(rows)])
            else:
                equal = outputs_equal(got, ef.symlen_pack_plain(*ins, **kw))
            cp = {"plan_key": f"adversarial {name} e={e} chunk="
                  f"{'exact' if chunk is None else chunk}", "equal": equal,
                  "words": int(got[3].sum()),
                  "max_abs_err": 0.0 if equal else float("inf")}
            checks["symlen_pack"].append(cp)
            check(equal, f"symlen_pack differs on an adversarial layout: "
                  f"{cp}")
            del ins, got
    adversarial_pack_s = time.perf_counter() - t1
    # encode_levels_gather: one bucket per plan key, its rows gathered from
    # that plan key's decoded bucket (K2's windows, flattened and padded by
    # the bucket width, as the transcoder lays them out); each row is one
    # member's run of 2**18 samples
    gbuckets = []
    for b, eb in zip(buckets, ebuckets):
        p, ep = b["plan"], eb["plan"]
        check(ep.domain_id == p.domain_id, "bucket order differs")
        win = df.decode_fused(b["words"], b["symlen"], p.tables, p.lut,
                              p.basis, b["v3"], l_max=p.l_max,
                              max_symlen=b["ms"], num_windows=b["nw"],
                              n=p.n, e=p.e, coding=p.coding)
        k = len(b["grp"].members)
        width = samples // ep.n * ep.n
        flat = torch.cat([win.reshape(-1), torch.zeros(
            width, device="cuda")])
        starts = torch.arange(k, dtype=torch.int32, device="cuda") * samples
        gbuckets.append(dict(plan=ep, flat=flat, starts=starts, width=width,
                             lens=torch.full((k,), samples,
                                             dtype=torch.int32,
                                             device="cuda"),
                             counts=eb["counts"][:k]))
        del win
    for g in gbuckets:
        p = g["plan"]
        q = p.tables.quant
        key = str((p.domain_id, p.n, p.e, p.l_max, p.coding))
        gx = (g["flat"], g["starts"], g["lens"])
        rows = ef.gather_rows(*gx, g["width"])
        kw = dict(n=p.n, e=p.e, coding=p.coding)
        gd = ef.encode_levels_gather(*gx, g["counts"], q, p.basis,
                                     width=g["width"], **kw)
        dd = ef.encode_levels(rows, g["counts"], q, p.basis, **kw)
        digests["encode_levels_gather"].append({"plan_key": key,
                                                "sha256": digest(gd)})
        # identity basis: windows of E samples, so coefficients = samples
        wid = samples // p.e * p.e
        ci = torch.full_like(g["counts"], wid)
        eye = torch.eye(p.e, device="cuda")
        id_kw = dict(n=p.e, e=p.e, coding=p.coding)
        li = torch.full_like(g["lens"], wid)
        gi = ef.encode_levels_gather(g["flat"], g["starts"], li, ci, q, eye,
                                     width=wid, **id_kw)
        di = ef.encode_levels(ef.gather_rows(g["flat"], g["starts"], li,
                                             wid), ci, q, eye, **id_kw)
        gip = ef.encode_levels_gather_plain(g["flat"], g["starts"], li, ci,
                                            q, eye, width=wid, **id_kw)
        torch.cuda.synchronize()
        cg = {"plan_key": key, "rows": int(g["starts"].numel()),
              "dct_equal": outputs_equal(gd, dd),
              "identity_equal": outputs_equal(gi, di),
              "identity_equal_plain": outputs_equal(gi, gip),
              "max_abs_err": int_err(gd[0], dd[0])}
        checks["encode_levels_gather"].append(cg)
        check(cg["dct_equal"] and cg["identity_equal"]
              and cg["identity_equal_plain"],
              f"encode_levels_gather differs from encode_levels: {cg}")
        del rows, gd, dd, gi, di, gip
    # the DCT + quantize layouts of tests/_levels_layouts.py at archive
    # width (8192 + 3 windows a row), each archive (n, e) under every
    # coding, with enough rows that every persistent CTA walks more than 4
    # tiles: identity basis exactly, DCT basis by the flip rule, the gather
    # arm equal to the dense arm on the gathered rows bit for bit
    t1 = time.perf_counter()
    for n, e in sorted({(k[1], k[2]) for k in keys}):
        for coding in LEVEL_CODINGS:
            c = levels_case(n, e, BIG, coding, rows=walk_rows(n, e, BIG),
                            seed=args.seed)
            q = quantize.quant_table_from_arrays(
                c["zone"], c["scale"], c["mu"], c["alpha1"]).to("cuda")
            x, cnt, flat, st, ln, gcnt = (
                torch.from_numpy(c[f]).cuda() for f in (
                    "signals", "counts", "flat", "starts", "lens", "gcounts"))
            kw = dict(n=n, e=e, coding=c["coding"])
            gkw = dict(width=c["width"], **kw)
            rows_g = ef.gather_rows(flat, st, ln, c["width"])
            res = {"plan_key": f"layouts n={n} e={e} wp={BIG} "
                   f"coding={c['coding']}", "rows": int(x.shape[0])}
            for name, basis in (
                    ("identity", torch.eye(n, device="cuda")[:, :e]
                     .contiguous()),
                    ("dct", dct.dct_basis(n, e, device="cuda"))):
                got = ef.encode_levels(x, cnt, q, basis, **kw)
                want = ef.encode_levels_plain(x, cnt, q, basis, **kw)
                gg = ef.encode_levels_gather(flat, st, ln, gcnt, q, basis,
                                             **gkw)
                res[f"gather_equal_dense_{name}"] = outputs_equal(
                    gg, ef.encode_levels(rows_g, gcnt, q, basis, **kw))
                if name == "identity":
                    res["identity_equal"] = outputs_equal(got, want)
                    res["gather_identity_equal_plain"] = outputs_equal(
                        gg, ef.encode_levels_gather_plain(
                            flat, st, ln, gcnt, q, basis, **gkw))
                    continue
                lvk = ef.encode_levels(x, cnt, q, basis, n=n, e=e)[0]
                fl = flip_stats(lvk, ef.encode_levels_plain(
                    x, cnt, q, basis, n=n, e=e)[0])
                clean = (lvk == ef.encode_levels_plain(
                    x, cnt, q, basis, n=n, e=e)[0]).reshape(
                        lvk.shape[0], -1).all(dim=1)
                res.update(flips=fl["flips"], cells=fl["cells"],
                           max_abs_err=fl["max_abs_err"], flip_rule=fl["ok"],
                           clean_rows_equal=all(
                               (a is None and w is None)
                               or bool(torch.equal(a[clean], w[clean]))
                               for a, w in zip(got, want)))
            torch.cuda.synchronize()
            checks["encode_levels"].append(res)
            check(all(res[k] for k in (
                "identity_equal", "gather_identity_equal_plain",
                "gather_equal_dense_identity", "gather_equal_dense_dct",
                "flip_rule", "clean_rows_equal")),
                f"encode_levels differs on a layout: {res}")
            del x, cnt, flat, st, ln, gcnt, rows_g, got, want, gg, lvk
    for n, e in ((16, 16),):  # K5: the KV block's pair, aligned and not
        c = dct_case(n, e, BIG, seed=args.seed)
        q = quantize.quant_table_from_arrays(
            c["zone"], c["scale"], c["mu"], c["alpha1"]).to("cuda")
        full = torch.from_numpy(c["windows"]).cuda()
        one = full.reshape(-1)[1:1 + BIG * n].view(BIG, n)  # 4 bytes on
        for off, x in (("aligned", full[:BIG]), ("one sample on", one)):
            eye = torch.eye(n, device="cuda")[:, :e].contiguous()
            db = dct.dct_basis(n, e, device="cuda")
            fl = flip_stats(dq.dct_quant(x, q, e=e, basis=db),
                            dq.dct_quant_plain(x, q, db))
            res = {"shape": f"layouts n={n} e={e} windows={BIG} {off}",
                   "identity_equal": bool(torch.equal(
                       dq.dct_quant(x, q, e=e, basis=eye),
                       dq.dct_quant_plain(x, q, eye))),
                   "flips": fl["flips"], "cells": fl["cells"],
                   "max_abs_err": fl["max_abs_err"], "flip_rule": fl["ok"]}
            checks["dct_quant"].append(res)
            check(res["identity_equal"] and res["flip_rule"],
                  f"K5 differs on a layout: {res}")
    levels_layouts_s = time.perf_counter() - t1
    kv_win = kv_gpu.reshape(-1, 16)
    kv_eq = kv_tab.device_tables("cuda").quant
    kv_db = enc.plan_for(kv_tab).basis
    eye16 = torch.eye(16, device="cuda")
    k5i = dq.dct_quant(kv_win, kv_eq, e=16, basis=eye16)
    k5ip = dq.dct_quant_plain(kv_win, kv_eq, eye16)
    k5 = dq.dct_quant(kv_win, kv_eq, e=16, basis=kv_db, exact=True)
    k5p = dq.dct_quant_plain(kv_win, kv_eq, kv_db)
    torch.cuda.synchronize()
    fl = flip_stats(k5, k5p)
    c5 = {"shape": list(kv_win.shape), "identity_equal":
          bool(torch.equal(k5i, k5ip)), "flips": fl["flips"],
          "cells": fl["cells"], "max_abs_err": fl["max_abs_err"],
          "flip_rule": fl["ok"],
          "levels_equal_encode_fixed": bool(torch.equal(
              k5, kv_levels.reshape(-1, 16)))}
    checks["dct_quant"].append(c5)
    digests["dct_quant"].append({"shape": list(kv_win.shape),
                                 "sha256": digest([k5])})
    check(c5["identity_equal"] and c5["flip_rule"]
          and c5["levels_equal_encode_fixed"], f"K5 differs: {c5}")
    emit({"phase": "check", "seconds": time.perf_counter() - t0,
          "adversarial_pack_seconds": adversarial_pack_s,
          "levels_layouts_seconds": levels_layouts_s,
          "symlen_layouts_seconds": symlen_layouts_s, "sha256": digests,
          "tolerance": f"max|d| <= {REL_TOL} * max|plain|; levels with the "
          f"DCT basis: |d| <= 1 in at most {FLIP_SHARE} of the cells",
          "flips": {k: sum(c.get("flips", 0) for c in checks[k])
                    for k in ("encode_levels", "dct_quant")}, **checks})
    del k1, k1p, lv, lvp, li, lip, k2, k2p, k3, k3p, k5i, k5ip, k5, k5p

    # -- 5. the main path ----------------------------------------------------------
    torch.cuda.synchronize()
    ops.reset_launches()
    up0, disp0 = dec.executor.stats.upload_s, dec.executor.stats.dispatch_s
    t0 = time.perf_counter()
    batch = dec.decode(archive, tables)
    t_decode = time.perf_counter() - t0
    out = batch.to_host()
    wall = time.perf_counter() - t0
    main_sha = host_digest(out)
    upload_s = dec.executor.stats.upload_s - up0
    dispatch_s = dec.executor.stats.dispatch_s - disp0
    t1 = time.perf_counter()
    kv_out = dec.decode_fixed(kv_levels, kv_tab, length=tokens)
    torch.cuda.synchronize()
    kv_wall = time.perf_counter() - t1
    launches = dict(ops.LAUNCHES)
    n_buckets = len(keys)
    n_v3 = sum(1 for k in keys if tuple(k[4]) != (0, 0, False))
    # K2 is symlen_decode, then v3_unpredict (v3 buckets), then lut_idct:
    # each once per bucket; K3 once for the KV block
    want = {k: 0 for k in launches}
    want.update(symlen_decode=n_buckets, v3_unpredict=n_v3,
                lut_idct=n_buckets, idct_dequant=1)
    check(launches == want, f"launch counts {launches} != expected {want}")
    # the distinct signals against the host reference decode; every replica
    # equal to its first copy; every v3 decode equal to its v2 twin
    ref, errs = {}, []
    for did, (cs, _) in pool.items():
        for i, c in enumerate(cs):
            ref[(did, i)] = decode(c, tables[did])
    first = {}
    for o, key in zip(out, source):
        check(o.shape == ref[key].shape and bool(np.isfinite(o).all()),
              f"bad output for {key}: shape {o.shape}")
        if key not in first:
            first[key] = o
            r = ref[key]
            err = float(np.abs(o - r).max()) / max(float(np.abs(r).max()), 1e-30)
            errs.append(err)
            check(err <= REL_TOL, f"signal {key} vs host decode: rel {err}")
        else:
            check(np.array_equal(o, first[key]), f"replica of {key} differs")
    v3_same = all(np.array_equal(first[(d, i)], first[(d + 4, i)])
                  for d in range(4) for i in range(distinct))
    check(v3_same, "a v3 decode differs from its v2 twin")
    kv_rel = float(torch.linalg.vector_norm(kv_out - kv_gpu)
                   / torch.linalg.vector_norm(kv_gpu))
    check(bool(torch.isfinite(kv_out).all()) and kv_rel < 0.05,
          f"KV fixed-rate reconstruction off: relative rms {kv_rel}")
    warm = []
    for _ in range(2):  # the same decode again: plans cached, allocator warm
        t0 = time.perf_counter()
        dec.decode(archive, tables).to_host()
        warm.append(time.perf_counter() - t0)
    emit({"phase": "main", "containers": len(archive), "buckets": n_buckets,
          "wall_s": wall, "decode_call_s": t_decode,
          "to_host_s": wall - t_decode, "upload_s": upload_s,
          "dispatch_s": dispatch_s, "warm_wall_s": warm,
          "containers_per_s": len(archive) / wall,
          "decoded_GB_per_s": 4 * n_out / wall / 1e9,
          "kv_decode_fixed_s": kv_wall, "kv_rel_rms_err": kv_rel,
          "launches": launches, "max_rel_err_vs_host": max(errs),
          "v3_equals_v2": v3_same, "sha256": main_sha})

    # -- 6. the encode path ------------------------------------------------------
    # the archive's 1024 signals (the replicas of the 32 distinct ones, in
    # the archive's order) through the chunked engine, then decoded
    signals = [pool[did][1][i] for did, i in source]
    doms = [did for did, _ in source]
    n_in = sum(x.size for x in signals)
    # which windows the card quantizes one level away from the host encoder
    # (K5 runs the same DCT + quantize arithmetic as encode_levels)
    flipped, eflips = {}, []
    for did, (cs, sigs) in pool.items():
        p = enc.plan_for(tables[did])
        for i, sig in enumerate(sigs):
            win = dct.window_signal(torch.from_numpy(sig.copy()), p.n)
            host_lv = quantize.quantize(dct.forward_dct(win, p.e),
                                        tables[did].quant)
            card_lv = dq.dct_quant(win.cuda(), p.tables.quant, e=p.e,
                                   basis=p.basis).cpu()
            fl = flip_stats(card_lv, host_lv)
            eflips.append(fl["flips"])
            check(fl["max_abs_err"] <= 1, f"encode levels of {(did, i)} "
                  f"differ by more than one: {fl}")
            flipped[(did, i)] = np.repeat(
                (card_lv != host_lv).any(dim=1).numpy(), p.n)[:sig.size]
    torch.cuda.synchronize()
    ops.reset_launches()
    up0, disp0 = enc.executor.stats.upload_s, enc.executor.stats.dispatch_s
    t0 = time.perf_counter()
    ebatch = enc.encode(signals, tables, domain_ids=doms)
    t_encode = time.perf_counter() - t0
    econt = ebatch.to_host()
    ewall = time.perf_counter() - t0
    enc_sha = host_digest(econt)
    e_upload = enc.executor.stats.upload_s - up0
    e_dispatch = enc.executor.stats.dispatch_s - disp0
    t1 = time.perf_counter()
    kv_again = enc.encode_fixed(kv_gpu, kv_tab)
    torch.cuda.synchronize()
    kv_enc_wall = time.perf_counter() - t1
    elaunches = dict(ops.LAUNCHES)
    ewant = {k: 0 for k in elaunches}
    ewant.update(encode_levels=n_buckets, symlen_pack=n_buckets, dct_quant=1)
    check(elaunches == ewant,
          f"encode launch counts {elaunches} != expected {ewant}")
    check(bool(torch.equal(kv_again, kv_levels)),
          "encode_fixed is not deterministic on the KV block")
    del ebatch
    # every replica's container equal to its first copy; every signal
    # decodes like its host-encoded twin wherever no level flipped
    out_e = dec.decode(econt, tables).to_host()
    first_c, eerrs = {}, []
    for c, o, key in zip(econt, out_e, source):
        check(c.signal_length == samples and o.shape == ref[key].shape
              and bool(np.isfinite(o).all()), f"bad encode output for {key}")
        if key not in first_c:
            first_c[key] = c
            keep = ~flipped[key]
            r = ref[key]
            err = float(np.abs(o[keep] - r[keep]).max(initial=0.0)) / max(
                float(np.abs(r).max()), 1e-30)
            eerrs.append(err)
            check(err <= REL_TOL, f"encoded {key} decodes off: rel {err}")
        else:
            f = first_c[key]
            check(np.array_equal(c.words, f.words)
                  and np.array_equal(c.symlen, f.symlen),
                  f"replica of {key} encodes differently")
    ebytes = sum(c.compressed_bytes for c in econt)
    # exact mode on the 32 distinct signals: the host encoder's bytes
    ex = BatchEncoder(chunk_size=None)
    keys32 = list(ref)
    t0 = time.perf_counter()
    exc = ex.encode([pool[d][1][i] for d, i in keys32], tables,
                    domain_ids=[d for d, _ in keys32]).to_host()
    exact_wall = time.perf_counter() - t0
    n_equal = n_flip = 0
    for (d, i), c in zip(keys32, exc):
        same = c.to_bytes() == pool[d][0][i].to_bytes()
        has_flip = bool(flipped[(d, i)].any())
        n_equal += same
        n_flip += has_flip
        check(same or has_flip, f"exact encode of {(d, i)} differs from "
              "the host encoder without a flipped level")
    ex.close()
    warm_e = []
    for _ in range(1):  # the same encode again: plans cached, allocator warm
        t0 = time.perf_counter()
        enc.encode(signals, tables, domain_ids=doms).to_host()
        warm_e.append(time.perf_counter() - t0)
    emit({"phase": "encode", "signals": len(signals), "buckets": n_buckets,
          "bytes_in": 4 * n_in, "wall_s": ewall, "encode_call_s": t_encode,
          "to_host_s": ewall - t_encode, "upload_s": e_upload,
          "dispatch_s": e_dispatch, "warm_wall_s": warm_e,
          "encoded_GB_per_s": 4 * n_in / ewall / 1e9,
          "containers_per_s": len(signals) / ewall,
          "compressed_bytes": ebytes,
          "kv_encode_fixed_s": kv_enc_wall, "launches": elaunches,
          "level_flips_32_signals": sum(eflips),
          "max_rel_err_vs_host_unflipped": max(eerrs),
          "exact_mode": {"signals": len(keys32), "wall_s": exact_wall,
                         "bytes_equal_host": n_equal,
                         "with_flips": n_flip}, "sha256": enc_sha})

    # -- 7. the staged decode: K6's path ---------------------------------------------
    # K6 serves no path of the engines: its path is the staged decode (tile,
    # then compaction) that holds K1 independently, driven bucket by bucket
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    staged = []
    for b in buckets:
        p = b["plan"]
        tile = hd.huffman_decode_tile(b["words"], p.tables, l_max=p.l_max,
                                      max_symlen=b["ms"])
        staged.append(symlen.compact_padded_scatter(
            tile.T, b["symlen"], b["nw"] * p.e).to(torch.uint8))
        del tile
    torch.cuda.synchronize()
    staged_s = time.perf_counter() - t0
    slaunches = dict(ops.LAUNCHES)
    swant = {k: 0 for k in slaunches}
    swant["symlen_tile"] = n_buckets
    check(slaunches == swant,
          f"staged launch counts {slaunches} != expected {swant}")
    for b, dense in zip(buckets, staged):
        p = b["plan"]
        k1 = hd.huffman_decode_dense(b["words"], b["symlen"], p.tables,
                                     l_max=p.l_max, max_symlen=b["ms"],
                                     num_symbols=b["nw"] * p.e)
        check(bool(torch.equal(dense, k1)),
              f"staged decode of {b['grp'].plan_key} differs from K1")
    del staged, k1
    emit({"phase": "staged", "buckets": n_buckets, "seconds": staged_s,
          "launches": slaunches, "equals_k1": True})

    # -- 8. the transcode path ---------------------------------------------------------
    # every container to its twin coding: id d <-> d + 4 (v2 -> v3 and
    # v3 -> v2 in one batch); the engines of the phases above, plans warm
    nd = len(ARCHIVAL)
    twin = [d + nd if d < nd else d - nd for d in doms]
    tc = Transcoder(decoder=dec, encoder=enc)
    rt_walls = []
    for _ in range(2):  # the round trip through the host, first and warm
        t0 = time.perf_counter()
        want_tc = enc.encode(dec.decode(archive, tables).to_host(), tables,
                             domain_ids=twin).to_host()
        rt_walls.append(time.perf_counter() - t0)
    tc_calls, tc_walls = [], []
    for rep_i in range(2):  # the transcode, first call and warm
        torch.cuda.synchronize()
        ops.reset_launches()
        d0 = enc.stats.dispatches
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tbatch = tc.transcode(archive, tables, tables,
                                  dst_domain_ids=twin)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        tc_calls.append(time.perf_counter() - t0)
        tout = tbatch.to_host()
        tc_walls.append(time.perf_counter() - t0)
        if rep_i == 0:
            tlaunches = dict(ops.LAUNCHES)
            t_buckets = enc.stats.dispatches - d0
            tc_sha = host_digest(tout)
        del tbatch
        same = sum(a.to_bytes() == b.to_bytes()
                   for a, b in zip(tout, want_tc))
        check(same == len(archive), f"transcode differs from the round trip "
              f"in {len(archive) - same} of {len(archive)} containers")
    twant = {k: 0 for k in tlaunches}
    twant.update(symlen_decode=n_buckets, lut_idct=n_buckets,
                 v3_unpredict=n_v3, encode_levels_gather=t_buckets,
                 symlen_pack=t_buckets)
    check(t_buckets == n_buckets and tlaunches == twant,
          f"transcode launch counts {tlaunches} != expected {twant}")
    tc_bytes = sum(c.compressed_bytes for c in tout)
    del tout, want_tc
    # an EncodedBatch source: the 512 v2 signals encoded on the card and
    # transcoded to v3 without a drain, against draining and transcoding
    v2_idx = [i for i, d in enumerate(doms) if d < nd]
    v2_sigs = [signals[i] for i in v2_idx]
    v2_doms = [doms[i] for i in v2_idx]
    v3_doms = [d + nd for d in v2_doms]
    src_batch = enc.encode(v2_sigs, tables, domain_ids=v2_doms)
    drained = enc.encode(v2_sigs, tables, domain_ids=v2_doms).to_host()
    t0 = time.perf_counter()
    from_batch = tc.transcode(src_batch, tables, tables,
                              dst_domain_ids=v3_doms).to_host()
    eb_wall = time.perf_counter() - t0
    from_host = tc.transcode(drained, tables, tables,
                             dst_domain_ids=v3_doms).to_host()
    check([c.to_bytes() for c in from_batch]
          == [c.to_bytes() for c in from_host],
          "EncodedBatch-source transcode differs from the drained one")
    try:
        src_batch.to_host()
        fail("a consumed EncodedBatch source drained")
    except RuntimeError as err:
        check("donated" in str(err), f"unexpected error: {err}")
    del from_batch, from_host, drained
    # codec.transcode of one container (exact mode) against the host round
    # trip under the target tables: bytes equal where no level flipped
    c_one = pool[0][0][0]
    t0 = time.perf_counter()
    got_one = codec.transcode(c_one, tables[0], tables[nd])
    one_wall = time.perf_counter() - t0
    host_one = encode(decode(c_one, tables[0]), tables[nd])
    lv_card = torch.from_numpy(container_levels(got_one, tables[nd]))
    lv_host = torch.from_numpy(container_levels(host_one, tables[nd]))
    one = flip_stats(lv_card, lv_host)
    one["bytes_equal"] = got_one.to_bytes() == host_one.to_bytes()
    check(one["bytes_equal"] or one["flips"] > 0,
          f"codec.transcode differs from the host round trip without a "
          f"flipped level: {one}")
    check(one["ok"], f"codec.transcode breaks the flip rule: {one}")
    if not one["bytes_equal"]:  # equal samples outside the flipped windows
        keep = np.repeat(~(lv_card != lv_host).any(dim=1).numpy(), c_one.n)[
            :c_one.signal_length]
        a = decode(got_one, tables[nd])
        b_ = decode(host_one, tables[nd])
        check(np.array_equal(a[keep], b_[keep]),
              "codec.transcode decodes differently outside flipped windows")
    emit({"phase": "transcode", "containers": len(archive),
          "bytes_in": 4 * n_out, "buckets": n_buckets,
          "transcode_call_s": tc_calls, "wall_s": tc_walls,
          "to_host_s": [w - c for w, c in zip(tc_walls, tc_calls)],
          "round_trip_wall_s": rt_walls,
          "what": "first call, then warm; transcode() under "
          "torch.cuda.set_sync_debug_mode('error'); the round trip is "
          "BatchEncoder().encode(BatchDecoder().decode(archive).to_host())"
          ".to_host() on the card",
          "bytes_equal_round_trip": len(archive),
          "compressed_bytes": tc_bytes, "launches": tlaunches,
          "sha256": tc_sha,
          "encoded_batch_source": {"signals": len(v2_sigs),
                                   "wall_s": eb_wall, "bytes_equal": True,
                                   "source_consumed": True},
          "codec_transcode": {"wall_s": one_wall, **one,
                              "rule": f"|d| <= 1 in at most {FLIP_SHARE} "
                              "of the cells"}})

    # -- 9. workloads ----------------------------------------------------------------
    emit(workloads_phase(smi, kv_gpu, enc, args.seed))

    # -- 10. serve --------------------------------------------------------------------
    emit(serve_phase(smi))

    # -- 11. times ------------------------------------------------------------------
    # first, the CUDA kernels one wrapper call of each kernel puts on the
    # card, on the first bucket that runs it, the profiler sessions one
    # after another (K3's session, placed after the timing loops below,
    # saw no kernel on the H100, though K3 alone in a process is seen)
    b0, bv = buckets[0], next(b for b in buckets if b["v3"] is not None)
    p0, pv = b0["plan"], bv["plan"]
    kw0 = dict(l_max=p0.l_max, max_symlen=b0["ms"])
    a0 = (b0["words"], b0["symlen"], p0.tables)
    dense_v = hd.huffman_decode_dense(
        bv["words"], bv["symlen"], pv.tables, num_symbols=bv["nw"] * pv.e,
        l_max=pv.l_max, max_symlen=bv["ms"])
    levels0 = df.bucket_levels(*a0, b0["v3"], num_windows=b0["nw"], e=p0.e,
                               coding=p0.coding, **kw0)
    eb, gb = ebuckets[0], gbuckets[0]
    pe, pg = eb["plan"], gb["plan"]
    ekw = dict(n=pe.n, e=pe.e, coding=pe.coding)
    g0 = ef.encode_levels(eb["x"], eb["counts"], pe.tables.quant, pe.basis,
                          **ekw)
    grids = {name: grids_per_call(name, fn) for name, fn in (
        ("symlen_decode", lambda: hd.huffman_decode_dense(
            *a0, num_symbols=b0["nw"] * p0.e, **kw0)),
        ("symlen_tile", lambda: hd.huffman_decode_tile(
            b0["words"], p0.tables, **kw0)),
        ("v3_unpredict", lambda: df.v3_expand_unpredict_cuda(
            dense_v, *bv["v3"], num_windows=bv["nw"], e=pv.e,
            pred_id=pv.coding[0], bands=pv.coding[1])),
        ("lut_idct", lambda: df.lut_idct(levels0, p0.lut, p0.basis)),
        ("idct_dequant", lambda: idq.idct_dequant(kv_flat, kv_q, kv_basis)),
        ("encode_levels", lambda: ef.encode_levels(
            eb["x"], eb["counts"], pe.tables.quant, pe.basis, **ekw)),
        ("symlen_pack", lambda: ef.symlen_pack(
            *g0[:3], eb["counts"], pe.tables.codes, pe.tables.lengths,
            chunk_size=eb["chunk"], coding=pe.coding,
            check_gaps=pe.has_gaps)),
        ("encode_levels_gather", lambda: ef.encode_levels_gather(
            gb["flat"], gb["starts"], gb["lens"], gb["counts"],
            pg.tables.quant, pg.basis, width=gb["width"], n=pg.n, e=pg.e,
            coding=pg.coding)),
        ("dct_quant", lambda: dq.dct_quant(kv_win, kv_eq, e=16, basis=kv_db,
                                           exact=True)),
    )}
    del dense_v, levels0, g0
    # per kernel: [ms, plain ms, bytes moved, operations], summed over the
    # buckets; K2 as a whole (its three kernels in a row) beside them, and
    # K4 as a whole (encode_levels then symlen_pack)
    acc = {k: [0.0, 0.0, 0.0, 0.0] for k in
           ("symlen_decode", "v3_unpredict", "lut_idct", "decode_fused",
            "symlen_tile", "encode_levels", "encode_levels_gather",
            "symlen_pack", "encode_fused")}

    def add(name, ms, plain_ms, nbytes, ops_):
        for i, v in enumerate((ms, plain_ms, nbytes, ops_)):
            acc[name][i] += v

    for b in buckets:
        p, kw = b["plan"], dict(l_max=b["plan"].l_max, max_symlen=b["ms"])
        nsym, nw, w = b["nw"] * p.e, b["nw"], b["words"].shape[0]
        f_kw = dict(n=p.n, num_windows=nw, e=p.e, coding=p.coding, **kw)
        args1 = (b["words"], b["symlen"], p.tables)
        add("symlen_decode",
            cuda_ms(lambda: hd.huffman_decode_dense(
                *args1, num_symbols=nsym, **kw)),
            cuda_ms(lambda: hd.huffman_decode_plain(
                *args1, num_symbols=nsym, **kw), reps=2),
            9 * w + nsym, 0.0)
        # K6: each word read once, every slot of the tile written once
        add("symlen_tile",
            cuda_ms(lambda: hd.huffman_decode_tile(
                b["words"], p.tables, **kw)),
            cuda_ms(lambda: hd.huffman_decode_tile_plain(
                b["words"], p.tables, **kw), reps=2),
            8 * w + 4 * b["ms"] * w, 0.0)
        dense = hd.huffman_decode_dense(*args1, num_symbols=nsym, **kw)
        if b["v3"] is not None:
            v3_kw = dict(num_windows=nw, e=p.e, pred_id=p.coding[0],
                         bands=p.coding[1])
            add("v3_unpredict",
                cuda_ms(lambda: df.v3_expand_unpredict_cuda(
                    dense, *b["v3"], **v3_kw)),
                cuda_ms(lambda: df.v3_expand_unpredict_plain(
                    dense, *b["v3"], **v3_kw), reps=2),
                nsym + 4 * nsym + 4 * nw + nsym, 0.0)
        levels = df.bucket_levels(*args1, b["v3"], num_windows=nw, e=p.e,
                                  coding=p.coding, **kw)
        lut_bytes = nsym + 4 * p.e * 256 + 4 * p.e * p.n + 4 * nw * p.n
        add("lut_idct",
            cuda_ms(lambda: df.lut_idct(levels, p.lut, p.basis)),
            cuda_ms(lambda: df.lut_idct_plain(levels, p.lut, p.basis)),
            lut_bytes, 2.0 * nw * p.e * p.n)
        args2 = (*args1, p.lut, p.basis, b["v3"])
        v3_bytes = 4 * (nsym + nw) if b["v3"] is not None else 0
        add("decode_fused",
            cuda_ms(lambda: df.decode_fused(*args2, **f_kw)),
            cuda_ms(lambda: df.decode_fused_plain(*args2, **f_kw), reps=2),
            9 * w + v3_bytes + lut_bytes - nsym, 2.0 * nw * p.e * p.n)
    rows = kv_flat.shape[0]
    acc["idct_dequant"] = [
        cuda_ms(lambda: idq.idct_dequant(kv_flat, kv_q, kv_basis)),
        cuda_ms(lambda: idq.idct_dequant_plain(kv_flat, kv_q, kv_basis)),
        rows * 16 + 4 * 16 * 16 + 8 * 16 + 4 * rows * 16,
        2.0 * rows * 16 * 16,
    ]
    # the encode buckets: bytes each input read once and each output
    # written once; K4 as a whole counts the signal in and the parts out
    exact_ms = 0.0
    pack_by_bucket = []
    for b in ebuckets:
        p, x, counts = b["plan"], b["x"], b["counts"]
        k, wp = x.shape[0], x.shape[1] // p.n
        q, codes, lens = p.tables.quant, p.tables.codes, p.tables.lengths
        kw = dict(n=p.n, e=p.e, coding=p.coding)
        pack_kw = dict(chunk_size=b["chunk"], coding=p.coding,
                       check_gaps=p.has_gaps)
        v3 = p.coding != (0, 0, False)
        masks = (k * wp + k * p.e) if p.coding[2] else 0
        sig_b, grid_b = 4 * x.numel(), k * wp * p.e
        slots = k * (-(-wp * p.e // b["chunk"])) * b["chunk"]
        parts_b = 12 * slots + 4 * slots // b["chunk"] + k
        small_b = 4 * p.n * p.e + 8 * p.e + 8 + 4 * k + 4 * k * v3
        fma = 2.0 * k * wp * p.n * p.e
        lv_ms = cuda_ms(lambda: ef.encode_levels(x, counts, q, p.basis, **kw))
        lv_b = sig_b + grid_b + masks + small_b
        add("encode_levels", lv_ms,
            cuda_ms(lambda: ef.encode_levels_plain(x, counts, q, p.basis,
                                                   **kw), reps=2),
            lv_b, fma)
        g = ef.encode_levels(x, counts, q, p.basis, **kw)
        pack_b = grid_b + masks + 4 * k + 12 * 256 + parts_b
        pack_ms = cuda_ms(lambda: ef.symlen_pack(*g[:3], counts, codes, lens,
                                                 **pack_kw))
        add("symlen_pack", pack_ms,
            cuda_ms(lambda: ef.symlen_pack_plain(*g[:3], counts, codes, lens,
                                                 **pack_kw), reps=1),
            pack_b, 0.0)
        fused_kw = dict(chunk_size=b["chunk"], check_gaps=p.has_gaps, **kw)
        add("encode_fused",
            cuda_ms(lambda: ef.encode_fused(x, counts, p.tables, p.basis,
                                            **fused_kw)),
            cuda_ms(lambda: ef.encode_fused_plain(x, counts, p.tables,
                                                  p.basis, **fused_kw),
                    reps=1),
            sig_b + small_b + 12 * 256 + parts_b + masks, fma)
        # exact mode (one chunk per row) on the exact run's 4-row bucket
        g4 = [t if t is None else t[:distinct] for t in g]
        ex_ms = cuda_ms(lambda: ef.symlen_pack(
            *g4[:3], counts[:distinct], codes, lens,
            chunk_size=wp * p.e, coding=p.coding, check_gaps=p.has_gaps),
            reps=2)
        exact_ms += ex_ms
        ex_b = distinct * (wp * p.e * 13 + 4 + 1) + 12 * 256 + (
            (distinct * wp + distinct * p.e) if p.coding[2] else 0)
        pack_by_bucket.append({
            "plan_key": str((p.domain_id, p.n, p.e, p.l_max, p.coding)),
            "e": p.e, "levels_ms": lv_ms,
            "levels_bound_ms": bound_ms(lv_b, fma)[0],
            "chunks": slots // b["chunk"], "ms": pack_ms,
            "bound_ms": bound_ms(pack_b, 0.0)[0], "exact_rows": distinct,
            "exact_ms": ex_ms, "exact_bound_ms": bound_ms(ex_b, 0.0)[0]})
        del g, g4
    # encode_levels_gather on the gather buckets of the check phase: the
    # live samples of each row read once (the pad is never read), starts
    # and lens, counts and tables, the grid and masks written once
    for g in gbuckets:
        p = g["plan"]
        k, wp = int(g["starts"].numel()), g["width"] // p.n
        gx = (g["flat"], g["starts"], g["lens"])
        kw = dict(width=g["width"], n=p.n, e=p.e, coding=p.coding)
        masks = (k * wp + k * p.e) if p.coding[2] else 0
        v3 = p.coding != (0, 0, False)
        small_b = 4 * p.n * p.e + 8 * p.e + 8 + 4 * k + 4 * k * v3
        add("encode_levels_gather",
            cuda_ms(lambda: ef.encode_levels_gather(
                *gx, g["counts"], p.tables.quant, p.basis, **kw)),
            cuda_ms(lambda: ef.encode_levels_gather_plain(
                *gx, g["counts"], p.tables.quant, p.basis, **kw), reps=2),
            4 * k * samples + 8 * k + small_b + k * wp * p.e + masks,
            2.0 * k * wp * p.n * p.e)
    del gbuckets
    kv_rows = kv_win.shape[0]
    acc["dct_quant"] = [
        cuda_ms(lambda: dq.dct_quant(kv_win, kv_eq, e=16, basis=kv_db,
                                     exact=True)),
        cuda_ms(lambda: dq.dct_quant_plain(kv_win, kv_eq, kv_db)),
        4 * kv_rows * 16 + kv_rows * 16 + 4 * 16 * 16 + 8 * 16 + 8,
        2.0 * kv_rows * 16 * 16,
    ]
    times = {k: (ms, plain, *bound_ms(nb, fl))
             for k, (ms, plain, nb, fl) in acc.items()}
    emit({"phase": "times", "what": "ms summed over the 8 archive buckets "
          "(v3_unpredict over the 4 v3 buckets; symlen_tile at each "
          "bucket's K1 slot count; the encode kernels over the 8 encode "
          "buckets of 128 rows, encode_levels_gather gathering them from "
          "the decoded buckets) and for the KV block "
          "(idct_dequant, dct_quant); CUDA events, mean of repeats after a "
          "warm-up; decode_fused is K2 as a whole: symlen_decode, "
          "v3_unpredict and lut_idct in a row; encode_fused is K4 as a "
          "whole: encode_levels then symlen_pack",
          "symlen_pack_exact_ms": exact_ms,
          "symlen_pack_exact_what": "exact mode (chunk = the row's symbols), "
          f"{distinct} rows per plan key, summed over the 8 keys",
          "k4_by_bucket": pack_by_bucket,
          "k4_by_bucket_what": "per encode bucket: encode_levels "
          "(levels_ms, levels_bound_ms) and symlen_pack (ms, bound_ms; "
          "exact_ms, exact_bound_ms in exact mode)",
          **{k: {"ms": v[0], "plain_ms": v[1], "bound_ms": v[2],
                 "bound_by": v[3]} for k, v in times.items()}})

    # -- 12. tune ----------------------------------------------------------------------
    if src == os.path.join(HERE, "src"):
        emit(tune_phase(
            tables, archive, signals, doms, twin, buckets, ebuckets, dec,
            enc, {"main": (main_sha, launches), "encode": (enc_sha, elaunches),
                  "transcode": (tc_sha, tlaunches)}))
    else:  # another checkout's port may predate the tuning cache
        emit({"phase": "tune", "skipped": "--src drives another checkout"})

    # -- 13. lm ---------------------------------------------------------------------
    lm = None
    if os.path.isdir(os.path.join(src, "repro_torch", "models")):
        lm = lm_phase(smi, args.seed)
        emit(lm)
    else:  # another checkout's port may predate the LM stack
        emit({"phase": "lm", "skipped": "the port has no repro_torch.models"})

    # -- 14. train ------------------------------------------------------------------
    train = None
    if os.path.isfile(os.path.join(src, "repro_torch", "distributed",
                                   "optimizer.py")):
        train = train_phase(smi, args.seed)
        emit(train)
    else:  # another checkout's port may predate the training slice
        emit({"phase": "train",
              "skipped": "the port has no repro_torch.distributed.optimizer"})

    # -- 15. families -----------------------------------------------------------
    families = None
    if os.path.isfile(os.path.join(src, "repro_torch", "models", "ssm.py")):
        families = families_phase(smi, args.seed)
        emit(families)
    else:  # another checkout's port may predate the MoE, MLA and hybrid
        emit({"phase": "families",
              "skipped": "the port has no repro_torch.models.ssm"})

    # -- 16. families_train -----------------------------------------------------
    ftrain = None
    if port_trains("whisper-tiny"):
        ftrain = families_train_phase(smi, args.seed)
        emit(ftrain)
    else:  # another checkout's port may not train these families yet
        emit({"phase": "families_train", "skipped": "the port's launch."
              "train does not train whisper-tiny"})

    # -- 17. scan_train ---------------------------------------------------------
    strain = None
    if all(port_trains(arch) for arch, _, _, _ in ST_RUNS):
        strain = scan_train_phase(smi, args.seed)
        emit(strain)
    else:  # another checkout's port may not train these families yet
        emit({"phase": "scan_train", "skipped": "the port's launch.train "
              "does not train " + " and ".join(a for a, _, _, _ in ST_RUNS)})

    # -- 18. mesh_train -----------------------------------------------------------
    mtrain = None
    if os.path.isfile(os.path.join(src, "repro_torch", "launch", "mesh.py")):
        mtrain = mesh_train_phase(smi, args.seed, src,
                                  [(a["loss"], a["grad_norm"])
                                   for a in train["run_a"]])
        emit(mtrain)
    else:  # another checkout's port may predate the multi-device layer
        emit({"phase": "mesh_train",
              "skipped": "the port has no repro_torch.launch.mesh"})

    # -- the kernels line, and the last line -------------------------------------
    counts_of = {"main": launches, "encode": elaunches,
                 "transcode": tlaunches, "staged": slaunches}
    lm_held = {"dct_quant": "k5_vs_plain", "idct_dequant": "k3_vs_plain"}
    kernels = []
    for name, (srcfile, replaces) in SOURCES.items():
        ms, plain, bnd, by = times[name]
        entry = {
            "name": name, "route": "cuda", "source": srcfile,
            "replaces": replaces, "launches": counts_of[PATH_OF[name]][name],
            "grids_per_call": grids[name],
            "max_abs_err": max(c["max_abs_err"] for c in checks[name]),
            "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": None,
        }
        if lm is not None and name in lm_held:  # the LM path's KV cache
            entry["lm_launches"] = lm["kv"]["launches"][name]
            entry["lm_max_abs_err"] = lm["kv"][lm_held[name]]["max_abs_err"]
        if families is not None and name in lm_held:  # the families' caches
            entry["families_launches"] = families["launches"][name]
            entry["families_max_abs_err"] = families["max_abs_err"][name]
        if train is not None and name in CKPT_KERNELS:  # train checkpoint
            held = train["resume"]["kernels"][name]
            entry["train_launches"] = held["launches"]
            entry["train_max_abs_err"] = held["max_abs_err"]
        if ftrain is not None and name in CKPT_KERNELS:  # phase 16's
            entry["families_train_launches"] = ftrain["launches"][name]
            entry["families_train_max_abs_err"] = ftrain["max_abs_err"][name]
        if strain is not None and name in CKPT_KERNELS:  # phase 17's
            entry["scan_train_launches"] = strain["launches"][name]
            entry["scan_train_max_abs_err"] = strain["max_abs_err"][name]
        if mtrain is not None and name in CKPT_KERNELS:  # phase 18's
            entry["mesh_train_launches"] = mtrain["launches"][name]
            entry["mesh_train_max_abs_err"] = mtrain["max_abs_err"][name]
        kernels.append(entry)
    tc.close()
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
