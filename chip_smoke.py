#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and check it end to end.

    python3 chip_smoke.py

Phases (every failure raises and exits nonzero):
  1. device  -- the card's name, and its name and power limit from
                nvidia-smi;
  2. build   -- compile the CUDA kernels (frontier relax, flash attention
                on the CUDA cores, on the tensor cores in bf16 (wgmma) and
                in f32 as 3xTF32 (`flash_attention_tf32.cu`, mma.sync), its
                backward on the CUDA cores (`flash_attention_bwd.cu`), on
                the tensor cores (`flash_attention_bwd_wgmma.cu`) and in
                3xTF32 (`flash_attention_bwd_tf32.cu`), SSD intra-chunk and
                its backward (`ssd_intra_bwd.cu`, 3xTF32 wgmma and
                mma.sync))
                from the sources in this checkout, one nvcc each, all at
                once (sm_90a); log ptxas registers, spills and warnings,
                and fail if the tensor-core attention kernels (forward and
                backward) or any function of the SSD kernel or of its
                backward spill, if
                either tensor-core attention source's wgmma is serialized
                (C7510) or its setmaxnreg ignored (C7508), if the SASS of
                the SSD kernel or of the wgmma backward waits after every
                wgmma (fewer waits than half the HGMMA count, per
                function; the SSD backward's too), if `bwd_dkdv` or
                `bwd_dq` has no HGMMA, if `ssd_bwd_dxw` has no HGMMA, or
                if `ssd_bwd_dx` or `ssd_bwd_dcdb` has no HMMA; and if
                either 3xTF32 attention source spills or any of its
                functions (`fwd_tf32`, `bwd_dkdv`, `bwd_dq`) at any head
                dim has no HMMA (they issue no wgmma for ptxas to
                serialize);
  3. kernel  -- hold the kernel against its plain PyTorch version,
                `frontier_relax_torch`, on the card: 4 semirings x dense /
                frontier-masked / empty states x B in {1, 8} x d in {1, 8},
                min_plus, max_min and or_and at the tuner's tiles 64 and
                256 (dense and masked, B in {1, 8}, d in {1, 8}; T=256
                with d=8 needs 64 KiB of shared memory, past the default),
                a destination tile with no block, a ragged vertex count,
                and full-size states of the main path's graph; NaN in a
                weight block, a source lane and a carry lane for min_plus,
                max_min and or_and at B in {1, 8}. min_plus, max_min and
                or_and must be bit-equal, NaN positions included; plus_times
                within atol 1e-5 (summation order differs). B=11 and
                d=12 (two query chunks, two feature slabs). At a Kronecker
                graph's shape (512 destination tiles of 502 blocks, 16.8
                GB at T=128: the kernel's deep plan, its ring and split
                segments) every semiring dense / frontier-masked / empty
                (min_plus also at B=1 and d=8; plus_times on PageRank-
                sized masses), a rank's slab of it, T=64 and T=256 deep
                layouts, two launches bit-identical. Times the kernel and
                the plain version at the main path's shapes, and the
                kernel at the Kronecker shape with its bytes a second,
                and computes the card's bound for the same work. Phase 2
                logs K1's registers, stack and spills per instantiation
                (cuobjdump) and its SASS counts, the SASS itself in
                chiprun_out/k1.sass;
  4. main path -- a 262,144-vertex road network (the repo's generator at
                the Ext. LRN setting) through `flip_torch.compile(...)
                .query(...)` with the default plan and device: sssp over 8
                sources, bfs, and bfs with mode="op". Each result passes
                `QueryResult.check()` against the numpy oracles, and the
                kernel's launch count follows the device loop's replay
                accounting (below);
                then sssp and bfs once more under torch.profiler: device
                time by kernel against the query's wall;
  5. programs -- pagerank, wcc, widest, reach, multi_bfs and labelprop on
                the 16,384-vertex Ext. LRN graph, each checked the same way;
  6. attention kernel -- flash attention against `attention_ref` on the
                card: causal x window {None, 128} x GQA ratio {1, 2, 8} x
                {f32 at hd 16, 64, 80, 128, 256; bf16 at hd 64, 80, 128,
                256}, ragged lengths (S=200 and S=5, shorter than one
                tile; in f32 also S != T both ways), and at B=1, S=4096 the
                layer of every architecture with attention: qwen3-0.6b
                (GQA 2, hd 128), granite-moe-3b-a800m (GQA 3, hd 64),
                hubert-xlarge (MHA, hd 80, non-causal), phi3-medium-14b
                (GQA 4), qwen3-moe-235b-a22b (GQA 16), gemma3-12b (hd 256,
                window 1,024) and chameleon-34b (GQA 8) (f32 atol 2e-5,
                bf16 atol 2e-2 against the f32 reference, and at those
                layers also a relative Frobenius error of 1e-2); each case
                logs its route ("tf32x3": f32 at every hd, 3xTF32 on the
                tensor cores; "wgmma": bf16 at hd 64/80/128/256 on the
                tensor cores, hd 80 in the hd-128 tile; "fma": the CUDA
                cores) and must have taken `flash.route`'s; each tf32x3
                case must give the same bits on a second call, and the fma
                kernel runs on the same inputs, held at the same atol and
                its error logged beside. Timed at the
                prefill shape: the wgmma kernel beside the CUDA-core kernel
                at the same shape, the plain version and SDPA (yardstick
                only); and the same at hubert's bf16 (4, 4,096, 16, 80)
                non-causal, beside the bound at hd 80 and the padded
                tile's floor;
  7. SSD kernel -- logs the kernel's route (3xTF32 tensor-core products,
                the head group sharing one G panel); holds the
                intra-chunk kernel against `ssd_intra_ref` (and
                `ssd_cuda` against `ssd_ref`) at the reference tests'
                shapes (chunk 16), a ragged chunk (100), N=20 / P=12 /
                chunk 72 (no multiple of 8, 16 or 64), N=5 / P=6 /
                chunk 48 (4-byte staging), P over 64 (two 64-column
                slots per head: P=100, 70, 128), a strong-decay case (cums
                below -500 inside a chunk, where a factored exp
                overflows), mamba2-370m's shape and jamba's (B=1 x 512,
                H=128, P=128, N=128, chunk 256), at atol 1e-4 x
                max(1, max|ref|); timed beside its plain version, with
                the route's bound (3xTF32 tensor cores) and the f32
                CUDA-core bound, at mamba2's and at jamba's layer in the
                B=4 x 4,096 cell;
  8. LM paths -- for qwen3-0.6b and mamba2-370m at full width in bf16: a
                B=4 x 4,096 prefill through `make_prefill_step` (kernel
                launches = layers x prefills; for qwen3 every one on the
                wgmma route), the float32 prefill of a
                256-token prompt against a token-by-token `decode_step`
                replay (rtol 2e-2, atol 2e-3), `launch.serve.main` with 8
                slots answering 16 requests, one profiled prefill and one
                profiled decode step at 8 slots;
  9. updates -- on phase 4's road network: sssp x8, then a monotone edge
                batch (64 weights halved, 4 two-hop shortcuts) through
                `cq.update`; the warm query must equal the scratch query
                bit for bit and pass `check()`; then 16 deletions: warm
                'auto' recomputes from scratch and passes `check()`,
                'always' raises. Logs update() seconds, blocks rebuilt,
                warm/scratch steps and walls;
 10. trace   -- sssp x8 and bfs with `trace=True` equal their untraced
                results bit for bit; one trace row per step, fetched +
                skipped = every block on each row; the Chrome trace is
                written and read back. Logs the traced/untraced wall
                ratio and blocks fetched per step;
 11. serving -- `AsyncGraphServer(batch=8, segment_steps=4)` on the real
                clock over bfs + sssp: a seeded Zipf (s = 1.1) stream of
                64 requests over 24 sources, one monotone update, 32 more.
                Every request is ok (none failed or shed) and equals one
                batched query per algebra and graph version bit for bit,
                two per version pass `check()`, warm starts follow the
                update, every lane state lives on the card, and the
                kernel's launches follow the replay accounting over the
                windows (each window one fixpoint). Logs
                queries/s, latency and queue-wait quantiles, occupancy,
                cache hit rate, and a profiled 16-request burst.

 12. mapping -- the FLIP mapping compiler and cycle simulator on the Table-4
                LRN graph (seed 0) for bfs, sssp and wcc: `compile_mapping`
                (effort 1), then `simulate` from vertex 0, which must match
                the oracle; logs simulated FLIP cycles at 100 MHz (a model
                of the CGRA fabric computed on the host, never a time on
                the card), parallelism, and the MCU and op-centric CGRA
                speedups. Then `flip_torch.compile(g, algo, plan,
                mapping=m)` on the card at tile 128 and 32 over 8 sources:
                bit-equal to the id-order session, `check()` passes, block
                counts logged under both orders; and `graph_run.main` with
                `--engine sim` and `--engine jax` on SRN, each printing
                `correct vs reference: True`;
 13. bucket server -- `GraphServer(batch=8)` over bfs + sssp on phase 4's
                network with a started `HeartbeatMonitor(timeout_s=0.5)`
                and `FaultInjector.random(seed=0, rate=0.25, stall_s=1.0)`
                plus one pinned NaN and one pinned stall: a Zipf stream of
                48 requests with a monotone update in the middle. Every
                request is ok and equals one batched query per algebra and
                graph version bit for bit; `faults_fired` equals the
                schedule, every raise and NaN is served by rung 1 (the
                finite guard trips on the NaN), the heartbeat flags every
                stall, and the ladder is [cuda+compact, cuda+dense]. Then
                the 6-vertex NaN graph (card == CPU, NaN positions
                included) and a copy of the network with one NaN weight
                go through servers where every rung trips the finite
                guard and every request carries a typed BackendFailure.
 14. autotune -- the plan autotuner on phase 4's network, with a tuning
                store in a fresh temporary directory: `autotune(g, "sssp",
                budget_s=None)` measures all three candidates (tile 64 /
                128 / 256 on the cuda route) by timing capped segments
                through the kernel; its chosen plan answers phase 4's
                sssp x8 bit for bit, steps included, and passes `check()`.
                `compile(g, "bfs", ExecutionPlan.auto(tuned=True,
                batch=8))` tunes under the default budget (logs which
                candidates the gate measured), answers 8 sources as the
                untuned session does, traced too, with `meta["autotune"]`
                on every dispatch record; a second compile is a store hit
                with no kernel launch. Then `graph_run --autotune` on SRN
                prints `correct vs reference: True`. Logs each candidate's
                us/step, best segment wall, blocks and the gate's estimate.

 15. distributed -- the distributed fixpoint at road-262k through
                `ExecutionPlan(distributed=True)`. First `graph_run
                --engine dist` on SRN with no process group (one rank, no
                collective): correct, through the captured loop's
                replays. (a) One rank over NCCL (world 1, a FileStore in
                a temporary directory): sssp x8, bfs and bfs/op on the
                captured device loop (the rank step's all-gather recorded
                in its CUDA graphs) and on the host loop (forced by
                patching `fixpoint_route` in this script alone), in turns
                as phase 22 runs them: both bit-equal to phase 4's
                results and to each other, steps and convergence
                included, with phase 22's launch and read rules and its
                logged numbers; K1 on a rank's slab (the replicated state
                of every tile, the carry of the rank's tiles) against its
                plain version at world 2 (both ranks, B=8) and world 3
                (the last rank's slab ends in a padding tile); one 1 MiB
                all-gather's device time (CUDA events over a graph of 200
                captured calls) and its host time eagerly;
                every registered program at ExtLRN-16k from 4 sources
                through the distributed plan against its local plan on
                the card (every program bit-equal, steps and convergence
                included, at world 1; the (+, x) programs' largest error
                logged), one read per chunk; `graph_run --engine
                dist` over the group. (b) Two ranks on the one card over
                gloo (NCCL refuses two ranks on one device; gloo's
                collectives run on the host, so the host loop), spawned:
                the same three queries on each rank, bit-equal to phase
                4's, K1 launches = iterations on each rank;
 16. granite -- granite-moe-3b-a800m at full width in bf16, random
                weights from seed 0, through phase 8's path: the B=4 x
                4,096 prefill (64 K2 launches, all wgmma; (token, choice)
                pairs dropped at capacity logged; device time of K2, the
                dispatch scatter, the expert products and the combine
                gather), the float32 prefill of an 8-token prompt against
                an 8-step decode replay (at T <= 8 the capacity, 8, drops
                nothing; at 256 tokens prefill drops pairs and decode does
                not, so the replay would be no identity), `launch.serve`
                with 16 requests; then `moe.apply(dispatch="all_to_all")`
                over phase 15's NCCL group against the one-group path at
                the prefill's layer shape (bf16, 1e-2 x max|y|).
 17. configs -- the other seven architectures in bf16 with random weights
                from seed 0, each model freed before the next, peak memory
                logged. phi3-medium-14b, mistral-nemo-12b, gemma3-12b and
                chameleon-34b at full depth through phase 8's path (two
                B=4 x 4,096 prefills, K2 launches = 2 x layers, all wgmma;
                the float32 replay at one pattern period, 4 layers for a
                1-long pattern, gemma3's 6 over 1,088 tokens so its window-
                1,024 rings wrap; serve 16 requests; one profiled prefill
                and decode step for phi3 only). hubert-xlarge at full depth
                on a (4, 4,096, 1,280) frames batch (96 K2 launches at hd
                80, wgmma), its float32 prefill at B=1 through K2 (tf32x3)
                against the same prefill on `attention_ref`, and `serve`
                refusing an encoder. qwen3-moe-235b-a22b at 12 of its 94
                layers (a depth one card holds with room to spare; drops
                at capacity 1,280 logged; the 8-token replay at 2 layers;
                serve --layers 12).
                jamba-1.5-large-398b, whose 8-layer period alone is 88 GB:
                its three block kinds at full width, one at a time, over
                (4, 4,096, 8,192) (one K2 and two K3 launches, each block's
                device time, the MoE's drops), one full-width mamba layer
                in float32 at B=1 x 512 against the plain intra-chunk
                form; then the whole hybrid model at its smoke config on
                the card (a prefill through K2 and K3, the 8-token replay,
                `serve --preset tiny --device cuda`).
 18. train    -- K2's backward (`flash_attention_bwd_cuda`) on its two
                routes (`flash.bwd_route`): "wgmma" (bf16 at hd
                64/80/128/256, `flash_attention_bwd_wgmma.cu`: bwd_dot,
                bwd_dkdv, bwd_dq, every product a wgmma; at hd 256 the two
                consumer warpgroups of a 64-row tile split hd; it takes the
                row log-sum-exp L that the wgmma forward writes with
                `return_lse=True`), "tf32x3" (f32 at every hd,
                `flash_attention_bwd_tf32.cu`: bwd_dot, bwd_dkdv, bwd_dq,
                every product 3xTF32 mma.sync; it takes the L of the tf32x3
                forward) and "fma" (bf16 at hd 16/32,
                `flash_attention_bwd.cu` on the CUDA cores; f32 when
                patched in). The forward's L on both routes against
                `attention_lse_ref` (bf16 and f32:
                qwen3's layer, ragged S=200 and S=5, hd 64 and 80, S=300 >
                T=100 under window 64, whose rows 163-299 see no key and
                must get +inf; f32 also hd 16 and 256; atol 1e-4; the
                output bit-equal to the call without L). Each route against
                `attention_bwd_ref`: causal x window {None, 128} x GQA
                ratio {1, 2, 8} x {f32 at hd 16, 64, 128, 256; bf16 at hd
                64, 128, 256}, f32 hd 16, non-causal hd 80
                (hubert's layer, bf16 at B=1 x 4,096), ragged S=200 (hd
                256, and bf16 at hd 80 and 64) and S=5, T != S both ways
                (hd 128 or 64, and 256), qwen3's layer and gemma3's (hd
                256, window 1,024 and global) at B=1 x 4,096 (f32 atol 1e-4
                x max(1, max|ref|); bf16 atol 2e-2 plus the output's bf16
                rounding, and a relative Frobenius error of 1e-2); every
                case must take its route's kernel and give the same bits
                on a second call, and each wgmma and tf32x3 case logs the
                fma kernel's error on the same inputs beside its own (held
                in f32); the autograd
                Function (`ops.flash_attention`) against torch.autograd
                through `attention_ref` in f32. Times at qwen3's training
                shape (bf16 q (8, 4,096, 16, 128), causal) both routes,
                beside the plain version, SDPA's backward (yardstick only),
                the bound and the wgmma design's seven-product floor (the
                profiled train step splits it by kernel); the wgmma forward
                with and without L at the prefill shape, in turns. At
                gemma3's (q (8, 4,096, 16, 256), k/v 8 heads), its global
                and a window-1,024 layer: the wgmma kernel (bwd_dkdv and
                bwd_dq apart from the profiled gemma3 step below) and the
                fma kernel in turns, SDPA's
                backward naming its backend, the bound and the floor; the
                wgmma forward at B=4 beside SDPA. In f32, at qwen3's
                shapes (forward (4, 4,096, 16, 128), backward (8, 4,096,
                16, 128)) and gemma3's hd-256 global layer (B=2): the
                tf32x3 and fma kernels in turns, the plain version, SDPA
                with TF32 off (naming its backend) and on (in the forward
                its error against `attention_ref`), the 3xTF32 bound, the
                backward's 7-product floor and the f32-FMA bound. The main
                path: qwen3-0.6b
                whole, bf16, B=8 x 4,096 from
                `SyntheticTextDataset(151_936, 4_096, 8, seed=0)` through
                `make_train_step` with remat, 5 steps: finite, falling
                loss; every gradient finite; wq/wk/wv/q_norm/k_norm
                gradients non-zero in all 28 layers; K2 forward launches
                2 x 28 x 5 (wgmma), backward 28 x 5, all wgmma; tokens/s,
                ms per step, peak memory, one profiled step. A bf16 hold at
                full width cut to 2 layers (B=2 x 1,024): one step through
                the wgmma backward against the same step with the route
                patched to "fma" here (unittest.mock; the package has no
                knob): the loss within 1e-3 relative, every gradient within
                relative Frobenius 1e-2. The f32 path: qwen3-0.6b whole (28
                layers) in f32, B=2 x 4,096, remat, 3 steps: finite,
                falling loss, every gradient finite, K2 forward 2 x 28 x 3
                and backward 28 x 3 launches, all tf32x3, one profiled step
                (K2's forward and backward device ms and share); step 1
                again with both K2 routes patched to "fma": loss within
                1e-5 relative, every gradient within relative Frobenius
                1e-4. An f32 hold at full width cut to 2
                layers (B=2 x 256): one step through the kernels (tf32x3
                forward and backward) against the same step on
                `attention_ref`, then 3 steps. `launch.train` on the card
                (tf32x3): 8 steps, --resume to 12, and a 12-step run resumed
                from its own step 8 against the uninterrupted run. Then
                gemma3-12b at full width cut to one pattern period (6 of 48
                layers: 5 local, window 1,024, and 1 global), bf16, B=8 x
                4,096 from `SyntheticTextDataset(262_144, 4_096, 8,
                seed=0)`, 5 steps the same way (K2 forward 2 x 6 x 5 and
                backward 6 x 5, all wgmma at hd 256; wq/wk/wv/q_norm/k_norm
                gradients non-zero in all 6 layers; one profiled step), and
                a route hold: 6 layers, B=1 x 2,048, one `train_loss` and
                `autograd.grad` through the wgmma backward against the same
                through the fma backward (patched in the script): the loss
                within 1e-3 relative, every gradient within relative
                Frobenius 1e-2.
 19. train mamba -- K3's backward (`ssd_intra_bwd_cuda`, 3xTF32 on the
                tensor cores: `ssd_bwd_dxw` (wgmma, P <= 64) or
                `ssd_bwd_dx` (mma.sync, P > 64), `ssd_bwd_dgsum`,
                `ssd_bwd_dcdb`) against `ssd_intra_bwd_ref` on phase 7's
                eleven cases (jamba's layer among them) with seeded
                cotangents: atol 1e-4 x max(1, max|ref|) per output, every
                output finite,
                two calls bit-equal; again at mamba2's training shape
                (f32 b=8, nc=16), what the main path gives it; the
                autograd Function `ops.SSDIntra` against torch.autograd
                through `ssd_intra_ref`, and
                `ssd_chunked` under autograd against `ssd_ref` under
                autograd (gradients of x, dt, Bm, Cm, A_log, D). Times at
                mamba2's training shape (f32 b=8, nc=16) and at jamba's
                (f32 b=2, nc=16, H=128, P=128), each held there too, beside
                the forward, the plain version, the bound (`ssd_bwd_work`:
                3xTF32 on the tensor cores, the card's least time; no
                library call computes it) and the CUDA cores' floor. The
                main path: mamba2-370m whole, bf16, B=8 x 4,096 from
                `SyntheticTextDataset(50_280, 4_096, 8, seed=0)` through
                `make_train_step` with remat, 5 steps: finite, falling
                loss; every gradient finite;
                A_log/D/dt_bias/wB/wC gradients non-zero in all 48 layers;
                K3 forward launches 2 x 48 x 5, backward 48 x 5; tokens/s,
                ms per step, peak memory, one profiled step (with each
                `ssd_bwd_*` function's time). An f32 hold at
                full width cut to 2 layers (B=2 x 512): one step through K3
                against the same step with the SSD patched to `ssd_ref`
                here (loss rtol 1e-5, gradients relative Frobenius 1e-4),
                then 3 steps. jamba: block 0 (mamba + dense FFN) at full
                width under autograd over (2, 4,096, 8,192) bf16, one K3
                forward and one backward at H=128, P=128, every gradient
                finite; the full-width f32 mamba layer at B=1 x 512, its
                gradients against autograd of `ssd_intra_ref`; the smoke
                model, 3 steps of `make_train_step` (K2 tf32x3, K3, MoE).
                `launch.train --arch mamba2_370m --preset tiny` on the
                card: 8 steps, --resume to 12, against a 12-step run
                resumed from its own step 8.
 20. mesh     -- the mesh surface (`distributed.sharding`, `launch.mesh`,
                `launch.steps.shard_state` / `shard_batch`): K2 and K3 run
                on each rank's shard inside `local_map` regions. (a) NCCL
                at world 1 under a (1, 1) data x model mesh: qwen3-0.6b
                whole, bf16, B=8 x 4,096 from phase 18's dataset and seed,
                3 steps of `make_train_step` on a sharded state; the first
                step's loss and grad norm against phase 18's (rtol 1e-3,
                bit-equality logged), K2 launches 2 x 28 x 3 forward and
                28 x 3 backward, all wgmma; ms per step, tokens/s and peak
                memory beside phase 18's. (b) Two gloo ranks on the one
                card (spawned as in 15b): the probe of the four collectives
                DTensor needs on CUDA tensors (all_reduce,
                all_gather_into_tensor, reduce_scatter_tensor,
                all_to_all_single); then under (2,) data and (1, 2) data x
                model: qwen3 at full width cut to 2 layers, f32, B=2 x 256,
                one step against the one-device step (loss rtol 1e-5,
                gradients relative Frobenius 1e-4, updated parameters 1e-6
                plus AdamW's bound); under (1, 2) mamba2 the same at B=2 x
                512, K3 forward and backward on 16 SSM heads per rank;
                qwen3 whole in bf16, global B=4 x 2,048, 2 steps (finite
                losses, K2 2 x 28 x 2 forward and 28 x 2 backward per rank,
                all wgmma, each rank holding a shard of the parameters); a
                granite MoE layer at full width in f32 with every group's
                capacity binding: under (2,) the grouped dispatch (G=2, a
                group per rank) against the one-device G=2 dispatch (1e-4 x
                max|y|, aux rtol 1e-5, each rank's drops = its group's),
                under (1, 2) `dispatch="all_to_all"` against the grouped
                dispatch on the same mesh. The same ranks also run phase
                21 (d).
 21. dryrun   -- the dry-run (`repro_torch.launch.dryrun`) against the
                card. Nine processes start at once and run on the CPU
                (no card): the CLI for qwen3-0.6b x train_4k,
                granite-moe-3b-a800m x prefill_32k, gemma3-12b x
                decode_32k (ring caches) and mamba2-370m x long_500k on
                the (16, 16) fake mesh, and mamba2-370m x decode_32k on
                (2, 16, 16) with --no-components, each of which must print
                [ok] and exit 0 (e); and `dryrun.measure_step` of phase
                18's and 19's cells (bf16, B=8 x 4,096, remat) without a
                mesh and on a fake (1, 1) mesh. Meanwhile, on the card:
                (a) qwen3-0.6b's and mamba2-370m's train step under
                `FlopCounterMode` (K2 and K3 launching through their
                custom ops), whose count must equal the dry-run's
                exactly, and a timed second step: the step time, the
                dry-run's compute_s and memory_s at the H100's constants
                and the step's share of the bf16 peak; then 2 pairs of
                qwen3 steps, K2 through its custom ops and called
                directly (`direct_k2`, the dispatch before this phase's
                ops), in turns (K2 2 x 28 x 6 forward and 28 x 6
                backward, K3 2 x 48 x 2 and 48 x 2, counted from 0);
                (b) the state's bytes (parameters, AdamW's moments and
                step) must equal the dry-run's, and its peak is logged
                beside the measured `max_memory_allocated`; (c)
                qwen3-0.6b whole, bf16, 8 slots, a 4,096-long cache, 32
                greedy decode steps under a (1, 1) mesh over NCCL: tokens
                equal and logits bit-equal to one device. (d), on phase
                20's two gloo ranks, f32 at 2 layers: qwen3 and mamba2
                decode under (1, 2) and qwen3's long_ctx decode with T
                over (data, model) = (2, 1) (a 512-long cache, B=1)
                against one device (1e-5 x max|logits|), and the granite
                MoE layer's gradients through `dispatch="all_to_all"`
                against the grouped dispatch's (1e-5 x max|grad|). Every
                number is logged beside nvidia-smi's name and power limit.
 22. device loop -- (run after phase 14, before 15) on phase 4's
                network: sssp x8, bfs and bfs/op through the captured
                device loop and, with a deadline far in the future (the
                reference's rule for the host loop), through the host
                loop, in turns (device, host, host, device): attrs,
                steps and the converged mask
                bit-equal; the host loop makes one launch and one
                device->host read per iteration (+1 read at its exit, +1
                for the result), the device loop one read per replayed
                chunk (+1 for the result). Logs ms/step, queries/s, the
                device's busy share from torch.profiler over one query of
                each loop, reads per query and launches, beside
                nvidia-smi's name and power limit. Then `update` of a
                monotone batch: the new engine carries none of the old
                engine's graphs, every replay of its two queries (warm,
                scratch) is of a graph it captured itself, and warm =
                scratch bit for bit.

Phase 20's launches on the gloo ranks are listed by rank in each kernel
row's `launches_by_phase` and left out of its `launches`, as phase 15b's
are in K1's.

In phases 4, 5, 9-15 and 22 every fixpoint step is one launch of the
frontier-relax kernel, and each path resets the launch count before it
runs. A CUDA engine without a deadline runs the captured device loop
(`FlipEngine._fixpoint_device`), the distributed fixpoint too where its
collective can be captured (NCCL, or no group): a fixpoint replays chunks
of L <= DEVICE_CHUNK steps, each replay credits L launches, and a chunk's
steps past the fixpoint are no-ops, so each path requires iterations <=
launches <= iterations + (DEVICE_CHUNK - 1) x fixpoints (for the
continuous server, the windows; for the bucket servers, every dispatch,
retries included; for a tuning sweep, one warm-up and three timed
segments per measured engine, which prices every bucket width on it).
The host loop (a deadline in phase 22, the forced runs of 15a, the gloo
ranks of 15b) requires launches = iterations. A capture that fails
raises: there is no fallback to the host loop.

The last lines are one JSON object describing each kernel -- K2 and its
backward once per route, K3 and its backward, every row with its
launches by phase, K2's
forward rows also with their times at hubert's hd-80 shape, the wgmma
backward's row with its seven-product floor, its L's error and the
forward's time with and without L -- and then
``{"ok": true, "device": {...}}``. Needs one CUDA card; without one it
exits 2 and prints no result. Imports nothing of JAX or of `repro`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import flip_torch  # noqa: E402
from repro_torch import configs, obs  # noqa: E402
from repro_torch.algebra import ALGEBRAS  # noqa: E402
from repro_torch.autotune import (TuningStore, autotune,  # noqa: E402
                                  profile_graph)
from repro_torch.autotune import measure as at_measure  # noqa: E402
from repro_torch.autotune.tuner import DEFAULT_BUDGET_S  # noqa: E402
from repro_torch.core import (baselines, compile_mapping,  # noqa: E402
                              mapping_order, simulate)
from repro_torch.core import engine as engine_mod  # noqa: E402
from repro_torch.core.engine import DEVICE_CHUNK, FlipEngine  # noqa: E402
from repro_torch.distributed.health import HeartbeatMonitor  # noqa: E402
from repro_torch.distributed.sharding import (NamedSharding,  # noqa: E402
                                              logical_to_pspec,
                                              mesh_context)
from repro_torch.graphs import (Graph, make_dataset,  # noqa: E402
                                make_road_network, reference)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.data import SyntheticTextDataset, make_batches  # noqa: E402
from repro_torch.kernels.attention import flash  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.attention.ref import (attention_bwd_ref,  # noqa: E402
                                               attention_lse_ref,
                                               attention_ref)
from repro_torch.kernels.frontier import frontier as relax  # noqa: E402
from repro_torch.kernels.frontier.ops import (BlockedGraph,  # noqa: E402
                                              build_blocks,
                                              frontier_relax_torch)
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ssd  # noqa: E402
from repro_torch.kernels.ssd.ref import (chunk_inputs,  # noqa: E402
                                         ssd_intra_bwd_ref, ssd_intra_ref,
                                         ssd_ref)
from repro_torch.launch import (graph_run, serve, steps,  # noqa: E402
                                train)
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch.serve_graph import GraphServer  # noqa: E402
from repro_torch.models import attention, mamba, moe  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import DeclModule, init_module  # noqa: E402
from repro_torch.obs import write_chrome_trace  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.resilience import (BackendFailure,  # noqa: E402
                                    FaultInjector, FaultSpec,
                                    fallback_chain)
from repro_torch.serving import AsyncGraphServer  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core rate
TF32_OPS_PER_S = 495e12       # H100 SXM dense TF32 tensor-core rate
FULL_N = 262_144              # DIMACS USA-road-d.NY scale (264,346 nodes)
PROGRAM_N = 16_384            # Ext. LRN, the paper's largest group
PLUS_TIMES_ATOL = 1e-5
SMI: list = []                # nvidia-smi's name and power limit


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max |a - b|, with equal infinities counting as no error."""
    d = torch.where(a == b, 0.0, (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def state(bg: BlockedGraph, b: int, d: int, density: str,
          rng: np.random.Generator):
    """(src_vals, carry) on the card: carry random, src_vals the carry
    where the frontier is active and the ⊕-identity elsewhere. density:
    'all' (every lane), 'sparse' (10% of source tiles, half their
    lanes), 'none'."""
    sr = bg.semiring
    shape = (b, bg.ntiles, bg.tile) + ((d,) if d > 1 else ())
    if sr.name == "or_and":
        carry = (rng.random(shape) < 0.5).astype(np.float32)
    else:
        carry = rng.uniform(0.5, 9.0, shape).astype(np.float32)
    if density == "all":
        mask = np.ones(shape, dtype=bool)
    elif density == "none":
        mask = np.zeros(shape, dtype=bool)
    else:
        tiles = rng.random((b, bg.ntiles)) < 0.1
        mask = rng.random(shape) < 0.5
        mask &= tiles.reshape(tiles.shape + (1,) * (len(shape) - 2))
    sv = np.where(mask, carry, np.float32(sr.zero)).astype(np.float32)
    dev = bg.device
    return torch.from_numpy(sv).to(dev), torch.from_numpy(carry).to(dev)


def work(bg: BlockedGraph, sv: torch.Tensor, d: int) -> dict:
    """Bytes and operations one relax step needs on these inputs: each
    active block read once (a block is active when some query's source
    tile holds a non-identity lane), the source values and carry read
    once, the output written once; 2 operations (⊗ and ⊕) per active
    (query, block, source lane, destination lane, feature)."""
    zero = bg.semiring.zero
    act = (sv != zero).reshape(sv.shape[0], bg.ntiles, -1).any(dim=-1)
    per_block = act[:, bg.bsrc.long()].sum(dim=0)          # (nb,) queries
    active_blocks = int((per_block > 0).sum())
    state_bytes = sv.numel() * 4
    nbytes = (active_blocks * bg.tile * bg.tile * 4 + 3 * state_bytes
              + bg.bsrc.numel() * 4 + bg.dst_start.numel() * 4)
    ops = int(per_block.sum()) * bg.tile * bg.tile * d * 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"active_blocks": active_blocks, "bytes": nbytes, "ops": ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of `fn` over `reps` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(label: str, bg: BlockedGraph, sv, carry, d: int,
            blocks: torch.Tensor | None = None) -> float:
    """One kernel call against the plain version on the same inputs;
    raises unless bit-equal (idempotent ⊕; NaN positions equal and the
    rest equal) or within atol (plus_times). `blocks` replaces the
    layout's weight blocks (the NaN cases)."""
    sr = bg.semiring
    w = bg.blocks if blocks is None else blocks
    out = relax.frontier_relax_cuda(sv, carry, w, bg.bsrc, bg.dst_start, sr,
                                    feature_dim=d)
    torch.cuda.synchronize()
    ref = frontier_relax_torch(sv, carry, w, bg.bsrc, bg.bdst, sr,
                               feature_dim=d)
    nan = torch.isnan(ref)
    err = max_abs_err(out[~nan], ref[~nan])
    if sr.idempotent:
        ok = torch.equal(torch.isnan(out), nan) and torch.equal(
            out[~nan], ref[~nan])
        rule = "bit-equal"
        if bool(nan.any()):
            rule += f", {int(nan.sum())} NaN at equal positions"
    else:
        ok = err <= PLUS_TIMES_ATOL
        rule = f"atol {PLUS_TIMES_ATOL:g}"
    log(f"kernel {label}: max|err| {err:.3e} ({rule}: {ok})")
    require(ok, f"kernel disagrees with the plain version: {label}")
    return err


def phase_device() -> dict:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card",
              file=sys.stderr)
        sys.exit(2)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(f"device {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    print(smi, flush=True)
    SMI.append(smi)
    return {"platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}


def demangle(names: list[str]) -> list[str]:
    """Kernel names as `flash_fwd<float, (int)16>`, through the toolkit's
    cu++filt (the mangled names where it is missing)."""
    filt = Path(_build.nvcc()).parent / "cu++filt"
    if not filt.exists():
        return names
    out = subprocess.run([str(filt)], input="\n".join(names),
                         capture_output=True, text=True, timeout=60).stdout
    short = []
    for sig in out.splitlines():
        sig = sig.replace("(anonymous namespace)::", "").removeprefix("void ")
        depth = 0
        for i, ch in enumerate(sig):       # cut at the parameter list
            depth += (ch == "<") - (ch == ">")
            if ch == "(" and depth == 0:
                sig = sig[:i]
                break
        short.append(sig)
    return short if len(short) == len(names) else names


def sass_counts(library: Path, marks: tuple[str, ...]) -> dict:
    """Per kernel of a built library, how many SASS instructions contain
    each of `marks`, through the toolkit's cuobjdump."""
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    require(tool.exists(), f"no {tool}: the SASS of {library.name} cannot "
            "be checked")
    sass = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    names, counts = [], []
    for ln in sass.splitlines():
        if "Function :" in ln:
            names.append(ln.split("Function :", 1)[1].strip())
            counts.append([0] * len(marks))
        elif names:
            for k, mark in enumerate(marks):
                counts[-1][k] += mark in ln
    return dict(zip(demangle(names), map(tuple, counts)))


def wgmma_waits(library: Path) -> dict:
    """Per kernel, (HGMMA, WARPGROUP.DEPBAR) counts in its SASS. A wait
    after every HGMMA means ptxas serialized the wgmma batch."""
    return sass_counts(library, ("HGMMA", "WARPGROUP.DEPBAR"))


def k1_resources(library: Path) -> None:
    """K1's registers, stack and spills for every instantiation
    (`cuobjdump -res-usage`), and per function the SASS counts of its
    semiring operations (FADD / FMNMX), shared loads, bulk copies and
    mbarrier operations; the whole SASS goes to chiprun_out/k1.sass."""
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    require(tool.exists(), f"no {tool}: K1's resources cannot be read")
    res = subprocess.run([str(tool), "-res-usage", str(library)],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    lines = res.splitlines()
    names = [ln.split("Function", 1)[1].strip(" :") for ln in lines
             if ln.strip().startswith("Function")]
    usage = [ln.strip() for ln in lines if "REG:" in ln]
    for name, use in zip(demangle(names), usage):
        log(f"  {name}: {use}")
    counts = sass_counts(library, ("FADD", "FMNMX", "LDS", "UBLKCP",
                                   "SYNCS", "BAR"))
    for name, c in counts.items():
        log(f"  {name}: SASS FADD {c[0]}, FMNMX {c[1]}, LDS {c[2]}, "
            f"bulk copies {c[3]}, mbarrier {c[4]}, BAR {c[5]}")
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "k1.sass").write_text(subprocess.run(
        [str(tool), "-sass", str(library)], capture_output=True, text=True,
        timeout=120, check=True).stdout)


def phase_build() -> None:
    sources = (relax.SOURCE, flash.SOURCE, flash.WGMMA_SOURCE,
               flash.TF32_SOURCE, flash.BWD_SOURCE, flash.BWD_WGMMA_SOURCE,
               flash.BWD_TF32_SOURCE, ssd.SOURCE, ssd.BWD_SOURCE)
    tf32_sources = (flash.TF32_SOURCE, flash.BWD_TF32_SOURCE)
    wgmma_sources = (flash.WGMMA_SOURCE, flash.BWD_WGMMA_SOURCE)
    t0 = time.perf_counter()
    for source, (path, seconds, text) in zip(
            sources, _build.build_all(sources, verbose=True)):
        log(f"built {path.name} in {seconds:.2f} s; ptxas:")
        names, props = [], []
        for ln in text.splitlines():
            if "warning" in ln:
                log(f"  {ln.strip()}")
            if "Compiling entry function" in ln:
                names.append(ln.split("'")[1])
                props.append([])
            elif names and ("spill" in ln or "registers" in ln):
                props[-1].append(ln.split(":", 1)[-1].strip())
        for name, prop in zip(demangle(names), props):
            log(f"  {name}: {'; '.join(prop)}")
        if source == relax.SOURCE:
            k1_resources(path)
        if source in wgmma_sources:
            require("C7510" not in text and "C7508" not in text,
                    f"{source.name}: ptxas serialized wgmma (C7510) or "
                    "ignored setmaxnreg (C7508)")
        if source in (*wgmma_sources, *tf32_sources, ssd.SOURCE,
                      ssd.BWD_SOURCE):
            require(" 0 bytes spill stores" in text
                    and text.count("spill stores") == text.count(
                        " 0 bytes spill stores"),
                    f"{source.name}: ptxas reports spills")
        if source in (flash.BWD_WGMMA_SOURCE, ssd.SOURCE, ssd.BWD_SOURCE):
            # ptxas gives no C7510 when it serializes these wgmma (a
            # register-A operand): only the SASS shows it
            waits = wgmma_waits(path)
            for name, (n_mma, n_wait) in waits.items():
                if n_mma:
                    log(f"  {name}: {n_mma} HGMMA, {n_wait} wgmma waits in "
                        "the SASS")
                    require(2 * n_wait < n_mma,
                            f"{source.name}: ptxas serialized the wgmma "
                            f"of {name} (a wait after each)")
            if source == flash.BWD_WGMMA_SOURCE:
                # every instantiation by name: demangled "fn<(int)hd>" or
                # mangled "fnILi<hd>E"
                for fn, hd in itertools.product(
                        ("bwd_dkdv", "bwd_dq"), (64, 128, 256)):
                    require(any((f"{fn}<(int){hd}>" in name
                                 or f"{fn}ILi{hd}E" in name) and n_mma
                                for name, (n_mma, _) in waits.items()),
                            f"{source.name}: no HGMMA in {fn}<{hd}>")
        if source in tf32_sources:
            # the tensor-core route: mma.sync (HMMA) in every function of
            # every head dim (no wgmma, so none for ptxas to serialize)
            mmas = sass_counts(path, ("HMMA", "HGMMA"))
            fns = (("fwd_tf32",) if source == flash.TF32_SOURCE
                   else ("bwd_dkdv", "bwd_dq"))
            for name, (n_mma, n_gmma) in mmas.items():
                if n_mma or n_gmma:
                    log(f"  {name}: {n_mma} HMMA, {n_gmma} HGMMA in the SASS")
            for fn, hd in itertools.product(fns, flash.HEAD_DIMS):
                require(any((f"{fn}<(int){hd}>" in name
                             or f"{fn}<(int){hd}," in name
                             or f"{fn}ILi{hd}E" in name) and n_mma
                            for name, (n_mma, _) in mmas.items()),
                        f"{source.name}: no HMMA in {fn}<{hd}>")
        if source == ssd.BWD_SOURCE:
            # the tensor-core route: wgmma (HGMMA) in ssd_bwd_dxw, mma.sync
            # (HMMA) in ssd_bwd_dx and ssd_bwd_dcdb
            mmas = sass_counts(path, ("HMMA", "HGMMA"))
            for name, (n_mma, n_gmma) in mmas.items():
                log(f"  {name}: {n_mma} HMMA, {n_gmma} HGMMA in the SASS")
            for fn, k in (("ssd_bwd_dxw", 1), ("ssd_bwd_dx", 0),
                          ("ssd_bwd_dcdb", 0)):
                # demangled "<unnamed>::fn", or mangled "...<len>fn..."
                found = [c[k] for name, c in mmas.items()
                         if name.endswith("::" + fn) or f"{len(fn)}{fn}E"
                         in name]
                require(found and all(found),
                        f"{source.name}: no {('HMMA', 'HGMMA')[k]} in {fn}")
    log(f"all kernels built in {time.perf_counter() - t0:.2f} s")
    relax._library()
    for name in flash.ROUTES:
        flash._library(name)
    for name in flash.BWD_ROUTES:
        flash._bwd_library(name)
    ssd._library()
    ssd._bwd_library()


def phase_kernel_small(rng) -> float:
    """All semirings, densities, B and d on a ragged 3,000-vertex graph,
    plus a smaller tile and the empty-destination layout."""
    errs = [0.0]
    g = make_road_network(3000, seed=0, delete_frac=0.56)   # 3000 % 128
    for algo in ("sssp", "widest", "reach", "pagerank"):
        bg = build_blocks(g, algo, tile=128, device="cuda")
        for density in ("all", "sparse", "none"):
            for b in (1, 8):
                for d in (1, 8):
                    sv, carry = state(bg, b, d, density, rng)
                    errs.append(compare(
                        f"{bg.semiring.name} n=3000 T=128 {density} "
                        f"B={b} d={d}", bg, sv, carry, d))
        sv, carry = state(bg, 3, 1, "sparse", rng)           # solo layout
        errs.append(compare(f"{bg.semiring.name} solo", bg, sv[0],
                            carry[0], 1))
    bg = build_blocks(g, "sssp", tile=32, device="cuda")
    sv, carry = state(bg, 8, 8, "sparse", rng)
    errs.append(compare("min_plus n=3000 T=32 sparse B=8 d=8", bg, sv,
                        carry, 8))
    # a destination tile no block writes keeps its carry
    t = 8
    empty = BlockedGraph(
        n=3 * t, tile=t, ntiles=3,
        blocks=torch.as_tensor(rng.uniform(1, 5, (1, t, t)).astype(
            np.float32), device="cuda"),
        bsrc=torch.tensor([2], dtype=torch.int32, device="cuda"),
        bdst=torch.tensor([0], dtype=torch.int32, device="cuda"),
        perm=np.arange(3 * t), inv_perm=np.arange(3 * t),
        algebra=ALGEBRAS["sssp"])
    for b in (1, 2):
        sv, carry = state(empty, b, 1, "all", rng)
        errs.append(compare(f"empty destination B={b}", empty, sv, carry,
                            1))
        out = relax.frontier_relax_cuda(sv, carry, empty.blocks, empty.bsrc,
                                        empty.dst_start, empty.semiring)
        require(torch.equal(out[:, 1:], carry[:, 1:]),
                "a destination with no block lost its carry")
    errs.append(tile_cases(g))
    errs.append(nan_cases(g))
    errs.append(chunk_cases(g))
    return max(errs)


def chunk_cases(g) -> float:
    """More queries than one work item's chunk of 8 and more features
    than its slab of 8: B=11 (two query chunks, the second of 3) and
    d=12 (two feature slabs, the second of 4), every semiring. Draws
    from a generator of its own, so the later phases' seeded draws are
    those of earlier PRs."""
    rng = np.random.default_rng(6)
    errs = []
    for algo in ("sssp", "widest", "reach", "pagerank"):
        bg = build_blocks(g, algo, tile=128, device="cuda")
        for b, d in ((11, 1), (3, 12), (11, 12)):
            sv, carry = state(bg, b, d, "sparse", rng)
            errs.append(compare(f"{bg.semiring.name} n=3000 T=128 sparse "
                                f"B={b} d={d}", bg, sv, carry, d))
    return max(errs)


def tile_cases(g) -> float:
    """The autotuner's other tiles (phase 14 runs the kernel at 64 and
    256 too): min_plus, max_min and or_and at T in {64, 256}, dense and
    frontier-masked, B in {1, 8}, d in {1, 8}. At T=256 and d=8 a block
    stages 8 queries x 256 lanes x 8 features, 64 KiB, which is past the
    48 KiB default and takes the opt-in to more shared memory. Draws
    from a generator of its own, so the later phases' seeded draws are
    those of earlier PRs."""
    rng = np.random.default_rng(2)
    errs = []
    for tile in (64, 256):
        for algo in ("sssp", "widest", "reach"):
            bg = build_blocks(g, algo, tile=tile, device="cuda")
            for density in ("all", "sparse"):
                for b in (1, 8):
                    for d in (1, 8):
                        sv, carry = state(bg, b, d, density, rng)
                        errs.append(compare(
                            f"{bg.semiring.name} n=3000 T={tile} {density} "
                            f"B={b} d={d}", bg, sv, carry, d))
    return max(errs)


def nan_cases(g) -> float:
    """NaN must propagate through the kernel as through the plain version
    (torch.minimum/maximum): a NaN weight, a NaN source lane and a NaN
    carry lane, for the three min/max semirings at B in {1, 8}. The NaN
    weight sits in a block every query relaxes (all lanes active): the
    kernel skips an inactive source tile per query, the dense plain
    version does not, and a NaN weight is the one operand for which
    ``zero ⊗ w != zero``. Draws from a generator of its own, so the
    later phases' seeded draws are those of earlier PRs."""
    rng = np.random.default_rng(1)
    errs = []
    for algo in ("sssp", "widest", "reach"):
        bg = build_blocks(g, algo, tile=128, device="cuda")
        name = bg.semiring.name
        for b in (1, 8):
            sv, carry = state(bg, b, 1, "all", rng)
            w = bg.blocks.clone()
            i = int(rng.integers(w.shape[0]))
            w[i, int(rng.integers(bg.tile)), int(rng.integers(bg.tile))] = \
                float("nan")
            errs.append(compare(f"{name} NaN weight B={b}", bg, sv, carry,
                                1, blocks=w))
            sv, carry = state(bg, b, 1, "sparse", rng)
            q, t = int(rng.integers(b)), int(rng.integers(bg.ntiles))
            sv[q, t, int(rng.integers(bg.tile))] = float("nan")
            errs.append(compare(f"{name} NaN source lane B={b}", bg, sv,
                                carry, 1))
            sv, carry = state(bg, b, 1, "sparse", rng)
            carry[int(rng.integers(b)), int(rng.integers(bg.ntiles)),
                  int(rng.integers(bg.tile))] = float("nan")
            errs.append(compare(f"{name} NaN carry lane B={b}", bg, sv,
                                carry, 1))
    return max(errs)


G500_TILES = 512             # a Kronecker scale-16 graph's tiles at T=128
G500_PER_TILE = 502          # its blocks a destination tile (257k in all)


def dense_layout(ntiles: int, per_tile: int, tile: int, algo: str,
                 seed: int) -> BlockedGraph:
    """A block layout of a Kronecker graph's shape, made on the card:
    `ntiles` destination tiles, each with `per_tile` distinct random
    source tiles (the diagonal one always), each block holding an edge
    in 5% of its lanes (weights of the algebra's kind, the ⊕-identity
    elsewhere)."""
    rng = np.random.default_rng(seed)
    src = np.stack([np.sort(np.concatenate([
        [t], rng.choice(np.delete(np.arange(ntiles), t), per_tile - 1,
                        replace=False)])) for t in range(ntiles)])
    bsrc = src.reshape(-1).astype(np.int32)
    bdst = np.repeat(np.arange(ntiles), per_tile).astype(np.int32)
    alg = ALGEBRAS[algo]
    zero = float(alg.semiring.zero)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    blocks = torch.empty(bsrc.size, tile, tile, device="cuda")
    for i in range(0, bsrc.size, 4096):
        w = blocks[i:i + 4096]
        edge = torch.rand(w.shape, generator=gen, device="cuda") < 0.05
        val = torch.rand(w.shape, generator=gen, device="cuda")
        if algo == "reach":
            val = torch.ones_like(val)
        elif algo != "pagerank":
            val = 1.0 + torch.floor(8.0 * val)
        w.copy_(torch.where(edge, val, zero))
    n = ntiles * tile
    return BlockedGraph(
        n=n, tile=tile, ntiles=ntiles, blocks=blocks,
        bsrc=torch.as_tensor(bsrc, device="cuda"),
        bdst=torch.as_tensor(bdst, device="cuda"),
        perm=np.arange(n), inv_perm=np.arange(n), algebra=alg)


def deep_state(bg: BlockedGraph, b: int, d: int, density: str, rng):
    """`state` for a deep layout; for plus_times as PageRank's masses
    (each lane's value over n): a destination there sums ~3,000
    products, and of O(1) values those round at ~1e-3 in f32 whatever
    the order, past PLUS_TIMES_ATOL."""
    sv, carry = state(bg, b, d, density, rng)
    if bg.semiring.name == "plus_times":
        sv, carry = sv / bg.n, carry / bg.n
    return sv, carry


def phase_kernel_deep() -> tuple[float, dict]:
    """K1 at a Kronecker graph's shape (512 destination tiles of ~500
    blocks, 16.8 GB of blocks at T=128): the deep plan, its ring and its
    split segments. Every semiring dense / frontier-masked / empty at
    B=8 (min_plus also at B=1 and d=8), a rank's slab of it (nsrc !=
    ntiles), T=64 and T=256 layouts of the same depth, and two launches
    bit-identical (plus_times too, whose parts are summed in a fixed
    order). Times min_plus B=8 d=1 beside the bound, with the bytes a
    second it reached; logs each launch plan. Draws from a generator of
    its own, so the later phases' seeded draws are those of earlier
    PRs."""
    rng = np.random.default_rng(5)
    errs = [0.0]
    timing = {}
    for algo in ("sssp", "widest", "reach", "pagerank"):
        bg = dense_layout(G500_TILES, G500_PER_TILE, 128, algo, seed=3)
        sr = bg.semiring
        plan = relax.launch_plan(128, 1, 8, bg.bsrc.numel(), bg.ntiles)
        log(f"deep layout {sr.name}: {bg.bsrc.numel()} blocks, "
            f"{bg.blocks.numel() * 4 / 1e9:.2f} GB; plan {plan}")
        combos = [("all", 8, 1), ("sparse", 8, 1), ("none", 8, 1)]
        if algo == "sssp":
            combos += [("all", 1, 1), ("sparse", 1, 1), ("none", 1, 1),
                       ("all", 8, 8), ("sparse", 8, 8), ("none", 1, 8),
                       ("sparse", 1, 8)]
        for density, b, d in combos:
            sv, carry = deep_state(bg, b, d, density, rng)
            errs.append(compare(f"{sr.name} deep T=128 {density} B={b} "
                                f"d={d}", bg, sv, carry, d))
        sv, carry = deep_state(bg, 8, 1, "all", rng)
        run = lambda: relax.frontier_relax_cuda(          # noqa: E731
            sv, carry, bg.blocks, bg.bsrc, bg.dst_start, sr)
        require(torch.equal(run(), run()),
                f"deep {sr.name}: two launches differ")
        log(f"deep {sr.name}: two launches bit-identical")
        if algo == "sssp":
            lo, hi = 128, 256                   # a rank's slab of tiles
            a, z = int(bg.dst_start[lo]), int(bg.dst_start[hi])
            slab = BlockedGraph(
                n=(hi - lo) * bg.tile, tile=bg.tile, ntiles=hi - lo,
                blocks=bg.blocks[a:z], bsrc=bg.bsrc[a:z],
                bdst=bg.bdst[a:z] - lo, perm=np.arange((hi - lo) * bg.tile),
                inv_perm=np.arange((hi - lo) * bg.tile), algebra=bg.algebra)
            for b in (8, 1):
                sv, carry = deep_state(bg, b, 1, "sparse", rng)
                errs.append(compare(
                    f"min_plus deep slab tiles {lo}..{hi - 1} of "
                    f"{bg.ntiles} B={b}", slab, sv,
                    carry[:, lo:hi].contiguous(), 1))
            for density in ("all", "sparse", "none"):
                sv, carry = deep_state(bg, 8, 1, density, rng)
                w = work(bg, sv, 1)
                ms = time_ms(lambda: relax.frontier_relax_cuda(
                    sv, carry, bg.blocks, bg.bsrc, bg.dst_start, sr),
                    reps=10)
                rate = w["bytes"] / (ms * 1e-3)
                log(f"time deep {density} B=8 d=1: kernel {ms:.4f} ms, "
                    f"bound {w['bound_ms']:.4f} ms ({w['bound_by']}; "
                    f"{w['active_blocks']} of {bg.bsrc.numel()} blocks "
                    f"active, {w['bytes']} B), {rate / 1e12:.3f} TB/s, "
                    f"{100 * w['bound_ms'] / ms:.1f}% of the bound")
                timing[density] = dict(w, ms=ms, bytes_per_s=rate)
        del bg, sv, carry
        torch.cuda.empty_cache()
    for tile, ntiles, per_tile in ((64, 1024, 400), (256, 128, 100)):
        for algo in ("sssp", "pagerank"):
            bg = dense_layout(ntiles, per_tile, tile, algo, seed=4)
            plan = relax.launch_plan(tile, 1, 8, bg.bsrc.numel(), ntiles)
            log(f"deep layout T={tile}: {bg.bsrc.numel()} blocks; plan "
                f"{plan}")
            for density, b, d in (("all", 8, 1), ("sparse", 8, 1),
                                  ("sparse", 1, 1), ("sparse", 8, 8)):
                sv, carry = deep_state(bg, b, d, density, rng)
                errs.append(compare(
                    f"{bg.semiring.name} deep T={tile} {density} B={b} "
                    f"d={d}", bg, sv, carry, d))
            del bg
            torch.cuda.empty_cache()
    return max(errs), timing


def phase_kernel_full(bg: BlockedGraph, rng) -> tuple[float, dict]:
    """Full-size states of the main path's graph, and the timings at the
    main path's shapes (sssp over 8 queries, d = 1)."""
    errs = [0.0]
    for density in ("all", "sparse"):
        for b in (1, 8):
            for d in (1, 8):
                sv, carry = state(bg, b, d, density, rng)
                errs.append(compare(
                    f"min_plus n={FULL_N} {density} B={b} d={d}", bg, sv,
                    carry, d))
    sr = bg.semiring
    timing = {}
    for density in ("all", "sparse"):
        sv, carry = state(bg, 8, 1, density, rng)
        w = work(bg, sv, 1)
        ms = time_ms(lambda: relax.frontier_relax_cuda(
            sv, carry, bg.blocks, bg.bsrc, bg.dst_start, sr), reps=20)
        plain_ms = time_ms(lambda: frontier_relax_torch(
            sv, carry, bg.blocks, bg.bsrc, bg.bdst, sr), reps=3, warmup=1)
        log(f"time {density} B=8 d=1: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {w['bound_ms']:.4f} ms "
            f"({w['bound_by']}; {w['active_blocks']} of "
            f"{bg.bsrc.numel()} blocks active, {w['bytes']} B, "
            f"{w['ops']} ops)")
        timing[density] = dict(w, ms=ms, plain_ms=plain_ms)
    return max(errs), timing


def replay_accounting(label: str, launches: int, iters: int,
                      fixpoints: int) -> None:
    """K1's launches against the fixpoint iterations of `fixpoints`
    fixpoints on the device loop. Each fixpoint replays whole chunks of
    L <= DEVICE_CHUNK steps and credits L launches per replay, and its
    last chunk's steps past the fixpoint are no-ops, so iterations <=
    launches <= iterations + (DEVICE_CHUNK - 1) x fixpoints. (The host
    loop, which deadlines and the distributed fixpoint take, launches
    exactly once per iteration.)"""
    top = iters + (DEVICE_CHUNK - 1) * fixpoints
    require(iters <= launches <= top,
            f"{label}: {launches} kernel launches for {iters} fixpoint "
            f"iterations in {fixpoints} fixpoints (want {iters}..{top}) -- "
            "the path did not go through the kernel's replays")


def counted_query(cq, srcs, label: str, **kw):
    """One query on the card with the kernel's count set to 0 just
    before it; requires the device loop's replay accounting (one
    fixpoint), or one launch per iteration when a deadline routes the
    query through the host loop. Returns ``(result, wall_s,
    launches)``."""
    relax.frontier_relax_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = cq.query(srcs, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = relax.frontier_relax_cuda.launches
    iters = int(np.max(r.steps))
    if kw.get("deadline_s") is not None:
        require(launches == iters,
                f"{label}: {launches} kernel launches for {iters} host-loop "
                "iterations -- the path did not go through the kernel")
    else:
        replay_accounting(label, launches, iters, 1)
    return r, wall, launches


def check(r, label: str) -> None:
    t0 = time.perf_counter()
    require(r.check(), f"{label}: result disagrees with the numpy oracle")
    log(f"{label}: check() passed ({time.perf_counter() - t0:.1f} s)")


def run_query(cq, srcs, label: str):
    """One query on the card; checks it against the oracle and the
    kernel's launches against the fixpoint iterations (the replay
    accounting). Returns ``(launches, result)``."""
    r, wall, launches = counted_query(cq, srcs, label)
    steps = np.atleast_1d(r.steps)
    iters = int(steps.max())
    bg = cq.engine.bg
    log(f"{label}: |V|={cq.graph.n} |E|={cq.graph.m} nb={bg.bsrc.numel()} "
        f"steps={steps.tolist()} wall {wall:.3f} s, {steps.size / wall:.3f} "
        f"queries/s, {wall / max(iters, 1) * 1e3:.4f} ms/step, "
        f"launches {launches}")
    check(r, label)
    return launches, r


@contextlib.contextmanager
def spans_off():
    """The port's program spans off under a profiler (`obs.enable`), so
    that a profiled busy share reads as it did before the port had
    spans."""
    obs.enable(False)
    try:
        yield
    finally:
        obs.enable(None)


def profile_query(cq, srcs, label: str, **kw) -> float | None:
    """Where one query's time goes on the card: device time by kernel
    (torch.profiler over the whole query, the program's spans off)
    against the profiled wall. Returns the device's busy share of the
    wall, None when the profiler saw no device event."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with spans_off(), profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = cq.query(srcs, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")), reverse=True)
    iters = int(np.max(r.steps))
    if not rows:
        log(f"profile {label}: device time not measured (no device events)")
        return None
    busy = sum(ms for ms, _, _ in rows)
    log(f"profile {label}: {iters} steps, profiled wall {wall_ms:.1f} ms, "
        f"device busy {busy:.1f} ms ({busy / wall_ms:.1%}), "
        f"{sum(c for _, c, _ in rows) / max(iters, 1):.1f} device ops/step")
    for ms, count, key in rows[:8]:
        log(f"  {ms:9.3f} ms {count:6d}x {ms / count * 1e3:8.2f} us  "
            f"{key[:90]}")
    return busy / wall_ms


# ------------------------------------------------------------------ #
# the graph-serving surface: updates (9), tracing (10), serving (11)
# ------------------------------------------------------------------ #
def monotone_batch(g, rng, reweights: int = 64, inserts: int = 4):
    """Weights halved on `reweights` random existing edges, plus
    `inserts` new two-hop shortcuts u -> x (x a neighbour's neighbour,
    not adjacent to u) at 0.9 x the two-hop length: a road batch of
    repaired and new segments, ⊕-improving under min_plus."""
    eu = g.edge_sources()
    idx = rng.choice(g.m, size=reweights, replace=False)
    batch = [(int(eu[i]), int(g.indices[i]), float(g.weights[i]) * 0.5)
             for i in idx]
    while len(batch) < reweights + inserts:
        u = int(rng.integers(g.n))
        nbr, w1 = g.neighbors(u), g.edge_weights(u)
        if nbr.size == 0:
            continue
        j = int(rng.integers(nbr.size))
        v = int(nbr[j])
        far, w2 = g.neighbors(v), g.edge_weights(v)
        k = int(rng.integers(far.size))
        x = int(far[k])
        if x != u and x not in set(nbr.tolist()):
            batch.append((u, x, 0.9 * float(w1[j] + w2[k])))
    return batch


def phase_updates(sssp, srcs, rng) -> int:
    """Phase 9 (module docstring). Returns the kernel's launches."""
    label = f"update sssp x{len(srcs)}"
    r, _, launches = counted_query(sssp, srcs, f"{label} base")
    batch = monotone_batch(sssp.graph, rng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cq2, delta = sssp.update(batch)
    torch.cuda.synchronize()
    upd_s = time.perf_counter() - t0
    require(delta.monotone and not delta.shape_changed,
            f"{label}: the reweight + shortcut batch is not a monotone "
            f"value-only update ({delta.monotone}, {delta.shape_changed})")
    w, w_wall, n = counted_query(cq2, srcs, f"{label} warm", warm=r)
    launches += n
    s, s_wall, n = counted_query(cq2, srcs, f"{label} scratch")
    launches += n
    require(np.array_equal(w.attrs, s.attrs),
            f"{label}: warm and scratch results differ")
    log(f"{label}: monotone batch of {len(batch)} edges, update() "
        f"{upd_s:.3f} s, {delta.n_blocks_rebuilt} blocks rebuilt, "
        f"shape_changed {delta.shape_changed}, "
        f"{delta.affected_src.size} sources seeded; warm steps "
        f"{np.asarray(w.steps).tolist()} in {w_wall:.3f} s vs scratch "
        f"{np.asarray(s.steps).tolist()} in {s_wall:.3f} s; launches follow "
        "the replay accounting on every query")
    check(w, f"{label} warm (bit-equal to scratch)")

    eu = cq2.graph.edge_sources()
    idx = rng.choice(cq2.graph.m, size=16, replace=False)
    dels = [(int(eu[i]), int(cq2.graph.indices[i]), None) for i in idx]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cq3, delta3 = cq2.update(dels)
    torch.cuda.synchronize()
    upd3_s = time.perf_counter() - t0
    require(not delta3.monotone,
            f"{label}: a batch of deletions reads as monotone")
    w3, w3_wall, n = counted_query(cq3, srcs, f"{label} after deletes",
                                   warm=w)
    launches += n
    log(f"{label}: 16 deletions, update() {upd3_s:.3f} s, "
        f"{delta3.n_blocks_rebuilt} blocks rebuilt, shape_changed "
        f"{delta3.shape_changed}; warm='auto' recomputed from scratch in "
        f"{np.asarray(w3.steps).tolist()} steps, {w3_wall:.3f} s")
    check(w3, f"{label} after deletes")
    always = dataclasses.replace(cq3, plan=dataclasses.replace(
        cq3.plan, warm="always"))
    try:
        always.query(srcs, warm=w)
    except ValueError as e:
        log(f"{label}: warm='always' refused the deletions: {e}")
    else:
        raise RuntimeError(f"{label}: warm='always' resumed across a "
                           "non-monotone batch")
    return launches


def phase_trace(sssp, bfs, srcs) -> int:
    """Phase 10 (module docstring). Returns the kernel's launches."""
    launches = 0
    for cq, q, label in ((sssp, srcs, f"trace sssp x{len(srcs)}"),
                         (bfs, 0, "trace bfs")):
        r, wall, n = counted_query(cq, q, f"{label} untraced")
        rt, t_wall, nt = counted_query(cq, q, label, trace=True)
        launches += n + nt
        require(np.array_equal(r.attrs, rt.attrs)
                and np.array_equal(r.steps, rt.steps),
                f"{label}: traced and untraced results differ")
        disp = rt.telemetry.dispatches[0]
        tr, nb = disp.trace, cq.engine.bg.bsrc.numel()
        require(len(tr) == int(np.max(r.steps)) and not disp.truncated,
                f"{label}: {len(tr)} trace rows for {np.max(r.steps)} "
                "steps")
        require(bool(((tr.blocks_fetched + tr.blocks_skipped) == nb).all()),
                f"{label}: fetched + skipped != {nb} blocks on some row")
        with tempfile.TemporaryDirectory() as tmp:
            path = write_chrome_trace(str(Path(tmp) / "trace.json"), rt)
            with open(path) as f:
                doc = json.load(f)
        spans = [e for e in doc["traceEvents"]
                 if e.get("name", "").startswith("step ")]
        require(len(spans) == len(tr),
                f"{label}: {len(spans)} step spans in the Chrome trace")
        bf = tr.blocks_fetched
        log(f"{label}: {len(tr)} rows, traced/untraced wall "
            f"{t_wall:.3f} / {wall:.3f} s = {t_wall / wall:.3f}, blocks "
            f"fetched per step min {int(bf.min())} median "
            f"{float(np.median(bf)):.1f} max {int(bf.max())} of {nb}, "
            f"mean active tiles {float(tr.active_tiles.mean()):.1f} of "
            f"{cq.engine.bg.ntiles}; Chrome trace of {len(spans)} step "
            "spans read back")
    return launches


def zipf_stream(rng, pool, n: int):
    """`n` (algo, src) requests, bfs and sssp alternating, sources drawn
    from `pool` by a Zipf (s = 1.1) rank law."""
    ranks = np.minimum(rng.zipf(1.1, size=n), len(pool)) - 1
    return [(("bfs", "sssp")[i % 2], int(pool[k]))
            for i, k in enumerate(ranks)]


def phase_serving(g, rng) -> int:
    """Phase 11 (module docstring). Returns the kernel's launches."""
    srv = AsyncGraphServer(g, batch=8, segment_steps=4)
    for algo in ("bfs", "sssp"):
        srv.session(algo)                  # build both layouts up front
    pool = rng.choice(g.n, size=24, replace=False)
    streams = [zipf_stream(rng, pool, 64), zipf_stream(rng, pool, 32)]
    batch = monotone_batch(g, rng)
    relax.frontier_relax_cuda.launches = 0
    versions, walls, upd_s = [], [], 0.0
    for i, stream in enumerate(streams):
        if i:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.update(batch)
            torch.cuda.synchronize()
            upd_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = srv.serve(stream)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        versions.append(({a: srv.session(a) for a in ("bfs", "sssp")},
                         reqs))
    launches = relax.frontier_relax_cuda.launches
    st = srv.stats()
    iters = st["metrics"]["histograms"]["window_iters"]
    replay_accounting("serving", launches, int(iters["sum"]),
                      int(iters["count"]))
    require(all(x.is_cuda for rb in srv._batches.values()
                for x in rb.state),
            "serving: a rotating-batch state tensor is not on CUDA")
    reqs = [r for _, rs in versions for r in rs]
    bad = [(r.req_id, r.error) for r in reqs if not r.ok]
    require(not bad and st["failed"] == st["shed"] == 0,
            f"serving: {len(bad)} requests not ok, failed {st['failed']}, "
            f"shed {st['shed']}: {bad[:3]}")
    warm = sum(r.warm_started for r in versions[1][1])
    require(warm > 0, "serving: no request warm-started after the update")

    # every result against one batched query per algebra and version
    # (comparison launches, outside the count above)
    checked = 0
    for sessions, rs in versions:
        for algo, cq in sessions.items():
            mine = [r for r in rs if r.algo == algo]
            distinct = sorted({r.src for r in mine})
            ref = cq.query(distinct)
            row = {s: i for i, s in enumerate(distinct)}
            for r in mine:
                # a warm start (or a hit on one) takes fewer steps than
                # scratch, to the same fixpoint
                cold = not (r.warm_started or r.cache_hit)
                require(np.array_equal(r.result, ref.attrs[row[r.src]])
                        and (r.steps == int(ref.steps[row[r.src]])
                             or not cold),
                        f"serving: request {r.req_id} ({algo}, src "
                        f"{r.src}) differs from the batched query")
            require(cq.program.check(cq.graph, mine[0].src,
                                     mine[0].result),
                    f"serving: {algo} src {mine[0].src} fails check()")
            checked += 1
    m = st["metrics"]["histograms"]
    nq = len(reqs)
    lat = " ".join(
        f"{a} p50/p95/p99 {m[f'latency_s.{a}']['p50'] * 1e3:.1f}/"
        f"{m[f'latency_s.{a}']['p95'] * 1e3:.1f}/"
        f"{m[f'latency_s.{a}']['p99'] * 1e3:.1f} ms, queue wait p50/p95 "
        f"{m[f'queue_wait_s.{a}']['p50'] * 1e3:.1f}/"
        f"{m[f'queue_wait_s.{a}']['p95'] * 1e3:.1f} ms;"
        for a in ("bfs", "sssp"))
    # lane occupancy: steps the lanes took over the lane-steps offered
    occ = ((m["steps.bfs"]["sum"] + m["steps.sssp"]["sum"])
           / max(1.0, 8 * iters["sum"]))
    log(f"serving: {nq} requests ({len(streams[0])} + update + "
        f"{len(streams[1])}) in {sum(walls):.3f} s = "
        f"{nq / sum(walls):.2f} queries/s (update() {upd_s:.3f} s); {lat} "
        f"{st['windows']} windows, {int(iters['sum'])} iterations, "
        f"launches {launches}, lane occupancy {occ:.3f}, cache hit rate "
        f"{st['cache']['hit_rate']:.3f}, {warm} warm starts; all equal "
        f"their batched queries, {checked} pass check()")

    # a profiled burst of 16 fresh sources (not counted above)
    from torch.profiler import ProfilerActivity, profile
    fresh = [int(s) for s in rng.choice(g.n, size=64, replace=False)
             if s not in set(pool.tolist())][:16]
    w0 = srv.windows
    torch.cuda.synchronize()
    with spans_off(), profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        burst = srv.serve([(("bfs", "sssp")[i % 2], s)
                           for i, s in enumerate(fresh)])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    require(all(r.ok for r in burst), "serving: a burst request failed")
    rows = [(e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    nwin = srv.windows - w0
    if rows:
        busy = sum(ms for ms, _ in rows)
        log(f"serving profile: 16 requests, {nwin} windows, wall "
            f"{wall_ms:.1f} ms, device busy {busy:.1f} ms "
            f"({busy / wall_ms:.1%}), {sum(c for _, c in rows) / nwin:.1f} "
            f"device ops/window, {wall_ms / nwin:.3f} ms/window")
    else:
        log("serving profile: device time not measured (no device events)")
    return launches


# ------------------------------------------------------------------ #
# the device loop against the host loop (22)
# ------------------------------------------------------------------ #
HOST_LOOP_DEADLINE_S = 1e6    # a finite deadline routes a query through
                              # the host loop (the reference's rule)


@contextlib.contextmanager
def counted_reads():
    """Count the device->host copies (`Tensor.cpu`) made inside the
    block: the fixpoint's reads and the result's one."""
    reads = [0]
    cpu = torch.Tensor.cpu

    def counted(self, *a, **k):
        if self.is_cuda:
            reads[0] += 1
        return cpu(self, *a, **k)
    with mock.patch.object(torch.Tensor, "cpu", counted):
        yield reads


@contextlib.contextmanager
def deadline_host_loop():
    """A deadline far in the future routes a query through the host loop
    (the reference's rule). Yields the query's keywords."""
    yield {"deadline_s": HOST_LOOP_DEADLINE_S}


@contextlib.contextmanager
def forced_host_loop():
    """Route every fixpoint to the host loop by patching `fixpoint_route`,
    in this script alone (the package has no such knob): the distributed
    fixpoint refuses deadlines. Yields the query's keywords (none)."""
    with mock.patch.object(engine_mod, "fixpoint_route",
                           lambda *a, **k: "host"):
        yield {}


def loops_in_turns(label, cq, q, host_loop) -> tuple[int, dict, object]:
    """Query `q` of `cq` on the captured device loop and, inside
    `host_loop()`, on the host loop, in turns (device, host, host,
    device): attrs, steps and the converged mask bit-equal; the host loop
    one launch and one device->host read per iteration (+1 read at its
    exit, +1 for the result), the device loop one read per replayed chunk
    (+1 for the result). Logs ms/step, queries/s, the busy share from
    torch.profiler over one more query of each loop, reads per query and
    launches, beside nvidia-smi's name and power limit. Returns the
    launches, the row of numbers and the device loop's first result."""
    b = int(np.size(q))
    launches = 0
    walls, first = {"device": [], "host": []}, {}
    for route in ("device", "host", "host", "device"):
        ctx = (host_loop() if route == "host"
               else contextlib.nullcontext({}))
        with ctx as kw, counted_reads() as reads:
            r, wall, n = counted_query(cq, q, f"{label} {route} loop", **kw)
        launches += n
        walls[route].append(wall)
        first.setdefault(route, (r, reads[0], n))
    (rd, reads_d, n_d), (rh, reads_h, n_h) = first["device"], first["host"]
    require(np.array_equal(rd.attrs, rh.attrs)
            and np.array_equal(rd.steps, rh.steps)
            and np.array_equal(rd.converged, rh.converged),
            f"{label}: the captured loop differs from the host loop")
    iters = int(np.max(rd.steps))
    require(n_h == iters and reads_h == iters + 2,
            f"{label}: the host loop made {n_h} launches and {reads_h} "
            f"reads for {iters} iterations")
    require(reads_d == -(-n_d // DEVICE_CHUNK) + 1,
            f"{label}: the captured loop made {reads_d} reads for "
            f"{n_d} launches")
    busy = {}
    for route in ("device", "host"):
        ctx = (host_loop() if route == "host"
               else contextlib.nullcontext({}))
        with ctx as kw:
            busy[route] = profile_query(cq, q, f"{label} {route} loop", **kw)
    row = {}
    for route, reads in (("device", reads_d), ("host", reads_h)):
        w = walls[route]
        row[route] = {
            "ms_per_step": [x / iters * 1e3 for x in w],
            "queries_per_s": [b / x for x in w],
            "busy_share": busy[route], "reads_per_query": reads,
            "launches": n_d if route == "device" else n_h}
        log(f"{label} {route} loop: {iters} iterations, walls "
            + ", ".join(f"{x:.4f}" for x in w) + " s = "
            + ", ".join(f"{x / iters * 1e3:.4f}" for x in w)
            + " ms/step = "
            + ", ".join(f"{b / x:.3f}" for x in w)
            + " queries/s; device busy "
            + ("not measured" if busy[route] is None
               else f"{busy[route]:.1%}")
            + f"; {reads} device->host reads per query; launches "
            f"{row[route]['launches']} ({SMI[0]})")
    return launches, dict(row, iterations=iters), rd


def phase_device_loop(g, sssp, bfs, srcs, rng) -> tuple[int, dict]:
    """Phase 22 (module docstring). Returns the kernel's launches and,
    per query, the captured loop's and the host loop's numbers."""
    launches, found = 0, {}
    cases = (("sssp x8", sssp, srcs), ("bfs", bfs, 0),
             ("bfs/op", flip_torch.compile(
                 g, "bfs", flip_torch.ExecutionPlan(mode="op")), 0))
    for label, cq, q in cases:
        n, found[label], _ = loops_in_turns(label, cq, q,
                                            deadline_host_loop)
        launches += n

    # a query after apply_updates replays only its own engine's graphs
    r = sssp.query(srcs)
    old = sssp.engine.__dict__.get("_captured", {})
    require(old, "sssp x8: phase 4's session captured no graph")
    cq2, _ = sssp.update(monotone_batch(g, rng))
    require("_captured" not in cq2.engine.__dict__,
            "the updated engine carries the old engine's graphs")
    seen = []
    replay = FlipEngine._replay

    def spy(self, loop, n):
        seen.append((self, loop))
        return replay(self, loop, n)
    with mock.patch.object(FlipEngine, "_replay", spy):
        w, _, n = counted_query(cq2, srcs, "update sssp warm", warm=r)
        s2, _, n2 = counted_query(cq2, srcs, "update sssp scratch")
    launches += n + n2
    mine = cq2.engine.__dict__.get("_captured", {}).values()
    require(seen and all(e is cq2.engine
                         and any(loop is x for x in mine)
                         and not any(loop is x for x in old.values())
                         for e, loop in seen),
            "a query after apply_updates replayed a graph it did not "
            "capture")
    require(np.array_equal(w.attrs, s2.attrs),
            "update sssp: warm and scratch differ on the device loop")
    log(f"apply_updates: {len(seen)} replays after the update, every one "
        f"of a graph the new engine captured ({len(old)} captured on the "
        "old engine, none replayed); warm = scratch bit for bit")
    return launches, found


# ------------------------------------------------------------------ #
# the FLIP mapping and cycle simulator (12), the bucket server (13)
# ------------------------------------------------------------------ #
def graph_run_main(argv: list[str]) -> str:
    """`graph_run.main(argv)` with its stdout captured and logged."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        graph_run.main(argv)
    out = buf.getvalue()
    for ln in out.splitlines():
        log(f"  {ln}")
    return out


def phase_mapping(rng) -> int:
    """Phase 12 (module docstring). Returns the kernel's launches."""
    g = next(make_dataset("LRN", 1, seed0=0))
    srcs = np.sort(rng.choice(g.n, size=8, replace=False))
    launches = 0
    for algo in ("bfs", "sssp", "wcc"):
        alg = ALGEBRAS[algo]
        t0 = time.perf_counter()
        m = compile_mapping(g, effort=1, program=alg)
        map_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = simulate(m, alg, src=0)
        sim_s = time.perf_counter() - t0
        ref, _ = reference.run(algo, g, 0)
        require(alg.results_match(r.attrs, ref),
                f"sim {algo}: the simulated result disagrees with the oracle")
        t_f = r.cycles / m.arch.freq_mhz
        mcu = baselines.mcu_cycles(algo, g, 0)
        cgra = baselines.cgra_cycles(algo, g, 0)
        log(f"sim {algo} LRN |V|={g.n} |E|={g.m}: mapping (effort 1) "
            f"{map_s:.1f} s on the host, avg routing length "
            f"{m.avg_routing_length():.3f}; simulated FLIP fabric at "
            f"{m.arch.freq_mhz:.0f} MHz, computed on the host (not card "
            f"time): {r.cycles} cycles = {t_f:.2f} us, parallelism avg "
            f"{r.avg_parallelism:.2f} max {r.max_parallelism}, "
            f"{g.m / t_f:.1f} MTEPS, pkt wait {r.avg_pkt_wait:.2f} cycles, "
            f"swaps {r.swaps}; simulated speedup vs MCU "
            f"{mcu.time_us / t_f:.1f}x, vs op-centric CGRA "
            f"{cgra.time_us / t_f:.1f}x; oracle match (sim {sim_s:.2f} s)")
        order = mapping_order(m)
        for tile in (128, 32):
            plan = flip_torch.ExecutionPlan(tile=tile)
            ido = flip_torch.compile(g, algo, plan)
            mo = flip_torch.compile(g, algo, plan, mapping=m)
            require(np.array_equal(mo.engine.bg.inv_perm, order),
                    f"{algo} T={tile}: the session is not in mapping order")
            label = f"{algo} x{len(srcs)} T={tile}"
            a, a_wall, n1 = counted_query(ido, srcs, f"{label} id order")
            b, b_wall, n2 = counted_query(mo, srcs,
                                          f"{label} mapping order")
            launches += n1 + n2
            require(np.array_equal(a.attrs, b.attrs)
                    and np.array_equal(a.steps, b.steps),
                    f"{label}: mapping order differs from id order")
            check(b, f"{label} mapping order")
            log(f"{label}: blocks id order {ido.engine.bg.bsrc.numel()}, "
                f"mapping order {mo.engine.bg.bsrc.numel()} "
                f"({mo.engine.bg.ntiles} tiles); steps "
                f"{np.asarray(b.steps).tolist()}, bit-equal to id order; "
                f"launches {n2}; wall {b_wall * 1e3:.1f} ms "
                f"(id order {a_wall * 1e3:.1f} ms)")
    for engine in ("sim", "jax"):
        relax.frontier_relax_cuda.launches = 0
        out = graph_run_main(["--engine", engine, "--dataset", "SRN"])
        require("[graph] correct vs reference: True" in out,
                f"graph_run --engine {engine}: no correct self-check")
        n = relax.frontier_relax_cuda.launches
        if engine == "jax":
            steps = int(out.split("fixpoint in ", 1)[1].split()[0])
            replay_accounting("graph_run --engine jax", n, steps, 1)
        else:
            require(n == 0, "graph_run --engine sim launched the kernel")
        launches += n
    return launches


def bucket_dispatches(items, b: int) -> int:
    """Bucket dispatches a `GraphServer(batch=b)` makes for a stream:
    one per full bucket, and one per non-empty bucket at each update
    (which drains first) and at the end."""
    n, pending = 0, {}
    for algo, _ in items + [("update", None)]:
        if algo == "update":
            n += sum(1 for k in pending.values() if k)
            pending = {}
            continue
        pending[algo] = pending.get(algo, 0) + 1
        if pending[algo] == b:
            n += 1
            pending[algo] = 0
    return n


def served_launches(srv, label: str) -> int:
    """The kernel's launches since the count was set to 0, held to the
    replay accounting of the server's fixpoints (every dispatch, retries
    included)."""
    launches = relax.frontier_relax_cuda.launches
    hist = srv.metrics.histogram("dispatch_iters")
    replay_accounting(label, launches, int(hist.total), int(hist.count))
    return launches


def nan_road_copy(g, src: int):
    """`g` with one NaN weight, on an out-edge of `src` (so every query
    from `src` relaxes it in its first step)."""
    w = g.weights.copy()
    w[int(g.indptr[src])] = np.float32("nan")
    return dataclasses.replace(g, weights=w)


def phase_bucket_server(g, rng) -> int:
    """Phase 13 (module docstring). Returns the kernel's launches."""
    for algo in ("bfs", "sssp"):
        chain = fallback_chain(flip_torch.ExecutionPlan(batch=8),
                               ALGEBRAS[algo])
        rungs = [(p.relax_mode, p.compact) for p in chain]
        require(rungs == [("cuda", True), ("cuda", False)],
                f"{algo}: the card's ladder is {rungs}")
    log("ladder on the card: [cuda+compact, cuda+dense] for bfs and sssp")
    pool = rng.choice(g.n, size=24, replace=False)
    stream = zipf_stream(rng, pool, 48)
    items = stream[:24] + [("update", monotone_batch(g, rng))] + stream[24:]
    n_disp = bucket_dispatches(items, 8)
    specs = FaultInjector.random(seed=0, dispatches=n_disp, rate=0.25,
                                 stall_s=1.0).specs
    # the seeded schedule, plus one NaN and one stall pinned where it left
    # room, so every fault kind runs (as the reference's chaos test does)
    free = [d for d in range(n_disp) if d not in {f.dispatch for f in specs}]
    specs += [FaultSpec(kind="nan", dispatch=free[0]),
              FaultSpec(kind="stall", dispatch=free[1], stall_s=1.0)]
    inj = FaultInjector(specs=specs, seed=0)
    flagged = []                  # dispatch ordinal at each stall flag
    hb = HeartbeatMonitor(
        timeout_s=0.5,
        on_stall=lambda: flagged.append(srv._dispatch_seq - 1))
    srv = GraphServer(g, batch=8, fault_injector=inj, heartbeat=hb)
    for algo in ("bfs", "sssp"):
        srv.session(algo)                  # build both layouts up front
    hb.beat()
    hb.start()
    relax.frontier_relax_cuda.launches = 0
    versions, reqs = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for algo, arg in items:
            if algo == "update":
                versions.append(({a: srv.session(a) for a in ("bfs", "sssp")},
                                 reqs))
                srv.update(arg)
                reqs = []
            else:
                reqs.append(srv.submit(algo, arg))
        srv.drain()
        torch.cuda.synchronize()
    finally:
        hb.stop()
    wall = time.perf_counter() - t0
    versions.append(({a: srv.session(a) for a in ("bfs", "sssp")}, reqs))
    launches = served_launches(srv, "bucket server")
    st = srv.stats()
    allreq = [r for _, rs in versions for r in rs]
    bad = [(r.req_id, r.error) for r in allreq if not r.ok]
    require(len(allreq) == 48 and not bad,
            f"bucket server: {len(bad)} requests not ok: {bad[:3]}")
    require(srv._dispatch_seq == n_disp,
            f"bucket server: {srv._dispatch_seq} dispatches, expected "
            f"{n_disp}")
    fired = sorted((f["dispatch"], f["kind"]) for f in inj.fired)
    require(fired == sorted((f.dispatch, f.kind) for f in specs)
            and st["resilience"]["faults_fired"] == len(specs),
            f"bucket server: faults fired {fired}, schedule "
            f"{[(f.dispatch, f.kind) for f in specs]}")
    n_err = sum(f.kind in ("raise", "nan") for f in specs)
    snap = st["metrics"]["counters"]
    require(snap.get("dispatch_errors.backend_failure", 0) == n_err
            and snap.get("fallback_rung.1", 0) == n_err
            and st["resilience"]["fallbacks"] == n_err,
            f"bucket server: {n_err} raise/nan faults but counters {snap}")
    stalls = sorted(f.dispatch for f in specs if f.kind == "stall")
    require(set(stalls) <= set(flagged) and hb.stall_count >= len(stalls),
            f"bucket server: stalls at {stalls}, heartbeat flagged "
            f"{flagged}")
    served_by = sorted({r.rung for r in allreq})
    require(served_by == [0, 1], f"bucket server: rungs {served_by}")

    # every result against one batched query per algebra and version
    # (comparison launches, outside the count above)
    for sessions, rs in versions:
        for algo, cq in sessions.items():
            mine = [r for r in rs if r.algo == algo]
            distinct = sorted({r.src for r in mine})
            ref = cq.query(distinct)
            row = {s: i for i, s in enumerate(distinct)}
            for r in mine:
                require(np.array_equal(r.result, ref.attrs[row[r.src]])
                        and r.steps == int(ref.steps[row[r.src]]),
                        f"bucket server: request {r.req_id} ({algo}, src "
                        f"{r.src}) differs from the batched query")
            require(cq.program.check(cq.graph, mine[0].src, mine[0].result),
                    f"bucket server: {algo} src {mine[0].src} fails check()")
    h = st["metrics"]["histograms"]
    log(f"bucket server: 48 requests + 1 update in {wall:.3f} s "
        f"({48 / wall:.2f} queries/s, stalls included) over {n_disp} "
        f"dispatches of B=8; faults fired {fired}; "
        f"{n_err} served by rung 1, {len(stalls)} stall(s) flagged by the "
        f"heartbeat (flags at dispatches {flagged}); launches {launches} "
        f"for the dispatches' iterations; latency p50/p95 "
        f"{h['latency_s.sssp']['p50'] * 1e3:.1f}/"
        f"{h['latency_s.sssp']['p95'] * 1e3:.1f} ms (sssp), "
        f"{h['latency_s.bfs']['p50'] * 1e3:.1f}/"
        f"{h['latency_s.bfs']['p95'] * 1e3:.1f} ms (bfs); every request "
        "equals its batched query bit for bit")

    # NaN weights: every rung trips the finite guard on the card
    with np.errstate(invalid="ignore"):    # numpy's ⊕.at over a NaN weight
        return launches + nan_servers(g, pool)


def nan_servers(g, pool) -> int:
    """Phase 13's NaN part: the 6-vertex NaN graph on the card against
    the CPU, then servers over it and over a copy of `g` with one NaN
    weight, where every rung trips the finite guard. Returns the
    kernel's launches."""
    launches = 0
    nan = float("nan")
    g6 = Graph.from_edges(6, [(0, 1), (1, 2), (2, 3), (0, 4), (4, 3),
                              (3, 5)], [1, nan, 1, 5, 1, 1])
    for algo in ("sssp", "widest"):
        card = flip_torch.compile(g6, algo).query(0)
        cpu = flip_torch.compile(g6, algo, device="cpu").query(0)
        require(np.array_equal(card.attrs, cpu.attrs, equal_nan=True)
                and card.steps == cpu.steps,
                f"6-vertex NaN graph {algo}: card {card.attrs} != cpu "
                f"{cpu.attrs}")
        log(f"6-vertex NaN graph {algo}: card == cpu, NaN positions "
            f"included: {card.attrs.tolist()}")
    src = int(pool[0])
    for label, graph, algos, srcs in (
            ("6-vertex", g6, ("sssp", "widest"), [0, 3]),
            ("road NaN copy", nan_road_copy(g, src), ("sssp",),
             [src] + [int(x) for x in pool[1:8]])):
        srv = GraphServer(graph, batch=len(srcs))
        relax.frontier_relax_cuda.launches = 0
        reqs = [srv.submit(a, s) for a in algos for s in srcs]
        srv.drain()
        torch.cuda.synchronize()
        n = served_launches(srv, f"{label} server")
        launches += n
        runs = srv.metrics.histogram("dispatch_iters").count
        require(all(r.done and isinstance(r.error, BackendFailure)
                    and r.result is None for r in reqs)
                and srv.failed == len(reqs)
                and runs == 2 * len(algos),
                f"{label} server: not every request failed typed after "
                f"both rungs ({runs} runs)")
        log(f"{label} server: {len(reqs)} requests, {runs} runs (every "
            f"rung tripped finite_guard), all carry BackendFailure "
            f"('{reqs[0].error}'), none lost; launches {n}")
    return launches


# ------------------------------------------------------------------ #
# the plan autotuner (14)
# ------------------------------------------------------------------ #
def id_order_blocks(g, tile: int) -> int:
    """Weight blocks of `g` at `tile` in id order, as `build_blocks`
    counts them: the distinct (destination, source) tile pairs of the
    edges plus the diagonal."""
    nt = max(1, -(-g.n // tile))
    key = (g.indices.astype(np.int64) // tile) * nt \
        + g.edge_sources() // tile
    return int(np.union1d(key, np.arange(nt, dtype=np.int64) * (nt + 1))
               .size)


def segment_iters(cq, graph) -> tuple[int, int]:
    """(iterations, summed query steps) of one capped tuning segment on
    `graph`: the tuner's probe sources (seed 0) for `SEGMENT_STEPS` steps
    through `cq`. The fixpoint's steps do not depend on the plan, so
    every candidate's segments run these. Launches outside any count."""
    probe = at_measure.probe_sources(graph, 0, at_measure.PROBE_SOURCES)
    r = cq.query(probe, max_steps=at_measure.SEGMENT_STEPS)
    return int(np.max(r.steps)), int(np.sum(r.steps))


def bucket_iters(steps, b: int) -> int:
    """Fixpoint iterations of a query dispatched in buckets of `b` (0 =
    one dispatch): the sum of each bucket's longest query."""
    steps = np.atleast_1d(steps)
    b = b or steps.size
    return int(sum(steps[i:i + b].max() for i in range(0, steps.size, b)))


def tuned_launches(label: str, samples, seg: tuple[int, int]) -> int:
    """The kernel's launches since the count was set to 0, held to the
    replay accounting of the sweep's segments: one warm-up and `REPEATS`
    timed segments per measured engine (bucket widths on one engine
    share its segments), `seg[0]` iterations each."""
    engines = len({at_measure.engine_key(s.plan) for s in samples
                   if s.source == "measured"})
    segments = engines * (1 + at_measure.REPEATS)
    n = relax.frontier_relax_cuda.launches
    replay_accounting(f"{label} ({engines} engines x "
                      f"{1 + at_measure.REPEATS} segments x {seg[0]})", n,
                      segments * seg[0], segments)
    return n


def phase_autotune(g, srcs, sssp, bfs, sssp_r) -> int:
    """Phase 14 (module docstring). Returns the kernel's launches."""
    prof = profile_graph(g, feature_dim=1)
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        store = TuningStore(str(Path(tmp) / "autotune_torch.json"))
        # a fully measured sweep: sssp over tiles 64 / 128 / 256
        seg = segment_iters(sssp, g)
        relax.frontier_relax_cuda.launches = 0
        t0 = time.perf_counter()
        rep = autotune(g, "sssp", flip_torch.ExecutionPlan(), store=store,
                       budget_s=None, seed=0)
        tune_s = time.perf_counter() - t0
        launches += tuned_launches("tune sssp", rep.samples, seg)
        require(sorted(s.plan.tile for s in rep.samples) == [64, 128, 256]
                and all(s.source == "measured" and s.plan.relax_mode == "cuda"
                        and s.steps == seg[1] for s in rep.samples),
                f"tune sssp: not three measured cuda candidates of "
                f"{seg[1]} steps: {[s.to_json() for s in rep.samples]}")
        log(f"tune sssp (road-262k, budget none): {tune_s:.3f} s, "
            f"{len(rep.samples)} candidates, each {1 + at_measure.REPEATS} "
            f"segments of {seg[0]} iterations ({seg[1]} query steps); "
            f"launches {relax.frontier_relax_cuda.launches}")
        for s in rep.samples:
            t = s.plan.tile
            log(f"  tile {t:3d} compact {s.plan.compact}: {s.step_us:.3f} "
                f"us/step, best segment {s.wall_s * 1e3:.3f} ms, "
                f"{id_order_blocks(g, t)} blocks (analytic model "
                f"{at_measure.expected_blocks(g.n, g.m, t):.0f}; gate "
                f"estimate {at_measure.estimated_measure_s(prof, s.plan):.3f}"
                f" s) [{s.source}]")
        log(f"tune sssp: {rep.why}")

        # the chosen plan answers as the default: phase 4's sssp x8
        cq = flip_torch.compile(g, "sssp", rep.chosen)
        r, wall, n = counted_query(cq, srcs, f"tuned sssp x{len(srcs)}")
        launches += n
        require(np.array_equal(r.attrs, sssp_r.attrs)
                and np.array_equal(r.steps, sssp_r.steps),
                "tuned sssp: the chosen plan's result differs from phase 4's")
        log(f"tuned sssp x{len(srcs)} (tile {cq.plan.tile}): bit-equal to "
            f"phase 4, steps included; wall {wall:.3f} s, launches {n}")
        check(r, "tuned sssp")
        del cq

        # the session surface: bfs, tuned=True, batch=8, default budget
        plan = flip_torch.ExecutionPlan.auto(tuned=True, batch=8)
        seg = segment_iters(bfs, g)
        want = bfs.query(srcs)               # comparison, outside the count
        relax.frontier_relax_cuda.launches = 0
        t0 = time.perf_counter()
        cq = flip_torch.compile(g, "bfs", plan, store=store)
        compile_s = time.perf_counter() - t0
        tune = cq.tune
        require(not tune.cached, "tune bfs: a store hit in a fresh store")
        launches += tuned_launches("tune bfs", tune.samples, seg)
        log(f"tune bfs (tuned=True, batch=8, budget "
            f"{DEFAULT_BUDGET_S} s): compile {compile_s:.3f} s; "
            + ", ".join(f"T={s.plan.tile}/B={s.plan.batch} {s.source} "
                        f"{s.step_us:.3f} us (gate "
                        f"{at_measure.estimated_measure_s(prof, s.plan):.3f} s)"
                        for s in tune.samples))
        log(f"tune bfs: {tune.why}")
        for trace in (False, True):
            relax.frontier_relax_cuda.launches = 0
            r = cq.query(srcs, trace=trace)
            torch.cuda.synchronize()
            n = relax.frontier_relax_cuda.launches
            iters = bucket_iters(r.steps, cq.plan.batch)
            replay_accounting(f"tuned bfs (trace={trace})", n, iters,
                              -(-len(srcs) // (cq.plan.batch or len(srcs))))
            launches += n
            require(np.array_equal(r.attrs, want.attrs)
                    and np.array_equal(r.steps, want.steps),
                    f"tuned bfs (trace={trace}): differs from the untuned "
                    "session")
            if trace:
                metas = [d.meta.get("autotune")
                         for d in r.telemetry.dispatches]
                require(all(m is not None and m["chosen"]["tile"]
                            == cq.plan.tile and m["why"] == tune.why
                            for m in metas),
                        "tuned bfs: a traced dispatch lacks its autotune "
                        "stamp")
        log(f"tuned bfs x{len(srcs)} (tile {cq.plan.tile}, batch "
            f"{cq.plan.batch}): bit-equal to the untuned session, steps "
            f"included, traced too; {len(metas)} dispatch records carry "
            "meta['autotune']")
        check(r, "tuned bfs")
        del cq
        relax.frontier_relax_cuda.launches = 0
        t0 = time.perf_counter()
        cq = flip_torch.compile(g, "bfs", plan, store=store)
        hit_s = time.perf_counter() - t0
        require(cq.tune.cached and relax.frontier_relax_cuda.launches == 0,
                f"tune bfs again: cached {cq.tune.cached}, "
                f"{relax.frontier_relax_cuda.launches} launches")
        log(f"tune bfs again: store hit in {hit_s:.3f} s (layout build "
            "included), no kernel launch")
        del cq

        # the CLI, its store in the same temporary directory
        srn = next(make_dataset("SRN", 1, seed0=0))
        seg = segment_iters(flip_torch.compile(srn, "sssp"), srn)
        relax.frontier_relax_cuda.launches = 0
        with mock.patch.dict(os.environ, FLIP_TORCH_AUTOTUNE_DB=str(
                Path(tmp) / "cli.json")):
            out = graph_run_main(["--dataset", "SRN", "--algo", "sssp",
                                  "--autotune", "--effort", "0"])
        require("[graph] correct vs reference: True" in out
                and "[graph] autotune: measured sweep over 3 candidates"
                in out, "graph_run --autotune: no tuned, correct run")
        steps = int(out.split("fixpoint in ", 1)[1].split()[0])
        n = relax.frontier_relax_cuda.launches
        segments = 3 * (1 + at_measure.REPEATS)
        replay_accounting("graph_run --autotune (sweep and query)", n,
                          segments * seg[0] + steps, segments + 1)
        launches += n
    return launches


# ------------------------------------------------------------------ #
# the LM kernels: flash attention (K2) and the SSD intra-chunk form (K3)
# ------------------------------------------------------------------ #
ATTN_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ATTN_REL_TOL = 1e-2           # bf16 at the qwen3 layer, relative Frobenius
SSD_ATOL = 1e-4               # scaled by max(1, max|ref|)
LM_BATCH, LM_SEQ = 4, 4_096   # the prefill cell (prefill_32k cut to fit)
KERNELS = (relax.frontier_relax_cuda, flash.flash_attention_cuda,
           flash.flash_attention_bwd_cuda, ssd.ssd_intra_cuda,
           ssd.ssd_intra_bwd_cuda)
REPLAY_LEN = 256              # float32 prefill-vs-decode prompt
# an MoE's replay prompt: at T <= 8 tokens the capacity (8) holds every
# (token, choice) pair, so prefill drops none, as decode (one token a
# step) never does; at 256 tokens C = 64 against a mean load of 51.2 per
# expert, prefill drops pairs and the replay is no identity
MOE_REPLAY_LEN = 8
GRANITE = "granite_moe_3b_a800m"
HUBERT = "hubert_xlarge"
QWEN3_MOE = "qwen3_moe_235b_a22b"
JAMBA = "jamba_1_5_large_398b"
MOE_EP_TOL = 1e-2             # bf16, relative to max|y|


def randn(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def attention_check(label: str, q, k, v, causal: bool,
                    window: int | None, quiet: bool = False,
                    rel_tol: float | None = None,
                    fma_errs: list | None = None) -> float:
    """The kernel against `attention_ref` on the same inputs (upcast to
    f32 for a bf16 kernel, as tests/test_kernels_attention.py does); the
    call must take `flash.route`'s route. With `rel_tol`, also holds the
    relative Frobenius error ||out - ref|| / ||ref||. On the "tf32x3" route
    a second call must give the same bits, and the "fma" kernel runs on the
    same inputs (launched directly, not counted), held at the same atol:
    its error goes to `fma_errs` and beside this one in the log."""
    name = flash.route(q.dtype, q.shape[-1])
    before = dict(flash.flash_attention_cuda.route_launches)
    out = flash.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    taken = [r for r, n in flash.flash_attention_cuda.route_launches.items()
             if n != before[r]]
    require(taken == [name], f"attention {label}: took {taken}, not {name}")
    ref = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                        window=window)
    err = float((out.float() - ref).abs().max())
    atol = ATTN_ATOL[q.dtype]
    ok = err <= atol and bool(torch.isfinite(out).all())
    rel = ""
    if rel_tol is not None:
        r = float((out.float() - ref).norm() / ref.norm())
        ok = ok and r <= rel_tol
        rel = f", relative Frobenius {r:.3e} (tol {rel_tol:g})"
    if name == "tf32x3":
        same = torch.equal(out, flash.flash_attention_cuda(
            q, k, v, causal=causal, window=window))
        alt = flash._launch("fma", q, k, v, causal, window)
        alt_err = float((alt - ref).abs().max())
        if fma_errs is not None:
            fma_errs.append(alt_err)
        ok = ok and same and alt_err <= atol
        rel += (f"; a second call bit-equal: {same}; the fma kernel on the "
                f"same inputs: max|err| {alt_err:.3e}")
        del alt
    if not (quiet and ok):
        log(f"attention {label} [{name}]: max|err| {err:.3e} (atol "
            f"{atol:g}){rel}: {ok}")
    require(ok, f"flash attention disagrees with attention_ref: {label}")
    return err


def attention_work(b, s, h, kh, hd, dtype, causal: bool = True) -> dict:
    """FLOPs 4*B*H*S^2*hd (halved when causal) over the bf16 tensor-core
    rate, and q, k, v, out bytes over the memory rate."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * s * h * hd + 2 * b * s * kh * hd) * size
    ops = 4 * b * h * s * s * hd / (2 if causal else 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return {"bytes": nbytes, "ops": ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_attention(gen) -> tuple[float, dict]:
    """Phase 6. Returns the wgmma route's max error and the timing, with
    each route's max error by name (`max_abs_err_by_route`)."""
    errs, fma_errs = [], []
    for dtype, hds in ((torch.float32, (16, 64, 80, 128, 256)),
                       (torch.bfloat16, (64, 80, 128, 256))):
        for hd in hds:
            group, alts = [], []
            for kh in (8, 4, 1):                    # GQA ratio 1, 2, 8
                q = randn(gen, (2, 320, 8, hd), dtype)
                k = randn(gen, (2, 320, kh, hd), dtype)
                v = randn(gen, (2, 320, kh, hd), dtype)
                for causal in (True, False):
                    for window in (None, 128):
                        group.append((flash.route(dtype, hd),
                                      attention_check(
                            f"{str(dtype)[6:]} hd={hd} g={8 // kh} "
                            f"causal={causal} window={window} S=320",
                            q, k, v, causal, window, quiet=True,
                            fma_errs=alts)))
            log(f"attention {str(dtype)[6:]} hd={hd} "
                f"[{flash.route(dtype, hd)}]: 12 cases (GQA ratio 1/2/8 x "
                "causal x window None/128, B=2, S=320, H=8): max|err| "
                f"{max(e for _, e in group):.3e} (atol {ATTN_ATOL[dtype]:g})"
                + (f", each call's bits equal to a second's; the fma kernel "
                   f"on the same inputs {max(alts):.3e}" if alts else ""))
            errs += group
            fma_errs += alts
    # ragged lengths; S=5 is shorter than one tile of any kernel; S != T
    for dtype, hd, n, t, window in ((torch.float32, 32, 200, 200, 50),
                                    (torch.float32, 128, 5, 5, None),
                                    (torch.float32, 128, 200, 328, None),
                                    (torch.float32, 64, 328, 200, None),
                                    (torch.bfloat16, 64, 200, 200, 50),
                                    (torch.bfloat16, 256, 200, 200, 50),
                                    (torch.bfloat16, 128, 5, 5, None)):
        q = randn(gen, (1, n, 4, hd), dtype)
        k = randn(gen, (1, t, 2, hd), dtype)
        v = randn(gen, (1, t, 2, hd), dtype)
        errs.append((flash.route(dtype, hd), attention_check(
            f"{str(dtype)[6:]} hd={hd} ragged S={n} T={t} window={window}",
            q, k, v, True, window, fma_errs=fma_errs)))
    qcfg = configs.get("qwen3_0_6b")
    shape = (qcfg.num_heads, qcfg.num_kv_heads, qcfg.head_dim)
    # every architecture's layer: GQA 3 at hd 64 (granite), hd 80
    # non-causal MHA (hubert), GQA 4 (phi3), GQA 16 (qwen3-moe), hd 256
    # with gemma3's window 1,024 on its local layers, GQA 8 (chameleon).
    # At S=4096 a row's output is ~0.03, under the bf16 atol: the f32
    # case (3xTF32, and the fma kernel beside it) at atol 2e-5 holds the
    # long range, and the relative error holds the bf16 one
    for name in ("qwen3_0_6b", GRANITE, HUBERT, "phi3_medium_14b",
                 QWEN3_MOE, "gemma3_12b", "chameleon_34b"):
        cfg = configs.get(name)
        h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        window = cfg.pattern[0].window
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(gen, (1, LM_SEQ, h, hd), dtype)
            k = randn(gen, (1, LM_SEQ, kh, hd), dtype)
            v = randn(gen, (1, LM_SEQ, kh, hd), dtype)
            errs.append((flash.route(dtype, hd), attention_check(
                f"{name} layer {str(dtype)[6:]} B=1 S={LM_SEQ} H={h} "
                f"KH={kh} hd={hd} causal={cfg.causal} window={window}", q,
                k, v, cfg.causal, window,
                rel_tol=ATTN_REL_TOL if dtype == torch.bfloat16 else None,
                fma_errs=fma_errs)))
            del q, k, v

    # timing at the main path's shape: the qwen3 prefill's layer
    b, s = LM_BATCH, LM_SEQ
    q = randn(gen, (b, s, shape[0], shape[2]), torch.bfloat16)
    k = randn(gen, (b, s, shape[1], shape[2]), torch.bfloat16)
    v = randn(gen, (b, s, shape[1], shape[2]), torch.bfloat16)
    w = attention_work(b, s, *shape, torch.bfloat16)
    ms = time_ms(lambda: flash.flash_attention_cuda(q, k, v), reps=20)
    # the CUDA-core kernel at the same shape, launched directly: the
    # wrapper never routes bf16 at hd=128 there
    fma_ms = time_ms(lambda: flash._launch("fma", q, k, v, True, None),
                     reps=3, warmup=1)
    plain_ms = time_ms(lambda: attention_ref(q, k, v), reps=2, warmup=1)
    lib = sdpa_yardstick(q, k, v)
    library_ms = lib["ms"]
    log(f"time attention bf16 B={b} S={s} H={shape[0]} KH={shape[1]} "
        f"hd={shape[2]} causal: wgmma kernel {ms:.4f} ms "
        f"({w['ops'] / ms / 1e9:.2f} TFLOP/s), CUDA-core kernel "
        f"{fma_ms:.4f} ms ({w['ops'] / fma_ms / 1e9:.2f} TFLOP/s), plain "
        f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms ({lib['backend']}), "
        f"bound {w['bound_ms']:.4f} ms ({w['bound_by']}; {w['ops']:.4g} ops, "
        f"{w['bytes']} B)")
    del q, k, v
    by_route = {r: max(e for r_, e in errs if r_ == r)
                for r in {r for r, _ in errs}}
    by_route["fma"] = max(fma_errs)
    return by_route["wgmma"], dict(w, ms=ms, fma_ms=fma_ms,
                                   plain_ms=plain_ms, library_ms=library_ms,
                                   hd80=hd80_timing(gen),
                                   max_abs_err_by_route=by_route)


def hd80_timing(gen) -> dict:
    """hubert-xlarge's prefill layer, bf16 (4, 4,096, 16, 80) non-causal:
    the wgmma kernel (hd 80 in the hd-128 tile), the CUDA-core kernel at
    the same shape, the plain version and SDPA (yardstick only), beside
    the bound at the true hd and the padded tile's floor."""
    cfg = configs.get(HUBERT)
    b, s, h, kh, hd = (LM_BATCH, LM_SEQ, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim)
    q = randn(gen, (b, s, h, hd), torch.bfloat16)
    k = randn(gen, (b, s, kh, hd), torch.bfloat16)
    v = randn(gen, (b, s, kh, hd), torch.bfloat16)
    w = attention_work(b, s, h, kh, hd, torch.bfloat16, causal=False)
    tile_ops = 4 * b * h * s * s * flash.wgmma_tile(hd)
    tile_ms = tile_ops / BF16_OPS_PER_S * 1e3
    ms = time_ms(lambda: flash.flash_attention_cuda(q, k, v, causal=False),
                 reps=20)
    fma_ms = time_ms(lambda: flash._launch("fma", q, k, v, False, None),
                     reps=3, warmup=1)
    plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=False),
                       reps=2, warmup=1)
    lib = sdpa_yardstick(q, k, v, causal=False)
    library_ms = lib["ms"]
    log(f"time attention bf16 B={b} S={s} H={h} KH={kh} hd={hd} "
        f"non-causal (hubert) [{flash.route(torch.bfloat16, hd)}, "
        f"{flash.wgmma_tile(hd)}-column tile]: wgmma kernel {ms:.4f} ms "
        f"({w['ops'] / ms / 1e9:.2f} TFLOP/s of the true hd), CUDA-core "
        f"kernel {fma_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms ({lib['backend']}), bound "
        f"{w['bound_ms']:.4f} ms "
        f"({w['bound_by']}; {w['ops']:.4g} ops at hd {hd}, {w['bytes']} "
        f"B), padded tile's floor {tile_ms:.4f} ms ({tile_ops:.4g} ops)")
    return dict(w, ms=ms, fma_ms=fma_ms, plain_ms=plain_ms,
                library_ms=library_ms, tile_bound_ms=tile_ms)


def ssd_inputs(gen, b, l, h, p, n, a_shift=0.0):
    """The reference tests' distribution: x, B, C, A_log, D normal (A_log
    shifted by `a_shift`); dt uniform in [0.01, 0.2)."""
    return (randn(gen, (b, l, h, p)),
            0.01 + 0.19 * torch.rand((b, l, h), generator=gen,
                                     device="cuda"),
            randn(gen, (b, l, n)), randn(gen, (b, l, n)),
            randn(gen, (h,)) + a_shift, randn(gen, (h,)))


def ssd_check(label: str, gen, b, l, h, p, n, chunk, a_shift=0.0) -> float:
    x, dt, Bm, Cm, A_log, D = ssd_inputs(gen, b, l, h, p, n, a_shift)
    C_c, B_c, dtx, cums = chunk_inputs(x, dt, Bm, Cm, A_log, chunk)
    if a_shift:
        # exp(-cums_j) overflows f32 below -88: a factored decay gives NaN
        require(float(cums.min()) < -500,
                f"ssd {label}: cums min {float(cums.min()):.1f} is not "
                "below -500")
        label += f", cums min {float(cums.min()):.1f}"
    y, S = ssd.ssd_intra_cuda(C_c, B_c, dtx, cums)
    torch.cuda.synchronize()
    y_ref, S_ref = ssd_intra_ref(C_c, B_c, dtx, cums)
    yf, hf = ssd.ssd_cuda(x, dt, Bm, Cm, A_log, D, chunk=chunk)
    yf_ref, hf_ref = ssd_ref(x, dt, Bm, Cm, A_log, D, chunk=chunk)
    torch.cuda.synchronize()
    errs = []
    ok = True
    for got, ref in ((y, y_ref), (S, S_ref), (yf, yf_ref), (hf, hf_ref)):
        err = float((got - ref).abs().max())
        tol = SSD_ATOL * max(1.0, float(ref.abs().max()))
        ok = ok and err <= tol and bool(torch.isfinite(got).all())
        errs.append((err, tol))
    log(f"ssd {label}: max|err| y {errs[0][0]:.3e} (tol {errs[0][1]:.3g}), "
        f"S {errs[1][0]:.3e} (tol {errs[1][1]:.3g}), ssd_cuda y "
        f"{errs[2][0]:.3e}, h {errs[3][0]:.3e}: {ok}")
    require(ok, f"SSD kernel disagrees with the plain version: {label}")
    return max(e for e, _ in errs[:2])


def ssd_work(b, nc, q, n, h, p) -> dict:
    """What the intra-chunk function needs: G over the i >= j pairs once
    per chunk, then per head the decay product, att @ dtx and the state;
    C, B, dtx, cums read once, y and S written once. `bound_ms` is the
    route's own: every product as three TF32 products on the tensor cores
    (3 x ops / 495 TFLOP/s) against the bytes; `f32_bound_ms` the same
    work as f32 FMAs on the CUDA cores (ops / 67 TFLOP/s)."""
    pairs = q * (q + 1) // 2
    ops = b * nc * (2 * pairs * n + h * (pairs + 2 * pairs * p
                                         + 2 * q * n * p))
    nbytes = 4 * b * nc * (2 * q * n + q * h * p + q * h + q * h * p
                           + h * n * p)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * ops / TF32_OPS_PER_S
    return {"bytes": nbytes, "ops": ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_rate": "3xTF32: 3 x ops / 495 TFLOP/s",
            "f32_bound_ms": max(t_bytes, ops / FP32_OPS_PER_S) * 1e3}


def ssd_cases() -> list[tuple]:
    """Phase 7's cases, held again for the backward in phase 19: (label,
    b, l, h, p, n, chunk, A_log shift)."""
    mcfg, jcfg = configs.get("mamba2_370m"), configs.get(JAMBA)
    h, p, n, q = (mcfg.ssm_heads, mcfg.ssm_head_dim, mcfg.ssm_state,
                  mcfg.ssm_chunk)
    jamba = (jcfg.ssm_heads, jcfg.ssm_head_dim, jcfg.ssm_state,
             jcfg.ssm_chunk)
    return [
        *((f"B={b} L={l} H={hh} P={pp} N={nn} chunk=16", b, l, hh, pp, nn,
           16, 0.0)
          for b, l, hh, pp, nn in ((1, 32, 2, 8, 4), (2, 64, 4, 16, 8),
                                   (1, 128, 1, 32, 16))),
        ("ragged B=1 L=200 H=3 P=24 N=20 chunk=100", 1, 200, 3, 24, 20, 100,
         0.0),
        ("ragged B=2 L=144 H=3 P=12 N=20 chunk=72", 2, 144, 3, 12, 20, 72,
         0.0),
        # N and P off a multiple of 4: the forward stages with 4-byte copies
        ("ragged B=1 L=96 H=2 P=6 N=5 chunk=48", 1, 96, 2, 6, 5, 48, 0.0),
        # P over 64: two 64-column slots per head, the second one ragged
        # (P=100, and P=70 with 4-byte copies), and the widest head (P=128);
        # H=9 puts a second head group behind a ragged chunk of three i
        # tiles
        ("two slots B=1 L=320 H=9 P=100 N=36 chunk=160", 1, 320, 9, 100, 36,
         160, 0.0),
        ("two slots B=1 L=200 H=3 P=70 N=20 chunk=100", 1, 200, 3, 70, 20,
         100, 0.0),
        (f"two slots B=1 L=512 H=3 P=128 N={n} chunk={q}", 1, 512, 3, 128,
         n, q, 0.0),
        (f"strong decay B=1 L=512 H=4 P={p} N={n} chunk={q} A_log+4", 1,
         512, 4, p, n, q, 4.0),
        (f"mamba2 B={LM_BATCH} L={LM_SEQ} H={h} P={p} N={n} chunk={q}",
         LM_BATCH, LM_SEQ, h, p, n, q, 0.0),
        ("jamba B=1 L=512 H={} P={} N={} chunk={}".format(*jamba), 1, 512,
         *jamba, 0.0)]


def phase_ssd(gen) -> tuple[float, dict]:
    mcfg = configs.get("mamba2_370m")
    h, p, n, q = (mcfg.ssm_heads, mcfg.ssm_head_dim, mcfg.ssm_state,
                  mcfg.ssm_chunk)
    log(f"ssd route: {ssd.ROUTE}")
    errs = [ssd_check(label, gen, *case) for label, *case in ssd_cases()]
    jcfg = configs.get(JAMBA)
    jamba = (jcfg.ssm_heads, jcfg.ssm_head_dim, jcfg.ssm_state,
             jcfg.ssm_chunk)

    x, dt, Bm, Cm, A_log, D = ssd_inputs(gen, LM_BATCH, LM_SEQ, h, p, n)
    C_c, B_c, dtx, cums = chunk_inputs(x, dt, Bm, Cm, A_log, q)
    w = ssd_work(LM_BATCH, LM_SEQ // q, q, n, h, p)
    ms = time_ms(lambda: ssd.ssd_intra_cuda(C_c, B_c, dtx, cums), reps=10)
    plain_ms = time_ms(lambda: ssd_intra_ref(C_c, B_c, dtx, cums), reps=3,
                       warmup=1)
    log(f"time ssd_intra f32 B={LM_BATCH} nc={LM_SEQ // q} Q={q} N={n} "
        f"H={h} P={p}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{w['bound_ms']:.4f} ms ({w['bound_by']}, {w['bound_rate']}; "
        f"{w['ops']:.4g} ops, {w['bytes']} B), f32 CUDA-core bound "
        f"{w['f32_bound_ms']:.4f} ms; {w['ops'] / ms / 1e9:.2f} TFLOP/s of "
        "needed work")
    del x, dt, Bm, Cm, C_c, B_c, dtx, cums
    return max(errs), dict(w, ms=ms, plain_ms=plain_ms, library_ms=None,
                           jamba=ssd_timing(gen, *jamba))


def ssd_timing(gen, h, p, n, q) -> dict:
    """The intra-chunk kernel at jamba's mamba layer in the prefill cell:
    B=4 x 4,096, H=128 heads (16 groups of 8) of P=128, N=128, Q=256."""
    x, dt, Bm, Cm, A_log, D = ssd_inputs(gen, LM_BATCH, LM_SEQ, h, p, n)
    C_c, B_c, dtx, cums = chunk_inputs(x, dt, Bm, Cm, A_log, q)
    del x, dt, Bm, Cm
    w = ssd_work(LM_BATCH, LM_SEQ // q, q, n, h, p)
    ms = time_ms(lambda: ssd.ssd_intra_cuda(C_c, B_c, dtx, cums), reps=10)
    plain_ms = time_ms(lambda: ssd_intra_ref(C_c, B_c, dtx, cums), reps=2,
                       warmup=1)
    log(f"time ssd_intra f32 at jamba's layer B={LM_BATCH} "
        f"nc={LM_SEQ // q} Q={q} N={n} H={h} P={p}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {w['bound_ms']:.4f} ms "
        f"({w['bound_by']}; {w['ops']:.4g} ops, {w['bytes']} B), f32 "
        f"CUDA-core bound {w['f32_bound_ms']:.4f} ms; "
        f"{w['ops'] / ms / 1e9:.2f} TFLOP/s of needed work")
    return {k: v for k, v in dict(w, ms=ms, plain_ms=plain_ms).items()
            if k in ("ms", "plain_ms", "bound_ms", "bound_by",
                     "f32_bound_ms")}


def profile_call(fn, label: str) -> None:
    """Where one call's time goes: device time by kernel and host time by
    op (torch.profiler) against the profiled wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in events
                   if str(e.device_type).endswith("CUDA")), reverse=True)
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in events if e.key.startswith("aten::")),
                  reverse=True)
    if not rows:
        log(f"profile {label}: device time not measured (no device events)")
        return
    busy = sum(ms for ms, _, _ in rows)
    log(f"profile {label}: profiled wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms ({busy / wall_ms:.1%}), "
        f"{sum(c for _, c, _ in rows)} device ops, "
        f"{sum(c for _, c, _ in host)} aten ops on the host")
    for ms, count, key in rows[:8]:
        log(f"  device {ms:9.3f} ms {count:6d}x {ms / count * 1e3:8.2f} us  "
            f"{key[:80]}")
    for ms, count, key in host[:5]:
        log(f"  host   {ms:9.3f} ms {count:6d}x {ms / count * 1e3:8.2f} us  "
            f"{key[:80]}")


def profile_decode(params, cfg, label: str) -> None:
    """One decode step at the serving shape (8 slots, a 4,096-deep cache,
    position 16): ms per step over 10 steps, then one profiled step."""
    decode = steps.make_decode_step(cfg)
    cache = M.init_cache(cfg, 8, 4_096)
    tokens = torch.randint(0, cfg.vocab_size, (8, 1), device="cuda")
    pos = torch.full((8,), 16, device="cuda")
    for _ in range(3):
        decode(params, cache, tokens, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        decode(params, cache, tokens, pos)
    torch.cuda.synchronize()
    log(f"{label}: {(time.perf_counter() - t0) * 100:.3f} ms per step "
        "(10 steps, host clock)")
    profile_call(lambda: decode(params, cache, tokens, pos), label)


def profile_shares(fn, label: str, spans: dict) -> None:
    """Device time of named parts of one call: each (module, function)
    in `spans` runs inside a `torch.profiler.record_function` range for
    this profiled call only, and its range's device time is logged as a
    share of the call's device busy time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def spanned(name, f):
        def g(*a, **kw):
            with record_function(name):
                return f(*a, **kw)
        return g

    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        for name, (mod, attr) in spans.items():
            stack.enter_context(mock.patch.object(
                mod, attr, spanned(name, getattr(mod, attr))))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    events = prof.key_averages()
    # the ranges' own device-side annotations repeat their kernels' time
    busy = sum(e.self_device_time_total for e in events
               if str(e.device_type).endswith("CUDA")
               and e.key not in spans) / 1e3
    parts = {e.key: e.device_time_total / 1e3 for e in events
             if e.key in spans}
    if not busy:
        log(f"profile {label}: device time not measured (no device events)")
        return
    log(f"profile {label}: device busy {busy:.1f} ms; " + ", ".join(
        f"{name} {parts.get(name, 0.0):.1f} ms "
        f"({parts.get(name, 0.0) / busy:.1%})" for name in spans))


def reset_counts() -> None:
    """Every kernel wrapper's launch count, and K2's by route, to 0."""
    for wrapper in KERNELS:
        wrapper.launches = 0
    for routes in (flash.flash_attention_cuda.route_launches,
                   flash.flash_attention_bwd_cuda.route_launches):
        for name in routes:
            routes[name] = 0


def layers_of(cfg, kind: str) -> int:
    return cfg.repeat * sum(spec.kind == kind for spec in cfg.pattern)


def drop_counter(drops: list):
    """`moe.dispatch_buffer` that also records each dispatch's dropped
    (token, choice) pairs in `drops` (patched in for one prefill)."""
    dispatch = moe.dispatch_buffer

    def counting(xt, ids, cap, e):
        out = dispatch(xt, ids, cap, e)
        drops.append((~out[2]).sum())
        return out
    return mock.patch.object(moe, "dispatch_buffer", counting)


def log_memory(label: str) -> None:
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"{label}: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB allocated of {total / 2**30:.2f} GiB")


def free() -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def lm_path(arch: str, kernel, rng, cfg=None, replay_layers=None,
            replay_len=None, profile=True, serve_flags=()) -> tuple[int, dict]:
    """One architecture's serving path at full width (see the module
    docstring, phases 8, 16 and 17). `kernel` is the wrapper the path must
    launch; `cfg` the config (default `configs.get(arch)`; a depth cut for
    qwen3-moe), `replay_layers` the depth of the float32 replay (default:
    the whole model), `replay_len` its prompt; `profile` adds one profiled
    prefill and decode step; `serve_flags` go to `serve.main` after the
    defaults. Returns its launches in the two bf16 prefills and, for flash
    attention, the launches by route: the bf16 prefills' (wgmma) and the
    float32 prefill's (tf32x3); the profiled calls are not counted."""
    cfg = cfg or configs.get(arch)
    is_moe = bool(cfg.num_experts)
    free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    require(params.device.type == "cuda", f"{arch}: the model is not on CUDA")
    nparam = sum(t.numel() for t in params.parameters())
    nbytes = sum(t.numel() * t.element_size() for t in params.parameters())
    log(f"{arch}: {cfg.num_layers} layers, {nparam} parameters, "
        f"{nbytes / 2**30:.2f} GiB on {params.device}, initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    prefill = steps.make_prefill_step(cfg)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, LM_SEQ))).cuda()
    batch = {"tokens": tokens}

    # the main path: counts start at 0 here
    reset_counts()
    routes = flash.flash_attention_cuda.route_launches
    drops = []                 # MoE: dropped (token, choice) pairs per layer
    walls = []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (drop_counter(drops) if is_moe and i == 0
              else contextlib.nullcontext()):
            logits = prefill(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = kernel.launches
    require(launches == 2 * cfg.num_layers,
            f"{arch}: {launches} kernel launches for 2 prefills of "
            f"{cfg.num_layers} layers -- the path did not go through the "
            "kernel")
    path_routes = dict(routes)
    if kernel is flash.flash_attention_cuda:
        require(routes == {**dict.fromkeys(routes, 0), "wgmma": launches},
                f"{arch}: bf16 prefill routes {routes}; every launch must "
                "take the wgmma kernel")
    require(tuple(logits.shape) == (LM_BATCH, 1, cfg.padded_vocab)
            and bool(torch.isfinite(logits).all()),
            f"{arch}: prefill logits {tuple(logits.shape)} not finite or "
            "of the wrong shape")
    ntok = LM_BATCH * LM_SEQ
    by_route = (f" ({routes['wgmma']} wgmma)"
                if kernel is flash.flash_attention_cuda else "")
    log(f"{arch} prefill B={LM_BATCH} S={LM_SEQ}: wall {walls[0]:.3f} / "
        f"{walls[1]:.3f} s, {ntok / walls[1]:.1f} tokens/s (second call), "
        f"launches {launches}{by_route}")
    log_memory(f"{arch} weights + prefill")
    if is_moe:
        require(len(drops) == cfg.num_layers,
                f"{arch}: {len(drops)} MoE dispatches in one prefill of "
                f"{cfg.num_layers} layers")
        per_layer = [int(d) for d in drops]
        pairs = ntok * cfg.top_k
        cap = moe._capacity(ntok, cfg.num_experts, cfg.top_k,
                            cfg.capacity_factor)
        total = pairs * cfg.num_layers
        log(f"{arch} prefill MoE: capacity {cap} per expert, "
            f"{sum(per_layer)} of {total} (token, choice) pairs dropped "
            f"({sum(per_layer) / total:.4%}); per layer min "
            f"{min(per_layer)} max {max(per_layer)}")
        if profile:
            profile_shares(lambda: prefill(params, batch), f"{arch} prefill",
                           {"attention (K2)": (attention, "attend"),
                            "moe dispatch scatter": (moe, "dispatch_buffer"),
                            "moe expert products": (moe, "expert_ffn"),
                            "moe combine gather": (moe, "combine")})
    if profile:
        profile_call(lambda: prefill(params, batch), f"{arch} prefill")
        profile_decode(params, cfg, f"{arch} decode step B=8")
    del params, logits
    free()

    # float32: prefill through the kernels == token-by-token decode replay
    replay = replay_len or (MOE_REPLAY_LEN if is_moe else REPLAY_LEN)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32",
                                num_layers=replay_layers or cfg.num_layers)
    params = M.init_params(cfg32, seed=1)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, replay))).cuda()
    before = kernel.launches
    f32_before = routes.get("tf32x3", 0)
    full = steps.make_prefill_step(cfg32)(params, {"tokens": prompt})
    require(kernel.launches == before + cfg32.num_layers,
            f"{arch}: the f32 prefill did not go through the kernel")
    if kernel is flash.flash_attention_cuda:
        path_routes["tf32x3"] = routes["tf32x3"] - f32_before
        require(path_routes["tf32x3"] == cfg32.num_layers,
                f"{arch}: f32 prefill routes {routes}; every launch must "
                "take the tf32x3 kernel")
    decode = steps.make_decode_step(cfg32)
    cache = M.init_cache(cfg32, 1, replay)
    t0 = time.perf_counter()
    for t in range(replay):
        logits, cache = decode(params, cache, prompt[:, t:t + 1],
                               torch.full((1,), t, device="cuda"))
    torch.cuda.synchronize()
    require(kernel.launches == before + cfg32.num_layers,
            f"{arch}: decode launched the prefill kernel")
    diff = (logits - full).abs()
    tol = 2e-3 + 2e-2 * full.abs()
    note = (f" (an MoE at T={replay} <= capacity 8: no pair dropped)"
            if is_moe else "")
    depth = (f", {cfg32.num_layers} of {cfg.num_layers} layers"
             if cfg32.num_layers != cfg.num_layers else "")
    log(f"{arch} f32 prefill vs {replay}-step decode replay{note}{depth} "
        f"({time.perf_counter() - t0:.1f} s): max|diff| "
        f"{float(diff.max()):.3e}, max|logit| {float(full.abs().max()):.3e}, "
        f"worst diff/tol {float((diff / tol).max()):.3f}")
    require(bool((diff <= tol).all()),
            f"{arch}: float32 prefill and decode replay disagree "
            "(rtol 2e-2, atol 2e-3)")
    del params, cache
    free()

    out = serve.main(["--arch", arch, "--preset", "full", "--slots", "8",
                      "--requests", "16", "--max-new", "32", "--max-seq",
                      "4096", *serve_flags])
    require(out["done"] == 16 and out["device"].startswith("cuda"),
            f"{arch}: serve answered {out['done']} of 16 requests on "
            f"{out['device']}")
    log(f"{arch} serve: 16 requests, {out['tokens']} tokens in "
        f"{out['steps']} steps, {out['seconds']:.3f} s, "
        f"{out['tokens'] / out['seconds']:.1f} decode tokens/s")
    log_memory(f"{arch} (serve included)")
    free()
    return launches, path_routes


# ------------------------------------------------------------------ #
# the distributed fixpoint (15) and granite-moe-3b-a800m (16)
# ------------------------------------------------------------------ #
DIST_WORLD = 2                # ranks of the one-card gloo run (15b)
DIST_CASES = (("sssp x8", "sssp", "data"), ("bfs", "bfs", "data"),
              ("bfs/op", "bfs", "op"))
DIST_PROGRAM_SRCS = [0, 5, 9, 4_096]   # phase 15a's every-program hold


def slab_checks(eng, bg, rng) -> float:
    """K1 on a rank's slab -- the replicated state of every tile, the
    carry of the rank's own tiles -- against its plain version, bit for
    bit: both ranks at world 2, and the last rank at world 3, whose slab
    ends in a padding tile."""
    errs = []
    for world, rank, b in ((2, 0, 8), (2, 1, 8), (3, 2, 1)):
        slab = eng._rank_slab(rank, world)
        sv, carry = state(bg, b, 1, "sparse", rng)
        pad = slab.ntiles * world - bg.ntiles
        if pad:
            sv = torch.nn.functional.pad(sv, (0, 0, 0, pad),
                                         value=float(bg.semiring.zero))
            carry = torch.nn.functional.pad(carry, (0, 0, 0, pad),
                                            value=float(bg.semiring.zero))
        t0 = rank * slab.ntiles
        carry_l = carry[:, t0:t0 + slab.ntiles].contiguous()
        errs.append(compare(
            f"slab rank {rank}/{world} ({slab.bsrc.numel()} blocks, tiles "
            f"{t0}..{t0 + slab.ntiles - 1}) B={b}", slab, sv, carry_l, 1))
    return max(errs)


def dist_rank(rank: int, world: int, store: str, g, srcs, q) -> None:
    """One rank of the one-card gloo run (a spawned process): the phase's
    three queries through `ExecutionPlan(distributed=True)` on the card,
    each with K1's count set to 0 just before it."""
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        out = {}
        for label, algo, mode in DIST_CASES:
            cq = flip_torch.compile(g, algo, flip_torch.ExecutionPlan(
                distributed=True, mode=mode))
            relax.frontier_relax_cuda.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = cq.query(srcs if label == "sssp x8" else 0)
            torch.cuda.synchronize()
            out[label] = (r.attrs, np.atleast_1d(r.steps),
                          relax.frontier_relax_cuda.launches,
                          time.perf_counter() - t0,
                          int(cq.engine._rank_slab(rank, world)
                              .bsrc.numel()))
        dist.destroy_process_group()
        q.put((rank, out))
    except BaseException as e:  # noqa: BLE001 -- reported to the parent
        q.put((rank, repr(e)))
        raise


def dist_graph_run(label: str) -> int:
    """`graph_run --engine dist` on the card (SRN, sssp from 3): correct
    against the oracle, on the captured device loop (replays seen, the
    replay accounting). Returns the kernel's launches."""
    replays = [0]
    replay = FlipEngine._replay

    def spy(self, loop, n):
        replays[0] += 1
        return replay(self, loop, n)
    relax.frontier_relax_cuda.launches = 0
    with mock.patch.object(FlipEngine, "_replay", spy):
        out = graph_run_main(["--algo", "sssp", "--dataset", "SRN", "--src",
                              "3", "--engine", "dist", "--effort", "0"])
    n = relax.frontier_relax_cuda.launches
    require("[graph] correct vs reference: True" in out,
            f"graph_run --engine dist ({label}): no correct self-check")
    steps = int(out.split("fixpoint in ", 1)[1].split()[0])
    require(replays[0] > 0, f"graph_run --engine dist ({label}): no replay "
            "of a captured chunk")
    replay_accounting(f"graph_run --engine dist ({label})", n, steps, 1)
    log(f"graph_run --engine dist ({label}): correct, {steps} steps, "
        f"{replays[0]} replays, launches {n}")
    return n


def dist_programs() -> tuple[int, dict]:
    """Every registered program through `ExecutionPlan(distributed=True)`
    on the NCCL group at ExtLRN-16k against its local plan on the card,
    both on the captured loop (one read per chunk on the distributed
    one): every program bit-equal, steps and convergence included (at
    world 1 the same kernel runs on the same tiles in the same order).
    Returns the launches and the largest error of the (+, x) programs
    (0 when they hold)."""
    g2 = make_road_network(PROGRAM_N, seed=0, delete_frac=0.56)
    launches, errs = 0, {}
    for algo in sorted(ALGEBRAS):
        alg = ALGEBRAS[algo]
        local, _, n_l = counted_query(flip_torch.compile(g2, algo),
                                      DIST_PROGRAM_SRCS, f"{algo} local")
        cq = flip_torch.compile(g2, algo, flip_torch.ExecutionPlan(
            distributed=True))
        cq.query(DIST_PROGRAM_SRCS)     # the slab copy and the captures
        with counted_reads() as reads:
            r, wall, n = counted_query(cq, DIST_PROGRAM_SRCS, f"{algo} dist")
        launches += n_l + n
        require(reads[0] == -(-n // DEVICE_CHUNK) + 1,
                f"dist {algo}: {reads[0]} reads for {n} launches: not the "
                "captured loop")
        # world 1 runs K1 on the same tiles in the same order as the
        # local plan, so every program is held bit for bit; the (+, x)
        # programs' atol is for worlds above 1 (the CPU tests)
        ok = (np.array_equal(r.attrs, local.attrs)
              and np.array_equal(r.steps, local.steps)
              and np.array_equal(r.converged, local.converged))
        what = "bit-equal, steps included"
        if not alg.semiring.idempotent:
            errs[algo] = float(np.abs(r.attrs - local.attrs).max())
            what += f" (max|diff| {errs[algo]:.3e})"
        require(ok, f"dist {algo} at 16k: differs from the local plan")
        log(f"dist {algo} (NCCL, world 1) at ExtLRN-16k, B="
            f"{len(DIST_PROGRAM_SRCS)}, d={cq.engine.feature_dim}: {what} "
            f"against the local plan; steps {np.asarray(r.steps).tolist()}, "
            f"{reads[0]} reads, launches {n} (local {n_l}), wall "
            f"{wall:.4f} s")
    return launches, errs


def phase_distributed(g, srcs, bg, phase4: dict, rng) -> tuple[dict, dict]:
    """Phase 15: (a) one rank through NCCL at world 1 on the captured
    loop and on the host loop in turns, every program at ExtLRN-16k and
    `graph_run --engine dist`; (b) two ranks on the one card over gloo
    (host loop). Every road-262k result bit-equal to phase 4's, steps
    included. Returns the main process's launches by part, and the slab
    checks' error, (b)'s launches by rank and (a)'s numbers."""
    require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
            "phase 15 runs over the NCCL group of world 1")
    launches, found = {}, {}
    for label, algo, mode in DIST_CASES:
        cq = flip_torch.compile(g, algo, flip_torch.ExecutionPlan(
            distributed=True, mode=mode))
        require(cq.plan.distributed and cq.engine.bg.device.type == "cpu"
                and cq.device.type == "cuda",
                f"dist {label}: layout on {cq.engine.bg.device}, state on "
                f"{cq.device}")
        s = srcs if label == "sssp x8" else 0
        t0 = time.perf_counter()
        cq.query(s)                     # the slab copy and the captures
        first = time.perf_counter() - t0
        n, found[label], r = loops_in_turns(f"dist {label}", cq, s,
                                            forced_host_loop)
        launches["15a loops"] = launches.get("15a loops", 0) + n
        want = phase4[label]
        require(np.array_equal(r.attrs, want.attrs)
                and np.array_equal(np.atleast_1d(r.steps),
                                   np.atleast_1d(want.steps))
                and np.array_equal(np.atleast_1d(r.converged),
                                   np.atleast_1d(want.converged)),
                f"dist {label}: differs from phase 4's result")
        iters = found[label]["iterations"]
        log(f"dist {label} (NCCL, world 1): both loops bit-equal to phase "
            f"4, steps and convergence included; {iters} iterations; first "
            f"query with the slab copy and the captures {first:.3f} s")
    err = slab_checks(cq.engine, bg, rng)
    # the collective alone: one all-gather of bfs's (1, 2048, 128) state
    x = torch.zeros((1, bg.ntiles, bg.tile), device="cuda")
    buf = torch.empty_like(x)
    for _ in range(10):
        dist.all_gather_into_tensor(buf, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        dist.all_gather_into_tensor(buf, x)
        torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    # its device time: eager calls leave the device idle between them, so
    # time 200 calls captured in one CUDA graph, as the device loop runs it
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(200):
            dist.all_gather_into_tensor(buf, x)
    graph.replay()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    graph.replay()
    ev[1].record()
    torch.cuda.synchronize()
    found["all_gather_us"] = {"device": ev[0].elapsed_time(ev[1]) / 200 * 1e3,
                              "host": host_us, "bytes": x.numel() * 4}
    del graph
    log(f"NCCL all-gather of {x.numel() * 4} B at world 1: "
        f"{found['all_gather_us']['device']:.2f} us per call on the device "
        f"(CUDA events over a graph of 200 captured calls), {host_us:.1f} us "
        f"per eager call with a synchronize after each (host clock) "
        f"({SMI[0]})")
    t0 = time.perf_counter()
    launches["15a programs 16k"], found["program_errs"] = dist_programs()
    log(f"phase 15a programs: {time.perf_counter() - t0:.1f} s")
    launches["15a graph_run NCCL"] = dist_graph_run("NCCL, world 1")

    # (b) two ranks on the one card, gloo (NCCL refuses two ranks on one
    # device); the state crosses the host in gloo's own copies
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=dist_rank,
                             args=(r, DIST_WORLD, os.path.join(tmp, "gloo"),
                                   g, srcs, q))
                 for r in range(DIST_WORLD)]
        for p in procs:
            p.start()
        try:
            got = dict(q.get(timeout=600) for _ in procs)
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
    by_rank = {}
    for rank in range(DIST_WORLD):
        res = got.get(rank)
        require(isinstance(res, dict), f"gloo rank {rank} failed: {res}")
        by_rank[rank] = 0
        for label, _, _ in DIST_CASES:
            attrs, steps, n, wall, nb = res[label]
            want = phase4[label]
            iters = int(steps.max())
            require(np.array_equal(attrs, want.attrs)
                    and np.array_equal(steps, np.atleast_1d(want.steps)),
                    f"gloo rank {rank} {label}: differs from phase 4")
            require(n == iters,
                    f"gloo rank {rank} {label}: {n} K1 launches for "
                    f"{iters} iterations")
            log(f"dist {label} (gloo, rank {rank} of {DIST_WORLD}, one "
                f"card): bit-equal to phase 4; {nb} blocks on this rank, "
                f"launches {n} = iterations, {wall / iters * 1e3:.4f} "
                f"ms/step (first query, slab copy included)")
            by_rank[rank] += n
    log(f"phase 15b: {time.perf_counter() - t0:.1f} s with the ranks' "
        "start-up")
    return launches, {"err": err, "by_rank": by_rank, "a": found}


def ep_check(cfg, group, gen) -> None:
    """`moe.apply(dispatch="all_to_all")` over the phase-15 NCCL group
    (world 1) against the one-group path, at the prefill's layer shape in
    bf16."""
    layer = DeclModule(moe.decls(cfg), torch.bfloat16, torch.device("cuda"))
    init_module(layer, gen)
    x = randn(gen, (LM_BATCH, LM_SEQ, cfg.d_model), torch.bfloat16)
    y1, a1 = moe.apply(layer, x, cfg)
    y2, a2 = moe.apply(layer, x, cfg, dispatch="all_to_all", group=group)
    torch.cuda.synchronize()
    err = float((y1.float() - y2.float()).abs().max())
    scale = float(y1.float().abs().max())
    ok = (err <= MOE_EP_TOL * scale and abs(float(a1) - float(a2)) <= 1e-5
          and bool(torch.isfinite(y2).all()))
    log(f"moe all_to_all (NCCL, world 1) vs one group at ({LM_BATCH}, "
        f"{LM_SEQ}, {cfg.d_model}) bf16: max|diff| {err:.3e} (tol "
        f"{MOE_EP_TOL:g} x max|y| = {MOE_EP_TOL * scale:.3e}), aux "
        f"{float(a1):.6f} / {float(a2):.6f}: {ok}")
    require(ok, "moe all_to_all disagrees with the one-group path")


# ------------------------------------------------------------------ #
# the other seven configurations (17)
# ------------------------------------------------------------------ #
DENSE = ("phi3_medium_14b", "mistral_nemo_12b", "gemma3_12b",
         "chameleon_34b")
# of qwen3-moe's 94 layers: 12 are 58.0 GiB of bf16 weights, ~63.5 GiB
# at the B=4 prefill (8 layers peaked at 44.86 GiB with 39.39 of
# weights); 14 would leave ~6.5 GiB of the card's 79.2 GiB, 16 do not fit
QWEN3_MOE_LAYERS = 12
GEMMA3_REPLAY_LEN = 1_088     # past the local layers' window of 1,024
REPLAY_TOL = dict(rtol=2e-2, atol=2e-3)


def hold(label: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """got within rtol 2e-2, atol 2e-3 of want, everywhere, and finite."""
    diff = (got - want).abs()
    tol = REPLAY_TOL["atol"] + REPLAY_TOL["rtol"] * want.abs()
    ok = bool((diff <= tol).all()) and bool(torch.isfinite(got).all())
    log(f"{label}: max|diff| {float(diff.max()):.3e}, max|ref| "
        f"{float(want.abs().max()):.3e}, worst diff/tol "
        f"{float((diff / tol).max()):.3f}: {ok}")
    require(ok, f"{label}: outside rtol 2e-2, atol 2e-3")


def hubert_path(gen) -> dict:
    """hubert-xlarge at full depth on a frames batch: two bf16 prefills
    through K2 (hd 80, wgmma), the float32 prefill at B=1 through K2's
    3xTF32 route against the same prefill with `attention.attend` on
    `attention_ref`, and `serve`'s refusal. Returns K2's launches by
    route."""
    cfg = configs.get(HUBERT)
    free()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, seed=0)
    frames = randn(gen, (LM_BATCH, LM_SEQ, cfg.d_model), torch.bfloat16)
    prefill = steps.make_prefill_step(cfg)
    routes = flash.flash_attention_cuda.route_launches
    reset_counts()
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, {"frames": frames})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    got = dict(routes)
    require(got == {**dict.fromkeys(got, 0), "wgmma": 2 * cfg.num_layers},
            f"{HUBERT}: bf16 prefill routes {got}; want "
            f"{2 * cfg.num_layers} wgmma launches (hd 80)")
    require(tuple(logits.shape) == (LM_BATCH, 1, cfg.padded_vocab)
            and bool(torch.isfinite(logits).all()),
            f"{HUBERT}: prefill logits {tuple(logits.shape)} not finite or "
            "of the wrong shape")
    ntok = LM_BATCH * LM_SEQ
    log(f"{HUBERT} prefill frames ({LM_BATCH}, {LM_SEQ}, {cfg.d_model}): "
        f"wall {walls[0]:.3f} / {walls[1]:.3f} s, {ntok / walls[1]:.1f} "
        f"frames/s (second call), K2 {got}")
    log_memory(f"{HUBERT} weights + prefill")
    del params, logits, frames
    free()

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    params = M.init_params(cfg32, seed=1)
    x = {"frames": randn(gen, (1, LM_SEQ, cfg.d_model))}
    prefill32 = steps.make_prefill_step(cfg32)
    f32_0 = routes["tf32x3"]
    out = prefill32(params, x)
    require(routes["tf32x3"] == f32_0 + cfg.num_layers and routes["wgmma"]
            == 2 * cfg.num_layers and routes["fma"] == 0,
            f"{HUBERT}: f32 prefill routes {routes}")
    n32 = routes["tf32x3"] - f32_0

    def plain(q, k, v, causal, window):
        return attention_ref(q, k, v, causal=causal, window=window)

    with mock.patch.object(attention, "attend", plain):
        want = prefill32(params, x)
    require(routes["tf32x3"] == f32_0 + cfg.num_layers,
            f"{HUBERT}: the plain prefill launched K2")
    hold(f"{HUBERT} f32 prefill B=1 S={LM_SEQ}, {cfg.num_layers} layers: "
         "K2 (tf32x3, hd 80) vs attention_ref", out, want)
    del params, out, want
    free()
    try:
        serve.main(["--arch", HUBERT, "--preset", "full"])
    except SystemExit as e:
        require("encoder-only" in str(e), f"{HUBERT} serve: {e}")
        log(f"{HUBERT} serve: {e}")
    else:
        require(False, f"{HUBERT}: serve did not refuse an encoder")
    return {"wgmma": got["wgmma"], "tf32x3": n32}


def jamba_blocks(gen) -> dict:
    """jamba-1.5-large-398b's three block kinds at full width, one at a
    time (one 8-layer period is 88 GB in bf16): positions 4 (attention +
    dense FFN), 0 (mamba + dense FFN) and 1 (mamba + MoE, 16 experts x
    24,576), each over a (4, 4,096, 8,192) bf16 input through the
    block forward; then one full-width mamba layer in float32 at B=1 x 512
    against the same layer with the plain intra-chunk form. Returns K2's
    and K3's launches."""
    cfg = configs.get(JAMBA)
    free()
    torch.cuda.reset_peak_memory_stats()
    x = randn(gen, (LM_BATCH, LM_SEQ, cfg.d_model), torch.bfloat16)
    reset_counts()
    routes = flash.flash_attention_cuda.route_launches
    for pos in (4, 0, 1):
        spec = cfg.pattern[pos]
        blk = M.Block(cfg, spec, torch.bfloat16, torch.device("cuda"))
        init_module(blk, gen)
        nbytes = sum(t.numel() * t.element_size() for t in blk.parameters())
        drops = []
        k2, k3 = routes["wgmma"], ssd.ssd_intra_cuda.launches
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        with drop_counter(drops) if spec.moe else contextlib.nullcontext():
            start.record()
            y, _ = M._run_block(blk, x, cfg)
            end.record()
        torch.cuda.synchronize()
        require(tuple(y.shape) == tuple(x.shape)
                and bool(torch.isfinite(y).all()),
                f"{JAMBA} block {pos}: output not finite or misshapen")
        kind = f"{spec.kind}{' + MoE' if spec.moe else ' + dense FFN'}"
        extra = ""
        if spec.moe:
            ntok = LM_BATCH * LM_SEQ
            cap = moe._capacity(ntok, cfg.num_experts, cfg.top_k,
                                cfg.capacity_factor)
            extra = (f"; capacity {cap} per expert, {int(drops[0])} of "
                     f"{ntok * cfg.top_k} (token, choice) pairs dropped")
        log(f"{JAMBA} block {pos} ({kind}, {nbytes / 1e9:.1f} GB): "
            f"{start.elapsed_time(end):.3f} ms on the card (one call), K2 "
            f"+{routes['wgmma'] - k2}, K3 "
            f"+{ssd.ssd_intra_cuda.launches - k3}{extra}")
        del blk, y
        free()
    got = {"wgmma": routes["wgmma"], "fma": routes["fma"],
           "ssd": ssd.ssd_intra_cuda.launches}
    require(got == {"wgmma": 1, "fma": 0, "ssd": 2},
            f"{JAMBA} blocks: launches {got}; want one K2 (wgmma) and two "
            "K3")
    log_memory(f"{JAMBA} blocks")
    del x

    layer = mamba.Mamba(cfg, torch.float32, torch.device("cuda"))
    init_module(layer, gen)
    xs = randn(gen, (1, 512, cfg.d_model))
    k3 = ssd.ssd_intra_cuda.launches
    out = mamba.apply(layer, xs, cfg)
    require(ssd.ssd_intra_cuda.launches == k3 + 1,
            f"{JAMBA}: the f32 mamba layer did not launch K3")
    with mock.patch.object(ssd, "ssd_intra_cuda", ssd_intra_ref):
        want = mamba.apply(layer, xs, cfg)
    hold(f"{JAMBA} f32 mamba layer B=1 L=512 (2 chunks of "
         f"{cfg.ssm_chunk}, H={cfg.ssm_heads} P={cfg.ssm_head_dim} "
         f"N={cfg.ssm_state}): K3 vs ssd_intra_ref", out, want)
    del layer, out, want
    free()
    return got


def jamba_smoke(rng) -> dict:
    """jamba's whole hybrid model at its smoke config on the card (K2 on
    the 3xTF32 route at hd 16 in f32, K3 at P 32): a prefill, the 8-token
    replay and `serve --preset tiny --device cuda`. Returns K2's (tf32x3)
    and K3's launches in the prefill."""
    cfg = configs.get_smoke(JAMBA)
    params = M.init_params(cfg, seed=0)
    n_attn, n_mamba = layers_of(cfg, "attn"), layers_of(cfg, "mamba")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (LM_BATCH, 512))).cuda()
    routes = flash.flash_attention_cuda.route_launches
    reset_counts()
    logits = M.prefill(params, {"tokens": tokens}, cfg)
    got = {**routes, "ssd": ssd.ssd_intra_cuda.launches}
    require(got == {**dict.fromkeys(routes, 0), "tf32x3": n_attn,
                    "ssd": n_mamba}
            and bool(torch.isfinite(logits).all()),
            f"{JAMBA} smoke prefill: launches {got}; want {n_attn} K2 "
            f"(tf32x3) "
            f"and {n_mamba} K3, finite logits")
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, MOE_REPLAY_LEN))).cuda()
    full = M.prefill(params, {"tokens": prompt}, cfg)
    cache = M.init_cache(cfg, 1, MOE_REPLAY_LEN)
    for t in range(MOE_REPLAY_LEN):
        step, cache = M.decode_step(params, cache, prompt[:, t:t + 1],
                                    torch.full((1,), t, device="cuda"), cfg)
    hold(f"{JAMBA} smoke ({cfg.num_layers} layers: {n_attn} attention, "
         f"{n_mamba} mamba, MoE on odd positions) f32 prefill vs "
         f"{MOE_REPLAY_LEN}-step decode replay", step, full)
    out = serve.main(["--arch", JAMBA, "--preset", "tiny", "--device",
                      "cuda", "--slots", "8", "--requests", "16"])
    require(out["done"] == 16 and out["device"].startswith("cuda"),
            f"{JAMBA} smoke serve: {out['done']} of 16 on {out['device']}")
    log(f"{JAMBA} smoke: prefill ({LM_BATCH}, 512) K2 {n_attn} (tf32x3) K3 "
        f"{n_mamba}; serve 16 requests, {out['tokens']} tokens in "
        f"{out['steps']} steps, {out['seconds']:.3f} s")
    return got


def phase_configs(rng, gen) -> tuple[dict, dict, dict]:
    """Phase 17. Returns K2's launches by phase on the wgmma and the tf32x3
    route, and K3's."""
    wgmma, f32, k3 = {}, {}, {}
    for arch in DENSE:
        t0 = time.perf_counter()
        cfg = configs.get(arch)
        period = len(cfg.pattern)
        n, r = lm_path(arch, flash.flash_attention_cuda, rng,
                       replay_layers=period if period > 1 else 4,
                       replay_len=(GEMMA3_REPLAY_LEN if arch == "gemma3_12b"
                                   else None),
                       profile=arch == DENSE[0])
        wgmma[f"17 {arch}"] = r["wgmma"]
        f32[f"17 {arch} f32 replay"] = r["tf32x3"]
        log(f"phase 17 {arch}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    r = hubert_path(gen)
    wgmma[f"17 {HUBERT}"] = r["wgmma"]
    f32[f"17 {HUBERT} f32"] = r["tf32x3"]
    log(f"phase 17 {HUBERT}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cut = dataclasses.replace(configs.get(QWEN3_MOE),
                              num_layers=QWEN3_MOE_LAYERS)
    n, r = lm_path(QWEN3_MOE, flash.flash_attention_cuda, rng, cfg=cut,
                   replay_layers=2, profile=False,
                   serve_flags=("--layers", str(QWEN3_MOE_LAYERS)))
    wgmma[f"17 {QWEN3_MOE} ({QWEN3_MOE_LAYERS} of 94 layers)"] = r["wgmma"]
    f32[f"17 {QWEN3_MOE} f32 replay"] = r["tf32x3"]
    log(f"phase 17 {QWEN3_MOE}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    r = jamba_blocks(gen)
    wgmma[f"17 {JAMBA} blocks"] = r["wgmma"]
    k3[f"17 {JAMBA} blocks"] = r["ssd"]
    r = jamba_smoke(rng)
    f32[f"17 {JAMBA} smoke"] = r["tf32x3"]
    k3[f"17 {JAMBA} smoke"] = r["ssd"]
    log(f"phase 17 {JAMBA}: {time.perf_counter() - t0:.1f} s")
    return wgmma, f32, k3


# ------------------------------------------------------------------ #
# training qwen3-0.6b (18)
# ------------------------------------------------------------------ #
TRAIN_ARCH = "qwen3_0_6b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 4_096, 5   # train_4k cut 32x
BWD_F32_ATOL = 1e-4           # x max(1, max|ref|) per output
BWD_REL_TOL = 1e-2            # bf16: relative Frobenius per output
HOLD_LAYERS, HOLD_BATCH, HOLD_SEQ = 2, 2, 256
GEMMA3 = "gemma3_12b"
GEMMA3_LAYERS = 6             # one pattern period: 5 local layers, 1 global
GEMMA3_HOLD_SEQ = 2_048       # the route hold, past the local window


def fma_route():
    """K2's backward patched onto its "fma" route, here only (the package
    has no such knob): the comparisons of phase 18, never the main path."""
    return mock.patch.object(flash, "bwd_route", lambda dtype, hd: "fma")


def grads_hold(dtype, got, want) -> tuple[bool, float, list[str]]:
    """(dq, dk, dv) against `attention_bwd_ref`'s: f32 atol 1e-4 x max(1,
    max|ref|) per output; bf16 phase 6's atol 2e-2 plus the output's own
    bf16 rounding (2^-8 |ref|) elementwise, and a relative Frobenius error
    of 1e-2 per output. Returns (held, max|err|, notes)."""
    errs, notes, ok = [], [], True
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        require(g.dtype == dtype and g.shape == w.shape,
                f"backward: {name} {g.dtype} {tuple(g.shape)}")
        diff = (g.float() - w).abs()
        err = float(diff.max())
        peak = float(w.abs().max())
        if dtype == torch.float32:
            good = err <= BWD_F32_ATOL * max(1.0, peak)
        else:
            rel = float((g.float() - w).norm() / w.norm())
            good = bool((diff <= ATTN_ATOL[torch.bfloat16]
                         + 2.0 ** -8 * w.abs()).all()) and rel <= BWD_REL_TOL
            notes.append(f"{name} rel {rel:.2e}")
        good = good and bool(torch.isfinite(g).all())
        ok = ok and good
        errs.append(err)
        notes.append(f"{name} {err:.2e} (max|ref| {peak:.3g})")
    return ok, max(errs), notes


def bwd_check(label: str, gen, q, k, v, causal: bool, window: int | None,
              quiet: bool = False) -> tuple[str, float, float | None]:
    """The backward kernel on `flash.bwd_route`'s route against
    `attention_bwd_ref` on the same inputs (o and L from the forward
    kernel, do random; the plain version in f32 on the upcast inputs), at
    `grads_hold`'s limits. The call must take the route's kernel, counted
    once, and a second call must give the same bits (no atomics). On the
    "wgmma" and "tf32x3" routes the "fma" kernel runs on the same inputs
    too (patched in) and its error is logged beside; in f32 it is held at
    the same limits, in bf16 not (it keeps P and dS in f32). Returns
    (route, max|err|, the fma route's max|err| or None)."""
    name = flash.bwd_route(q.dtype, q.shape[-1])
    takes_lse = name in flash.LSE_ROUTES
    with torch.no_grad():
        out = flash.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window, return_lse=takes_lse)
    o, lse = out if takes_lse else (out, None)
    do = randn(gen, tuple(o.shape), q.dtype)
    counts = flash.flash_attention_bwd_cuda.route_launches
    before = dict(counts)
    got = flash.flash_attention_bwd_cuda(q, k, v, o, do, causal, window,
                                         lse=lse)
    torch.cuda.synchronize()
    taken = {r: n - before[r] for r, n in counts.items() if n != before[r]}
    require(taken == {name: 1}, f"backward {label}: took {taken}, not "
            f"{name} once")
    again = flash.flash_attention_bwd_cuda(q, k, v, o, do, causal, window,
                                           lse=lse)
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"backward {label}: two calls differ")
    want = attention_bwd_ref(q.float(), k.float(), v.float(), o.float(),
                             do.float(), causal, window)
    ok, err, notes = grads_hold(q.dtype, got, want)
    alt_err, alt = None, ""
    if takes_lse:
        with fma_route():
            other = flash.flash_attention_bwd_cuda(q, k, v, o, do, causal,
                                                   window)
        alt_ok, alt_err, alt_notes = grads_hold(q.dtype, other, want)
        alt = f" | the fma route on the same inputs: {'; '.join(alt_notes)}"
        if q.dtype == torch.float32:
            ok = ok and alt_ok
    if not (quiet and ok):
        log(f"backward {label} [{name}]: max|err| {'; '.join(notes)}: "
            f"{ok}{alt}")
    require(ok, f"backward kernel ({name}) disagrees with attention_bwd_ref: "
            f"{label}")
    return name, err, alt_err


LSE_ATOL = 1e-4               # natural-log units: 1e-4 of the row sum


def lse_check(label: str, gen, b, s, t, h, kh, hd, causal, window,
              dtype=torch.bfloat16) -> float:
    """The forward's row log-sum-exp (`return_lse=True`, the wgmma route
    in bf16, tf32x3 in f32) against `attention_lse_ref` on the same inputs
    (upcast): +inf on exactly the rows that see no key, elsewhere within
    atol 1e-4; the output the same bit for bit as without L."""
    q = randn(gen, (b, s, h, hd), dtype)
    k = randn(gen, (b, t, kh, hd), dtype)
    v = randn(gen, (b, t, kh, hd), dtype)
    name = flash.route(dtype, hd)
    before = flash.flash_attention_cuda.route_launches[name]
    o, lse = flash.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, return_lse=True)
    o2 = flash.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    require(flash.flash_attention_cuda.route_launches[name] == before + 2,
            f"L {label}: not on the {name} route")
    ref = attention_lse_ref(q.float(), k.float(), causal, window)
    require(lse.shape == (b, h, s) and lse.dtype == torch.float32,
            f"L {label}: {tuple(lse.shape)} {lse.dtype}")
    empty = torch.isinf(ref)
    fin = ~empty
    err = float((lse[fin] - ref[fin]).abs().max()) if bool(fin.any()) else 0.0
    ok = (bool(torch.equal(torch.isposinf(lse), empty))
          and bool(torch.isfinite(lse[fin]).all()) and err <= LSE_ATOL
          and bool(torch.equal(o, o2)))
    log(f"forward L {label} [{name}]: max|err| {err:.3e} on "
        f"{int(fin.sum())} rows "
        f"(atol {LSE_ATOL:g}), +inf on the {int(empty.sum())} rows that see "
        f"no key; output bit-equal to the call without L: {ok}")
    require(ok, f"the forward's L disagrees with attention_lse_ref: {label}")
    return err


def lse_cases(gen) -> float:
    """Phase 18's L cases, in bf16 (wgmma) and f32 (tf32x3): qwen3's
    layer, ragged S=200 and S=5, hd 64 and 80, and S > T under a window,
    where rows see no key; in f32 also hd 16 and 256."""
    qcfg = configs.get(TRAIN_ARCH)
    cases = [(f"qwen3 layer B=1 S={LM_SEQ}", 1, LM_SEQ, LM_SEQ,
              qcfg.num_heads, qcfg.num_kv_heads, qcfg.head_dim, True, None),
             ("ragged S=200 hd=128 window=50", 2, 200, 200, 4, 2, 128, True,
              50),
             ("ragged S=5 hd=64", 1, 5, 5, 4, 2, 64, True, None),
             ("hd=80 non-causal S=200", 1, 200, 200, 4, 4, 80, False, None),
             ("S=300 > T=100 window=64 (rows 163-299 see no key)", 1, 300,
              100, 4, 2, 128, True, 64)]
    f32 = [("hd=16 S=200", 1, 200, 200, 4, 2, 16, True, None),
           ("hd=256 S=200 window=50", 1, 200, 200, 4, 2, 256, True, 50)]
    return max([lse_check(label, gen, *rest) for label, *rest in cases]
               + [lse_check(f"f32 {label}", gen, *rest, dtype=torch.float32)
                  for label, *rest in cases + f32])


def function_check(gen, b, s, h, kh, hd, causal, window) -> float:
    """`ops.flash_attention` (the autograd Function: K2's forward and
    backward kernels) against torch.autograd through `attention_ref`, f32
    at atol 1e-4 x max(1, max|ref|): the output and the three input
    gradients."""
    q, k, v = (randn(gen, shp) for shp in ((b, s, h, hd), (b, s, kh, hd),
                                           (b, s, kh, hd)))
    do = randn(gen, (b, s, h, hd))
    f0, b0 = (flash.flash_attention_cuda.launches,
              flash.flash_attention_bwd_cuda.launches)
    outs = []
    for fn in (attn_ops.flash_attention, attention_ref):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fn(*leaves, causal=causal, window=window)
        outs.append([o.detach(), *torch.autograd.grad(o, leaves, do)])
    require((flash.flash_attention_cuda.launches - f0,
             flash.flash_attention_bwd_cuda.launches - b0) == (1, 1),
            "the autograd Function did not launch each kernel once")
    err = 0.0
    for name, g, w in zip(("out", "dq", "dk", "dv"), *outs):
        e = float((g - w).abs().max())
        require(e <= BWD_F32_ATOL * max(1.0, float(w.abs().max())),
                f"autograd Function {name} disagrees with autograd through "
                f"attention_ref: {e:.3e}")
        err = max(err, e)
    log(f"autograd Function f32 ({b}, {s}, {h}, {hd}) KH={kh} causal="
        f"{causal} window={window}: out, dq, dk, dv max|err| {err:.3e} "
        "against torch.autograd through attention_ref: True")
    return err


def bwd_cases(gen) -> dict:
    """Phase 18's kernel-against-plain cases. Returns each backward
    route's max|err|: the fma route's from its f32 runs beside the tf32x3
    kernel (held there)."""
    errs = {"wgmma": [], "tf32x3": [], "fma": []}

    def run(label, q, k, v, causal, window, quiet=False):
        name, err, alt = bwd_check(label, gen, q, k, v, causal, window,
                                   quiet)
        errs[name].append(err)
        if alt is not None and q.dtype == torch.float32:
            errs["fma"].append(alt)
        return name, err, alt

    for dtype, hds in ((torch.float32, (16, 64, 128, 256)),
                       (torch.bfloat16, (64, 128, 256))):
        for hd in hds:
            group, alts = [], []
            for kh in (8, 4, 1):                    # GQA ratio 1, 2, 8
                q = randn(gen, (2, 320, 8, hd), dtype)
                k = randn(gen, (2, 320, kh, hd), dtype)
                v = randn(gen, (2, 320, kh, hd), dtype)
                for causal in (True, False):
                    for window in (None, 128):
                        name, err, alt = run(
                            f"{str(dtype)[6:]} hd={hd} g={8 // kh} "
                            f"causal={causal} window={window} S=320", q, k,
                            v, causal, window, quiet=True)
                        group.append(err)
                        if alt is not None:
                            alts.append(alt)
            log(f"backward {str(dtype)[6:]} hd={hd} [{name}]: 12 cases (GQA "
                "ratio 1/2/8 x causal x window None/128, B=2, S=320, H=8): "
                f"max|err| {max(group):.3e}"
                + (f"; the fma route on the same inputs {max(alts):.3e}"
                   if alts else ""))
    cases = [("f32 hd=16 (the smoke config's)", torch.float32, 1, 320, 4, 2,
              16, True, None),
             ("f32 hd=80 non-causal", torch.float32, 1, 320, 16, 16, 80,
              False, None),
             ("bf16 hubert layer B=1 S=4096 hd=80 non-causal",
              torch.bfloat16, 1, LM_SEQ, 16, 16, 80, False, None),
             ("f32 ragged S=200 window=50", torch.float32, 1, 200, 4, 2, 32,
              True, 50),
             ("bf16 ragged S=200 hd=256 window=50", torch.bfloat16, 1, 200,
              4, 2, 256, True, 50),
             ("bf16 ragged S=200 hd=80 window=50", torch.bfloat16, 1, 200,
              4, 2, 80, True, 50),
             ("bf16 ragged S=200 hd=64 GQA 4 non-causal", torch.bfloat16, 1,
              200, 8, 2, 64, False, None),
             ("bf16 ragged S=5", torch.bfloat16, 1, 5, 4, 2, 128, True,
              None),
             ("f32 ragged S=5", torch.float32, 1, 5, 4, 2, 64, False, None)]
    qcfg = configs.get(TRAIN_ARCH)
    for dtype in (torch.float32, torch.bfloat16):
        cases.append((f"{str(dtype)[6:]} qwen3 layer B=1 S={LM_SEQ}", dtype,
                      1, LM_SEQ, qcfg.num_heads, qcfg.num_kv_heads,
                      qcfg.head_dim, True, None))
    # gemma3's local (window 1,024) and global layers at hd 256
    gcfg = configs.get(GEMMA3)
    for window in (gcfg.pattern[0].window, None):
        cases.append((f"bf16 gemma3 layer B=1 S={LM_SEQ} window={window}",
                      torch.bfloat16, 1, LM_SEQ, gcfg.num_heads,
                      gcfg.num_kv_heads, gcfg.head_dim, True, window))
    for label, dtype, b, s, h, kh, hd, causal, window in cases:
        q = randn(gen, (b, s, h, hd), dtype)
        k = randn(gen, (b, s, kh, hd), dtype)
        v = randn(gen, (b, s, kh, hd), dtype)
        run(label, q, k, v, causal, window)
        del q, k, v
    # T != S: kv tiles past S that no q tile reaches (zeros), and rows
    # past T
    for dtype in (torch.bfloat16, torch.float32):
        for s, t, hd in ((200, 328, 128), (328, 200, 64), (200, 328, 256),
                         (328, 200, 256)):
            run(f"{str(dtype)[6:]} S={s} T={t} hd={hd} causal",
                randn(gen, (1, s, 4, hd), dtype),
                randn(gen, (1, t, 2, hd), dtype),
                randn(gen, (1, t, 2, hd), dtype), True, None)
    errs["tf32x3"].append(function_check(gen, 2, 256, 16, 8, 128, True,
                                         None))
    errs["tf32x3"].append(function_check(gen, 1, 320, 8, 2, 64, True, 128))
    return {name: max(e) for name, e in errs.items()}


def bwd_timing(gen) -> dict:
    """The backward at qwen3's training shape, bf16 q (8, 4,096, 16, 128),
    k/v (8, 4,096, 8, 128), causal: the wgmma kernel (L from the forward)
    and the fma kernel on the same inputs, the plain version at the
    largest batch it fits (stated), SDPA's backward (yardstick only),
    beside the bound: 2.5x the forward's operations at the bf16
    tensor-core rate (3.0x with the recompute of q k^T for L; 3.5x, the
    wgmma design's seven products), or the bytes of q, k, v, o, do read
    and dq, dk, dv written. Also the wgmma forward with and without L at
    qwen3's prefill shape (B=4), in turns."""
    cfg = configs.get(TRAIN_ARCH)
    b, s, h, kh, hd = (TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads,
                       cfg.num_kv_heads, cfg.head_dim)
    q = randn(gen, (b, s, h, hd), torch.bfloat16)
    k = randn(gen, (b, s, kh, hd), torch.bfloat16)
    v = randn(gen, (b, s, kh, hd), torch.bfloat16)
    do = randn(gen, (b, s, h, hd), torch.bfloat16)
    with torch.no_grad():
        o, lse = flash.flash_attention_cuda(q, k, v, return_lse=True)
    fwd = attention_work(b, s, h, kh, hd, torch.bfloat16)
    ops = 2.5 * fwd["ops"]
    nbytes = 2 * fwd["bytes"] + b * s * h * hd * 2 * 2   # + o and do
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S

    def wgmma():
        return flash.flash_attention_bwd_cuda(q, k, v, o, do, lse=lse)

    def fma():
        with fma_route():
            return flash.flash_attention_bwd_cuda(q, k, v, o, do)
    ms = time_ms(wgmma, reps=10, warmup=2)
    fma_ms = time_ms(fma, reps=3, warmup=1)
    ms2 = time_ms(wgmma, reps=10, warmup=1)
    plain_ms = plain_b = None
    for pb in (b, b // 2, b // 4, 1):
        try:
            free()
            plain_ms = time_ms(lambda: attention_bwd_ref(
                q[:pb], k[:pb], v[:pb], o[:pb], do[:pb]), reps=2, warmup=1)
            plain_b = pb
            break
        except torch.cuda.OutOfMemoryError:
            continue
    free()
    require(plain_ms is not None, "the plain backward fits at no batch")
    lib = sdpa_yardstick(q, k, v, do)
    library_ms = lib["ms"]
    require(library_ms is not None, "no fused SDPA backend took qwen3's "
            "backward")
    # the forward at the prefill shape, in turns: without L, with, with,
    # without, twice over
    qf, kf, vf = q[:LM_BATCH], k[:LM_BATCH], v[:LM_BATCH]
    fwd_runs = [time_ms(lambda: flash.flash_attention_cuda(
        qf, kf, vf, return_lse=with_l), reps=50)
        for with_l in (False, True, True, False) * 2]
    without = [fwd_runs[i] for i in (0, 3, 4, 7)]
    with_l = [fwd_runs[i] for i in (1, 2, 5, 6)]
    t = {"ms": ms, "ms_again": ms2, "fma_ms": fma_ms, "plain_ms": plain_ms,
         "plain_batch": plain_b, "library_ms": library_ms,
         "library_backend": lib["backend"], "ops": ops,
         "bytes": nbytes, "bound_ms": max(t_bytes, t_ops) * 1e3,
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "bound_recompute_ms": 3.0 * fwd["ops"] / BF16_OPS_PER_S * 1e3,
         "floor_7_products_ms": 3.5 * fwd["ops"] / BF16_OPS_PER_S * 1e3,
         "fwd_ms": float(np.mean(without)),
         "fwd_lse_ms": float(np.mean(with_l))}
    log(f"time backward bf16 B={b} S={s} H={h} KH={kh} hd={hd} causal: "
        f"wgmma kernel {ms:.4f} ms, again {ms2:.4f} ms ({ops / ms / 1e9:.2f} "
        f"TFLOP/s of the 2.5x count), fma kernel {fma_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms at B={plain_b}, SDPA backward {library_ms:.4f} "
        f"ms ({lib['backend']}), bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}; {ops:.4g} ops, "
        f"{nbytes} B), with the recompute of q k^T "
        f"{t['bound_recompute_ms']:.4f} ms, the wgmma design's seven "
        f"products {t['floor_7_products_ms']:.4f} ms")
    log(f"time forward bf16 ({LM_BATCH}, {s}, {h}, {hd}) causal, wgmma, in "
        f"turns: without L {' / '.join(f'{x:.4f}' for x in without)} ms "
        f"(mean {t['fwd_ms']:.4f}), with L "
        f"{' / '.join(f'{x:.4f}' for x in with_l)} ms (mean "
        f"{t['fwd_lse_ms']:.4f})")
    del q, k, v, o, do, lse, qf, kf, vf
    free()
    return t


def mask_pairs(s: int, t: int, causal: bool, window: int | None) -> int:
    """The (q, key) pairs the mask allows over `s` rows and `t` keys: the
    work a flash kernel does on these inputs."""
    q = torch.arange(s, dtype=torch.int64)
    hi = q.clamp(max=t - 1) if causal else torch.full_like(q, t - 1)
    lo = (q - window + 1).clamp(min=0) if window else torch.zeros_like(q)
    return int((hi - lo + 1).clamp(min=0).sum())


def sdpa_backend(*args, **kw) -> str:
    """The backend PyTorch's SDPA dispatch picks for these arguments."""
    from torch.nn.attention import SDPBackend
    names = {m.value: n.lower() for n, m in SDPBackend.__members__.items()}
    return names.get(int(torch._fused_sdp_choice(*args, **kw)), "unknown")


def sdpa_yardstick(q, k, v, do=None, causal: bool = True,
                   window: int | None = None) -> dict:
    """SDPA on (B,S,H,hd) q and (B,T,KH,hd) k/v, timed as one library call
    (yardstick only; the port never calls it): the forward, or with `do`
    the backward (autograd.grad of one recorded call). GQA through
    `enable_gqa` where a fused backend takes it; else k/v repeated to H
    heads beforehand (not timed) where one then does; the window as a
    boolean mask. The math backend, which materializes the scores, is not
    run: backend "none". Returns {"ms", "backend", "kv"}."""
    grad = do is not None
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(grad)
                  for x in (q, k, v))
    kw = {"is_causal": causal} if window is None else {}
    if window is not None:
        pos = torch.arange(q.shape[1], device=q.device)
        ok = pos[None, :] > pos[:, None] - window
        if causal:
            ok &= pos[None, :] <= pos[:, None]
        kw["attn_mask"] = ok
    kv = "enable_gqa"
    backend = sdpa_backend(qt, kt, vt, enable_gqa=True, **kw)
    if backend == "math":
        g = q.shape[2] // k.shape[2]
        kt, vt = (x.detach().repeat_interleave(g, dim=1).requires_grad_(grad)
                  for x in (kt, vt))
        kv = f"k/v repeated to {q.shape[2]} heads (untimed)"
        backend = sdpa_backend(qt, kt, vt, **kw)
    else:
        kw["enable_gqa"] = True
    if backend == "math":
        return {"ms": None, "backend": "none", "kv": kv}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if grad:
        out = sdpa(qt, kt, vt, **kw)
        dot = do.transpose(1, 2)
        ms = time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), reps=5)
        del out, dot
    else:
        with torch.no_grad():
            ms = time_ms(lambda: sdpa(qt, kt, vt, **kw), reps=10)
    del qt, kt, vt, kw
    free()
    return {"ms": ms, "backend": backend, "kv": kv}


def gemma_bwd_timing(gen) -> dict:
    """K2's backward at gemma3-12b's training shape, bf16 q (8, 4,096, 16,
    256), k/v (8, 4,096, 8, 256), for its global (causal) layer and a
    local one (window 1,024): the wgmma kernel, in turns with the fma
    kernel on the same inputs (wgmma, fma, wgmma; bwd_dot, bwd_dkdv and
    bwd_dq apart come from the profiled train step, `gemma_main_path`);
    SDPA's backward (`sdpa_yardstick`);
    the bound, the larger of 2.5x the forward's operations over the mask's
    pairs at the bf16 tensor-core rate and the bytes of q, k, v, o, do
    read and dq, dk, dv written; the design's seven-product floor (3.5x).
    Then the wgmma forward at the prefill shape (B=4), causal, beside SDPA
    and its bound."""
    cfg = configs.get(GEMMA3)
    b, s, h, kh, hd = (TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads,
                       cfg.num_kv_heads, cfg.head_dim)
    q = randn(gen, (b, s, h, hd), torch.bfloat16)
    k = randn(gen, (b, s, kh, hd), torch.bfloat16)
    v = randn(gen, (b, s, kh, hd), torch.bfloat16)
    do = randn(gen, (b, s, h, hd), torch.bfloat16)
    nbytes = (4 * b * s * h * hd + 4 * b * s * kh * hd) * 2
    t = {"shape": f"bf16 q ({b}, {s}, {h}, {hd}), k/v ({b}, {s}, {kh}, "
                  f"{hd}), causal", "bytes": nbytes}
    for window in (None, cfg.pattern[0].window):
        with torch.no_grad():
            o, lse = flash.flash_attention_cuda(q, k, v, window=window,
                                                return_lse=True)
        fwd_ops = 4 * b * h * mask_pairs(s, s, True, window) * hd
        ops = 2.5 * fwd_ops
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S

        def wgmma():
            return flash.flash_attention_bwd_cuda(q, k, v, o, do, True,
                                                  window, lse=lse)

        def fma():
            with fma_route():
                return flash.flash_attention_bwd_cuda(q, k, v, o, do, True,
                                                      window)
        ms = time_ms(wgmma, reps=10)
        fma_ms = time_ms(fma, reps=1, warmup=1)
        ms2 = time_ms(wgmma, reps=10, warmup=1)
        lib = sdpa_yardstick(q, k, v, do, True, window)
        row = {"ms": ms, "ms_again": ms2, "fma_ms": fma_ms,
               "library_ms": lib["ms"],
               "library_backend": lib["backend"], "library_kv": lib["kv"],
               "ops": ops, "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "floor_7_products_ms": 3.5 * fwd_ops / BF16_OPS_PER_S * 1e3}
        t["global" if window is None else "local"] = row
        lib_txt = ("none" if lib["ms"] is None else
                   f"{lib['ms']:.4f} ms ({lib['backend']}, {lib['kv']})")
        log(f"[{SMI[0]}] time backward gemma3 layer bf16 B={b} S={s} H={h} "
            f"KH={kh} hd={hd} causal window={window}: wgmma kernel "
            f"{ms:.4f} ms, again {ms2:.4f} ms ({ops / ms / 1e9:.2f} TFLOP/s "
            f"of the 2.5x count), fma kernel "
            f"{fma_ms:.4f} ms, SDPA backward {lib_txt}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}; {ops:.4g} ops, "
            f"{nbytes} B), the seven products' floor "
            f"{row['floor_7_products_ms']:.4f} ms")
        del o, lse
        free()
    qf, kf, vf = q[:LM_BATCH], k[:LM_BATCH], v[:LM_BATCH]
    w = attention_work(LM_BATCH, s, h, kh, hd, torch.bfloat16)
    fwd_ms = time_ms(lambda: flash.flash_attention_cuda(qf, kf, vf), reps=20)
    lib = sdpa_yardstick(qf, kf, vf)
    t["forward"] = {"ms": fwd_ms, "library_ms": lib["ms"],
                    "library_backend": lib["backend"],
                    "bound_ms": w["bound_ms"], "bound_by": w["bound_by"],
                    "shape": f"bf16 q ({LM_BATCH}, {s}, {h}, {hd}), causal"}
    log(f"[{SMI[0]}] time forward gemma3 layer bf16 B={LM_BATCH} S={s} "
        f"H={h} KH={kh} hd={hd} causal: wgmma kernel {fwd_ms:.4f} ms "
        f"({w['ops'] / fwd_ms / 1e9:.2f} TFLOP/s), SDPA "
        + ("none" if lib["ms"] is None else
           f"{lib['ms']:.4f} ms ({lib['backend']})")
        + f", bound {w['bound_ms']:.4f} ms ({w['bound_by']})")
    del q, k, v, do, qf, kf, vf
    free()
    return t


def sdpa_tf32(q, k, v, do=None) -> dict:
    """SDPA (causal) with TF32 allowed for f32 matmuls and convolutions,
    restored after: its time as one library call (`sdpa_yardstick`) and,
    for the forward, its output (B,S,H,hd), to hold against
    `attention_ref`: what one TF32 product per multiply gives."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        lib = sdpa_yardstick(q, k, v, do)
        if do is None and lib["ms"] is not None:
            with torch.no_grad():
                lib["out"] = torch.nn.functional.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True).transpose(1, 2)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    return lib


def f32_yardsticks(gen) -> dict:
    """K2's f32 routes, causal, at qwen3's shapes (the forward at the
    prefill shape (4, 4,096, 16, 128), the backward at the training shape
    (8, 4,096, 16, 128)) and at gemma3's hd-256 global layer (2, 4,096,
    16, 256): the tf32x3 kernel and the fma kernel on the same inputs in
    turns (tf32x3, fma, tf32x3); SDPA in f32 with TF32 off
    (`sdpa_yardstick`, naming its backend) and with TF32 on (`sdpa_tf32`;
    in the forward its error against `attention_ref` beside the tf32x3
    kernel's); each beside the 3xTF32 bound (three TF32 products for each
    operation, or the bytes), the backward's 7-product floor (S and dP
    recomputed in both walks) and the f32-FMA bound."""
    require(not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    qcfg, gcfg = configs.get(TRAIN_ARCH), configs.get(GEMMA3)
    out = {}
    for key, what, b, cfg in (("forward", "forward", LM_BATCH, qcfg),
                              ("backward", "backward", TRAIN_BATCH, qcfg),
                              ("gemma3_forward", "forward", 2, gcfg),
                              ("gemma3_backward", "backward", 2, gcfg)):
        h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = randn(gen, (b, TRAIN_SEQ, h, hd))
        k = randn(gen, (b, TRAIN_SEQ, kh, hd))
        v = randn(gen, (b, TRAIN_SEQ, kh, hd))
        w = attention_work(b, TRAIN_SEQ, h, kh, hd, torch.float32)
        bwd = what == "backward"
        ops = w["ops"] * (2.5 if bwd else 1.0)
        nbytes = w["bytes"] * (2 if bwd else 1)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = 3 * ops / TF32_OPS_PER_S
        row = {"bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "fp32_bound_ms": max(t_bytes, ops / FP32_OPS_PER_S) * 1e3,
               "ops": ops, "bytes": nbytes,
               "shape": f"f32 q ({b}, {TRAIN_SEQ}, {h}, {hd}), k/v "
                        f"({b}, {TRAIN_SEQ}, {kh}, {hd}), causal"}
        if bwd:
            row["floor_7_products_ms"] = (3 * 3.5 * w["ops"]
                                          / TF32_OPS_PER_S * 1e3)
            do = randn(gen, (b, TRAIN_SEQ, h, hd))
            with torch.no_grad():
                o, lse = flash.flash_attention_cuda(q, k, v, return_lse=True)

            def tf32():
                return flash.flash_attention_bwd_cuda(q, k, v, o, do,
                                                      lse=lse)

            def fma():
                with fma_route():
                    return flash.flash_attention_bwd_cuda(q, k, v, o, do)
            reps = (3, 2)
        else:
            do = None

            def tf32():
                return flash.flash_attention_cuda(q, k, v)

            def fma():
                return flash._launch("fma", q, k, v, True, None)
            reps = (10, 3)
        before = dict(flash.flash_attention_cuda.route_launches)
        bbefore = dict(flash.flash_attention_bwd_cuda.route_launches)
        row["ms"] = time_ms(tf32, reps=reps[0], warmup=1)
        row["fma_ms"] = time_ms(fma, reps=reps[1], warmup=1)
        row["ms_again"] = time_ms(tf32, reps=reps[0], warmup=1)
        took = (flash.flash_attention_bwd_cuda.route_launches["tf32x3"]
                - bbefore["tf32x3"]) if bwd else (
            flash.flash_attention_cuda.route_launches["tf32x3"]
            - before["tf32x3"])
        require(took == 2 * (reps[0] + 1),
                f"f32 {key}: {took} tf32x3 launches timed")
        if bwd:           # the plain version at the largest batch it fits
            row["plain_ms"] = row["plain_batch"] = None
            for pb in (b, b // 2, b // 4, 1):
                try:
                    free()
                    row["plain_ms"] = time_ms(lambda: attention_bwd_ref(
                        q[:pb], k[:pb], v[:pb], o[:pb], do[:pb]), reps=1,
                        warmup=1)
                    row["plain_batch"] = pb
                    break
                except torch.cuda.OutOfMemoryError:
                    continue
            free()
        else:
            row["plain_ms"] = time_ms(lambda: attention_ref(q, k, v),
                                      reps=2, warmup=1)
            row["plain_batch"] = b
        lib = sdpa_yardstick(q, k, v, do)
        row.update(library_ms=lib["ms"], library_backend=lib["backend"],
                   library_kv=lib["kv"])
        lib32 = sdpa_tf32(q, k, v, do)
        row.update(tf32_library_ms=lib32["ms"],
                   tf32_library_backend=lib32["backend"])
        note = ""
        if not bwd:
            ref = attention_ref(q, k, v)
            mine = tf32()
            row["max_abs_err"] = float((mine - ref).abs().max())
            if "out" in lib32:
                row["tf32_library_max_abs_err"] = float(
                    (lib32.pop("out") - ref).abs().max())
            note = (f"; max|err| against attention_ref: tf32x3 kernel "
                    f"{row['max_abs_err']:.3e}, SDPA with TF32 on "
                    f"{row.get('tf32_library_max_abs_err', math.nan):.3e} "
                    f"(atol {ATTN_ATOL[torch.float32]:g})")
            del ref, mine
        floor = (f", 7-product floor {row['floor_7_products_ms']:.4f} ms"
                 if bwd else "")
        log(f"[{SMI[0]}] time {what} f32 B={b} S={TRAIN_SEQ} H={h} KH={kh} "
            f"hd={hd} causal, in turns: tf32x3 kernel {row['ms']:.4f} ms, "
            f"fma kernel {row['fma_ms']:.4f} ms, tf32x3 again "
            f"{row['ms_again']:.4f} ms ({3 * ops / row['ms'] / 1e9:.2f} "
            f"TFLOP/s of TF32 products); SDPA TF32 off "
            + ("none" if lib["ms"] is None else
               f"{lib['ms']:.4f} ms ({lib['backend']}, {lib['kv']})")
            + ", SDPA TF32 on "
            + ("none" if lib32["ms"] is None else
               f"{lib32['ms']:.4f} ms ({lib32['backend']})")
            + f"; plain {row['plain_ms']:.4f} ms at B={row['plain_batch']}"
            f"; bound {row['bound_ms']:.4f} ms at 3xTF32 "
            f"({row['bound_by']}){floor}, f32-FMA bound "
            f"{row['fp32_bound_ms']:.4f} ms{note}")
        out[key] = row
        del q, k, v, do
        if bwd:
            del o, lse
        free()
    return out


KERNEL_CLASSES = (("K3 forward", ("ssd_intra_y", "ssd_intra_state")),
                  ("K3 backward", ("ssd_bwd_",)),
                  ("K2 forward", ("flash_wgmma", "flash_fwd", "fwd_tf32")),
                  ("K2 backward", ("bwd_prep", "bwd_dot", "bwd_dkdv",
                                   "bwd_dq")),
                  ("cuBLAS GEMM", ("gemm", "xmma", "cutlass", "cublas",
                                   "nvjet", "Kernel2")),
                  ("elementwise", ("elementwise",)),
                  ("reductions", ("reduce", "softmax", "logsumexp")))


def grad_spy(record: list, keep_grads: bool = False):
    """`adamw.adamw_update` that first reads, per parameter, whether its
    gradient is finite and non-zero (one host read per step), keeps
    copies of the gradients with `keep_grads`, and times the update with
    CUDA events; one entry per step is appended to `record` (patched in
    for phase 18)."""
    update = adamw.adamw_update

    def spying(grads, opt_state, params, cfg):
        names = list(grads)
        flags = torch.stack([torch.stack((torch.isfinite(g).all(),
                                          (g != 0).any()))
                             for g in grads.values()]).cpu()
        entry = {"finite": {n: bool(f[0]) for n, f in zip(names, flags)},
                 "nonzero": {n: bool(f[1]) for n, f in zip(names, flags)}}
        if keep_grads:
            entry["grads"] = {n: g.detach().clone() for n, g in grads.items()}
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        out = update(grads, opt_state, params, cfg)
        end.record()
        entry["events"] = (start, end)
        record.append(entry)
        return out
    return mock.patch.object(adamw, "adamw_update", spying)


def profile_train_step(step_fn, state, batch,
                       shares: dict | None = None) -> dict:
    """One profiled train step: device time by kernel class, the chunked
    CE's forward and the AdamW update as ranges, and the device's busy
    share of the step's wall. Returns the device ms of each call of K2's
    backward functions (bwd_dot, bwd_dkdv, bwd_dq), in launch order ({}
    when the profiler saw no device time); `shares`, when given, takes the
    step's wall and busy ms and each kernel class's device ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def spanned(name, f):
        def g(*a, **kw):
            with record_function(name):
                return f(*a, **kw)
        return g

    spans = {"chunked CE forward": (M, "chunked_ce"),
             "AdamW update": (adamw, "adamw_update")}
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        for name, (mod, attr) in spans.items():
            stack.enter_context(mock.patch.object(
                mod, attr, spanned(name, getattr(mod, attr))))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step_fn(state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in events if str(e.device_type).endswith("CUDA")
               and e.key not in spans]
    busy = sum(ms for _, ms, _ in kernels)
    if not busy:
        log("profile train step: device time not measured (no device "
            "events)")
        return {}
    classes = {name: 0.0 for name, _ in KERNEL_CLASSES}
    other = 0.0
    for key, ms, _ in kernels:
        for name, marks in KERNEL_CLASSES:
            if any(m in key for m in marks):
                classes[name] += ms
                break
        else:
            other += ms
    parts = {e.key: e.device_time_total / 1e3 for e in events
             if e.key in spans}
    if shares is not None:
        shares.update(classes, wall_ms=wall, busy_ms=busy, other_ms=other)
    log(f"profile train step: wall {wall:.1f} ms, device busy {busy:.1f} ms "
        f"({busy / wall:.1%}), {sum(c for _, _, c in kernels)} device ops; "
        + ", ".join(f"{n} {ms:.1f} ms ({ms / busy:.1%})"
                    for n, ms in classes.items())
        + f", other {other:.1f} ms ({other / busy:.1%}); ranges: "
        + ", ".join(f"{n} {parts.get(n, 0.0):.1f} ms" for n in spans))
    for key, ms, count in sorted(kernels, key=lambda r: -r[1])[:14]:
        log(f"  device {ms:9.3f} ms {count:6d}x  {key[:90]}")
    for key, ms, count in kernels:   # K3's backward, function by function
        if "ssd_bwd_" in key:
            name = key[key.index("ssd_bwd_"):].split("(")[0]
            log(f"  K3 backward {name}: "
                f"{ms:.3f} ms in {count} calls, {ms / count:.4f} ms each")
    # K2's backward, function by function, call by call
    calls: dict = {}
    for e in sorted((e for e in prof.events()
                     if str(e.device_type).endswith("CUDA")),
                    key=lambda e: e.time_range.start):
        for fn in ("bwd_dot", "bwd_dkdv", "bwd_dq"):
            if f"::{fn}" in e.name:
                calls.setdefault(fn, []).append(e.self_device_time_total / 1e3)
    for fn, ms in calls.items():
        log(f"  K2 backward {fn}: {sum(ms):.3f} ms in {len(ms)} calls, in "
            f"launch order {', '.join(f'{x:.4f}' for x in ms)} ms")
    return calls


def ce_timing(cfg) -> float:
    """The chunked CE alone, forward and backward, at the main path's
    shape (hidden (8, 4,096, 1,024) bf16, the tied head): device ms."""
    params = M.init_params(dataclasses.replace(cfg, num_layers=0), seed=2)
    hidden = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model),
                         device="cuda").to(torch.bfloat16).requires_grad_()
    labels = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                           device="cuda")
    w = params.embedding["embed"].requires_grad_()

    def run():
        loss = M.chunked_ce(params, hidden, labels, cfg)
        torch.autograd.grad(loss, (hidden, w))
    ms = time_ms(run, reps=2, warmup=1)
    del params, hidden, labels, w
    free()
    return ms


def k2_launches() -> dict:
    """K2's launches since the last `reset_counts`: the forward by route,
    the backward by route (``bwd_<route>``)."""
    fwd = flash.flash_attention_cuda.route_launches
    bwd = flash.flash_attention_bwd_cuda.route_launches
    return {**fwd, **{f"bwd_{r}": n for r, n in bwd.items()}}


def k2_want(**counts) -> dict:
    """`k2_launches()`'s keys, each 0 but those given."""
    want = dict.fromkeys(flash.ROUTES, 0)
    want.update((f"bwd_{r}", 0) for r in flash.BWD_ROUTES)
    require(set(counts) <= set(want), f"k2_want: no route in {counts}")
    return {**want, **counts}


def train_cell(arch: str, kind: str, leaves: tuple,
               layers: int | None = None) -> tuple:
    """`arch` whole (or its first `layers` layers, whole pattern periods),
    bf16, B=8 x 4,096 from `SyntheticTextDataset(vocab, 4,096, 8, seed=0)`
    through `make_train_step` with remat, 5 steps, the counts set to 0 just
    before: a finite, falling loss; every gradient finite; the gradients of
    `blocks.<layer>.<kind>.<leaf>` for `leaves` non-zero in every layer
    (every layer is of that kind). Returns (cfg, step_fn, state, ds, out)
    with the logged numbers in `out`; the caller reads the launches before
    it launches anything else."""
    cfg = configs.get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    free()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, seed=0)
    opt_cfg = AdamWConfig(total_steps=TRAIN_STEPS,
                          warmup_steps=TRAIN_STEPS // 10 + 1)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    step_fn = steps.make_train_step(cfg, opt_cfg)
    ds = SyntheticTextDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    record: list = []
    losses, walls, gnorms = [], [], []
    # the main path: counts start at 0 here
    reset_counts()
    with grad_spy(record):
        for step, batch in make_batches(ds, 0, TRAIN_STEPS):
            batch = {k: torch.from_numpy(x).cuda() for k, x in batch.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(loss)
            gnorms.append(float(metrics["grad_norm"]))
            log(f"{arch} train step {step + 1}: loss {loss:.6f}, lr "
                f"{float(metrics['lr']):.3e}, grad norm "
                f"{float(metrics['grad_norm']):.4f}, wall {walls[-1]:.3f} s")
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"{arch} train: losses {losses} not finite or not falling")
    require(len(record) == TRAIN_STEPS, "the AdamW spy missed a step")
    for i, entry in enumerate(record):
        bad = [n_ for n_, ok in entry["finite"].items() if not ok]
        require(not bad, f"step {i + 1}: non-finite gradients {bad[:4]}")
        for layer in range(cfg.num_layers):
            for leaf in leaves:
                name = f"blocks.{layer}.{kind}.{leaf}"
                require(entry["nonzero"][name],
                        f"step {i + 1}: the gradient of {name} is zero: "
                        "the kernel's backward did not reach it")
    adamw_ms = [e[0].elapsed_time(e[1]) for e in
                (r["events"] for r in record)]
    ntok = TRAIN_BATCH * TRAIN_SEQ
    med = float(np.median(walls[1:]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = {"losses": losses, "grad_norms": gnorms, "walls": walls,
           "ms_per_step": med * 1e3,
           "tokens_per_s": ntok / med, "peak_gib": peak,
           "adamw_ms": float(np.median(adamw_ms))}
    log(f"{arch} train B={TRAIN_BATCH} S={TRAIN_SEQ} bf16, remat, "
        f"{TRAIN_STEPS} steps: losses {[round(x, 6) for x in losses]}; "
        f"every gradient finite; {'/'.join(leaves)} non-zero in all "
        f"{cfg.num_layers} layers; {out['ms_per_step']:.1f} ms per step, "
        f"{out['tokens_per_s']:.1f} tokens/s (median of steps 2-"
        f"{TRAIN_STEPS}); AdamW update {out['adamw_ms']:.2f} ms (device)")
    log_memory(f"{arch} train")
    return cfg, step_fn, state, ds, out


def train_main_path(gen) -> tuple[dict, dict]:
    """qwen3-0.6b whole, bf16, B=8 x 4,096 through `make_train_step` with
    remat, 5 steps (`train_cell`). Returns the launches (K2 forward by
    route, backward) and the logged numbers."""
    cfg, step_fn, state, ds, out = train_cell(
        TRAIN_ARCH, "attn", ("wq", "wk", "wv", "q_norm", "k_norm"))
    launches = k2_launches()
    n = cfg.num_layers * TRAIN_STEPS
    require(launches == k2_want(wgmma=2 * n, bwd_wgmma=n)
            and flash.flash_attention_bwd_cuda.launches == n,
            f"{TRAIN_ARCH} train: launches {launches}; want {2 * n} K2 "
            f"forward (wgmma; remat runs each block twice) and {n} backward "
            "(wgmma)")
    log(f"{TRAIN_ARCH} train: K2 launches {launches}")
    batch = {k: torch.from_numpy(x).cuda()
             for k, x in ds.batch_at(TRAIN_STEPS).items()}
    profile_train_step(step_fn, state, batch)
    del state, batch
    free()
    out["ce_ms"] = ce_timing(cfg)
    log(f"chunked CE alone (8 chunks, fwd + bwd, hidden ({TRAIN_BATCH}, "
        f"{TRAIN_SEQ}, {cfg.d_model}) bf16): {out['ce_ms']:.2f} ms")
    return launches, out


F32_TRAIN_BATCH, F32_TRAIN_STEPS = 2, 3   # qwen3 whole in f32, B=2 x 4,096


@contextlib.contextmanager
def fma_routes():
    """K2's forward and backward both patched onto their "fma" routes, here
    only (the package has no such knob): the f32 train step's comparison,
    never the main path."""
    with mock.patch.object(flash, "route", lambda dtype, hd: "fma"), \
            fma_route():
        yield


def f32_main_path() -> tuple[dict, dict]:
    """qwen3-0.6b whole (28 layers) at full width in f32, B=2 x 4,096
    from `SyntheticTextDataset(vocab, 4,096, 2, seed=4)` through
    `make_train_step` with remat, 3 steps, the counts set to 0 just
    before: a finite, falling loss; every gradient finite; K2's forward
    2 x 28 x 3 launches and backward 28 x 3, all tf32x3; one profiled step
    (K2's forward and backward device ms and share); then step 1 again from
    the same parameters and batch with both K2 routes patched to "fma"
    (`fma_routes`): its loss within 1e-5 relative and every gradient within
    a relative Frobenius error of 1e-4 of the tf32x3 step's. Returns the
    launches (the main path's and the patched step's) and the logged
    numbers."""
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH),
                              param_dtype="float32",
                              activation_dtype="float32")
    free()
    torch.cuda.reset_peak_memory_stats()
    opt_cfg = AdamWConfig(total_steps=F32_TRAIN_STEPS, warmup_steps=1)
    ds = SyntheticTextDataset(cfg.vocab_size, TRAIN_SEQ, F32_TRAIN_BATCH,
                              seed=4)
    batches = [{k: torch.from_numpy(x).cuda() for k, x in b.items()}
               for _, b in make_batches(ds, 0, F32_TRAIN_STEPS + 1)]
    runs, shares, peak = [], {}, 0.0
    for patched in (False, True):
        params = M.init_params(cfg, seed=6)
        state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
        step_fn = steps.make_train_step(cfg, opt_cfg)
        record: list = []
        losses, walls = [], []
        # the f32 main path: counts start at 0 here (the patched step's
        # are read apart)
        reset_counts()
        with (fma_routes() if patched else contextlib.nullcontext()), \
                grad_spy(record, True):
            for batch in batches[:1 if patched else F32_TRAIN_STEPS]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                losses.append(float(metrics["loss"]))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if len(record) > 1:        # step 1's gradients are kept
                    record[-1].pop("grads")
        launches = k2_launches()
        runs.append((losses, walls, record, launches))
        if not patched:
            n = cfg.num_layers * F32_TRAIN_STEPS
            require(launches == k2_want(tf32x3=2 * n, bwd_tf32x3=n)
                    and flash.flash_attention_bwd_cuda.launches == n,
                    f"{TRAIN_ARCH} f32 train: launches {launches}; want "
                    f"{2 * n} K2 forward (remat runs each block twice) and "
                    f"{n} backward, all tf32x3")
            bad = [n_ for e in record for n_, ok in e["finite"].items()
                   if not ok]
            require(all(math.isfinite(x) for x in losses)
                    and losses[-1] < losses[0] and not bad,
                    f"{TRAIN_ARCH} f32 train: losses {losses}, non-finite "
                    f"gradients {bad[:4]}")
            peak = torch.cuda.max_memory_allocated() / 2**30
            profile_train_step(step_fn, state, batches[-1], shares)
        del params, state
        free()
    (losses, walls, record, launches), (lf, _, rf, lf_launches) = runs
    n = cfg.num_layers
    require(lf_launches == k2_want(fma=2 * n, bwd_fma=n),
            f"{TRAIN_ARCH} f32 patched step: launches {lf_launches}; want "
            f"{2 * n} K2 forward and {n} backward, all fma")
    rel = grads_rel(record[0]["grads"], rf[0]["grads"])
    worst = max(rel, key=rel.get)
    attn = max(v for k, v in rel.items() if ".attn." in k)
    ok = (abs(losses[0] - lf[0]) <= 1e-5 * abs(lf[0])
          and rel[worst] <= 1e-4)
    med = float(np.median(walls[1:]))
    ntok = F32_TRAIN_BATCH * TRAIN_SEQ
    out = {"losses": losses, "walls": walls, "ms_per_step": med * 1e3,
           "tokens_per_s": ntok / med, "peak_gib": peak,
           "fma_loss": lf[0], "worst_grad_rel": rel[worst],
           "worst_grad": worst, "worst_attn_grad_rel": attn,
           "profile": shares}
    busy = shares.get("busy_ms")
    log(f"[{SMI[0]}] {TRAIN_ARCH} f32 train ({cfg.num_layers} layers, full "
        f"width, B={F32_TRAIN_BATCH} S={TRAIN_SEQ}, remat, "
        f"{F32_TRAIN_STEPS} steps): losses {losses}; every gradient "
        f"finite; {out['ms_per_step']:.1f} ms per step, "
        f"{out['tokens_per_s']:.1f} tokens/s (median of steps 2-"
        f"{F32_TRAIN_STEPS}); peak {peak:.2f} GiB; K2 launches {launches}; "
        + ("profiled step: device time not measured" if not busy else
           f"profiled step: K2 forward {shares['K2 forward']:.1f} ms "
           f"({shares['K2 forward'] / busy:.1%} of {busy:.1f} ms busy), "
           f"K2 backward {shares['K2 backward']:.1f} ms "
           f"({shares['K2 backward'] / busy:.1%})"))
    log(f"{TRAIN_ARCH} f32 step 1, tf32x3 vs both K2 routes patched to fma: "
        f"loss {losses[0]!r} vs {lf[0]!r} (rtol 1e-5); worst gradient "
        f"relative Frobenius {rel[worst]:.3e} ({worst}), worst attention "
        f"weight {attn:.3e} (tol 1e-4); patched launches {lf_launches}: "
        f"{ok}")
    require(ok, f"{TRAIN_ARCH} f32 train: the tf32x3 step disagrees with "
            "the same step through the fma kernels")
    del runs, record, rf
    free()
    return {"main": launches, "patched": lf_launches}, out


def grads_rel(gk: dict, gp: dict) -> dict:
    """Each gradient's relative Frobenius error (absolute where the
    reference is 0)."""
    return {n: float((gk[n] - gp[n]).norm() / gp[n].norm()) if float(
        gp[n].norm()) else float((gk[n] - gp[n]).norm()) for n in gk}


def update_hold(gk: dict, gp: dict, pk: dict, pp: dict,
                opt_cfg) -> tuple[dict, int, int, float]:
    """The first AdamW step's parameters pk (from gradients gk) against pp
    (from gp). AdamW's first step moves an element by lr * g/(|g| + eps)
    on the clipped gradient g: between two runs' gradients a and b that
    update differs by at most lr * eps |a - b| / (m + eps)^2, m = min(|a|,
    |b|) (0 when the signs differ). Returns (each parameter's worst excess
    over atol 1e-6 plus that bound, the elements past 1e-6, the elements,
    max |diff|)."""
    lr = float(adamw.cosine_schedule(1, opt_cfg))
    eps = opt_cfg.eps
    clip = [min(1.0, opt_cfg.clip_norm / max(float(adamw.global_norm(g)),
                                             1e-9)) for g in (gk, gp)]
    excess, over = {}, 0
    total = sum(p.numel() for p in pk.values())
    for n in pk:
        a, b = gk[n].float() * clip[0], gp[n].float() * clip[1]
        m = torch.where(a * b > 0, torch.minimum(a.abs(), b.abs()), 0.0)
        sens = lr * eps * (a - b).abs() / (m + eps) ** 2
        diff = (pk[n] - pp[n]).abs()
        over += int((diff > 1e-6).sum())
        excess[n] = float((diff - 1e-6 - sens).max())
    dp_max = max(float((pk[n] - pp[n]).abs().max()) for n in pk)
    return excess, over, total, dp_max


def hold_f32(gen) -> dict:
    """qwen3 at full width cut to 2 layers, f32, B=2 x 256: one train step
    through the kernels against the same step with `attention_ref` in K2's
    place (swapped here only): losses rtol 1e-5, every gradient relative
    Frobenius 1e-4, the updated parameters atol 1e-6 plus AdamW's own
    first-step sensitivity to the two gradients' difference (an element
    whose clipped gradient is near 0 moves by lr * g/(|g| + 1e-8)), with
    at most 0.01% of the elements past 1e-6; then 3 steps each, losses
    rtol 1e-4. Returns K2's launches by route (all tf32x3)."""
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH), num_layers=HOLD_LAYERS,
                              param_dtype="float32",
                              activation_dtype="float32")
    opt_cfg = AdamWConfig(total_steps=3, warmup_steps=1)
    ds = SyntheticTextDataset(cfg.vocab_size, HOLD_SEQ, HOLD_BATCH, seed=1)

    def plain(q, k, v, causal, window):
        return attention_ref(q, k, v, causal=causal, window=window)

    runs = []
    # the f32 hold's path: counts start at 0 here
    reset_counts()
    for swap in (False, True):
        params = M.init_params(cfg, seed=3)
        state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
        step_fn = steps.make_train_step(cfg, opt_cfg)
        record: list = []
        losses = []
        with (mock.patch.object(attention, "attend", plain) if swap
              else contextlib.nullcontext()), grad_spy(record, True):
            for i in range(3):
                batch = {k: torch.from_numpy(x).cuda()
                         for k, x in ds.batch_at(i).items()}
                state, metrics = step_fn(state, batch)
                losses.append(float(metrics["loss"]))
                if i == 0:
                    after = {n: p.detach().clone()
                             for n, p in params.named_parameters()}
        runs.append((losses, record[0]["grads"], after))
        del params, state, record
    launches = k2_launches()
    require(launches == k2_want(tf32x3=2 * 3 * HOLD_LAYERS,
                                bwd_tf32x3=3 * HOLD_LAYERS),
            f"f32 hold: K2 launches {launches}; the plain run must launch "
            "none")
    (lk, gk, pk), (lp, gp, pp) = runs
    rel = grads_rel(gk, gp)
    worst = max(rel, key=rel.get)
    excess, over, total, dp_max = update_hold(gk, gp, pk, pp, opt_cfg)
    worst_p = max(excess, key=excess.get)
    # the bound is loose where the signs differ, so few elements may use it
    ok = (abs(lk[0] - lp[0]) <= 1e-5 * abs(lp[0]) and rel[worst] <= 1e-4
          and excess[worst_p] <= 0 and over <= 1e-4 * total)
    log(f"f32 hold ({HOLD_LAYERS} layers at full width, B={HOLD_BATCH} "
        f"S={HOLD_SEQ}): step 1 loss {lk[0]!r} (kernels) vs {lp[0]!r} "
        f"(attention_ref); worst gradient relative Frobenius {rel[worst]:.3e}"
        f" ({worst}); updated parameters: max |diff| {dp_max:.3e}, {over} "
        f"of {total} elements past 1e-6 (at most 0.01% may be), each within "
        f"1e-6 + AdamW's bound for its "
        f"gradient difference (worst margin {excess[worst_p]:.3e}, "
        f"{worst_p}): {ok}")
    require(ok, "f32 hold: the train step through the kernels disagrees "
            "with the same step on attention_ref")
    np_ok = bool(np.allclose(lk, lp, rtol=1e-4, atol=0))
    log(f"f32 hold, 3 steps: losses {lk} vs {lp} (rtol 1e-4): {np_ok}")
    require(np_ok, "f32 hold: 3-step losses disagree")
    free()
    return launches


def launch_counts() -> dict:
    """K2's launches by route (`k2_launches`) and K3's forward and
    backward launches, since the last `reset_counts`."""
    return {**k2_launches(), "ssd": ssd.ssd_intra_cuda.launches,
            "ssd_bwd": ssd.ssd_intra_bwd_cuda.launches}


def cli_resume(arch: str = TRAIN_ARCH) -> dict:
    """`python -m repro_torch.launch.train --arch <arch> --preset tiny` on
    the card (in process): 8 steps, then --resume to 12; a 12-step run
    resumed from its own step-8 checkpoint ends at the uninterrupted run's
    step-12 loss (rtol 1e-4: the embedding's gradient sums in no fixed
    order on the card). Returns `launch_counts()`: K2 (tf32x3) and K3 twice
    forward (remat) and once backward per layer and step."""
    base = ["--arch", arch, "--preset", "tiny", "--seq", "64",
            "--batch", "4", "--ckpt-every", "4", "--log-every", "4"]
    # the CLI's path: counts start at 0 here
    reset_counts()

    def run(ckpt, *extra) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train.main([*base, "--ckpt-dir", ckpt, *extra])
        text = buf.getvalue()
        require(rc == 0, f"train {extra}: rc {rc}\n{text}")
        return text

    def loss_at(text, step) -> float:
        for ln in text.splitlines():
            if f"step={step} " in ln:
                return float(ln.split("loss=")[1].split()[0])
        raise RuntimeError(f"no step={step} line in {text!r}")

    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        out = run(a, "--steps", "8")
        require("step=8" in out, f"train 8 steps: {out}")
        out = run(a, "--steps", "12", "--resume")
        require("resumed from step 8" in out and "step=12" in out,
                f"train --resume: {out}")
        full = run(b, "--steps", "12")
        shutil.rmtree(os.path.join(b, "step_00000012"))
        again = run(b, "--steps", "12", "--resume")
        require("resumed from step 8" in again, f"resume: {again}")
        l_full, l_again = loss_at(full, 12), loss_at(again, 12)
        ok = math.isfinite(l_full) and abs(l_again - l_full) <= 1e-4 * abs(
            l_full)
        log(f"train CLI on the card ({arch} tiny, seq 64, batch 4): 8 "
            f"steps, --resume to 12 ('resumed from step 8'); 12 steps "
            f"{l_full!r} vs resumed from its step 8 {l_again!r} (rtol "
            f"1e-4): {ok}")
        require(ok, f"train CLI {arch}: the resumed step-12 loss differs")
    # steps run: 8, 8 -> 12, 12, 8 -> 12; remat runs each block twice
    cfg = configs.get_smoke(arch)
    n_attn, n_ssd = (layers_of(cfg, kind) * (8 + 4 + 12 + 4)
                     for kind in ("attn", "mamba"))
    launches = launch_counts()
    require(launches == {**k2_want(tf32x3=2 * n_attn, bwd_tf32x3=n_attn),
                         "ssd": 2 * n_ssd, "ssd_bwd": n_ssd},
            f"train CLI {arch}: launches {launches}; want {2 * n_attn} K2 "
            f"forward and {n_attn} backward (tf32x3), {2 * n_ssd} K3 forward "
            f"and {n_ssd} backward")
    return launches


HOLD16_SEQ = 1_024


def hold_bf16_routes() -> dict:
    """qwen3 at full width cut to 2 layers, in its own bf16, B=2 x 1,024:
    one train step through the wgmma backward, then the same step with
    `flash.bwd_route` patched to "fma" (`fma_route`): the loss within 1e-3
    relative, every gradient within a relative Frobenius error of 1e-2
    (P and dS are rounded to bf16 before the wgmma products; the fma
    kernel keeps them in f32). Returns K2's launches by route."""
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH),
                              num_layers=HOLD_LAYERS)
    opt_cfg = AdamWConfig(total_steps=1, warmup_steps=1)
    ds = SyntheticTextDataset(cfg.vocab_size, HOLD16_SEQ, HOLD_BATCH, seed=2)
    batch = {k: torch.from_numpy(x).cuda() for k, x in ds.batch_at(0).items()}
    runs = []
    # the bf16 hold's path: counts start at 0 here
    reset_counts()
    for patched in (False, True):
        params = M.init_params(cfg, seed=4)
        state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
        step_fn = steps.make_train_step(cfg, opt_cfg)
        record: list = []
        with (fma_route() if patched else contextlib.nullcontext()), \
                grad_spy(record, True):
            state, metrics = step_fn(state, batch)
        runs.append((float(metrics["loss"]), record[0]["grads"]))
        del params, state, record
    launches = k2_launches()
    require(launches == k2_want(wgmma=2 * 2 * HOLD_LAYERS,
                                bwd_wgmma=HOLD_LAYERS, bwd_fma=HOLD_LAYERS),
            f"bf16 hold: K2 launches {launches}")
    (lw, gw), (lf, gf) = runs
    rel = grads_rel({n: g.float() for n, g in gw.items()},
                    {n: g.float() for n, g in gf.items()})
    worst = max(rel, key=rel.get)
    finite = all(bool(torch.isfinite(g).all()) for g in gw.values())
    ok = (finite and math.isfinite(lw) and abs(lw - lf) <= 1e-3 * abs(lf)
          and rel[worst] <= 1e-2)
    attn = max(v for n, v in rel.items() if ".attn." in n)
    log(f"bf16 hold ({HOLD_LAYERS} layers at full width, B={HOLD_BATCH} "
        f"S={HOLD16_SEQ}): loss {lw!r} (wgmma backward) vs {lf!r} (fma "
        f"backward); worst gradient relative Frobenius {rel[worst]:.3e} "
        f"({worst}), worst attention weight {attn:.3e}; every gradient "
        f"finite: {ok}")
    require(ok, "bf16 hold: the step through the wgmma backward disagrees "
            "with the same step through the fma backward")
    del runs, gw, gf
    free()
    return launches


def gemma_main_path() -> tuple[dict, dict]:
    """gemma3-12b at full width cut to one pattern period (6 of its 48
    layers: 5 local layers, window 1,024, and 1 global), bf16, B=8 x 4,096
    through `make_train_step` with remat, 5 steps (`train_cell`): K2's
    forward and backward at hd 256, all wgmma. Returns the launches and the
    logged numbers."""
    cfg, step_fn, state, ds, out = train_cell(
        GEMMA3, "attn", ("wq", "wk", "wv", "q_norm", "k_norm"),
        layers=GEMMA3_LAYERS)
    launches = k2_launches()
    n = cfg.num_layers * TRAIN_STEPS
    require(launches == k2_want(wgmma=2 * n, bwd_wgmma=n)
            and flash.flash_attention_bwd_cuda.launches == n,
            f"{GEMMA3} train: launches {launches}; want {2 * n} K2 forward "
            f"(wgmma; remat runs each block twice) and {n} backward (wgmma)")
    log(f"[{SMI[0]}] {GEMMA3} train ({cfg.num_layers} of 48 layers, full "
        f"width, {sum(p.numel() for p in state['params'].parameters())} "
        f"parameters): {out['ms_per_step']:.1f} ms per step, "
        f"{out['tokens_per_s']:.1f} tokens/s, peak {out['peak_gib']:.2f} "
        f"GiB; K2 launches {launches}")
    batch = {k: torch.from_numpy(x).cuda()
             for k, x in ds.batch_at(TRAIN_STEPS).items()}
    # the backward runs the layers last to first: the global layer (the
    # period's last) launches first, then the five local ones
    out["k2_bwd_calls"] = profile_train_step(step_fn, state, batch)
    del state, batch
    free()
    return launches, out


def hold_gemma_routes() -> dict:
    """gemma3-12b at full width, 6 layers, bf16, B=1 x 2,048 (past the
    local window): one `train_loss` (remat) and `autograd.grad` through the
    wgmma backward, then the same from the same parameters and batch with
    `flash.bwd_route` patched to "fma" (`fma_route`), no optimizer state:
    the loss within 1e-3 relative, every gradient finite and within a
    relative Frobenius error of 1e-2. Returns K2's launches by route."""
    cfg = dataclasses.replace(configs.get(GEMMA3), num_layers=GEMMA3_LAYERS)
    params = M.init_params(cfg, seed=5)
    ds = SyntheticTextDataset(cfg.vocab_size, GEMMA3_HOLD_SEQ, 1, seed=3)
    batch = {k: torch.from_numpy(x).cuda() for k, x in ds.batch_at(0).items()}
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    runs = []
    # the hold's path: counts start at 0 here
    reset_counts()
    for patched in (False, True):
        with fma_route() if patched else contextlib.nullcontext():
            loss = M.train_loss(params, batch, cfg, remat=True)
            grads = torch.autograd.grad(loss, list(named.values()),
                                        allow_unused=True)
        runs.append((float(loss.detach()), {
            n: (torch.zeros_like(p) if g is None else g).float()
            for (n, p), g in zip(named.items(), grads)}))
        del loss, grads
    launches = k2_launches()
    n = cfg.num_layers
    require(launches == k2_want(wgmma=2 * 2 * n, bwd_wgmma=n, bwd_fma=n),
            f"gemma3 route hold: K2 launches {launches}")
    (lw, gw), (lf, gf) = runs
    rel = grads_rel(gw, gf)
    worst = max(rel, key=rel.get)
    finite = all(bool(torch.isfinite(g).all()) for g in gw.values())
    ok = (finite and math.isfinite(lw) and abs(lw - lf) <= 1e-3 * abs(lf)
          and rel[worst] <= 1e-2)
    attn = max(v for k, v in rel.items() if ".attn." in k)
    log(f"[{SMI[0]}] gemma3 route hold ({n} layers at full width, bf16, B=1 "
        f"S={GEMMA3_HOLD_SEQ}): loss {lw!r} (wgmma backward) vs {lf!r} (fma "
        f"backward); worst gradient relative Frobenius {rel[worst]:.3e} "
        f"({worst}), worst attention weight {attn:.3e}; every gradient "
        f"finite; K2 {launches}: {ok}")
    require(ok, "gemma3 route hold: train_loss's gradients through the "
            "wgmma backward disagree with the fma backward's")
    params.requires_grad_(False)
    del runs, gw, gf, params, named, batch
    free()
    return launches


def phase_train(gen) -> tuple[dict, dict, dict, dict]:
    """Phase 18. Returns each backward route's max error, the backward's
    times, K2's launches by phase and route (forward wgmma, tf32x3, fma;
    backward the same) and the main paths' numbers."""
    t0 = time.perf_counter()
    err = bwd_cases(gen)
    err["lse"] = lse_cases(gen)
    log(f"phase 18 backward and L cases: {time.perf_counter() - t0:.1f} s")
    t_bwd = bwd_timing(gen)
    t0 = time.perf_counter()
    t_bwd["gemma3"] = gemma_bwd_timing(gen)
    t_bwd["f32"] = f32_yardsticks(gen)
    log(f"phase 18 gemma3 and f32 timing: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    main_launches, train_out = train_main_path(gen)
    log(f"phase 18 main path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    f32_launches, train_out["f32"] = f32_main_path()
    log(f"phase 18 f32 main path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    hold16 = hold_bf16_routes()
    hold = hold_f32(gen)
    cli = cli_resume()
    log(f"phase 18 holds and CLI: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gemma_launches, train_out["gemma3"] = gemma_main_path()
    for fn, ms in train_out["gemma3"]["k2_bwd_calls"].items():
        t_bwd["gemma3"]["global"][f"{fn}_ms"] = ms[0]
        t_bwd["gemma3"]["local"][f"{fn}_ms"] = float(np.mean(ms[1:]))
    hold_g = hold_gemma_routes()
    log(f"phase 18 gemma3 train and route hold: "
        f"{time.perf_counter() - t0:.1f} s")
    by_phase = {
        "wgmma": {"18 qwen3 train": main_launches["wgmma"],
                  "18 bf16 hold": hold16["wgmma"],
                  "18 gemma3 train": gemma_launches["wgmma"],
                  "18 gemma3 route hold": hold_g["wgmma"]},
        "tf32x3": {"18 qwen3 f32 train": f32_launches["main"]["tf32x3"],
                   "18 f32 hold": hold["tf32x3"], "18 CLI": cli["tf32x3"]},
        "fma": {"18 qwen3 f32 step (patched)":
                f32_launches["patched"]["fma"]},
        "bwd_wgmma": {"18 qwen3 train": main_launches["bwd_wgmma"],
                      "18 bf16 hold": hold16["bwd_wgmma"],
                      "18 gemma3 train": gemma_launches["bwd_wgmma"],
                      "18 gemma3 route hold": hold_g["bwd_wgmma"]},
        "bwd_tf32x3": {
            "18 qwen3 f32 train": f32_launches["main"]["bwd_tf32x3"],
            "18 f32 hold": hold["bwd_tf32x3"],
            "18 CLI": cli["bwd_tf32x3"]},
        "bwd_fma": {"18 bf16 hold (patched)": hold16["bwd_fma"],
                    "18 gemma3 route hold (patched)": hold_g["bwd_fma"],
                    "18 qwen3 f32 step (patched)":
                    f32_launches["patched"]["bwd_fma"]}}
    return err, t_bwd, by_phase, train_out


# ------------------------------------------------------------------ #
# training mamba2-370m and jamba's mamba layers (19)
# ------------------------------------------------------------------ #
MAMBA_ARCH = "mamba2_370m"
MAMBA_LEAVES = ("A_log", "D", "dt_bias", "wB", "wC")   # need dcums, dB, dC
MAMBA_HOLD_SEQ = 512
JAMBA_TRAIN_BATCH = 2


def ssd_bwd_work(b, nc, q, n, h, p) -> dict:
    """What the intra-chunk backward needs: per chunk G recomputed, dC =
    dG.B and dB's dG^T.C over the i >= j pairs; per head the decay, dAtt =
    dY.X^T and att^T.dY over the pairs, B.dS and X.dS^T over Q x N x P;
    C, B, dtx, cums, dy, dS read once, dC, dB, ddtx, dcums written once.
    `bound_ms` is the card's least time, as `ssd_work` puts it: every
    product as three TF32 products on the tensor cores (3 x ops / 495
    TFLOP/s, which meets SSD_ATOL) against the bytes; `f32_bound_ms` the
    same work as f32 FMAs on the CUDA cores (ops / 67 TFLOP/s), the floor
    of the route the kernel left."""
    pairs = q * (q + 1) // 2
    ops = b * nc * (6 * pairs * n + h * (pairs + 4 * pairs * p
                                         + 4 * q * n * p))
    nbytes = 4 * b * nc * (4 * q * n + 3 * q * h * p + 2 * q * h
                           + h * n * p)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * ops / TF32_OPS_PER_S
    return {"bytes": nbytes, "ops": ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_rate": "3xTF32: 3 x ops / 495 TFLOP/s",
            "f32_bound_ms": max(t_bytes, ops / FP32_OPS_PER_S) * 1e3}


def ssd_grads_hold(label: str, got, want, names) -> float:
    """Each gradient within SSD_ATOL x max(1, max|ref|) of its plain
    counterpart, and finite. Returns the largest error."""
    errs, ok = [], True
    for name, g, w in zip(names, got, want):
        err = float((g - w).abs().max())
        tol = SSD_ATOL * max(1.0, float(w.abs().max()))
        ok = ok and err <= tol and bool(torch.isfinite(g).all())
        errs.append(f"{name} {err:.3e} (tol {tol:.3g})")
    log(f"{label}: max|err| " + ", ".join(errs) + f": {ok}")
    require(ok, f"{label}: disagrees with the plain version")
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def ssd_bwd_check(label: str, gen, b, l, h, p, n, chunk,
                  a_shift=0.0) -> float:
    """The backward kernel against `ssd_intra_bwd_ref` on phase 7's inputs
    and seeded cotangents; two calls bit-equal."""
    x, dt, Bm, Cm, A_log, D = ssd_inputs(gen, b, l, h, p, n, a_shift)
    C_c, B_c, dtx, cums = chunk_inputs(x, dt, Bm, Cm, A_log, chunk)
    if a_shift:
        require(float(cums.min()) < -500,
                f"ssd bwd {label}: cums min {float(cums.min()):.1f} is not "
                "below -500")
        label += f", cums min {float(cums.min()):.1f}"
    nc = l // chunk
    dy, dS = randn(gen, (b, nc, chunk, h, p)), randn(gen, (b, nc, h, n, p))
    ins = (C_c, B_c, dtx, cums, dy, dS)
    got = ssd.ssd_intra_bwd_cuda(*ins)
    again = ssd.ssd_intra_bwd_cuda(*ins)
    torch.cuda.synchronize()
    bit = all(torch.equal(g, a) for g, a in zip(got, again))
    require(bit, f"ssd bwd {label}: two calls differ")
    return ssd_grads_hold(f"ssd bwd {label} (two calls bit-equal)", got,
                          ssd_intra_bwd_ref(*ins),
                          ("dC", "dB", "ddtx", "dcums"))


def ssd_function_checks(gen) -> float:
    """`ops.SSDIntra` against torch.autograd through `ssd_intra_ref`, and
    `ssd_chunked` under autograd (the kernels) against `ssd_ref` under
    autograd: the gradients of x, dt, Bm, Cm, A_log and D, f32, at a
    ragged chunk and at mamba2's widths."""
    err = 0.0
    for b, l, h, p, n, chunk in ((1, 200, 3, 24, 20, 100),
                                 (2, 512, 4, 64, 128, 256)):
        label = f"B={b} L={l} H={h} P={p} N={n} chunk={chunk}"
        x, dt, Bm, Cm, A_log, D = ssd_inputs(gen, b, l, h, p, n)
        C_c, B_c, dtx, cums = chunk_inputs(x, dt, Bm, Cm, A_log, chunk)
        nc = l // chunk
        dy, dS = randn(gen, (b, nc, chunk, h, p)), randn(gen,
                                                         (b, nc, h, n, p))
        k = ssd.ssd_intra_bwd_cuda.launches
        leaves = [t.clone().requires_grad_() for t in (C_c, B_c, dtx, cums)]
        got = torch.autograd.grad(ssd_ops.SSDIntra.apply(*leaves), leaves,
                                  (dy, dS))
        require(ssd.ssd_intra_bwd_cuda.launches == k + 1,
                "SSDIntra did not launch the backward kernel")
        leaves = [t.clone().requires_grad_() for t in (C_c, B_c, dtx, cums)]
        want = torch.autograd.grad(ssd_intra_ref(*leaves), leaves, (dy, dS))
        err = max(err, ssd_grads_hold(
            f"SSDIntra vs autograd of ssd_intra_ref {label}", got, want,
            ("C", "B", "dtx", "cums")))
        ins = [t.clone().requires_grad_() for t in (x, dt, Bm, Cm, A_log,
                                                     D)]
        y, hf = ssd_ops.ssd_chunked(*ins, chunk=chunk)
        cot = (randn(gen, y.shape), randn(gen, hf.shape))
        got = torch.autograd.grad((y, hf), ins, cot)
        require(ssd.ssd_intra_bwd_cuda.launches == k + 2,
                "ssd_chunked under autograd did not launch the backward")
        ins = [t.clone().requires_grad_() for t in (x, dt, Bm, Cm, A_log,
                                                     D)]
        want = torch.autograd.grad(ssd_ref(*ins, chunk=chunk), ins, cot)
        err = max(err, ssd_grads_hold(
            f"ssd_chunked vs autograd of ssd_ref {label}", got, want,
            ("x", "dt", "Bm", "Cm", "A_log", "D")))
    return err


def ssd_bwd_time(gen, label: str, b, h, p, n, q) -> tuple[float, dict]:
    """The backward kernel at one training shape (f32, nc = TRAIN_SEQ / q;
    CUDA events), beside the forward at the same shape, its plain version,
    the bound and the CUDA cores' floor of `ssd_bwd_work`; the kernel held
    against its plain version on these inputs. Returns the error and the
    times. Each function's time comes from the profiled mamba2 step: a
    profiler session around this call left that step's profile short."""
    nc = TRAIN_SEQ // q
    x, dt, Bm, Cm, A_log, D = ssd_inputs(gen, b, TRAIN_SEQ, h, p, n)
    ins = (*chunk_inputs(x, dt, Bm, Cm, A_log, q),
           randn(gen, (b, nc, q, h, p)), randn(gen, (b, nc, h, n, p)))
    del x, dt, Bm, Cm
    w = ssd_bwd_work(b, nc, q, n, h, p)
    ms = time_ms(lambda: ssd.ssd_intra_bwd_cuda(*ins), reps=10)
    fwd_ms = time_ms(lambda: ssd.ssd_intra_cuda(*ins[:4]), reps=10)
    plain_ms = time_ms(lambda: ssd_intra_bwd_ref(*ins), reps=2, warmup=1)
    log(f"time ssd_intra_bwd f32 {label} B={b} nc={nc} Q={q} N={n} H={h} "
        f"P={p}: kernel {ms:.4f} ms (the forward {fwd_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, bound {w['bound_ms']:.4f} ms ({w['bound_by']}, "
        f"{w['bound_rate']}; {w['ops']:.4g} ops, {w['bytes']} B), f32 "
        f"CUDA-core floor {w['f32_bound_ms']:.4f} ms; "
        f"{w['ops'] / ms / 1e9:.2f} TFLOP/s of needed work, "
        f"{ms / w['bound_ms']:.2f}x the bound; library: none")
    err = ssd_grads_hold(f"ssd bwd {label} training shape B={b} nc={nc} "
                         f"H={h} P={p}", ssd.ssd_intra_bwd_cuda(*ins),
                         ssd_intra_bwd_ref(*ins),
                         ("dC", "dB", "ddtx", "dcums"))
    del ins
    free()
    return err, dict(w, ms=ms, fwd_ms=fwd_ms, plain_ms=plain_ms,
                     library_ms=None)


def ssd_bwd_timing(gen) -> tuple[float, dict]:
    """`ssd_bwd_time` at mamba2's training shape (b=8, H=32, P=64), the
    main path's, and at jamba's mamba layer (b=2, H=128, P=128); N=128,
    Q=256 in both. Returns the larger error and mamba2's times with
    jamba's under "jamba"."""
    err, t = ssd_bwd_time(gen, "mamba2", TRAIN_BATCH,
                          *ssd_widths(MAMBA_ARCH))
    jerr, jt = ssd_bwd_time(gen, "jamba", JAMBA_TRAIN_BATCH,
                            *ssd_widths(JAMBA))
    t["jamba"] = {k: jt[k] for k in ("ms", "fwd_ms", "plain_ms", "bound_ms",
                                     "bound_by", "f32_bound_ms")}
    return max(err, jerr), t


def ssd_widths(arch: str) -> tuple[int, int, int, int]:
    """(H, P, N, Q) of an architecture's mamba layers."""
    cfg = configs.get(arch)
    return cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk


def mamba_main_path() -> tuple[dict, dict]:
    """mamba2-370m whole, bf16, B=8 x 4,096 through `make_train_step`
    with remat, 5 steps (`train_cell`): K3 forward launches 2 x 48 x 5,
    backward 48 x 5, no K2; A_log / D / dt_bias / wB / wC gradients
    non-zero in all 48 layers; one profiled step. Returns K3's launches
    and the logged numbers."""
    cfg, step_fn, state, ds, out = train_cell(MAMBA_ARCH, "mamba",
                                              MAMBA_LEAVES)
    launches = launch_counts()
    n = layers_of(cfg, "mamba") * TRAIN_STEPS
    require(launches == {**k2_want(), "ssd": 2 * n, "ssd_bwd": n},
            f"{MAMBA_ARCH} train: launches {launches}; want {2 * n} K3 "
            f"forward (remat runs each block twice) and {n} backward")
    log(f"{MAMBA_ARCH} train: K3 launches forward {launches['ssd']}, "
        f"backward {launches['ssd_bwd']}")
    batch = {k: torch.from_numpy(x).cuda()
             for k, x in ds.batch_at(TRAIN_STEPS).items()}
    profile_train_step(step_fn, state, batch)
    del state, batch
    free()
    return launches, out


def mamba_hold_f32() -> dict:
    """mamba2 at full width cut to 2 layers, f32, B=2 x 512: one train
    step through K3 and its backward against the same step with the SSD
    patched to `ssd_ref` here (unittest.mock; the package has no knob):
    the loss within rtol 1e-5, every gradient within a relative Frobenius
    error of 1e-4; then 3 steps each, losses rtol 1e-4. Returns the
    launches of the kernel run (the plain run launches none)."""
    cfg = dataclasses.replace(configs.get(MAMBA_ARCH),
                              num_layers=HOLD_LAYERS, param_dtype="float32",
                              activation_dtype="float32")
    opt_cfg = AdamWConfig(total_steps=3, warmup_steps=1)
    ds = SyntheticTextDataset(cfg.vocab_size, MAMBA_HOLD_SEQ, HOLD_BATCH,
                              seed=1)

    def plain(x, dt, Bm, Cm, A_log, D, chunk=64, h0=None):
        return ssd_ref(x, dt, Bm, Cm, A_log, D, chunk=chunk, h0=h0)

    runs = []
    # the f32 hold's path: counts start at 0 here
    reset_counts()
    for swap in (False, True):
        params = M.init_params(cfg, seed=3)
        state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
        step_fn = steps.make_train_step(cfg, opt_cfg)
        record: list = []
        losses = []
        with (mock.patch.object(mamba, "ssd_chunked", plain) if swap
              else contextlib.nullcontext()), grad_spy(record, True):
            for i in range(3):
                batch = {k: torch.from_numpy(x).cuda()
                         for k, x in ds.batch_at(i).items()}
                state, metrics = step_fn(state, batch)
                losses.append(float(metrics["loss"]))
        runs.append((losses, record[0]["grads"]))
        del params, state, record
    launches = launch_counts()
    n = 3 * HOLD_LAYERS
    require(launches["ssd"] == 2 * n and launches["ssd_bwd"] == n,
            f"mamba f32 hold: launches {launches}; want {2 * n} K3 forward "
            f"and {n} backward, none in the plain run")
    (lk, gk), (lp, gp) = runs
    rel = {k: float((gk[k] - gp[k]).norm() / gp[k].norm()) if float(
        gp[k].norm()) else float((gk[k] - gp[k]).norm()) for k in gk}
    worst = max(rel, key=rel.get)
    ok = abs(lk[0] - lp[0]) <= 1e-5 * abs(lp[0]) and rel[worst] <= 1e-4
    ssd_rel = max(v for k, v in rel.items()
                  if any(k.endswith(f".{leaf}") for leaf in MAMBA_LEAVES))
    log(f"mamba f32 hold ({HOLD_LAYERS} layers at full width, B={HOLD_BATCH}"
        f" S={MAMBA_HOLD_SEQ}): step 1 loss {lk[0]!r} (K3) vs {lp[0]!r} "
        f"(ssd_ref); worst gradient relative Frobenius {rel[worst]:.3e} "
        f"({worst}), worst of {'/'.join(MAMBA_LEAVES)} {ssd_rel:.3e}: {ok}")
    require(ok, "mamba f32 hold: the train step through K3 disagrees with "
            "the same step on ssd_ref")
    np_ok = bool(np.allclose(lk, lp, rtol=1e-4, atol=0))
    log(f"mamba f32 hold, 3 steps: losses {lk} vs {lp} (rtol 1e-4): {np_ok}")
    require(np_ok, "mamba f32 hold: 3-step losses disagree")
    free()
    return launches


def jamba_train(gen) -> dict:
    """jamba's mamba layers under autograd on the card: position 0 (mamba
    + dense FFN) at full width over (2, 4,096, 8,192) bf16, every gradient
    finite, one K3 forward and one backward at H=128, P=128; the
    full-width f32 mamba layer at B=1 x 512, its gradients through K3's
    backward against the same layer with `SSDIntra` patched to
    `ssd_intra_ref` under autograd (relative Frobenius 1e-4 per
    parameter); the whole smoke model, 3 steps of `make_train_step` (K2
    fma at hd 16, K3 at P=32, the MoE). Returns K2's and K3's launches by
    part."""
    cfg = configs.get(JAMBA)
    free()
    torch.cuda.reset_peak_memory_stats()
    spec = cfg.pattern[0]
    blk = M.Block(cfg, spec, torch.bfloat16, torch.device("cuda"))
    init_module(blk, gen)
    blk.requires_grad_(True)
    x = randn(gen, (JAMBA_TRAIN_BATCH, LM_SEQ, cfg.d_model),
              torch.bfloat16).requires_grad_()
    # the block's path: counts start at 0 here
    reset_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    start.record()
    y, _ = M._run_block(blk, x, cfg)
    leaves = [x, *blk.parameters()]
    grads = torch.autograd.grad(y, leaves, randn(gen, y.shape,
                                                 torch.bfloat16),
                                allow_unused=True)
    end.record()
    torch.cuda.synchronize()
    block = launch_counts()
    finite = all(g is not None and bool(torch.isfinite(g).all())
                 for g in grads)
    require(finite and block["ssd"] == 1 and block["ssd_bwd"] == 1,
            f"{JAMBA} block 0 under autograd: finite {finite}, launches "
            f"{block}; want one K3 forward and one backward")
    log(f"{JAMBA} block 0 (mamba + dense FFN, H={cfg.ssm_heads} "
        f"P={cfg.ssm_head_dim} N={cfg.ssm_state}) forward + backward over "
        f"({JAMBA_TRAIN_BATCH}, {LM_SEQ}, {cfg.d_model}) bf16: "
        f"{start.elapsed_time(end):.3f} ms on the card (one call), "
        f"{len(grads)} gradients finite, K3 forward 1, backward 1")
    log_memory(f"{JAMBA} block 0 train")
    del blk, x, y, grads, leaves
    free()

    layer = mamba.Mamba(cfg, torch.float32, torch.device("cuda"))
    init_module(layer, gen)
    layer.requires_grad_(True)
    xs = randn(gen, (1, 512, cfg.d_model))
    dy = randn(gen, (1, 512, cfg.d_model))
    params = list(layer.parameters())
    k3 = launch_counts()
    got = torch.autograd.grad(mamba.apply(layer, xs, cfg), params, dy)
    layer_launches = {k: v - k3[k] for k, v in launch_counts().items()}
    require(layer_launches["ssd"] == 1 and layer_launches["ssd_bwd"] == 1,
            f"{JAMBA} f32 mamba layer: launches {layer_launches}")
    with mock.patch.object(ssd_ops.SSDIntra, "apply", ssd_intra_ref):
        want = torch.autograd.grad(mamba.apply(layer, xs, cfg), params, dy)
    names = [n for n, _ in layer.named_parameters()]
    rel = {n: float((g - w).norm() / w.norm()) if float(w.norm())
           else float((g - w).norm()) for n, g, w in zip(names, got, want)}
    worst = max(rel, key=rel.get)
    ok = rel[worst] <= 1e-4 and all(bool(torch.isfinite(g).all())
                                    for g in got)
    log(f"{JAMBA} f32 mamba layer B=1 L=512: gradients through K3's "
        f"backward vs autograd of ssd_intra_ref, worst relative Frobenius "
        f"{rel[worst]:.3e} ({worst}; 1e-4): {ok}")
    require(ok, f"{JAMBA} f32 mamba layer: gradients disagree")
    del layer, xs, dy, params, got, want
    free()

    smoke = configs.get_smoke(JAMBA)
    params = M.init_params(smoke, seed=0)
    opt_cfg = AdamWConfig(total_steps=3, warmup_steps=1)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    step_fn = steps.make_train_step(smoke, opt_cfg)
    ds = SyntheticTextDataset(smoke.vocab_size, 512, LM_BATCH, seed=0)
    record: list = []
    losses = []
    # the smoke model's path: counts start at 0 here
    reset_counts()
    with grad_spy(record):
        for i in range(3):
            batch = {k: torch.from_numpy(v).cuda()
                     for k, v in ds.batch_at(i).items()}
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
    launches = launch_counts()
    n_attn, n_ssd = (3 * layers_of(smoke, kind) for kind in ("attn",
                                                              "mamba"))
    require(launches == {**k2_want(tf32x3=2 * n_attn, bwd_tf32x3=n_attn),
                         "ssd": 2 * n_ssd, "ssd_bwd": n_ssd},
            f"{JAMBA} smoke train: launches {launches}")
    bad = [n for e in record for n, f in e["finite"].items() if not f]
    require(all(math.isfinite(v) for v in losses) and not bad,
            f"{JAMBA} smoke train: losses {losses}, non-finite {bad[:4]}")
    log(f"{JAMBA} smoke train ({smoke.num_layers} layers, B={LM_BATCH} "
        f"S=512), 3 steps: losses {losses}; every gradient finite; "
        f"launches {launches}")
    del params, state
    free()
    return {"block": block, "layer": layer_launches, "smoke": launches}


def phase_train_mamba(gen) -> tuple[float, dict, dict]:
    """Phase 19. Returns the backward kernel's max error against its plain
    version (phase 7's cases and the training shape), its times and K3's
    forward and backward launches by phase."""
    t0 = time.perf_counter()
    log(f"ssd backward route: {ssd.BWD_ROUTE}")
    errs = [ssd_bwd_check(label, gen, *case) for label, *case in ssd_cases()]
    # through the Function and the torch glue: unscaled gradient errors,
    # logged apart from the kernel's
    t_bwd = {"function_max_abs_err": ssd_function_checks(gen)}
    log(f"phase 19 backward cases: {time.perf_counter() - t0:.1f} s")
    err, timing = ssd_bwd_timing(gen)
    errs.append(err)
    t_bwd.update(timing)
    t0 = time.perf_counter()
    main, _ = mamba_main_path()
    log(f"phase 19 main path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    hold = mamba_hold_f32()
    log(f"phase 19 f32 hold: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    jam = jamba_train(gen)
    log(f"phase 19 jamba: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli = cli_resume(MAMBA_ARCH)
    log(f"phase 19 CLI: {time.perf_counter() - t0:.1f} s")
    parts = {"19 mamba2 train": main, "19 f32 hold": hold,
             f"19 {JAMBA} block": jam["block"],
             f"19 {JAMBA} f32 layer": jam["layer"],
             f"19 {JAMBA} smoke train": jam["smoke"], "19 CLI": cli}
    by_phase = {k: {name: c[k] for name, c in parts.items()}
                for k in ("ssd", "ssd_bwd", "tf32x3", "bwd_tf32x3")}
    return max(errs), t_bwd, by_phase


# ------------------------------------------------------------------ #
# the mesh surface (20)
# ------------------------------------------------------------------ #
MESH_STEPS = 3                # the NCCL (1, 1) run of phase 18's cell
MESH_WORLD = 2                # gloo ranks on the one card
MESH_SHAPES = {"2": ((2,), ("data",)), "1x2": ((1, 2), ("data", "model"))}
MESH_BF16_BATCH, MESH_BF16_SEQ, MESH_BF16_STEPS = 4, 2_048, 2
MESH_BF16_LAYERS = 4          # of 28: 2 steps took 57.4 s at full depth
MESH_MOE_BATCH, MESH_MOE_SEQ = 2, 2_048
MESH_MOE_SKEW = 0.01          # on router column 0: every group drops
MESH_MOE_TOL = 1e-4           # f32, relative to max|y|
PROBE = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
         "all_to_all_single")


def probe_collectives(rank: int, world: int) -> dict:
    """Each collective that DTensor's redistributions need, once on CUDA
    tensors over the gloo group, its result checked: rank r sends
    (r + 1) in world chunks of 4."""
    x = torch.full((world * 4,), float(rank + 1), device="cuda")
    total = world * (world + 1) / 2
    ranks = torch.arange(1, world + 1, device="cuda",
                         dtype=torch.float32)[:, None]
    t = x.clone()
    dist.all_reduce(t)
    g = torch.empty((world * world * 4,), device="cuda")
    dist.all_gather_into_tensor(g, x)
    r = torch.empty(4, device="cuda")
    dist.reduce_scatter_tensor(r, x)
    a = torch.empty((world * 4,), device="cuda")
    dist.all_to_all_single(a, x)
    torch.cuda.synchronize()
    g, a = g.view(world, world * 4), a.view(world, 4)
    return {"all_reduce": bool((t == total).all()),
            "all_gather_into_tensor": bool((g == ranks).all()),
            "reduce_scatter_tensor": bool((r == total).all()),
            "all_to_all_single": bool((a == ranks).all())}


def mesh_grad_spy(record: list):
    """`adamw.adamw_update` that first keeps each gradient whole
    (`full_tensor()`, a collective every rank joins)."""
    update = adamw.adamw_update

    def spying(grads, opt_state, params, cfg):
        record.append({n: g.full_tensor().detach().clone()
                       for n, g in grads.items()})
        return update(grads, opt_state, params, cfg)
    return mock.patch.object(adamw, "adamw_update", spying)


def shard_bytes(params) -> tuple[int, int]:
    """(this rank's parameter bytes, the whole model's)."""
    local = sum(p.to_local().numel() * p.element_size()
                for p in params.parameters())
    whole = sum(p.numel() * p.element_size() for p in params.parameters())
    return local, whole


def mesh_hold(arch: str, mesh, rank: int, seq: int) -> dict:
    """`arch` at full width cut to 2 layers, f32, B=2 x `seq`: one train
    step under `mesh` (the state `shard_state`'s, the batch
    `shard_batch`'s) with the counts set to 0 just before it; then, on
    rank 0, the same step on one device, and the holds of phases 18 and
    19: the loss rtol 1e-5, every gradient relative Frobenius 1e-4, the
    updated parameters within 1e-6 plus AdamW's bound (at most 0.01% of
    them past 1e-6). Records the SSM heads each rank's K3 sees."""
    cfg = dataclasses.replace(configs.get(arch), num_layers=HOLD_LAYERS,
                              param_dtype="float32",
                              activation_dtype="float32")
    opt_cfg = AdamWConfig(total_steps=3, warmup_steps=1)
    ds = SyntheticTextDataset(cfg.vocab_size, seq, HOLD_BATCH, seed=1)
    batch = {k: torch.from_numpy(x).cuda()
             for k, x in ds.batch_at(0).items()}
    heads = []
    ssd_local = mamba._ssd

    def spy(xc, *a):
        heads.append(xc.shape[-1] // cfg.ssm_head_dim)
        return ssd_local(xc, *a)
    params = M.init_params(cfg, seed=3)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    steps.shard_state(state, cfg, mesh, opt_cfg)
    step_fn = steps.make_train_step(cfg, opt_cfg)
    record: list = []
    # the mesh hold's path: counts start at 0 here
    reset_counts()
    with mesh_context(mesh), mesh_grad_spy(record), \
            mock.patch.object(mamba, "_ssd", spy):
        state, metrics = step_fn(state, steps.shard_batch(batch, mesh))
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    torch.cuda.synchronize()
    out = {"launches": launch_counts(), "loss": loss, "gnorm": gnorm,
           "heads": sorted(set(heads)),
           "bytes": shard_bytes(state["params"])}
    after = {n: p.detach().full_tensor() for n, p in
             state["params"].named_parameters()}
    gk = record[0]
    del state, params, record
    if rank:
        return out
    params = M.init_params(cfg, seed=3)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    record = []
    with grad_spy(record, True):
        state, metrics = steps.make_train_step(cfg, opt_cfg)(state, batch)
    lp, gp = float(metrics["loss"]), record[0]["grads"]
    pp = {n: p.detach() for n, p in params.named_parameters()}
    rel = grads_rel(gk, gp)
    worst = max(rel, key=rel.get)
    excess, over, total, dp_max = update_hold(gk, gp, after, pp, opt_cfg)
    worst_p = max(excess, key=excess.get)
    out.update(loss_one=lp, gnorm_one=float(metrics["grad_norm"]),
               worst=(worst, rel[worst]), worst_p=(worst_p, excess[worst_p]),
               over=over, total=total, dp_max=dp_max,
               ok=(abs(loss - lp) <= 1e-5 * abs(lp) and rel[worst] <= 1e-4
                   and excess[worst_p] <= 0 and over <= 1e-4 * total))
    del state, params, record, after, gk, gp
    free()
    return out


def mesh_bf16(mesh) -> dict:
    """qwen3-0.6b at full width in bf16, cut to 4 of its 28 layers (two
    full-depth steps took 57.4 s over gloo's host copies), under `mesh`,
    global B=4 x 2,048, 2 steps, the counts set to 0 just before: the
    losses, the K2 launches, this rank's parameter bytes, ms per step."""
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH),
                              num_layers=MESH_BF16_LAYERS)
    opt_cfg = AdamWConfig(total_steps=MESH_BF16_STEPS, warmup_steps=1)
    params = M.init_params(cfg, seed=0)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    steps.shard_state(state, cfg, mesh, opt_cfg)
    del params
    free()
    torch.cuda.reset_peak_memory_stats()
    step_fn = steps.make_train_step(cfg, opt_cfg)
    ds = SyntheticTextDataset(cfg.vocab_size, MESH_BF16_SEQ,
                              MESH_BF16_BATCH, seed=0)
    losses, walls = [], []
    # the bf16 mesh path: counts start at 0 here
    reset_counts()
    with mesh_context(mesh):
        for _, batch in make_batches(ds, 0, MESH_BF16_STEPS):
            batch = steps.shard_batch({k: torch.from_numpy(x).cuda()
                                       for k, x in batch.items()}, mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    out = {"launches": k2_launches(), "losses": losses, "walls": walls,
           "bytes": shard_bytes(state["params"]),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del state
    free()
    return out


def moe_layer_inputs(cfg):
    """A granite MoE layer at full width in f32 (seed 0), router column 0
    skewed, and x (2, 2,048, d) biased positive, so that most tokens pick
    expert 0 and every group's capacity binds."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    layer = DeclModule(moe.decls(cfg), torch.float32, torch.device("cuda"))
    init_module(layer, gen)
    p = {n: t.detach() for n, t in layer.named_parameters()}
    p["router"][:, 0] += MESH_MOE_SKEW
    x = randn(gen, (MESH_MOE_BATCH, MESH_MOE_SEQ, cfg.d_model)) + 0.3
    return p, x


@torch.no_grad()
def mesh_moe(mname: str, mesh, rank: int) -> dict:
    """Under (2,): the grouped dispatch (G=2, one group per rank) against
    the one-device G=2 dispatch on rank 0, drops per group. Under (1,
    2): `dispatch="all_to_all"` over the model axis's gloo group against
    the grouped dispatch on the same mesh."""
    cfg = configs.get(GRANITE)
    p, x = moe_layer_inputs(cfg)
    decls = moe.decls(cfg)
    pd = {n: distribute_tensor(t, mesh, NamedSharding(
        mesh, logical_to_pspec(decls[n].shape, decls[n].logical_axes,
                               mesh)).placements)
          for n, t in p.items()}
    xd = distribute_tensor(x, mesh, NamedSharding(mesh, logical_to_pspec(
        x.shape, ("batch", "seq", None), mesh)).placements)
    drops: list = []
    with mesh_context(mesh), drop_counter(drops):
        y, aux = moe.apply(pd, xd, cfg)
        y, aux = y.full_tensor(), float(aux.full_tensor())
    out = {"drops": [int(d) for d in drops]}
    if mname == "1x2":
        with mesh_context(mesh):
            y2, aux2 = moe.apply(pd, xd, cfg, dispatch="all_to_all")
            y2, aux2 = y2.full_tensor(), float(aux2.full_tensor())
        out.update(err=float((y2 - y).abs().max()),
                   scale=float(y.abs().max()), aux=(aux, aux2))
    elif rank == 0:
        one: list = []
        with mock.patch.object(moe, "_num_groups", lambda b, s: (2, 1)), \
                drop_counter(one):
            y1, aux1 = moe.apply(p, x, cfg)
        out.update(err=float((y1 - y).abs().max()),
                   scale=float(y1.abs().max()), aux=(aux, float(aux1)),
                   drops_one=[int(d) for d in one])
    free()
    return out


DECODE_MESH_B, DECODE_MESH_T, DECODE_MESH_STEPS = 2, 256, 8
DECODE_LONG_T = 512           # the long_ctx cache, T over (data, model)
DECODE_MESH_TOL = 1e-5        # f32, relative to max|logits| (and |grad|)


def mesh_decode(arch: str, mesh, rank: int, long_ctx: bool = False,
                b: int = DECODE_MESH_B, t: int = DECODE_MESH_T) -> dict:
    """`arch` at full width cut to 2 layers, f32 (seed 3):
    `DECODE_MESH_STEPS` decode steps of seeded tokens under `mesh` (the
    parameters in `param_shardings`, the caches in `cache_shardings`,
    `long_ctx` as given), against the same steps on one device (rank
    0): max |diff| of the logits and their scale."""
    cfg = dataclasses.replace(configs.get(arch), num_layers=HOLD_LAYERS,
                              param_dtype="float32",
                              activation_dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (DECODE_MESH_STEPS, b, 1))).cuda()

    def run(params, m=None):
        cache = M.init_cache(cfg, b, t)
        ctx = contextlib.nullcontext()
        if m is not None:
            csh = steps.cache_shardings(cfg, m, b, t, long_ctx=long_ctx)
            cache = [{k: distribute_tensor(x, m, csh[i][k].placements)
                      for k, x in layer.items()}
                     for i, layer in enumerate(cache)]
            ctx = mesh_context(m)
        out = []
        with ctx:
            for i in range(DECODE_MESH_STEPS):
                tok = toks[i]
                pos = torch.full((b,), i, dtype=torch.int64, device="cuda")
                if m is not None:
                    tok = distribute_tensor(tok, m, NamedSharding(
                        m, logical_to_pspec(tok.shape, ("batch", None),
                                            m)).placements)
                    pos = distribute_tensor(pos, m, NamedSharding(
                        m, logical_to_pspec(pos.shape, ("batch",),
                                            m)).placements)
                lg, cache = M.decode_step(params, cache, tok, pos, cfg,
                                          long_ctx=long_ctx)
                out.append(lg.full_tensor() if m is not None else lg)
        return torch.stack(out)
    params = M.init_params(cfg, seed=3)
    ps = steps.param_shardings(cfg, mesh)
    for prefix, mod in params.named_modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            full = f"{prefix}.{name}" if prefix else name
            mod._parameters[name] = torch.nn.Parameter(distribute_tensor(
                p.detach(), mesh, ps[full].placements), requires_grad=False)
    got = run(params, mesh)
    out = {}
    if rank == 0:
        want = run(M.init_params(cfg, seed=3))
        out = {"err": float((got - want).abs().max()),
               "scale": float(want.abs().max())}
    del params
    free()
    return out


def mesh_moe_grads(mesh, rank: int) -> dict:
    """Phase 20's granite MoE layer (full width, f32) under `mesh`: the
    gradients of sum(y) + aux for x and every parameter through
    `dispatch="all_to_all"` against the grouped dispatch's (rank 0)."""
    cfg = configs.get(GRANITE)
    p, x = moe_layer_inputs(cfg)
    decls = moe.decls(cfg)

    def grads(dispatch):
        pd = {n: distribute_tensor(t, mesh, NamedSharding(
            mesh, logical_to_pspec(decls[n].shape, decls[n].logical_axes,
                                   mesh)).placements).requires_grad_()
              for n, t in p.items()}
        xd = distribute_tensor(x, mesh, NamedSharding(
            mesh, logical_to_pspec(x.shape, ("batch", "seq", None),
                                   mesh)).placements).requires_grad_()
        with mesh_context(mesh):
            y, aux = moe.apply(pd, xd, cfg, dispatch=dispatch)
            loss = (y.sum() + aux).full_tensor()
            g = torch.autograd.grad(loss, [xd] + list(pd.values()))
        return [t.full_tensor() for t in g]
    a2a, grouped = grads("all_to_all"), grads("gspmd")
    out = {}
    if rank == 0:
        out = {"err": max(float((a - b).abs().max())
                          for a, b in zip(a2a, grouped)),
               "scale": max(float(b.abs().max()) for b in grouped)}
    del a2a, grouped
    free()
    return out


def mesh_rank(rank: int, world: int, store: str, q) -> None:
    """One rank of the one-card gloo run (a spawned process): the probe,
    then each mesh's f32 holds, bf16 steps and MoE layer."""
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        out = {"probe": probe_collectives(rank, world)}
        for mname, (shape, axes) in MESH_SHAPES.items():
            mesh = mesh_lib.make_mesh(shape, axes)
            t0 = time.perf_counter()
            cases = {"qwen3 hold": lambda: mesh_hold(TRAIN_ARCH, mesh, rank,
                                                     HOLD_SEQ),
                     "bf16": lambda: mesh_bf16(mesh),
                     "moe": lambda: mesh_moe(mname, mesh, rank)}
            if mname == "1x2":
                cases["mamba2 hold"] = lambda: mesh_hold(
                    MAMBA_ARCH, mesh, rank, MAMBA_HOLD_SEQ)
                # phase 21 (d): decode under (1, 2), the all_to_all MoE's
                # gradients
                cases["qwen3 decode"] = lambda: mesh_decode(
                    TRAIN_ARCH, mesh, rank)
                cases["mamba2 decode"] = lambda: mesh_decode(
                    MAMBA_ARCH, mesh, rank)
                cases["moe grads"] = lambda: mesh_moe_grads(mesh, rank)
            for case, fn in cases.items():
                t1 = time.perf_counter()
                out[f"{mname}/{case}"] = fn()
                if rank == 0:
                    log(f"mesh {mname} gloo rank 0: {case} "
                        f"{time.perf_counter() - t1:.1f} s")
            out[f"{mname}/s"] = time.perf_counter() - t0
        # phase 21 (d): long_ctx decode, T over (data, model) = (2, 1)
        long_mesh = mesh_lib.make_mesh((2, 1), ("data", "model"))
        out["2x1/qwen3 long decode"] = mesh_decode(
            TRAIN_ARCH, long_mesh, rank, long_ctx=True, b=1,
            t=DECODE_LONG_T)
        dist.destroy_process_group()
        q.put((rank, out))
    except BaseException as e:  # noqa: BLE001 -- reported to the parent
        q.put((rank, repr(e)))
        raise


def mesh_nccl(train18: dict) -> tuple[dict, dict]:
    """qwen3-0.6b whole, bf16, B=8 x 4,096 from phase 18's dataset and
    seed, `MESH_STEPS` steps of `make_train_step` on a `shard_state`
    state under a (1, 1) data x model mesh over NCCL (world 1), the
    counts set to 0 just before: the first step's loss and grad norm
    against phase 18's (rtol 1e-3), K2 launches 2 x 28 x 3 forward and
    28 x 3 backward, all wgmma; ms per step and tokens/s beside phase
    18's, peak memory."""
    cfg = configs.get(TRAIN_ARCH)
    opt_cfg = AdamWConfig(total_steps=TRAIN_STEPS,
                          warmup_steps=TRAIN_STEPS // 10 + 1)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "nccl"), 1),
            rank=0, world_size=1,
            device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            mesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
            free()
            torch.cuda.reset_peak_memory_stats()
            params = M.init_params(cfg, seed=0)
            state = {"params": params,
                     "opt": init_opt_state(params, opt_cfg)}
            steps.shard_state(state, cfg, mesh, opt_cfg)
            del params
            step_fn = steps.make_train_step(cfg, opt_cfg)
            ds = SyntheticTextDataset(cfg.vocab_size, TRAIN_SEQ,
                                      TRAIN_BATCH, seed=0)
            losses, gnorms, walls = [], [], []
            # the mesh main path: counts start at 0 here
            reset_counts()
            with mesh_context(mesh):
                for _, batch in make_batches(ds, 0, MESH_STEPS):
                    batch = steps.shard_batch(
                        {k: torch.from_numpy(x).cuda()
                         for k, x in batch.items()}, mesh)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, metrics = step_fn(state, batch)
                    losses.append(float(metrics["loss"]))
                    gnorms.append(float(metrics["grad_norm"]))
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
            launches = k2_launches()
            peak = torch.cuda.max_memory_allocated() / 2**30
            del state
        finally:
            dist.destroy_process_group()
    free()
    n = cfg.num_layers * MESH_STEPS
    require(launches == k2_want(wgmma=2 * n, bwd_wgmma=n),
            f"mesh (1, 1) train: K2 launches {launches}; want {2 * n} "
            f"forward and {n} backward, all wgmma")
    l18, g18 = train18["losses"][0], train18["grad_norms"][0]
    ok = (all(math.isfinite(x) for x in losses)
          and abs(losses[0] - l18) <= 1e-3 * abs(l18)
          and abs(gnorms[0] - g18) <= 1e-3 * abs(g18))
    med = float(np.median(walls[1:]))
    ntok = TRAIN_BATCH * TRAIN_SEQ
    log(f"mesh (1, 1) data x model over NCCL (world 1), {TRAIN_ARCH} whole, "
        f"bf16, B={TRAIN_BATCH} S={TRAIN_SEQ}, {MESH_STEPS} steps: losses "
        f"{losses}, grad norms {gnorms}; step 1 vs phase 18's: loss "
        f"{losses[0]!r} / {l18!r}, grad norm {gnorms[0]!r} / {g18!r} (rtol "
        f"1e-3; bit-equal: {losses[0] == l18 and gnorms[0] == g18}): {ok}; "
        f"K2 launches {launches}")
    log(f"mesh (1, 1) train: {med * 1e3:.1f} ms per step, "
        f"{ntok / med:.1f} tokens/s (median of steps 2-{MESH_STEPS}; phase "
        f"18: {train18['ms_per_step']:.1f} ms, "
        f"{train18['tokens_per_s']:.1f} tokens/s); peak {peak:.2f} GiB "
        f"(phase 18: {train18['peak_gib']:.2f})")
    require(ok, "mesh (1, 1) train: step 1 differs from phase 18's")
    return launches, {"ms_per_step": med * 1e3, "tokens_per_s": ntok / med,
                      "peak_gib": peak}


def check_mesh_ranks(got: dict) -> dict:
    """Phase 20's requirements over the gloo ranks' results. Returns the
    launches by rank: K2 by route, K3."""
    cfg = configs.get(TRAIN_ARCH)
    by_rank = {}
    for rank in range(MESH_WORLD):
        res = got.get(rank)
        require(isinstance(res, dict), f"mesh gloo rank {rank} failed: {res}")
        by_rank[rank] = {**k2_want(), "ssd": 0, "ssd_bwd": 0}
        log(f"gloo probe (rank {rank}, CUDA tensors): {res['probe']}")
        require(all(res["probe"].values()),
                f"gloo refuses a collective for CUDA tensors: {res['probe']}")
        for mname in MESH_SHAPES:
            n = HOLD_LAYERS
            h = res[f"{mname}/qwen3 hold"]
            require(h["launches"] == {**k2_want(tf32x3=2 * n,
                                                bwd_tf32x3=n),
                                      "ssd": 0, "ssd_bwd": 0},
                    f"mesh {mname} qwen3 hold rank {rank}: launches "
                    f"{h['launches']}")
            holds = [("qwen3", h)]
            if mname == "1x2":
                hm = res[f"{mname}/mamba2 hold"]
                mcfg = configs.get(MAMBA_ARCH)
                require(hm["launches"]["ssd"] == 2 * n
                        and hm["launches"]["ssd_bwd"] == n
                        and hm["heads"] == [mcfg.ssm_heads // 2],
                        f"mesh {mname} mamba2 hold rank {rank}: launches "
                        f"{hm['launches']}, heads per rank {hm['heads']}")
                holds.append(("mamba2", hm))
            for arch, hh in holds:
                local, whole = hh["bytes"]
                line = (f"mesh {mname} gloo rank {rank}: {arch} f32 hold "
                        f"({HOLD_LAYERS} layers at full width): loss "
                        f"{hh['loss']!r}, grad norm {hh['gnorm']!r}; "
                        f"parameters {local} of {whole} B on this rank; "
                        f"launches {hh['launches']}; SSM heads per rank "
                        f"{hh['heads']}")
                if rank == 0:
                    line += (f"; one device: loss {hh['loss_one']!r}, grad "
                             f"norm {hh['gnorm_one']!r}; worst gradient "
                             f"relative Frobenius {hh['worst'][1]:.3e} "
                             f"({hh['worst'][0]}); updated parameters max "
                             f"|diff| {hh['dp_max']:.3e}, {hh['over']} of "
                             f"{hh['total']} past 1e-6, worst margin "
                             f"{hh['worst_p'][1]:.3e} ({hh['worst_p'][0]}): "
                             f"{hh['ok']}")
                log(line)
                if rank == 0:
                    require(hh["ok"], f"mesh {mname} {arch} f32 hold: the "
                            "sharded step disagrees with one device")
                for k, v in hh["launches"].items():
                    by_rank[rank][k] += v
            b = res[f"{mname}/bf16"]
            nb = MESH_BF16_LAYERS * MESH_BF16_STEPS
            local, whole = b["bytes"]
            require(b["launches"] == k2_want(wgmma=2 * nb, bwd_wgmma=nb)
                    and all(math.isfinite(x) for x in b["losses"])
                    and local < whole,
                    f"mesh {mname} bf16 rank {rank}: {b}")
            for k, v in b["launches"].items():
                by_rank[rank][k] += v
            log(f"mesh {mname} gloo rank {rank}: {TRAIN_ARCH} at full width, "
                f"{MESH_BF16_LAYERS} of {cfg.num_layers} layers, bf16, "
                f"global B={MESH_BF16_BATCH} S={MESH_BF16_SEQ}, "
                f"{MESH_BF16_STEPS} steps: losses {b['losses']}, walls "
                f"{[round(w * 1e3, 1) for w in b['walls']]} ms; parameters "
                f"{local} of {whole} B ({local / whole:.1%}) on this rank; "
                f"peak {b['peak_gib']:.2f} GiB; K2 launches {b['launches']}")
            mo = res[f"{mname}/moe"]
            if mname == "1x2" or rank == 0:
                tol = MESH_MOE_TOL * mo["scale"]
                a1, a2 = mo["aux"]
                ok = (mo["err"] <= tol and abs(a1 - a2) <= 1e-5 * abs(a2))
                what = ("all_to_all vs grouped (both on the mesh)"
                        if mname == "1x2" else
                        "grouped G=2 vs one device G=2")
                log(f"mesh {mname} gloo rank {rank}: {GRANITE} layer f32 "
                    f"({MESH_MOE_BATCH}, {MESH_MOE_SEQ}), {what}: max|diff| "
                    f"{mo['err']:.3e} (tol {tol:.3e}), aux {a1!r} / {a2!r}; "
                    f"drops per group {mo['drops']}"
                    + (f", one device {mo['drops_one']}"
                       if "drops_one" in mo else "") + f": {ok}")
                require(ok, f"mesh {mname} MoE layer disagrees")
            log(f"mesh {mname} gloo rank {rank}: {res[f'{mname}/s']:.1f} s")
    # phase 21 (d): decode and the all_to_all gradients, rank 0 holds
    r0 = got[0]
    for key, what in (("1x2/qwen3 decode", f"{TRAIN_ARCH} decode under "
                       "(1, 2): T over model"),
                      ("1x2/mamba2 decode", f"{MAMBA_ARCH} decode under "
                       "(1, 2): SSM heads over model"),
                      ("2x1/qwen3 long decode", f"{TRAIN_ARCH} long_ctx "
                       f"decode, B=1, a {DECODE_LONG_T}-long cache, T over "
                       "(data, model) = (2, 1)"),
                      ("1x2/moe grads", f"{GRANITE} MoE layer gradients, "
                       "all_to_all vs grouped under (1, 2)")):
        d = r0[key]
        tol = DECODE_MESH_TOL * max(1.0, d["scale"])
        log(f"[{SMI[0] if SMI else ''}] phase 21 (d) gloo: {what}, f32 at "
            f"{HOLD_LAYERS} layers: max |diff| {d['err']:.3e} (tol "
            f"{tol:.3e}) against "
            + ("the grouped dispatch" if "moe" in key else "one device"))
        require(d["err"] <= tol, f"phase 21 (d) {what}: {d}")
    # each rank's group drops what one device's group of that rank drops
    d2 = got[0]["2/moe"]
    require(all(d > 0 for d in d2["drops_one"])
            and [got[r]["2/moe"]["drops"][0] for r in range(MESH_WORLD)]
            == d2["drops_one"],
            f"mesh 2 MoE: drops by rank differ from one device's groups "
            f"{d2['drops_one']}")
    return by_rank


def phase_mesh(train18: dict) -> dict:
    """Phase 20: NCCL at world 1 under a (1, 1) mesh, then two gloo ranks
    on the one card. Returns the launches: "nccl" (this process, K2) and
    by gloo rank."""
    t0 = time.perf_counter()
    launches, _ = mesh_nccl(train18)
    log(f"phase 20 NCCL (1, 1): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=mesh_rank,
                             args=(r, MESH_WORLD, os.path.join(tmp, "gloo"),
                                   q))
                 for r in range(MESH_WORLD)]
        for p in procs:
            p.start()
        try:
            got = dict(q.get(timeout=900) for _ in procs)
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
    by_rank = check_mesh_ranks(got)
    log(f"phase 20 gloo ranks: {time.perf_counter() - t0:.1f} s with the "
        "ranks' start-up")
    return {"nccl": launches, "by_rank": by_rank}


# ------------------------------------------------------------------ #
# the dry-run (21)
# ------------------------------------------------------------------ #
DRYRUN_CELLS = (("qwen3_0_6b", "train_4k"),
                ("granite_moe_3b_a800m", "prefill_32k"),
                ("gemma3_12b", "decode_32k"),       # ring caches
                ("mamba2_370m", "long_500k"))
DRYRUN_MULTI = ("mamba2_370m", "decode_32k")     # multi-pod, no components
DRYRUN_TIMEOUT_S = 400
DECODE21_SLOTS, DECODE21_SEQ, DECODE21_STEPS = 8, 4_096, 32
# the dry-run's count of a phase-18/19 step on fake tensors, without a
# mesh and on a fake (1, 1) mesh: a process of its own (its fake process
# group cannot share this process with phase 20's NCCL group)
MEASURE_STEP = """
import json, sys
sys.path.insert(0, "src")
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.optim.adamw import AdamWConfig
arch, mesh = sys.argv[1], sys.argv[2]
r = dryrun.measure_step(
    configs.get(arch), "train", int(sys.argv[3]), int(sys.argv[4]),
    mesh_shape=None if mesh == "none" else (1, 1),
    opt_cfg=AdamWConfig(total_steps=int(sys.argv[5]), warmup_steps=1))
print(json.dumps({k: r[k] for k in ("flops", "bytes", "coll",
                                     "state_bytes", "input_bytes",
                                     "peak_bytes", "peak_note")}))
"""


def dryrun_jobs(out: str) -> dict:
    """Start the dry-run's processes, all at once (CPU only, no card): the
    CLI for each of `DRYRUN_CELLS` single-pod and `DRYRUN_MULTI`
    multi-pod without components, and `MEASURE_STEP` for phase 18's and
    19's cells without a mesh and on (1, 1)."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    cli = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out", out]
    cmds = {f"{a} x {s}": cli + ["--arch", a, "--shape", s]
            for a, s in DRYRUN_CELLS}
    cmds[f"{DRYRUN_MULTI[0]} x {DRYRUN_MULTI[1]} multi-pod"] = cli + [
        "--arch", DRYRUN_MULTI[0], "--shape", DRYRUN_MULTI[1],
        "--multi-pod", "--no-components"]
    for arch in (TRAIN_ARCH, MAMBA_ARCH):
        for mesh in ("none", "1x1"):
            cmds[f"measure {arch} {mesh}"] = [
                sys.executable, "-c", MEASURE_STEP, arch, mesh,
                str(TRAIN_BATCH), str(TRAIN_SEQ), str(TRAIN_STEPS)]
    return {name: subprocess.Popen(cmd, cwd=root, env=env,
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
            for name, cmd in cmds.items()}


def dryrun_results(jobs: dict) -> dict:
    """Each job's exit code and output; every job must exit 0 (a failed
    cell makes the CLI exit 1)."""
    out = {}
    for name, proc in jobs.items():
        try:
            so, se = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            so, se = proc.communicate()
        require(proc.returncode == 0,
                f"dry-run {name}: exit {proc.returncode}\n{so[-2000:]}\n"
                f"{se[-4000:]}")
        out[name] = so
    return out


DISPATCH_TURNS = 2            # pairs of steps: K2 through its ops / direct


@contextlib.contextmanager
def direct_k2():
    """`ops.FlashAttention` calling K2's wrappers directly, as it did
    before K2's forward and backward became custom ops (the same kernels
    and launches, without the ops' dispatch)."""
    def forward(ctx, q, k, v, causal, window):
        if flash.bwd_route(q.dtype, q.shape[-1]) in flash.LSE_ROUTES:
            o, lse = flash.flash_attention_cuda(q, k, v, causal=causal,
                                                window=window,
                                                return_lse=True)
        else:
            o = flash.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window)
            lse = None
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash.flash_attention_bwd_cuda(
            q, k, v, o, do.contiguous(), ctx.causal, ctx.window, lse=lse)
        return dq, dk, dv, None, None
    fa = attn_ops.FlashAttention
    with mock.patch.object(fa, "forward", staticmethod(forward)), \
            mock.patch.object(fa, "backward", staticmethod(backward)):
        yield


def flops_on_card(arch: str, turns: int = 0) -> dict:
    """`arch` whole, bf16, B=8 x 4,096 from phase 18's dataset (seed 0),
    steps of `make_train_step` with remat, the counts set to 0 just
    before: the first under `FlopCounterMode` (its total), the second
    timed, then `turns` pairs of timed steps, K2 through its custom ops
    and through `direct_k2`, in turns; the state's bytes (parameters,
    AdamW's moments and step) and the peak allocated since the state was
    made."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = configs.get(arch)
    free()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, seed=0)
    opt_cfg = AdamWConfig(total_steps=TRAIN_STEPS,
                          warmup_steps=TRAIN_STEPS // 10 + 1)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    tensors = list(params.parameters()) + [
        t for m in ("mu", "nu") for t in state["opt"][m].values()] + [
        state["opt"]["step"]]
    state_bytes = sum(t.numel() * t.element_size() for t in tensors)
    step_fn = steps.make_train_step(cfg, opt_cfg)
    ds = SyntheticTextDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [{k: torch.from_numpy(x).cuda() for k, x in b.items()}
               for _, b in make_batches(ds, 0, 2 + 2 * turns)]
    # phase 21's card path: counts start at 0 here
    reset_counts()
    with FlopCounterMode(display=False) as counter:
        state, metrics = step_fn(state, batches[0])
        loss = float(metrics["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step_fn(state, batches[1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    turn_ms = {"ops": [], "direct": []}
    for i in range(2 * turns):
        how = "ops" if i % 2 == 0 else "direct"
        with (contextlib.nullcontext() if how == "ops" else direct_k2()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batches[2 + i])
            torch.cuda.synchronize()
            turn_ms[how].append((time.perf_counter() - t0) * 1e3)
    out = {"flops": int(counter.get_total_flops()), "wall_s": wall,
           "loss": loss, "state_bytes": state_bytes,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": launch_counts(), "turn_ms": turn_ms}
    del state, params, tensors, batches
    free()
    return out


def decode21(params, cfg, mesh=None) -> tuple[list, list]:
    """`DECODE21_STEPS` greedy `decode_step`s of `DECODE21_SLOTS` slots
    from one seeded token each, on a `DECODE21_SEQ`-long cache: (logits
    per step, tokens per step). With `mesh`, the parameters, caches,
    tokens and positions as DTensors in their shardings."""
    b = DECODE21_SLOTS
    tok = torch.from_numpy(np.random.default_rng(21).integers(
        0, cfg.vocab_size, (b, 1))).cuda()
    cache = M.init_cache(cfg, b, DECODE21_SEQ)
    ctx = contextlib.nullcontext()
    if mesh is not None:
        csh = steps.cache_shardings(cfg, mesh, b, DECODE21_SEQ)
        cache = [{k: distribute_tensor(t, mesh, csh[i][k].placements)
                  for k, t in layer.items()} for i, layer in enumerate(cache)]
        ctx = mesh_context(mesh)
    logits_all, toks = [], []
    with ctx:
        for i in range(DECODE21_STEPS):
            pos = torch.full((b,), i, dtype=torch.int64, device="cuda")
            t_in, p_in = tok, pos
            if mesh is not None:
                t_in = distribute_tensor(tok, mesh, NamedSharding(
                    mesh, logical_to_pspec(tok.shape, ("batch", None),
                                           mesh)).placements)
                p_in = distribute_tensor(pos, mesh, NamedSharding(
                    mesh, logical_to_pspec(pos.shape, ("batch",),
                                           mesh)).placements)
            logits, cache = M.decode_step(params, cache, t_in, p_in, cfg)
            if mesh is not None:
                logits = logits.full_tensor()
            tok = logits[:, -1].argmax(-1, keepdim=True)
            logits_all.append(logits)
            toks.append(tok)
    return logits_all, toks


def decode_nccl() -> dict:
    """qwen3-0.6b whole, bf16, seed 0: `decode21` on one device, then
    under a (1, 1) data x model mesh over NCCL (world 1): the tokens must
    be equal and the logits bit-equal."""
    cfg = configs.get(TRAIN_ARCH)
    params = M.init_params(cfg, seed=0)
    one, toks_one = decode21(params, cfg)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "nccl"), 1),
            rank=0, world_size=1,
            device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            mesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
            ps = steps.param_shardings(cfg, mesh)
            for prefix, mod in params.named_modules():
                for name, p in list(mod.named_parameters(recurse=False)):
                    full = f"{prefix}.{name}" if prefix else name
                    mod._parameters[name] = torch.nn.Parameter(
                        distribute_tensor(p.detach(), mesh,
                                          ps[full].placements),
                        requires_grad=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, toks = decode21(params, cfg, mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    same_tokens = all(torch.equal(a, b) for a, b in zip(toks, toks_one))
    bit_equal = all(torch.equal(a, b) for a, b in zip(got, one))
    err = max(float((a - b).abs().max()) for a, b in zip(got, one))
    scale = max(float(b.abs().max()) for b in one)
    del params, one, got
    free()
    return {"same_tokens": same_tokens, "bit_equal": bit_equal, "err": err,
            "scale": scale, "ms_per_step": wall / DECODE21_STEPS * 1e3}


def phase_dryrun() -> dict:
    """Phase 21: the dry-run's processes start first (CPU only) and run
    while this process drives the card: (a) qwen3's and mamba2's train
    step under `FlopCounterMode`, (b) their state bytes and peak, (c)
    qwen3's decode under a (1, 1) NCCL mesh; then (a) and (b) are held
    against the dry-run's counts, and (e) its cells must print [ok].
    Returns K2's and K3's launches of (a)."""
    t0 = time.perf_counter()
    smi = SMI[0] if SMI else "nvidia-smi: not read"
    with tempfile.TemporaryDirectory() as out:
        jobs = dryrun_jobs(out)
        card = {TRAIN_ARCH: flops_on_card(TRAIN_ARCH, DISPATCH_TURNS),
                MAMBA_ARCH: flops_on_card(MAMBA_ARCH)}
        dec = decode_nccl()
        log(f"phase 21 card work: {time.perf_counter() - t0:.1f} s")
        res = dryrun_results(jobs)
        cells = {}
        for a, sh_ in DRYRUN_CELLS + (DRYRUN_MULTI,):
            multi = (a, sh_) == DRYRUN_MULTI
            name = f"{a}__{sh_}__{'multi' if multi else 'single'}"
            with open(os.path.join(out, name + ".json")) as f:
                cells[name] = json.load(f)
    # (a) FLOPs: the card's count = the dry-run's, without a mesh and on
    # (1, 1); (b) the state's bytes = the dry-run's, its peak beside the
    # measured one
    n = {TRAIN_ARCH: configs.get(TRAIN_ARCH).num_layers,
         MAMBA_ARCH: configs.get(MAMBA_ARCH).num_layers}
    k = 2 + 2 * DISPATCH_TURNS          # qwen3's steps
    want_launches = {
        TRAIN_ARCH: {**k2_want(wgmma=2 * k * n[TRAIN_ARCH],
                               bwd_wgmma=k * n[TRAIN_ARCH]),
                     "ssd": 0, "ssd_bwd": 0},
        MAMBA_ARCH: {**k2_want(), "ssd": 4 * n[MAMBA_ARCH],
                     "ssd_bwd": 2 * n[MAMBA_ARCH]}}
    for arch, c in card.items():
        dr = {m: json.loads(res[f"measure {arch} {m}"].strip()
                            .splitlines()[-1]) for m in ("none", "1x1")}
        compute_s = dr["none"]["flops"] / BF16_OPS_PER_S
        memory_s = dr["none"]["bytes"] / HBM_BYTES_PER_S
        share = c["flops"] / (c["wall_s"] * BF16_OPS_PER_S)
        peak = dr["none"]["peak_bytes"]
        log(f"[{smi}] phase 21 (a) {arch} train step B={TRAIN_BATCH} "
            f"S={TRAIN_SEQ} bf16, remat: FlopCounterMode on the card "
            f"{c['flops']} FLOPs; dry-run without a mesh "
            f"{int(dr['none']['flops'])}, on a fake (1, 1) mesh "
            f"{int(dr['1x1']['flops'])}; step {c['wall_s'] * 1e3:.1f} ms "
            f"(loss {c['loss']:.6f}); dry-run compute_s {compute_s:.6f}, "
            f"memory_s {memory_s:.6f} (bytes {dr['none']['bytes']:.4e}); "
            f"share of the bf16 peak {share:.4f}; launches {c['launches']}")
        require(c["flops"] == int(dr["none"]["flops"])
                == int(dr["1x1"]["flops"]),
                f"phase 21 (a) {arch}: the card's FLOPs {c['flops']} differ "
                f"from the dry-run's {dr['none']['flops']} / "
                f"{dr['1x1']['flops']}")
        require(c["launches"] == want_launches[arch],
                f"phase 21 (a) {arch}: launches {c['launches']}")
        log(f"[{smi}] phase 21 (b) {arch}: state bytes on the card "
            f"{c['state_bytes']}, dry-run {dr['none']['state_bytes']} (on "
            f"(1, 1) {dr['1x1']['state_bytes']}); peak: dry-run "
            + ("not measured (" + dr["none"]["peak_note"] + ")"
               if peak is None else f"{peak / 2**30:.2f} GiB")
            + f", measured max_memory_allocated "
            f"{c['peak_bytes'] / 2**30:.2f} GiB"
            + ("" if peak is None else
               f", ratio {peak / c['peak_bytes']:.4f}"))
        require(c["state_bytes"] == dr["none"]["state_bytes"]
                == dr["1x1"]["state_bytes"],
                f"phase 21 (b) {arch}: state bytes differ")
    tm = card[TRAIN_ARCH]["turn_ms"]
    log(f"[{smi}] phase 21 {TRAIN_ARCH} train step, K2 through its custom "
        f"ops / called directly, in turns: {[round(x, 1) for x in tm['ops']]}"
        f" / {[round(x, 1) for x in tm['direct']]} ms")
    # (c) decode under (1, 1) NCCL
    log(f"[{smi}] phase 21 (c) {TRAIN_ARCH} decode, {DECODE21_SLOTS} slots, "
        f"{DECODE21_SEQ}-long cache, {DECODE21_STEPS} greedy steps under a "
        f"(1, 1) mesh over NCCL against one device: tokens equal "
        f"{dec['same_tokens']}, logits bit-equal {dec['bit_equal']} (max "
        f"|diff| {dec['err']:.3e} of max|logits| {dec['scale']:.3e}); "
        f"{dec['ms_per_step']:.1f} ms per mesh step")
    require(dec["same_tokens"] and dec["bit_equal"],
            "phase 21 (c): decode under (1, 1) differs from one device")
    # (e) the dry-run's cells on this torch
    for name, text in res.items():
        if name.startswith("measure"):
            continue
        ok = [line for line in text.splitlines() if line.startswith("[ok]")]
        require(len(ok) == 1, f"phase 21 (e) {name}: {text[-1000:]}")
        log(f"phase 21 (e) dry-run {name}: {ok[0]}")
    for name, r in cells.items():
        mem = r["memory"]["bytes_per_device"]
        log(f"phase 21 (e) {name}: "
            + ("n/a" if mem is None else f"{mem / 2**30:.2f} GiB")
            + f" per device (arguments {r['memory']['arg_bytes'] / 2**30:.3f}"
            f" GiB), dominant {r['roofline']['dominant']}, useful FLOP share "
            f"{r['useful_flops_frac']:.4f}, FLOPs per device "
            f"{r['hlo_flops']:.4e}, collective bytes "
            f"{r['collective_bytes']:.4e}; lower {r['lower_s']} s, step "
            f"{r['compile_s']} s")
    log(f"phase 21: {time.perf_counter() - t0:.1f} s")
    out = {k: card[TRAIN_ARCH]["launches"][k] + card[MAMBA_ARCH]["launches"][k]
           for k in card[TRAIN_ARCH]["launches"]}
    return out


def process_launches(by_phase: dict) -> int:
    """A kernel's launches in this process; the spawned gloo ranks' are
    listed by phase beside them, as phase 15b's are."""
    return sum(n for k, n in by_phase.items() if "rank" not in k)


def kernel_row(name, source, replaces, launches, err, t, by_phase,
               route="cuda") -> dict:
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "launches_by_phase": by_phase}


def main() -> None:
    device = phase_device()
    rng = np.random.default_rng(0)
    phase_build()
    err_small = phase_kernel_small(rng)

    t0 = time.perf_counter()
    g = make_road_network(FULL_N, seed=0, delete_frac=0.56)
    log(f"graph |V|={g.n} |E|={g.m} generated in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sssp = flip_torch.compile(g, "sssp")
    bg = sssp.engine.bg
    log(f"compiled sssp in {time.perf_counter() - t0:.1f} s: "
        f"{bg.bsrc.numel()} blocks, "
        f"{bg.blocks.numel() * 4 / 2**20:.1f} MiB on {bg.device}")
    require(bg.device.type == "cuda", "the default session is not on CUDA")
    err_full, timing = phase_kernel_full(bg, rng)
    err_deep, timing_deep = phase_kernel_deep()

    # the main path: counts start at 0 here
    srcs = np.sort(rng.choice(g.n, size=8, replace=False))
    bfs = flip_torch.compile(g, "bfs")
    phase4 = {}
    n4, phase4["sssp x8"] = run_query(sssp, srcs, "sssp x8")
    n, phase4["bfs"] = run_query(bfs, 0, "bfs")
    n4 += n
    n, phase4["bfs/op"] = run_query(
        flip_torch.compile(g, "bfs", flip_torch.ExecutionPlan(mode="op")),
        0, "bfs/op")
    n4 += n
    sssp_r = phase4["sssp x8"]
    profile_query(sssp, srcs, "sssp x8")
    profile_query(bfs, 0, "bfs")

    g2 = make_road_network(PROGRAM_N, seed=0, delete_frac=0.56)
    for algo in ("pagerank", "wcc", "widest", "reach", "multi_bfs",
                 "labelprop"):
        n4 += run_query(flip_torch.compile(g2, algo), 0, algo)[0]
    del g2
    k1_phases = {"4-5": n4}

    # the LM kernels, then the LM paths (each resets its kernel's count)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    err_attn, t_attn = phase_attention(gen)
    err_ssd, t_ssd = phase_ssd(gen)
    attn_launches, qwen3_routes = lm_path(
        "qwen3_0_6b", flash.flash_attention_cuda, rng)
    ssd_launches, _ = lm_path("mamba2_370m", ssd.ssd_intra_cuda, rng)

    # the graph-serving surface on phase 4's network and sessions
    for phase, fn in (("9 updates", lambda: phase_updates(sssp, srcs, rng)),
                      ("10 trace", lambda: phase_trace(sssp, bfs, srcs)),
                      ("11 serving", lambda: phase_serving(g, rng)),
                      ("12 mapping", lambda: phase_mapping(rng)),
                      ("13 bucket server",
                       lambda: phase_bucket_server(g, rng)),
                      ("14 autotune",
                       lambda: phase_autotune(g, srcs, sssp, bfs, sssp_r))):
        t0 = time.perf_counter()
        n = fn()
        k1_phases[phase.split()[0]] = n
        log(f"phase {phase}: {time.perf_counter() - t0:.1f} s, {n} kernel "
            "launches")
    t0 = time.perf_counter()
    n, loop22 = phase_device_loop(g, sssp, bfs, srcs, rng)
    k1_phases["22"] = n
    log(f"phase 22 device loop: {time.perf_counter() - t0:.1f} s, {n} "
        f"kernel launches; {json.dumps(loop22)}")

    # the distributed fixpoint with no group (one rank, no collective)
    k1_phases["15 graph_run no group"] = dist_graph_run("no group")
    # one process group for the distributed phases: NCCL at world 1
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "nccl"), 1),
            rank=0, world_size=1,
            device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            t0 = time.perf_counter()
            n15, d15 = phase_distributed(g, srcs, bg, phase4, rng)
            k1_phases.update(n15)
            for rank, nr in d15["by_rank"].items():
                k1_phases[f"15b rank {rank}"] = nr
            log(f"phase 15 distributed: {time.perf_counter() - t0:.1f} s, "
                f"{n15} kernel launches in this process, "
                f"{d15['by_rank']} by gloo rank; {json.dumps(d15['a'])}")
            del sssp, bfs, bg
            torch.cuda.empty_cache()

            t0 = time.perf_counter()
            granite_launches, granite_routes = lm_path(
                GRANITE, flash.flash_attention_cuda, rng)
            ep_check(configs.get(GRANITE), dist.group.WORLD, gen)
            log(f"phase 16 granite: {time.perf_counter() - t0:.1f} s, "
                f"{granite_launches} K2 launches in the bf16 prefills")
        finally:
            dist.destroy_process_group()

    t0 = time.perf_counter()
    wgmma17, f32_17, k3_17 = phase_configs(rng, gen)
    log(f"phase 17 configs: {time.perf_counter() - t0:.1f} s; K2 wgmma "
        f"{wgmma17}, tf32x3 {f32_17}; K3 {k3_17}")

    t0 = time.perf_counter()
    err_bwd, t_bwd, k2_18, train18 = phase_train(gen)
    log(f"phase 18 train: {time.perf_counter() - t0:.1f} s; K2 {k2_18}")

    t0 = time.perf_counter()
    err_ssd_bwd, t_ssd_bwd, k3_19 = phase_train_mamba(gen)
    log(f"phase 19 train mamba: {time.perf_counter() - t0:.1f} s; K3 "
        f"{k3_19}")

    t0 = time.perf_counter()
    m20 = phase_mesh(train18)
    k20 = {"wgmma": {"20 mesh (1, 1) NCCL": m20["nccl"]["wgmma"]},
           "bwd_wgmma": {"20 mesh (1, 1) NCCL": m20["nccl"]["bwd_wgmma"]}}
    for kind in (*k2_want(), "ssd", "ssd_bwd"):
        k20.setdefault(kind, {}).update(
            {f"20 gloo rank {r}": n[kind]
             for r, n in m20["by_rank"].items()})
    log(f"phase 20 mesh: {time.perf_counter() - t0:.1f} s; {k20}")

    k21 = phase_dryrun()
    k21 = {kind: {"21 dryrun FLOPs steps": k21[kind]} for kind in k21}

    k1_main = sum(v for k, v in k1_phases.items() if "rank" not in k)
    wgmma_by_phase = {"8 qwen3": qwen3_routes["wgmma"],
                      "16 granite": granite_routes["wgmma"], **wgmma17,
                      **k2_18["wgmma"], **k20["wgmma"], **k21["wgmma"]}
    f32_by_phase = {"8 qwen3 f32 replay": qwen3_routes["tf32x3"],
                    "16 granite f32 replay": granite_routes["tf32x3"],
                    **f32_17, **k2_18["tf32x3"], **k3_19["tf32x3"],
                    **k20["tf32x3"]}
    fma_by_phase = {**k2_18["fma"], **k20["fma"]}
    bwd_wgmma_by_phase = {**k2_18["bwd_wgmma"], **k20["bwd_wgmma"],
                          **k21["bwd_wgmma"]}
    bwd_f32_by_phase = {**k2_18["bwd_tf32x3"], **k3_19["bwd_tf32x3"],
                        **k20["bwd_tf32x3"]}
    bwd_fma_by_phase = {**k2_18["bwd_fma"], **k20["bwd_fma"]}
    t32 = t_bwd["f32"]
    ssd_by_phase = {"8 mamba2": ssd_launches, **k3_17, **k3_19["ssd"],
                    **k20["ssd"], **k21["ssd"]}
    ssd_bwd_by_phase = {**k3_19["ssd_bwd"], **k20["ssd_bwd"],
                        **k21["ssd_bwd"]}
    print(json.dumps({"kernels": [
        dict(kernel_row(
            "frontier_relax",
            "src/repro_torch/kernels/frontier/csrc/frontier_relax.cu",
            "src/repro/kernels/frontier/frontier.py:137", k1_main,
            max(err_small, err_full, err_deep, d15["err"]),
            dict(timing["all"], library_ms=None), k1_phases),
            deep_shape=timing_deep),
        dict(kernel_row(
            "flash_attention",
            "src/repro_torch/kernels/attention/csrc/flash_attention_wgmma.cu",
            "src/repro/kernels/attention/flash.py:84",
            process_launches(wgmma_by_phase), err_attn, t_attn, wgmma_by_phase),
            kernel_route="wgmma", hubert_hd80={
                k: t_attn["hd80"][k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "tile_bound_ms")},
            gemma3_hd256=t_bwd["gemma3"]["forward"]),
        dict(kernel_row(
            "flash_attention",
            "src/repro_torch/kernels/attention/csrc/flash_attention_tf32.cu",
            "src/repro/kernels/attention/flash.py:84",
            process_launches(f32_by_phase),
            max(t32["forward"]["max_abs_err"],
                t_attn["max_abs_err_by_route"]["tf32x3"]),
            t32["forward"], f32_by_phase),
            kernel_route="tf32x3",
            shape=t32["forward"]["shape"],
            ms_again=t32["forward"]["ms_again"],
            fma_ms=t32["forward"]["fma_ms"],
            fp32_bound_ms=t32["forward"]["fp32_bound_ms"],
            library_backend=t32["forward"]["library_backend"],
            tf32_library_ms=t32["forward"]["tf32_library_ms"],
            tf32_library_max_abs_err=t32["forward"].get(
                "tf32_library_max_abs_err"),
            lse_max_abs_err=err_bwd["lse"],
            gemma3_hd256=t32["gemma3_forward"]),
        dict(kernel_row(
            "flash_attention",
            "src/repro_torch/kernels/attention/csrc/flash_attention.cu",
            "src/repro/kernels/attention/flash.py:84",
            process_launches(fma_by_phase),
            t_attn["max_abs_err_by_route"]["fma"],
            dict(t_attn, ms=t_attn["fma_ms"]), fma_by_phase),
            kernel_route="fma", hubert_hd80={
                "ms": t_attn["hd80"]["fma_ms"],
                "bound_ms": t_attn["hd80"]["bound_ms"]},
            f32={**{k: t32["forward"][k] for k in (
                "shape", "library_ms", "library_backend", "fp32_bound_ms")},
                 "ms": t32["forward"]["fma_ms"]}),
        dict(kernel_row(
            "flash_attention_bwd",
            "src/repro_torch/kernels/attention/csrc/"
            "flash_attention_bwd_wgmma.cu",
            "src/repro/kernels/attention/flash.py:84",
            process_launches(bwd_wgmma_by_phase), err_bwd["wgmma"], t_bwd,
            bwd_wgmma_by_phase),
            kernel_route="wgmma",
            shape="bf16 q (8, 4096, 16, 128), k/v (8, 4096, 8, 128), causal",
            plain_batch=t_bwd["plain_batch"],
            floor_7_products_ms=t_bwd["floor_7_products_ms"],
            lse_max_abs_err=err_bwd["lse"],
            forward_ms_without_lse=t_bwd["fwd_ms"],
            forward_ms_with_lse=t_bwd["fwd_lse_ms"],
            gemma3_hd256={k: t_bwd["gemma3"][k]
                          for k in ("shape", "global", "local")}),
        dict(kernel_row(
            "flash_attention_bwd",
            "src/repro_torch/kernels/attention/csrc/"
            "flash_attention_bwd_tf32.cu",
            "src/repro/kernels/attention/flash.py:84",
            process_launches(bwd_f32_by_phase), err_bwd["tf32x3"],
            t32["backward"], bwd_f32_by_phase),
            kernel_route="tf32x3",
            shape=t32["backward"]["shape"],
            plain_batch=t32["backward"]["plain_batch"],
            ms_again=t32["backward"]["ms_again"],
            fma_ms=t32["backward"]["fma_ms"],
            floor_7_products_ms=t32["backward"]["floor_7_products_ms"],
            fp32_bound_ms=t32["backward"]["fp32_bound_ms"],
            library_backend=t32["backward"]["library_backend"],
            tf32_library_ms=t32["backward"]["tf32_library_ms"],
            gemma3_hd256=t32["gemma3_backward"],
            qwen3_f32_train={k: train18["f32"][k] for k in (
                "ms_per_step", "tokens_per_s", "peak_gib", "profile",
                "worst_grad_rel")}),
        dict(kernel_row(
            "flash_attention_bwd",
            "src/repro_torch/kernels/attention/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/attention/flash.py:84",
            process_launches(bwd_fma_by_phase), err_bwd["fma"],
            dict(t_bwd, ms=t_bwd["fma_ms"]), bwd_fma_by_phase),
            kernel_route="fma",
            shape="bf16 q (8, 4096, 16, 128), k/v (8, 4096, 8, 128), causal",
            plain_batch=t_bwd["plain_batch"],
            bound_recompute_ms=t_bwd["bound_recompute_ms"],
            f32={**{k: t32["backward"][k] for k in (
                "shape", "library_ms", "library_backend", "fp32_bound_ms")},
                 "ms": t32["backward"]["fma_ms"]},
            gemma3_hd256_ms={w: t_bwd["gemma3"][w]["fma_ms"]
                             for w in ("global", "local")}),
        dict(kernel_row("ssd_intra",
                        "src/repro_torch/kernels/ssd/csrc/ssd_intra.cu",
                        "src/repro/kernels/ssd/ssd.py:50",
                        process_launches(ssd_by_phase), err_ssd, t_ssd,
                        ssd_by_phase),
             bound_rate=t_ssd["bound_rate"], jamba_shape=t_ssd["jamba"]),
        dict(kernel_row("ssd_intra_bwd",
                        "src/repro_torch/kernels/ssd/csrc/ssd_intra_bwd.cu",
                        "src/repro/kernels/ssd/ssd.py:50",
                        process_launches(ssd_bwd_by_phase), err_ssd_bwd,
                        t_ssd_bwd, ssd_bwd_by_phase),
             kernel_route=ssd.BWD_ROUTE,
             reference_backward="none: the reference differentiates its jnp "
             "ssd_ref (src/repro/kernels/ssd/ref.py:20)",
             shape="f32 b=8 nc=16 Q=256 N=128 H=32 P=64 (mamba2 training)",
             bound_rate=t_ssd_bwd["bound_rate"],
             f32_bound_ms=t_ssd_bwd["f32_bound_ms"],
             function_max_abs_err=t_ssd_bwd["function_max_abs_err"],
             forward_ms_same_shape=t_ssd_bwd["fwd_ms"],
             jamba_shape=dict(t_ssd_bwd["jamba"], shape="f32 b=2 nc=16 "
                              "Q=256 N=128 H=128 P=128")),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
