#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --phases card,build,kernels   # after a kernel edit

Phases, each printing JSON lines:

  card      the card's name and power limit (nvidia-smi), torch and CUDA
  build     compile the kernel library from ``src/repro_torch/kernels/csrc``;
            each tensor-core kernel's registers, shared memory and spills
            (ptxas; a spill is a failure), and its HGMMA and UTMALDG (wgmma)
            or HMMA (mma.sync: wkv6's chunked kernels) instructions counted
            in the library's SASS (cuobjdump; none is a failure); the
            instructions of one threefry2x32 block by opcode and pipe
            (``threefry_sass``: the draw's bound); the warp votes of the
            compacted draw in every instantiation of counter_noise's and
            noise_update's kernels (``warp_sass``: none is a failure)
  kernels   each of the fourteen kernels against its plain PyTorch version on
            the card, at the shapes each train path below gives it (bf16;
            each tap routed as ``core.bk.plan_report`` says, one case a
            layer shape and route, the deepest stack's; MoE records and
            masks from the path's own step-0 forward; hymba's bcdt, p = 57,
            which bk-mixopt caches, on grad_norm_direct's and clipped_grad's
            SIMT routes too), at the prefill paths' shapes
            (flash_attention, wkv6; bf16) and at ragged f32
            shapes (wkv6 also under strong constant decay, w = 0.1 and
            0.01, and a mixed decay: log-uniform in [1e-6, 1] with exact
            zeros and ones; T not a multiple of its chunk); norms,
            fused_clip_grad's outputs (under all four clip functions, w
            with a zero), flash_attention and wkv6 run twice must agree
            bitwise; kernel, plain and one-call library times with CUDA
            events (at least 3 runs each; the plain, SIMT and library
            versions only at the kernel's ROW_PATH and TIMED_PATHS, the
            kernel alone elsewhere), and for fused_clip_grad (at the
            smoke-width parity_layer model's units, the path that launches
            it, f32, its SIMT route; and at FUSED_EDGES, the largest bf16 units
            ``dispatch.fused_plan`` fuses, FUSED_WALKS, the fused units
            with more tiles than the card holds CTAs, which the kernel's
            CTAs walk, bf16 and f32, and one tile)
            the composed route it replaces, its device time and the kernels
            one call launches by torch.profiler (one, or the phase fails),
            and its launch plan. ghost_norm, clipped_grad,
            grad_norm_direct, flash_attention, moe_ghost_norm,
            moe_direct_norm, moe_clipped_grad and fused_clip_grad take
            their wgmma kernels on bf16 (``route``):
            there each is also held to its SIMT kernel on the same inputs
            (the weighted grads at SIMT_GRAD_TOL, the norms at NORM_TOL,
            flash at the bf16 tolerance) and to itself run twice (bitwise),
            with the SIMT kernel timed beside it (simt_ms), at every train
            path's / the prefill's shapes, at one tile, and at ragged bf16
            shapes (moe_ghost_norm also at C > 64 under a non-binary mask;
            fused_clip_grad at FUSED_EDGES, G at SIMT_GRAD_TOL, sq at
            NORM_TOL);
            ghost_norm's, grad_norm_direct's and moe_ghost_norm's three
            versions also against a float64 evaluation (the wgmma kernel
            within NORM_TOL's rtol of it; grad_norm_direct's library forms
            include the instantiated bf16 einsum). wkv6 takes its chunked
            kernel (tensor cores, split TF32) on f32 and bf16 with h a
            multiple of 16: held to its scan kernel likewise (simt_ms: the
            scan's time), and at the prefill's shapes all three versions to
            a float64 recurrence at one head (the chunked kernel within
            WKV_LONG_TOL of it); also with u per sample, (B,H,h), at
            train_rwkv's shapes and ragged f32. wkv6_backward (no TPU
            counterpart: the recurrence's gradients, from the chunked
            forward's saved chunk states) against ``plain_backward``
            (autograd through the recurrence) at WKV_BWD_TOL: at
            train_rwkv's shapes (bf16, u per sample), ragged f32 (T not a
            multiple of a chunk, h 16 and 64, both u layouts), the strong
            constant decays and the mixed decay (f32 and bf16); at one
            (b, head) against float64 autograd; bitwise run to run; its
            bound from the six h x h f32 FMA passes a token and head.
            rwkv6's narrow mm taps (tm_w1, tm_w2_i, wa, wb: the direct
            norm and clipped_grad at widths 32 to 160) in ``wgmma``.
            emb_ghost_norm and emb_clipped_grad at train's ids, the ragged
            ids, ids of 4 values and one id at every position (bitwise run
            to run), each with its device time by torch.profiler beside
            its CUDA-event time.
            counter_noise (phase-4 noise: threefry2x32 + ndtri + the add,
            no TPU counterpart; ``counter_noise_checks``): (a) the
            threefry2x32 known answers and the bits of the golden file
            (``src/repro_torch/core/noise_golden.json``, the JAX package's
            keys, bits and normals at chosen indices, indices past 2^32 of
            a (8, 2^31) tensor too) through ``dp_threefry_bits``, then 2^26
            random counters against the plain threefry2x32, bitwise; (b)
            ``dp_ndtri_f32`` over all 2^24 uniforms against the plain
            ndtri (within NOISE_ULP) and float64 (within NDTRI_F64_REL),
            all finite; (c) the kernel against its plain version at every
            leaf of ``train`` (bf16), its three largest leaves in f32,
            ragged f32 and bf16 leaves and a depth-10 tree with
            completion: one-key draws within NOISE_ULP, outputs equal
            wherever the draws are, bitwise run to run; its bound from the
            build phase's SASS count of one threefry2x32 block; (d) the
            golden normals within GOLDEN_ULP; (e) each train leaf's time
            by events beside the plain version's and the randn + multiply
            + add + divide chain it replaces (composed_ms); its device time
            from ``train_ghostclip``'s profiled step (the BK paths draw
            inside noise_update); every case bitwise the plain version, an
            odd-offset leaf alone and in place too.
            noise_update (phase 4 + the AdamW / SGD step in one pass a
            leaf, no TPU counterpart; ``noise_update_checks``): every leaf
            of ``train`` (bf16), its three largest leaves in f32, ragged,
            odd-offset and mixed-alignment leaves, SGD and AdamW with and
            without weight decay, a depth-10 tree with completion and no
            noise; m and v within f32 TOL of the plain version (counter_
            noise's plain version, then the torch chain), p within its
            dtype's TOL; the draws bitwise counter_noise's (m from m = v =
            0 under b1 = 0); bitwise run to run; each train leaf's time
            beside the plain version's and ``torch._fused_adamw_``'s
            (library_ms); its device time from ``train``'s profiled step.
            Its FTRL branch (DP-FTRL, momentum 0.9) at every leaf of
            ``train`` (bf16, timed: the ``ftrl`` entry of its summary
            row, against 26 and 24 bytes an element): a restart step at
            its 1 key (local t = 1) and an ordinary one at t = 3 of a tree
            without restarts (hi 2, lo 1: 2 distinct draws); both at those
            3 keys at its three largest leaves in f32, ragged, unaligned
            and mixed-alignment leaves and no noise; s, m and t0 bitwise
            the plain version's, bf16 p within half an ulp of the plain
            f32 p (+ f32 TOL), bitwise run to run.
            shard blocks (both noise kernels' block route, a rank's block
            of a leaf under a mesh; ``shard_block_checks``): every rank
            block of every leaf of ``train`` under the meshes (2,2),
            (4,2) and (2,2,2) (runs that stay in their rows), then
            SHARD_RAGGED's blocks and train's o/w at an odd offset (runs
            that cross rows), counter_noise at a Gaussian key and a tree's
            two draws, noise_update's AdamW, SGD and FTRL at both: each
            block bitwise the same block of the whole-leaf launch, the
            plain version on the card and a zeroed guard around it
            untouched; then one (2,2) rank's blocks of train's leaves timed
            by the block route beside the window route over the same
            elements (each kernel's summary row: ``shard_block_route``)
  noise     (not in the default run) counter_noise's and noise_update's
            checks alone, shard blocks included
  wgmma     (not in the default run) the short call after a tensor-core
            kernel edit: those checks at one tile, the ragged bf16 shapes
            and one row shape of each (the head tap of ``train``, whose
            ghost_norm items take the p split, the ``prefill`` attention,
            ``train_moe``'s up tap with random records under a router-like
            mask, ``train_long``'s qkv tap), fused_clip_grad at FUSED_EDGES
            and one tile, rwkv6's narrow mm taps, and every wkv6 and
            wkv6_backward case of the kernels phase, without building a
            model
  train             qwen2-1.5b, full (28 layers, bf16), B=8, T=512, remat on
                    (its registered config's); then the same steps with
                    remat off on the same seed: both params' sha256, bitwise
                    or the largest difference (within the bf16 TOL), both
                    peaks and step seconds
  train_nonprivate  the same, mode 'nonprivate' (standard training: the
                    mean loss's gradient, no port kernel)
  train_ghostclip   the same, mode 'ghostclip' (the norm kernels of mode
                    'bk''s plan, asserted against ``plan_report``: 5
                    ghost_norm + 1 emb_ghost_norm a step; then a second
                    backward per clip unit, no weighted-grad kernel); after
                    the train paths a ``paper_ratios`` line: bk-mixopt over
                    nonprivate and ghostclip over bk-mixopt, in step
                    seconds, profiled device time and peak memory
  train_moe         deepseek-moe-16b at full width, 6 of its 28 layers
                    (dense0_0 + 5 MoE blocks), B=8, T=512
  train_moe_direct  the same with the experts group forced to the direct
                    norm (2 steps)
  train_long        qwen2-1.5b at full width, LONG_LAYERS of its 28 layers,
                    B=2, T=2048: qkv and o take the direct norm with the
                    mixopt cache off
  train_layer       qwen2-1.5b, full, B=8, T=512, clipping scope 'layer':
                    each mm unit streams through the composed route
                    (ghost_norm, then clipped_grad): none fits the fused
                    budget of ``kernels.dispatch.fused_plan``
  train_tape        train_long's model and shapes, tape 'recompute': no
                    weighted-grad kernel, a reweighted backward per unit
                    (2 steps)
  train_ftrl        qwen2-1.5b at full width, LONG_LAYERS of its 28 layers,
                    B=8, T=512, 4 steps of DP-FTRL
                    (--optimizer ftrl --ftrl-momentum 0.9 --restart-every 2
                    --tree-completion --epsilon 3 --dataset-size 50000):
                    sigma from the tree accountant, the ledger's epsilon at
                    the end; train's kernels and one FTRL noise_update a
                    leaf a step
  train_rwkv        rwkv6-3b at full width (d 2560, 40 heads x 64, d_ff
                    8960, V 65536, bf16), all 32 layers (RWKV_LAYERS; 28
                    until remat), B=8, T=512: the recurrence through
                    Wkv6Fn (wkv6 twice a layer, its forward and remat's
                    recompute, and wkv6_backward once),
                    the direct norm on its narrow taps (a flat DPConfig: no
                    registered policy)
  train_hymba       hymba-1.5b at full width (d 1600, 25 heads GQA kv 5 x
                    64, ssm_state 16, d_ff 5504, V 32001, 128 meta tokens,
                    window 1024, bf16), all 32 layers (HYMBA_LAYERS; 30
                    until remat; global 0, 15 and 31), B=4, T=1024 (T +
                    meta = 1152 >
                    the window): a flat DPConfig (no registered policy);
                    the kernels ``core.bk.plan_report`` routes its taps to,
                    the head's ghost_norm and clipped_grad on their SIMT
                    routes (p = 32001), every other on wgmma; bk-mixopt
                    caches bcdt (p = 57) and the unstacked fuse_o (no
                    kernel). Also the bytes autograd saves in one BK
                    forward outside the remat blocks, by kind (the global
                    layers' attention probabilities, SSM chunk tensors, the
                    rest), what remat keeps (the blocks' inputs, the
                    records), the tap outputs the tape does not hold and
                    the backward's peak over the forward (the recompute
                    included), and the optimizer state's
  train_whisper     whisper-small at full width and depth (12 encoder + 12
                    decoder layers, d 768, 12 heads x 64, d_ff 3072 GELU,
                    LayerNorm, V 51865, bf16), B=8, Tf=1500 frames (--seq),
                    Td=448 tokens: a flat DPConfig (no registered policy);
                    the encoder's four stacked taps and the cross keys and
                    values (xattn/kv, recorded at Tf) take grad_norm_direct,
                    the frontend bk-mixopt's cache, the decoder's six taps
                    and the head ghost_norm; the head's ghost_norm and
                    clipped_grad on their SIMT routes (p = 51865), every
                    other launch on wgmma; the saved bytes by kind (whisper
                    does not remat, as its reference)
  train_qwen25      qwen2.5-3b at full width and depth (36 layers, d 2048,
                    16 heads / 2 kv, d_ff 11008, V 151936, QKV bias), B=8,
                    T=512, AdamW, 2 steps (the second profiled)
  train_qwen3       qwen3-14b at full width (d 5120, 40 heads / 8 kv x 128,
                    qk-norm, d_ff 17408, V 151936), QWEN3_LAYERS of its 40
                    layers (the depth one card holds), B=8, T=512, AdamW,
                    2 steps
  train_llama3      llama3-405b at full width (d 16384, 128 heads / 8 kv,
                    d_ff 53248, V 128256: its embedding and head leaves
                    2,101,346,304 elements each), LLAMA3_LAYERS of its 126
                    layers, B=8, T=512, SGD (AdamW's moments do not fit),
                    2 steps
  train_moonshot    moonshot-v1-16b-a3b at full width (d 2048, 64 experts
                    top-6 + 2 shared, renorm_topk, dense0_0 d_ff 11264, V
                    163840), MOONSHOT_LAYERS of its 48 layers, B=8, T=512,
                    AdamW, 2 steps
            (the four decoder configs: a flat DPConfig, every mm tap ghost
            and to clipped_grad, moonshot's experts to the MoE kernels; the
            kernels phase checks each tap at their shapes, timing the
            kernel alone, then the index width: emb_clipped_grad's and the
            head's clipped_grad outputs at train_llama3's 2,101,346,304
            elements and at train_internvl2's shapes against their plain
            versions on the last 2^20)
  train_internvl2   internvl2-26b (the vlm family) at full width (d 6144, 48
                    heads / 8 kv x 128, d_ff 16384, V 92553, 1024 patch
                    embeddings of width 3200, bf16), INTERNVL2_LAYERS of its
                    48 layers (the depth one card holds), B=8, 512 text
                    tokens after the 1024 patches, AdamW, 3 steps: a flat
                    DPConfig; the projector (T = 1024), qkv, o, up, down and
                    the head (T = 1536) ghost and to clipped_grad, the
                    head's pair on its SIMT routes (p = 92553), every other
                    launch wgmma; the profile's ``port_kernels_ms`` gives
                    the SIMT pair's device ms (T9); the kernels phase times
                    the head's SIMT kernels beside their einsums (path
                    ``internvl2_head``)
            each: the arch's registered policy, bk-mixopt (unless named),
            sigma=1.0, AdamW (unless named), remat as its registered config
            sets it (every one but whisper's blocks remat), through
            ``repro_torch.launch.train.train`` (losses drained every step);
            launch counts per step (noise_update: one a leaf on every path;
            counter_noise: one a noised leaf on train_ghostclip, none on
            the BK paths and under 'nonprivate'); the last step runs under
            torch.profiler, whose summary gives the device time of the
            ``bk_phases_1_3`` and ``phase4_update`` ranges
  train_cnn     a CNN defined in this script (tests/test_conv_dp.py's
                TinyCNN pattern with one more strided conv: 7x7/2 3 -> 64
                with a bias, 3x3/2 64 -> 128, 3x3/2 128 -> 256, ReLUs,
                global average pool, 256 -> 1000 with a bias; ResNet-18's
                stem widths), B=32 images of 224 x 224 x 3, bf16, AdamW,
                sigma 1.0, through ``launch.steps.make_train_step``: 3
                steps of bk-mixopt (its cache takes the three convs' small
                per-sample grads: the head's ghost_norm and clipped_grad
                alone), then 3 of bk-mixghost (each conv's
                grad_norm_direct and clipped_grad, c1's on their SIMT
                routes at d = 147, c2's and c3's on wgmma); each step's
                launches held to ``plan_report``'s, the first loss near
                ln(1000); the last step of each profiled. The kernels phase
                checks every conv tap (bf16 at B=32, f32 at parity_cnn's
                B=4: their ghost, direct and weighted-grad kernels)
  train_mesh    ``train`` through the mesh path at LONG_LAYERS of its 28
                layers: --mesh 1,1, a world of one
                process under NCCL (B=8, T=512, sigma 1, 3 AdamW steps);
                its params' sha256 and epsilon equal a no-mesh run's in
                the same phase; its launches a step as train's (none by
                the noise kernels' block route), its last step profiled
  train_mesh2   two processes sharing the card under gloo (NCCL cannot put
                two ranks on one device), qwen2-1.5b at full width and 2 of
                its 28 layers, f32, B=8, T=512, sigma 1, 2 AdamW steps
                (MESH2), after the same run in this process (world 1): (a)
                --mesh 2,1 (4 rows a rank, one all-reduce a weighted grad,
                a checkpoint every step) within rtol 1e-3 / atol 1e-5 and
                losses within 1e-4, (b) --mesh 1,2 (the model axis: blocks
                that take the noise kernels' block route) bitwise, (c) (a)'s
                last checkpoint (two process files, slices at nonzero
                offsets) restored in this process with (a)'s params sha256
                and epsilon; every run's launches a step held to train's
                kernels on the SIMT routes (f32) and one noise_update a
                leaf, of them the block route's as many as the rank's
                blocks that are not one run of the leaf (none on world 1,
                some on (b)); (d) the bf16 clipped sums of one step over
                2,1 equal to world 1's in 99% of elements or more (f32
                partials summed, then cast once), every gap within one
                bf16 ulp of its leaf's largest magnitude;
                each rank's peak, the bytes of its blocks at rest and its
                step seconds. No multi-card number: one card
  train_resume  checkpoint and restart through ``launch.train``'s command
                line (``RESUME_CASES``): (a) qwen2-1.5b at full width and
                LONG_LAYERS of its 28 layers (``--layers``), registered
                policy, bk-mixopt, AdamW, B=8, T=512,
                sigma 1.0, 4 steps; (b) DP-FTRL at the smoke width (f32,
                restarts every 4, 8 steps). Each: the run without a
                checkpoint directory in this process, then with
                ``--ckpt-dir`` (``--ckpt-every 2``) in a subprocess that
                ``REPRO_FAULT`` kills at the top of step 3 (b: 6) and must
                die so, then the same command again in this process: it
                must resume (``resumed_from`` > 0) and end with the first
                run's ``params_sha256`` and epsilon, each equal, launching
                each kernel a step as that run did. Prints the disk's free
                bytes and MemAvailable, the checkpoint's bytes, the seconds
                its save blocked the step (the copy to pinned host
                buffers), the writer thread's seconds, the seconds of
                ``latest_step`` + ``restore``, and the saving step's peak
                device memory against the same step of the first run: the
                gap must stay under SAVE_PEAK_GAP (1 GiB: no device copy).
                The checkpoints go under ``build/train_resume/`` and are
                deleted
  prefill       qwen2-1.5b, full (28 layers, bf16), B=4, T=4096, through
                ``model.prefill``: flash_attention once a layer
  prefill_rwkv  rwkv6-3b, full (32 layers, bf16), B=4, T=4096: wkv6 once a
                layer
  prefill_hymba hymba-1.5b, full (32 layers, bf16), B=4, T=3968 (T + meta =
                4096, so the sliding-window layers take the chunked band):
                flash_attention once a global layer (3 a prefill)
  prefill_whisper whisper-small, full (12 + 12 layers, bf16), B=4, 1500
                frames and 448 tokens: flash_attention 3 times a layer (the
                encoder's bidirectional 1500 x 1500, the decoder's causal
                448, the cross-attention's bidirectional 448 x 1500: 36 a
                prefill, all wgmma); frames + tokens a second
  prefill_internvl2 internvl2-26b, full (48 layers, bf16), B=2, 1024 patches
                (projected) and 1024 prompt tokens: flash_attention once a
                layer at T = 2048 (48 / 8 heads, h 128, wgmma); patches +
                tokens a second
            each: three prefills (warm-up, timed, profiled); launches per
            prefill; finite last-position logits
  serve, serve_rwkv, serve_hymba, serve_whisper
            ``launch.serve.generate`` of each model, full: B=4 prompts of
            16 tokens, 16 generated (teacher-forced prompt, greedy decode
            against the cache); decode ms/token, peak memory; whisper first
            encodes 1500 frames into the cross caches (``prefill_cross``:
            12 flash_attention launches, wgmma) and decodes against them
  parity, parity_moe, parity_long, parity_layer
            one BK step of a 2-layer, full-width, f32 model of each path
            with the kernels and with ``use_kernels=False`` (parity_long
            under bk-mixghost, so that the direct norm runs at 2 layers;
            parity_layer also at qwen2-1.5b's smoke_config width, where
            every mm unit fuses: fused_clip_grad's driven path, whose
            launches count; f32, so every launch takes the SIMT routes);
            then one noised AdamW step over the kernel run's sums, the
            train step's route (one noise_update a leaf) against the plain
            version leaf by leaf, params and moments at f32 TOL; at
            parity_layer's smoke width (2 layers, f32), three noised steps
            of DP-FTRL (tree noise, restarts every 2 with completion: one
            noise_update a leaf a step), LAMB and Adafactor (one
            counter_noise a noised leaf a step, then their torch chains)
            on the card held to the same steps on the CPU (the plain
            versions), params and state at f32 TOL
  parity_rwkv
            one BK step of a 1-layer, full-width, f32 rwkv6-3b model, B=4,
            T=512, on the card (on the card the recurrence always takes
            wkv6 and wkv6_backward) against the same params and batch on
            the CPU (the plain versions; the recurrence by the JAX
            package's route): norms at NORM_TOL, sums at f32 TOL; then one
            noised AdamW step as in ``parity``; then bk-mixopt against
            opacus on the card (sigma 0; opacus runs Wkv6Fn under
            vmap(grad))
  parity_hymba
            one BK step of a 5-layer (global 0, 2, 4), full-width, f32
            hymba-1.5b model, B=4, T=1024 (bk-mixopt, sigma 1.0): the
            kernels on the card against ``use_kernels=False`` on the card
            and against the CPU (the chunked SSM and banded attention on
            both), norms at NORM_TOL, sums at f32 TOL; one noised AdamW
            step as in ``parity``; bk-mixopt against opacus on the card
            (sigma 0)
  parity_whisper
            one BK step of a 2 + 2-layer, full-width, f32 whisper-small
            model, B=2, Tf=1500, Td=448 (bk-mixopt, sigma 1.0: the
            encoder's taps and xattn/kv direct, cached at 2 layers; the
            decoder's and the head ghost), as parity_hymba: against
            ``use_kernels=False`` on the card and against the CPU, one
            noised AdamW step, bk-mixopt against opacus on the card
  parity_qwen3
            one BK step of a 2-layer, full-width, f32 qwen3-14b, B=2,
            T=128 (bk-mixopt, sigma 1.0; qk-norm's per-sample (B, h) scales
            on the psp route, remat), as parity_hymba: against
            ``use_kernels=False`` on the card and against the CPU, one
            noised AdamW step, bk-mixopt against opacus on the card (opacus
            runs the blocks without checkpoint); then its prefill, B=2,
            T=16, card against CPU, and 16 decode steps teacher-forced on
            the card against the CPU's, the last against the card's prefill
  parity_internvl2
            one BK step of a 2-layer, full-width, f32 internvl2-26b, B=2,
            64 tokens after 128 of its 1024 patches (the CPU's step at full
            width in the time; bk-mixopt, sigma 1.0: the projector's tap
            and its bias on the psp route, the head over the patch
            positions), as parity_hymba: against ``use_kernels=False`` on
            the card and against the CPU, one noised AdamW step, bk-mixopt
            against opacus on the card
  parity_cnn
            train_cnn's CNN in f32, B=4, sigma 0: bk, bk-mixopt,
            bk-mixghost and ghostclip on the card (the kernels: the convs'
            ghost norm at T = 112^2 under 'bk', their direct norm under
            bk-mixghost) against opacus on the card (vmap(grad) through
            the im2col unfold), against the same mode with
            ``use_kernels=False`` on the card and on the CPU: norms at
            NORM_TOL, grads at f32 TOL; then one noised AdamW step over
            bk-mixopt's sums (sigma 1.0) against its plain version
  parity_modes
            every mode of ``core.engine.make_grad_fn`` on the card (f32,
            one seed) against opacus: qwen2-1.5b at full width and 2 layers
            (B=8, T=512, registered policy) and the paper's Figure 2 MLP
            (128 -> 1024 x 6 -> 10, B=64); norms at NORM_TOL, grads at f32
            TOL, at sigma 0 and then 0.7 (the same noise in every mode:
            each draws the JAX package's counter-based noise under the
            common key ``prng_key(7)``, one counter_noise launch a leaf);
            each mode's seconds, launches and peak memory (opacus: all
            per-sample grads at once)
  parity_prefill, parity_prefill_rwkv
            a 2-layer, full-width, f32 model of each family: the prefill on
            the card (kernels) against the same params' prefill on the CPU
            (plain versions), and the teacher-forced decode's logits at the
            last prompt position against the card's prefill
  parity_prefill_hymba
            parity_hymba's 5-layer f32 model, B=2, T=1408 (T + meta = 1536:
            the chunked band, the window biting): the card's prefill
            against the CPU's, and the teacher-forced decode's logits at
            every position on the card against the CPU's (decode never
            prepends the meta tokens, as in the JAX package, so it is not
            held to the prefill)
  parity_prefill_whisper
            a 2 + 2-layer, full-width, f32 whisper-small, B=2, 1500 frames,
            448 tokens: the card's prefill, ``prefill_cross``'s caches and
            the decode teacher-forced over all 448 positions against the
            CPU's, and the last decode step against the card's prefill
  parity_prefill_internvl2
            parity_internvl2's model (2 layers, f32, 128 patches), B=2, 64
            tokens: the card's prefill with the patches against the CPU's,
            then 16 dense decode steps (no patches, as the reference's
            generate) teacher-forced on the card against the CPU's
  dryrun    the dry-run planner (``launch.steps.plan_cell`` on the meta
            device, ``CellPlan.plan``) held against the card on two cells
            the port runs: (a) the rank's work of qwen2-1.5b's train_4k
            (TRAIN_MICROBATCH 32 over 16 data ranks: B=2, T=4096; full
            width, all 28 layers where the plan's peak fits the card, else
            the deepest that does) and (b) hymba-1.5b's long_500k (B=1, S =
            524288, full-length caches on all 32 layers), three decode
            steps at positions S - 3 .. S - 1. Each cell's operands built
            for real (``CellPlan.make_args``) and the plan's ``fn`` run on
            them: planned argument_bytes equal to the bytes held exactly,
            the planned peak within DRYRUN_PEAK_TOL of the measured one
            (``max_memory_allocated`` past what was allocated before the
            operands), cell (a)'s launches and routes a step equal to the
            plan's; every workspace size the kernels asked the library for
            equal to ``kernels.meta``'s rule (fused_clip_grad's modelled
            plan printed beside the card's); loss and logits finite
  examples  the four examples' twins (``examples/*_torch.py``) on the card
            at smoke size: quickstart, DP-LoRA (BK against opacus on the
            adapters, zero base grads), the GPT2-class train driver
            (checkpoints under ``build/``) and greedy decode

Each phase ends with a ``phase_seconds`` line. Then a ``kernels`` summary
line and, last, the ``ok`` line. Any failed check
raises, and the script exits non-zero without the ``ok`` line. It needs a
CUDA card and the ``src/repro_torch`` package beside it. It imports nothing
of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TRAINS = ("train", "train_nonprivate", "train_ghostclip", "train_moe",
          "train_moe_direct", "train_long", "train_layer", "train_tape",
          "train_ftrl", "train_rwkv", "train_mesh", "train_hymba",
          "train_whisper", "train_qwen25", "train_qwen3", "train_llama3",
          "train_moonshot", "train_internvl2")
# the CNN's train path (not a registered arch: its own step loop)
CNN_TRAINS = ("train_cnn",)
PREFILLS = ("prefill", "prefill_rwkv", "prefill_hymba", "prefill_whisper",
            "prefill_internvl2")
SERVES = ("serve", "serve_rwkv", "serve_hymba", "serve_whisper")
PARITIES = ("parity", "parity_moe", "parity_long", "parity_layer",
            "parity_modes", "parity_rwkv", "parity_hymba", "parity_whisper",
            "parity_qwen3", "parity_internvl2", "parity_cnn")
SERVE_PARITIES = ("parity_prefill", "parity_prefill_rwkv",
                  "parity_prefill_hymba", "parity_prefill_whisper",
                  "parity_prefill_internvl2")
RESUMES = ("train_resume",)
MESHES = ("train_mesh2",)
PLANS = ("dryrun", "examples")
PHASES = (("card", "build", "kernels") + TRAINS + CNN_TRAINS + MESHES
          + RESUMES + PREFILLS + SERVES + PARITIES + SERVE_PARITIES + PLANS)
EXTRA_PHASES = ("wgmma", "noise")

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and operations/s by
# type; int32: 132 SMs x 64 integer results a clock on one pipe x the 1.98
# GHz boost clock (the integer work of counter_noise's threefry rounds)
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int32": 132 * 64 * 1.98e9}
# one threefry2x32 block's instructions in the built library's SASS
# (``threefry_sass``; set by the build phase)
THREEFRY = {}
# kernel-vs-plain tolerances (rtol, atol). Weighted grads: f32 as
# tests/test_kernel_parity.py:15, bf16 as its :18 (the plain clipped grads
# round C to bf16 like the JAX reference). Norms: both versions read the
# same inputs and sum in f32, so one tight tolerance serves either dtype.
TOL = {"float32": (1e-3, 1e-4), "bfloat16": (5e-2, 2e-2)}
NORM_TOL = (1e-4, 1e-6)
# clipped_grad's wgmma kernel against its SIMT kernel: TOL's f32 rtol, and
# its atol in units of the output's RMS (at least 1). Both kernels sum the
# same exact bf16 products in f32, in other orders; over B*T = 4096 terms
# the outputs' RMS is ~40 and two f32 orders differ by up to ~1e-3 where an
# entry cancels to near zero (cuBLAS's f32 einsum vs the SIMT kernel: 7.8e-4
# at the head tap, PR 14's run), which a bare atol of 1e-4 cannot hold.
SIMT_GRAD_TOL = (1e-3, 1e-4)
# a weighted grad of f32 records summed over more rows (B T) than this
# carries rounding past f32 TOL's bare atol on unit-variance records, in any
# order of summation: at parity_cnn's first conv (B T = 50176, d = 147, p =
# 64) the plain version (a cuBLAS f32 einsum) is 2.2e-3 and the SIMT kernel
# 3.6e-4 from a float64 evaluation (the case's line, NVIDIA H100 80GB HBM3
# at 700 W). Past it the kernels phase holds clipped_grad to the
# float64 evaluation: no farther from it than the plain version is, plus
# TOL's atol (both distances in the case's line). Every case before these
# sums 4096 rows or fewer, and keeps its gate.
F32_SUM_ROWS = 4096
# flash_attention: f32 as tests/test_kernels.py:78; bf16 as TOL (the output
# is rounded to bf16 by both versions). wkv6: ragged as
# tests/test_kernels.py:93; at T=4096 (bf16 inputs, f32 recurrence) 1e-3
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (5e-2, 2e-2)}
WKV_TOL = (2e-4, 2e-4)
WKV_LONG_TOL = (1e-3, 1e-3)
# wkv6_backward against autograd through the recurrence: the reference's
# own tolerance for the recurrence's grads (tests/test_rwkv_chunked.py:41)
WKV_BWD_TOL = (2e-3, 2e-3)
MOE_LAYERS = 6      # dense0_0 + 5 MoE blocks: the depth one 80 GB card holds
# rwkv6-3b at all its 32 layers, B=8, T=512: with remat 53.60 GB
# (scripts/depth_probe.py, NVIDIA H100 80GB HBM3 at 700 W); without it
# 28 layers peaked at 74.96 GB and 30 ran out of memory
RWKV_LAYERS = 32
# of qwen2-1.5b's 28 layers, what train_long and train_tape run at B=2,
# T=2048, and train_ftrl, train_mesh and train_resume's full case at B=8,
# T=512 (cut from 28 to 14, then to 7 for the internvl2 and CNN phases, to
# keep the whole script in its time; at 7 layers qkv and o still take the
# direct norm, uncached)
LONG_LAYERS = 7
# hymba-1.5b at all its 32 layers (global 0, 15 and 31), B=4, T=1024: with
# remat 27.58 GB (scripts/depth_probe.py, NVIDIA H100 80GB HBM3 at 700 W);
# without it 32 layers peaked at 79.10 GB, 35.34 of it the attention's
# saved f32 probabilities, which remat recomputes
HYMBA_LAYERS = 32
# the deepest cuts one 80 GB card holds at B=8, T=512 with remat
# (scripts/depth_probe.py, NVIDIA H100 80GB HBM3 at 700 W): qwen3-14b 11 of
# its 40 layers under AdamW (74.49 GB; 12 ran out of memory), llama3-405b 1
# of its 126 under SGD (69.62 GB; 2 ran out; AdamW's f32 moments for one
# layer, the embedding and the head alone are 59 GB), moonshot-v1-16b-a3b
# 8 of its 48 (dense0_0 + 7 MoE blocks; 72.70 GB; 9 ran out)
QWEN3_LAYERS = 11
LLAMA3_LAYERS = 1
MOONSHOT_LAYERS = 8
# internvl2-26b at B=8, T=512 text tokens + 1024 patches (1536 positions)
# under AdamW with remat: the deepest cut of its 48 layers one card holds
# (scripts/depth_probe.py internvl2-26b:N)
INTERNVL2_LAYERS = 8
# host seconds of idle margin at each end of device_ms's recorded calls:
# the profiler keeps only device events whose timestamps, converted to the
# host clock, fall inside its window, and on the card's machine that
# conversion jitters by tens of ms and drifts over a process's life
# (scripts/profiler_window.py: short unpadded sessions lost every kernel
# after ~90 s of a process). The train and prefill profiles, a whole step
# long, are left as they were.
PROFILE_PAD_S = 0.25
# cuda_ms stops timing a function once it has 3 runs and they pass this
# many ms (every time a median of at least 3 runs)
TIMING_BUDGET_MS = 300.0
# counter_noise: its normals against the plain version's (the bound the
# tests hold the plain ndtri to against JAX's; on the card they measured
# 0), the golden (JAX) normals, and the exhaustive ndtri against float64
# (scipy), relative: the measured 5.498e-7 rounded up (NVIDIA H100 80GB
# HBM3, 700.00 W)
NOISE_ULP = 8
GOLDEN_ULP = 16
NDTRI_F64_REL = 6e-7
NOISE_GOLDEN = ROOT / "src" / "repro_torch" / "core" / "noise_golden.json"
# threefry2x32 known answers: (key, counter) -> block (Random123, JAX)
THREEFRY_KATS = (((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
                 ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 2,
                  (0x1cb996fc, 0xbb002be7)),
                 ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
                  (0xc4923a9c, 0x483df7a0)))

KERNELS = ("ghost_norm", "clipped_grad", "emb_ghost_norm", "emb_clipped_grad",
           "grad_norm_direct", "moe_ghost_norm", "moe_direct_norm",
           "moe_clipped_grad", "fused_clip_grad", "flash_attention", "wkv6",
           "counter_noise", "noise_update", "wkv6_backward")
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {
    "ghost_norm": ("ghost_norm_wgmma.cu", "ghost_norm.py:62"),
    "clipped_grad": ("clipped_grad_wgmma.cu", "clipped_grad.py:39"),
    "emb_ghost_norm": ("emb_norm.cu", "emb_norm.py:50"),
    "emb_clipped_grad": ("emb_grad.cu", "emb_grad.py:50"),
    "grad_norm_direct": ("grad_norm_direct_wgmma.cu",
                         "grad_norm_direct.py:42"),
    "moe_ghost_norm": ("moe_ghost_norm_wgmma.cu", "moe_ghost.py:58"),
    "moe_direct_norm": ("moe_direct_norm_wgmma.cu", "moe_ghost.py:98"),
    "moe_clipped_grad": ("moe_clipped_grad_wgmma.cu", "moe_ghost.py:146"),
    "fused_clip_grad": ("fused_clip.cu", "fused_clip.py:56"),
    "flash_attention": ("flash_attention_wgmma.cu", "flash_attention.py:64"),
    "wkv6": ("wkv6_chunked.cu", "wkv6.py:76"),
    "counter_noise": ("counter_noise.cu", None),
    "noise_update": ("noise_update.cu", None),
    "wkv6_backward": ("wkv6_backward.cu", None),
}
# kernels with no TPU counterpart: the JAX code each replaces
NO_TPU_KERNEL = {"counter_noise": "src/repro/core/noise.py:103",
                 "noise_update": "src/repro/optim/optimizers.py:76",
                 "wkv6_backward": "src/repro/models/rwkv6.py:200-206"}
# the kernels that draw by the warp-compacted draw (counter_normal.cuh's
# warp_xi): their names in the SASS, each instantiation of which must vote
WARP_DRAW = {"counter_noise": "counter_noise_kernel",
             "noise_update": "noise_update_kernel"}
# the tensor-core kernels: their SIMT kernels (f32 and unaligned inputs),
# and their names in the SASS
WGMMA = {"ghost_norm": ("ghost_norm.cu", "ghost_norm_wgmma_kernel"),
         "clipped_grad": ("clipped_grad.cu", "clipped_grad_wgmma_kernel"),
         "flash_attention": ("flash_attention.cu", "flash_wgmma_kernel"),
         "moe_ghost_norm": ("moe_ghost_norm.cu", "moe_ghost_wgmma_kernel"),
         "moe_direct_norm": ("moe_direct_norm.cu", "moe_norm_wgmma_kernel"),
         "moe_clipped_grad": ("moe_clipped_grad.cu",
                              "moe_grad_wgmma_kernel"),
         "grad_norm_direct": ("grad_norm_direct.cu",
                              "dense_norm_wgmma_kernel"),
         # both routes in one source: the SIMT kernels beside the wgmma one
         "fused_clip_grad": ("fused_clip.cu", "fused_clip_wgmma_kernel")}
# the kernels of a chunked route (mma.sync on the tensor cores, f32 and bf16
# inputs alike): their scan kernel, and their kernels' names in the SASS
CHUNKED = {"wkv6": ("wkv6.cu", ("wkv6_state_kernel", "wkv6_out_kernel"))}
# no single PyTorch call computes these (say why in the summary)
NO_LIBRARY = {
    "emb_ghost_norm": "no single call builds the id-equality mask and "
                      "contracts it",
    "fused_clip_grad": "no single call clips per sample (composed_ms: the "
                       "norm + weighted-grad kernels it replaces)",
    "wkv6": "no single call runs the recurrence",
    "wkv6_backward": "no single call runs the recurrence's backward",
    "counter_noise": "no single call draws threefry normals (composed_ms: "
                     "the randn + multiply + add + divide chain it "
                     "replaces)",
}
# the norm kernel of each route of a tap (core.bk.plan_report's 'norm'
# plan); its 'grad' entry names the weighted-grad kernel, fused_clip_grad,
# or a route with no kernel ('cache', 'reweighted_backward')
NORM_KERNEL = {("mm", "ghost"): "ghost_norm",
               ("mm", "direct"): "grad_norm_direct",
               ("emb", "ghost"): "emb_ghost_norm",
               ("moe", "ghost"): "moe_ghost_norm",
               ("moe", "direct"): "moe_direct_norm"}


def _per_step(**counts):
    return {k: counts.get(k, 0) for k in KERNELS}


# each train path: config, shapes, steps, and each kernel's launches per
# step (mm taps: head + 4 per dense layer + 4 stacked; the router (2048->64)
# goes direct but bk-mixopt caches its small per-sample grad, no kernel)
RUNS = {
    # remat on (the registered config's), then the same steps with remat
    # off on the same seed (``remat_twin``): their params compared
    "train": dict(arch="qwen2-1.5b", layers=0, batch=8, seq=512, steps=3,
                  direct=False, remat_twin=True, per_step=_per_step(
                      ghost_norm=5, clipped_grad=5, emb_ghost_norm=1,
                      emb_clipped_grad=1)),
    # the paper's two yardsticks for train: standard training (no port
    # kernel), and GhostClip (the norm kernels of mode 'bk''s plan, then a
    # second backward per clip unit: no weighted-grad kernel)
    "train_nonprivate": dict(arch="qwen2-1.5b", layers=0, batch=8, seq=512,
                             steps=3, direct=False, mode="nonprivate",
                             per_step=_per_step()),
    "train_ghostclip": dict(arch="qwen2-1.5b", layers=0, batch=8, seq=512,
                            steps=3, direct=False, mode="ghostclip",
                            per_step=_per_step(ghost_norm=5,
                                               emb_ghost_norm=1)),
    "train_moe": dict(arch="deepseek-moe-16b", layers=MOE_LAYERS, batch=8,
                      seq=512, steps=3, direct=False, per_step=_per_step(
                          ghost_norm=9, clipped_grad=9, emb_ghost_norm=1,
                          emb_clipped_grad=1, moe_ghost_norm=2,
                          moe_clipped_grad=2)),
    "train_moe_direct": dict(arch="deepseek-moe-16b", layers=MOE_LAYERS,
                             batch=8, seq=512, steps=2, direct=True,
                             per_step=_per_step(
                                 ghost_norm=9, clipped_grad=9,
                                 emb_ghost_norm=1, emb_clipped_grad=1,
                                 moe_direct_norm=2, moe_clipped_grad=2)),
    "train_long": dict(arch="qwen2-1.5b", layers=LONG_LAYERS, batch=2,
                       seq=2048, steps=3, direct=False, per_step=_per_step(
                           grad_norm_direct=2, ghost_norm=3, clipped_grad=5,
                           emb_ghost_norm=1, emb_clipped_grad=1)),
    # every param path its own clip unit, each streamed by the composed
    # route: no full-width mm unit fits fused_plan's budget (the smoke-width
    # case of parity_layer drives fused_clip_grad)
    "train_layer": dict(arch="qwen2-1.5b", layers=0, batch=8, seq=512,
                        steps=3, direct=False, scope="layer",
                        per_step=_per_step(ghost_norm=5, clipped_grad=5,
                                           emb_ghost_norm=1,
                                           emb_clipped_grad=1)),
    # no cotangent held: norms only, then one reweighted backward per unit
    "train_tape": dict(arch="qwen2-1.5b", layers=LONG_LAYERS, batch=2,
                       seq=2048, steps=2, direct=False, tape="recompute",
                       per_step=_per_step(grad_norm_direct=2, ghost_norm=3,
                                          emb_ghost_norm=1)),
    # DP-FTRL: sigma from --epsilon 3 over 50000 samples by the tree
    # accountant; restarts every 2 steps with completion (steps 1 and 3
    # complete a tree, step 2 restarts it and the anchor); train's kernels,
    # and one FTRL noise_update a leaf
    "train_ftrl": dict(arch="qwen2-1.5b", layers=LONG_LAYERS, batch=8,
                       seq=512,
                       steps=4, direct=False, optimizer="ftrl",
                       ftrl_momentum=0.9, restart_every=2,
                       tree_completion=True, epsilon=3.0,
                       dataset_size=50000, per_step=_per_step(
                           ghost_norm=5, clipped_grad=5, emb_ghost_norm=1,
                           emb_clipped_grad=1)),
    # rwkv6-3b (no registered policy: a flat DPConfig): the recurrence
    # through Wkv6Fn, two wkv6 (chunked: the forward and remat's recompute,
    # core.bk.plan_report's 'remat') and one wkv6_backward a layer; mm
    # taps r, k, v, g, o, key, value, receptance and head ghost, tm_w1,
    # tm_w2_0..4, wa, wb direct (2T^2 > pd), each to clipped_grad. Its
    # first loss sits near ln(V) + 1/2: the head's 1/sqrt(d) init after a
    # layernorm gives logits of unit variance (qwen2's 0.1/sqrt(d) none)
    "train_rwkv": dict(arch="rwkv6-3b", layers=RWKV_LAYERS, batch=8, seq=512,
                       steps=3, direct=False, loss0_excess=0.5,
                       per_step=_per_step(
                           ghost_norm=9, grad_norm_direct=8, clipped_grad=17,
                           emb_ghost_norm=1, emb_clipped_grad=1,
                           wkv6=2 * RWKV_LAYERS,
                           wkv6_backward=RWKV_LAYERS)),
    # hymba-1.5b (no registered policy: a flat DPConfig), T + 128 meta
    # tokens = 1152: qkv, xz, up, down and the head ghost (2T^2 < pd),
    # bcdt (p = 57) and fuse_o direct; bk-mixopt caches bcdt and the three
    # unstacked fuse_o (no kernel), the two stacked fuse_o launch
    # grad_norm_direct; clipped_grad on every other mm tap. The head's
    # ghost_norm and clipped_grad take the SIMT routes (p = 32001 is no
    # multiple of 8: ``simt``), every other launch wgmma. Its first loss
    # sits near ln(V) + 1/2 (the head's 1/sqrt(d) init after an rmsnorm)
    "train_hymba": dict(arch="hymba-1.5b", layers=HYMBA_LAYERS, batch=4,
                        seq=1024, steps=3, direct=False, loss0_excess=0.5,
                        simt=dict(ghost_norm=1, clipped_grad=1),
                        peak_limit=76e9,
                        per_step=_per_step(
                            ghost_norm=21, grad_norm_direct=2,
                            clipped_grad=23, emb_ghost_norm=1,
                            emb_clipped_grad=1)),
    # whisper-small at full depth (12 encoder + 12 decoder layers; a flat
    # DPConfig: no registered policy), --seq as frames: Tf = 1500, Td =
    # decoder_len = 448. Every encoder tap and xattn/kv take the direct
    # norm (2 Tf^2 = 4.5 M > pd), stacked over 12 layers past the mixopt
    # cache's 2^24: grad_norm_direct 5; the frontend (B d p = 4.7 M) is
    # cached (no kernel); the decoder's six taps and the head ghost (7);
    # clipped_grad on every mm tap but the frontend (12). The head's
    # ghost_norm and clipped_grad take the SIMT routes (p = 51865), every
    # other launch wgmma. Its first loss sits near ln(V) + 1/2 (the head's
    # 1/sqrt(d) init after a layernorm)
    "train_whisper": dict(arch="whisper-small", layers=0, batch=8, seq=1500,
                          steps=3, direct=False, loss0_excess=0.5,
                          simt=dict(ghost_norm=1, clipped_grad=1),
                          per_step=_per_step(
                              ghost_norm=7, grad_norm_direct=5,
                              clipped_grad=12, emb_ghost_norm=1,
                              emb_clipped_grad=1)),
    # the decoder configs of B8.4 (a flat DPConfig: no registered policy),
    # 2 steps, the second profiled; every mm tap ghost (2T^2 < pd) and to
    # clipped_grad (5 and 5), the emb kernels; moonshot as train_moe: its
    # router direct and cached by bk-mixopt (no kernel), its expert taps
    # the MoE kernels. qwen2.5-3b at all 36 layers (AdamW); qwen3-14b (qk
    # norm, GQA 40/8) at QWEN3_LAYERS of 40 (AdamW); llama3-405b at full
    # width (d 16384, d_ff 53248, V 128256) and LLAMA3_LAYERS of 126 under
    # SGD (its embedding and head leaves 2,101,346,304 elements each);
    # moonshot-v1-16b-a3b at MOONSHOT_LAYERS of 48 (AdamW, renorm_topk)
    "train_qwen25": dict(arch="qwen2.5-3b", layers=0, batch=8, seq=512,
                         steps=2, direct=False, per_step=_per_step(
                             ghost_norm=5, clipped_grad=5, emb_ghost_norm=1,
                             emb_clipped_grad=1)),
    "train_qwen3": dict(arch="qwen3-14b", layers=QWEN3_LAYERS, batch=8,
                        seq=512, steps=2, direct=False, per_step=_per_step(
                            ghost_norm=5, clipped_grad=5, emb_ghost_norm=1,
                            emb_clipped_grad=1)),
    "train_llama3": dict(arch="llama3-405b", layers=LLAMA3_LAYERS, batch=8,
                         seq=512, steps=2, direct=False, optimizer="sgd",
                         per_step=_per_step(
                             ghost_norm=5, clipped_grad=5, emb_ghost_norm=1,
                             emb_clipped_grad=1)),
    "train_moonshot": dict(arch="moonshot-v1-16b-a3b", layers=MOONSHOT_LAYERS,
                           batch=8, seq=512, steps=2, direct=False,
                           per_step=_per_step(
                               ghost_norm=9, clipped_grad=9, emb_ghost_norm=1,
                               emb_clipped_grad=1, moe_ghost_norm=2,
                               moe_clipped_grad=2)),
    # internvl2-26b (the vlm family; a flat DPConfig: no registered policy)
    # at INTERNVL2_LAYERS of 48, B=8, 512 text tokens after 1024 patches:
    # the projector (T = 1024, 3200 -> 6144), qkv, o, up, down (T = 1536)
    # and the head (over all 1536 positions, as the reference's) ghost
    # (2T^2 < pd), each to clipped_grad; the emb kernels over the text. The
    # head's ghost_norm and clipped_grad take the SIMT routes (p = 92553 is
    # no multiple of 8: ``simt``), every other launch wgmma
    "train_internvl2": dict(arch="internvl2-26b", layers=INTERNVL2_LAYERS,
                            batch=8, seq=512, steps=3, direct=False,
                            simt=dict(ghost_norm=1, clipped_grad=1),
                            per_step=_per_step(
                                ghost_norm=6, clipped_grad=6,
                                emb_ghost_norm=1, emb_clipped_grad=1)),
    # train through the mesh path: --mesh 1,1, a world of one process under
    # NCCL (the sharded step's gathers, all-reduces and block noise all of
    # one rank); its params' sha256 must equal a no-mesh run's
    "train_mesh": dict(arch="qwen2-1.5b", layers=LONG_LAYERS, batch=8,
                       seq=512,
                       steps=3, direct=False, mesh=(1, 1),
                       per_step=_per_step(
                           ghost_norm=5, clipped_grad=5, emb_ghost_norm=1,
                           emb_clipped_grad=1)),
}
# two processes sharing the card under gloo (NCCL cannot put two ranks on
# one device): qwen2-1.5b at full width, 2 of its 28 layers, f32, sigma 1,
# 2 AdamW steps (cut from 4 layers and 3 steps to keep the whole
# script in its time) (``phase_train_mesh2``): (a) --mesh 2,1 (B=8, 4 a
# rank, a checkpoint every step), (b) --mesh 1,2, each against world 1
MESH2 = dict(arch="qwen2-1.5b", layers=2, batch=8, seq=512, steps=2,
             dtype="float32", cases={"a": (2, 1), "b": (1, 2)})
MESH2_TOL = dict(rtol=1e-3, atol=1e-5)     # tests/test_sharded_step.py:80
# fused_clip_grad's gate-edge cases (name, L, d, p; bf16, B=8, T=512): the
# largest units the reference's rule (kernels.dispatch.fused_plan) sends to
# it, square, stacked exactly at its budget, and the rank-16 adapter's A and
# B at qwen2-1.5b's width
FUSED_EDGES = (("edge_square", 1, 512, 512), ("edge_stacked", 4, 256, 256),
               ("edge_adapter_A", 1, 1536, 16),
               ("edge_adapter_B", 1, 16, 1536))
# units the gate fuses with more tiles than the card holds CTAs at once, so
# fused_clip_grad's CTAs walk them (name, L, T, d, p, dtype name; B=8): the
# rank-16 adapter's A stacked over qwen2-1.5b's 28 layers at T=2 (672 wgmma
# tiles; its f32 twin, 2688 SIMT tiles of 16), and 8192 layers of d = p = 8
# at T=1 (8192 tiles)
FUSED_WALKS = (("edge_adapter_stacked", 28, 2, 1536, 16, "bfloat16"),
               ("edge_adapter_stacked_f32", 28, 2, 1536, 16, "float32"),
               ("many_tiles", 8192, 1, 8, 8, "bfloat16"))
# the path whose shapes give each kernel's row in the summary line
ROW_PATH = {"ghost_norm": "train", "clipped_grad": "train",
            "emb_ghost_norm": "train", "emb_clipped_grad": "train",
            "grad_norm_direct": "train_long", "moe_ghost_norm": "train_moe",
            "moe_direct_norm": "train_moe_direct",
            "moe_clipped_grad": "train_moe", "fused_clip_grad": "parity_layer",
            "flash_attention": "prefill", "wkv6": "prefill_rwkv",
            "counter_noise": "train", "noise_update": "train",
            "wkv6_backward": "train_rwkv"}
# the cases whose plain, SIMT and library versions (and an embedding case's
# profiled device times) the kernels phase times beside the kernel: those at
# the kernel's ROW_PATH and on these paths (the unaligned bf16 heads and
# taps of T9: hymba's, whisper's and internvl2's head; whisper's shapes;
# internvl2's prefill attention); every other case times the kernel alone,
# its checks unchanged
TIMED_PATHS = ("train_hymba", "hymba_bcdt", "train_whisper",
               "prefill_hymba", "prefill_whisper", "internvl2_head",
               "prefill_internvl2")
# the train path whose profiled step gives a kernel's device time a step in
# the summary line (the path that launches it on train's leaves)
STEP_DEVICE = {"counter_noise": "train_ghostclip", "noise_update": "train"}
# the serving paths: arch, shapes, and the kernel each prefill launches once
# a layer
SERVING = {"prefill": dict(arch="qwen2-1.5b", batch=4, seq=4096,
                           kernel="flash_attention"),
           "prefill_rwkv": dict(arch="rwkv6-3b", batch=4, seq=4096,
                                kernel="wkv6"),
           "serve": dict(arch="qwen2-1.5b", batch=4, prompt=16, gen=16),
           "serve_rwkv": dict(arch="rwkv6-3b", batch=4, prompt=16, gen=16),
           "parity_prefill": dict(arch="qwen2-1.5b", batch=2, seq=100,
                                  kernel="flash_attention"),
           "parity_prefill_rwkv": dict(arch="rwkv6-3b", batch=2, seq=100,
                                       kernel="wkv6"),
           # the global layers take flash_attention (3 a prefill), the
           # sliding-window layers banded_attention (torch ops)
           "prefill_hymba": dict(arch="hymba-1.5b", batch=4, seq=3968,
                                 kernel="flash_attention", per_prefill=3),
           "serve_hymba": dict(arch="hymba-1.5b", batch=4, prompt=16,
                               gen=16),
           # decode: the prompt tokens teacher-forced through decode on
           # the card and on the CPU (the CPU's decode reads every weight a
           # token)
           "parity_prefill_hymba": dict(arch="hymba-1.5b", batch=2,
                                        seq=1408, layers=5, decode=64,
                                        kernel="flash_attention",
                                        per_prefill=3),
           # whisper: ``frames`` of audio and ``seq`` = decoder_len tokens;
           # a prefill runs flash_attention 3 times a layer (the encoder's
           # bidirectional 1500 x 1500, the decoder's causal 448 and the
           # cross-attention's bidirectional 448 x 1500), prefill_cross
           # once an encoder layer
           "prefill_whisper": dict(arch="whisper-small", batch=4, seq=448,
                                   frames=1500, kernel="flash_attention",
                                   per_prefill=36),
           "serve_whisper": dict(arch="whisper-small", batch=4, prompt=16,
                                 gen=16, frames=1500),
           # the card's prefill, cross caches and decode (teacher-forced
           # over every decoder position) against the CPU's, f32
           "parity_prefill_whisper": dict(arch="whisper-small", batch=2,
                                          seq=448, frames=1500, layers=2,
                                          kernel="flash_attention",
                                          per_prefill=6),
           # parity_qwen3's serving half: qwen3-14b, 2 layers, f32 (qk
           # norm, GQA 40/8, h 128): the card's prefill against the CPU's,
           # 16 decode steps teacher-forced on the card against the CPU's,
           # the last one against the card's prefill (T and the decode 64
           # until the internvl2 phases: the CPU's decode reads every weight
           # a step)
           "parity_qwen3": dict(arch="qwen3-14b", batch=2, seq=16,
                                layers=2, decode=16,
                                kernel="flash_attention"),
           # internvl2-26b at all 48 layers (bf16): B=2, 1024 patches and
           # 1024 prompt tokens, flash_attention at T = 2048 once a layer
           "prefill_internvl2": dict(arch="internvl2-26b", batch=2,
                                     seq=1024, kernel="flash_attention"),
           # 2 layers, f32, 128 of the 1024 patches and 64 tokens (the
           # CPU's prefill at full width in the time): the card's prefill
           # with patches against the CPU's, then 16 dense decode steps
           # (no patches, as the reference's generate) card against CPU
           "parity_prefill_internvl2": dict(arch="internvl2-26b", batch=2,
                                            seq=64, layers=2,
                                            patch_tokens=128, decode=16,
                                            kernel="flash_attention")}
# train paths that share one model, seed and batch (so one set of records)
PATH_GROUPS = (("train", "train_layer"), ("train_moe", "train_moe_direct"),
               ("train_long", "train_tape"))
# train_resume's cases: a train command line (``launch.train``'s flags),
# the checkpoint period and the step whose top kills the checkpointing run.
# full: qwen2-1.5b at full width and LONG_LAYERS of its 28 layers (cut
# from 28 to keep the whole script in its time), its registered policy,
# bk-mixopt, AdamW, sigma 1.0 (train's run, 4 steps); ftrl_smoke: DP-FTRL
# across a tree and anchor restart at the smoke width, f32 (the argv of
# tests/test_elastic_restart.py)
RESUME_CASES = {
    "full": dict(argv=["--arch", "qwen2-1.5b", "--layers", str(LONG_LAYERS),
                       "--steps", "4", "--batch", "8",
                       "--seq", "512", "--sigma", "1.0", "--optimizer",
                       "adamw", "--ckpt-every", "2", "--keep-checkpoints",
                       "1"], kill=3),
    "ftrl_smoke": dict(argv=["--arch", "qwen2-1.5b", "--smoke", "--steps",
                             "8", "--batch", "4", "--seq", "16", "--lr",
                             "1e-3", "--optimizer", "ftrl", "--restart-every",
                             "4", "--mode", "bk", "--policy", "", "--sigma",
                             "0.5", "--ckpt-every", "2"], kill=6),
}
# the most a step that saves may add to the device's peak memory: the save
# copies to pinned host buffers, never to a second device copy
SAVE_PEAK_GAP = 1 << 30
# the meshes whose rank blocks of train's leaves the noise kernels' block
# route draws in the kernels phase (``shard_block_checks``)
SHARD_MESHES = ((2, 2), (4, 2), (2, 2, 2))
# elements of a zeroed guard on each side of a block's buffer: the block
# route must write the block's elements and nothing around them
GUARD = 64
# blocks whose runs cross their rows' ends (the block route's other form):
# (label, leaf shape, dtype, spec, mesh, operands' offset in their buffers)
SHARD_RAGGED = (
    ("rows of 769", (28, 4, 1538), "float32", (None, "data", "model"),
     (2, 2), 0),
    ("rows of 3", (64, 6), "bfloat16", ("data", "model"), (2, 2), 0),
    ("4 dims, rows of 3", (7, 13, 10, 6), "float32",
     (None, "data", None, "model"), (2, 2), 0),
    ("(2,2,2) rows of 769, offset 1", (28, 4, 1538), "bfloat16",
     (None, "data", "model"), (2, 2, 2), 1))
# the rank whose blocks of train's leaves time the block route, against the
# contiguous route over the same leaves cut to the blocks' shapes
BLOCK_TIMING = ((2, 2), (0, 0))
# that timing, a row a noise kernel: {kernel: {leaves, elements, block_ms,
# contiguous_ms, bound_ms}}; set by the block checks
BLOCK_ROW = {}


def emit(**obj):
    print(json.dumps(obj), flush=True)


def wrappers():
    from repro_torch.kernels import clipped_grad as cg
    from repro_torch.kernels import counter_noise as cn
    from repro_torch.kernels import emb_grad as eg
    from repro_torch.kernels import emb_norm as en
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_clip as fc
    from repro_torch.kernels import ghost_norm as gn
    from repro_torch.kernels import grad_norm_direct as gd
    from repro_torch.kernels import moe_ghost as mg
    from repro_torch.kernels import noise_update as nu
    from repro_torch.kernels import wkv6 as wk
    return {"ghost_norm": gn.ghost_norm, "clipped_grad": cg.clipped_grad,
            "emb_ghost_norm": en.emb_ghost_norm,
            "emb_clipped_grad": eg.emb_clipped_grad,
            "grad_norm_direct": gd.grad_norm_direct,
            "moe_ghost_norm": mg.moe_ghost_norm,
            "moe_direct_norm": mg.moe_direct_norm,
            "moe_clipped_grad": mg.moe_clipped_grad,
            "fused_clip_grad": fc.fused_clip_grad,
            "flash_attention": fa.flash_attention, "wkv6": wk.wkv6,
            "counter_noise": cn.counter_noise,
            "noise_update": nu.noise_update,
            "wkv6_backward": wk.wkv6_backward}


def reset_counts(ws):
    """Every launch count to 0, the wgmma and chunked routes' counts too."""
    for w in ws.values():
        w.launches = 0
        for count in ("wgmma_launches", "chunked_launches",
                      "block_launches"):
            if hasattr(w, count):
                setattr(w, count, 0)


def check_routes(name, ws, want_wgmma: bool, simt=None):
    """-> {kernel: wgmma or chunked launches}; raises unless every launch of
    each wgmma kernel took the wgmma route (``want_wgmma``: bf16 paths,
    but for ``simt`` {kernel: launches}, the bf16 taps of unaligned width)
    or none did (f32 paths: the SIMT route), and every launch of a kernel
    with a chunked route took it (f32 and bf16 alike)."""
    got = {k: ws[k].wgmma_launches for k in WGMMA}
    got.update({k: ws[k].chunked_launches for k in CHUNKED})
    for k in (*WGMMA, *CHUNKED):
        want = ws[k].launches if want_wgmma or k in CHUNKED else 0
        if want_wgmma and k in (simt or {}):
            want -= simt[k]
        if got[k] != want:
            route = "chunked" if k in CHUNKED else "wgmma"
            raise AssertionError(f"{name}: {got[k]} of {ws[k].launches} "
                                 f"{k} launches took the {route} route, want "
                                 f"{want}")
    return got


def fresh_peak() -> int:
    """Collect what earlier phases left for the garbage collector, reset the
    peak-memory count -> the bytes still allocated (the count's floor)."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def train_config(name):
    """The TrainConfig a train path hands ``train``: its shapes, steps, the
    clipping-scope / tape flags and the optimizer with its DP-FTRL knobs
    (FTRL under the constant schedule, as the CLI forces it)."""
    from repro_torch.configs.base import TrainConfig
    run = RUNS[name]
    opt = run.get("optimizer", "adamw")
    return TrainConfig(global_batch=run["batch"], seq_len=run["seq"],
                       steps=run["steps"], lr=3e-4, optimizer=opt,
                       lr_schedule=("constant" if opt == "ftrl"
                                    else TrainConfig.lr_schedule),
                       ftrl_momentum=run.get("ftrl_momentum", 0.0),
                       restart_every=run.get("restart_every", 0),
                       tree_completion=run.get("tree_completion", False),
                       clipping_scope=run.get("scope", ""),
                       tape=run.get("tape", ""))


def run_config(name, flags=True):
    """-> (ModelConfig, PrivacyPolicy) of a train path: the policy ``train``
    runs, or with ``flags=False`` the one it is handed (before its
    TrainConfig's scope and tape flags)."""
    from repro_torch.configs.registry import cut_depth, get_config
    from repro_torch.launch.train import resolve_dp, train_policy
    run = RUNS[name]
    cfg = cut_depth(get_config(run["arch"]), run["layers"])
    # sigma 1.0, or 0 where the path calibrates it from its epsilon
    dp = resolve_dp(cfg.name, "auto", run.get("mode", "bk-mixopt"),
                    "automatic", 0.0 if run.get("epsilon") else 1.0,
                    log=lambda m: None)
    if run["direct"]:
        dp = dataclasses.replace(dp, groups=tuple(
            dataclasses.replace(g, method="direct") if g.name == "experts"
            else g for g in dp.groups))
    return cfg, train_policy(dp, train_config(name)) if flags else dp


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs (at least 3), by
    CUDA events; once 3 runs pass TIMING_BUDGET_MS (a plain version on a
    whole train path's tensors) the runs end early."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    while len(times) < max(reps, 3) and (len(times) < 3 or
                                         sum(times) < TIMING_BUDGET_MS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def device_ms(fn, reps: int = 5, launched: dict | None = None,
              calls: dict | None = None, pad: float = PROFILE_PAD_S) -> dict:
    """Device milliseconds of ``fn`` a call, by kernel name (every kernel
    it launches, by torch.profiler), summed over ``reps`` calls and divided
    by them; ``launched``, if given, receives the device events a call by
    name. ``calls``, if given, receives a call's device events
    (``device``), its launch calls on the host (``host``: the CUDA
    runtime's or driver's ``*Launch*`` records) and its launches
    (``launches``: the correlation ids of either, so that a launch counts
    once, and still counts where the profiler dropped one of its two
    records). The profiler's schedule runs two calls as its warm-up before
    the ``reps`` it records (its first kernels after start-up can be lost);
    the recorded calls sit ``pad`` seconds from either end of their
    window."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=2, active=1,
                                             repeat=1)) as prof:
        for i, n in enumerate((1, 1, reps)):
            if i == 2:
                time.sleep(pad)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
            prof.step()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:60]
            by_name[name] = (by_name.get(name, 0.0)
                             + e.time_range.elapsed_us() / reps / 1e3)
            if launched is not None:
                launched[name] = launched.get(name, 0.0) + 1.0 / reps
    if calls is not None:
        kept = prof.profiler.kineto_results.events()
        host = {e.correlation_id() for e in kept
                if e.device_type() == DeviceType.CPU and "Launch" in e.name()}
        dev = {e.correlation_id() for e in kept
               if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation()}
        calls.update(host=len(host) / reps, device=len(dev) / reps,
                     launches=len(host | dev) / reps)
    return by_name


def compare(got, want, tol) -> dict:
    """Max abs / rel error of got vs want, and the allclose verdict at
    ``tol`` = (rtol, atol)."""
    import torch
    rtol, atol = tol
    g, w = got.reshape(-1), want.reshape(-1)
    max_abs, max_rel, ok, n = 0.0, 0.0, True, 1 << 26
    for i in range(0, g.numel(), n):     # in slices: outputs reach 7 GB
        gi, wi = g[i:i + n].double(), w[i:i + n].double()
        if not torch.isfinite(gi).all():
            raise AssertionError("kernel output is not finite")
        diff = (gi - wi).abs()
        max_abs = max(max_abs, float(diff.max()))
        max_rel = max(max_rel,
                      float((diff / wi.abs().clamp_min(1e-30)).max()))
        ok = ok and bool((diff <= atol + rtol * wi.abs()).all())
    return {"max_abs_err": max_abs, "max_rel_err": max_rel,
            "rtol": rtol, "atol": atol, "ok": ok}


def bound(nbytes: float, ops: float, dtype_name: str):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------------- phases
def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(line, flush=True)
    emit(phase="card", nvidia_smi=line, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return line


def sass_counts(funcs: dict) -> dict:
    """Tensor-core instructions in each tensor-core kernel's SASS
    (``funcs``: ``sass_functions`` of the library): HGMMA and UTMALDG of
    each wgmma kernel, HMMA (mma.sync) of each kernel of a chunked
    route."""
    names = {fn: (k, ("HGMMA", "UTMALDG")) for k, (_, fn) in WGMMA.items()}
    names.update({fn: (f"{k}:{fn}", ("HMMA",)) for k, (_, fns) in
                  CHUNKED.items() for fn in fns})
    counts = {key: dict.fromkeys(ops, 0) for key, ops in names.values()}
    for name, body in funcs.items():
        current = next((names[fn] for fn in names if fn in name), None)
        for op in current[1] if current else ():
            counts[current[0]][op] += sum(f" {op}." in ln or f" {op} " in ln
                                          for ln in body)
    return counts


def warp_sass(funcs: dict) -> dict:
    """The warp-level instructions of each instantiation of the kernels
    that draw by the warp-compacted draw (WARP_DRAW; ``funcs``:
    ``sass_functions`` of the library): VOTE (the tail queue's ballots),
    POPC (their prefix offsets), SHFL and WARPSYNC, by kernel and
    instantiation."""
    from repro_torch.kernels.sass import SASS_OP
    ops = ("VOTE", "POPC", "SHFL", "WARPSYNC")
    counts = {}
    for fn, body in funcs.items():
        kernel = next((k for k, sym in WARP_DRAW.items() if sym in fn), None)
        if kernel is None:
            continue
        row = counts.setdefault(kernel, {})[fn] = dict.fromkeys(ops, 0)
        for ln in body:
            m = SASS_OP.match(ln)
            if m and m.group(1).split(".")[0] in ops:
                row[m.group(1).split(".")[0]] += 1
    return counts


def ptxas_lines(report: str, source: str) -> list:
    """The ptxas lines of one source: registers, shared memory, spills, and
    any wgmma warning."""
    lines, inside = [], False
    for ln in report.splitlines():
        if ln.startswith("=="):
            inside = ln == f"== {source}"
        elif inside and any(w in ln for w in ("registers", "spill",
                                              "wgmma", "Warning")):
            lines.append(ln.strip())
    return lines


def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels.sass import (sass_functions, sass_text,
                                          threefry_sass)
    info = build.build()
    regs = [ln.strip() for ln in info["ptxas"].splitlines()
            if "registers" in ln or "spill" in ln or ln.startswith("==")]
    emit(phase="build", seconds=info["seconds"], cached=info["cached"],
         library=str(Path(info["path"]).relative_to(ROOT)), ptxas=regs)
    funcs = sass_functions(sass_text(info["path"]))
    sass = sass_counts(funcs)
    THREEFRY.update(threefry_sass(funcs))
    emit(phase="build", threefry_sass=THREEFRY)
    warp = warp_sass(funcs)
    emit(phase="build", warp_draw_sass=warp,
         ptxas={k: ptxas_lines(info["ptxas"], SOURCES[k][0])
                for k in WARP_DRAW})
    silent = [f"{k} {fn}" for k in WARP_DRAW
              for fn, c in warp.get(k, {"(none)": {"VOTE": 0}}).items()
              if not c["VOTE"]]
    if silent:
        raise AssertionError(f"no warp vote (the compacted tail's ballots) "
                             f"in the SASS of: {silent}")
    tc = (*WGMMA, *CHUNKED)
    emit(phase="build", tensor_core_kernels={
        k: {"source": SOURCES[k][0],
            "ptxas": ptxas_lines(info["ptxas"], SOURCES[k][0]),
            **(sass[k] if k in WGMMA else
               {fn: sass[f"{k}:{fn}"] for fn in CHUNKED[k][1]})}
        for k in tc})
    empty = [f"{k} {op}" for k, c in sass.items() for op, n in c.items()
             if not n]
    if empty:
        raise AssertionError(f"no tensor-core / TMA instructions in the SASS "
                             f"of: {empty}")
    spills = sorted({k for k in tc
                     for ln in ptxas_lines(info["ptxas"], SOURCES[k][0])
                     if any(int(n) for n in re.findall(r"(\d+) bytes spill",
                                                       ln))})
    if spills:
        raise AssertionError(f"tensor-core kernels that spill: {spills}")
    build.load()


def path_taps(paths, dev, smoke=False):
    """The taps of a group of train paths that share one model, seed and
    batch, each routed as the engine routes it (``core.bk.plan_report``)
    under each path's policy -> (cfg, step-0 batch, [(key, kind, record
    shape, cotangent shape, {kernel: first path that launches it})], the
    step-0 MoE records of the path's own model: its router's masks).
    ``smoke``: the arch's smoke_config width in f32 instead (the model of
    a parity phase's smoke-width case)."""
    import torch
    from repro_torch.configs.registry import build, smoke_config
    from repro_torch.core.bk import plan_report, tap_act_structs
    from repro_torch.core.tape import Tape, parse_key
    from repro_torch.data.synthetic import make_batch

    cfg, _ = run_config(paths[0])
    if smoke:
        cfg = smoke_config(cfg.name).with_(param_dtype="float32")
    run = RUNS[paths[0]]
    model = build(cfg)
    params = model.init(0, dev)        # train()'s seed and step-0 batch
    batch = make_batch(cfg, run["batch"], run["seq"], 0, 0, dev)
    outs, acts = tap_act_structs(model.apply, params, batch)
    reports = [(path, plan_report(model.apply, params, batch,
                                  run_config(path)[1])) for path in paths]
    taps = []
    for key in sorted(acts):
        kind = parse_key(key)[1]
        a_shape = (acts[key]["a"] if kind == "moe" else acts[key])[0]
        ds_shape = outs[key][0]
        kernels = {}
        for path, report in reports:
            grad = report[key]["grad"]
            if grad not in ("fused_clip_grad", "cache"):
                kernels.setdefault(
                    NORM_KERNEL[kind, report[key]["norm"].method], path)
            if grad in KERNELS:
                kernels.setdefault(grad, path)
        taps.append((key, kind, a_shape, ds_shape, kernels))
    records = {}
    if any(kind == "moe" for _, kind, *_ in taps):
        tape = Tape()
        with torch.no_grad():
            model.apply(params, batch, tape)
        records = {k: v for k, v in tape.acts.items()
                   if parse_key(k)[1] == "moe"}
        del tape
    del params
    torch.cuda.empty_cache()
    return cfg, batch, taps, records


def _runs(ids):
    """Runs (distinct ids) per (l, b) row, summed: the squared norms of run
    sums that the embedding norm needs for these ids."""
    return sum(int(row.unique().numel())
               for row in ids.reshape(-1, ids.shape[-1]))


def phase_kernels(only_wgmma=False, only_noise=False):
    """Each kernel vs its plain version on the card at the shapes each train
    path gives it, as the engine routes its taps -> per-kernel summary (from
    each kernel's ROW_PATH). ``only_wgmma``: the tensor-core kernels' checks
    alone, at one tile, the ragged bf16 shapes and one row shape each;
    ``only_noise``: counter_noise's checks alone."""
    import ctypes

    import torch
    from repro_torch.core import ghost
    from repro_torch.core.tape import parse_key
    from repro_torch.kernels import build
    from repro_torch.kernels import clipped_grad as cg
    from repro_torch.kernels import emb_grad as eg
    from repro_torch.configs.registry import get_config
    from repro_torch.core.clipping import get_clip_fn
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import emb_norm as en
    from repro_torch.kernels import fused_clip as fc
    from repro_torch.kernels import ghost_norm as gn
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grad_norm_direct as gd
    from repro_torch.kernels import moe_ghost as mg
    from repro_torch.kernels import wkv6 as wk

    dev = torch.device("cuda")
    # the f32 plain versions' products in full f32 (PyTorch's default)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    summary = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
                       max_abs_err=0.0, t_bytes=0.0, t_ops=0.0)
               for k in KERNELS}
    summary["fused_clip_grad"].update(composed_ms=0.0, device_ms=0.0)
    summary["counter_noise"].update(composed_ms=0.0)
    for k in (*WGMMA, *CHUNKED):
        summary[k]["simt_ms"] = 0.0

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def clip_factors(B, dtype):
        # clip factors the record dtype holds exactly: the plain version
        # rounds C to it (as the JAX reference does), the kernel keeps f32
        return (torch.rand(B, generator=gen, device=dev) + 0.1).to(
            dtype).float()

    def record(name, path, case, got, want, tol, ms_k, ms_p, nbytes, ops,
               dname, ms_lib=None, again=None, timed=True, exact=None,
               **extra):
        """``exact``: a float64 evaluation, the gate in place of the plain
        version where f32 TOL's bare atol holds for no f32 sum (see
        F32_SUM_ROWS): the kernel no farther from it than the plain version
        is, plus TOL's atol."""
        cmp = compare(got, want, tol)
        b_ms, b_by = bound(nbytes, ops, dname)
        ok = cmp["ok"]
        if exact is not None:
            k_err = float((got.double() - exact).abs().max())
            p_err = float((want.double() - exact).abs().max())
            ok = k_err <= p_err + tol[1]
            extra.update(gate="float64", gate_ok=ok, vs_f64_max_abs_err=k_err,
                         plain_vs_f64_max_abs_err=p_err)
        if again is not None:       # a norm run twice: bitwise equal?
            extra["bitwise_repeat"] = bool(torch.equal(got, again))
        emit(phase="kernels", kernel=name, path=path, case=case, **cmp,
             **extra, kernel_ms=ms_k, plain_ms=ms_p, library_ms=ms_lib,
             bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops)
        if not ok:
            raise AssertionError(f"{name} [{case}] disagrees with its plain "
                                 f"version: {cmp}" + (
                                     "" if exact is None else
                                     f", float64: {extra}"))
        if again is not None and not extra["bitwise_repeat"]:
            raise AssertionError(f"{name} [{case}] differs run to run")
        if path == ROW_PATH[name] and timed:
            s = summary[name]
            s["ms"] += ms_k
            s["plain_ms"] += ms_p
            s["bound_ms"] += b_ms
            s["t_bytes" if b_by == "bytes" else "t_ops"] += b_ms
            s["max_abs_err"] = max(s["max_abs_err"], cmp["max_abs_err"])
            if ms_lib is not None:
                s["library_ms"] = (s["library_ms"] or 0.0) + ms_lib
            for key in ("composed_ms", "simt_ms", "device_ms"):
                if key in extra and key in s:
                    s[key] += extra[key]

    def reps(path, name):
        return (10, 2) if path == ROW_PATH[name] else (3, 1)

    def timed(name, path) -> bool:
        """Whether a case times the versions beside its kernel."""
        return path == ROW_PATH[name] or path in TIMED_PATHS

    def opt_ms(name, path, fn, r, w):
        """A plain, SIMT or library version's time where ``timed``, else
        None."""
        return cuda_ms(fn, r, w) if timed(name, path) else None

    def einsum_forms(eq, *ops):
        """One torch.einsum call, by each contraction order torch offers:
        left to right, and opt_einsum's path where that package is there."""
        def form(opt):
            def run():
                prev = torch.backends.opt_einsum.enabled
                torch.backends.opt_einsum.enabled = opt
                try:
                    return torch.einsum(eq, *ops)
                finally:
                    torch.backends.opt_einsum.enabled = prev
            return run
        forms = {"left_to_right": form(False)}
        if torch.backends.opt_einsum.is_available():
            forms["opt_einsum"] = form(True)
        return forms

    def norm_case(name, path, case, fn, plain, args, nbytes, ops, dname,
                  library=None, **extra):
        got, again = fn(*args), fn(*args)
        want = plain(*args)
        r, w = reps(path, name)
        ms_k = cuda_ms(lambda: fn(*args), r, w)
        ms_p = opt_ms(name, path, lambda: plain(*args), 3, 1)
        ms_lib = None
        if library and timed(name, path):
            forms = {f: cuda_ms(run, r, w) for f, run in library.items()}
            ms_lib = min(forms.values())
            extra["library_forms_ms"] = forms
        record(name, path, case, got, want, NORM_TOL, ms_k, ms_p, nbytes,
               ops, dname, ms_lib, again, **extra)

    def grad_case(name, path, case, fn, plain, args, nbytes, ops, dname,
                  library=None, exact=None, **extra):
        got = fn(*args)
        want = plain(*args)
        if exact is not None:
            extra["exact"] = exact()
        r, w = reps(path, name)
        ms_k = cuda_ms(lambda: fn(*args), min(r, 5), 1)
        ms_p = opt_ms(name, path, lambda: plain(*args), 3, 1)
        ms_lib = opt_ms(name, path, library, r, w) if library else None
        record(name, path, case, got, want, TOL[dname], ms_k, ms_p, nbytes,
               ops, dname, ms_lib, **extra)
        del got, want

    def simt_check(name, case, got, simt, tol, route="wgmma"):
        """(b): the ``route`` kernel against its SIMT (or scan) kernel on the
        same inputs at ``tol`` (SIMT_GRAD_TOL: its atol times the SIMT
        output's RMS) -> the comparison's fields for the kernels line."""
        if tol is SIMT_GRAD_TOL:
            rms = float(torch.linalg.vector_norm(simt)) / simt.numel() ** 0.5
            tol = (tol[0], tol[1] * max(1.0, rms))
        cmp = compare(got, simt, tol)
        if not cmp["ok"]:
            raise AssertionError(f"{name} [{case}]: the {route} kernel "
                                 f"disagrees with the SIMT / scan kernel: "
                                 f"{cmp}")
        return {"vs_simt_max_abs_err": cmp["max_abs_err"],
                "vs_simt_max_rel_err": cmp["max_rel_err"],
                "vs_simt_rtol": tol[0], "vs_simt_atol": tol[1]}

    def wgmma_case(name, path, case, fn, plain, args, tol, simt_tol, nbytes,
                   ops, library, **extra):
        """A kernel on its wgmma route: (a) against the plain version at
        ``tol``, (b) against its SIMT kernel (``fn(..., kernel="simt")``) at
        ``simt_tol``, (c) itself run twice, bitwise; kernel, SIMT, plain and
        library times (``library``: one call, or {form: call})."""
        got, again = fn(*args), fn(*args)
        simt = fn(*args, kernel="simt")
        extra.update(simt_check(name, case, got, simt, simt_tol))
        del simt
        want = plain(*args)
        r = min(reps(path, name)[0], 5)
        ms_k = cuda_ms(lambda: fn(*args), r, 1)
        extra["simt_ms"] = opt_ms(name, path,
                                  lambda: fn(*args, kernel="simt"),
                                  min(r, 3), 1)
        ms_p = opt_ms(name, path, lambda: plain(*args), 3, 1)
        ms_lib = None
        if not timed(name, path):
            pass
        elif isinstance(library, dict):
            forms = {f: cuda_ms(run, r, 1) for f, run in library.items()}
            ms_lib = min(forms.values())
            extra["library_forms_ms"] = forms
        elif library:
            ms_lib = cuda_ms(library, r, 1)
        record(name, path, case, got, want, tol, ms_k, ms_p, nbytes, ops,
               "bfloat16", ms_lib, again, route="wgmma", **extra)
        del got, again, want
        torch.cuda.empty_cache()

    def ghost_vs_f64(a, ds):
        """The ghost norm in float64, one (l, b) at a time, as the arbiter
        of the f32 versions' sums -> each version's max relative error;
        raises unless the wgmma kernel's is within NORM_TOL's rtol."""
        exact = torch.zeros(a.shape[1], dtype=torch.float64, device=dev)
        for l in range(a.shape[0]):
            for b in range(a.shape[1]):
                x, g = a[l, b].double(), ds[l, b].double()
                exact[b] += ((x @ x.T) * (g @ g.T)).sum()
        err = {k: float(((fn().double() - exact).abs() / exact.abs()).max())
               for k, fn in (("wgmma", lambda: gn.ghost_norm(a, ds)),
                             ("simt", lambda: gn.ghost_norm(a, ds,
                                                            kernel="simt")),
                             ("plain", lambda: gn.plain(a, ds)))}
        if err["wgmma"] > NORM_TOL[0]:
            raise AssertionError(f"ghost_norm: the wgmma kernel is "
                                 f"{err['wgmma']} from float64")
        return err

    def direct_vs_f64(a, ds):
        """The direct norm in float64, one (l, b) at a time, as the arbiter
        of the f32 versions' sums -> each version's max relative error;
        raises unless the wgmma kernel's is within NORM_TOL's rtol."""
        exact = torch.zeros(a.shape[1], dtype=torch.float64, device=dev)
        for l in range(a.shape[0]):
            for b in range(a.shape[1]):
                g = a[l, b].double().T @ ds[l, b].double()
                exact[b] += (g * g).sum()
        err = {k: float(((fn().double() - exact).abs() / exact.abs()).max())
               for k, fn in (("wgmma", lambda: gd.grad_norm_direct(a, ds)),
                             ("simt", lambda: gd.grad_norm_direct(
                                 a, ds, kernel="simt")),
                             ("plain", lambda: gd.plain(a, ds)))}
        if err["wgmma"] > NORM_TOL[0]:
            raise AssertionError(f"grad_norm_direct: the wgmma kernel is "
                                 f"{err['wgmma']} from float64")
        return err

    def moe_ghost_vs_f64(a, mask, ds):
        """The MoE ghost norm in float64, a layer at a time, as the arbiter
        of the f32 versions' sums -> each version's max relative error;
        raises unless the wgmma kernel's is within NORM_TOL's rtol."""
        exact = torch.zeros(a.shape[1], dtype=torch.float64, device=dev)
        for l in range(a.shape[0]):
            m = mask[l].double()[..., None]
            x, g = a[l].double() * m, ds[l].double() * m
            exact += torch.einsum("becx,becx->b", x @ x.transpose(-1, -2),
                                  g @ g.transpose(-1, -2))
            del x, g
        err = {k: float(((fn().double() - exact).abs()
                         / exact.abs().clamp_min(1e-30)).max())
               for k, fn in (("wgmma", lambda: mg.moe_ghost_norm(a, mask, ds)),
                             ("simt", lambda: mg.moe_ghost_norm(
                                 a, mask, ds, kernel="simt")),
                             ("plain", lambda: ghost.sq_norm_moe_ghost(
                                 a, mask, ds)))}
        if err["wgmma"] > NORM_TOL[0]:
            raise AssertionError(f"moe_ghost_norm: the wgmma kernel is "
                                 f"{err['wgmma']} from float64")
        return err

    def wgmma_grad_case(path, case, a, C, ds, nbytes, ops, library):
        """clipped_grad on its wgmma route: (b) at SIMT_GRAD_TOL (both sum
        exact bf16 products in f32, in other orders)."""
        if cg.route(a.dtype, a.shape[-1], ds.shape[-1]) != "wgmma":
            raise AssertionError(f"clipped_grad [{case}]: not on the wgmma "
                                 "route")
        wgmma_case("clipped_grad", path, case, cg.clipped_grad, cg.plain,
                   (a, C, ds), TOL["bfloat16"], SIMT_GRAD_TOL, nbytes, ops,
                   library)

    def fused_case(path, case, a, ds, dname, clips):
        """fused_clip_grad under each clip function of ``clips``, w with a
        zero (a masked sample), on the route ``fc.route`` names (asserted):
        (a) against its plain version, G at TOL and sq at NORM_TOL; (b) on
        the wgmma route, against its SIMT route, G at SIMT_GRAD_TOL and sq
        at NORM_TOL; (c) itself run twice, bitwise. The first clip function
        timed: CUDA events around the wrapper's call (host work included),
        the device time and the kernels one call launches by torch.profiler
        (one, or the case fails), the SIMT route's time, the plain
        version's, and the composed route it replaces (the norm kernel,
        then clipped_grad)."""
        L, Bc, Tc, d = a.shape
        p = ds.shape[-1]
        route = fc.route(a.dtype, d, p)
        w = torch.rand(Bc, generator=gen, device=dev) + 0.5
        w[1] = 0.0
        gamma = 0.01
        sq0 = fc.plain(a, ds, w, "automatic", 1.0, gamma)[1]   # the norms
        # flat: R midway in the widest gap between the norms, at least 1e-5
        # (relative) from each, so that the 1e-6 the two versions' sums may
        # differ by cannot flip the indicator
        n = torch.sort(torch.sqrt(sq0.double())).values
        i = int(torch.argmax(n[1:] - n[:-1]))
        R_flat = float((n[i] + n[i + 1]) / 2)
        if float(n[i + 1] - n[i]) / 2 < 1e-5 * R_flat:
            raise AssertionError(f"fused_clip_grad [{case}]: norms too "
                                 f"close for the flat indicator: {n}")
        # the others: R at the median norm, so C is near 1 (G keeps the
        # size of the per-sample grads, and the tolerances bite) and abadi
        # clips some samples and keeps others
        R_mid = float(n[len(n) // 2])
        nbytes = (a.numel() + ds.numel()) * a.element_size() + Bc * 4 * 2 \
            + L * d * p * 4
        ops = 2.0 * L * Bc * Tc * d * p
        for k, clip in enumerate(clips):
            R = R_flat if clip == "flat" else R_mid
            args = (a, ds, w, clip, R, gamma)
            w0 = fc.fused_clip_grad.wgmma_launches
            G, sq = fc.fused_clip_grad(*args)
            took = ("wgmma" if fc.fused_clip_grad.wgmma_launches > w0
                    else "simt")
            if took != route:
                raise AssertionError(f"fused_clip_grad [{case}]: took the "
                                     f"{took} route, want {route}")
            G2, sq2 = fc.fused_clip_grad(*args)
            bitwise = bool(torch.equal(G, G2) and torch.equal(sq, sq2))
            del G2, sq2
            Gp, sqp = fc.plain(*args)
            cmp_sq = compare(sq, sqp, NORM_TOL)
            extra = {"clip": clip, "R": R, "route": took, "sq_max_abs_err":
                     cmp_sq["max_abs_err"], "sq_max_rel_err":
                     cmp_sq["max_rel_err"], "bitwise_repeat": bitwise}
            if not cmp_sq["ok"]:
                raise AssertionError(f"fused_clip_grad [{case}, {clip}]: sq "
                                     f"disagrees with the plain version: "
                                     f"{cmp_sq}")
            if not bitwise:
                raise AssertionError(f"fused_clip_grad [{case}, {clip}] "
                                     "differs run to run")
            if route == "wgmma":
                Gs, sqs = fc.fused_clip_grad(*args, kernel="simt")
                extra.update(simt_check("fused_clip_grad", f"{case} {clip}",
                                        G, Gs, SIMT_GRAD_TOL))
                cmp_s = compare(sq, sqs, NORM_TOL)
                extra["sq_vs_simt_max_rel_err"] = cmp_s["max_rel_err"]
                if not cmp_s["ok"]:
                    raise AssertionError(f"fused_clip_grad [{case}, {clip}]: "
                                         f"sq disagrees with the SIMT route: "
                                         f"{cmp_s}")
                del Gs, sqs
            ms_k = ms_p = 0.0
            if k == 0:
                # a call is microseconds, mostly host work: 10 calls on
                # every path, not reps()'s 3 off the row path
                r = 10
                ms_k = cuda_ms(lambda: fc.fused_clip_grad(*args), r, 2)
                ms_p = cuda_ms(lambda: fc.plain(*args), 3, 1)
                # launches a call: a launch is counted by its host record
                # and its device record together (the profiler drops some
                # of either: scripts/profiler_window.py). A profile that
                # lost both records of a launch is taken again, at most
                # twice, each time with four times the idle margin; more
                # than one launch a call, or a kernel of another name,
                # fails
                for attempt in range(3):
                    launched, calls = {}, {}
                    dev_k = device_ms(lambda: fc.fused_clip_grad(*args),
                                      launched=launched, calls=calls,
                                      pad=PROFILE_PAD_S * 4 ** attempt)
                    if calls["launches"] > 1.0 - 1e-6:
                        break
                extra.update(device_ms=sum(dev_k.values()),
                             device_by_kernel=dev_k,
                             kernels_a_call=calls["launches"],
                             device_events_a_call=calls["device"],
                             host_launches_a_call=calls["host"],
                             profiles=attempt + 1)
                if abs(calls["launches"] - 1.0) > 1e-6 or len(launched) != 1:
                    raise AssertionError(f"fused_clip_grad [{case}]: one call "
                                         f"launched {calls['launches']} "
                                         f"kernels ({calls}; device events "
                                         f"by name {launched}), want one "
                                         "kernel")
                extra["simt_ms"] = ms_k if route == "simt" else cuda_ms(
                    lambda: fc.fused_clip_grad(*args, kernel="simt"), r, 2)
                clip_fn = get_clip_fn(clip, R, **(
                    {"gamma": gamma} if clip == "automatic" else {}))
                norm = {"ghost": gn.ghost_norm, "direct": gd.grad_norm_direct
                        }[dispatch.norm_plan("mm", a.shape, ds.shape,
                                             "bk-mixopt").method]

                def composed():
                    C = clip_fn(torch.sqrt(norm(a, ds))) * w
                    return cg.clipped_grad(a, C, ds)

                extra["composed_ms"] = cuda_ms(composed, r, 2)
                plan = (ctypes.c_int * 8)()
                build.check(build.load().dp_fused_clip_plan(
                    L, Bc, Tc, d, p, int(a.dtype == torch.bfloat16),
                    int(route == "wgmma"), plan), "dp_fused_clip_plan")
                extra["plan"] = dict(zip(
                    ("tile", "group", "split", "rows_a_cta", "ctas",
                     "resident", "smem_bytes", "walk"), list(plan)))
            record("fused_clip_grad", path, f"{case} {clip}", G, Gp,
                   TOL[dname], ms_k, ms_p, nbytes, ops, dname,
                   timed=k == 0, **extra)
            del G, sq, Gp, sqp
        torch.cuda.empty_cache()

    def mm_case(case, L, Bc, Tc, d, p, dtype, kernels, clips=("automatic",)):
        """``kernels``: {kernel: the path it runs for} of this tap;
        ``clips``: the clip functions fused_clip_grad is checked under."""
        dname = str(dtype).split(".")[-1]
        a, ds = rnd(L, Bc, Tc, d, dtype=dtype), rnd(L, Bc, Tc, p, dtype=dtype)
        C = clip_factors(Bc, dtype)
        esz = a.element_size()
        rec_bytes = (a.numel() + ds.numel()) * esz
        # the one-call library version of either norm: the same function
        library = einsum_forms("lbtd,lbsd,lbtp,lbsp->b", a, a, ds, ds)
        if "ghost_norm" in kernels:
            args = ("ghost_norm", kernels["ghost_norm"], case, gn.ghost_norm,
                    gn.plain, (a, ds))
            nbytes = rec_bytes + Bc * 4
            ops = 2.0 * (d + p) * L * Bc * Tc * (Tc + 1) / 2
            if gn.route(dtype, d, p) == "wgmma":
                # the p chunks this launch cuts the wider record into
                split = build.load().dp_ghost_norm_wgmma_split(L, Bc, Tc, d,
                                                               p)
                wgmma_case(*args, NORM_TOL, NORM_TOL, nbytes, ops, library,
                           split=split, f64_rel_err=ghost_vs_f64(a, ds))
            else:
                norm_case(*args, nbytes, ops, dname, library)
        if "grad_norm_direct" in kernels:
            args = ("grad_norm_direct", kernels["grad_norm_direct"], case,
                    gd.grad_norm_direct, gd.plain, (a, ds))
            nbytes, ops = rec_bytes + Bc * 4, 2.0 * L * Bc * Tc * d * p
            if gd.route(dtype, d, p) == "wgmma":
                # beside the ghost einsum: the per-sample grads instantiated
                # in bf16 by one einsum, then squared and summed
                forms = dict(library, instantiated_bf16=lambda: torch.einsum(
                    "lbtd,lbtp->lbdp", a, ds).float().square().sum((0, 2, 3)))
                wgmma_case(*args, NORM_TOL, NORM_TOL, nbytes, ops, forms,
                           f64_rel_err=direct_vs_f64(a, ds))
            elif dtype == torch.bfloat16:
                # a bf16 tap of unaligned width (hymba's bcdt): the same
                # instantiated bf16 einsum beside the ghost one
                norm_case(*args, nbytes, ops, dname, dict(
                    library, instantiated_bf16=lambda: torch.einsum(
                        "lbtd,lbtp->lbdp", a, ds).float().square().sum(
                            (0, 2, 3))))
            else:
                norm_case(*args, nbytes, ops, dname, library)
        if "clipped_grad" in kernels:
            path = kernels["clipped_grad"]
            lib = lambda: torch.einsum("lbtd,b,lbtp->ldp", a, C.to(dtype),
                                       ds)
            nbytes = rec_bytes + Bc * 4 + L * d * p * 4
            ops = 2.0 * L * Bc * Tc * d * p
            if cg.route(dtype, d, p) == "wgmma":
                wgmma_grad_case(path, case, a, C, ds, nbytes, ops, lib)
            else:
                # an f32 sum over more rows than F32_SUM_ROWS: held to a
                # float64 evaluation beside the plain version
                grad_case("clipped_grad", path, case, cg.clipped_grad,
                          cg.plain, (a, C, ds), nbytes, ops, dname, lib,
                          exact=(lambda: torch.einsum(
                              "lbtd,b,lbtp->ldp", a.double(), C.double(),
                              ds.double()))
                          if dtype == torch.float32
                          and Bc * Tc > F32_SUM_ROWS else None)
        if "fused_clip_grad" in kernels:
            fused_case(kernels["fused_clip_grad"], case, a, ds, dname, clips)
        del a, ds, library
        torch.cuda.empty_cache()

    def emb_case(case, ids, d, V, dtype, kernels):
        """emb_ghost_norm (where ``kernels`` names it: at NORM_TOL) and
        emb_clipped_grad (at TOL) on ids (L,B,T) or (B,T), each (a) against
        its plain version, (c) itself run twice, bitwise; device time by
        torch.profiler beside the CUDA-event time, for both and for the
        weighted grad's library call."""
        dname = str(dtype).split(".")[-1]
        L, Bc, Tc = (ids if ids.dim() == 3 else ids[None]).shape
        ds = rnd(*ids.shape, d, dtype=dtype)
        C = torch.rand(Bc, generator=gen, device=dev) + 0.1
        esz = ds.element_size()
        if "emb_ghost_norm" in kernels:
            # the run-sum form's work: every row added once, each run's sum
            # squared (f32, on the CUDA cores)
            dev_n = (device_ms(lambda: en.emb_ghost_norm(ids, ds))
                     if timed("emb_ghost_norm", kernels["emb_ghost_norm"])
                     else {})
            norm_case("emb_ghost_norm", kernels["emb_ghost_norm"], case,
                      en.emb_ghost_norm, en.plain, (ids, ds),
                      ids.numel() * 4 + ds.numel() * esz + Bc * 4,
                      d * (ids.numel() + 2.0 * _runs(ids)), "float32",
                      **({"device_ms": sum(dev_n.values()),
                          "device_by_kernel": dev_n} if dev_n else {}))
        valid = ((ids >= 0) & (ids < V)).reshape(-1)
        flat = (ids.long() + torch.arange(L, device=dev)[:, None, None] * V
                ).reshape(-1)[valid]
        w = (ds.float() * C[:, None, None]).reshape(-1, d)[valid]
        path, args = kernels["emb_clipped_grad"], (ids, C, ds, V)
        library = lambda: torch.zeros(L * V, d, device=dev).index_add_(
            0, flat, w)
        got, again = eg.emb_clipped_grad(*args), eg.emb_clipped_grad(*args)
        extra = {}
        if timed("emb_clipped_grad", path):
            dev_k = device_ms(lambda: eg.emb_clipped_grad(*args))
            dev_lib = device_ms(library)
            extra = {"device_ms": sum(dev_k.values()),
                     "device_by_kernel": dev_k,
                     "library_device_ms": sum(dev_lib.values())}
        want = eg.plain(*args)
        r, wu = reps(path, "emb_clipped_grad")
        ms_k = cuda_ms(lambda: eg.emb_clipped_grad(*args), r, wu)
        ms_p = opt_ms("emb_clipped_grad", path, lambda: eg.plain(*args), 3, 1)
        ms_lib = opt_ms("emb_clipped_grad", path, library, r, wu)
        record("emb_clipped_grad", path, case, got, want, TOL[dname], ms_k,
               ms_p, ids.numel() * 4 + Bc * 4 + ds.numel() * esz
               + L * V * d * 4, 2.0 * int(valid.sum()) * d, dname, ms_lib,
               again, **extra)
        del ds, w, got, again, want
        torch.cuda.empty_cache()

    def emb_edges(kernels):
        """The ragged f32 case (odd d and V, stacked; ids -1 and >= V, which
        the weighted grad drops and the norm matches by value), ids of 4
        values (heavy duplicates) and one id at every (b, t) of ``train``'s
        shapes (all B*T ids in one row's run, T in one run of each
        sample's norm), and T = 9000."""
        ids = torch.randint(0, 1001, (3, 3, 509), generator=gen, device=dev,
                            dtype=torch.int32)
        ids[:, :, ::97] = -1
        ids[:, :, 5::101] = 1001 + 7
        emb_case("ragged L=3 B=3 T=509 d=37 V=1001 f32", ids, 37, 1001,
                 torch.float32, kernels)
        run = RUNS["train"]
        shape = (run["batch"], run["seq"])
        emb_case(f"4 ids B={run['batch']} T={run['seq']} "
                 f"d={q_cfg.d_model} V={q_cfg.vocab} bf16",
                 torch.randint(0, 4, shape, generator=gen, device=dev,
                               dtype=torch.int32) * 977, q_cfg.d_model,
                 q_cfg.vocab, torch.bfloat16, kernels)
        emb_case(f"one id B={run['batch']} T={run['seq']} "
                 f"d={q_cfg.d_model} V={q_cfg.vocab} bf16",
                 torch.full(shape, 7, device=dev, dtype=torch.int32),
                 q_cfg.d_model, q_cfg.vocab, torch.bfloat16, kernels)
        # more ids than the norm copies to shared memory: its ballots read
        # them from device memory
        emb_case("long B=2 T=9000 d=64 V=5000 bf16",
                 torch.randint(0, 5000, (2, 9000), generator=gen, device=dev,
                               dtype=torch.int32), 64, 5000, torch.bfloat16,
                 kernels)

    def moe_case(case, a, mask, p, kernels):
        """Records a (L,B,E,C,d) and mask (L,B,E,C): the model's own (path
        shapes, a pre-masked) or raw (ragged: the kernels' own masking is
        what is checked); cotangents random, unmasked."""
        dtype = a.dtype
        dname = str(dtype).split(".")[-1]
        L, Bc, E, Cap, d = a.shape
        ds = rnd(L, Bc, E, Cap, p, dtype=dtype)
        m = mask[..., None].to(dtype)
        am, dm = a * m, ds * m                   # for the library calls
        C = clip_factors(Bc, dtype)
        esz = a.element_size()
        # kept slots / (l,b,e): those of a non-zero mask value
        nv = (mask != 0).reshape(-1, Cap).sum(-1).double()
        kept = float(nv.sum())
        # the function reads the kept slots' rows and the mask
        rec_bytes = kept * (d + p) * esz + mask.numel() * 4
        fill = kept / mask.numel()
        library = einsum_forms("lbecd,lbefd,lbecp,lbefp->b", am, am, dm, dm)
        wgmma = mg.route(dtype, d, p) == "wgmma"
        if "moe_ghost_norm" in kernels:
            args = ("moe_ghost_norm", kernels["moe_ghost_norm"], case,
                    mg.moe_ghost_norm, ghost.sq_norm_moe_ghost,
                    (a, mask, ds))
            nbytes = rec_bytes + Bc * 4
            ops = float((d + p) * (nv * (nv + 1)).sum())
            if wgmma:
                wgmma_case(*args, NORM_TOL, NORM_TOL, nbytes, ops, library,
                           fill=fill, f64_rel_err=moe_ghost_vs_f64(a, mask,
                                                                   ds))
            else:
                norm_case(*args, nbytes, ops, dname, library, fill=fill)
        if "moe_direct_norm" in kernels:
            args = ("moe_direct_norm", kernels["moe_direct_norm"], case,
                    mg.moe_direct_norm, ghost.sq_norm_moe_direct,
                    (a, mask, ds))
            nbytes, ops = rec_bytes + Bc * 4, 2.0 * kept * d * p
            if wgmma:
                wgmma_case(*args, NORM_TOL, NORM_TOL, nbytes, ops, library,
                           fill=fill)
            else:
                norm_case(*args, nbytes, ops, dname, library, fill=fill)
        if "moe_clipped_grad" in kernels:
            args = ("moe_clipped_grad", kernels["moe_clipped_grad"], case,
                    mg.moe_clipped_grad, mg.plain_clipped_grad,
                    (a, mask, C, ds))
            nbytes = rec_bytes + Bc * 4 + L * E * d * p * 4
            ops = 2.0 * kept * d * p
            lib = lambda: torch.einsum("lbecd,b,lbecp->ledp", a, C.to(dtype),
                                       dm)
            if wgmma:
                wgmma_case(*args, TOL["bfloat16"], SIMT_GRAD_TOL, nbytes, ops,
                           lib, fill=fill)
            else:
                grad_case(*args, nbytes, ops, dname, lib, fill=fill)
        del ds, dm, am, library
        torch.cuda.empty_cache()

    # ---- the serving kernels: each run twice (bitwise), against its plain
    # version, timed beside it and (flash) beside one SDPA call
    def repeat_case(name, path, case, fn, plain, args, tol, nbytes, ops,
                    dname, library=None, simt=None, route="wgmma", **extra):
        """``simt``: the SIMT (or scan) kernel of a ``route`` kernel, held
        to it at ``tol`` and timed beside it."""
        got, again = fn(*args), fn(*args)
        want = plain(*args)
        r, w = reps(path, name)
        if simt is not None:
            extra.update(simt_check(name, case, got, simt(*args), tol, route))
            extra["simt_ms"] = opt_ms(name, path, lambda: simt(*args), r, w)
            extra["route"] = route
        ms_k = cuda_ms(lambda: fn(*args), r, w)
        ms_p = opt_ms(name, path, lambda: plain(*args), 3, 1)
        ms_lib = opt_ms(name, path, library, r, w) if library else None
        record(name, path, case, got, want, tol, ms_k, ms_p, nbytes, ops,
               dname, ms_lib, again, **extra)
        del got, again, want
        torch.cuda.empty_cache()

    def flash_case(path, B, T, S, H, K, h, causal, dtype):
        dname = str(dtype).split(".")[-1]
        q, k, v = rnd(B, T, H, h, dtype=dtype), rnd(B, S, K, h, dtype=dtype), \
            rnd(B, S, K, h, dtype=dtype)
        # the (t, s) pairs this run computes: s <= t (causal) or all
        pairs = sum(min(t + 1, S) for t in range(T)) if causal else T * S
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        repeat_case(
            "flash_attention", path,
            f"{path} B={B} T={T} S={S} H={H} K={K} h={h} "
            f"{'causal' if causal else 'bidirectional'} {dname[:4]}",
            fa.flash_attention, fa.plain, (q, k, v, causal),
            FLASH_TOL[dname],
            (2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
            4.0 * B * H * h * pairs, dname,
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True),
            simt=(lambda *a: fa.flash_attention(*a, kernel="simt"))
            if fa.route(dtype, h) == "wgmma" else None)
        del q, k, v, qt, kt, vt

    def wkv_decay(shape, decay):
        """w: uniform in [0.5, 0.999] (None), the constant ``decay``, or
        'mixed': log-uniform in [1e-6, 1] per element, 5% of them exactly 0
        and 5% exactly 1 (where a difference of prefix sums of log w would
        lose the recurrence, or give NaN)."""
        if decay is None:
            return torch.rand(shape, generator=gen, device=dev) * 0.499 + 0.5
        if decay == "mixed":
            w = torch.exp(torch.rand(shape, generator=gen, device=dev)
                          * math.log(1e-6))
            m = torch.rand(shape, generator=gen, device=dev)
            return torch.where(m < 0.05, 0.0, torch.where(m > 0.95, 1.0, w))
        return torch.full(shape, decay, device=dev)

    def wkv_vs_f64(args, tol):
        """The recurrence in float64 at (b 0, head 0), as the arbiter of the
        f32 sums -> each version's max abs error there; raises unless the
        chunked kernel is within ``tol`` of it."""
        r_, k_, v_, w, u = (t.double() for t in args)
        u0 = u[0, 0] if u.dim() == 3 else u[0]
        x = [t[0, :, 0] for t in (r_, k_, v_, w)]
        S = torch.zeros(x[0].shape[-1], x[0].shape[-1], dtype=torch.float64,
                        device=dev)
        exact = torch.empty_like(x[0])
        for t in range(x[0].shape[0]):
            rt, kt, vt, wt = (y[t] for y in x)
            exact[t] = rt @ S + (rt * u0 * kt).sum() * vt
            S = wt[:, None] * S + kt[:, None] * vt[None, :]
        got = {k: fn()[0, :, 0] for k, fn in (
            ("chunked", lambda: wk.wkv6(*args)),
            ("scan", lambda: wk.wkv6(*args, kernel="scan")),
            ("plain", lambda: wk.plain(*args)))}
        cmp = compare(got["chunked"], exact, tol)
        if not cmp["ok"]:
            raise AssertionError(f"wkv6: the chunked kernel is off the "
                                 f"float64 recurrence: {cmp}")
        return {k: float((g.double() - exact).abs().max())
                for k, g in got.items()}

    def wkv_u(B, H, h, per_sample):
        """u normal * 0.5, f32 (as the wrapper hands it to the kernel):
        (H,h), or (B,H,h) per sample (the BK step's psp layout)."""
        lead = (B,) if per_sample else ()
        return torch.randn(*lead, H, h, generator=gen, device=dev) * 0.5

    def wkv_case(path, case, B, T, H, h, dtype, tol, decay=None, f64=False,
                 per_sample_u=False):
        """r, k, v standard normal, w as ``wkv_decay`` draws it, u as
        ``wkv_u``; on the chunked route also (b) against the scan kernel
        at ``tol``; ``f64``: every version against a float64 recurrence at
        one head."""
        dname = str(dtype).split(".")[-1]
        r_, k_, v_ = (rnd(B, T, H, h, dtype=dtype) for _ in range(3))
        w = wkv_decay((B, T, H, h), decay).to(dtype)
        u = wkv_u(B, H, h, per_sample_u)
        args = (r_, k_, v_, w, u)
        n = B * T * H * h
        extra = {"f64_max_abs_err": wkv_vs_f64(args, tol)} if f64 else {}
        chunked = wk.route(dtype, h) == "chunked"
        repeat_case("wkv6", path, f"{path} {case} B={B} T={T} H={H} h={h} "
                    f"{dname[:4]}", wk.wkv6, wk.plain, args, tol,
                    4 * n * r_.element_size() + u.numel() * 4 + n * 4,
                    B * T * H * (5.0 * h * h + 5.0 * h), dname,
                    simt=(lambda *a: wk.wkv6(*a, kernel="scan")) if chunked
                    else None, route="chunked", **extra)
        del r_, k_, v_, w, u, args

    def wkv_bwd_vs_f64(args, got, want):
        """The five grads at (b 0, head 0) against float64 autograd through
        the recurrence there -> the kernel's and the plain version's max
        abs error; raises unless the kernel is within WKV_BWD_TOL."""
        do, r_, k_, v_, w, u, _ = args
        one = [t[:1, :, :1].double() for t in (r_, k_, v_, w, do)]
        u1 = (u[:1, :1] if u.dim() == 3 else u[None, :1]).double()
        exact = wk.plain_backward(*one[:4], u1, one[4])

        def head(gs):
            return torch.cat([*(g[:1, :, :1].reshape(-1) for g in gs[:4]),
                              gs[4][:1, :1].reshape(-1)]).double()
        want64 = torch.cat([g.reshape(-1) for g in exact])
        cmp = compare(head(got), want64, WKV_BWD_TOL)
        if not cmp["ok"]:
            raise AssertionError(f"wkv6_backward: the kernel is off the "
                                 f"float64 gradients: {cmp}")
        return {"kernel": cmp["max_abs_err"],
                "plain": float((head(want) - want64).abs().max())}

    def wkv_bwd_case(path, case, B, T, H, h, dtype, decay=None, f64=False,
                     per_sample_u=False):
        """wkv6_backward on r, k, v standard normal, w as ``wkv_decay``
        draws it, u as ``wkv_u``, do standard normal (f32) and the chunk
        states the chunked forward saves on them: (a) its five grads
        against ``plain_backward`` (autograd through the recurrence) at
        WKV_BWD_TOL, (c) itself run twice, bitwise; ``f64``: at one (b,
        head) against float64 autograd. Bound: the inputs, do and the saved
        states read once and the five grads written once, against the six
        h x h f32 FMA passes a token and head (the S and dS updates, dr,
        dk, dv, dw)."""
        dname = str(dtype).split(".")[-1]
        r_, k_, v_ = (rnd(B, T, H, h, dtype=dtype) for _ in range(3))
        w = wkv_decay((B, T, H, h), decay).to(dtype)
        u = wkv_u(B, H, h, per_sample_u)
        do = torch.randn(B, T, H, h, generator=gen, device=dev)
        state = wk._forward(r_, k_, v_, w, u, "chunked")[1]
        args = (do, r_, k_, v_, w, u, state)

        def flat(gs):
            return torch.cat([g.reshape(-1) for g in gs])
        got, again = wk.wkv6_backward(*args), wk.wkv6_backward(*args)
        want = wk.plain_backward(r_, k_, v_, w, u, do)
        per_grad = {}
        for name, g, x in zip(("dr", "dk", "dv", "dw", "du"), got, want):
            c = compare(g, x, WKV_BWD_TOL)
            per_grad[name] = {"max_abs_err": c["max_abs_err"], "ok": c["ok"]}
        extra = {"per_grad": per_grad, "u": "per sample (B,H,h)"
                 if per_sample_u else "shared (H,h)"}
        if f64:
            extra["f64_max_abs_err"] = wkv_bwd_vs_f64(args, got, want)
        r, wu = reps(path, "wkv6_backward")
        ms_k = cuda_ms(lambda: wk.wkv6_backward(*args), r, wu)
        ms_p = opt_ms("wkv6_backward", path,
                      lambda: wk.plain_backward(r_, k_, v_, w, u, do), 3, 1)
        n = B * T * H * h
        nbytes = (4 * n * r_.element_size() + u.numel() * 4 + n * 4
                  + state.numel() * 4 + 4 * n * 4 + B * H * h * 4)
        record("wkv6_backward", path, f"{path} {case} B={B} T={T} H={H} "
               f"h={h} {dname[:4]}", flat(got), flat(want), WKV_BWD_TOL,
               ms_k, ms_p, nbytes, 12.0 * n * h, "float32", None,
               flat(again), **extra)
        del r_, k_, v_, w, u, do, state, args, got, again, want
        torch.cuda.empty_cache()

    def wkv_shapes():
        """wkv6 at the prefill's shapes (bf16, against float64 at one head
        too) and at ragged ones: T not a multiple of a chunk, h 16 and 64,
        the strong constant decays, and the mixed decay of ``wkv_decay``."""
        rp = SERVING["prefill_rwkv"]
        r_cfg = get_config(rp["arch"])
        wkv_case("prefill_rwkv", "w~U[0.5,0.999]", rp["batch"], rp["seq"],
                 r_cfg.d_model // r_cfg.hd, r_cfg.hd, torch.bfloat16,
                 WKV_LONG_TOL, f64=True)
        for h in (16, 64):
            wkv_case("ragged", "w~U[0.5,0.999]", 3, 509, 3, h, torch.float32,
                     WKV_TOL)
        for decay in (0.1, 0.01):           # where the chunked forms fail
            wkv_case("ragged", f"strong decay w={decay}", 1, 64, 2, 64,
                     torch.float32, WKV_TOL, decay)
            wkv_case("ragged", f"strong decay w={decay}", 2, 509, 3, 64,
                     torch.float32, WKV_TOL, decay)
        mixed = "mixed decay w~logU[1e-6,1], 5% 0, 5% 1"
        wkv_case("ragged", mixed, 2, 509, 3, 64, torch.float32, WKV_TOL,
                 "mixed")
        wkv_case("ragged", mixed, 2, 1000, 4, 64, torch.bfloat16,
                 WKV_LONG_TOL, "mixed")
        # u per sample (B,H,h), as the BK step gives it: train_rwkv's shapes
        # (bf16, float64 at one head) and ragged f32
        rt = RUNS["train_rwkv"]
        w_cfg = get_config(rt["arch"])
        Hr, hr = w_cfg.d_model // w_cfg.hd, w_cfg.hd
        wkv_case("train_rwkv", "w~U[0.5,0.999], u per sample", rt["batch"],
                 rt["seq"], Hr, hr, torch.bfloat16, WKV_LONG_TOL, f64=True,
                 per_sample_u=True)
        wkv_case("ragged", "w~U[0.5,0.999], u per sample", 3, 509, 3, 64,
                 torch.float32, WKV_TOL, per_sample_u=True)
        # the backward: train_rwkv's shapes (bf16, u per sample, float64 at
        # one head), ragged f32 (T not a multiple of a chunk, h 16 and 64,
        # both u layouts), the strong constant decays and the mixed decay
        wkv_bwd_case("train_rwkv", "w~U[0.5,0.999], u per sample",
                     rt["batch"], rt["seq"], Hr, hr, torch.bfloat16,
                     f64=True, per_sample_u=True)
        for h in (16, 64):
            for per_sample in (False, True):
                wkv_bwd_case("ragged", "w~U[0.5,0.999]", 3, 509, 3, h,
                             torch.float32, per_sample_u=per_sample)
        for decay in (0.1, 0.01):
            wkv_bwd_case("ragged", f"strong decay w={decay}", 2, 509, 3, 64,
                         torch.float32, decay, f64=True)
        wkv_bwd_case("ragged", mixed, 2, 509, 3, 64, torch.float32, "mixed",
                     f64=True)
        wkv_bwd_case("ragged", mixed, 2, 1000, 4, 64, torch.bfloat16,
                     "mixed", per_sample_u=True)

    bf16 = torch.bfloat16
    fp = SERVING["prefill"]
    q_cfg = get_config(fp["arch"])

    moe_wgmma = dict.fromkeys(("moe_ghost_norm", "moe_direct_norm",
                               "moe_clipped_grad"), "ragged")

    def router_mask(L, Bc, E, Cap, fill):
        """A 0/1 slot mask as the router leaves it: each (l, b, e) keeps a
        random count of slots (mean ~ fill * Cap), the kept ones first."""
        n = torch.randint(0, Cap + 1, (L, Bc, E, 1), generator=gen,
                          device=dev).float() * (2 * fill)
        return (torch.arange(Cap, device=dev).float() < n).float()

    def hymba_cases():
        """train_hymba's taps as the engine routes them (the head's SIMT
        routes at p = 32001 among them), then the routes bk-mixopt takes
        in no run at hymba's odd width, bcdt's p = 57 (it caches the
        per-sample grads): grad_norm_direct and clipped_grad on their SIMT
        routes (bf16, unaligned) at the stacked swa_a tap's shapes; and
        prefill_hymba's global layers' flash_attention."""
        group_cases(("train_hymba",))
        run = RUNS["train_hymba"]
        h_cfg = run_config("train_hymba")[0]
        Bh, Th = run["batch"], run["seq"] + h_cfg.meta_tokens
        L = h_cfg.full_attn_layers[1] - 1
        p = 2 * h_cfg.ssm_state + h_cfg.ssm_heads
        for k in (gd, cg):
            if k.route(bf16, h_cfg.d_model, p) != "simt":
                raise AssertionError(f"{k.__name__}: bcdt (p = {p}) is not "
                                     "on the SIMT route")
        mm_case(f"train_hymba swa_a/ssm/bcdt L={L} B={Bh} T={Th} "
                f"d={h_cfg.d_model} p={p} bf16 (cached by bk-mixopt)", L, Bh,
                Th, h_cfg.d_model, p, bf16,
                {"grad_norm_direct": "hymba_bcdt",
                 "clipped_grad": "hymba_bcdt"})
        hp = SERVING["prefill_hymba"]
        Tp = hp["seq"] + h_cfg.meta_tokens
        flash_case("prefill_hymba", hp["batch"], Tp, Tp, h_cfg.n_heads,
                   h_cfg.n_kv_heads, h_cfg.hd, True, bf16)

    def whisper_cases():
        """train_whisper's taps as the engine routes them (the encoder's
        direct norm on its 12-layer stacks at T = 1500, the head's SIMT
        routes at p = 51865 among them), then prefill_whisper's three
        flash_attention shapes: the encoder's bidirectional Tf x Tf, the
        decoder's causal Td x Td and the cross-attention's bidirectional
        Td x Tf."""
        group_cases(("train_whisper",))
        wp = SERVING["prefill_whisper"]
        w_cfg = get_config(wp["arch"])
        Bw, Tf, Td = wp["batch"], wp["frames"], wp["seq"]
        for T, S, causal in ((Tf, Tf, False), (Td, Td, True),
                             (Td, Tf, False)):
            flash_case("prefill_whisper", Bw, T, S, w_cfg.n_heads,
                       w_cfg.n_kv_heads, w_cfg.hd, causal, bf16)

    def index_width_cases(path):
        """The widest leaves' 32-bit index width: emb_clipped_grad's and the
        head's clipped_grad outputs at a path's shapes (bf16; llama3-405b's
        embedding and head hold V d = 2,101,346,304 elements, 97.9% of
        INT32_MAX; internvl2-26b's head record B T p = 1,137,291,264 over
        its 1536 positions) held to their plain versions on their last 2^20
        elements, where an index that a 32-bit product wrapped would land:
        the ids give every sample the embedding's last rows that the tail
        covers, and the head's plain version runs on the last rows of d
        that the tail covers."""
        cfg = run_config(path)[0]
        run = RUNS[path]
        Bl, Tl, d, V = run["batch"], run["seq"], cfg.d_model, cfg.vocab
        Th = Tl + cfg.patch_tokens           # the head runs over the patches
        tail = 1 << 20
        C = clip_factors(Bl, bf16)

        def check(kernel, case, got, want):
            got, want = got.reshape(-1)[-tail:], want.reshape(-1)[-tail:]
            cmp = compare(got, want, TOL["bfloat16"])
            emit(phase="kernels", kernel=kernel, path=path, case=case,
                 check="index_width", elements=V * d,
                 of_int32_max=V * d / (2 ** 31 - 1), tail=tail,
                 tail_nonzero=int((want != 0).sum()), **cmp)
            if not cmp["ok"] or not bool((want != 0).any()):
                raise AssertionError(f"{kernel} [{case}]: the last {tail} "
                                     f"of {V * d} elements disagree with the "
                                     f"plain version ({cmp}), or are zero")

        rows = -(-tail // d)                     # the embedding's last rows
        ids = torch.randint(0, V, (Bl, Tl), generator=gen, device=dev,
                            dtype=torch.int32)
        ids[:, :rows] = torch.arange(V - rows, V, device=dev,
                                     dtype=torch.int32)
        ds = rnd(Bl, Tl, d)
        # ids shifted by V - rows: only the last rows' stay in [0, rows)
        check("emb_clipped_grad", f"embed B={Bl} T={Tl} V={V} d={d} bf16, "
              f"ids on the last {rows} rows", eg.emb_clipped_grad(
                  ids, C, ds, V),
              eg.plain(ids - (V - rows), C, ds, rows))
        del ds
        torch.cuda.empty_cache()
        a, g = rnd(1, Bl, Th, d), rnd(1, Bl, Th, V)
        cols = -(-tail // V)                     # the head's last rows of d
        check("clipped_grad", f"head L=1 B={Bl} T={Th} d={d} p={V} bf16 "
              f"(B T p = {Bl * Th * V})", cg.clipped_grad(a, C, g),
              cg.plain(a[..., -cols:].contiguous(), C, g))
        del a, g
        torch.cuda.empty_cache()

    def internvl2_cases():
        """train_internvl2's taps as the engine routes them (the head's
        SIMT routes at p = 92553 timed beside the einsum: path
        ``internvl2_head``), then prefill_internvl2's flash_attention (48 /
        8 heads, h 128, T = 1024 patches + 1024 tokens)."""
        group_cases(("train_internvl2",), {"head#mm": "internvl2_head"})
        ip = SERVING["prefill_internvl2"]
        i_cfg = get_config(ip["arch"])
        Ti = ip["seq"] + i_cfg.patch_tokens
        flash_case("prefill_internvl2", ip["batch"], Ti, Ti, i_cfg.n_heads,
                   i_cfg.n_kv_heads, i_cfg.hd, True, bf16)

    def cnn_cases():
        """The CNN's taps at train_cnn's shapes (B=32, bf16) and
        parity_cnn's (B=4, f32), each with the kernels its modes route it
        to (``plan_report``): the convs' grad_norm_direct (c1 on SIMT at d
        = 147) and clipped_grad under bk-mixghost (bk-mixopt caches them);
        under 'bk' (parity_cnn, and ghostclip's norms) their ghost_norm; the
        head ghost_norm and clipped_grad (T = 1)."""
        from repro_torch.core.bk import DPConfig, plan_report, tap_act_structs
        for path, B, dtype, modes in (
                ("train_cnn", CNN_TRAIN["batch"], bf16, CNN_TRAIN["modes"]),
                ("parity_cnn", CNN_PARITY["batch"], torch.float32,
                 CNN_PARITY["modes"])):
            params = cnn_init(0, dev, dtype)
            batch = cnn_batch(B, 0, dev)
            outs, acts = tap_act_structs(cnn_apply, params, batch)
            kernels = {key: {} for key in acts}
            for mode in modes:
                report = plan_report(cnn_apply, params, batch, DPConfig(
                    mode="bk" if mode == "ghostclip" else mode))
                for key, plans in report.items():
                    if plans["grad"] == "cache":
                        continue
                    kernels[key][NORM_KERNEL[
                        "mm", plans["norm"].method]] = path
                    if mode != "ghostclip":
                        kernels[key][plans["grad"]] = path
            del params, batch
            for key in sorted(acts):
                (_, Tc, d), p = acts[key][0], outs[key][0][-1]
                dname = "bf16" if dtype == bf16 else "f32"
                mm_case(f"{path} {parse_key(key)[0]} L=1 B={B} T={Tc} d={d} "
                        f"p={p} {dname}", 1, B, Tc, d, p, dtype, kernels[key])

    def wgmma_shapes():
        """The wgmma routes at one tile and at ragged bf16 shapes: widths
        multiples of 8 but of no tile, T / C not a multiple of any tile
        (MoE: a random 0/1 mask with an all-zero expert and a sample with no
        kept slot); flash with h 64 and 128, G 1 and 6, causal and
        bidirectional, and bidirectional with T != S (cross-attention's
        case: fewer queries than keys and more)."""
        mm_case("tile L=1 B=1 T=64 d=128 p=128 bf16", 1, 1, 64, 128, 128,
                bf16, dict.fromkeys(("clipped_grad", "grad_norm_direct"),
                                    "ragged"))
        mm_case("tile L=1 B=1 T=128 d=128 p=128 bf16", 1, 1, 128, 128, 128,
                bf16, {"ghost_norm": "ragged"})
        mm_case("ragged L=3 B=3 T=509 d=136 p=264 bf16", 3, 3, 509, 136, 264,
                bf16, dict.fromkeys(("ghost_norm", "clipped_grad",
                                     "grad_norm_direct"), "ragged"))
        moe_case("tile L=1 B=1 E=1 C=64 d=128 p=128 bf16",
                 rnd(1, 1, 1, 64, 128), torch.ones(1, 1, 1, 64, device=dev),
                 128, moe_wgmma)
        mask = (torch.rand(2, 3, 5, 37, generator=gen, device=dev) < 0.7
                ).float()
        mask[:, :, 0] = 0.0             # an expert that no sample reached
        mask[:, 1] = 0.0                # a sample with no kept slot
        moe_case("ragged L=2 B=3 E=5 C=37 d=136 p=264 bf16",
                 rnd(2, 3, 5, 37, 136), mask, 264, moe_wgmma)
        # the ghost norm past one tile (3 tiles of 64 slots: off-diagonal
        # pairs) under a non-binary mask, with empty slots and an all-zero
        # expert (the other two kernels round a general mask into bf16, so
        # NORM_TOL does not hold them to it)
        mask = torch.rand(2, 3, 3, 130, generator=gen, device=dev) * 2.0
        mask[mask < 0.5] = 0.0
        mask[:, :, 1] = 0.0
        moe_case("ragged L=2 B=3 E=3 C=130 d=136 p=264 bf16, mask in "
                 "{0} + [0.5, 2)", rnd(2, 3, 3, 130, 136), mask, 264,
                 {"moe_ghost_norm": "ragged"})
        for causal in (True, False):
            flash_case("tile", 1, 128, 128, 1, 1, 128, causal, bf16)
        for h in (64, 128):
            for H in (2, 12):                   # G = 1 and 6 over K = 2
                for causal in (True, False):
                    flash_case("ragged", 2, 509, 509, H, 2, h, causal, bf16)
        for T, S in ((509, 1500), (1500, 509)):
            flash_case("ragged", 2, T, S, 12, 2, 64, False, bf16)
        # rwkv6-3b's narrow mm taps (train_rwkv: the direct norm, then
        # clipped_grad), two layers of random records at its B and T
        rt = RUNS["train_rwkv"]
        for tap, d, p in (("tm_w1", 2560, 160), ("tm_w2_i", 32, 2560),
                          ("wa", 2560, 64), ("wb", 64, 2560)):
            mm_case(f"rwkv6 narrow {tap} L=2 B={rt['batch']} T={rt['seq']} "
                    f"d={d} p={p} bf16", 2, rt["batch"], rt["seq"], d, p,
                    bf16, dict.fromkeys(("grad_norm_direct", "clipped_grad"),
                                        "ragged"))

    def fused_edges():
        """fused_clip_grad at the largest units the reference's rule sends
        to it (FUSED_EDGES: bf16, B=8, T=512; ``dispatch.fused_plan`` must
        say 'fused' for each), on its wgmma route, every clip function at
        edge_square; at the units whose tiles outnumber the card's
        resident CTAs (FUSED_WALKS: the walk, asserted by the plan; every
        clip function at the bf16 adapter); at one tile; and at B = 20
        (three groups of samples)."""
        B, T = 8, 512
        cases = [(name, L, T, d, p, "bfloat16", name == "edge_square")
                 for name, L, d, p in FUSED_EDGES]
        cases += [(*walk, walk[0] == "edge_adapter_stacked")
                  for walk in FUSED_WALKS]
        for name, L, Tc, d, p, dname, every_clip in cases:
            plan = dispatch.fused_plan("mm", (L, B, Tc, d), (L, B, Tc, p),
                                       "bk-mixopt").method
            if plan != "fused":
                raise AssertionError(f"fused_clip_grad [{name}]: fused_plan "
                                     f"says {plan!r}, want 'fused'")
            dtype = getattr(torch, dname)
            if any(name == walk[0] for walk in FUSED_WALKS):
                walks = (ctypes.c_int * 8)()
                build.check(build.load().dp_fused_clip_plan(
                    L, B, Tc, d, p, int(dtype == bf16),
                    int(fc.route(dtype, d, p) == "wgmma"), walks),
                    "dp_fused_clip_plan")
                if not walks[7] or walks[4] <= 0:
                    raise AssertionError(f"fused_clip_grad [{name}]: plan "
                                         f"{list(walks)}, want the walk")
            mm_case(f"{name} L={L} B={B} T={Tc} d={d} p={p} "
                    f"{'bf16' if dtype == bf16 else 'f32'}", L, B, Tc, d, p,
                    dtype, {"fused_clip_grad": "edge"},
                    fc.CLIPS if every_clip else ("automatic",))
        mm_case("tile L=1 B=2 T=64 d=64 p=64 bf16", 1, 2, 64, 64, 64, bf16,
                {"fused_clip_grad": "edge"})
        # more samples than a group's 8 slots (three grid barriers), ragged
        # T, p of no tile
        mm_case("groups L=2 B=20 T=100 d=64 p=40 bf16", 2, 20, 100, 64, 40,
                bf16, {"fused_clip_grad": "edge"}, fc.CLIPS)

    if only_noise:
        counter_noise_checks(record, rnd)
        noise_update_checks(record, rnd)
        shard_block_checks(rnd)
        return summary
    if only_wgmma:
        wgmma_shapes()
        fused_edges()
        d, V = q_cfg.d_model, q_cfg.vocab
        # the head of train: its items take the p split
        mm_case(f"train head L=1 B=8 T=512 d={d} p={V} bf16", 1, 8, 512, d,
                V, bf16, {"ghost_norm": "train", "clipped_grad": "train"})
        # train_moe's up tap, random records under a router-like mask
        m_cfg = get_config(RUNS["train_moe"]["arch"])
        L, E, Cap = MOE_LAYERS - 1, m_cfg.n_experts, 60
        mask = router_mask(L, 8, E, Cap, 0.75)
        moe_case(f"train_moe up L={L} B=8 E={E} C={Cap} d={m_cfg.d_model} "
                 f"p={2 * m_cfg.moe_d_ff} bf16 (random records)",
                 rnd(L, 8, E, Cap, m_cfg.d_model) * mask[..., None].to(bf16),
                 mask, 2 * m_cfg.moe_d_ff,
                 {"moe_ghost_norm": "train_moe",
                  "moe_direct_norm": "train_moe_direct",
                  "moe_clipped_grad": "train_moe"})
        flash_case("prefill", fp["batch"], fp["seq"], fp["seq"],
                   q_cfg.n_heads, q_cfg.n_kv_heads, q_cfg.hd, True, bf16)
        # train_long's qkv tap, random records: grad_norm_direct's row shape
        p_qkv = q_cfg.hd * (q_cfg.n_heads + 2 * q_cfg.n_kv_heads)
        mm_case(f"train_long qkv L={LONG_LAYERS} B=2 T=2048 d={d} "
                f"p={p_qkv} bf16", LONG_LAYERS, 2, 2048, d, p_qkv, bf16,
                {"grad_norm_direct": "train_long"})
        wkv_shapes()
        return summary

    def group_cases(paths, relabel=None):
        """The train paths' shapes, each tap routed as the engine routes
        it; ``relabel`` {tap key: path}: that tap's cases under another
        path name (a TIMED_PATHS one)."""
        cfg, batch, taps, records = path_taps(paths, dev)
        B = RUNS[paths[0]]["batch"]
        seen = set()
        # taps of one layer shape and route, stacked or not (hymba's global
        # blocks and its two sliding-window segments; deepseek-moe's
        # dense0_0 attention beside the MoE blocks'): one case, the deepest
        # stack's
        taps = sorted(taps, key=lambda t: -t[2][0] if len(t[2]) == 4 else -1)
        for key, kind, a_shape, ds_shape, kernels in taps:
            if not kernels:
                continue            # the mixopt cache (an einsum), no kernel
            same = (kind, tuple(a_shape[-3:]), ds_shape[-1],
                    tuple(sorted(kernels.items())))
            if kind != "moe" and same in seen:
                continue
            seen.add(same)
            where = f"{paths[0]} {parse_key(key)[0]}"
            if key in (relabel or {}):
                kernels = dict.fromkeys(kernels, relabel[key])
            if kind == "mm":
                L = a_shape[0] if len(a_shape) == 4 else 1
                # the record's T: the batch's T plus any meta tokens (or
                # whisper's decoder tokens, or its frames)
                Tr, d, p = a_shape[-2], a_shape[-1], ds_shape[-1]
                # every clip function on the smallest unit, o
                mm_case(f"{where} L={L} B={B} T={Tr} d={d} p={p} bf16", L, B,
                        Tr, d, p, torch.bfloat16, kernels,
                        fc.CLIPS if key.endswith("/o#mm.s") else
                        ("automatic",))
            elif kind == "emb":
                emb_case(f"{where} B={B} T={batch['tokens'].shape[1]} "
                         f"d={ds_shape[-1]} "
                         f"V={cfg.vocab} bf16", batch["tokens"], ds_shape[-1],
                         cfg.vocab, torch.bfloat16, kernels)
            else:
                a, mask = records[key]["a"], records[key]["mask"]
                L, _, E, Cap, d = a.shape
                moe_case(f"{where} L={L} B={B} E={E} C={Cap} d={d} "
                         f"p={ds_shape[-1]} bf16", a, mask, ds_shape[-1],
                         kernels)
        del records

    clock = {"t": time.perf_counter()}

    def part(name):
        """The seconds of the kernels phase's part ``name``."""
        now = time.perf_counter()
        emit(phase="kernels_seconds", part=name, seconds=now - clock["t"])
        clock["t"] = now

    for paths in PATH_GROUPS:
        group_cases(paths)
        part(paths[0])

    # ---- fused_clip_grad where a driven path launches it: the smoke-width
    # case of parity_layer (f32), whose every mm unit fits fused_plan's
    # budget (every clip function on the smallest unit, o)
    B, T = RUNS["train_layer"]["batch"], RUNS["train_layer"]["seq"]
    for key, kind, a_shape, ds_shape, kernels in path_taps(
            ("train_layer",), dev, smoke=True)[2]:
        if "fused_clip_grad" in kernels:
            L = a_shape[0] if len(a_shape) == 4 else 1
            d, p = a_shape[-1], ds_shape[-1]
            mm_case(f"parity_layer smoke {parse_key(key)[0]} L={L} B={B} "
                    f"T={T} d={d} p={p} f32", L, B, T, d, p, torch.float32,
                    {"fused_clip_grad": "parity_layer"},
                    fc.CLIPS if key.endswith("/o#mm.s") else ("automatic",))
    fused_edges()
    part("fused")

    # ---- ragged: T / C not a multiple of any tile, odd d / p / V, stacked,
    # f32; some ids outside [0, V) (dropped by both versions); masked slots.
    # d, p of one tile and of several, neither a multiple of 128
    mm_all = dict.fromkeys(("ghost_norm", "grad_norm_direct",
                            "clipped_grad", "fused_clip_grad"), "ragged")
    moe_all = dict.fromkeys(("moe_ghost_norm", "moe_direct_norm",
                             "moe_clipped_grad"), "ragged")
    for d, p in ((37, 53), (165, 301)):
        mm_case(f"ragged L=3 B=3 T=509 d={d} p={p} f32", 3, 3, 509, d, p,
                torch.float32, mm_all, fc.CLIPS)
        mask = (torch.rand(2, 3, 5, 7, generator=gen, device=dev) < 0.7
                ).float()
        mask[0, :, 0] = 0.0             # an expert that no sample reached
        moe_case(f"ragged L=2 B=3 E=5 C=7 d={d} p={p} f32",
                 rnd(2, 3, 5, 7, d, dtype=torch.float32), mask, p, moe_all)
    emb_edges(dict.fromkeys(("emb_ghost_norm", "emb_clipped_grad"),
                            "ragged"))
    part("ragged")
    # train_rwkv's taps after fused_clip_grad's cases: its profiled
    # one-kernel-a-call check loses device events as the process ages (the
    # profiler's clock drifts: scripts/profiler_window.py)
    group_cases(("train_rwkv",))
    part("train_rwkv")
    hymba_cases()
    part("train_hymba")
    whisper_cases()
    part("train_whisper")
    # the B8.4 decoder paths (each tap checked as the engine routes it; the
    # kernel's time alone), then the 32-bit index width at llama3's leaves
    for name in ("train_qwen25", "train_qwen3", "train_llama3",
                 "train_moonshot"):
        group_cases((name,))
        part(name)
    internvl2_cases()
    part("train_internvl2")
    cnn_cases()
    part("train_cnn")
    for path in ("train_llama3", "train_internvl2"):
        index_width_cases(path)
    part("index_width")

    flash_case("prefill", fp["batch"], fp["seq"], fp["seq"], q_cfg.n_heads,
               q_cfg.n_kv_heads, q_cfg.hd, True, torch.bfloat16)
    for h in (16, 64, 128):
        for H in (2, 12):                       # G = 1 and 6 over K = 2
            for causal in (True, False):
                flash_case("ragged", 2, 509, 509, H, 2, h, causal,
                           torch.float32)
    for T, S in ((509, 1500), (1500, 509)):     # cross-attention's T != S
        flash_case("ragged", 2, T, S, 12, 2, 64, False, torch.float32)
    part("flash")
    wgmma_shapes()
    part("wgmma")
    wkv_shapes()
    part("wkv")
    counter_noise_checks(record, rnd)
    part("counter_noise")
    noise_update_checks(record, rnd)
    part("noise_update")
    shard_block_checks(rnd)
    part("shard_blocks")
    return summary


def shifted(t, offset: int):
    """A copy of ``t`` as a contiguous view ``offset`` elements into a
    buffer of its dtype (``t`` itself when offset is 0)."""
    import torch
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def _stand_in_mesh(shape, coords):
    """A rank of a mesh of ``shape`` at ``coords``, as ``launch.sharding``
    reads one (axis sizes and the rank's coordinates; no processes)."""
    import types
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names,
                                 coords=dict(zip(names, coords)))


def shard_block_checks(rnd):
    """The noise kernels' block route (``shard blocks``): every rank block
    that the rules table gives a leaf of ``train`` (qwen2-1.5b at full
    width, bf16) under each of SHARD_MESHES, the replicas once (rows a
    multiple of 8 elements, runs from index 0: the route whose runs stay in
    their rows), then SHARD_RAGGED's blocks (rows of 769 and of 3 elements,
    a 4-dim leaf) and train's o/w blocks at an odd offset (their runs cross
    rows: the other route).
    (a) counter_noise draws each block at train's step-0 key (Gaussian) and
        at a tree's t = 3 (hi 2 + lo 1 keys: 2 draws), written in place over
        the block inside a zeroed guard of GUARD elements each side; each
        block bitwise the same block of the whole-leaf launch, bitwise the
        plain version on the card (``counter_noise.plain`` at the block's
        geometry), and the guard untouched (the block's elements drawn,
        not the leaf's);
    (b) noise_update at both key sets updates each block (AdamW, SGD, and
        FTRL's ordinary step; p in the leaf's dtype, f32 state): p and the
        state bitwise the same block of the whole-leaf launch's; from m = v
        = 0 with b1 = 0 the m it writes bitwise the plain version's noised
        gradient; FTRL's s, m and t0 bitwise the plain chain's;
    (c) the timing of BLOCK_TIMING's rank: each kernel over its blocks of
        train's leaves (one key, AdamW) by the block route, and by the
        contiguous route over tensors of the blocks' shapes (the same
        elements, each block taken as a whole leaf), with the bound of the
        blocks' elements (BLOCK_ROW)."""
    import itertools

    import torch
    from repro_torch.configs.registry import build
    from repro_torch.core import noise
    from repro_torch.core.policy import resolve_policy
    from repro_torch.kernels import counter_noise as cn
    from repro_torch.kernels import noise_update as nu
    from repro_torch.kernels.sass import draws
    from repro_torch.launch import sharding as sh
    from repro_torch.utils.tree import flatten, unflatten

    dev = torch.device("cuda")
    f32 = torch.float32
    cfg, policy = run_config("train")
    params = flatten(build(cfg).init(0, dev))
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in params.items()}
    del params
    like = unflatten({k: torch.empty(s, device="meta")
                      for k, (s, _) in shapes.items()})
    res = resolve_policy(policy, list(shapes))
    rng = noise.fold_in(noise.prng_key(1), 0)      # train's step 0
    alpha = policy.sigma * res.sensitivity
    denom = float(RUNS["train"]["batch"])
    tree = noise.TreeAggregationMechanism(seed=3, depth=10)
    hypers = {"adamw": nu.AdamW(3e-4, 0.9, 0.999, 1e-8, 0.1, 0.001, 0.0),
              "sgd": nu.SGD(3e-4, 0.9, 0.0), "ftrl": nu.FTRL(3e-4, 0.9)}
    fresh_peak()

    def update(rec, state, hp, shift=0):
        p, m, v, t0 = (shifted(t.clone(), shift) for t in state)
        nu.noise_update(rec, p, m, v, hp, t0=t0)
        return p, m, v, t0

    def leaf_blocks(label, path, shape, dtype, blocks, count, shift=0):
        """Every check of (a) and (b) at each of ``blocks`` ({offsets:
        local shape}) of one leaf; ``shift``: every operand that many
        elements into its buffer."""
        g = rnd(*shape, dtype=dtype)
        state = (rnd(*shape, dtype=f32).mul_(0.02).to(dtype),
                 rnd(*shape, dtype=f32).mul_(1e-2),
                 rnd(*shape, dtype=f32).square_().mul_(1e-4),
                 rnd(*shape, dtype=f32).mul_(0.02))
        for kind, hi, lo in (("gaussian", [noise._path_rng(rng, path)], []),
                             ("tree t=3", tree.node_keys(path, 3),
                              tree.node_keys(path, 2))):
            whole_g = cn.counter_noise(g, hi, lo, alpha, denom)
            geo_w = noise.geometry(shape)
            rec_w = noise.NoisedLeaf(g, tuple(hi), tuple(lo), alpha, denom,
                                     geo_w.start, geo_w.trail)
            whole = {opt: update(rec_w, state, hp)
                     for opt, hp in hypers.items()}
            for offs, local in sorted(blocks.items()):
                cut = tuple(slice(o, o + n) for o, n in zip(offs, local))
                gb = g[cut].contiguous()
                n = gb.numel()
                geo = noise.geometry(local, offs, shape)
                count["block_route"] += not geo.contiguous
                buf = torch.zeros(n + 2 * GUARD + shift, dtype=dtype,
                                  device=dev)
                at = GUARD + shift
                buf[at:at + n] = gb.view(-1)
                out = cn.counter_noise(buf[at:at + n].view(local), hi, lo,
                                       alpha, denom, offs, shape,
                                       inplace=True)
                want = cn.plain(gb, hi, lo, alpha, denom, geo.start,
                                geo.trail, geo.dims, geo.strides)
                ok = {"counter_noise_whole": torch.equal(out, whole_g[cut]),
                      "counter_noise_plain": torch.equal(out, want),
                      "drawn_elements": out.numel() == n and bool(
                          (buf[:at] == 0).all()
                          and (buf[at + n:] == 0).all())}
                del buf, out
                rec = noise.NoisedLeaf(shifted(gb, shift), tuple(hi),
                                       tuple(lo), alpha, denom, geo.start,
                                       geo.trail, geo.dims, geo.strides)
                sb = tuple(t[cut].contiguous() for t in state)
                for opt, hp in hypers.items():
                    got = update(rec, sb, hp, shift)
                    ok[f"{opt}_whole"] = all(
                        torch.equal(a, b[cut])
                        for a, b in zip(got, whole[opt]))
                    if opt == "ftrl":
                        pp, sp, mp, tp = (t.clone() for t in sb)
                        nu.plain(want, pp, sp, mp, hp, t0=tp)
                        ok["ftrl_plain"] = all(torch.equal(a, b) for a, b
                                               in zip(got[1:], (sp, mp, tp)))
                        del pp, sp, mp, tp
                    del got
                zk = shifted(torch.zeros(local, dtype=f32, device=dev), shift)
                nu.noise_update(rec, shifted(sb[0].clone(), shift), zk,
                                shifted(torch.zeros_like(zk), shift),
                                nu.AdamW(0.0, 0.0, 0.999, 1e-8, 1.0, 1.0))
                ok["noise_update_draws_plain"] = torch.equal(zk,
                                                             want.to(f32))
                del zk, want, rec, sb, gb
                count["blocks"] += 1
                count["elements"] += n
                if not all(ok.values()):
                    raise AssertionError(
                        f"shard blocks {label} {path} at {offs} ({kind}): "
                        f"{[k for k, v in ok.items() if not v]} not bitwise")
            del whole_g, whole
        del g, state
        torch.cuda.empty_cache()

    def rank_blocks(mesh, shape, spec):
        out = {}
        for c in itertools.product(*map(range, mesh)):
            local, offs = sh.local_block(shape, spec,
                                         _stand_in_mesh(mesh, c))
            out[offs] = local
        return out

    checks = ["counter_noise_whole", "counter_noise_plain", "drawn_elements",
              "adamw_whole", "sgd_whole", "ftrl_whole", "ftrl_plain",
              "noise_update_draws_plain"]
    for mesh in SHARD_MESHES:
        specs = sh.flat_param_pspecs(like, _stand_in_mesh(mesh, (0,) *
                                                          len(mesh)))
        t0 = time.perf_counter()
        count = dict(leaves=0, blocks=0, elements=0, block_route=0)
        for path, (shape, dtype) in sorted(shapes.items()):
            blocks = rank_blocks(mesh, shape, specs[path])
            if path in res.frozen or len(blocks) == 1:
                continue           # whole on every rank: the leaf's own rows
            count["leaves"] += 1
            leaf_blocks(str(mesh), path, shape, dtype, blocks, count)
        emit(phase="kernels", kernel="counter_noise, noise_update",
             case="shard blocks", mesh=list(mesh), **count, checks=checks,
             key_sets=["gaussian", "tree t=3 (2 draws)"], bitwise=True,
             runs_stay_in_rows=True, seconds=time.perf_counter() - t0,
             max_memory_allocated=torch.cuda.max_memory_allocated())
    # the route whose runs cross rows: rows not a multiple of 8 elements,
    # and operands at an odd offset
    t0 = time.perf_counter()
    count = dict(leaves=0, blocks=0, elements=0, block_route=0)
    for label, shape, dtype, spec, mesh, shift in SHARD_RAGGED:
        count["leaves"] += 1
        leaf_blocks(label, label, shape, getattr(torch, dtype),
                    rank_blocks(mesh, shape, spec), count, shift)
    o_w = "blocks/attn/o/w"
    spec = sh.flat_param_pspecs(like, _stand_in_mesh((2, 2), (0, 0)))[o_w]
    leaf_blocks("odd offset", o_w, shapes[o_w][0], shapes[o_w][1],
                rank_blocks((2, 2), shapes[o_w][0], spec), count, shift=1)
    count["leaves"] += 1
    emit(phase="kernels", kernel="counter_noise, noise_update",
         case="shard blocks, runs crossing rows",
         cases=[c[0] for c in SHARD_RAGGED] + ["train o/w (2,2), offset 1"],
         **count, checks=checks, bitwise=True,
         seconds=time.perf_counter() - t0)

    # ---- (c) the block route's time against the contiguous route's
    mesh, coords = BLOCK_TIMING
    rank = _stand_in_mesh(mesh, coords)
    specs = sh.flat_param_pspecs(like, rank)
    for name in ("counter_noise", "noise_update"):
        BLOCK_ROW[name] = dict(mesh=list(mesh), rank=list(coords), leaves=0,
                               block_route_leaves=0, elements=0,
                               block_ms=0.0, contiguous_ms=0.0, bound_ms=0.0)
    hp = hypers["adamw"]
    for path, (shape, dtype) in sorted(shapes.items()):
        if path in res.frozen:
            continue
        local, offs = sh.local_block(shape, specs[path], rank)
        geo = noise.geometry(local, offs, shape)
        gb = rnd(*local, dtype=dtype)
        n = gb.numel()
        key = [noise._path_rng(rng, path)]
        p, m, v = (rnd(*local, dtype=f32).mul_(0.02).to(dtype),
                   rnd(*local, dtype=f32).mul_(1e-2),
                   rnd(*local, dtype=f32).square_().mul_(1e-4))
        rec_b = noise.NoisedLeaf(gb, tuple(key), (), alpha, denom, geo.start,
                                 geo.trail, geo.dims, geo.strides)
        whole = noise.geometry(local)
        rec_c = noise.NoisedLeaf(gb, tuple(key), (), alpha, denom,
                                 whole.start, whole.trail)
        runs = {"counter_noise": (
                    lambda: cn.counter_noise(gb, key, [], alpha, denom, offs,
                                             shape),
                    lambda: cn.counter_noise(gb, key, [], alpha, denom),
                    bound(2 * n * gb.element_size(),
                          THREEFRY["draw_ops"] * n, "int32")[0]),
                "noise_update": (
                    lambda: nu.noise_update(rec_b, p, m, v, hp),
                    lambda: nu.noise_update(rec_c, p, m, v, hp),
                    bound(n * (3 * gb.element_size() + 16),
                          THREEFRY["draw_ops"] * n * draws(key, []),
                          "int32")[0])}
        for name, (block, contiguous, b_ms) in runs.items():
            row = BLOCK_ROW[name]
            ms_b, ms_c = cuda_ms(block, reps=5), cuda_ms(contiguous, reps=5)
            row["leaves"] += 1
            row["block_route_leaves"] += not geo.contiguous
            row["elements"] += n
            row["block_ms"] += ms_b
            row["contiguous_ms"] += ms_c
            row["bound_ms"] += b_ms
            emit(phase="kernels", kernel=name, case="shard block timing",
                 path=path, mesh=list(mesh), rank=list(coords),
                 block=list(local), offsets=list(offs),
                 geometry=[geo.start, list(geo.dims), list(geo.strides)],
                 route="contiguous" if geo.contiguous else "block",
                 elements=n, block_ms=ms_b, contiguous_ms=ms_c,
                 bound_ms=b_ms)
        del gb, p, m, v, rec_b, rec_c
        torch.cuda.empty_cache()
    for name, row in BLOCK_ROW.items():
        emit(phase="kernels", kernel=name, case="shard block route", **row,
             block_over_contiguous=row["block_ms"] / row["contiguous_ms"])


def bf16_ulp_gap(a, b):
    """|a - b| in bf16 ulps, elementwise (two bf16 tensors)."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int16).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def p_rounding_excess(p, want32, tol) -> float:
    """How far a bf16 ``p`` lies beyond what rounding ``want32`` (f32, the
    exact-step reference) allows: the largest of |p - want32| - (half of
    p's bf16 ulp + atol + rtol * |want32|); <= 0 when every element is one
    of the two bf16 values around a value within f32 TOL of want32. The
    ulp is the spacing above |p|, which covers a value rounded up to a
    power of two."""
    import torch
    rtol, atol = tol
    mag = p.abs().contiguous()
    up = (mag.view(torch.int16) + 1).view(torch.bfloat16).float() \
        - mag.float()
    err = (p.float() - want32).abs_().sub_(up.mul_(0.5))
    return float(err.sub_(want32.abs().mul_(rtol).add_(atol)).max())


def ulp_gap(a, b):
    """|a - b| in f32 ulps, elementwise (the distance of the ordered bit
    patterns of a and b as f32)."""
    import torch

    def ordered(x):
        i = x.float().contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def counter_noise_checks(record, rnd):
    """counter_noise on the card (``phase_kernels``' rows of it):
    (a) the threefry2x32 known answers and the golden file's keys and bits
        through ``dp_threefry_bits``, then 2^26 random counters against the
        plain threefry2x32 on the card, bitwise;
    (b) ``dp_ndtri_f32`` over all 2^24 uniforms against the plain ndtri
        on the card (within NOISE_ULP) and against float64 (scipy; within
        NDTRI_F64_REL relative); every value finite;
    (c) the kernel against its plain version at every leaf of ``train``
        (its shapes, bf16, under train's step-0 keys and scale), at train's
        three largest leaves in f32, at a ragged f32 and a ragged bf16
        leaf, and at two steps of a depth-10 tree with completion (one its
        completed epoch end); its one-key draws within NOISE_ULP of the
        plain version's, its outputs equal to the plain version's wherever
        the draws are (and within TOL elsewhere), bitwise run to run; the
        tree's ``add_leaf`` on the card bitwise the direct launch; the
        bound's integer operations are the build phase's SASS count of a
        threefry2x32 block (``threefry_sass``) a key;
    (d) the golden (JAX) normals, one-element windows and the 8-element
        window past 2^32, within GOLDEN_ULP;
    (e) each train leaf's kernel time by CUDA events, the plain version's
        time and the chain it replaces (randn, then multiply, add and
        divide); the kernel's device time is ``train``'s profiled step's
        (the summary's ``train_step_device_ms``)."""
    import numpy as np
    import scipy.special
    import torch
    from repro_torch.configs.registry import build, get_config
    from repro_torch.core import noise
    from repro_torch.core.policy import resolve_policy
    from repro_torch.kernels import counter_noise as cn
    from repro_torch.kernels.sass import draws
    from repro_torch.utils.tree import flatten

    dev = torch.device("cuda")
    name = "counter_noise"
    i64 = torch.int64
    golden = json.loads(NOISE_GOLDEN.read_text())["triples"]

    # ---- (a) bits
    rows = torch.tensor([[*k, *c] for k, c, _ in THREEFRY_KATS], dtype=i64,
                        device=dev)
    kats = [tuple(r) for r in cn.threefry_bits(rows).tolist()] == \
        [w for _, _, w in THREEFRY_KATS]
    keys_ok, rows, want_bits = True, [], []
    for t in golden:
        base = noise.prng_key(t["seed"] + 1)
        skey = noise.fold_in(base, t["step"])
        key = noise._path_rng(skey, t["path"])
        keys_ok = keys_ok and [list(base), list(skey), list(key)] == \
            [t["base_key"], t["step_key"], t["key"]]
        for v in t["values"]:
            _, trail, _ = noise.counter_split(v["full_shape"])
            rows.append([*key, v["index"] % trail, v["index"] // trail])
            want_bits.append(v["bits"])
    bits = cn.threefry_bits(torch.tensor(rows, dtype=i64, device=dev))
    golden_bits = bits[:, 0].tolist() == want_bits
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    words = torch.randint(0, 1 << 32, (1 << 26, 4), generator=gen,
                          device=dev, dtype=i64)
    got = cn.threefry_bits(words)
    want = torch.stack(noise.threefry2x32(*words.unbind(1)), 1)
    bad = int((got != want).any(1).sum())
    emit(phase="kernels", kernel=name, case="threefry2x32 bits",
         known_answers=kats, golden_keys=keys_ok, golden_bits=golden_bits,
         golden_values=len(want_bits), random_counters=words.shape[0],
         mismatches=bad,
         kernel_ms=cuda_ms(lambda: cn.threefry_bits(words), reps=5))
    if not (kats and keys_ok and golden_bits and bad == 0):
        raise AssertionError(f"{name}: threefry2x32 bits disagree (known "
                             f"answers {kats}, golden keys {keys_ok}, "
                             f"golden bits {golden_bits}, {bad} random)")
    del words, got, want

    # ---- (b) ndtri over every uniform the counter gives
    u = noise.uniform(torch.arange(1 << 24, dtype=i64, device=dev) << 8)
    plain_z = noise.ndtri(u)
    f64 = torch.from_numpy(scipy.special.ndtri(
        u.double().cpu().numpy())).to(dev)

    def rel64(z):      # u = 0.5 is a value (m = 2^23 rounds to it): 0 / 0
        diff = (z.double() - f64).abs()
        return float(torch.where(diff == 0, 0.0, diff / f64.abs()).max())

    z = cn.ndtri_f32(u)
    gap = ulp_gap(z, plain_z)
    mine = {"finite": bool(torch.isfinite(z).all()),
            "max_ulp_vs_plain": int(gap.max()),
            "ulp_hist_vs_plain": torch.bincount(gap.clamp_max(16)).tolist(),
            "f64_max_rel": rel64(z)}
    emit(phase="kernels", kernel=name, case="ndtri all 2^24 uniforms",
         **mine, plain_f64_max_rel=rel64(plain_z),
         plain_finite=bool(torch.isfinite(plain_z).all()),
         ulp_bound=NOISE_ULP, f64_bound=NDTRI_F64_REL)
    if not (mine["finite"] and mine["max_ulp_vs_plain"] <= NOISE_ULP
            and mine["f64_max_rel"] <= NDTRI_F64_REL):
        raise AssertionError(f"{name}: ndtri out of bounds: {mine}")
    del u, plain_z, f64, z, gap

    # ---- (c), (e) the kernel against its plain version, and its times
    def case(label, path, shape, dtype, hi, lo, alpha, denom, timed,
             offset=0, inplace=False):
        # offset: g a view that many elements into its buffer (a leaf whose
        # address breaks the runs' alignment); inplace: written over a fresh
        # such view each call, so that g and out share that address
        g = shifted(rnd(*shape, dtype=dtype), offset)
        if inplace:
            call = (lambda: cn.counter_noise(shifted(g, offset), hi, lo,
                                             alpha, denom, inplace=True))
        else:
            call = (lambda: cn.counter_noise(g, hi, lo, alpha, denom))
        out, again = call(), call()
        want = cn.plain(g, hi, lo, alpha, denom)
        zero = torch.zeros(shape, dtype=torch.float32, device=dev)
        xi_k = cn.counter_noise(zero, hi, lo, 1.0, 1.0)
        xi_p = cn.plain(zero, hi, lo, 1.0, 1.0)
        gap = int(ulp_gap(xi_k, xi_p).max())
        xi_err = float((xi_k - xi_p).abs().max())
        # where the draws agree bitwise, both versions round the same f32
        # or bf16 operations: the outputs must be equal there
        same = xi_k == xi_p
        unequal = int(((out != want) & same).sum())
        extra = {"keys": len(hi) + len(lo), "dtype": str(dtype)[6:],
                 "draws_max_ulp" if len(hi) + len(lo) == 1 else
                 "xi_max_ulp": gap, "xi_max_abs_err": xi_err,
                 "draws_unequal": int(same.numel() - same.sum()),
                 "out_unequal_where_draws_equal": unequal,
                 "bitwise_plain": bool(torch.equal(out, want)),
                 "offset": offset, "inplace": inplace}
        del zero, xi_k, xi_p, same
        if len(hi) + len(lo) == 1 and gap > NOISE_ULP:
            raise AssertionError(f"{name} [{label}]: draws {gap} ulp from "
                                 "the plain version's")
        if unequal:
            raise AssertionError(f"{name} [{label}]: {unequal} outputs "
                                 "differ from the plain version's where "
                                 "their draws are equal")
        # the draw is the plain version's device functions on the card
        # (bitwise already when it was drawn one thread an element,
        # designs/counter_noise_per_element.cu): the warp-compacted draw
        # must keep that
        if not extra["bitwise_plain"]:
            raise AssertionError(f"{name} [{label}]: output not bitwise the "
                                 "plain version's")
        ms_k = ms_p = None
        if timed:
            ms_k = cuda_ms(call, reps=5)
            # warm: the plain version ran just above
            ms_p = cuda_ms(lambda: cn.plain(g, hi, lo, alpha, denom),
                           reps=1, warmup=0)
            extra["composed_ms"] = cuda_ms(lambda: (g + alpha * torch.randn(
                shape, generator=gen, device=dev).to(dtype)) / denom,
                reps=5)
        n = g.numel()
        record(name, path, f"{label} {tuple(shape)} {str(dtype)[6:]}", out,
               want, TOL[str(dtype)[6:]], ms_k, ms_p,
               2 * n * g.element_size(),
               THREEFRY["draw_ops"] * n * draws(hi, lo), "int32",
               again=again, timed=timed, **extra)
        del g, out, again, want
        torch.cuda.empty_cache()

    cfg, policy = run_config("train")
    params = flatten(build(cfg).init(0, dev))
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in params.items()}
    del params
    res = resolve_policy(policy, list(shapes))
    rng = noise.fold_in(noise.prng_key(1), 0)      # train's step 0
    alpha = policy.sigma * res.sensitivity
    denom = float(RUNS["train"]["batch"])
    fresh_peak()
    for path, (shape, dtype) in sorted(shapes.items()):
        if path not in res.frozen:
            case(f"train {path}", "train", shape, dtype,
                 [noise._path_rng(rng, path)], [], alpha, denom, True)
    largest = sorted(shapes, key=lambda k: -math.prod(shapes[k][0]))[:3]
    for path in largest:
        case(f"train {path}", "f32", shapes[path][0], torch.float32,
             [noise._path_rng(rng, path)], [], alpha, denom, False)
    case("ragged", "ragged", (3, 1001), torch.float32, [(7, 11)], [], 0.7,
         3.0, False)
    case("ragged", "ragged", (28, 3, 1537), torch.bfloat16, [(7, 12)], [],
         0.7, 3.0, False)
    # an odd offset: g alone (no index where g and out are both aligned: one
    # element a thread), and in place (both: a head of 7, then runs)
    case("unaligned", "ragged", (3, 4099), torch.bfloat16, [(7, 13)], [],
         0.7, 3.0, False, offset=1)
    case("unaligned in place", "ragged", (3, 4099), torch.bfloat16,
         [(7, 13)], [], 0.7, 3.0, False, offset=1, inplace=True)
    case("unaligned in place", "ragged", (5, 999), torch.float32, [(7, 14)],
         [], 0.7, 3.0, False, offset=3, inplace=True)
    tree = noise.TreeAggregationMechanism(seed=3, depth=10,
                                          restart_every=100, completion=True)
    for step in (54, 99):        # t = 55; t = 100 = E: completed to 128
        epoch, t, t_hi = tree._local_prefix(1.0, step)
        hi = tree.node_keys("blocks/mlp/up/w", t_hi, epoch)
        lo = tree.node_keys("blocks/mlp/up/w", t - 1, epoch)
        case(f"tree depth 10 completion step {step} t_hi {t_hi}", "tree",
             (4096, 1536), torch.float32, hi, lo, 1.3, 8.0, False)
        g = rnd(4096, 1536, dtype=torch.float32)
        if not torch.equal(
                tree.add_leaf("blocks/mlp/up/w", g, None, 1.0, 1.3, 8.0,
                              step=step),
                cn.counter_noise(g, hi, lo, 1.3, 8.0)):
            raise AssertionError(f"{name}: the tree's add_leaf is not its "
                                 "keys' launch")
        del g

    # ---- (d) the golden normals, one launch a value, and the window
    worst, n = 0, 0
    for t in golden:
        key = tuple(t["key"])
        for v in t["values"]:
            full = tuple(v["full_shape"])
            off = np.unravel_index(v["index"], full)
            z = cn.counter_noise(torch.zeros((1,) * len(full), device=dev),
                                 [key], [], 1.0, 1.0, offsets=off,
                                 full_shape=full)
            want = cn._as_int32(torch.tensor([v["normal_bits"]])).view(
                torch.float32).to(dev)
            worst = max(worst, int(ulp_gap(z.reshape(-1), want).max()))
            n += 1
        window = [v for v in t["values"] if v["index"] >= 1 << 32]
        if window:
            full = tuple(window[0]["full_shape"])
            off = np.unravel_index(window[0]["index"], full)
            z = cn.counter_noise(torch.zeros(1, len(window), device=dev),
                                 [key], [], 1.0, 1.0, offsets=off,
                                 full_shape=full)
            want = cn._as_int32(torch.tensor(
                [v["normal_bits"] for v in window])).view(
                torch.float32).to(dev)
            worst = max(worst, int(ulp_gap(z.reshape(-1), want).max()))
    emit(phase="kernels", kernel=name, case="golden normals", values=n,
         max_ulp=worst, bound=GOLDEN_ULP)
    if worst > GOLDEN_ULP:
        raise AssertionError(f"{name}: golden normals {worst} ulp off")


# the profiler ranges of a train step (core/bk.py, launch/steps.py): the
# device time of the kernels launched inside each
RANGES = ("bk_phases_1_3", "phase4_update")


# noise_update's library yardstick, as the noise checks found it
LIBRARY_NOTE = {}
# noise_update's FTRL branch over train's leaves (bf16; a restart step at
# 1 key, an ordinary one at 3 keys, 2 draws), summed by step kind:
# {"ordinary" | "restart": {keys, draws, leaves, elements, ms, plain_ms,
# bound_ms, max_abs_err}}; set by the noise checks
FTRL_ROW = {}


def noise_update_checks(record, rnd):
    """noise_update on the card (``phase_kernels``' rows of it), each case
    from one state (m, v, p from a seed) run by the kernel twice and by
    its plain version (``counter_noise.plain``, then the torch chain):
    (a) every leaf of ``train`` (bf16, AdamW, train's step-0 keys and
        scale), train's three largest leaves with f32 g and p (AdamW,
        weight decay 0.1), ragged f32 and bf16 leaves (SGD and AdamW,
        weight decay 0 and > 0), a leaf a view at an odd offset (every
        operand: a head of 7 elements, then runs) and one whose operands
        disagree on alignment (one element a thread), two steps of a
        depth-10 tree with completion, and no noise (a tensor taken as
        given, AdamW and SGD);
    (b) m and v within f32 TOL of the plain version's (the largest ulp gap
        reported), p within its dtype's TOL (bf16: the elements one ulp and
        more off counted); m, v and p bitwise run to run;
    (c) the draws bitwise: from m = v = 0 with b1 = 0 the m it writes is
        ``counter_noise``'s output on the same record, widened to f32;
    (d) at train's leaves: the kernel's time by CUDA events beside the
        plain version's and ``torch._fused_adamw_``'s on the same noised
        gradients (the one PyTorch call for the step; on f32 copies where
        it refuses bf16 params with f32 moments), and the bound (22 bytes
        an element at bf16; the draw's integer operations from the build
        phase's SASS count)."""
    import torch
    from repro_torch.configs.registry import build
    from repro_torch.core import noise
    from repro_torch.core.policy import resolve_policy
    from repro_torch.kernels import counter_noise as cn
    from repro_torch.kernels import noise_update as nu
    from repro_torch.kernels.design_study import fused_adamw_takes_mixed
    from repro_torch.kernels.sass import draws
    from repro_torch.utils.tree import flatten

    dev = torch.device("cuda")
    name = "noise_update"
    f32, bf16 = torch.float32, torch.bfloat16
    mixed = fused_adamw_takes_mixed()
    LIBRARY_NOTE[name] = (
        "torch._fused_adamw_ over the noised leaves" + (
            "" if mixed else " on f32 copies of p and the noised gradient "
            "(it refuses bf16 params with f32 moments)"))
    emit(phase="kernels", kernel=name, case="library yardstick",
         fused_adamw_takes_bf16_params_f32_moments=mixed)

    def adamw(wd, step=0, b1=0.9):
        t = step + 1
        return nu.AdamW(3e-4, b1, 0.999, 1e-8, 1.0 - b1 ** t,
                        1.0 - 0.999 ** t, wd)

    def case(label, path, shape, g_dt, p_dt, hi, lo, alpha, denom, hp,
             timed=False, noisy=True, offsets=(0, 0, 0)):
        # offsets: of g, p and (m, v) in their buffers
        g = shifted(rnd(*shape, dtype=g_dt), offsets[0])
        start, trail = cn.window(g.shape)
        rec = noise.NoisedLeaf(g, tuple(hi), tuple(lo), alpha, denom,
                               start, trail) if noisy else g
        m0 = rnd(*shape, dtype=f32).mul_(1e-2)
        v0 = rnd(*shape, dtype=f32).square_().mul_(1e-4)
        p0 = rnd(*shape, dtype=f32).mul_(0.02).to(p_dt)
        adam = isinstance(hp, nu.AdamW)

        def fresh():
            return (shifted(p0.clone(), offsets[1]),
                    shifted(m0.clone(), offsets[2]),
                    shifted(v0.clone(), offsets[2]) if adam else None)

        runs = []
        for _ in range(2):
            pk, mk, vk = fresh()
            nu.noise_update(rec, pk, mk, vk, hp)
            runs.append((pk, mk, vk))
        torch.cuda.synchronize()
        (pk, mk, vk), (p2, m2, v2) = runs
        repeat = torch.equal(pk, p2) and torch.equal(mk, m2) and (
            not adam or torch.equal(vk, v2))
        del runs, p2, m2, v2
        pp, mp, vp = fresh()
        # p in f32: the plain version's update before p's own rounding (a
        # bf16 p is exact in f32, and the chain widens it first)
        pp32 = pp.float()
        nu.plain(rec, pp32, mp, vp, hp)
        pp = pp32.to(p_dt)
        extra = {"dtype": f"g {str(g_dt)[6:]} p {str(p_dt)[6:]}",
                 "optimizer": type(hp).__name__,
                 "weight_decay": hp.weight_decay, "noise": noisy,
                 "keys": len(hi) + len(lo) if noisy else 0,
                 "draws": draws(hi, lo) if noisy else 0,
                 "offsets": list(offsets), "state_bitwise_repeat": repeat}
        bad = []
        for key, got, want in (("m", mk, mp), ("v", vk, vp)):
            if got is None:
                continue
            cmp = compare(got, want, TOL["float32"])
            extra[f"{key}_max_abs_err"] = cmp["max_abs_err"]
            extra[f"{key}_max_ulp"] = int(ulp_gap(got, want).max())
            if not cmp["ok"]:
                bad.append(key)
        del mp, vp
        if p_dt == bf16:
            gap = bf16_ulp_gap(pk, pp)
            extra["p_bf16_one_ulp_off"] = int((gap == 1).sum())
            extra["p_bf16_over_one_ulp_off"] = int((gap > 1).sum())
            del gap
            # the step itself (lr * update, ~2e-4 against p ~ 0.02, a few
            # bf16 ulps) held as the rounding allows: p within half a bf16
            # ulp of the plain version's f32 p, plus f32 TOL for the
            # step's own arithmetic; a kernel that drops p's store, lr or
            # the update's sign is off by the step itself
            over = p_rounding_excess(pk, pp32, TOL["float32"])
            extra["p_bf16_rounding_excess"] = over
            if over > 0:
                bad.append("p")
        else:
            extra["p_max_ulp"] = int(ulp_gap(pk, pp).max())
        del pp32
        if noisy:
            # the draws: m = v = 0, b1 = 0 -> m is the noised gradient
            zk = torch.zeros(shape, dtype=f32, device=dev)
            nu.noise_update(rec, p0.clone(), zk, torch.zeros_like(zk),
                            nu.AdamW(0.0, 0.0, 0.999, 1e-8, 1.0, 1.0, 0.0))
            want_g = cn.counter_noise(g, hi, lo, alpha, denom)
            extra["draws_bitwise_counter_noise"] = bool(
                torch.equal(zk, want_g.to(f32)))
            del zk, want_g
        ms_k = ms_p = ms_lib = None
        n = g.numel()
        if timed:           # on fresh copies: pk, mk, vk are compared below
            q = fresh()
            ms_k = cuda_ms(lambda: nu.noise_update(rec, *q, hp), reps=5)
            q = fresh()
            ms_p = cuda_ms(lambda: nu.plain(rec, *q, hp), reps=1, warmup=0)
            del q
            gn = nu.gradient(rec) if noisy else g
            lib = [pk.clone(), gn.clone(), mk.clone(), vk.clone()]
            if not mixed:
                lib[0], lib[1] = lib[0].float(), lib[1].float()
            step_t = torch.ones((), device=dev)
            ms_lib = cuda_ms(lambda: torch._fused_adamw_(
                [lib[0]], [lib[1]], [lib[2]], [lib[3]], [], [step_t],
                lr=hp.lr, beta1=hp.b1, beta2=hp.b2,
                weight_decay=hp.weight_decay, eps=hp.eps, amsgrad=False,
                maximize=False), reps=5)
            del gn, lib
        es_g, es_p = g.element_size(), pk.element_size()
        nbytes = n * (es_g + 2 * es_p + (16 if adam else 8))
        ops = THREEFRY["draw_ops"] * n * draws(hi, lo) if noisy else 0
        record(name, path, f"{label} {tuple(shape)}", pk, pp,
               TOL[str(p_dt)[6:]], ms_k, ms_p, nbytes, ops, "int32",
               ms_lib=ms_lib, again=None, timed=timed, **extra)
        if bad or not repeat or not extra.get(
                "draws_bitwise_counter_noise", True):
            raise AssertionError(f"{name} [{label}]: {extra}, out of "
                                 f"TOL: {bad}")
        del g, rec, pk, mk, vk, pp, m0, v0, p0
        torch.cuda.empty_cache()

    cfg, policy = run_config("train")
    params = flatten(build(cfg).init(0, dev))
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in params.items()}
    del params
    res = resolve_policy(policy, list(shapes))
    rng = noise.fold_in(noise.prng_key(1), 0)      # train's step 0
    alpha = policy.sigma * res.sensitivity
    denom = float(RUNS["train"]["batch"])
    fresh_peak()
    for path, (shape, dtype) in sorted(shapes.items()):
        case(f"train {path}", "train", shape, dtype, dtype,
             [noise._path_rng(rng, path)], [], alpha, denom, adamw(0.0),
             timed=True, noisy=path not in res.frozen)
    largest = sorted(shapes, key=lambda k: -math.prod(shapes[k][0]))[:3]
    for path in largest:
        case(f"train {path}", "f32", shapes[path][0], f32, f32,
             [noise._path_rng(rng, path)], [], alpha, denom, adamw(0.1))
    sgd = nu.SGD(3e-4, 0.9, 0.0)
    case("ragged sgd", "ragged", (3, 1001), f32, f32, [(7, 11)], [], 0.7,
         3.0, sgd)
    case("ragged sgd wd", "ragged", (28, 3, 1537), bf16, bf16, [(7, 12)],
         [], 0.7, 3.0, nu.SGD(3e-4, 0.9, 0.01))
    case("ragged adamw", "ragged", (28, 3, 1537), bf16, bf16, [(7, 12)],
         [], 0.7, 3.0, adamw(0.0, step=5))
    case("unaligned adamw wd", "ragged", (3, 4099), bf16, bf16, [(7, 13)],
         [], 0.7, 3.0, adamw(0.1), offsets=(1, 1, 1))
    case("unaligned mixed sgd", "ragged", (3, 4099), bf16, bf16, [(7, 13)],
         [], 0.7, 3.0, sgd, offsets=(1, 0, 0))
    case("g bf16 p f32", "ragged", (3, 4099), bf16, f32, [(7, 15)], [],
         0.7, 3.0, adamw(0.1))
    tree = noise.TreeAggregationMechanism(seed=3, depth=10,
                                          restart_every=100, completion=True)
    for step in (54, 99):        # t = 55; t = 100 = E: completed to 128
        epoch, t, t_hi = tree._local_prefix(1.0, step)
        case(f"tree depth 10 completion step {step} t_hi {t_hi}", "tree",
             (4096, 1536), f32, f32,
             tree.node_keys("blocks/mlp/up/w", t_hi, epoch),
             tree.node_keys("blocks/mlp/up/w", t - 1, epoch), 1.3, 8.0,
             adamw(0.1, step=step))
    case("no noise adamw", "no_noise", (28, 1536, 256), bf16, bf16, [], [],
         0.0, 1.0, adamw(0.1), noisy=False)
    case("no noise sgd", "no_noise", (28, 1536, 256), bf16, bf16, [], [],
         0.0, 1.0, nu.SGD(3e-4, 0.9, 0.1), noisy=False)

    def ftrl_case(label, shape, g_dt, p_dt, hi, lo, restart, timed=False,
                  noisy=True, offsets=(0, 0, 0)):
        """noise_update's FTRL branch on one leaf (momentum 0.9): s, m and
        t0 bitwise the plain version's, p as the AdamW cases hold it,
        bitwise run to run; ``offsets``: of g, p and the state."""
        g = shifted(rnd(*shape, dtype=g_dt), offsets[0])
        start, trail = cn.window(g.shape)
        rec = noise.NoisedLeaf(g, tuple(hi), tuple(lo), alpha, denom,
                               start, trail) if noisy else g
        s0 = rnd(*shape, dtype=f32)
        m0 = rnd(*shape, dtype=f32)
        t00 = rnd(*shape, dtype=f32).mul_(0.02)
        p0 = rnd(*shape, dtype=f32).mul_(0.02).to(p_dt)
        hp = nu.FTRL(3e-4, 0.9, restart)

        def fresh():
            return (shifted(p0.clone(), offsets[1]),
                    shifted(s0.clone(), offsets[2]),
                    shifted(m0.clone(), offsets[2]),
                    shifted(t00.clone(), offsets[2]))

        def launch(q):
            nu.noise_update(rec, q[0], q[1], q[2], hp, t0=q[3])

        runs = []
        for _ in range(2):
            q = fresh()
            launch(q)
            runs.append(q)
        torch.cuda.synchronize()
        (pk, sk, mk, tk), again = runs
        repeat = all(torch.equal(a, b) for a, b in zip(runs[0], again))
        del runs, again
        pp, sp, mp, tp = fresh()
        pp32 = pp.float()
        nu.plain(rec, pp32, sp, mp, hp, t0=tp)
        pp = pp32.to(p_dt)
        extra = {"dtype": f"g {str(g_dt)[6:]} p {str(p_dt)[6:]}",
                 "optimizer": "FTRL", "restart": restart, "noise": noisy,
                 "keys": len(hi) + len(lo) if noisy else 0,
                 "draws": draws(hi, lo) if noisy else 0,
                 "offsets": list(offsets), "state_bitwise_repeat": repeat}
        bad = [k for k, got, want in (("s", sk, sp), ("m", mk, mp),
                                      ("t0", tk, tp))
               if not torch.equal(got, want)]
        extra["s_m_t0_bitwise_plain"] = not bad
        for key, got, want in (("s", sk, sp), ("m", mk, mp)):
            extra[f"{key}_max_ulp"] = int(ulp_gap(got, want).max())
        del sp, mp, tp
        if p_dt == bf16:
            gap = bf16_ulp_gap(pk, pp)
            extra["p_bf16_one_ulp_off"] = int((gap == 1).sum())
            extra["p_bf16_over_one_ulp_off"] = int((gap > 1).sum())
            del gap
            over = p_rounding_excess(pk, pp32, TOL["float32"])
            extra["p_bf16_rounding_excess"] = over
            if over > 0:
                bad.append("p")
        else:
            extra["p_max_ulp"] = int(ulp_gap(pk, pp).max())
        del pp32
        # the kernel alone: the plain chain, 3.4-6.6 s over train's leaves,
        # is timed on train's AdamW cases
        ms_k = ms_p = None
        if timed:
            q = fresh()
            ms_k = cuda_ms(lambda: launch(q), reps=5)
            del q
        n = g.numel()
        es_g, es_p = g.element_size(), pk.element_size()
        # an ordinary step reads the anchor and not p; a restart step reads
        # p and writes the anchor: g, p's write, s and m read and written,
        # t0 once, and p's read on a restart
        nbytes = n * (es_g + es_p + 20 + (es_p if restart else 0))
        ops = THREEFRY["draw_ops"] * n * draws(hi, lo) if noisy else 0
        path = "train_ftrl" if timed else "ftrl"
        record(name, path, f"ftrl {label} {tuple(shape)}", pk, pp,
               TOL[str(p_dt)[6:]], ms_k, ms_p, nbytes, ops, "int32",
               timed=timed, **extra)
        if timed:
            row = FTRL_ROW.setdefault(
                "restart" if restart else "ordinary",
                {"keys": extra["keys"], "draws": extra["draws"],
                 "leaves": 0, "elements": 0, "ms": 0.0, "plain_ms": None,
                 "bound_ms": 0.0, "max_abs_err": 0.0})
            row["leaves"] += 1
            row["elements"] += n
            row["ms"] += ms_k
            row["bound_ms"] += bound(nbytes, ops, "int32")[0]
            row["max_abs_err"] = max(row["max_abs_err"], float(
                (pk.float() - pp.float()).abs().max()))
        if bad or not repeat:
            raise AssertionError(f"{name} [ftrl {label}]: {extra}, not as "
                                 f"the plain version: {bad}")
        del g, rec, pk, sk, mk, tk, pp, s0, m0, t00, p0
        torch.cuda.empty_cache()

    # FTRL at every train leaf (bf16, timed) at the keys each step kind
    # has: a restart step is a tree's local t = 1 (node (0, 1), no lo
    # keys); the ordinary one is t = 3 of a tree with no restarts (nodes
    # (0, 3) and (1, 1) minus node (1, 1) of t - 1 = 2: 3 keys, 2 draws).
    # Then both step kinds at those 3 keys at train's three largest leaves
    # in f32, ragged and unaligned leaves, and without noise
    ftree = noise.TreeAggregationMechanism(seed=3, depth=10)
    for path, (shape, dtype) in sorted(shapes.items()):
        ftrl_case(f"train {path}", shape, dtype, dtype,
                  ftree.node_keys(path, 1), [], True, timed=True)
        ftrl_case(f"train {path}", shape, dtype, dtype,
                  ftree.node_keys(path, 3), ftree.node_keys(path, 2),
                  False, timed=True)
    for path in largest:
        for restart in (True, False):
            ftrl_case(f"train {path}", shapes[path][0], f32, f32,
                      ftree.node_keys(path, 3), ftree.node_keys(path, 2),
                      restart)
    for restart in (True, False):
        ftrl_case("ragged", (28, 3, 1537), bf16, bf16, [(7, 12), (7, 14)],
                  [(7, 16)], restart)
        ftrl_case("unaligned", (3, 4099), bf16, bf16, [(7, 13)], [],
                  restart, offsets=(1, 1, 1))
        ftrl_case("unaligned mixed", (3, 4099), bf16, f32, [(7, 13)], [],
                  restart, offsets=(1, 0, 0))
        ftrl_case("no noise", (28, 1536, 256), bf16, bf16, [], [], restart,
                  noisy=False)
    emit(phase="kernels", kernel=name, case="ftrl over train's leaves",
         **FTRL_ROW, library_ms=None,
         library="none: no single call computes the FTRL step")


def _range_device_ms(prof) -> dict:
    """Device ms of the kernels launched inside each host range of RANGES:
    each launch call on the host (the CUDA runtime's or driver's, by torch
    or by a ctypes kernel wrapper alike) that starts inside a range, and
    the kernel with its correlation id. (The profiler's own attribution,
    ``device_time_total``, follows torch ops only: it misses the port's
    ctypes launches.)"""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in events
             if e.device_type() == DeviceType.CPU and e.name() in RANGES]
    launched = {}
    for e in events:
        if e.device_type() == DeviceType.CPU and "Launch" in e.name():
            name = next((n for n, a, b in spans if a <= e.start_ns() <= b),
                        None)
            if name:
                launched[e.correlation_id()] = name
    out = dict.fromkeys(RANGES, 0.0)
    for e in events:
        if (e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
                and e.correlation_id() in launched):
            out[launched[e.correlation_id()]] += e.duration_ns() / 1e6
    return out


def _profile_summary(prof, window_ms: float) -> dict:
    """Device time of one profiled step, by kernel, by kind and by range
    (``_range_device_ms``; the ranges' own annotations on the device
    timeline are not kernels and are left out of the sums); the port's
    kernels each by name (``port_kernels_ms``: a SIMT kernel's name has no
    ``wgmma``)."""
    from torch.autograd import DeviceType
    by_name, ranges = {}, _range_device_ms(prof)
    for e in prof.events():
        if e.name in ranges:
            continue
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
    ours = tuple(f"{k}_kernel" for k in (
        "ghost_norm", "ghost_norm_wgmma", "clipped_grad",
        "clipped_grad_wgmma", "flash_wgmma", "emb_norm", "emb_grad",
        "emb_grad_mark", "reduce_rows",
        "grad_norm_direct", "dense_norm_wgmma", "moe_ghost_norm",
        "moe_direct_norm",
        "moe_clipped_grad", "moe_norm_wgmma", "moe_grad_wgmma",
        "fused_clip_wgmma", "fused_clip_simt", "counter_noise",
        "noise_update",
        "moe_ghost_wgmma", "flash_attention", "wkv6", "wkv6_state",
        "wkv6_out", "wkv6_bwd", "wkv6_bwd_sum"))
    kinds = {"port_kernels": 0.0, "gemm": 0.0, "other": 0.0}
    noise_ms = update_ms = 0.0
    port = {}
    for name, ms in by_name.items():
        low = name.lower()
        kind = ("port_kernels" if any(k in name for k in ours) else
                "gemm" if any(k in low for k in ("gemm", "cutlass", "nvjet",
                                                 "sm90_", "cublas"))
                else "other")
        kinds[kind] += ms
        if kind == "port_kernels":
            port[name[:60]] = port.get(name[:60], 0.0) + ms
        if "counter_noise_kernel" in name:
            noise_ms += ms
        if "noise_update_kernel" in name:
            update_ms += ms
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"window_ms": window_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / window_ms),
            "by_kind_ms": kinds, "by_range_ms": ranges,
            "port_kernels_ms": port,
            "counter_noise_ms": noise_ms, "noise_update_ms": update_ms,
            "top_kernels_ms": [[n[:90], ms] for n, ms in top]}


def bk_norm_counts(name) -> dict:
    """The norm kernels a step of a train path launches under mode 'bk''s
    plan (``core.bk.plan_report``: one a tap, ghost or direct by its
    ParamGroup override): what the ghostclip baseline launches."""
    import torch
    from repro_torch.configs.registry import build
    from repro_torch.core.bk import plan_report
    from repro_torch.core.tape import parse_key
    from repro_torch.data.synthetic import make_batch
    cfg, dp = run_config(name)
    run = RUNS[name]
    model = build(cfg)
    params = model.init(0, "cuda")
    batch = make_batch(cfg, run["batch"], run["seq"], 0, 0, "cuda")
    report = plan_report(model.apply, params, batch,
                         dataclasses.replace(dp, mode="bk"))
    del params, batch
    torch.cuda.empty_cache()
    counts = _per_step()
    for key, plans in report.items():
        counts[NORM_KERNEL[parse_key(key)[1], plans["norm"].method]] += 1
    return counts


def saved_by_kind(cfg, params, run, peak: int) -> dict:
    """The bytes autograd saves in one BK forward of a train path's model
    (phase 1 up to its backward: the vector params per sample, a tap on
    every op, as ``core.bk.tapped_backward`` runs it), each storage counted
    once, by the function that saved it: ``_attend`` (the attention's f32
    probabilities and their operands), ``ssd`` (the SSM's chunk tensors)
    and the rest; beside the params' bytes and AdamW's f32 moments (two a
    param) and the train step's ``peak``. Where blocks remat (the tape's
    ``remat`` keys), a remat block's own saves go to checkpoint's hooks
    and are recomputed in the backward, so the kinds count only what is
    saved outside those blocks
    (``saved_outside_remat_blocks_by_kind``); beside them what remat keeps:
    each remat block's inputs (checkpoint holds its arguments; the params'
    slices are views), the tape's records, the bytes of the tap outputs
    that the tape's targets (autograd edges) do not hold, and the
    backward's peak over the forward's allocation, the blocks' recompute
    included."""
    import torch
    from repro_torch.core.tape import Tape
    from repro_torch.data.synthetic import make_batch
    from repro_torch.configs.registry import build
    from repro_torch.models import attention, ssm
    from repro_torch.utils.tree import flatten, unflatten

    kind, seen = ["rest"], {}

    def tagged(fn, name, module):
        def run_tagged(*a, **kw):
            kind.append(name)
            try:
                return fn(*a, **kw)
            finally:
                kind.pop()
        setattr(module, fn.__name__, run_tagged)

    def pack(t):
        st = t.untyped_storage()
        seen.setdefault(st.data_ptr(), (kind[-1], st.nbytes()))
        # the storage stays saved, but not the tensor: a node holding its
        # own output (and so itself) would be a cycle through C++ that
        # the garbage collector cannot see
        return t.detach()

    flat = {k: v.detach() for k, v in flatten(params).items()}
    B = run["batch"]
    batch = make_batch(cfg, B, run["seq"], 0, 0, "cuda")
    psp = {k: v.expand(B, *v.shape).clone().requires_grad_()
           for k, v in flat.items() if not k.endswith("/w")}
    owned = {v.untyped_storage().data_ptr()
             for v in (*flat.values(), *psp.values())}
    inputs = {}
    block = Tape.block

    def block_inputs(self, fn, *args, remat=False):
        # the storages a remat block's checkpoint keeps as its arguments
        for a in args if remat else ():
            if isinstance(a, torch.Tensor):
                st = a.untyped_storage()
                if st.data_ptr() not in owned:
                    inputs.setdefault(st.data_ptr(), st.nbytes())
        return block(self, fn, *args, remat=remat)

    attend, ssd = attention._attend, ssm.ssd
    tagged(attend, "attention", attention)
    tagged(ssd, "ssm_chunks", ssm)
    Tape.block = block_inputs
    before = torch.cuda.memory_allocated()
    tape = Tape(active=lambda k: True, per_sample=psp)
    try:
        with torch.enable_grad(), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            losses = build(cfg).apply(unflatten({**flat, **psp}), batch,
                                      tape)
        after = torch.cuda.memory_allocated()
    finally:
        attention._attend, ssm.ssd = attend, ssd
        Tape.block = block
    by_kind = {}
    for k, n in seen.values():
        by_kind[k] = by_kind.get(k, 0) + n
    # the tape's remat keys: taps recorded inside a remat block (none for
    # whisper, which ignores cfg.remat as its reference does)
    remat = bool(tape.remat)
    out = {"saved_outside_remat_blocks_by_kind" if remat
           else "saved_bytes_by_kind": by_kind,
           "forward_allocated_bytes": after - before}
    if remat:
        targets = [t for v in tape.outs.values()
                   for t in (v if isinstance(v, list) else [v])]
        records = {}
        for v in flatten(tape.acts).values():
            st = v.untyped_storage()
            records.setdefault(st.data_ptr(), st.nbytes())
        torch.cuda.reset_peak_memory_stats()
        grads = torch.autograd.grad(losses.sum(),
                                    [t.edge for t in targets]
                                    + list(psp.values()), allow_unused=True)
        out.update(remat_block_inputs_bytes=sum(inputs.values()),
                   records_bytes=sum(records.values()),
                   tap_outputs_not_held_bytes=sum(
                       t.shape.numel() * t.dtype.itemsize for t in targets),
                   backward_peak_over_forward_bytes=(
                       torch.cuda.max_memory_allocated() - after))
        del grads, targets
    del losses, psp, batch, tape
    torch.cuda.empty_cache()
    n_params = sum(v.numel() for v in flat.values())
    return {**out, "params_bytes": sum(v.numel() * v.element_size()
                                       for v in flat.values()),
            "adamw_moments_bytes": 8 * n_params, "peak_bytes": peak}


def phase_train(name, stats: dict):
    """One train path through the train entry point -> launch totals.
    The last step runs under torch.profiler. ``stats[name]`` receives its
    step seconds (unprofiled: the step before the profiled one), profiled
    seconds, peak and profiled device time, for the paper's ratios."""
    import torch
    from repro_torch.configs.registry import has_policy
    from repro_torch.core.bk import BK_MODES
    from repro_torch.core.policy import as_policy, resolve_policy
    from repro_torch.launch.train import train, train_policy
    from repro_torch.utils.tree import flatten

    run = RUNS[name]
    cfg, dp = run_config(name, flags=False)
    if run.get("mode") == "ghostclip":
        planned = bk_norm_counts(name)
        if planned != run["per_step"]:
            raise AssertionError(f"{name}: mode 'bk''s plan launches "
                                 f"{planned}, want {run['per_step']}")
    ws = wrappers()
    tc = train_config(name)
    per_step, prof = [], {}

    def on_step(step, loss, seconds):
        counts = {k: w.launches for k, w in ws.items()}
        prev = per_step[-1]["total"] if per_step else dict.fromkeys(counts, 0)
        per_step.append({"step": step, "loss": loss, "seconds": seconds,
                         "launches": {k: counts[k] - prev[k] for k in counts},
                         "total": counts})
        if step == tc.steps - 2:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            prof["p"] = torch.profiler.profile(activities=acts)
            prof["p"].start()
            prof["t0"] = time.perf_counter()
        elif "p" in prof and step == tc.steps - 1:
            torch.cuda.synchronize()
            prof["ms"] = (time.perf_counter() - prof["t0"]) * 1e3
            prof["p"].stop()

    floor = fresh_peak()
    summary, logs = {}, []
    mesh_kw = {"mesh": run["mesh"]} if "mesh" in run else {}
    reset_counts(ws)                  # counts from here on are the path's
    # the params' sha256 only where a twin run is held to it (hashing
    # every param on the host takes seconds at these sizes)
    params, losses = train(cfg, tc, dp, device="cuda", log=logs.append,
                           on_step=on_step,
                           dataset_size=run.get("dataset_size", 0),
                           target_epsilon=run.get("epsilon", 0.0),
                           summary_out=summary,
                           digest="mesh" in run or run.get("remat_twin",
                                                           False),
                           **mesh_kw)
    torch.cuda.synchronize()
    totals = {k: w.launches for k, w in ws.items()}
    block = ws["noise_update"].block_launches
    wgmma = check_routes(name, ws, True, {
        k: n * tc.steps for k, n in run.get("simt", {}).items()})
    peak = torch.cuda.max_memory_allocated()
    for s in per_step:
        emit(phase=name, step=s["step"], loss=s["loss"],
             step_seconds=s["seconds"], launches=s["launches"])
    # the policy train ran (a flat DPConfig as its one-unit policy)
    ran = as_policy(train_policy(dp, tc))
    # phase 4: one noise_update launch a leaf a step on every path (the BK
    # step draws the noise inside it); counter_noise only where a baseline
    # materializes the noised tree: one launch a noised leaf (none without
    # noise)
    flat = flatten(params)
    want = dict(run["per_step"], noise_update=len(flat),
                counter_noise=0 if dp.mode in BK_MODES + ("nonprivate",)
                else len(resolve_policy(ran, flat).unit_of))
    memory = (saved_by_kind(cfg, params, run, peak)
              if cfg.family in ("hybrid", "encdec") else None)
    kept = ({k: v.cpu() for k, v in flat.items()}
            if run.get("remat_twin") else None)
    del params, flat
    emit(phase=name, arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab, dtype=cfg.param_dtype,
         mode=dp.mode,
         policy=cfg.name if has_policy(cfg.name) else "flat DPConfig",
         methods={g.name: g.method or "rule" for g in as_policy(dp).groups},
         scopes={g.name: g.scope for g in ran.groups},
         tape=ran.tape_policy,
         optimizer=tc.optimizer, batch=tc.global_batch, seq=tc.seq_len,
         steps=tc.steps, sigma=summary["ledger"]["entries"][0]["sigma"],
         epsilon_spent=summary["epsilon"], delta=summary["delta"],
         ledger=summary["ledger"], driver_log=[
             m for m in logs if not m.startswith("step ")],
         losses=losses, max_memory_allocated=peak,
         allocated_at_start=floor, launches=totals, wgmma_launches=wgmma,
         **({"memory": memory} if memory else {}))
    profile = _profile_summary(prof["p"], prof["ms"])
    emit(phase=f"{name}_profile", step=tc.steps - 1, **profile)
    stats[name] = {"step_seconds": per_step[-2]["seconds"],
                   "profiled_seconds": per_step[-1]["seconds"],
                   "peak_bytes": peak,
                   "device_busy_ms": profile["device_busy_ms"],
                   "counter_noise_ms": profile["counter_noise_ms"],
                   "noise_update_ms": profile["noise_update_ms"],
                   "phase4_ms": profile["by_range_ms"]["phase4_update"]}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss: {losses}")
    if peak >= run.get("peak_limit", math.inf):
        raise AssertionError(f"{name}: peak {peak} bytes at {cfg.n_layers} "
                             f"layers, want under {run['peak_limit']:.0f}")
    loss0 = math.log(cfg.vocab) + run.get("loss0_excess", 0.0)
    if abs(losses[0] - loss0) > 0.5:
        raise AssertionError(f"{name}: step-0 loss {losses[0]} is not near "
                             f"{loss0} (ln(vocab) = {math.log(cfg.vocab)})")
    for s in per_step:
        for k, n in s["launches"].items():
            if n != want[k]:
                raise AssertionError(f"{name} step {s['step']}: {k} launched "
                                     f"{n} times, want {want[k]}")
    if run.get("remat_twin"):
        remat_twin(name, cfg, tc, dp, kept, summary["params_sha256"],
                   peak, [s["seconds"] for s in per_step])
    if "mesh" in run:
        # the same steps without a mesh, in this phase: the same params
        plain = {}
        train(cfg, tc, dp, device="cuda", log=lambda m: None,
              summary_out=plain)
        fresh_peak()
        same = plain["params_sha256"] == summary["params_sha256"]
        emit(phase=name, mesh=list(run["mesh"]),
             backend=summary["mesh"]["backend"],
             block_launches=block, params_sha256=summary["params_sha256"],
             no_mesh_params_sha256=plain["params_sha256"], bitwise=same,
             epsilon=summary["epsilon"], no_mesh_epsilon=plain["epsilon"])
        if not (same and plain["epsilon"] == summary["epsilon"]):
            raise AssertionError(f"{name}: the mesh run's params or epsilon "
                                 "differ from the run without a mesh")
        # a world of one holds every leaf whole: the window route only
        if summary["mesh"]["backend"] != "nccl" or block:
            raise AssertionError(
                f"{name}: backend {summary['mesh']['backend']}, {block} "
                "block-route launches; want nccl and none")
    return totals


def remat_twin(name, cfg, tc, dp, kept: dict, sha: str, peak: int,
               seconds: list):
    """The steps of a train path again with ``remat=False``, from the same
    seed: its params against the remat run's (``kept``, on the host; its
    ``params_sha256`` ``sha``), bitwise or the largest difference, which
    must be within the bf16 TOL; both peaks and step seconds."""
    import torch
    from repro_torch.launch.train import train
    from repro_torch.utils.tree import flatten
    floor = fresh_peak()
    twin, twin_s = {}, []
    params, _ = train(cfg.with_(remat=False), tc, dp, device="cuda",
                      log=lambda m: None, summary_out=twin,
                      on_step=lambda step, loss, sec: twin_s.append(sec))
    torch.cuda.synchronize()
    twin_peak = torch.cuda.max_memory_allocated()
    worst, ok = 0.0, True
    for k, v in flatten(params).items():
        cmp = compare(v, kept[k].to(v.device), TOL[cfg.param_dtype])
        worst, ok = max(worst, cmp["max_abs_err"]), ok and cmp["ok"]
    del params, kept
    fresh_peak()
    bitwise = twin["params_sha256"] == sha
    emit(phase=name, case="remat on against off", layers=cfg.n_layers,
         params_sha256=sha, no_remat_params_sha256=twin["params_sha256"],
         bitwise=bitwise, params_max_abs_diff=worst,
         tol=TOL[cfg.param_dtype], peak_bytes=peak,
         no_remat_peak_bytes=twin_peak, no_remat_allocated_at_start=floor,
         step_seconds=seconds, no_remat_step_seconds=twin_s)
    if not ok:
        raise AssertionError(f"{name}: remat on and off end {worst} apart, "
                             f"beyond {TOL[cfg.param_dtype]}")


def _mesh2_config():
    """train_mesh2's (ModelConfig, TrainConfig, policy): qwen2-1.5b at full
    width, MESH2's depth and dtype, its registered policy, bk-mixopt,
    sigma 1."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import resolve_dp
    cfg = get_config(MESH2["arch"]).with_(n_layers=MESH2["layers"],
                                          param_dtype=MESH2["dtype"])
    tc = TrainConfig(global_batch=MESH2["batch"], seq_len=MESH2["seq"],
                     steps=MESH2["steps"], lr=3e-4, optimizer="adamw")
    dp = resolve_dp(cfg.name, "auto", "bk-mixopt", "automatic", 1.0,
                    log=lambda m: None)
    return cfg, tc, dp


def _mesh2_counts(ws) -> dict:
    """Every kernel's launches so far, and noise_update's block route's
    apart (``noise_update_block``)."""
    counts = {k: w.launches for k, w in ws.items()}
    counts["noise_update_block"] = ws["noise_update"].block_launches
    return counts


def _mesh2_per_step(steps) -> list:
    """on_step's running totals -> each step's own launches."""
    out, prev = [], None
    for s in steps:
        total = s.pop("total")
        prev = prev or dict.fromkeys(total, 0)
        out.append(dict(s, launches={k: total[k] - prev[k] for k in total}))
        prev = total
    return out


def _mesh2_launch_check(name, run, per_step, want):
    """Raises unless every step of ``run`` launched ``want``."""
    for s in per_step:
        if s["launches"] != want:
            raise AssertionError(f"{name} {run} step {s['step']}: launched "
                                 f"{s['launches']}, want {want}")


def _mesh2_rank(rank, port, mesh, out, ckpt_dir):
    """One rank of a train_mesh2 case (a spawned process): ``train`` over
    ``mesh`` on the one card (gloo: the ranks outnumber the cards) ->
    ``out``/rank<r>.pt: its losses, step seconds, launches a step (the
    block route's apart), the block-route launches a step its blocks call
    for, peak device bytes, the bytes of its blocks at rest (params, m and
    v), the backend, and on rank 0 the whole params and the summary. Raises
    unless every launch took the SIMT route (f32)."""
    import torch
    from repro_torch.core.noise import geometry
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.train import train
    from repro_torch.utils.tree import flatten, unflatten
    cfg, tc, dp = _mesh2_config()
    if ckpt_dir:
        tc = dataclasses.replace(tc, checkpoint_dir=ckpt_dir,
                                 checkpoint_every=1, keep_checkpoints=1)
    ws = wrappers()
    reset_counts(ws)
    steps, summary = [], {}

    def on_step(step, loss, seconds):
        steps.append({"step": step, "loss": loss, "seconds": seconds,
                      "total": _mesh2_counts(ws)})

    torch.cuda.reset_peak_memory_stats()
    params, losses = train(cfg, tc, dp, device="cuda", log=lambda m: None,
                           on_step=on_step, summary_out=summary, mesh=mesh,
                           rank=rank, world=2,
                           init_method=f"tcp://localhost:{port}")
    torch.cuda.synchronize()
    check_routes(f"train_mesh2 rank {rank}", ws, False)
    flat = flatten(params)
    coords = dict(zip(("data", "model"), divmod(rank, mesh[1])))
    stand_in = _stand_in_mesh(mesh, tuple(coords.values()))
    specs = sh.flat_param_pspecs(unflatten(flat), stand_in)
    blocks = {k: sh.local_block(v.shape, specs[k], stand_in)
              for k, v in flat.items()}
    rest = sum(3 * 4 * math.prod(local) for local, _ in blocks.values())
    # a block that is not one run of its leaf takes the block route
    strided = sum(not geometry(local, offs, flat[k].shape).contiguous
                  for k, (local, offs) in blocks.items())
    rec = {"rank": rank, "coords": coords, "losses": losses,
           "steps": _mesh2_per_step(steps),
           "block_route_want": strided,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "bytes_at_rest": rest, "summary": summary}
    if rank == 0:
        rec["params"] = {k: v.cpu() for k, v in flat.items()}
    torch.save(rec, Path(out) / f"rank{rank}.pt")


def _mesh2_sums(dev, mesh=None) -> dict:
    """train_mesh2 (d): ``bk_clipped_sum`` of MESH2's model at bf16 on its
    step-0 batch (``mesh``: the calling rank's rows, its weighted grads
    all-reduced) -> {path: the sum, on the host}."""
    from repro_torch.configs.registry import build
    from repro_torch.core.bk import bk_clipped_sum
    from repro_torch.data.synthetic import make_batch
    cfg, _, dp = _mesh2_config()
    cfg = cfg.with_(param_dtype="bfloat16")
    model = build(cfg)
    params = model.init(0, dev)
    batch = make_batch(cfg, MESH2["batch"], MESH2["seq"], 0, 0, dev)
    sums, _ = bk_clipped_sum(model.apply, params, batch, dp, mesh=mesh)
    return {k: v.cpu() for k, v in sums.items()}


def _mesh2_sums_rank(rank, port, out):
    """One rank of train_mesh2 (d) (a spawned process): :func:`_mesh2_sums`
    over (2, 1) on the one card -> ``out``/sums.pt on rank 0."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import (init_distributed, make_mesh,
                                         rank_device)
    init_distributed(rank, 2, f"tcp://localhost:{port}", "cuda")
    try:
        dev = rank_device("cuda", rank)
        sums = _mesh2_sums(dev, make_mesh((2, 1), device=dev))
        if rank == 0:
            torch.save(sums, Path(out) / "sums.pt")
    finally:
        dist.destroy_process_group()


def _mesh2_ranks(rank, cases, out, ck):
    """One rank of every train_mesh2 case, one after another in one spawned
    process (a process's start-up, the card's and the library's, paid once
    for the three): ``cases`` [(case, mesh, port)], (a) and (b) by
    :func:`_mesh2_rank` (``ck``: (a)'s checkpoint directory), (d) by
    :func:`_mesh2_sums_rank`, each into ``out``/<case>; each case's
    seconds into ``out``/seconds<rank>.json."""
    import torch
    seconds = {}
    for case, mesh, port in cases:
        t0 = time.perf_counter()
        if case == "d":
            _mesh2_sums_rank(rank, port, str(Path(out) / case))
        else:
            _mesh2_rank(rank, port, mesh, str(Path(out) / case),
                        ck if case == "a" else "")
        seconds[case] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    (Path(out) / f"seconds{rank}.json").write_text(json.dumps(seconds))


def _bf16_against(one: dict, got: dict) -> dict:
    """-> the elements, the share of them equal, the largest gap over the
    leaf's largest magnitude, and the largest gap in the element's own bf16
    ulps (2^(exponent - 7) at the larger magnitude) of ``got``'s bf16
    tensors against ``one``'s."""
    import torch
    n = same = 0
    of_top = ulps = 0.0
    for k, a in one.items():
        a, b = a.float(), got[k].float()
        gap = (a - b).abs()
        top = max(float(a.abs().max()), float(b.abs().max()))
        of_top = max(of_top, float(gap.max()) / top if top else 0.0)
        e = torch.frexp(torch.maximum(a.abs(), b.abs()))[1]
        ulps = max(ulps, float((gap / torch.ldexp(torch.ones_like(a),
                                                  e - 8)).max()))
        n += a.numel()
        same += int((a == b).sum())
    return {"elements": n, "equal_share": same / n,
            "max_gap_of_leaf_max": of_top, "max_gap_ulps": ulps}


def phase_train_mesh2(name):
    """train_mesh2 (MESH2): the world-1 run in this process, then each
    case's two ranks spawned on the card under gloo. (a) --mesh 2,1 (the
    batch split, one all-reduce a weighted grad) against world 1 at
    MESH2_TOL, losses within 1e-4, a checkpoint every step; (b) --mesh 1,2
    (the model axis: strided blocks, the noise kernels' block route)
    bitwise world 1; (c) (a)'s last checkpoint (slices at nonzero offsets,
    two process files) restored in this process: its params' sha256 and
    its ledger's epsilon those of (a)'s run. Every step of every run
    launches train's kernels on the SIMT routes (f32) and one noise_update
    a leaf: on world 1 none by the block route, on each rank as many as its
    blocks that are not one run of their leaf (some on (b)). (d) bf16
    clipped sums over (2, 1) against world 1's: equal in 99% of elements
    or more (the f32 partials summed, then cast once; partials cast first
    leave about two thirds equal), every gap within one bf16 ulp of its
    leaf's largest magnitude. The cases' ranks run in one spawn of two
    processes, one case after another. Prints each rank's backend, launches
    a step, peak device bytes, the bytes of its blocks at rest, its step
    seconds and each case's seconds (rank 0's)."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.checkpoint.run_state import params_digest
    from repro_torch.core.accounting import PrivacyLedger
    from repro_torch.launch.mesh import free_port
    from repro_torch.launch.train import train
    from repro_torch.utils.tree import flatten

    cfg, tc, dp = _mesh2_config()
    fresh_peak()
    ws = wrappers()
    one, logs, steps = {}, [], []
    reset_counts(ws)                  # counts from here on are the run's
    t0 = time.perf_counter()
    params, losses = train(
        cfg, tc, dp, device="cuda", log=logs.append, summary_out=one,
        on_step=lambda step, loss, seconds: steps.append(
            {"step": step, "total": _mesh2_counts(ws)}))
    ref = {k: v.cpu() for k, v in flatten(params).items()}
    del params
    check_routes(name, ws, False)
    per_step = _mesh2_per_step(steps)
    # train's kernels, one noise_update a leaf
    want = dict(_per_step(ghost_norm=5, clipped_grad=5, emb_ghost_norm=1,
                          emb_clipped_grad=1), noise_update=len(ref))
    emit(phase=name, run="world 1", arch=cfg.name, layers=cfg.n_layers,
         dtype=cfg.param_dtype, batch=tc.global_batch, seq=tc.seq_len,
         steps=tc.steps, losses=losses, params_sha256=one["params_sha256"],
         epsilon=one["epsilon"], seconds=time.perf_counter() - t0,
         peak_bytes=torch.cuda.max_memory_allocated(),
         launches=[s["launches"] for s in per_step])
    _mesh2_launch_check(name, "world 1", per_step,
                        dict(want, noise_update_block=0))
    fresh_peak()
    root = ROOT / "build" / name
    shutil.rmtree(root, ignore_errors=True)
    # every case's two ranks in one spawn: (a), (b), then (d)
    ports = []
    while len(ports) < 3:
        port = free_port()
        if port not in ports:
            ports.append(port)
    cases = [(case, mesh, port) for (case, mesh), port in
             zip([*MESH2["cases"].items(), ("d", (2, 1))], ports)]
    for case, _, _ in cases:
        (root / case).mkdir(parents=True)
    t0 = time.perf_counter()
    mp.spawn(_mesh2_ranks, args=(cases, str(root), str(root / "ck")),
             nprocs=2, join=True)
    emit(phase=name, spawn_seconds=time.perf_counter() - t0)
    case_seconds = json.loads((root / "seconds0.json").read_text())
    for case, mesh in MESH2["cases"].items():
        out = root / case
        seconds = case_seconds[case]
        ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]
        got = ranks[0]
        worst = max(float((got["params"][k] - v).abs().max())
                    for k, v in ref.items())
        row = dict(phase=name, case=case, mesh=list(mesh),
                   backend=got["summary"]["mesh"]["backend"],
                   seconds=seconds, losses=got["losses"],
                   world1_losses=losses,
                   loss_max_gap=max(abs(a - b) for a, b in
                                    zip(got["losses"], losses)),
                   params_max_abs_gap=worst,
                   params_sha256=got["summary"]["params_sha256"],
                   bitwise=got["summary"]["params_sha256"]
                   == one["params_sha256"],
                   ranks=[{k: r[k] for k in ("rank", "coords", "peak_bytes",
                                              "bytes_at_rest",
                                              "block_route_want")}
                          | {"step_seconds": [s["seconds"]
                                              for s in r["steps"]],
                             "launches": [s["launches"]
                                          for s in r["steps"]]}
                          for r in ranks])
        emit(**row)
        if row["backend"] != "gloo":
            raise AssertionError(f"{name} ({case}): two ranks on one card "
                                 f"took {row['backend']}, want gloo")
        for r in ranks:
            _mesh2_launch_check(name, f"({case}) rank {r['rank']}",
                                r["steps"], dict(
                                    want, noise_update_block=r[
                                        "block_route_want"]))
        if case == "b" and not sum(r["block_route_want"] for r in ranks):
            raise AssertionError(f"{name} (b): no rank's block takes the "
                                 "block route")
        if case == "a":
            for k, v in ref.items():
                np.testing.assert_allclose(got["params"][k].numpy(),
                                           v.numpy(), err_msg=k, **MESH2_TOL)
            if row["loss_max_gap"] >= 1e-4:
                raise AssertionError(f"{name} (a): losses {got['losses']} "
                                     f"against world 1's {losses}")
            # (c) the two-rank checkpoint, restored in one process
            t1 = time.perf_counter()
            step = ckpt.latest_step(str(root / "ck"))
            manifest = json.loads((root / "ck" / f"step_{step:010d}"
                                   / ckpt.MANIFEST).read_text())
            state, step, meta = ckpt.restore(str(root / "ck"), device="cpu")
            entries = [e for f in manifest["files"].values()
                       for e in f["entries"].values()]
            eps = PrivacyLedger.from_json(meta["ledger"]).epsilon(1e-5)
            restored = dict(
                phase=name, case="c", step=step,
                process_files=sorted(manifest["files"]),
                offset_slices=sum(any(o > 0 for o in e["offset"])
                                  for e in entries),
                slices=len(entries),
                bytes=ckpt.nbytes(str(root / "ck" / f"step_{step:010d}")),
                params_sha256=params_digest(state["params"]),
                saved_params_sha256=got["summary"]["params_sha256"],
                epsilon=eps, saved_epsilon=got["summary"]["epsilon"],
                restore_seconds=time.perf_counter() - t1,
                saves=got["summary"]["checkpoints"]["saves"])
            del state
            emit(**restored)
            if not (restored["offset_slices"] > 0
                    and len(restored["process_files"]) == 2
                    and restored["params_sha256"]
                    == restored["saved_params_sha256"]
                    and eps == restored["saved_epsilon"]):
                raise AssertionError(f"{name} (c): the two-rank checkpoint "
                                     f"does not restore as saved: {restored}")
        elif not row["bitwise"] or any(
                not torch.equal(got["params"][k], v) for k, v in ref.items()):
            raise AssertionError(f"{name} ({case}): --mesh "
                                 f"{mesh} is not world 1's params bitwise")
        del ranks, got
    # (d) bf16 clipped sums over (2, 1): each rank's f32 partials summed,
    # then rounded once, as world 1 rounds its f32 sum: equal but where the
    # two f32 sums (apart by f32 reassociation) straddle a bf16 rounding
    # boundary; an element that cancels can move many of its own ulps, so
    # the gaps are held to the leaf's largest magnitude (one bf16 ulp)
    got = torch.load(root / "d" / "sums.pt", weights_only=False)
    seconds = case_seconds["d"]
    cmp = _bf16_against(_mesh2_sums(torch.device("cuda")), got)
    fresh_peak()
    emit(phase=name, case="d", mesh=[2, 1], dtype="bfloat16",
         what="bk_clipped_sum against world 1's", seconds=seconds, **cmp)
    if cmp["max_gap_of_leaf_max"] > 2.0 ** -7 or cmp["equal_share"] < 0.99:
        raise AssertionError(f"{name} (d): the bf16 sums over (2, 1) are "
                             f"not world 1's rounded once: {cmp}")
    shutil.rmtree(root, ignore_errors=True)


def _train_in_process(argv, ws):
    """``launch.train``'s command line ``argv`` run in this process (the
    configuration ``main`` builds) -> (summary, per step: seconds, peak
    device bytes since the step before, launches; driver log)."""
    import torch
    from repro_torch.launch.train import cli_args, train
    kwargs, _ = cli_args(argv)
    steps, logs, summary = {}, [], {}
    counts = {k: 0 for k in ws}

    def on_step(step, loss, seconds):
        now = {k: w.launches for k, w in ws.items()}
        steps[step] = {"loss": loss, "seconds": seconds,
                       "peak_bytes": torch.cuda.max_memory_allocated(),
                       "launches": {k: now[k] - counts[k] for k in now}}
        counts.update(now)
        torch.cuda.reset_peak_memory_stats()

    fresh_peak()
    reset_counts(ws)
    params, _ = train(**kwargs, log=logs.append, on_step=on_step,
                      summary_out=summary)
    del params
    fresh_peak()
    return summary, steps, [m for m in logs if not m.startswith("step ")]


def phase_train_resume(name):
    """Kill-and-resume through ``launch.train`` (``RESUME_CASES``): the
    uninterrupted run without a checkpoint directory (this process), the
    same run with ``--ckpt-dir`` in a subprocess killed by ``REPRO_FAULT``
    at a step's top (it must die as ``expected_death`` says), then the same
    command again (this process), which must resume and end with the first
    run's ``params_sha256`` and epsilon, each equal. Prints the disk's free
    bytes and the host's MemAvailable before the writes, one checkpoint's
    bytes, the seconds a save blocks its step, the writer's seconds, the
    seconds of ``latest_step`` + ``restore``, and the peak device memory of
    the resumed run's saving step against the same step of the first run
    (under SAVE_PEAK_GAP). -> launch totals of the in-process runs."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.runtime import fault_injection as fi
    ws = wrappers()
    totals = dict.fromkeys(ws, 0)
    for case, spec in RESUME_CASES.items():
        root = ROOT / "build" / "train_resume" / case
        shutil.rmtree(root, ignore_errors=True)
        root.mkdir(parents=True)
        ck = root / "ck"
        argv = spec["argv"]
        ref, ref_steps, ref_log = _train_in_process(argv, ws)
        meminfo = Path("/proc/meminfo").read_text()
        emit(phase=name, case=case, run="uninterrupted", argv=argv,
             disk_free_bytes=shutil.disk_usage(root).free,
             mem_available_kb=int(re.search(r"MemAvailable:\s+(\d+)",
                                            meminfo).group(1)),
             params_sha256=ref["params_sha256"], epsilon=ref["epsilon"],
             steps=ref_steps, driver_log=ref_log)

        fault = fi.FaultSpec("step", spec["kill"], "sigkill")
        code = ("from repro_torch.launch.train import main\n"
                f"main({[*argv, '--ckpt-dir', str(ck)]!r})\n")
        t0 = time.perf_counter()
        killed = fi.run_subprocess(code, fault,
                                   env={"PYTHONPATH": str(ROOT / "src"),
                                        "PYTHONUNBUFFERED": "1"},
                                   timeout=900, cwd=str(ROOT))
        killed_s = time.perf_counter() - t0
        latest = ckpt.latest_step(str(ck))
        # its saves' host copies, from its log (the first pins the buffers)
        copies = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
            r"checkpoint step (\d+): copied to the host in ([\d.]+)s",
            killed.stdout)}
        emit(phase=name, case=case, run="killed", fault=fault.encode(),
             returncode=killed.returncode, seconds=killed_s,
             latest_step=latest, listed=ckpt.steps(str(ck)),
             on_disk=sorted(os.listdir(ck)), save_blocking_seconds=copies,
             driver_log=killed.stdout.splitlines()[-12:])
        if latest is None:
            raise AssertionError(f"{name} {case}: the killed run left no "
                                 "valid checkpoint")

        got, got_steps, got_log = _train_in_process(
            [*argv, "--ckpt-dir", str(ck)], ws)
        shutil.rmtree(root)
        saves = got["checkpoints"]["saves"]
        every = int(argv[argv.index("--ckpt-every") + 1])
        saving = [s for s in got_steps if s % every == 0]
        row = dict(
            phase=name, case=case, run="resumed",
            resumed_from=got["resumed_from"],
            params_sha256=got["params_sha256"], epsilon=got["epsilon"],
            bitwise=got["params_sha256"] == ref["params_sha256"],
            epsilon_equal=got["epsilon"] == ref["epsilon"],
            checkpoint_bytes=saves[-1]["bytes"],
            save_blocking_seconds=saves[-1]["snapshot_seconds"],
            writer_seconds=saves[-1]["writer_seconds"],
            restore_seconds=got["checkpoints"]["restore_seconds"],
            saves=saves, steps=got_steps, driver_log=got_log)
        if saving:
            s = saving[-1]
            row.update(saving_step=s,
                       saving_step_peak_bytes=got_steps[s]["peak_bytes"],
                       same_step_unsaved_peak_bytes=ref_steps[s]["peak_bytes"],
                       saving_step_seconds=got_steps[s]["seconds"],
                       same_step_unsaved_seconds=ref_steps[s]["seconds"])
            row["save_peak_gap_bytes"] = (row["saving_step_peak_bytes"]
                                          - row["same_step_unsaved_peak_bytes"])
        emit(**row)
        if not got["resumed_from"] > 0:
            raise AssertionError(f"{name} {case}: the rerun did not resume")
        if not (row["bitwise"] and row["epsilon_equal"]):
            raise AssertionError(
                f"{name} {case}: the resumed run ends at {got['params_sha256']}"
                f", epsilon {got['epsilon']}; the uninterrupted run at "
                f"{ref['params_sha256']}, epsilon {ref['epsilon']}")
        if not saving:
            raise AssertionError(f"{name} {case}: the resumed run "
                                 "saved at no step")
        if row["save_peak_gap_bytes"] >= SAVE_PEAK_GAP:
            raise AssertionError(f"{name} {case}: a saving step peaks "
                                 f"{row['save_peak_gap_bytes']} bytes above "
                                 "the same step unsaved")
        for s, rec in got_steps.items():
            if rec["launches"] != ref_steps[s]["launches"]:
                raise AssertionError(
                    f"{name} {case} step {s}: resumed launches "
                    f"{rec['launches']}, uninterrupted {ref_steps[s]['launches']}")
        for rec in (*ref_steps.values(), *got_steps.values()):
            for k, n in rec["launches"].items():
                totals[k] += n
    return totals


# ---- the CNN of train_cnn and parity_cnn: tests/test_conv_dp.py's TinyCNN
# pattern (conv -> ReLU -> strided conv -> ReLU -> global average pool ->
# linear) with one more strided conv, at ResNet-18's stem widths on 224 x
# 224 x 3 images (the case of that test's hybrid decision): each conv an
# im2col tap (``models.layers.conv2d``), SAME padding. Not a registered
# arch: the script drives it through ``launch.steps.make_train_step`` and
# ``core.engine.make_grad_fn``, the entry points any user model takes.
# (name, k, stride, c_in, c_out, bias): c1 T = 112^2, d = 147; c2 T = 56^2,
# d = 576; c3 T = 28^2, d = 1152; the head 256 -> 1000 (T = 1)
CNN_CONVS = (("c1", 7, 2, 3, 64, True), ("c2", 3, 2, 64, 128, False),
             ("c3", 3, 2, 128, 256, False))
CNN_IMAGE, CNN_CLASSES = 224, 1000
# train_cnn: B=32, bf16, AdamW, sigma 1.0, ``steps`` a mode (the last
# profiled): bk-mixopt, whose cache takes the three convs' small per-sample
# grads (L B d p <= 2^24: no kernel), then bk-mixghost, where they launch
# grad_norm_direct (c1 on its SIMT route at d = 147, c2 and c3 on wgmma)
# and clipped_grad; the head ghost in both
CNN_TRAIN = dict(batch=32, steps=3, modes=("bk-mixopt", "bk-mixghost"))
# parity_cnn: f32, B=4, every BK mode and ghostclip against opacus, the
# card's use_kernels=False and the CPU
CNN_PARITY = dict(batch=4, modes=("bk", "bk-mixopt", "bk-mixghost",
                                  "ghostclip"))


def cnn_init(seed: int, device, dtype):
    """The CNN's params from ``seed`` (a torch.Generator on ``device``)."""
    import torch
    from repro_torch.models import layers as L
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {name: L.conv2d_init(gen, k, k, c_in, c_out, dtype, bias)
              for name, k, _, c_in, c_out, bias in CNN_CONVS}
    params["head"] = L.linear_init(gen, CNN_CONVS[-1][4], CNN_CLASSES, dtype,
                                   bias=True)
    return params


def cnn_apply(params, batch, tape):
    """batch {'x': (B, 224, 224, 3) f32 images, 'y': (B,) labels} ->
    per-sample cross-entropy (B,)."""
    import torch
    from repro_torch.models import layers as L
    x = batch["x"].to(params["head"]["w"].dtype)
    for name, k, stride, *_ in CNN_CONVS:
        x = torch.relu(L.conv2d(tape, name, params[name], x, k, k, stride))
    x = x.mean(dim=(1, 2))[:, None, :]                   # (B, 1, 256)
    logits = L.linear(tape, "head", params["head"], x)[:, 0].float()
    gold = torch.gather(logits, -1, batch["y"][:, None].long())[:, 0]
    return torch.logsumexp(logits, dim=-1) - gold


def cnn_batch(B: int, seed: int, device="cuda") -> dict:
    """Standard normal images and uniform labels from ``seed``."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {"x": torch.randn(B, CNN_IMAGE, CNN_IMAGE, 3, generator=gen,
                             device=device),
            "y": torch.randint(0, CNN_CLASSES, (B,), generator=gen,
                               device=device)}


def plan_counts(report) -> dict:
    """Each kernel's launches a step under a ``core.bk.plan_report``: a
    norm kernel a tap whose grads are not cached, and its weighted-grad
    kernel."""
    from repro_torch.core.tape import parse_key
    counts = _per_step()
    for key, plans in report.items():
        if plans["grad"] != "cache":
            counts[NORM_KERNEL[parse_key(key)[1],
                               plans["norm"].method]] += 1
        if plans["grad"] in counts:
            counts[plans["grad"]] += 1
    return counts


def cnn_routes(report, params, batch) -> dict:
    """{tap: {kernel: route}} of the CNN's kernel launches (bf16: wgmma
    where d and p are multiples of 8, else SIMT) and the simt launches a
    step by kernel (``check_routes``' ``simt``)."""
    from repro_torch.core.bk import tap_act_structs
    from repro_torch.kernels import clipped_grad as cg
    from repro_torch.kernels import ghost_norm as gn
    from repro_torch.kernels import grad_norm_direct as gd
    outs, acts = tap_act_structs(cnn_apply, params, batch)
    mods = {"ghost_norm": gn, "grad_norm_direct": gd, "clipped_grad": cg}
    routes, simt = {}, {}
    for key, plans in report.items():
        (shape, dtype), p = acts[key], outs[key][0][-1]
        kernels = [] if plans["grad"] == "cache" else [
            NORM_KERNEL["mm", plans["norm"].method], plans["grad"]]
        routes[key] = {k: mods[k].route(dtype, shape[-1], p)
                       for k in kernels}
        for k, r in routes[key].items():
            if r == "simt":
                simt[k] = simt.get(k, 0) + 1
    return routes, simt


def phase_train_cnn(name):
    """The CNN at B=32, bf16: ``CNN_TRAIN['steps']`` AdamW steps under each
    mode of CNN_TRAIN through ``launch.steps.make_train_step`` (sigma 1.0,
    automatic clipping; new images every step), the last step profiled ->
    launch totals. Each step's launches are held to ``plan_report``'s plan
    (and one noise_update a leaf), every launch to its route (c1's SIMT
    kernels at d = 147, the rest wgmma); the first loss near ln(1000)."""
    import torch
    from repro_torch.core.bk import DPConfig, plan_report
    from repro_torch.core.noise import prng_key
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.utils.tree import flatten

    B, steps = CNN_TRAIN["batch"], CNN_TRAIN["steps"]
    ws = wrappers()
    totals = _per_step()
    for mode in CNN_TRAIN["modes"]:
        dp = DPConfig(mode=mode, sigma=1.0)
        params = cnn_init(0, "cuda", torch.bfloat16)
        report = plan_report(cnn_apply, params, cnn_batch(B, 0), dp)
        routes, simt = cnn_routes(report, params, cnn_batch(B, 0))
        want = dict(plan_counts(report), noise_update=len(flatten(params)))
        opt = make_optimizer("adamw", lambda s: 3e-4)
        state = TrainState(params, opt.init(params), 0, prng_key(1))
        step_fn = make_train_step(cnn_apply, params, opt, dp)
        del params
        floor = fresh_peak()
        reset_counts(ws)
        per_step, losses = [], []
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        for step in range(steps):
            batch = cnn_batch(B, step)
            before = {k: w.launches for k, w in ws.items()}
            torch.cuda.synchronize()
            if step == steps - 1:
                prof.start()
            t0 = time.perf_counter()
            state, loss = step_fn(state, batch)
            losses.append(float(loss))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if step == steps - 1:
                prof.stop()
            per_step.append({"step": step, "loss": losses[-1],
                             "seconds": seconds, "launches": {
                                 k: w.launches - before[k]
                                 for k, w in ws.items()}})
        peak = torch.cuda.max_memory_allocated()
        wgmma = check_routes(f"{name} {mode}", ws, True,
                             {k: n * steps for k, n in simt.items()})
        profile = _profile_summary(prof, per_step[-1]["seconds"] * 1e3)
        for s in per_step:
            emit(phase=name, mode=mode, step=s["step"], loss=s["loss"],
                 step_seconds=s["seconds"], launches=s["launches"])
        emit(phase=name, mode=mode, batch=B, image=CNN_IMAGE,
             dtype="bfloat16", optimizer="adamw", sigma=dp.sigma,
             steps=steps, losses=losses, plan={
                 k: {"norm": v["norm"].method, "grad": v["grad"]}
                 for k, v in report.items()}, routes=routes,
             max_memory_allocated=peak, allocated_at_start=floor,
             wgmma_launches=wgmma, launches_a_step=want)
        emit(phase=f"{name}_profile", mode=mode, step=steps - 1, **profile)
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name} [{mode}]: non-finite loss: "
                                 f"{losses}")
        if abs(losses[0] - math.log(CNN_CLASSES)) > 0.5:
            raise AssertionError(f"{name} [{mode}]: step-0 loss {losses[0]} "
                                 f"is not near ln({CNN_CLASSES})")
        for s in per_step:
            if s["launches"] != want:
                raise AssertionError(f"{name} [{mode}] step {s['step']}: "
                                     f"launched {s['launches']}, want "
                                     f"{want}")
        for k, n in want.items():
            totals[k] += n * steps
        del state, step_fn, opt
        torch.cuda.empty_cache()
    return totals


def phase_parity_cnn(name):
    """The CNN in f32 at B=4 on the card, sigma 0: every mode of CNN_PARITY
    (the kernels) against opacus on the card (vmap(grad) through the im2col
    unfold), against the same mode with ``use_kernels=False`` on the card
    and on the CPU: per-sample norms at NORM_TOL, grads at f32 TOL; each
    kernel run's launches on the SIMT routes (f32), none in the plain runs.
    Then bk-mixopt's clipped sums at sigma 1.0 into one noised AdamW step
    against its plain version (``update_parity``). -> {} (these launches do
    not count as a path's)."""
    import torch
    from repro_torch.core.bk import DPConfig, bk_clipped_sum
    from repro_torch.core.engine import make_grad_fn
    from repro_torch.core.noise import prng_key
    from repro_torch.core.policy import as_policy
    from repro_torch.utils.tree import flatten, unflatten

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B = CNN_PARITY["batch"]
    params = cnn_init(1, "cuda", torch.float32)
    batch = cnn_batch(B, 1)
    cpu_params = unflatten({k: v.cpu() for k, v in flatten(params).items()})
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    ws = wrappers()

    def run(mode, use=True, dev="cuda"):
        reset_counts(ws)
        t0 = time.perf_counter()
        grads, aux = make_grad_fn(cnn_apply, DPConfig(
            mode=mode, use_kernels=use))(
                *((params, batch) if dev == "cuda" else
                  (cpu_params, cpu_batch)), prng_key(7))
        if dev == "cuda":
            torch.cuda.synchronize()
        launched = {k: w.launches for k, w in ws.items() if w.launches}
        return ({k: v.to("cuda") for k, v in flatten(grads).items()},
                aux["per_sample_norms"].to("cuda"), launched,
                time.perf_counter() - t0)

    ref, ref_norms, _, ref_s = run("opacus")
    rtol, atol = TOL["float32"]
    for mode in CNN_PARITY["modes"]:
        got, norms, launched, card_s = run(mode)
        check_routes(f"{name} {mode}", ws, False)      # f32: SIMT routes
        if not launched:
            raise AssertionError(f"{name} [{mode}]: no kernel launched")
        for case, (want, want_norms, plain_launched, s) in (
                ("vs opacus", (ref, ref_norms, {}, ref_s)),
                ("vs card use_kernels=False", run(mode, use=False)),
                ("vs CPU", run(mode, dev="cpu"))):
            worst, bad = 0.0, []
            for k in sorted(want):
                cmp = compare(got[k], want[k], (rtol, atol))
                worst = max(worst, cmp["max_abs_err"])
                if not cmp["ok"]:
                    bad.append(k)
            cmp_n = compare(norms, want_norms, NORM_TOL)
            emit(phase=name, mode=mode, case=case, batch=B, image=CNN_IMAGE,
                 dtype="float32", grads_max_abs_err=worst, rtol=rtol,
                 atol=atol, norms=cmp_n, failed=bad, launched=launched,
                 reference_launched=plain_launched, card_seconds=card_s,
                 reference_seconds=s)
            if bad or not cmp_n["ok"] or plain_launched:
                raise AssertionError(f"{name} [{mode} {case}]: disagrees on "
                                     f"{bad}, norms {cmp_n}, or the plain "
                                     f"run launched {plain_launched}")
    policy = as_policy(DPConfig(mode="bk-mixopt", sigma=1.0))
    sums, _ = bk_clipped_sum(cnn_apply, params, batch, policy)
    update_parity(name, params, sums, policy, B)
    del params, batch, cpu_params, ref, sums
    torch.cuda.empty_cache()
    return {}


def paper_ratios(stats: dict) -> dict:
    """The paper's two comparisons at qwen2-1.5b's full width and depth:
    bk-mixopt (``train``) over standard training (``train_nonprivate``),
    and GhostClip (``train_ghostclip``) over bk-mixopt: step seconds (the
    unprofiled step), profiled device busy time and peak memory."""
    bk, base, gc = (stats[k] for k in ("train", "train_nonprivate",
                                       "train_ghostclip"))
    out = {"phase": "paper_ratios"}
    for key in ("step_seconds", "device_busy_ms", "peak_bytes"):
        out[f"bk_over_nonprivate_{key}"] = bk[key] / base[key]
        out[f"ghostclip_over_bk_{key}"] = gc[key] / bk[key]
    out["stats"] = {k: stats[k] for k in ("train", "train_nonprivate",
                                          "train_ghostclip")}
    return out


# the dry-run phase: its cells, and how far the planned peak may sit from
# max_memory_allocated (both count the caching allocator's 512-byte blocks)
DRYRUN_PEAK_TOL = 0.10
DRYRUN_CARD_BYTES = 79e9     # the most a cell's planned peak may take
# the library's size entries (the workspace rules kernels.meta writes out)
SIZE_ENTRIES = ("dp_ghost_norm_nparts", "dp_ghost_norm_wgmma_split",
                "dp_ghost_norm_wgmma_nparts", "dp_clipped_grad_split",
                "dp_emb_norm_nparts", "dp_emb_grad_smem_bytes",
                "dp_emb_grad_scratch_ints", "dp_grad_norm_direct_nparts",
                "dp_grad_norm_direct_wgmma_nparts",
                "dp_moe_ghost_norm_wgmma_nparts", "dp_moe_direct_norm_nparts",
                "dp_moe_direct_norm_wgmma_nparts", "dp_wkv6_chunked_nparts",
                "dp_wkv6_backward_nparts")
FUSED_SIZES = ("dp_fused_clip_nparts", "dp_fused_clip_scratch_bytes")
# widths and depths the size rules are also asked at (train paths' taps,
# the head, an unaligned tap, MoE capacities, fused units)
SIZE_CASES = ((28, 8, 512, 1536, 1536), (28, 8, 512, 1536, 8960),
              (1, 8, 512, 1536, 151936), (1, 2, 4096, 1536, 151936),
              (28, 2, 4096, 1536, 256), (32, 8, 1152, 1600, 57),
              (1, 8, 1152, 1600, 32001), (26, 8, 64, 2048, 1408),
              (4, 8, 512, 256, 256), (1, 2, 64, 64, 64), (28, 2, 1536, 16, 64))


class _SizeSpy:
    """Records each size entry the library is asked (name, args) -> the
    card's answer, over the real library's functions (restored on exit)."""

    def __init__(self):
        from repro_torch.kernels import build
        self.lib, self.asked, self.saved = build.load(), {}, {}

    def __enter__(self):
        for name in SIZE_ENTRIES + FUSED_SIZES:
            fn = getattr(self.lib, name)
            self.saved[name] = fn

            def spy(*args, _fn=fn, _name=name):
                out = _fn(*args)
                self.asked[_name, args] = out
                return out
            setattr(self.lib, name, spy)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.lib, name, fn)


def size_checks(asked: dict) -> dict:
    """Every size the card's library gave (``asked``, and SIZE_CASES for
    each rule) against ``kernels.meta.LIB``'s: raises on an exact rule
    that differs; fused_clip_grad's plan is a model of the card's
    occupancy, printed beside it."""
    from repro_torch.kernels import build, meta
    lib = build.load()
    cases = dict(asked)
    for L, B, T, d, p in SIZE_CASES:
        for name, args in (
                ("dp_ghost_norm_nparts", (T,)),
                ("dp_ghost_norm_wgmma_split", (L, B, T, d, p)),
                ("dp_ghost_norm_wgmma_nparts", (L, B, T, d, p)),
                ("dp_clipped_grad_split", (L, B, T, d, p)),
                ("dp_emb_norm_nparts", (T,)),
                ("dp_emb_grad_smem_bytes", (p,)),
                ("dp_emb_grad_scratch_ints", (p,)),
                ("dp_grad_norm_direct_nparts", (d, p)),
                ("dp_grad_norm_direct_wgmma_nparts", (d,)),
                ("dp_moe_ghost_norm_wgmma_nparts", (T,)),
                ("dp_moe_direct_norm_nparts", (d, p)),
                ("dp_moe_direct_norm_wgmma_nparts", (d,)),
                ("dp_wkv6_chunked_nparts", (T, min(128, d))),
                ("dp_wkv6_backward_nparts", (min(64, d),))):
            cases.setdefault((name, args), getattr(lib, name)(*args))
        for wgmma in (0, 1):
            if wgmma and (d % 8 or p % 8):
                continue
            for name in FUSED_SIZES:
                args = (L, B, T, d, p, 1, wgmma)
                cases.setdefault((name, args), getattr(lib, name)(*args))
    bad, fused = [], []
    for (name, args), got in sorted(cases.items()):
        want = getattr(meta.LIB, name)(*args)
        if name in FUSED_SIZES:
            fused.append({"entry": name, "args": list(args), "card": got,
                          "model": want})
        elif got != want:
            bad.append({"entry": name, "args": list(args), "card": got,
                        "rule": want})
    out = {"asked_on_path": len(asked), "checked": len(cases) - len(fused),
           "fused_model_agrees": sum(f["card"] == f["model"] for f in fused),
           "fused_cases": len(fused),
           "fused_disagree": [f for f in fused if f["card"] != f["model"]]}
    emit(phase="dryrun_sizes", **out, mismatches=bad)
    if bad:
        raise AssertionError(f"dryrun: kernels.meta's size rules differ from "
                             f"the library's at {bad[:4]}")
    return out


def _cell_on_card(name, plan, planned, run):
    """Build ``plan``'s operands on the card, run ``run(fn, args)`` ->
    (measured dict, the run's result). The peak counts from what was
    allocated before the operands (``fresh_peak``)."""
    import torch
    from repro_torch.launch.steps import _storages
    floor = fresh_peak()
    args = plan.make_args("cuda", 0)
    torch.cuda.synchronize()
    held = sum(_storages(args).values())
    at_rest = torch.cuda.memory_allocated() - floor
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run(plan.fn, args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - floor
    mem = planned["memory"]
    measured = {"held_bytes": held, "allocated_at_rest": at_rest,
                "max_memory_allocated": peak, "seconds": seconds}
    emit(phase="dryrun", cell=name, arch=plan.arch, shape=plan.shape,
         note=plan.note, planned=mem, measured=measured,
         peak_ratio=mem["peak_bytes"] / peak,
         planned_flops=planned["cost"]["flops"],
         planned_collectives=planned["collectives"]["total"])
    if mem["argument_bytes"] != held:
        raise AssertionError(f"dryrun {name}: planned argument_bytes "
                             f"{mem['argument_bytes']} != {held} held")
    if abs(mem["peak_bytes"] - peak) > DRYRUN_PEAK_TOL * peak:
        raise AssertionError(f"dryrun {name}: planned peak "
                             f"{mem['peak_bytes']} is not within "
                             f"{DRYRUN_PEAK_TOL:.0%} of the measured {peak}")
    del args
    return measured, out


def phase_dryrun(name):
    """The planner against the card (see the module's docstring) -> the
    launch totals of the cells' runs on the card."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_plan_mesh
    from repro_torch.launch.steps import TRAIN_MICROBATCH, plan_cell

    ws = wrappers()
    totals = dict.fromkeys(ws, 0)
    mesh = make_plan_mesh((1, 1))
    # (a) one data rank's train_4k work: 32 rows over 16 ranks
    rows = TRAIN_MICROBATCH["qwen2-1.5b"] // 16
    shape = ShapeConfig("train_4k", 4096, rows, "train")
    layers = get_config("qwen2-1.5b").n_layers
    t0 = time.perf_counter()
    while True:
        plan = plan_cell("qwen2-1.5b", shape, mesh,
                         cfg_patch={"n_layers": layers})
        planned = plan.plan()
        if planned["memory"]["peak_bytes"] <= DRYRUN_CARD_BYTES or \
                layers == 1:
            break
        layers -= 1
    plan_s = time.perf_counter() - t0
    emit(phase="dryrun_plan", cell="qwen2_train_4k_rank", layers=layers,
         plan_seconds=plan_s, kernels=planned["kernels"])

    def train_step(fn, args):
        reset_counts(ws)
        new_state, loss = fn(*args)
        return loss
    with _SizeSpy() as spy:
        measured, loss = _cell_on_card("qwen2_train_4k_rank", plan, planned,
                                       train_step)
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"dryrun: the train step's loss {loss} is not "
                             "finite")
    got = {k: w.launches for k, w in ws.items() if w.launches}
    routes = {k: w.wgmma_launches for k, w in ws.items()
              if getattr(w, "wgmma_launches", 0)}
    want = planned["kernels"]["launches"]
    want_routes = {}
    for entry, n in planned["kernels"]["entries"].items():
        if entry.endswith("_wgmma"):
            k = {"dp_emb_norm": "emb_ghost_norm"}.get(entry[3:-6],
                                                      entry[3:-6])
            want_routes[k] = want_routes.get(k, 0) + n
    emit(phase="dryrun_launches", cell="qwen2_train_4k_rank", card=got,
         plan=want, card_wgmma=routes, plan_wgmma=want_routes)
    if got != want or routes != want_routes:
        raise AssertionError(f"dryrun: the card launched {got} (wgmma "
                             f"{routes}), the plan {want} (wgmma "
                             f"{want_routes})")
    for k, w in ws.items():
        totals[k] += w.launches
    asked = dict(spy.asked)
    del loss
    torch.cuda.empty_cache()

    # (b) hymba-1.5b's long_500k: three decode steps near S
    t0 = time.perf_counter()
    plan = plan_cell("hymba-1.5b", "long_500k", mesh)
    planned = plan.plan()
    emit(phase="dryrun_plan", cell="hymba_long_500k",
         plan_seconds=time.perf_counter() - t0, kernels=planned["kernels"])

    def decode(fn, args):
        params, cache, tokens, pos = args
        reset_counts(ws)
        for i in (2, 1, 0):
            logits, cache = fn(params, cache, tokens, pos - i)
            tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return logits
    with _SizeSpy() as spy:
        measured, logits = _cell_on_card("hymba_long_500k", plan, planned,
                                         decode)
    cfg = get_config("hymba-1.5b")
    if tuple(logits.shape) != (1, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"dryrun: long_500k logits "
                             f"{tuple(logits.shape)} are not finite (1, "
                             f"{cfg.vocab})")
    for k, w in ws.items():
        totals[k] += w.launches
    asked.update(spy.asked)
    del logits
    torch.cuda.empty_cache()
    size_checks(asked)
    return {k: n for k, n in totals.items() if n}


def phase_examples(name):
    """The four examples' twins on the card -> launch totals."""
    import importlib.util
    ws = wrappers()
    reset_counts(ws)
    out = {}
    for ex, argv in (("quickstart_torch", ["--steps", "5"]),
                     ("finetune_lora_dp_torch", ["--steps", "10"]),
                     ("train_dp_lm_torch", ["--smoke", "--steps", "20",
                                            "--ckpt-dir", str(
                                                ROOT / "build" /
                                                "examples_dp_lm")]),
                     ("serve_decode_torch", ["hymba-1.5b"])):
        spec = importlib.util.spec_from_file_location(
            ex, ROOT / "examples" / f"{ex}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        res = mod.main(["--device", "cuda", *argv])
        out[ex] = {"seconds": time.perf_counter() - t0,
                   **({"losses": [res[0], res[-1]]}
                      if isinstance(res, list) else
                      {"shape": list(res.shape)})}
    shutil.rmtree(ROOT / "build" / "examples_dp_lm", ignore_errors=True)
    totals = {k: w.launches for k, w in ws.items() if w.launches}
    emit(phase=name, examples=out, launches=totals)
    return totals


def _serving_model(name, layers=0, dtype=""):
    """-> (cfg, model, params on the card from seed 0) of a serving path,
    cut to ``layers`` and cast to ``dtype`` where given."""
    from repro_torch.configs.registry import build, cut_depth, get_config
    cfg = cut_depth(get_config(SERVING[name]["arch"]), layers)
    if dtype:
        cfg = cfg.with_(param_dtype=dtype)
    if SERVING[name].get("patch_tokens"):
        cfg = cfg.with_(patch_tokens=SERVING[name]["patch_tokens"])
    model = build(cfg)
    return cfg, model, model.init(0, "cuda")


def _tokens(vocab, B, T):
    """(B, T) int32 tokens on the card, from seed 1."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    return torch.randint(0, vocab, (B, T), generator=gen, device="cuda",
                         dtype=torch.int32)


def _frames(cfg, B, Tf):
    """(B, Tf, frame_dim) f32 frames of audio on the card: ``make_batch``'s
    from seed 1."""
    from repro_torch.data.synthetic import make_batch
    return make_batch(cfg, B, Tf, seed=1, device="cuda")["frames"]


def _patches(cfg, B):
    """(B, patch_tokens, vit_dim) f32 patch embeddings on the card:
    ``make_batch``'s from seed 1, or None outside the vlm family."""
    from repro_torch.data.synthetic import make_batch
    if cfg.family != "vlm":
        return None
    return make_batch(cfg, B, 1, seed=1, device="cuda")["patches"]


def phase_prefill(name):
    """Three prefills of a full model through ``model.prefill`` (warm-up,
    timed, profiled) -> launch totals. Each prefill launches its kernel
    once a layer (``per_prefill`` where given) and no other kernel. An
    encoder-decoder model's prefill also takes ``frames`` of audio, a vlm's
    its patches (before the tokens)."""
    import torch
    run = SERVING[name]
    cfg, model, params = _serving_model(name)
    B, T = run["batch"], run["seq"]
    tokens = _tokens(cfg.vocab, B, T)
    patches = _patches(cfg, B)
    inputs = ((_frames(cfg, B, run["frames"]), tokens) if "frames" in run
              else (tokens,) if patches is None else (tokens, patches))
    ws = wrappers()
    fresh_peak()
    reset_counts(ws)                  # counts from here on are the path's
    seconds, per_call = [], []
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    for i in range(3):
        before = {k: w.launches for k, w in ws.items()}
        if i == 2:
            prof.start()
        t0 = time.perf_counter()
        logits = model.prefill(params, *inputs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if i == 2:
            prof.stop()
        per_call.append({k: w.launches - before[k] for k, w in ws.items()})
    totals = {k: w.launches for k, w in ws.items()}
    wgmma = check_routes(name, ws, True)
    peak = torch.cuda.max_memory_allocated()
    emit(phase=name, arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab, dtype=cfg.param_dtype,
         batch=B, seq=T, prefill_seconds=seconds, wgmma_launches=wgmma,
         tokens_per_s=B * T / seconds[1], max_memory_allocated=peak,
         **({"frames": run["frames"], "frames_and_tokens_per_s":
             B * (run["frames"] + T) / seconds[1]} if "frames" in run
            else {}),
         **({"patches": cfg.patch_tokens, "patches_and_tokens_per_s":
             B * (cfg.patch_tokens + T) / seconds[1]}
            if patches is not None else {}),
         launches_per_prefill={k: n for k, n in per_call[-1].items() if n},
         logits_shape=list(logits.shape))
    emit(phase=f"{name}_profile", call=2,
         **_profile_summary(prof, seconds[2] * 1e3))
    if tuple(logits.shape) != (B, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name}: logits {tuple(logits.shape)} are not "
                             f"finite (B, vocab) = {(B, cfg.vocab)}")
    want = _per_step(**{run["kernel"]: run.get("per_prefill",
                                                cfg.n_layers)})
    for i, got in enumerate(per_call):
        if got != want:
            raise AssertionError(f"{name} prefill {i}: launches {got}, want "
                                 f"{want}")
    del params, logits, inputs
    torch.cuda.empty_cache()
    return totals


def phase_serve(name):
    """``launch.serve.generate`` of a full model, twice (the second timed):
    B prompts teacher-forced through decode_step, then greedy tokens. With
    ``frames`` (whisper) each run first encodes the audio into the cross
    caches (``prefill_cross``: flash_attention once an encoder layer, on
    its wgmma route) and decodes against them."""
    import torch
    from repro_torch.launch.serve import generate
    run = SERVING[name]
    cfg, model, params = _serving_model(name)
    B, Tp, gen_len = run["batch"], run["prompt"], run["gen"]
    steps = Tp + gen_len
    prompts = _tokens(cfg.vocab, B, Tp)
    frames = _frames(cfg, B, run["frames"]) if "frames" in run else None
    ws = wrappers()
    fresh_peak()
    reset_counts(ws)
    seconds, cross = [], []
    for _ in range(2):
        cache = None
        if frames is not None:
            n0 = ws["flash_attention"].launches
            t0 = time.perf_counter()
            cache = model.prefill_cross(params, frames, model.init_cache(
                B, steps, Tf=run["frames"], device="cuda"))
            torch.cuda.synchronize()
            cross.append({"seconds": time.perf_counter() - t0, "launches":
                          ws["flash_attention"].launches - n0})
        t0 = time.perf_counter()
        out = generate(model, params, prompts, gen_len, cache=cache)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    if frames is not None:
        check_routes(name, ws, True)
        if any(c["launches"] != cfg.encoder_layers for c in cross):
            raise AssertionError(f"{name}: prefill_cross launched {cross}, "
                                 f"want flash_attention x "
                                 f"{cfg.encoder_layers}")
    emit(phase=name, arch=cfg.name, layers=cfg.n_layers, dtype=cfg.param_dtype,
         batch=B, prompt=Tp, gen=gen_len, generate_seconds=seconds,
         decode_ms_per_token=seconds[1] / steps * 1e3,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches={k: w.launches for k, w in ws.items() if w.launches},
         **({"frames": run["frames"], "prefill_cross": cross}
            if cross else {}),
         sample=out[0].tolist())
    if tuple(out.shape) != (B, steps) or not torch.equal(out[:, :Tp],
                                                         prompts):
        raise AssertionError(f"{name}: tokens {tuple(out.shape)} do not "
                             "continue the prompts")
    if int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
        raise AssertionError(f"{name}: tokens outside [0, {cfg.vocab})")
    del params
    torch.cuda.empty_cache()


def phase_serve_parity(name):
    """A 2-layer, full-width, f32 model: the prefill on the card (kernels)
    against the same params' prefill on the CPU (plain versions), a vlm's
    with its patches; the teacher-forced decode's logits at the last prompt
    position against the card's prefill (the gate of ``generate``; not
    where meta tokens or patches are prepended); with ``decode`` steps,
    each step's logits against the CPU's decode."""
    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.utils.tree import flatten, unflatten
    run = SERVING[name]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, model, params = _serving_model(name, layers=run.get("layers", 2),
                                        dtype="float32")
    tokens = _tokens(cfg.vocab, run["batch"], run["seq"])
    patches = _patches(cfg, run["batch"])
    extra = () if patches is None else (patches,)
    ws = wrappers()
    reset_counts(ws)
    clock = {"t": time.perf_counter()}
    seconds = {}

    def took(stage):
        now = time.perf_counter()
        seconds[stage] = now - clock["t"]
        clock["t"] = now

    before = {k: w.launches for k, w in ws.items()}
    got = model.prefill(params, tokens, *extra)
    torch.cuda.synchronize()
    took("card_prefill")
    launched = {k: w.launches - before[k] for k, w in ws.items()}
    cpu = unflatten({k: v.cpu() for k, v in flatten(params).items()})
    before = {k: w.launches for k, w in ws.items()}
    want = model.prefill(cpu, tokens.cpu(), *(t.cpu() for t in extra))
    took("cpu_prefill")
    decoded = tokens[:, :run.get("decode", tokens.shape[1])]
    _, steps = generate(model, params, decoded, 0, return_logits=True)
    torch.cuda.synchronize()
    took("card_decode")
    plain_launched = {k: w.launches - before[k] for k, w in ws.items()
                      if w.launches > before[k]}
    tol = TOL["float32"]
    cmp_cpu = compare(got.cpu(), want, tol)
    cmps = {}
    if "decode" in run:
        # every decode step held to the CPU's decode (hymba's decode
        # prepends no meta tokens, the JAX package's, so it is not held to
        # its prefill)
        cpu_steps = generate(model, cpu, decoded.cpu(), 0,
                             return_logits=True)[1]
        took("cpu_decode")
        cmps["decode_vs_cpu"] = compare(steps.cpu(), cpu_steps, tol)
        del cpu_steps
    if not (cfg.meta_tokens or extra) and \
            decoded.shape[1] == tokens.shape[1]:
        cmps["decode_vs_prefill"] = compare(steps[:, -1], got, tol)
    emit(phase=name, arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab, dtype="float32",
         batch=run["batch"], seq=run["seq"],
         patches=cfg.patch_tokens if extra else 0,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         prefill_vs_cpu=cmp_cpu, **cmps, decoded_tokens=decoded.shape[1],
         launched={k: n for k, n in launched.items() if n},
         launched_cpu_and_decode=plain_launched, seconds=seconds)
    if not (cmp_cpu["ok"] and all(c["ok"] for c in cmps.values())):
        raise AssertionError(f"{name}: card prefill vs CPU {cmp_cpu}, decode "
                             f"{cmps}")
    check_routes(name, ws, False)     # f32: the SIMT routes
    if launched != _per_step(**{run["kernel"]: run.get("per_prefill",
                                                       cfg.n_layers)}) or \
            plain_launched:
        raise AssertionError(f"{name}: launches {launched} in the card "
                             f"prefill, {plain_launched} on the CPU and in "
                             f"decode; want {run['kernel']} x "
                             f"{cfg.n_layers} and none")
    del params, cpu, steps, extra
    torch.cuda.empty_cache()


def phase_serve_parity_encdec(name):
    """An encoder-decoder model (whisper), 2 + 2 layers, full width, f32:
    on the card and on the CPU (the plain versions) from the same params,
    frames and tokens, (a) the prefill over ``seq`` = decoder_len tokens,
    (b) ``prefill_cross``'s caches, (c) the decode teacher-forced over every
    decoder position against those caches, each step's logits; on the card
    also (d) the last decode step against the prefill. The card's prefill
    launches flash_attention ``per_prefill`` times (SIMT: f32),
    prefill_cross once an encoder layer, decode none."""
    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.utils.tree import flatten, unflatten
    run = SERVING[name]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, model, params = _serving_model(name, layers=run["layers"],
                                        dtype="float32")
    B, Td, Tf = run["batch"], run["seq"], run["frames"]
    tokens, frames = _tokens(cfg.vocab, B, Td), _frames(cfg, B, Tf)
    ws = wrappers()
    reset_counts(ws)
    launched = {}
    got = model.prefill(params, frames, tokens)
    torch.cuda.synchronize()
    launched["prefill"] = {k: w.launches for k, w in ws.items()
                           if w.launches}
    check_routes(name, ws, False)     # f32: the SIMT routes
    reset_counts(ws)
    cache = model.prefill_cross(params, frames, model.init_cache(
        B, Td, Tf=Tf, device="cuda"))
    torch.cuda.synchronize()
    launched["prefill_cross"] = {k: w.launches for k, w in ws.items()
                                 if w.launches}
    check_routes(name, ws, False)     # f32: the SIMT routes
    reset_counts(ws)
    cross = {k: cache[k].cpu() for k in ("xk", "xv")}
    t0 = time.perf_counter()
    _, steps = generate(model, params, tokens, 0, return_logits=True,
                        cache=cache)
    torch.cuda.synchronize()
    card_decode_s = time.perf_counter() - t0
    cpu = unflatten({k: v.cpu() for k, v in flatten(params).items()})
    want = model.prefill(cpu, frames.cpu(), tokens.cpu())
    cpu_cache = model.prefill_cross(cpu, frames.cpu(), model.init_cache(
        B, Td, Tf=Tf, device="cpu"))
    cmp_cross = {k: compare(cross[k], cpu_cache[k], TOL["float32"])
                 for k in cross}
    t0 = time.perf_counter()
    cpu_steps = generate(model, cpu, tokens.cpu(), 0, return_logits=True,
                         cache=cpu_cache)[1]
    cpu_decode_s = time.perf_counter() - t0
    launched["decode_and_cpu"] = {k: w.launches for k, w in ws.items()
                                  if w.launches}
    tol = TOL["float32"]
    cmp_cpu = compare(got.cpu(), want, tol)
    cmp_dec = compare(steps.cpu(), cpu_steps, tol)
    cmp_last = compare(steps[:, -1], got, tol)
    emit(phase=name, arch=cfg.name, layers=cfg.n_layers,
         encoder_layers=cfg.encoder_layers, d_model=cfg.d_model,
         vocab=cfg.vocab, dtype="float32", batch=B, seq=Td, frames=Tf,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         prefill_vs_cpu=cmp_cpu, cross_caches_vs_cpu=cmp_cross,
         decode_vs_cpu=cmp_dec, decode_vs_prefill=cmp_last,
         decoded_tokens=Td, card_decode_seconds=card_decode_s,
         cpu_decode_seconds=cpu_decode_s, launched=launched)
    ok = cmp_cpu["ok"] and cmp_dec["ok"] and cmp_last["ok"] and all(
        c["ok"] for c in cmp_cross.values())
    if not ok:
        raise AssertionError(f"{name}: prefill vs CPU {cmp_cpu}, cross "
                             f"caches {cmp_cross}, decode vs CPU {cmp_dec}, "
                             f"decode vs prefill {cmp_last}")
    want_launched = {"prefill": {run["kernel"]: run["per_prefill"]},
                     "prefill_cross": {run["kernel"]: cfg.encoder_layers},
                     "decode_and_cpu": {}}
    if launched != want_launched:
        raise AssertionError(f"{name}: launches {launched}, want "
                             f"{want_launched}")
    del params, cpu, steps, cpu_steps, cache, cpu_cache
    torch.cuda.empty_cache()


# one BK step with and without the kernels: (path, layers, mode, expected
# kernel launches in the kernel run, per policy)
PARITY = {
    "parity": ("train", 2, "bk-mixopt", ("ghost_norm", "clipped_grad")),
    "parity_moe": ("train_moe", 2, "bk-mixopt",
                   ("moe_ghost_norm", "moe_clipped_grad")),
    "parity_long": ("train_long", 2, "bk-mixghost", ("grad_norm_direct",)),
    "parity_layer": ("train_layer", 2, "bk-mixopt",
                     ("ghost_norm", "clipped_grad", "emb_ghost_norm",
                      "emb_clipped_grad")),
}
# a parity phase's case at the arch's smoke_config width (f32, the path's B
# and T), where fused_plan fuses every mm unit: the driven path of
# fused_clip_grad, whose launches count as the path's
PARITY_SMOKE = {"parity_layer": ("fused_clip_grad", "emb_ghost_norm",
                                 "emb_clipped_grad")}


def phase_parity(name):
    """One BK step with and without the kernels, 2 layers, full width, f32,
    under the path's policy (and, for the MoE path, with the experts forced
    to the direct norm too; for parity_layer, also at smoke width) -> the
    kernel launches of the smoke-width case (none without one)."""
    import torch
    from repro_torch.configs.registry import build, smoke_config
    from repro_torch.core.bk import bk_clipped_sum
    from repro_torch.data.synthetic import make_batch

    path, layers, mode, expect = PARITY[name]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, dp = run_config(path)
    B, T = RUNS[path]["batch"], RUNS[path]["seq"]
    policies = [(mode, dp, expect)]
    if path == "train_moe":
        policies.append(("bk-mixopt experts=direct",
                         run_config("train_moe_direct")[1],
                         ("moe_direct_norm", "moe_clipped_grad")))
    # (model config, policies, whether its kernel launches count as the
    # path's)
    cases = [(cfg.with_(n_layers=layers, param_dtype="float32"), policies,
              False)]
    if name in PARITY_SMOKE:
        cases.append((smoke_config(cfg.name).with_(param_dtype="float32"),
                      [(f"{mode} smoke width", dp, PARITY_SMOKE[name])],
                      True))
    rtol, atol = TOL["float32"]
    ws = wrappers()
    reset_counts(ws)
    counted = {}
    for small, pols, counts in cases:
        model = build(small)
        params = model.init(seed=1, device="cuda")
        batch = make_batch(small, B, T, seed=1, device="cuda")
        for label, pol, want_launched in pols:
            out, launched = {}, {}
            for use in (True, False):
                before = {k: w.launches for k, w in ws.items()}
                p = dataclasses.replace(pol, mode=mode, use_kernels=use)
                out[use] = bk_clipped_sum(model.apply, params, batch, p)
                torch.cuda.synchronize()
                launched[use] = {k: w.launches - before[k]
                                 for k, w in ws.items()
                                 if w.launches > before[k]}
            (sk, ak), (sp, ap) = out[True], out[False]
            worst, bad = 0.0, []
            pairs = [(f"sum:{k}", sk[k], sp[k]) for k in sorted(sk)]
            pairs.append(("per_sample_norms", ak["per_sample_norms"],
                          ap["per_sample_norms"]))
            pairs += [(f"group_norms:{k}", ak["group_norms"][k],
                       ap["group_norms"][k]) for k in ak["group_norms"]]
            for key, g, w in pairs:
                diff = (g.double() - w.double()).abs()
                worst = max(worst, float(diff.max()))
                if not bool((diff <= atol + rtol * w.double().abs()).all()):
                    bad.append(key)
            emit(phase=name, policy=label, arch=small.name,
                 layers=small.n_layers, d_model=small.d_model,
                 vocab=small.vocab, dtype="float32", batch=B, seq=T,
                 allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                 cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                 rtol=rtol, atol=atol, compared=len(pairs),
                 max_abs_err=worst, failed=bad, launched=launched[True])
            if bad:
                raise AssertionError(f"{name} [{label}]: kernel path "
                                     f"disagrees with use_kernels=False on "
                                     f"{bad}")
            if launched[False] or not all(launched[True].get(k)
                                          for k in want_launched):
                raise AssertionError(f"{name} [{label}]: launches "
                                     f"{launched}, want {want_launched} in "
                                     "the kernel run and none in the plain "
                                     "run")
            if counts:
                counted = launched[True]
            check_routes(name, ws, False)     # f32: the SIMT routes
            if not counts and label == mode:
                update_parity(name, params, sk, pol, B)
            if counts:
                optimizer_parity(name, params, sk, pol, B)
            del out, sk, sp
        del model, params, batch
        torch.cuda.empty_cache()
    return counted


def update_parity(name, params, sums, policy, B):
    """One noised AdamW step (sigma of the path's policy, weight decay 0.1)
    over the clipped sums ``sums`` of a parity model (f32): the train
    step's route (``noise_leaf_fn(..., out="deferred")`` into
    ``update_leaves``: one noise_update launch a leaf) against the plain
    version leaf by leaf (``noise_update.plain``), params and both moments
    at f32 TOL."""
    import torch
    from repro_torch.core.noise import fold_in, prng_key
    from repro_torch.core.policy import noise_leaf_fn, resolve_policy
    from repro_torch.kernels import noise_update as nu
    from repro_torch.optim.optimizers import adamw
    from repro_torch.utils.tree import flatten, unflatten

    flat = flatten(params)
    res = resolve_policy(policy, flat)
    leaf = noise_leaf_fn(policy, res, fold_in(prng_key(1), 0), float(B), 0,
                         out="deferred")
    opt = adamw(lambda s: 3e-4, weight_decay=0.1)
    got = unflatten({k: v.clone() for k, v in flat.items()})
    state = opt.init(got)
    n0 = nu.noise_update.launches
    opt.update_leaves(lambda path, p: leaf(path, sums[path]), state, got, 0)
    launches = nu.noise_update.launches - n0
    hp = nu.AdamW(3e-4, 0.9, 0.999, 1e-8, 1.0 - 0.9, 1.0 - 0.999, 0.1)
    worst, bad = 0.0, []
    fg, fm, fv = flatten(got), flatten(state["m"]), flatten(state["v"])
    for path, p in flat.items():
        pp, mp = p.clone(), torch.zeros_like(p)
        vp = torch.zeros_like(p)
        nu.plain(leaf(path, sums[path]), pp, mp, vp, hp)
        for key, g, w in (("p", fg[path], pp), ("m", fm[path], mp),
                          ("v", fv[path], vp)):
            cmp = compare(g, w, TOL["float32"])
            worst = max(worst, cmp["max_abs_err"])
            if not cmp["ok"]:
                bad.append(f"{key}:{path}")
        del pp, mp, vp
    emit(phase=name, case="noised update step", sigma=policy.sigma,
         leaves=len(flat), noise_update_launches=launches,
         rtol=TOL["float32"][0], atol=TOL["float32"][1], max_abs_err=worst,
         failed=bad)
    if bad or launches != len(flat):
        raise AssertionError(f"{name}: the noised update step disagrees "
                             f"with its plain version on {bad} ({launches} "
                             f"launches for {len(flat)} leaves)")
    del got, state, fg, fm, fv
    torch.cuda.empty_cache()


# one BK step of a family's small, full-width, f32 model on the card against
# the CPU: its train path (policy, T), depth, batch, the kernels its kernel
# run must launch (``per_layer``: once a layer), the kernel opacus must
# launch under vmap(grad) (None: any), and whether the card also runs the
# step with ``use_kernels=False``. parity_rwkv at train_rwkv's T, 1 layer
# (cut from 2 to keep the whole script in its time);
# parity_hymba at 5 layers (global 0, 2, 4: one layer a sliding-window
# segment, whose fuse_o bk-mixopt then caches: no grad_norm_direct)
FAMILY_PARITY = {
    # wkv6 twice a layer (the forward and remat's recompute), its backward
    # once
    "parity_rwkv": dict(path="train_rwkv", layers=1, batch=4,
                        want=("wkv6", "wkv6_backward", "ghost_norm",
                              "clipped_grad", "emb_ghost_norm",
                              "emb_clipped_grad"),
                        per_layer={"wkv6": 2, "wkv6_backward": 1},
                        opacus="wkv6_backward", vs_plain=False),
    "parity_hymba": dict(path="train_hymba", layers=5, batch=4,
                         want=("ghost_norm", "clipped_grad", "emb_ghost_norm",
                               "emb_clipped_grad"),
                         per_layer={}, opacus=None, vs_plain=True),
    # whisper at 2 + 2 layers, Tf = 1500, Td = 448: the encoder's taps and
    # xattn/kv take the direct norm, which bk-mixopt caches at 2 layers (no
    # grad_norm_direct launch); the decoder's and the head the ghost norm
    "parity_whisper": dict(path="train_whisper", layers=2, batch=2,
                           want=("ghost_norm", "clipped_grad",
                                 "emb_ghost_norm", "emb_clipped_grad"),
                           per_layer={}, opacus=None, vs_plain=True),
    # qwen3-14b at 2 layers, B=2, T=128 (the CPU's step at full width, V
    # 151936 and d 5120, in the time): qk-norm's per-sample (B, h) scales on
    # the psp route, remat on the BK step; every tap ghost. Then its
    # prefill and decode (SERVING["parity_qwen3"])
    "parity_qwen3": dict(path="train_qwen3", layers=2, batch=2, seq=128,
                         want=("ghost_norm", "clipped_grad", "emb_ghost_norm",
                               "emb_clipped_grad"),
                         per_layer={}, opacus=None, vs_plain=True),
    # internvl2-26b at 2 layers, B=2, 64 tokens after 128 of its 1024
    # patches (the CPU's step at full width, V 92553 and d 6144, in the
    # time): the projector's tap and its bias on the psp route, the head
    # over the patch positions too; every tap ghost
    "parity_internvl2": dict(path="train_internvl2", layers=2, batch=2,
                             seq=64, patch_tokens=128,
                             want=("ghost_norm", "clipped_grad",
                                   "emb_ghost_norm", "emb_clipped_grad"),
                             per_layer={}, opacus=None, vs_plain=True),
}


def phase_parity_family(name):
    """One BK step of a small, full-width, f32 model of a family
    (``FAMILY_PARITY``; bk-mixopt, sigma 1.0, as its train path's policy,
    at its train path's T) on the card, the kernels launched, against the
    same params and batch on the CPU (the plain versions: rwkv6's
    recurrence by the JAX package's route, autograd of wkv6_chunked;
    hymba's chunked SSM and banded attention, the same torch ops as on the
    card), and where ``vs_plain`` against ``use_kernels=False`` on the
    card: per-sample norms at NORM_TOL, sums at f32 TOL. On the card
    rwkv6's recurrence always takes wkv6 and wkv6_backward. Then one noised
    AdamW step over the card's sums against its plain version
    (``update_parity``), and bk-mixopt against opacus on the card at sigma
    0 (norms at NORM_TOL, grads at f32 TOL; rwkv6's opacus runs Wkv6Fn
    under vmap(grad)). -> {} (these launches do not count as a path's)."""
    import torch
    from repro_torch.configs.registry import build, cut_depth
    from repro_torch.core.bk import bk_clipped_sum
    from repro_torch.core.engine import make_grad_fn
    from repro_torch.core.noise import prng_key
    from repro_torch.core.policy import as_policy
    from repro_torch.data.synthetic import make_batch
    from repro_torch.utils.tree import flatten, unflatten

    fam = FAMILY_PARITY[name]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, dp = run_config(fam["path"])
    dp = as_policy(dp)               # a flat DPConfig: its one-unit policy
    small = cut_depth(cfg, fam["layers"]).with_(param_dtype="float32")
    if "patch_tokens" in fam:
        small = small.with_(patch_tokens=fam["patch_tokens"])
    B, T = fam["batch"], fam.get("seq", RUNS[fam["path"]]["seq"])
    model = build(small)
    params = model.init(seed=1, device="cuda")
    batch = make_batch(small, B, T, seed=1, device="cuda")
    ws = wrappers()
    reset_counts(ws)
    t0 = time.perf_counter()
    sk, ak = bk_clipped_sum(model.apply, params, batch, dp)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launched = {k: w.launches for k, w in ws.items() if w.launches}
    check_routes(name, ws, False)             # f32: the SIMT routes
    refs = {}
    if fam["vs_plain"]:
        reset_counts(ws)
        t0 = time.perf_counter()
        refs["card use_kernels=False"] = bk_clipped_sum(
            model.apply, params, batch,
            dataclasses.replace(dp, use_kernels=False))
        torch.cuda.synchronize()
        refs["card use_kernels=False"] += (time.perf_counter() - t0,)
        if any(w.launches for w in ws.values()):
            raise AssertionError(f"{name}: use_kernels=False launched "
                                 f"{ {k: w.launches for k, w in ws.items()} }")
    cpu_params = unflatten({k: v.cpu() for k, v in flatten(params).items()})
    t0 = time.perf_counter()
    refs["card vs CPU"] = bk_clipped_sum(
        model.apply, cpu_params, {k: v.cpu() for k, v in batch.items()}, dp)
    refs["card vs CPU"] += (time.perf_counter() - t0,)
    del cpu_params
    rtol, atol = TOL["float32"]
    failed = []
    for case, (sp, ap, ref_s) in refs.items():
        worst, bad = 0.0, []
        pairs = [(f"sum:{k}", sk[k], sp[k], TOL["float32"])
                 for k in sorted(sk)]
        pairs.append(("per_sample_norms", ak["per_sample_norms"],
                      ap["per_sample_norms"], NORM_TOL))
        for key, g, w, tol in pairs:
            # on the card: the f32 sums reach 2.2 G elements (qwen3-14b)
            cmp = compare(g, w.to(g.device), tol)
            worst = max(worst, cmp["max_abs_err"])
            if not cmp["ok"]:
                bad.append(key)
        emit(phase=name, case=case, arch=small.name,
             layers=small.n_layers, d_model=small.d_model, vocab=small.vocab,
             dtype="float32", batch=B, seq=T, mode=dp.mode, sigma=dp.sigma,
             patches=small.patch_tokens,
             rtol=rtol, atol=atol, norm_tol=NORM_TOL, compared=len(pairs),
             max_abs_err=worst, failed=bad, launched=launched,
             card_seconds=card_s, reference_seconds=ref_s)
        failed += [f"{case}: {k}" for k in bad]
    per_layer_bad = [k for k, n in fam["per_layer"].items()
                     if launched.get(k) != n * small.n_layers]
    if failed or per_layer_bad or \
            not all(launched.get(k) for k in fam["want"]):
        raise AssertionError(f"{name}: the card's step disagrees on "
                             f"{failed}, or launched {launched} (want "
                             f"{fam['want']}, {fam['per_layer']} a layer)")
    del refs
    t0 = time.perf_counter()
    update_parity(name, params, sk, dp, B)
    emit(phase=name, case="noised update step seconds",
         seconds=time.perf_counter() - t0)
    del sk, ak
    # bk-mixopt against opacus on the card, sigma 0
    out = {}
    for mode in ("opacus", "bk-mixopt"):
        reset_counts(ws)
        floor = fresh_peak()
        t0 = time.perf_counter()
        grads, aux = make_grad_fn(model.apply, dataclasses.replace(
            dp, mode=mode, sigma=0.0))(params, batch, prng_key(7))
        torch.cuda.synchronize()
        out[mode] = (flatten(grads), aux, {
            "seconds": time.perf_counter() - t0,
            "launched": {k: w.launches for k, w in ws.items() if w.launches},
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "allocated_at_start": floor})
        del grads
    (ref, ref_aux, ref_stats), (got, aux, stats) = out["opacus"], \
        out["bk-mixopt"]
    worst, bad = 0.0, []
    for k in sorted(ref):
        cmp = compare(got[k], ref[k], (rtol, atol))
        worst = max(worst, cmp["max_abs_err"])
        if not cmp["ok"]:
            bad.append(k)
    norms = compare(aux["per_sample_norms"], ref_aux["per_sample_norms"],
                    NORM_TOL)
    emit(phase=name, case="bk-mixopt vs opacus", sigma=0.0,
         grads_max_abs_err=worst, rtol=rtol, atol=atol, norms=norms,
         failed=bad, opacus=ref_stats, bk_mixopt=stats)
    if bad or not norms["ok"] or (
            fam["opacus"] and not ref_stats["launched"].get(fam["opacus"])):
        raise AssertionError(f"{name}: bk-mixopt disagrees with opacus on "
                             f"{bad}, norms {norms}, or opacus launched "
                             f"{ref_stats['launched']} (want {fam['opacus']} "
                             f"under vmap)")
    del model, params, batch, out, ref, got
    torch.cuda.empty_cache()
    if name in SERVING:
        phase_serve_parity(name)
    return {}


# the optimizers held card to CPU by optimizer_parity, with their knobs;
# each takes OPT_STEPS steps: under ftrl's tree noise (restarts every 2,
# completion) step 1 completes the tree and step 2 restarts it and the
# anchor
PARITY_OPTIMIZERS = {"ftrl": dict(momentum=0.9, restart_every=2),
                     "lamb": {}, "adafactor": {}}
OPT_STEPS = 3
# optimizer_parity's step check: each param's change over OPT_STEPS, card
# against CPU, within STEP_TOL of the leaf's largest change. f32 TOL alone
# (atol 1e-4) is about a whole step's change at lr 3e-4: it could not fail
# a halved lr or a flipped sign.
STEP_TOL = 1e-2


def _optimizer_run(name, params, sums, policy, B, dev, lr=3e-4):
    """OPT_STEPS deferred steps of optimizer ``name`` (``lr``, constant)
    from ``params`` over the clipped sums ``sums``, every tensor copied to
    ``dev`` -> (flat params, flat state, noise_update and counter_noise
    launches). ftrl draws the tree noise the train driver switches it to;
    lamb and adafactor the policy's Gaussian noise."""
    import torch
    from repro_torch.core.noise import fold_in, prng_key
    from repro_torch.core.policy import noise_leaf_fn, resolve_policy
    from repro_torch.kernels import counter_noise as cn
    from repro_torch.kernels import noise_update as nu
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.utils.tree import flatten, unflatten

    if name == "ftrl":
        policy = dataclasses.replace(policy, noise="tree", noise_depth=2,
                                     noise_restart_every=2,
                                     noise_completion=True)
    flat = {k: v.detach().to(dev, copy=True)
            for k, v in flatten(params).items()}
    res = resolve_policy(policy, flat)
    opt = make_optimizer(name, lambda s: lr, **PARITY_OPTIMIZERS[name])
    p = unflatten(flat)
    state = opt.init(p)
    n0 = (nu.noise_update.launches, cn.counter_noise.launches)
    for step in range(OPT_STEPS):
        leaf = noise_leaf_fn(policy, res, fold_in(prng_key(1), step),
                             float(B), step, out="deferred")
        # a copy of each sum: lamb and adafactor draw over it in place
        opt.update_leaves(lambda path, q: leaf(
            path, sums[path].to(dev, copy=True)), state, p, step)
    if dev != "cpu":
        torch.cuda.synchronize()
    return flatten(p), flatten(state), (
        nu.noise_update.launches - n0[0],
        cn.counter_noise.launches - n0[1])


def optimizer_gap(got_p, got_s, want_p, want_s, p0) -> dict:
    """optimizer_parity's comparison of two runs of one optimizer from the
    params ``p0`` (flat dicts): every param and state leaf at f32 TOL and
    finite, and every param's change ``p - p0`` within STEP_TOL of the
    leaf's largest change in ``want`` (a leaf that ``want`` leaves as it
    was must stay so) -> {max_abs_err, step_err (the largest change gap
    over its leaf's largest change), step_min / step_max (the smallest and
    largest leaf's largest change), failed}."""
    import torch
    worst, bad = 0.0, []
    for key, got, want in ([("p:" + k, got_p[k], want_p[k]) for k in want_p]
                           + [("state:" + k, got_s[k], want_s[k])
                              for k in want_s]):
        got = got.cpu()
        cmp = compare(got, want.cpu(), TOL["float32"])
        worst = max(worst, cmp["max_abs_err"])
        if not cmp["ok"] or not bool(torch.isfinite(got).all()):
            bad.append(key)
    step_err, sizes = 0.0, []
    for k, p in p0.items():
        before = p.cpu().double()
        d_want = want_p[k].cpu().double() - before
        gap = float((got_p[k].cpu().double() - before - d_want).abs().max())
        size = float(d_want.abs().max())
        sizes.append(size)
        err = gap / size if size else (0.0 if gap == 0 else math.inf)
        step_err = max(step_err, err)
        if not err <= STEP_TOL:
            bad.append("step:" + k)
    return {"max_abs_err": worst, "step_err": step_err,
            "step_min": min(sizes), "step_max": max(sizes), "failed": bad}


def optimizer_parity(name, params, sums, policy, B):
    """DP-FTRL (tree noise, restarts), LAMB and Adafactor, OPT_STEPS noised
    steps each over the clipped sums ``sums`` of a parity model (f32): the
    port's run on the card (ftrl: one noise_update launch a leaf a step;
    lamb, adafactor: one counter_noise launch a noised leaf a step) held to
    its run on the CPU (the plain versions) by ``optimizer_gap``: params
    and every state leaf at f32 TOL, each param's change within STEP_TOL
    of its leaf's largest."""
    import torch
    from repro_torch.core.policy import resolve_policy
    from repro_torch.utils.tree import flatten

    p0 = flatten(params)
    leaves = len(p0)
    noised = len(resolve_policy(policy, p0).unit_of)
    for opt in PARITY_OPTIMIZERS:
        t0 = time.perf_counter()
        gp, gs, launched = _optimizer_run(opt, params, sums, policy, B,
                                          "cuda")
        seconds = time.perf_counter() - t0
        wp, ws, _ = _optimizer_run(opt, params, sums, policy, B, "cpu")
        gap = optimizer_gap(gp, gs, wp, ws, p0)
        bad = gap["failed"]
        want_launched = ((OPT_STEPS * leaves, 0) if opt == "ftrl"
                         else (0, OPT_STEPS * noised))
        emit(phase=name, case=f"{opt} card vs cpu", steps=OPT_STEPS,
             sigma=policy.sigma, leaves=leaves,
             noise_update_launches=launched[0],
             counter_noise_launches=launched[1], card_seconds=seconds,
             rtol=TOL["float32"][0], atol=TOL["float32"][1],
             step_tol=STEP_TOL, **gap)
        if bad or launched != want_launched:
            raise AssertionError(f"{name} [{opt}]: the card run disagrees "
                                 f"with the CPU run on {bad} (launches "
                                 f"{launched}, want {want_launched})")
        del gp, gs, wp, ws
        torch.cuda.empty_cache()


# parity_modes: every mode of core.engine against opacus, f32 (name, B, T):
# qwen2-1.5b at full width and 2 layers under its registered policy, as
# parity runs it, and the MLP of the paper's Figure 2 ("wide" in
# benchmarks/fig2_mlp.py: 128 -> 1024 x 6 -> 10, B = 64) under one flat
# automatic-clipping group
MODES_MODELS = (("qwen2-1.5b", 8, 512), ("mlp_fig2_wide", 64, 0))
# the kernels a mode launches on them (use_kernels: the baselines other
# than ghostclip launch none)
MODES_KERNELS = {"ghostclip": {"qwen2-1.5b": ("ghost_norm",
                                              "emb_ghost_norm"),
                               "mlp_fig2_wide": ("ghost_norm",)}}


def phase_parity_modes(name):
    """All eight modes of ``core.engine.make_grad_fn`` on the card, f32,
    one seed, against ``opacus`` (vmap(grad): every per-sample grad
    instantiated): at sigma 0 the per-sample norms at NORM_TOL and the
    grads at f32 TOL (nonprivate, which clips nothing: finite, and against
    opacus's loss); then at sigma 0.7 every DP mode's noised grads against
    opacus's at the same TOL (the same noise in every mode). Reports each
    mode's seconds and peak memory (opacus's: every per-sample grad at
    once). -> {} (the launches of these steps do not count as a path's)."""
    import torch
    from repro_torch.configs.registry import build, get_config
    from repro_torch.core.bk import DPConfig
    from repro_torch.core.engine import ALL_MODES, make_grad_fn
    from repro_torch.core.noise import prng_key
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.train import resolve_dp
    from repro_torch.models.mlp import MLP, MLPConfig
    from repro_torch.utils.tree import flatten

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ws = wrappers()
    rtol, atol = TOL["float32"]
    for model_name, B, T in MODES_MODELS:
        if model_name == "mlp_fig2_wide":
            mcfg = MLPConfig(d_in=128, width=1024, depth=6, n_classes=10)
            model = MLP(mcfg)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(1)
            batch = {"x": torch.randn(B, mcfg.d_in, generator=gen,
                                      device="cuda"),
                     "y": torch.randint(0, mcfg.n_classes, (B,),
                                        generator=gen, device="cuda")}
            policy = DPConfig(clipping="automatic", R=1.0)
            shape = dict(d_in=mcfg.d_in, width=mcfg.width, depth=mcfg.depth)
        else:
            cfg = get_config(model_name).with_(n_layers=2,
                                               param_dtype="float32")
            model = build(cfg)
            batch = make_batch(cfg, B, T, seed=1, device="cuda")
            policy = resolve_dp(model_name, "auto", "bk", "automatic", 0.0,
                                log=lambda m: None)
            shape = dict(layers=cfg.n_layers, d_model=cfg.d_model,
                         vocab=cfg.vocab)
        params = model.init(seed=1, device="cuda")

        def run(mode, sigma):
            pol = dataclasses.replace(policy, mode=mode, sigma=sigma)
            reset_counts(ws)
            floor = fresh_peak()
            t0 = time.perf_counter()
            grads, aux = make_grad_fn(model.apply, pol)(params, batch,
                                                        prng_key(7))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launched = {k: w.launches for k, w in ws.items() if w.launches}
            check_routes(f"{name} {mode}", ws, False)    # f32: SIMT routes
            return flatten(grads), aux, {
                "seconds": seconds, "launched": launched,
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "allocated_at_start": floor}

        for sigma in (0.0, 0.7):
            ref, ref_aux, ref_stats = run("opacus", sigma)
            emit(phase=name, model=model_name, batch=B, seq=T, sigma=sigma,
                 mode="opacus", **shape, **ref_stats)
            for mode in ALL_MODES:
                if mode == "opacus" or (sigma and mode == "nonprivate"):
                    continue
                got, aux, stats = run(mode, sigma)
                want = MODES_KERNELS.get(mode, {}).get(model_name, ()) + (
                    ("counter_noise",) if sigma else ())
                if sorted(stats["launched"]) != sorted(want) and \
                        not mode.startswith("bk"):
                    raise AssertionError(f"{name} [{model_name} {mode}]: "
                                         f"launched {stats['launched']}, "
                                         f"want {want}")
                if mode == "nonprivate":
                    if not all(bool(torch.isfinite(g).all())
                               for g in got.values()):
                        raise AssertionError(f"{name} [{model_name}]: "
                                             "nonprivate grads not finite")
                    cmp = compare(aux["loss"], ref_aux["loss"], NORM_TOL)
                    emit(phase=name, model=model_name, sigma=sigma,
                         mode=mode, loss_vs_opacus=cmp, **stats)
                    if not cmp["ok"]:
                        raise AssertionError(f"{name} [{model_name}]: "
                                             f"nonprivate loss {cmp}")
                    continue
                worst, bad = 0.0, []
                for k in sorted(ref):
                    cmp = compare(got[k], ref[k], (rtol, atol))
                    worst = max(worst, cmp["max_abs_err"])
                    if not cmp["ok"]:
                        bad.append(k)
                norms = compare(aux["per_sample_norms"],
                                ref_aux["per_sample_norms"], NORM_TOL)
                emit(phase=name, model=model_name, sigma=sigma, mode=mode,
                     grads_max_abs_err=worst, rtol=rtol, atol=atol,
                     norms=norms, failed=bad, **stats)
                if bad or not norms["ok"]:
                    raise AssertionError(f"{name} [{model_name} {mode}, "
                                         f"sigma {sigma}]: disagrees with "
                                         f"opacus on {bad}, norms {norms}")
                del got, aux
            del ref, ref_aux
        del model, params, batch
        torch.cuda.empty_cache()
    return {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES + EXTRA_PHASES}")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES + EXTRA_PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}; known: "
                 f"{PHASES + EXTRA_PHASES}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    t0 = time.perf_counter()
    timer = {"t": t0}

    def lap(name):
        now = time.perf_counter()
        emit(phase="phase_seconds", name=name, seconds=now - timer["t"])
        timer["t"] = now

    phase_card()
    if {"build", "kernels", "wgmma", "noise"} & set(phases):
        phase_build()
        lap("build")
    if "wgmma" in phases:
        phase_kernels(only_wgmma=True)
    if "noise" in phases:
        phase_kernels(only_noise=True)
    summary = phase_kernels() if "kernels" in phases else None
    lap("kernels")
    launches, train_stats = {}, {}
    for name in TRAINS + PREFILLS:
        if name in phases:
            totals = (phase_train(name, train_stats) if name in TRAINS
                      else phase_prefill(name))
            for k, n in totals.items():
                launches[k] = launches.get(k, 0) + n
            lap(name)
    for name in CNN_TRAINS:
        if name in phases:
            for k, n in phase_train_cnn(name).items():
                launches[k] = launches.get(k, 0) + n
            lap(name)
    for name in MESHES:
        if name in phases:
            phase_train_mesh2(name)
            lap(name)
    for name in RESUMES:
        if name in phases:
            for k, n in phase_train_resume(name).items():
                launches[k] = launches.get(k, 0) + n
            lap(name)
    if all(p in train_stats for p in ("train", "train_nonprivate",
                                      "train_ghostclip")):
        emit(**paper_ratios(train_stats))
    for name in SERVES:
        if name in phases:
            phase_serve(name)
            lap(name)
    for name in PARITIES:
        if name in phases:
            run = (phase_parity_modes if name == "parity_modes" else
                   phase_parity_cnn if name == "parity_cnn" else
                   phase_parity_family if name in FAMILY_PARITY else
                   phase_parity)
            for k, n in run(name).items():
                launches[k] = launches.get(k, 0) + n
            lap(name)
    for name in SERVE_PARITIES:
        if name in phases:
            (phase_serve_parity_encdec if "frames" in SERVING[name]
             else phase_serve_parity)(name)
            lap(name)
    for name in PLANS:
        if name in phases:
            run = phase_dryrun if name == "dryrun" else phase_examples
            for k, n in run(name).items():
                launches[k] = launches.get(k, 0) + n
            lap(name)
    if summary is not None:
        kernels = []
        for name, s in summary.items():
            kernels.append({
                "name": name, "route": "cuda",
                "source": CSRC + SOURCES[name][0],
                "replaces": NO_TPU_KERNEL.get(
                    name, "src/repro/kernels/" + str(SOURCES[name][1])),
                "launches": launches.get(name) if launches else None,
                "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                "bound_by": ("bytes" if s["t_bytes"] >= s["t_ops"]
                             else "operations"),
                "library_ms": s["library_ms"],
                **({"library": "none: " + NO_LIBRARY[name]}
                   if name in NO_LIBRARY else
                   {"library": LIBRARY_NOTE[name]}
                   if name in LIBRARY_NOTE else {}),
                **({k: s[k] for k in ("composed_ms", "device_ms")
                    if k in s}),
                # noise_update's FTRL branch over train's leaves: its own
                # time, plain time and bound, by step kind
                **({"ftrl": {**FTRL_ROW, "library_ms": None, "library":
                             "none: no single call computes the FTRL "
                             "step"}}
                   if name == "noise_update" and FTRL_ROW else {}),
                # the block route over one rank's blocks of train's leaves
                # beside the contiguous route over the same elements
                **({"shard_block_route": BLOCK_ROW[name]}
                   if name in BLOCK_ROW else {}),
                # its device time by torch.profiler: the main path's own
                # step (the kernels phase's short sessions lose events)
                **({"train_step_device_ms":
                    train_stats[STEP_DEVICE[name]][f"{name}_ms"]}
                   if STEP_DEVICE.get(name) in train_stats else {}),
                **({"simt_ms": s["simt_ms"],
                    "simt_source": CSRC + {**WGMMA, **CHUNKED}[name][0]}
                   if name in WGMMA or name in CHUNKED else {})})
        emit(kernels=kernels)
        if all(p in phases for p in TRAINS + CNN_TRAINS + PREFILLS
               + tuple(PARITY_SMOKE)):
            idle = [k["name"] for k in kernels if not k["launches"]]
            if idle:
                raise AssertionError(f"kernels never launched on the train, "
                                     f"prefill and smoke-width parity paths: "
                                     f"{idle}")
    emit(phase="done", seconds=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
