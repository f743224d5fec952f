#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --long-passes [ops,ring,mixer,mega]

Needs one CUDA card (Hopper, sm_90a) and ``nvcc``; exits non-zero, with
no result line, when there is no card or the port is missing. The second
form times the long-line passes op by op (``long_passes_main``) and
prints no result line. Phases,
each printing one JSON line (any failed check raises and exits non-zero):

1. device  — the card's name and power limit (the raw nvidia-smi line is
             printed on a line of its own), torch / CUDA versions; TF32 is
             switched off for matmul and cuDNN.
2. build   — nvcc builds every kernel from ``src/repro_torch/kernels/csrc``,
             forced, so a second run in the same checkout reports ptxas's
             registers and spills per instantiation too (and per
             out-of-line Stockham op, 'kernel/stockham_n<layout,N,...>')
             and each source's seconds (all compile at once; the matmul
             route's operand forms of the megakernels build from
             ``mega.cu`` into a library of their own, ``mega_forms.cu``,
             and both megakernels for chains with a line past one
             block into others, ``mega_long.cu``, ``staged_long.cu``
             and ``mega_long_forms.cu``);
             ``cuobjdump -sass`` must show HMMA TF32 instructions in the
             matmul instantiations of ``spectral_kernel``,
             ``mega_resident`` and ``mega_staged`` (the tensor-core
             stage), and HMMA BF16 / F16 in the bf16 / f16 / bs16 ones.
3. kernel  — the CUDA spectral kernel against its plain PyTorch version on
             the card: every filter mode x axis x fwd/inv combination at
             N in {128, 4096}, B in {1, 2}, 37 lines (ragged against every
             tile), tolerance 2e-4 x max|want|; each N = 4096 case also
             against a complex128 ``torch.fft`` oracle at 1e-5 x max|want|
             (the outer phase rounded as the kernels round it).
4. main    — the main path at the paper's size: ``simulate`` a 4096^2
             scene, ``build_pipeline(cfg, "fused3").run(raw)`` with the
             launch counts reset just before and read just after (exactly
             3 spectral launches and no other), all five targets within 8 px of ``metrics.expected_pixel``
             (argmax over a +-64 px window), the same compiled plan replayed
             through the plain version on the card (same peaks, |dSNR| <=
             0.1 dB), the image within 1e-5 x max|want| of the plan in
             complex128, each launch's inputs through kernel and plain
             version;
             then ``fused_tfree`` (exactly 4 launches); then a 128^2 scene
             on the card against the plain version on the CPU.
5. times   — CUDA events, 2 warm-ups, median of 7: each fused3 launch
             (every kernel, plain and library time is queued behind a
             spin on the card, so the host's time before the launch is
             not in it) and the whole run (with the host's time),
             beside the launch's bound (bytes over 3.35 TB/s
             vs nominal 5 N log2 N FLOP over 67 TFLOP/s, H100 SXM spec
             sheet), ``mma_floor_ms`` (the stages' 3 TF32 passes of
             8 N (n1 + n2) flop a line and transform over 495 TFLOP/s),
             the plain version, ``library_ms`` (torch.fft -> multiply ->
             torch.fft, timed only as a yardstick) and ``vs_library``
             (kernel ms over library ms; on every time_launch and
             time_kernel line).
6. mega_kernel — each CUDA megakernel (``csrc/mega.cu``) against
             ``fft4step.mega_plain`` on the card, 2e-4 x max|want|: fused1's
             3-segment chain with every filter mode on both axes, one- and
             two-segment chains and a same-axis boundary, on 64x128,
             128x64, 128^2 (both kernels, held ``torch.equal`` to each
             other), 256^2 and 4096^2 (staged), B in {1, 2}; each 4096^2
             case also against the chain in complex128 at 1e-5. The
             shared-memory opt-in the residency cut assumes is read from
             the card.
7. main fused1 — ``build_pipeline(cfg, "fused1").run(raw)`` at 4096^2
             (staged by the cut): exactly one ``mega_staged`` launch and no
             spectral launch, all five targets within 8 px, ``torch.equal``
             to the card's fused3 image, the plan replayed through
             ``mega_spectral_op_plain`` on the card (same peaks, |dSNR| <=
             0.1 dB); then 128^2 (resident by the cut): one
             ``mega_resident`` launch, ``torch.equal`` to fused3 and to
             ``residency="staged"``, within 2e-4 of the CPU plain version.
8. time fused1 — fused3 and fused1 runs in turns (fused3, fused1, fused1,
             fused3); the staged kernel alone at 4096^2 and the resident
             kernel alone on 132 scenes of 128^2 (one per SM, beside fused3
             and fused1 runs of that batch), each beside its bound, its
             plain version and ``library_ms``.
9. transpose_kernel — the CUDA tiled transpose (``csrc/transpose.cu``)
             against ``transpose_plain`` with ``torch.equal``: float32 and
             complex64, 2-D and B = 2, square, non-square and ragged shapes
             up to 4096^2.
10. stockham_kernel — phase 3's grid with ``fft_impl="stockham"`` at N in
             {16, 128, 256, 1024, 4096} (the Stockham route of the
             spectral kernel), then phase 6's chains through both
             megakernels on the Stockham route, each ``torch.equal`` to
             its plain version (and resident to staged); each N = 4096
             case and each 4096^2 chain also against the complex128
             oracle at 1e-5, as on the matmul route.
11. main fused — ``build_pipeline(cfg, "fused").run(raw)`` at 4096^2 with
             the counts reset just before and read just after (exactly 3
             spectral, 4 transpose, 0 mega launches), all five targets
             within 8 px, the same peaks and |dSNR| <= 0.1 dB against the
             card's ``unfused`` image and against the steps replayed
             through the plain versions; each turn's input through the
             kernel and ``transpose_plain``.
12. main stockham — ``fused3`` with ``fft_impl="stockham"`` at 4096^2
             (exactly 3 spectral launches, five targets within 8 px, the
             same peaks and |dSNR| <= 0.1 dB against the matmul fused3
             image and the plain replay, the image within 1e-5 of the plan
             in complex128); ``fused1`` on the Stockham route
             at 4096^2 (one ``mega_staged`` launch) and 128^2 (one
             ``mega_resident`` launch, and ``residency="staged"``), each
             ``torch.equal`` to the Stockham fused3 image of its size.
13. time baselines — each transpose launch of the fused run at 4096^2
             complex64 beside its bound, ``transpose_plain`` and
             ``library_ms`` (``x.transpose(-1, -2).contiguous()``); the
             fused run with its spectral launches and its sinc RCMC step
             timed alone; each Stockham fused3 launch beside the matmul
             launch of the same segment; both megakernels on the Stockham
             route; fused3 runs on the two routes in turns (matmul,
             stockham, stockham, matmul).
14. csa / omega-K — the paper's scene through ``csa`` (the torch backend's
             7 ops, no kernel launch, the baseline), then on each FFT
             route ``csa_fused`` and ``omegak`` (exactly 3 spectral
             launches, FULL screens read from device memory; five targets
             within 8 px, the plain replay's peaks and |dSNR| <= 0.1 dB,
             ``csa_fused`` within 0.1 dB of ``csa``; each launch against
             its plain version) and ``csa_fused1`` / ``omegak_fused1``
             (exactly one ``mega_staged``, ``torch.equal`` to the three
             launches); each launch and megakernel timed beside its bound
             and ``library_ms`` (the variant through torch.fft and torch
             multiplies by the same screens), the two variants' runs in
             turns; then 132 scenes of 128^2 through ``mega_resident``,
             ``torch.equal`` to the three launches, timed the same way.
15. precisions — the Stockham route at bf16, f16 and bs16: the spectral
             kernel's grid at N in {16 ... 4096} with odd lines subnormal
             and both megakernels' chains (a unit-scale scene beside a
             subnormal one), bs16 ``torch.equal`` to its plain version and
             different from f32 where values are subnormal, bf16 and f16
             equal to f32; then ``fused3``, ``fused1``, ``csa_fused``,
             ``csa_fused1``, ``omegak`` and ``omegak_fused1`` at 4096^2 and
             ``fused1`` at 128^2 at each precision (launch counts,
             ``torch.equal`` to the plain replay, within 0.1 dB of the f32
             image, whether it equals f32 bit for bit), each bs16 launch
             timed.

16. tuning — the matmul route's operand forms and the tuner that drives
             them: (1) f32 with Karatsuba, bf16, f16, bs16 and bs16 with
             Karatsuba through phase 3's grid (both splits at N = 4096,
             odd lines subnormal for bs16) and phase 6's chains (f16's up
             to 256^2: a random 4096^2 chain overflows f16 in the plain
             version too), each within ``FORM_TOL`` of its plain version,
             resident == staged, f32 with Karatsuba within 1e-5 of
             complex128 at N = 4096; (2) fused3 and fused1 at 4096^2 and
             fused1 at 128^2 at bf16, f16, bs16 and with Karatsuba (launch
             counts, five targets within 8 px and |dSNR| <= 0.1 dB against
             the f32 image and the plain replay where the image is finite,
             fused1 == fused3 and resident == staged bit for bit); (3)
             ``search_kernel`` at N = 4096 over f32 / bf16 / bs16 behind
             the SNR gate, its cache in a temporary directory, strictly
             fewer candidates timed than the space holds, the winner
             persisted and compiled by ``build_pipeline``'s default
             ``tune="cached"`` into every fused3 launch; ``search_schedule``
             for fused1 at 4096^2 and 128^2, fused1 through each winner
             ``torch.equal`` to the same knobs given by hand, and a
             schedule whose azimuth and range segments split differently
             reaching ``mega_staged``; (4) each fused3 launch and both
             megakernels at bf16, bs16 and f32 with Karatsuba beside f32,
             in turns, with bounds, ``mma_floor_ms``, plain and library
             times.

17. service — the port's streaming executor and focusing service: (1)
             ``run_streamed(raw, strips=4)`` at 4096^2 for fused3 on both
             routes, ``csa_fused`` and ``unfused``, each bit-equal to
             ``run`` in 3 x 4 spectral launches (``unfused``: the torch
             backend, none), timed on the host clock against ``run`` from
             the card and from the host; ``fused`` and ``fused1`` refused;
             (2) ``FocusService(ServiceConfig())`` on the card, warmed,
             its bs16 gate measured: 16 default-tier 128^2 requests in one
             burst (only ``mega_resident`` launches, one a batch, each
             reply bit-equal to fused1 at the tier the gate admitted), then
             4096^2 f32 requests (3 spectral launches, five targets within
             8 px, bit-equal to fused3), then the same scene over
             ``device_budget_bytes`` on the stream lane (3 x 4 launches,
             bit-equal to in memory); per-request latency p50 / p99 beside
             ``Pipeline.run`` alone; no request off tier 0; (3) the seeded
             chaos replay (dispatch error, NaN output, lane hang) at 128^2:
             0 lost requests; (4) the service paths' launches timed
             beside their plain versions and bounds.

18. sharded — the multi-device lowering (``core.sar.distributed``) on
             meshes that repeat the one card, P = 1, 2 and 8 slabs (each
             slab its own launches, each corner turn on-card copies, not
             NVLink; every line says so), and on every visible card: at
             4096^2 lowered fused3 (3 x P spectral launches), fused1
             (3 x P ``mega_staged``: the azimuth FFT on (4096, 4096/P)
             slabs, range fwd . H . inv on (4096/P, 4096), azimuth H .
             inv), fused1 pinned staged, csa_fused1 and omegak_fused1 on
             both routes, each ``torch.equal`` to its local twin; fused1
             bs16 (the Stockham route: f16's range overflows on the
             matmul route at 4096^2) equal to the local bs16 image;
             corner2 equal to fused3 and with a bf16 wire within the
             0.1 dB gate; halo at the largest P its bound admits, equal
             to its one-device plan and within 0.01 dB of ``unfused``
             (and at 256^2 l2 < 1e-5, the reference's own check); 132 x
             128^2 fused1 at P = 8 through 24 ``mega_resident`` launches;
             the sharded backend serving three 4096^2 requests and the
             local backend's sharded route for a streamed one, equal to
             fused3 with no fallback. Launch counts are read around each
             run; each unit is timed on its P slabs beside its plain
             version, torch.fft and its bound, each turn's copies beside
             their bytes bound, and each run per P.

19. long lines — lines past one block (``csrc/long_lines.cuh``: the
             four-step over device memory in one cooperative launch): the
             spectral kernel against its plain version at N in {8192,
             16384, 32768, 2^18, 2^21}, rows and columns, ragged lines
             (every filter mode x fwd/inv at 8192 and 32768, fwd * FULL *
             inv at the others) and, on the matmul route, the explicit
             splits (8, 8, 8), (16, 8, 4), (16, 16, 16), (32, 16, 16); the
             Stockham route ``torch.equal``, the matmul route within TOL;
             each case against complex128 at 1e-5 up to N = 16384 and 4e-5
             past it; ``mega_staged`` on phase 6's chains with an
             8192-point segment the same way. Then the 8192 x 16384 paper
             scene (2^27 points, not cut) through fused3 / fused1,
             csa_fused / csa_fused1 and omegak / omegak_fused1 on both
             routes: exactly 3 spectral launches or 1 ``mega_staged``,
             five targets within 8 px at SNR > 30 dB, the plain replay's
             peaks and |dSNR| <= 0.1 dB, fused3 within 1e-5 of complex128,
             each fused1 ``torch.equal`` to its three launches, csa_fused
             within 0.1 dB of the torch backend's csa; each launch and
             ``mega_staged`` call timed beside its bound, plain version
             and ``library_ms``, and the whole fused3 run; fused3 with
             ``fft_kw=(16, 16, 16)`` on the 4096^2 scene (five targets,
             1e-5 of complex128); the 4096^2 fused3 launches timed again
             on both routes.
20. long forms — every precision past one block: the residency cut
             (128^2 at (8, 4, 4) and 2 x 8192 compile fused1 to one
             ``mega_resident`` launch, equal to fused3 and to a pinned
             staged fused1), each form's kernel sweeps, the 8192 x 16384
             scene at bs16 and bf16, a default-tier service request, the
             SNR gate and ``search_kernel`` at 8192, the forms' times.
21. resident long — ``mega_resident`` past one block: lines of 8192 and
             16384 points on either axis, 128^2 at (8, 4, 4), batch_block
             2, at every form on both routes, one launch a case, bit for
             bit ``mega_staged``, the spectral launches and (batch_block
             2) one scene a block, the plain version (Stockham bit for
             bit, matmul within FORM_TOL), f32 within 1e-5 of
             complex128; then 132-scene batches of 2 x 8192 and of 128^2
             at (8, 4, 4) timed beside ``mega_staged``, plain and the
             library chain.

22. lm — ``core.fusion`` and the LM stack's serving path: (1)
             ``SpectralPipeline`` on the kernel backend, every filter mode
             on rows and columns on both FFT routes at f32 (N = 4096, 37
             lines; one spectral launch each, within 2e-4 of the plain
             version and of the torch backend, 1e-5 of complex128), one
             bs16 case through the ``compute_dtype`` alias, ``fft_conv`` in
             one launch; (2) the FFTConvMixer at stablelm-1.6b's width (D =
             2048, B = 4, S = 2048 and 4096: 8192 lines of 4096 and 8192
             points) — ``fftconv_forward`` in one launch within 2e-4 of its
             plain version and ``fftconv_reference``, the gradients of
             sum(y^2) through its autograd.Function within 2e-4 of autograd
             through the reference, the launch timed beside its plain
             version, the torch.fft chain and its bytes bound; (3)
             stablelm-1.6b at full width and depth, weights from seed 0:
             ``generate`` (batch 4, prompt 32, 32 new tokens) at its bf16
             compute — prefill ms, decode ms a token beside the bound of
             reading the bf16 weights once, tokens/s — then at f32 every
             decode step within 1e-4 x max|want| of a full forward over the
             same prefix (greedy tokens equal the forward's argmax where its
             top two differ by more), and the card's f32 forward at 2
             layers within 1e-4 of the CPU's; (4) every other architecture
             at full width, one pattern period deep, f32, MoE dropless:
             prefill 16 tokens and 4 decode steps, each against a full
             forward at the same bar. The LM runs launch no spectral kernel.
23. train — the LM stack's training path: (a) stablelm-1.6b at full
             width and depth trained through ``launch/train.py`` (f32
             weights, bf16 compute, AdamW, ``TokenStream``; batch 8, seq
             128, 30 steps): every loss finite, the last 5 below the first
             5; the step's ms (CUDA events, median of the last 20),
             tokens/s, peak memory beside 18 B a parameter, the step's
             bound and its two terms (FLOP over dense bf16, the optimizer's
             and the cast's bytes over HBM); then 3 steps at seq 2048 with
             remat on and off, remat's peak lower; (b) 2 layers at f32:
             the token stream's batch on the card equal to the CPU's, every
             gradient and one AdamW step within 1e-4 x max|want| of the
             CPU's, remat on vs off within 1e-6; (c) in a child process
             under deterministic algorithms (``--train-restart-child``),
             2 layers at bf16: a run that fails at step 5 and restarts
             from its checkpoints (every 2 steps) ends ``torch.equal`` to
             an uninterrupted run, and a preemption stops with a
             checkpoint of its step (the child runs beside (b) and (d));
             (d) every other architecture at one
             pattern period, one train step (finite, every parameter a
             gradient, peak memory; llama4 skipped: 196 GB at 18 B a
             parameter), and one AdamW step of the FFTConvMixer at D =
             2048, B = 4, S = 2048 (one spectral launch, gradients within
             2e-4 of the plain version's); (e) the parts' seconds. The
             model's loss launches no kernel.
24. sharded — the LM stack over meshes of slabs of the one card, a data
             position's "model" row computing split (its ranks: heads,
             ``ff`` and vocabulary, the sequence-parallel residual): (a)
             stablelm-1.6b at full width and depth, one AdamW step on
             (4, 2) against one device from the same weights and non-zero
             moments: the loss and every weight within 5e-3, the update
             p - p0 within 1e-2 x its largest of one device's step
             summing every split contraction as the ranks sum it, and
             the split with its partial sums rounded to bf16 before
             their reduction outside that bar; every slab exactly its
             shard; its step ms and
             peak GiB beside the whole-weights layout's (each position
             gathering every weight, ``PERF.md`` §5); then at f32, the
             update within 1e-2 x its largest; (b) at f32, 2 layers:
             stablelm's gradients on (4, 2) and (2, 2, 2), granite's
             with remat and
             routing groups spanning positions on (4, 1), within 1e-5 x
             max|want|; (c) gemma3-12b's batch-1 decode with the KV
             sequence over "data" and stablelm's ``generate`` under (4,
             1); (d) the FFTConvMixer's sharded AdamW step, 4 spectral
             launches; (e) the phase under 180 s; (f) stablelm-1.6b at
             full width on (1, 4): bf16 prefill and 8 decode tokens
             within 1e-2 x max|want| of one device, each rank's KV cache
             its own slab; at f32, 2 layers, every logit within 1e-5 x
             max|want| and ``generate``'s tokens equal; one bf16 train
             step's ms and peak; (g) the dry run's per-device peak of
             that step (on a (1, 4) meta mesh) beside the card's peak /
             4.
25. tp mixers — MoE, the recurrent mixers and cross-attention split over
             a data position's "model" row (slabs of the one card): (a)
             granite-moe-3b, one pattern period, on (1, 16), where 40
             experts do not divide 16 (each rank its ``ff`` columns of
             every expert): one f32 train step's loss and gradients
             within 1e-5 x max|want| of one device; one bf16 AdamW step's
             update within 1e-2 x its largest move of one device summing
             every split contraction as the ranks sum it
             (``split_association``), the control (partial sums rounded to
             bf16 first) outside that bar; bf16 prefill (batch 4, prompt
             32) and 8 decode tokens within 1e-2 x max|want|; (b)
             llama4-scout, 2 layers (what the card holds twice, with its
             bf16 compute copies), on (1, 8): 16 experts 2 a rank, 40
             heads 5 a rank, with the shared expert; at f32 the prefill of
             16 tokens and 4 decode steps, every logit within 1e-5 and the
             greedy tokens equal; whether the bf16 prefill's logits equal
             one device's bit for bit (reported); (c) falcon-mamba-7b and
             recurrentgemma-9b, one pattern period each, on (1, 4): (a)'s
             f32 gradients and bf16 update bar and control, and the f32
             prefill and decode (each rank's recurrent state its channel
             slice of its own copy); (d) whisper-tiny on (1, 2): f32
             decode gives one device's tokens, each rank reading its own
             3 heads of the cross cache; (e) each split step's ms and peak
             GiB beside one device's, and the rank threads; (f) the phase
             under 150 s.

The line before the last lists each kernel — on the main path and on each
path of phases 14 to 24 (phase 25 launches none), with the precisions
and Karatsuba flags it runs on each route; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import concurrent.futures
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM spec sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM spec sheet, FP32 outside tensor cores
TF32_FLOP_PER_S = 495e12       # H100 SXM spec sheet, dense TF32 tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM spec sheet, dense BF16 / FP16
TF32_PASSES = 3                # the matmul route's 3xTF32 split
TOL = 2e-4                     # x max|want| (tests/test_kernels.py)
# The matmul route's operand forms against their plain versions
# (tests/test_torch_cuda.py states the same): f32 keeps TOL; bf16 / f16 /
# bs16 differ only in the order of f32 accumulation and where a reordered
# sum rounds to the other 16-bit neighbour at a later stage (a megakernel
# chains three segments of such roundings).
FORM_TOL = {"f32": TOL, "bf16": 1e-2, "f16": 2e-3, "bs16": 2e-3}
ORACLE_TOL = 1e-5              # x max|want|, either route vs complex128
GATE_DB = 0.1
SEARCH = 64                    # window of the peak-position check


# the matmul-route f32 instantiations, which must run on the tensor cores
MMA_KERNELS = ("spectral_kernel<matmul>", "mega_resident<matmul>",
               "mega_staged<matmul>")
_KERNEL_NAMES = ("spectral_kernel", "spectral_long_form", "spectral_long",
                 "mega_resident", "mega_staged", "transpose_kernel")
# the out-of-line device functions of csrc/long_lines.cuh and of
# mega_resident's long chains (ptxas reports each under its kernel, as it
# does the Stockham ops)
_LONG_FUNCTIONS = (r"(long_stage_cols_kara|long_stage_cols|long_stage_form|"
                   r"long_stage|long_segment_form|long_segment|long_op_form|"
                   r"long_lines_whole|"
                   r"resident_long_op|resident_segment_apart|"
                   r"slab_tail_transform|slab_move|long_op)")


_OPERAND_NAMES = {1: "bf16", 2: "f16"}


def instantiation(mangled):
    """A readable name of a mangled kernel, e.g. 'mega_staged<matmul>'
    (the template flag kStockham of spectral.cu and mega.cu; a megakernel
    specialised on its N, 'mega_staged<stockham,4096>'; the bs16 codec's
    instantiations end in ',bs16'; the matmul route's other operand forms
    name theirs, ',bf16' / ',f16', and Karatsuba, ',kara' in every
    transform or ',kara/seg' chosen per segment), or of one out-of-line
    Stockham op, e.g. 'stockham_n<cols,4096,io,32>' (layout, N,
    device-memory tile or in-place slab, points a thread, ',bs16' with the
    codec). The lines past one block: 'spectral_long<matmul>', a
    megakernel's instantiation for chains with such a segment ',long',
    and their out-of-line functions by name ('long_op<stockham>')."""
    m = re.search(r"stockham_nILb([01])ELi(\d+)ELb([01])ELi(\d+)ELb([01])E",
                  mangled)
    if m:
        return (f"stockham_n<{'cols' if m.group(1) == '1' else 'rows'},"
                f"{m.group(2)},{'io' if m.group(3) == '1' else 'slab'},"
                f"{m.group(4)}{',bs16' if m.group(5) == '1' else ''}>")
    m = re.search(_LONG_FUNCTIONS + r"(I(?:L[bi]\d+E)+E)?", mangled)
    if m:
        fn = m.group(1)
        targs = [int(v) for v in re.findall(r"L[bi](\d+)E", m.group(2) or "")]
        if fn == "long_stage_form":     # <kOp, kKara>
            tags = [_OPERAND_NAMES.get(targs[0], "f32")] + (
                ["kara"] if targs[1] else [])
            return f"{fn}<{','.join(tags)}>"
        if not targs:
            return fn
        stockham, op, kara, bs = (targs + [0, 0, 0])[:4]
        tags = form_tags(stockham, 0, bs, op, kara)
        if fn == "resident_segment_apart":   # <..., kLineFast>
            tags.append("cols" if targs[4] else "rows")
        return f"{fn}<{','.join(tags)}>"
    for name in _KERNEL_NAMES:
        i = mangled.find(name)
        if i < 0:
            continue
        rest = mangled[i + len(name):]
        m = re.match(r"I((?:L[bi]\d+E)+)E", rest)
        if m is None:   # the transpose's element type, or no template
            return (f"{name}<{rest[1:rest.find('E')]}>"
                    if rest.startswith("I") else name)
        args = [int(v) for v in re.findall(r"L[bi](\d+)E", m.group(1))]
        long_ = 0
        if name == "spectral_kernel":   # <kStockham, kBs, kOp, kKara>
            stockham, bs, op, kara = args
            n = 0
        elif name.startswith("spectral_long"):
            # <kStockham> (f32), _form <kStockham, kOp, kKara, kBs>
            stockham, op, kara, bs = (args + [0, 0, 0])[:4]
            n = 0
        else:                  # <kStockham, kN, kBs, kOp, kKara[, kLong]>
            stockham, n, bs, op, kara = args[:5]
            long_ = args[5] if len(args) > 5 else 0
        tags = form_tags(stockham, n, bs, op, kara)
        if long_:
            tags.append("long")
        return f"{name}<{','.join(tags)}>"
    return mangled


def form_tags(stockham, n, bs, op, kara):
    """The route, N, operand form and Karatsuba tags of an instantiation
    (``instantiation``)."""
    tags = ["stockham" if stockham else "matmul"]
    if n:
        tags.append(str(n))
    if bs:
        tags.append("bs16")
    elif op:
        tags.append(_OPERAND_NAMES[op])
    if kara:
        tags.append("kara" if kara == 1 else "kara/seg")
    return tags


def ptxas_report(log):
    """{instantiation: registers, spill stores and loads} from one source's
    ``-Xptxas -v`` output; an out-of-line Stockham op (``stockham_n``, a
    call of its kernel, compiled for each kernel's register budget) gets
    its own spill record under 'kernel/op' (its registers count in its
    kernel's)."""
    out = {}
    cur = props = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = m.group(1)
            out[instantiation(cur)] = {}
            continue
        m = re.search(r"Function properties for (\w+)", ln)
        if m:
            props = m.group(1)
            continue
        if cur is None:
            continue
        rec = out[instantiation(cur)]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and props == cur:
            rec.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        elif m and props and ("stockham_n" in props or
                              re.search(_LONG_FUNCTIONS, props)):
            out[f"{instantiation(cur)}/{instantiation(props)}"] = dict(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            rec["registers"] = int(m.group(1))
    return out


def sass_hmma(lib):
    """{instantiation: {operand type: HMMA instructions}} in the SASS of one
    built library (``cuobjdump -sass``, beside nvcc): 'tf32'
    (HMMA.1684.F32.TF32), 'bf16' (HMMA.16816.F32.BF16) and 'f16'
    (HMMA.16816.F32)."""
    from repro_torch.kernels import _build
    exe = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([exe, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts = {}
    cur = None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = instantiation(m.group(1))
            counts.setdefault(cur, {"tf32": 0, "bf16": 0, "f16": 0})
        elif cur is not None and "HMMA" in ln:
            kind = "tf32" if "TF32" in ln else "bf16" if "BF16" in ln \
                else "f16"
            counts[cur][kind] += 1
    return counts


def hmma_wanted(name):
    """The HMMA operand type a matmul-route instantiation must run on (its
    stages' form), or None for a kernel without tensor-core stages."""
    if not name.startswith(("spectral_kernel<matmul", "mega_resident<matmul",
                            "mega_staged<matmul")):
        return None
    if ",bf16" in name:
        return "bf16"
    if ",f16" in name or ",bs16" in name:
        return "f16"
    return "tf32"


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def rel_err(got, want):
    """max|got - want| over max|want|, for split (re, im) pairs."""
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return err, err / max(scale, 1e-30)


def phase_f32(torch, u, v):
    """The rank-K outer phase sum_q u[l, q] v[k, q] as the kernels round
    it (``ph = fmaf(u_q, v_q, ph)`` in float32, q in order), as float64
    (lines, n): the float64 product of two float32 values is exact, so
    each step rounds once to float32 (up to a rare double-rounding tie)."""
    u = u.reshape(u.shape[0], -1).double()
    v = v.reshape(v.shape[0], -1).double()
    ph = torch.zeros(u.shape[0], v.shape[0], dtype=torch.float64,
                     device=u.device)
    for q in range(u.shape[1]):
        ph = (u[:, q, None] * v[None, :, q] + ph).float().double()
    return ph


def oracle_op(torch, x, axis, fwd, inv, mode, hr=None, hi=None, u=None,
              v=None):
    """One per-axis op [FFT] -> filter -> [IFFT] in complex128 through
    torch.fft, on a complex (..., lines, n) rows / (..., n, lines) cols
    tensor, with the filter payloads of ``ops.spectral_op``; the outer
    phase rounded as the kernels round it (``phase_f32``), so what is
    held is the FFT arithmetic."""
    dim = -1 if axis == 1 else -2
    x = x.to(torch.complex128)
    if fwd:
        x = torch.fft.fft(x, dim=dim)
    if mode in ("shared", "full", "shared_outer"):
        h = torch.complex(hr.double(), hi.double())
        if mode != "full":
            h = h[None, :] if axis == 1 else h[:, None]
        x = x * h
    if mode in ("outer", "shared_outer"):
        ph = phase_f32(torch, u, v)
        if axis == 0:
            ph = ph.T
        x = x * torch.polar(torch.ones_like(ph), ph)
    if inv:
        x = torch.fft.ifft(x, dim=dim)
    return x


def image_oracle(torch, pipe, raw):
    """A compiled pipeline of spectral steps, in complex128 through
    ``oracle_op`` with each step's own payloads."""
    want = raw
    for s in pipe.steps:
        kk = s.kernel_kw
        want = oracle_op(torch, want, kk["axis"], kk["fwd"], kk["inv"],
                         kk["filter_mode"], **s.filter_kw)
    return want


def oracle_err(torch, got, want):
    """max|got - want| / max|want| of a split float32 result against a
    complex128 oracle."""
    g = torch.complex(got[0].double(), got[1].double())
    return float((g - want).abs().max() / want.abs().max())


# the plain versions at 8192 x 16384 are timed once, with no warm-up:
# their correctness comparisons all stay, but at ~0.1 s a call they are no
# yardstick, and 9 calls each took a sixth of phases 19 and 20
PLAIN_ONCE = dict(warm=0, reps=1)


def cuda_median_ms(fn, warm=2, reps=7, queued=False):
    """Median of ``reps`` CUDA-event timings of ``fn``. ``queued``: each
    timing waits behind a spin on the card, so the events bracket the
    card's work and not the host's Python time before each launch — the
    kernel times; a whole pipeline run is timed with the host in it."""
    from repro_torch.kernels.probe import median_ms
    return median_ms(fn, warm=warm, reps=reps, queued=queued)


TRANSPOSE_SHAPES = ((64, 64), (128, 256), (96, 32), (37, 4096), (4096, 4096))
MEGA_MODES = ("none", "shared", "full", "outer", "shared_outer")
MEGA_SHAPES = ((64, 128), (128, 64), (128, 128), (256, 256), (4096, 4096))
MEGA_BATCH = 132               # resident timing: one 128^2 scene per SM
STOCKHAM_SIZES = (16, 128, 256, 1024, 4096)   # phase 10's spectral sweep


def mega_chains():
    """fused1's 3-segment shape with each filter mode on both axes, one-
    and two-segment chains, and a same-axis boundary."""
    chains = [((0, True, False, "none"), (1, True, True, m),
               (0, False, True, m)) for m in MEGA_MODES]
    chains.append(((0, True, True, "shared_outer"),))
    chains.append(((1, True, True, "shared"), (0, False, True, "full")))
    chains.append(((1, True, False, "shared"), (1, False, True, "outer"),
                   (0, True, True, "none")))
    return chains


def reset_launch_counts():
    """Every kernel's launch count to 0 (just before a main-path run)."""
    from repro_torch.kernels import ops, transpose
    ops.SPECTRAL_LAUNCHES = 0
    ops.MEGA_LAUNCHES.update(mega_resident=0, mega_staged=0)
    transpose.TRANSPOSE_LAUNCHES = 0


def launch_counts(**want):
    """The launch counts since the last reset: every kernel, 0 unless
    named in ``want`` (the expected counts, for ``==``)."""
    from repro_torch.kernels import ops, transpose
    got = {"spectral": ops.SPECTRAL_LAUNCHES,
           "transpose": transpose.TRANSPOSE_LAUNCHES, **ops.MEGA_LAUNCHES}
    return got, {**{k: 0 for k in got}, **want}


def seeded_randn(torch, dev, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    return rand


def filter_payload(rand, mode, n, scene, lines, rank=2):
    """The filter keywords of ``ops.spectral_op`` for one sweep case."""
    filt = {}
    if mode in ("shared", "shared_outer"):
        filt.update(hr=rand(n), hi=rand(n))
    if mode == "full":
        filt.update(hr=rand(*scene), hi=rand(*scene))
    if mode in ("outer", "shared_outer"):
        filt.update(u=rand(lines, rank), v=rand(n, rank))
    return filt


def spectral_sweep(torch, ops, rand, fft_impl, sizes=(128, 4096),
                   exact=False, precision="f32", karatsuba=False, tol=TOL,
                   splits=((None, None),), subnormal=False):
    """The spectral kernel against its plain version on the card: every
    filter mode x axis x fwd/inv at N in ``sizes`` (at N = 4096 each split
    of ``splits``, (None, None) the default), B in {1, 2}, 37 lines,
    within ``tol`` or, ``exact``, ``torch.equal``; ``subnormal``: odd lines
    scaled into the subnormal floats, and held to ``tol`` of their own
    largest value too (the bs16 codec's lines). At f32, on either route,
    each N = 4096 case also against the complex128 oracle
    (``ORACLE_TOL``). Returns {cases, max_rel_err, subnormal_max_rel_err,
    oracle_cases, max_oracle_err}."""
    from repro_torch.kernels.fft4step import FILTER_MODES
    lines = 37
    out = dict(cases=0, max_rel_err=0.0, subnormal_max_rel_err=0.0,
               oracle_cases=0, max_oracle_err=0.0)
    for n in sizes:
        for n1, n2 in (splits if n == 4096 else ((None, None),)):
            for batch in (1, 2):
                for axis in (0, 1):
                    scene = (lines, n) if axis == 1 else (n, lines)
                    xr, xi = rand(batch, *scene), rand(batch, *scene)
                    if subnormal:
                        xr, xi = subnormal_lines(torch, (xr, xi), axis)
                    odd = ((slice(None), slice(1, None, 2)) if axis == 1
                           else (slice(None), slice(None), slice(1, None, 2)))
                    for mode in FILTER_MODES:
                        filt = filter_payload(rand, mode, n, scene, lines)
                        for fwd, inv in ((True, False), (False, True),
                                         (True, True), (False, False)):
                            if mode == "none" and not (fwd or inv):
                                continue
                            kw = dict(axis=axis, fwd=fwd, inv=inv,
                                      filter_mode=mode, block=1,
                                      fft_impl=fft_impl, precision=precision,
                                      karatsuba=karatsuba, n1=n1, n2=n2)
                            got = ops.spectral_op(xr, xi, **filt, **kw)
                            want = ops.spectral_op_plain(xr, xi, **filt, **kw)
                            torch.cuda.synchronize()
                            _, rel = rel_err(got, want)
                            where = f"{kw} n={n} B={batch}"
                            check(rel <= tol, f"kernel vs plain {where}: "
                                  f"rel err {rel:.3e}")
                            check(not exact or all(
                                torch.equal(g, w) for g, w in zip(got, want)),
                                  f"kernel != plain {where}: rel err "
                                  f"{rel:.3e}")
                            out["max_rel_err"] = max(out["max_rel_err"], rel)
                            if subnormal:
                                _, sub = rel_err([g[odd] for g in got],
                                                 [w[odd] for w in want])
                                check(sub <= tol, f"subnormal lines {where}: "
                                      f"rel err {sub:.3e}")
                                out["subnormal_max_rel_err"] = max(
                                    out["subnormal_max_rel_err"], sub)
                            out["cases"] += 1
                            if n == 4096 and precision == "f32":
                                o = oracle_err(torch, got, oracle_op(
                                    torch, torch.complex(xr, xi), axis, fwd,
                                    inv, mode, **filt))
                                check(o <= ORACLE_TOL, f"kernel vs complex128 "
                                      f"{where}: {o:.3e}")
                                out["max_oracle_err"] = max(
                                    out["max_oracle_err"], o)
                                out["oracle_cases"] += 1
    return out


def mega_sweep(torch, ops, rand, fft_impl, exact=False, precision="f32",
               karatsuba=False, tol=TOL, shapes=MEGA_SHAPES,
               subnormal=False):
    """Both megakernels against ``mega_plain`` on the card over
    ``mega_chains()`` x ``shapes`` x B in {1, 2} (within ``tol`` or,
    ``exact``, ``torch.equal``), resident held ``torch.equal`` to staged;
    ``subnormal``: the batch's second scene scaled into the subnormal
    floats and held to ``tol`` of its own largest value (B = 2). At f32,
    on either route, each 4096^2 case also against the complex128 oracle
    chain (``ORACLE_TOL``). Returns {cases, max_rel_err (per kernel),
    subnormal_max_rel_err, resident_equals_staged_cases, oracle_cases,
    max_oracle_err}."""
    out = dict(cases={"mega_resident": 0, "mega_staged": 0},
               max_rel_err={"mega_resident": 0.0, "mega_staged": 0.0},
               subnormal_max_rel_err=0.0, resident_equals_staged_cases=0,
               oracle_cases=0, max_oracle_err=0.0)
    kw = dict(fft_impl=fft_impl, precision=precision, karatsuba=karatsuba)
    for na, nr in shapes:
        for batch in (1, 2):
            x = (rand(batch, na, nr), rand(batch, na, nr))
            if subnormal and batch == 2:
                for t in x:
                    t[1] *= 1e-40
            for segments in mega_chains():
                args = []
                for axis, _fwd, _inv, mode in segments:
                    n, lines = (nr, na) if axis == 1 else (na, nr)
                    if mode in ("shared", "shared_outer"):
                        args += [rand(n), rand(n)]
                    if mode == "full":
                        args += [rand(na, nr), rand(na, nr)]
                    if mode in ("outer", "shared_outer"):
                        args += [rand(lines, 2), rand(n, 2)]
                want = ops.mega_spectral_op_plain(*x, *args,
                                                  segments=segments, **kw)
                outs = []
                for residency, kernel in (("vmem", "mega_resident"),
                                          ("staged", "mega_staged")):
                    if residency == "vmem" and \
                            ops.mega_residency(na, nr) != "vmem":
                        continue
                    got = ops.mega_spectral_op(*x, *args, segments=segments,
                                               residency=residency, **kw)
                    torch.cuda.synchronize()
                    _, rel = rel_err(got, want)
                    where = (f"{kernel} {kw} {segments} {na}x{nr} "
                             f"B={batch}")
                    check(rel <= tol, f"{where} vs plain: rel err {rel:.3e}")
                    check(not exact or all(
                        torch.equal(g, w) for g, w in zip(got, want)),
                          f"{where} != plain: rel err {rel:.3e}")
                    out["max_rel_err"][kernel] = max(
                        out["max_rel_err"][kernel], rel)
                    out["cases"][kernel] += 1
                    if subnormal and batch == 2:
                        _, sub = rel_err([g[1] for g in got],
                                         [w[1] for w in want])
                        check(sub <= tol, f"{where} subnormal scene: "
                              f"{sub:.3e}")
                        out["subnormal_max_rel_err"] = max(
                            out["subnormal_max_rel_err"], sub)
                    outs.append(got)
                    if na == nr == 4096 and precision == "f32":
                        o = oracle_err(torch, got, oracle_chain(
                            torch, torch.complex(*x), segments, args))
                        check(o <= ORACLE_TOL, f"{where} vs complex128: "
                              f"{o:.3e}")
                        out["max_oracle_err"] = max(out["max_oracle_err"], o)
                        out["oracle_cases"] += 1
                if len(outs) == 2:
                    check(all(torch.equal(a, b) for a, b in zip(*outs)),
                          f"resident != staged {kw} {segments} {na}x{nr}")
                    out["resident_equals_staged_cases"] += 1
            del x, args, want, outs
    return out


def oracle_chain(torch, x, segments, args):
    """A megakernel chain in complex128 (``oracle_op`` per segment, the
    filter payloads in scene coordinates, in segment order)."""
    it = iter(args)
    for axis, fwd, inv, mode in segments:
        filt = {}
        if mode in ("shared", "full", "shared_outer"):
            filt.update(hr=next(it), hi=next(it))
        if mode in ("outer", "shared_outer"):
            filt.update(u=next(it), v=next(it))
        x = oracle_op(torch, x, axis, fwd, inv, mode, **filt)
    return x


def mma_floor(n, n1, n2, lines, transforms, precision="f32",
              karatsuba=False, n3=0):
    """(tensor-core flops, ms) of the matmul route's stages: 8 N (n1 + n2
    [+ n3]) real flops a line and transform (6 N (...) with Karatsuba's
    three products), issued as ``TF32_PASSES`` TF32 passes over the dense
    TF32 rate at f32, as one pass over the dense BF16 / FP16 rate at bf16,
    f16 and bs16."""
    flops = ((6.0 if karatsuba else 8.0) * n * (n1 + n2 + n3) * lines
             * transforms)
    if precision == "f32":
        flops *= TF32_PASSES
        return flops, flops / TF32_FLOP_PER_S * 1e3
    return flops, flops / BF16_FLOP_PER_S * 1e3


def time_mega_kernel(torch, smi_line, name, step, x, segments_cfg,
                     variant="fused1", plain_timing=None):
    """One megakernel alone on the main path's split input, beside its
    bound, its plain version, ``variant``'s chain through torch.fft and
    torch multiplies by the same payloads (``library_ms``) and, on the
    matmul route, the tensor-core floor of its stages. ``plain_timing``:
    ``cuda_median_ms``' warm-up and runs for the plain version
    (``PLAIN_ONCE`` past one block, where it is no yardstick)."""
    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import build_pipeline
    from repro_torch.kernels import ops
    from repro_torch.kernels.fft4step import (MegaSpec, SegmentSpec,
                                              _mega_flops)
    xr, xi = planlib.split(x)
    args = [t for a in step.seg_filter_args for t in a]
    kk = step.kernel_kw
    batch, na, nr = xr.shape if xr.ndim == 3 else (1, *xr.shape)
    spec = MegaSpec(na, nr, tuple(
        SegmentSpec(*s[:4], **dict(zip(("n1", "n2", "n3", "karatsuba"),
                                       s[4:])))
        for s in kk["segments"]), karatsuba=kk.get("karatsuba", False),
        n1=kk.get("n1"), n2=kk.get("n2"), n3=kk.get("n3"))
    nbytes = 16 * xr.numel() + sum(4 * t.numel() for t in args)
    flops = _mega_flops(spec) * batch
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    oracle = build_pipeline(segments_cfg, variant, backend="torch")
    rec = dict(
        kernel=name, variant=variant, fft_impl=kk["fft_impl"],
        precision=kk["precision"],
        karatsuba=[spec.seg_spec(g).karatsuba for g in spec.segments],
        segments=kk["segments"], scene=[na, nr], batch=batch,
        ms=cuda_median_ms(lambda: ops.mega_spectral_op(xr, xi, *args, **kk),
                          queued=True),
        plain_ms=cuda_median_ms(lambda: ops.mega_spectral_op_plain(
            xr, xi, *args, **kk), queued=True, **(plain_timing or {})),
        library_ms=cuda_median_ms(lambda: oracle.run(x), queued=True),
        bytes=nbytes, flops_nominal=flops,
        bound_ms=max(t_mem, t_ops),
        bound_by="bytes" if t_mem >= t_ops else "operations",
        per_phase_floor_ms=len(kk["segments"]) * 16 * xr.numel()
        / HBM_BYTES_PER_S * 1e3)
    rec["vs_library"] = rec["ms"] / rec["library_ms"]
    if kk["fft_impl"] == "matmul":
        mma = [mma_floor(sspec.n, *sspec.factors()[:2],
                         batch * (na if seg.axis == 1 else nr),
                         int(seg.fwd) + int(seg.inv), kk["precision"],
                         sspec.karatsuba, *sspec.factors()[2:])
               for seg in spec.segments for sspec in [spec.seg_spec(seg)]]
        rec.update(mma_flops=sum(f for f, _ in mma),
                   mma_floor_ms=sum(t for _, t in mma))
    emit("time_kernel", nvidia_smi=smi_line, **rec)
    return rec


def time_spectral_launch(smi_line, step, xr, xi, x, variant="fused3",
                         plain_timing=None):
    """One spectral-kernel launch of ``variant``'s compiled plan on its own
    inputs,
    beside its bound (bytes over 3.35 TB/s vs nominal 5 N log2 N FLOP over
    67 TFLOP/s), its plain version and ``library_ms`` (torch.fft ->
    multiply -> torch.fft, timed only as a yardstick). ``plain_timing``:
    as ``time_mega_kernel``'s."""
    from repro_torch.core import plan as planlib
    from repro_torch.kernels import ops
    from repro_torch.kernels.fft4step import SpectralSpec, flops_nominal
    kk, fk = step.kernel_kw, step.filter_kw
    if kk["axis"] == 1:
        nlines, n = xr.shape[-2:]
    else:
        n, nlines = xr.shape[-2:]
    spec = SpectralSpec(n=n, fwd=kk["fwd"], filter_mode=kk["filter_mode"],
                        inv=kk["inv"], axis=kk["axis"],
                        fft_impl=kk["fft_impl"], precision=kk["precision"],
                        n1=kk.get("n1"), n2=kk.get("n2"), n3=kk.get("n3"),
                        karatsuba=kk.get("karatsuba", False))
    nbytes = 4 * xr.numel() * 4 + sum(4 * t.numel() for t in fk.values())
    flops = flops_nominal(spec, nlines)
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    rec = dict(
        launch=step.name, variant=variant, fft_impl=kk["fft_impl"],
        precision=kk["precision"], karatsuba=spec.karatsuba,
        split=list(spec.factors()), axis=kk["axis"],
        mode=kk["filter_mode"], fwd=kk["fwd"], inv=kk["inv"],
        ms=cuda_median_ms(lambda: ops.spectral_op(xr, xi, **fk, **kk),
                          queued=True),
        plain_ms=cuda_median_ms(
            lambda: ops.spectral_op_plain(xr, xi, **fk, **kk), queued=True,
            **(plain_timing or {})),
        library_ms=cuda_median_ms(lambda: planlib._torch_apply(
            x, kk["fwd"], kk["inv"], kk["filter_mode"], fk, kk["axis"]),
            queued=True),
        bytes=nbytes, flops_nominal=flops, bound_ms=max(t_mem, t_ops),
        bound_by="bytes" if t_mem >= t_ops else "operations")
    rec["vs_library"] = rec["ms"] / rec["library_ms"]
    if kk["fft_impl"] == "matmul":
        mma, mma_ms = mma_floor(n, *spec.factors()[:2], nlines,
                                int(kk["fwd"]) + int(kk["inv"]),
                                kk["precision"], spec.karatsuba,
                                *spec.factors()[2:])
        rec.update(mma_flops=mma, mma_floor_ms=mma_ms)
    emit("time_launch", nvidia_smi=smi_line, **rec)
    return rec


def step_inputs(pipe, x):
    """Run ``pipe``'s steps one by one: [(step, its input)], the output."""
    out = []
    for s in pipe.steps:
        out.append((s, x))
        x = s.fn(x)
    return out, x


def mega_phases(torch, dev, smi_line, cfg, raw, fused3_img, score, small,
                small_raw, fused3_pipe):
    """Phases 6-8 (the megakernels); returns their ``kernels`` records."""
    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import build_pipeline, metrics, paper_targets
    from repro_torch.kernels import ops

    def split_err(a, b):
        return rel_err((a.real, a.imag), (b.real, b.imag))

    # ---- 6. each megakernel vs its plain version on the card --------------
    lib = ops._bind_mega(ops.MEGA_STAGED_NAMES[ops.MEGA_KERNEL_NAME])
    optin = lib.mega_smem_optin(dev.index or 0)
    check(optin == ops.SMEM_OPTIN_BYTES,
          f"shared-memory opt-in {optin} B, the cut assumes "
          f"{ops.SMEM_OPTIN_BYTES} B")
    rand = seeded_randn(torch, dev, 1)
    ms = mega_sweep(torch, ops, rand, "matmul")
    staged_smem = (ops.RESIDENT_MAX_POINTS * 8
                   + ops.dft_smem_bytes(64, 64))   # 4096^2, matmul
    emit("mega_kernel", cases=ms["cases"], max_rel_err=ms["max_rel_err"],
         tol=TOL, oracle_cases=ms["oracle_cases"],
         max_oracle_err=ms["max_oracle_err"], oracle_tol=ORACLE_TOL,
         resident_equals_staged_cases=ms["resident_equals_staged_cases"],
         smem_optin_bytes=optin,
         staged_smem_bytes=staged_smem,
         staged_blocks_per_sm=lib.mega_staged_blocks_per_sm(staged_smem, 0),
         sms=torch.cuda.get_device_properties(dev).multi_processor_count)

    # ---- 7. the main path through fused1 -----------------------------------
    pipe = build_pipeline(cfg, "fused1")
    check([s.kind for s in pipe.steps] == ["mega"] and pipe.dispatches == 1,
          "fused1 compiles to one mega step")
    step = pipe.steps[0]
    check(step.kernel_kw["residency"] == "staged", "4096^2 is staged")
    reset_launch_counts()
    img = pipe.run(raw)
    torch.cuda.synchronize()
    got_counts, want = launch_counts(mega_staged=1)
    check(got_counts == want, f"fused1 4096^2 launches {got_counts}")
    check(bool(torch.isfinite(img).all()), "fused1: non-finite image")
    rep_k = score(img)
    check(torch.equal(img, fused3_img), "fused1 != fused3 at 4096^2")
    seg_args = [t for a in step.seg_filter_args for t in a]
    xr, xi = planlib.split(raw)
    img_p = planlib.unsplit(*ops.mega_spectral_op_plain(
        xr, xi, *seg_args, **step.kernel_kw))
    torch.cuda.synchronize()
    dsnr = check_focus("fused1 vs plain", rep_k, score(img_p))
    staged_err, staged_rel = split_err(img, img_p)
    check(staged_rel <= TOL, f"fused1 vs plain: rel err {staged_rel:.3e}")
    emit("main", variant="fused1", scene=[cfg.na, cfg.nr],
         residency="staged", launches=got_counts, targets=rep_k,
         equal_to_fused3=True, snr_delta_db_vs_plain=dsnr,
         max_abs_err_vs_plain=staged_err, rel_err_vs_plain=staged_rel)
    del img, img_p, fused3_img

    small_f3 = build_pipeline(small, "fused3").run(small_raw)
    pipe_s = build_pipeline(small, "fused1")
    step_s = pipe_s.steps[0]
    check(step_s.kernel_kw["residency"] == "vmem", "128^2 is resident")
    reset_launch_counts()
    img_s = pipe_s.run(small_raw)
    torch.cuda.synchronize()
    small_counts, want = launch_counts(mega_resident=1)
    check(small_counts == want, f"fused1 128^2 launches {small_counts}")
    check(torch.equal(img_s, small_f3), "fused1 != fused3 at 128^2")
    staged_s = build_pipeline(small, "fused1", residency="staged").run(
        small_raw)
    check(torch.equal(img_s, staged_s), "resident != staged at 128^2")
    on_cpu = build_pipeline(small, "fused1", device="cpu").run(
        small_raw.cpu())
    _, cpu_rel = split_err(img_s.cpu(), on_cpu)
    check(cpu_rel <= TOL, f"128^2 fused1 card vs CPU: {cpu_rel:.3e}")
    sr, si = planlib.split(small_raw)
    seg_args_s = [t for a in step_s.seg_filter_args for t in a]
    img_sp = planlib.unsplit(*ops.mega_spectral_op_plain(
        sr, si, *seg_args_s, **step_s.kernel_kw))
    resident_err, _ = split_err(img_s, img_sp)
    peaks = [(r.row, r.col) for r in metrics.analyze_scene(
        img_s.cpu().numpy(), small, paper_targets(small))]
    emit("main", variant="fused1", scene=[small.na, small.nr],
         residency="vmem", launches=small_counts, equal_to_fused3=True,
         equal_to_staged=True, rel_err_vs_cpu=cpu_rel,
         max_abs_err_vs_plain=resident_err, peaks=peaks)

    # ---- 8. times -----------------------------------------------------------
    runs = {"fused3": [], "fused1": []}
    for variant in ("fused3", "fused1", "fused1", "fused3"):
        p = fused3_pipe if variant == "fused3" else pipe
        runs[variant].append(cuda_median_ms(lambda: p.run(raw)))
    emit("time_run", variant="fused1_vs_fused3", scene=[cfg.na, cfg.nr],
         order=["fused3", "fused1", "fused1", "fused3"],
         fused3_ms=runs["fused3"], fused1_ms=runs["fused1"],
         nvidia_smi=smi_line)

    t_staged = time_mega_kernel(torch, smi_line, "mega_staged", step, raw,
                                cfg)
    batch_raw = small_raw.expand(MEGA_BATCH, *small_raw.shape).contiguous()
    reset_launch_counts()
    got = pipe_s.run(batch_raw)
    torch.cuda.synchronize()
    batch_counts, want_counts = launch_counts(mega_resident=1)
    check(batch_counts == want_counts, f"batch launches {batch_counts}")
    want = planlib.unsplit(*ops.mega_spectral_op_plain(
        *planlib.split(batch_raw), *seg_args_s, **step_s.kernel_kw))
    _, batch_rel = split_err(got, want)
    check(batch_rel <= TOL, f"resident batch vs plain: {batch_rel:.3e}")
    t_resident = time_mega_kernel(torch, smi_line, "mega_resident", step_s,
                                  batch_raw, small)
    small3 = build_pipeline(small, "fused3")
    batch_runs = {"fused3": [], "fused1": []}
    for variant in ("fused3", "fused1", "fused1", "fused3"):
        p = small3 if variant == "fused3" else pipe_s
        batch_runs[variant].append(cuda_median_ms(lambda: p.run(batch_raw)))
    emit("time_run", variant="fused1_vs_fused3", scene=[small.na, small.nr],
         batch=MEGA_BATCH, order=["fused3", "fused1", "fused1", "fused3"],
         fused3_ms=batch_runs["fused3"], fused1_ms=batch_runs["fused1"],
         rel_err_vs_plain=batch_rel, nvidia_smi=smi_line)

    def record(name, line, launches, err, t):
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/mega.cu",
                "replaces": f"src/repro/kernels/fft4step.py:{line}",
                "launches": launches, "max_abs_err": err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}

    return [record("mega_resident", 931, small_counts["mega_resident"],
                   resident_err, t_resident),
            record("mega_staged", 1002, got_counts["mega_staged"],
                   staged_err, t_staged)]


def scorer(cfg, targets):
    """score(img): each target's expected pixel, its peak
    (``metrics.analyze_scene``), the offset of the largest magnitude in a
    +-SEARCH px window around the expected pixel, and its SNR."""
    from repro_torch.core.sar import metrics

    def score(img):
        mag = img.abs().cpu().numpy()
        reps = metrics.analyze_scene(img.cpu().numpy(), cfg, targets)
        out = []
        for t, rep in zip(targets, reps):
            er, ec = metrics.expected_pixel(cfg, t)
            rows = [(er + d) % cfg.na for d in range(-SEARCH, SEARCH + 1)]
            cols = [(ec + d) % cfg.nr for d in range(-SEARCH, SEARCH + 1)]
            win = mag[rows][:, cols]
            i, j = divmod(int(win.argmax()), win.shape[1])
            out.append(dict(expected=[er, ec], peak=[rep.row, rep.col],
                            wide_peak_offset=[i - SEARCH, j - SEARCH],
                            snr_db=rep.snr_db))
        return out
    return score


def card_scorer(torch, cfg, targets):
    """``scorer``'s score on the card (phases 19 and 20): the same
    expected pixels, peaks (``metrics``' +-8 px search), wide-window
    offsets and SNR — the peak's magnitude over the RMS magnitude outside
    +-64 px guard windows around every target (``metrics.noise_rms``),
    summed in float64 — for a 2^27-point image, whose host copy and numpy
    passes take seconds."""
    from repro_torch.core.sar import metrics

    def window(mag, r, c, half):
        rows = torch.arange(r - half, r + half + 1, device=mag.device) % cfg.na
        cols = torch.arange(c - half, c + half + 1, device=mag.device) % cfg.nr
        win = mag[rows][:, cols]
        i, j = divmod(int(win.argmax()), win.shape[1])
        return int(rows[i]), int(cols[j]), i - half, j - half

    def score(img):
        mag = img.abs()
        keep = torch.ones_like(mag, dtype=torch.bool)
        pix = [metrics.expected_pixel(cfg, t) for t in targets]
        for r, c in pix:
            rows = torch.arange(r - 64, r + 65, device=mag.device) % cfg.na
            cols = torch.arange(c - 64, c + 65, device=mag.device) % cfg.nr
            keep[rows[:, None], cols[None, :]] = False
        noise = float(torch.sqrt(torch.mean(mag[keep].double() ** 2)))
        out = []
        for er, ec in pix:
            r, c, _, _ = window(mag, er, ec, 8)
            _, _, di, dj = window(mag, er, ec, SEARCH)
            peak = float(mag[r, c])
            out.append(dict(expected=[er, ec], peak=[r, c],
                            wide_peak_offset=[di, dj],
                            snr_db=20.0 * math.log10(peak / max(noise,
                                                                1e-30))))
        return out
    return score


def check_focus(name, rep, want=None, gate=GATE_DB):
    """All five targets within 8 px of their expected pixels at SNR > 30
    dB; with ``want`` (another image's score) the same peaks and |dSNR|
    <= ``gate``. Returns the |dSNR| list (empty without ``want``)."""
    for r in rep:
        off = r["wide_peak_offset"]
        check(max(abs(off[0]), abs(off[1])) <= 8,
              f"{name}: target peak {off} px from expected")
        check(r["snr_db"] > 30.0, f"{name}: SNR {r['snr_db']}")
    if want is None:
        return []
    check([r["peak"] for r in rep] == [r["peak"] for r in want],
          f"{name}: peaks differ")
    dsnr = [abs(a["snr_db"] - b["snr_db"]) for a, b in zip(rep, want)]
    check(max(dsnr) <= gate, f"{name}: dSNR {dsnr}")
    return dsnr


def l2_rel(torch, a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def baseline_phases(torch, dev, smi_line, cfg, raw, score, replay_plain,
                    small, small_raw, fused3_pipe, main_inputs, matmul_img):
    """Phases 9-13 (the paper's baselines: the tiled transpose and the
    8-launch ``fused`` RDA, the Stockham route of the spectral kernel and
    both megakernels); returns their ``kernels`` records."""
    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import build_pipeline
    from repro_torch.kernels import ops, transpose

    # ---- 9. the transpose kernel vs its plain version ---------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    cases = 0
    for dtype in (torch.float32, torch.complex64):
        for shape in TRANSPOSE_SHAPES:
            for lead in ((), (2,)):
                x = torch.randn((*lead, *shape), generator=gen, device=dev,
                                dtype=dtype)
                got = transpose.transpose(x)
                torch.cuda.synchronize()
                check(torch.equal(got, transpose.transpose_plain(x)),
                      f"transpose {dtype} {(*lead, *shape)} != plain")
                cases += 1
    del x, got
    emit("transpose_kernel", cases=cases, shapes=TRANSPOSE_SHAPES,
         batches=[1, 2], dtypes=["float32", "complex64"], equal=True)

    # ---- 10. the Stockham route vs the plain versions ----------------------
    # bit for bit: pairing passes changes which thread computes a point,
    # never how; N = 16, 256, 4096 turn around in registers, 1024 has two
    # pairs and a lone pass, 128 a radix-4/radix-2 pair
    # and, as the matmul route, each N = 4096 case against the complex128
    # oracle, whose outer phase is rounded as the kernels round it
    sw = spectral_sweep(torch, ops, seeded_randn(torch, dev, 3), "stockham",
                        sizes=STOCKHAM_SIZES, exact=True)
    ms = mega_sweep(torch, ops, seeded_randn(torch, dev, 4), "stockham",
                    exact=True)
    emit("stockham_kernel", spectral_cases=sw["cases"], sizes=STOCKHAM_SIZES,
         spectral_max_rel_err=sw["max_rel_err"], mega_cases=ms["cases"],
         mega_max_rel_err=ms["max_rel_err"],
         resident_equals_staged_cases=ms["resident_equals_staged_cases"],
         equal_to_plain=True, spectral_oracle_cases=sw["oracle_cases"],
         spectral_max_oracle_err=sw["max_oracle_err"],
         mega_oracle_cases=ms["oracle_cases"],
         mega_max_oracle_err=ms["max_oracle_err"], oracle_tol=ORACLE_TOL)

    # ---- 11. the main path through fused -----------------------------------
    pipe = build_pipeline(cfg, "fused")
    check(pipe.dispatches == 8 and [s.kind for s in pipe.steps].count(
        "transpose") == 4, "fused compiles to 8 steps, 4 of them turns")
    reset_launch_counts()
    img = pipe.run(raw)
    torch.cuda.synchronize()
    fused_counts, want = launch_counts(spectral=3, transpose=4)
    check(fused_counts == want, f"fused launches {fused_counts}")
    check(bool(torch.isfinite(img).all()), "fused: non-finite image")
    rep_k = score(img)
    check_focus("fused", rep_k)
    img_u = build_pipeline(cfg, "unfused").run(raw)
    dsnr_u = check_focus("fused vs unfused", rep_k, score(img_u))
    l2_u = l2_rel(torch, img, img_u)
    del img_u
    img_p = replay_plain(pipe, raw)
    torch.cuda.synchronize()
    dsnr_p = check_focus("fused vs plain", rep_k, score(img_p))
    l2_p = l2_rel(torch, img, img_p)
    del img_p
    inputs, out = step_inputs(pipe, raw)
    check(torch.equal(out, img), "fused: a second run differs")
    for s, x in inputs:
        if s.kind == "transpose":
            check(torch.equal(transpose.transpose(x),
                              transpose.transpose_plain(x)),
                  f"fused turn {s.name}: kernel != plain")
    emit("main", variant="fused", scene=[cfg.na, cfg.nr],
         launches=fused_counts, targets=rep_k,
         snr_delta_db_vs_unfused=dsnr_u, l2_rel_vs_unfused=l2_u,
         snr_delta_db_vs_plain=dsnr_p, l2_rel_vs_plain=l2_p,
         turns_equal_to_plain=True)
    del img, out

    # ---- 12. the main path on the Stockham route ---------------------------
    st3 = build_pipeline(cfg, "fused3", fft_impl="stockham")
    reset_launch_counts()
    img3 = st3.run(raw)
    torch.cuda.synchronize()
    st_counts, want = launch_counts(spectral=3)
    check(st_counts == want, f"stockham fused3 launches {st_counts}")
    check(bool(torch.isfinite(img3).all()), "stockham fused3: non-finite")
    rep3 = score(img3)
    dsnr_m = check_focus("stockham fused3 vs matmul", rep3, score(matmul_img))
    l2_m = l2_rel(torch, img3, matmul_img)
    img_p = replay_plain(st3, raw)
    torch.cuda.synchronize()
    dsnr_p = check_focus("stockham fused3 vs plain", rep3, score(img_p))
    del img_p, matmul_img
    st_oracle = oracle_err(torch, (img3.real, img3.imag),
                           image_oracle(torch, st3, raw))
    check(st_oracle <= ORACLE_TOL,
          f"stockham fused3 4096^2 vs complex128: {st_oracle:.3e}")
    st_inputs = {}
    st_err = 0.0
    for s, x in step_inputs(st3, raw)[0]:
        xr, xi = planlib.split(x)
        st_inputs[s.name] = (s, xr, xi, x)
        got = ops.spectral_op(xr, xi, **s.filter_kw, **s.kernel_kw)
        want_p = ops.spectral_op_plain(xr, xi, **s.filter_kw, **s.kernel_kw)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want_p)
        check(rel <= TOL, f"stockham launch {s.name}: rel err {rel:.3e}")
        st_err = max(st_err, err)
    del got, want_p
    emit("main", variant="fused3", fft_impl="stockham",
         scene=[cfg.na, cfg.nr], launches=st_counts, targets=rep3,
         snr_delta_db_vs_matmul=dsnr_m, l2_rel_vs_matmul=l2_m,
         snr_delta_db_vs_plain=dsnr_p, max_abs_err_launches=st_err,
         oracle_rel_err=st_oracle, oracle_tol=ORACLE_TOL)

    st1 = build_pipeline(cfg, "fused1", fft_impl="stockham")
    check(st1.steps[0].kernel_kw["residency"] == "staged", "4096^2 staged")
    reset_launch_counts()
    img1 = st1.run(raw)
    torch.cuda.synchronize()
    st1_counts, want = launch_counts(mega_staged=1)
    check(st1_counts == want, f"stockham fused1 launches {st1_counts}")
    check(torch.equal(img1, img3), "stockham fused1 != stockham fused3")
    del img1, img3
    small3 = build_pipeline(small, "fused3", fft_impl="stockham").run(
        small_raw)
    st1s = build_pipeline(small, "fused1", fft_impl="stockham")
    check(st1s.steps[0].kernel_kw["residency"] == "vmem", "128^2 resident")
    reset_launch_counts()
    img1s = st1s.run(small_raw)
    torch.cuda.synchronize()
    st1s_counts, want = launch_counts(mega_resident=1)
    check(st1s_counts == want, f"stockham fused1 128^2 {st1s_counts}")
    check(torch.equal(img1s, small3), "stockham fused1 != fused3 at 128^2")
    staged_s = build_pipeline(small, "fused1", fft_impl="stockham",
                              residency="staged").run(small_raw)
    check(torch.equal(staged_s, small3), "stockham staged != fused3 128^2")
    emit("main", variant="fused1", fft_impl="stockham",
         launches_4096=st1_counts, launches_128=st1s_counts,
         equal_to_stockham_fused3=[True, True],
         staged_equal_to_stockham_fused3_128=True)

    # ---- 13. times ---------------------------------------------------------
    turns = []
    for s, x in inputs:
        if s.kind != "transpose":
            continue
        nbytes = 2 * x.numel() * x.element_size()
        rec = dict(
            step=s.name, shape=list(x.shape), dtype=str(x.dtype),
            ms=cuda_median_ms(lambda: transpose.transpose(x), queued=True),
            plain_ms=cuda_median_ms(lambda: transpose.transpose_plain(x),
                                    queued=True),
            library_ms=cuda_median_ms(
                lambda: x.transpose(-1, -2).contiguous(), queued=True),
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes")
        emit("time_transpose", nvidia_smi=smi_line, **rec)
        turns.append(rec)
    spec_t = []
    for s, x in inputs:
        if s.kind == "spectral":
            xr, xi = planlib.split(x)
            spec_t.append(time_spectral_launch(smi_line, s, xr, xi, x,
                                               variant="fused"))
    sinc_step, sinc_x = next((s, x) for s, x in inputs
                             if s.kind == "sinc_rcmc")
    sinc_ms = cuda_median_ms(lambda: sinc_step.fn(sinc_x))
    fused_ms = cuda_median_ms(lambda: pipe.run(raw))
    steps_ms = (sum(r["ms"] for r in spec_t) + sum(r["ms"] for r in turns)
                + sinc_ms)
    emit("time_run", variant="fused", scene=[cfg.na, cfg.nr], ms=fused_ms,
         spectral_ms=[r["ms"] for r in spec_t],
         transpose_ms=[r["ms"] for r in turns], sinc_rcmc_ms=sinc_ms,
         split_unsplit_ms=fused_ms - steps_ms, nvidia_smi=smi_line)
    del inputs

    st_t = []
    for name, (s, xr, xi, x) in st_inputs.items():
        ms_, xr_m, xi_m, _ = main_inputs[name]
        mm = [cuda_median_ms(lambda: ops.spectral_op(
            xr_m, xi_m, **ms_.filter_kw, **ms_.kernel_kw), queued=True)]
        rec = time_spectral_launch(smi_line, s, xr, xi, x)
        mm.append(cuda_median_ms(lambda: ops.spectral_op(
            xr_m, xi_m, **ms_.filter_kw, **ms_.kernel_kw), queued=True))
        emit("time_route", launch=name, order=["matmul", "stockham",
                                               "matmul"],
             matmul_ms=mm, stockham_ms=rec["ms"], nvidia_smi=smi_line)
        st_t.append(rec)
    t_st_staged = time_mega_kernel(torch, smi_line, "mega_staged",
                                   st1.steps[0], raw, cfg)
    batch_raw = small_raw.expand(MEGA_BATCH, *small_raw.shape).contiguous()
    reset_launch_counts()
    got = st1s.run(batch_raw)
    torch.cuda.synchronize()
    batch_counts, want = launch_counts(mega_resident=1)
    check(batch_counts == want, f"stockham batch launches {batch_counts}")
    step_s = st1s.steps[0]
    want_b = planlib.unsplit(*ops.mega_spectral_op_plain(
        *planlib.split(batch_raw),
        *[t for a in step_s.seg_filter_args for t in a], **step_s.kernel_kw))
    _, batch_rel = rel_err((got.real, got.imag), (want_b.real, want_b.imag))
    check(batch_rel <= TOL, f"stockham resident batch: {batch_rel:.3e}")
    del got, want_b
    t_st_resident = time_mega_kernel(torch, smi_line, "mega_resident",
                                     step_s, batch_raw, small)
    runs = {"matmul": [], "stockham": []}
    for route in ("matmul", "stockham", "stockham", "matmul"):
        p = fused3_pipe if route == "matmul" else st3
        runs[route].append(cuda_median_ms(lambda: p.run(raw)))
    emit("time_run", variant="fused3_matmul_vs_stockham",
         scene=[cfg.na, cfg.nr],
         order=["matmul", "stockham", "stockham", "matmul"],
         matmul_ms=runs["matmul"], stockham_ms=runs["stockham"],
         nvidia_smi=smi_line)

    def total(recs, key):
        return sum(r[key] for r in recs)

    return [
        {"name": "transpose", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/transpose.cu",
         "replaces": "src/repro/kernels/transpose.py:26",
         "also_replaces": "src/repro/kernels/transpose.py:30",
         "launches": fused_counts["transpose"], "max_abs_err": 0.0,
         "ms": total(turns, "ms"), "plain_ms": total(turns, "plain_ms"),
         "bound_ms": total(turns, "bound_ms"), "bound_by": "bytes",
         "library_ms": total(turns, "library_ms")},
        {"name": "stockham", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/spectral.cu",
         "device_code": "src/repro_torch/kernels/csrc/spectral_common.cuh",
         "replaces": "src/repro/kernels/fft4step.py:422",
         "launches": st_counts["spectral"], "max_abs_err": st_err,
         "ms": total(st_t, "ms"), "plain_ms": total(st_t, "plain_ms"),
         "bound_ms": total(st_t, "bound_ms"),
         "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in st_t)
         else "operations",
         "library_ms": total(st_t, "library_ms"),
         "mega_staged_ms": t_st_staged["ms"],
         "mega_staged_launches": st1_counts["mega_staged"],
         "mega_resident_ms": t_st_resident["ms"],
         "mega_resident_launches": st1s_counts["mega_resident"]},
    ]


# CSA and omega-K: each three-launch variant and its one-launch twin
FAMILIES = {"csa_fused": "csa_fused1", "omegak": "omegak_fused1"}
PRECISION_VARIANTS = ("fused3", "fused1", "csa_fused", "csa_fused1", "omegak",
                      "omegak_fused1")
NARROW = ("bf16", "f16", "bs16")      # the Stockham route's other precisions
BS16_CHAINS = (((0, True, False, "full"), (1, True, True, "full"),
                (0, False, True, "full")),
               ((1, False, False, "full"), (0, True, True, "shared"),
                (1, False, False, "outer")))


def replay_mega_plain(step, x):
    """One mega step through ``mega_spectral_op_plain`` on x's device."""
    from repro_torch.core import plan as planlib
    from repro_torch.kernels import ops
    return planlib.unsplit(*ops.mega_spectral_op_plain(
        *planlib.split(x), *[t for a in step.seg_filter_args for t in a],
        **step.kernel_kw))


def family_phases(torch, smi_line, cfg, raw, score, replay_plain, small,
                  small_raw):
    """Phase 14: CSA and omega-K on the paper's scene on both FFT routes,
    and on 132 scenes of 128^2 through ``mega_resident``. Returns the
    ``kernels`` records, the Stockham images (for phase 15) and the
    seconds the screens took to build."""
    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import build_pipeline
    from repro_torch.kernels import ops

    # the screens (three float64 4096^2 screens for CSA, one for omega-K),
    # built on the host once per (cfg, plan) and kept on the card by the
    # compiler's caches: before any timed window
    t0 = time.perf_counter()
    base = build_pipeline(cfg, "csa")        # torch backend: the baseline
    pipes = {(v, r): build_pipeline(cfg, v, fft_impl=r)
             for r in ("matmul", "stockham")
             for three, one in FAMILIES.items() for v in (three, one)}
    torch.cuda.synchronize()
    screens_s = time.perf_counter() - t0
    check(base.dispatches == 7 and all(
        p.dispatches == (1 if v.endswith("fused1") else 3)
        for (v, _), p in pipes.items()), "CSA / omega-K dispatches")
    reset_launch_counts()
    img_base = base.run(raw)
    torch.cuda.synchronize()
    base_counts, want = launch_counts()
    check(base_counts == want, f"csa (torch backend) launches {base_counts}")
    rep_base = score(img_base)
    emit("main", variant="csa", backend="torch", scene=[cfg.na, cfg.nr],
         launches=base_counts, targets=rep_base, screens_seconds=screens_s)
    check_focus("csa", rep_base)
    del img_base

    images = {}
    records = []
    for fft_impl in ("matmul", "stockham"):
        for three, one in FAMILIES.items():
            p3, p1 = pipes[(three, fft_impl)], pipes[(one, fft_impl)]
            reset_launch_counts()
            img3 = p3.run(raw)
            torch.cuda.synchronize()
            counts3, want = launch_counts(spectral=3)
            check(counts3 == want, f"{three} ({fft_impl}) launches {counts3}")
            check(bool(torch.isfinite(img3).all()), f"{three}: non-finite")
            rep3 = score(img3)
            emit("main", variant=three, fft_impl=fft_impl,
                 scene=[cfg.na, cfg.nr], launches=counts3, targets=rep3)
            img_p = replay_plain(p3, raw)
            torch.cuda.synchronize()
            dsnr_p = check_focus(f"{three} ({fft_impl}) vs plain", rep3,
                                 score(img_p))
            del img_p
            dsnr_b = (check_focus(f"{three} ({fft_impl}) vs csa", rep3,
                                  rep_base)
                      if three == "csa_fused" else None)
            # where every transform of the chain has 4096 points, the
            # Stockham route's mega_staged takes its specialisation
            # (csrc/mega.cu: transform_n == 4096)
            step1 = p1.steps[0]
            check(step1.kernel_kw["residency"] == "staged", f"{one}: staged")
            reset_launch_counts()
            img1 = p1.run(raw)
            torch.cuda.synchronize()
            counts1, want = launch_counts(mega_staged=1)
            check(counts1 == want, f"{one} ({fft_impl}) launches {counts1}")
            check(torch.equal(img1, img3), f"{one} != {three} ({fft_impl})")
            img1_p = replay_mega_plain(step1, raw)
            err1, rel1 = rel_err((img1.real, img1.imag),
                                 (img1_p.real, img1_p.imag))
            check(rel1 <= TOL, f"{one} ({fft_impl}) vs plain: {rel1:.3e}")
            del img1_p
            launch_err = 0.0
            timed = []
            for s, x in step_inputs(p3, raw)[0]:
                xr, xi = planlib.split(x)
                got = ops.spectral_op(xr, xi, **s.filter_kw, **s.kernel_kw)
                want_p = ops.spectral_op_plain(xr, xi, **s.filter_kw,
                                               **s.kernel_kw)
                torch.cuda.synchronize()
                err, rel = rel_err(got, want_p)
                check(rel <= TOL and (fft_impl == "matmul" or all(
                    torch.equal(g, w) for g, w in zip(got, want_p))),
                      f"{three} launch {s.name} ({fft_impl}): {rel:.3e}")
                launch_err = max(launch_err, err)
                del got, want_p
                timed.append(time_spectral_launch(smi_line, s, xr, xi, x,
                                                  variant=three))
            t1 = time_mega_kernel(torch, smi_line, "mega_staged", step1, raw,
                                  cfg, variant=one)
            runs = {three: [], one: []}
            for v in (three, one, one, three):
                p = p3 if v == three else p1
                runs[v].append(cuda_median_ms(lambda: p.run(raw)))
            emit("main", variant=one, fft_impl=fft_impl,
                 scene=[cfg.na, cfg.nr], launches=counts1,
                 specialised_4096=cfg.na == cfg.nr == 4096,
                 equal_to_three_launches=True, targets=rep3,
                 snr_delta_db_vs_plain=dsnr_p, snr_delta_db_vs_csa=dsnr_b,
                 max_abs_err_launches=launch_err, rel_err_fused1_vs_plain=rel1)
            emit("time_run", variant=f"{three}_vs_{one}", fft_impl=fft_impl,
                 scene=[cfg.na, cfg.nr], order=[three, one, one, three],
                 **{f"{three}_ms": runs[three], f"{one}_ms": runs[one]},
                 launch_ms_sum=sum(r["ms"] for r in timed),
                 launch_library_ms_sum=sum(r["library_ms"] for r in timed),
                 nvidia_smi=smi_line)
            if fft_impl == "stockham":
                images[three] = img3
            del img1
            records.append(kernel_record(
                "spectral", three, fft_impl, counts3["spectral"], launch_err,
                timed))
            records.append(kernel_record(
                "mega_staged", one, fft_impl, counts1["mega_staged"], err1,
                [t1]))

    # one scene of 128^2 per SM through mega_resident, beside its twin
    batch_raw = small_raw.expand(MEGA_BATCH, *small_raw.shape).contiguous()
    for fft_impl in ("matmul", "stockham"):
        for three, one in FAMILIES.items():
            img3 = build_pipeline(small, three, fft_impl=fft_impl).run(
                batch_raw)
            p1 = build_pipeline(small, one, fft_impl=fft_impl)
            check(p1.steps[0].kernel_kw["residency"] == "vmem", "resident")
            reset_launch_counts()
            img1 = p1.run(batch_raw)
            torch.cuda.synchronize()
            counts, want = launch_counts(mega_resident=1)
            check(counts == want, f"{one} 132 x 128^2 launches {counts}")
            check(torch.equal(img1, img3),
                  f"{one} != {three} on 132 x 128^2 ({fft_impl})")
            want_p = replay_mega_plain(p1.steps[0], batch_raw)
            err, rel = rel_err((img1.real, img1.imag),
                               (want_p.real, want_p.imag))
            check(rel <= TOL, f"{one} 132 x 128^2 vs plain: {rel:.3e}")
            t = time_mega_kernel(torch, smi_line, "mega_resident",
                                 p1.steps[0], batch_raw, small, variant=one)
            emit("main", variant=one, fft_impl=fft_impl,
                 scene=[small.na, small.nr], batch=MEGA_BATCH,
                 launches=counts, equal_to_three_launches=True,
                 rel_err_vs_plain=rel)
            records.append(kernel_record("mega_resident", one, fft_impl,
                                         counts["mega_resident"], err, [t]))
            del img1, img3, want_p
    return records, images, screens_s


def kernel_precisions(name):
    """What a ``kernels`` entry's kernel runs: precisions by FFT route
    (``ops.KERNEL_PRECISIONS``; the ``stockham`` entry is that route of
    the spectral kernel), or the transpose's element types."""
    from repro_torch.kernels import ops
    if name == "transpose":
        return {"elements": ["float32", "complex64"]}
    routes = ("stockham",) if name == "stockham" else ops.FFT_IMPLS
    return {r: list(ops.KERNEL_PRECISIONS[r]) for r in routes}


def kernel_karatsuba(name):
    """The Karatsuba flags a ``kernels`` entry's kernel runs by FFT route:
    both on the matmul route's stages, none to take on the Stockham
    route (no complex contraction there)."""
    if name == "transpose":
        return {}
    if name == "stockham":
        return {"stockham": [False]}
    return {"matmul": [False, True], "stockham": [False]}


def kernel_record(name, variant, fft_impl, launches, err, timed,
                  source=None):
    """One ``kernels`` entry for a kernel on a path of phase 14, 15 or 16:
    the sums over the path's launches of that kernel (``source``: the
    file in csrc/ its library builds from, when not the kernel's own)."""
    source = source or ("spectral.cu" if name == "spectral" else "mega.cu")
    line = {"spectral": 598, "mega_resident": 931, "mega_staged": 1002}[name]
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/fft4step.py:{line}",
            "path": variant, "fft_impl": fft_impl,
            "precision": timed[0]["precision"],
            "karatsuba": any(any(r["karatsuba"]) if isinstance(
                r.get("karatsuba"), list) else r.get("karatsuba", False)
                for r in timed),
            "launches": launches, "max_abs_err": err,
            "ms": sum(r["ms"] for r in timed),
            "plain_ms": sum(r["plain_ms"] for r in timed),
            "bound_ms": sum(r["bound_ms"] for r in timed),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in timed) else "operations",
            "library_ms": sum(r["library_ms"] for r in timed)}


def subnormal_lines(torch, x, axis):
    """Odd lines times 1e-40 (subnormal floats), beside unit-scale lines:
    where the bs16 codec changes a result on the Stockham route."""
    scale = torch.ones(x[0].shape[-2 if axis == 1 else -1],
                       device=x[0].device)
    scale[1::2] = 1e-40
    view = (-1, 1) if axis == 1 else (1, -1)
    return [t * scale.view(view) for t in x]


def precision_sweeps(torch, ops, dev):
    """Phase 15a: the Stockham route at bf16, f16 and bs16 against the
    plain versions: the spectral kernel at ``STOCKHAM_SIZES`` (every filter
    mode x axis x fwd/inv, B = 2, 37 lines, odd lines subnormal) and both
    megakernels over ``mega_chains()`` and ``BS16_CHAINS`` on the shapes up
    to 256^2 (a unit-scale scene beside a subnormal one). bs16 equals its
    plain version bit for bit and differs from f32 where values are
    subnormal alone (a round trip with nothing between, fwd+inv unfiltered,
    may land on the input's subnormal grid either way, so it is counted
    apart); bf16 and f16 equal f32."""
    from repro_torch.kernels.fft4step import FILTER_MODES
    rand = seeded_randn(torch, dev, 5)
    lines, rank = 37, 2
    cases = differ = trips = trips_differ = 0
    for n in STOCKHAM_SIZES:
        for axis in (0, 1):
            scene = (lines, n) if axis == 1 else (n, lines)
            x = subnormal_lines(torch, (rand(2, *scene), rand(2, *scene)),
                                axis)
            normal = (slice(None), slice(0, None, 2)) if axis == 1 else \
                (slice(None), slice(None), slice(0, None, 2))
            for mode in FILTER_MODES:
                filt = {}
                if mode in ("shared", "shared_outer"):
                    filt.update(hr=rand(n), hi=rand(n))
                if mode == "full":
                    filt.update(hr=rand(*scene), hi=rand(*scene))
                if mode in ("outer", "shared_outer"):
                    filt.update(u=rand(lines, rank), v=rand(n, rank))
                for fwd, inv in ((True, False), (False, True), (True, True),
                                 (False, False)):
                    if mode == "none" and not (fwd or inv):
                        continue
                    kw = dict(axis=axis, fwd=fwd, inv=inv, filter_mode=mode,
                              block=1, fft_impl="stockham")
                    f32 = ops.spectral_op(*x, **filt, **kw)
                    got = ops.spectral_op(*x, **filt, precision="bs16", **kw)
                    want = ops.spectral_op_plain(*x, **filt,
                                                 precision="bs16", **kw)
                    torch.cuda.synchronize()
                    check(all(torch.equal(g, w) for g, w in zip(got, want)),
                          f"bs16 kernel != plain {kw} n={n}")
                    check(all(torch.equal(g[normal], w[normal])
                              for g, w in zip(got, f32)),
                          f"bs16 != f32 on unit-scale lines {kw} n={n}")
                    changed = not all(torch.equal(g, w)
                                      for g, w in zip(got, f32))
                    if mode == "none" and fwd and inv:
                        trips += 1
                        trips_differ += changed
                    else:
                        differ += changed
                    for precision in ("bf16", "f16"):
                        narrow = ops.spectral_op(*x, **filt,
                                                 precision=precision, **kw)
                        check(all(torch.equal(g, w)
                                  for g, w in zip(narrow, f32)),
                              f"{precision} != f32 {kw} n={n}")
                    cases += 1
    check(differ == cases - trips, f"bs16 equals f32 on subnormal lines in "
          f"{cases - trips - differ} of {cases - trips} cases")
    m_cases = m_pairs = 0
    for na, nr in MEGA_SHAPES[:-1]:
        for segments in mega_chains() + list(BS16_CHAINS):
            x = [rand(2, na, nr), rand(2, na, nr)]
            for t in x:
                t[1] *= 1e-40
            args = []
            for axis, _fwd, _inv, mode in segments:
                n, nl = (nr, na) if axis == 1 else (na, nr)
                if mode in ("shared", "shared_outer"):
                    args += [rand(n), rand(n)]
                if mode == "full":
                    args += [rand(na, nr), rand(na, nr)]
                if mode in ("outer", "shared_outer"):
                    args += [rand(nl, 2), rand(n, 2)]
            kw = dict(segments=segments, fft_impl="stockham")
            want = ops.mega_spectral_op_plain(*x, *args, precision="bs16",
                                              **kw)
            outs = []
            for residency in ("vmem", "staged"):
                if residency == "vmem" and \
                        ops.mega_residency(na, nr) != "vmem":
                    continue
                got = ops.mega_spectral_op(*x, *args, residency=residency,
                                           precision="bs16", **kw)
                f32 = ops.mega_spectral_op(*x, *args, residency=residency,
                                           **kw)
                torch.cuda.synchronize()
                where = f"{residency} {segments} {na}x{nr}"
                check(all(torch.equal(g, w) for g, w in zip(got, want)),
                      f"bs16 megakernel != plain {where}")
                check(all(torch.equal(g[0], w[0]) for g, w in zip(got, f32))
                      and not all(torch.equal(g[1], w[1])
                                  for g, w in zip(got, f32)),
                      f"bs16 vs f32 megakernel {where}")
                for precision in ("bf16", "f16"):
                    narrow = ops.mega_spectral_op(
                        *x, *args, residency=residency, precision=precision,
                        **kw)
                    check(all(torch.equal(g, w)
                              for g, w in zip(narrow, f32)),
                          f"{precision} megakernel != f32 {where}")
                outs.append(got)
                m_cases += 1
            if len(outs) == 2:
                check(all(torch.equal(a, b) for a, b in zip(*outs)),
                      f"bs16 resident != staged {segments} {na}x{nr}")
                m_pairs += 1
    emit("precision_kernel", fft_impl="stockham", precisions=list(NARROW),
         spectral_cases=cases, bs16_differs_from_f32_cases=differ,
         round_trips=trips, round_trips_differing=trips_differ,
         sizes=STOCKHAM_SIZES, mega_cases=m_cases,
         resident_equals_staged_cases=m_pairs, equal_to_plain=True)


def precision_phases(torch, smi_line, cfg, raw, score, replay_plain, small,
                     small_raw, f32_images):
    """Phase 15b: every main-path variant on the Stockham route at bf16,
    f16 and bs16 on the paper's scene (and fused1 / fused3 on 128^2):
    launch counts, ``torch.equal`` to the plain version on the card,
    within 0.1 dB of the f32 image; each bs16 launch timed. Returns the
    ``kernels`` records of the bs16 paths."""
    from repro_torch.core.sar import build_pipeline
    from repro_torch.core import plan as planlib
    records = []
    for variant in PRECISION_VARIANTS:
        one = variant.endswith("fused1")
        f32_img = f32_images[variant]
        rep_f32 = score(f32_img)
        for precision in NARROW:
            pipe = build_pipeline(cfg, variant, fft_impl="stockham",
                                  precision=precision)
            reset_launch_counts()
            img = pipe.run(raw)
            torch.cuda.synchronize()
            counts, want = (launch_counts(mega_staged=1) if one
                            else launch_counts(spectral=3))
            check(counts == want, f"{variant} {precision} launches {counts}")
            check(bool(torch.isfinite(img).all()),
                  f"{variant} {precision}: non-finite")
            plain = (replay_mega_plain(pipe.steps[0], raw) if one
                     else replay_plain(pipe, raw))
            torch.cuda.synchronize()
            check(torch.equal(img, plain), f"{variant} {precision} != plain")
            rep = score(img)
            dsnr = check_focus(f"{variant} {precision} vs f32", rep, rep_f32)
            emit("main", variant=variant, fft_impl="stockham",
                 precision=precision, scene=[cfg.na, cfg.nr],
                 launches=counts, equal_to_plain=True,
                 equal_to_f32=torch.equal(img, f32_img),
                 snr_delta_db_vs_f32=dsnr)
            if precision == "bs16":
                if one:
                    timed = [time_mega_kernel(
                        torch, smi_line, "mega_staged", pipe.steps[0], raw,
                        cfg, variant=variant)]
                else:
                    timed = []
                    for s, x in step_inputs(pipe, raw)[0]:
                        xr, xi = planlib.split(x)
                        timed.append(time_spectral_launch(
                            smi_line, s, xr, xi, x, variant=variant))
                records.append(kernel_record(
                    "mega_staged" if one else "spectral", variant,
                    "stockham", counts["mega_staged" if one else "spectral"],
                    0.0, timed))
            del img, plain
    # the resident megakernel at bs16 on one 128^2 scene per SM, beside the
    # same kernel at f32 in this call
    batch_raw = small_raw.expand(MEGA_BATCH, *small_raw.shape).contiguous()
    for variant in ("fused1", "csa_fused1", "omegak_fused1"):
        timed = {}
        for precision in ("f32", "bs16", "bs16", "f32"):
            pipe = build_pipeline(small, variant, fft_impl="stockham",
                                  precision=precision)
            reset_launch_counts()
            img = pipe.run(batch_raw)
            torch.cuda.synchronize()
            counts, want = launch_counts(mega_resident=1)
            check(counts == want, f"{variant} 132 x 128^2 {precision}")
            check(torch.equal(img, replay_mega_plain(pipe.steps[0],
                                                     batch_raw)),
                  f"{variant} 132 x 128^2 {precision} != plain")
            timed.setdefault(precision, []).append(time_mega_kernel(
                torch, smi_line, "mega_resident", pipe.steps[0], batch_raw,
                small, variant=variant))
        records.append(kernel_record("mega_resident", variant, "stockham",
                                     counts["mega_resident"], 0.0,
                                     timed["bs16"][:1]))
        emit("time_run", variant=f"{variant}_f32_vs_bs16",
             scene=[small.na, small.nr], batch=MEGA_BATCH,
             order=["f32", "bs16", "bs16", "f32"],
             f32_ms=[t["ms"] for t in timed["f32"]],
             bs16_ms=[t["ms"] for t in timed["bs16"]], nvidia_smi=smi_line)
    small_f32 = build_pipeline(small, "fused3", fft_impl="stockham").run(
        small_raw)
    for precision in NARROW:
        kw = dict(fft_impl="stockham", precision=precision)
        f3 = build_pipeline(small, "fused3", **kw).run(small_raw)
        pipe = build_pipeline(small, "fused1", **kw)
        reset_launch_counts()
        img = pipe.run(small_raw)
        torch.cuda.synchronize()
        counts, want = launch_counts(mega_resident=1)
        check(counts == want, f"fused1 128^2 {precision} launches {counts}")
        check(torch.equal(img, f3), f"fused1 != fused3 128^2 {precision}")
        check(torch.equal(img, replay_mega_plain(pipe.steps[0], small_raw)),
              f"fused1 128^2 {precision} != plain")
        emit("main", variant="fused1", fft_impl="stockham",
             precision=precision, scene=[small.na, small.nr],
             launches=counts, equal_to_fused3=True, equal_to_plain=True,
             equal_to_f32=torch.equal(img, small_f32))
    return records


# Phase 16: the matmul route's operand forms (precision, karatsuba)
FORMS16 = (("f32", True), ("bf16", False), ("f16", False), ("bs16", False),
           ("bs16", True))
# the forms timed beside f32, in turns
TIMED_FORMS = (("f32", False), ("bf16", False), ("bs16", False),
               ("f32", True))
FUSED1_SEGMENTS = (dict(axis=0, fwd=True),
                   dict(axis=1, fwd=True, inv=True, filtered=True),
                   dict(axis=0, inv=True, filtered=True))


def bit_equal(torch, a, b):
    """Equal bit for bit, NaN payloads included (an f16 image overflows)."""
    return torch.equal(torch.view_as_real(a).view(torch.int32),
                       torch.view_as_real(b).view(torch.int32))


def form_kw(precision, karatsuba):
    """Compile keywords of one operand form: the precision, and Karatsuba
    in every segment through a Schedule (each fused3 launch and each
    in-kernel segment of fused1 take one segment of it), tuning off."""
    from repro_torch import tuning
    sched = tuning.Schedule(
        segments=(tuning.SegmentConfig(karatsuba=True),) * 3) \
        if karatsuba else None
    return dict(precision=precision, schedule=sched, tune="off")


def form_sweeps(torch, ops, dev):
    """Phase 16.1: each operand form of the matmul route against the plain
    versions on the card: the spectral kernel's grid of phase 3 (both
    splits at N = 4096, odd lines subnormal for bs16), phase 6's chains
    through both megakernels (resident == staged); f32 with Karatsuba
    against complex128 at N = 4096 too."""
    for i, (precision, kara) in enumerate(FORMS16):
        t0 = time.perf_counter()
        kw = dict(precision=precision, karatsuba=kara,
                  tol=FORM_TOL[precision], subnormal=precision == "bs16")
        # f16 (no codec) overflows its range on a random 4096^2 chain, in
        # the plain version as in the kernels: its chains stop at 256^2
        shapes = MEGA_SHAPES[:-1] if precision == "f16" else MEGA_SHAPES
        sw = spectral_sweep(torch, ops, seeded_randn(torch, dev, 20 + i),
                            "matmul", splits=((None, None), (128, 32)), **kw)
        ms = mega_sweep(torch, ops, seeded_randn(torch, dev, 30 + i),
                        "matmul", shapes=shapes, **kw)
        emit("form_kernel", precision=precision, karatsuba=kara,
             tol=FORM_TOL[precision], oracle_tol=ORACLE_TOL, spectral=sw,
             mega=ms, mega_shapes=shapes, seconds=time.perf_counter() - t0)


def form_images(torch, smi_line, cfg, raw, score, replay_plain, small,
                small_raw):
    """Phase 16.2: fused3 and fused1 at 4096^2 and fused1 at 128^2 at each
    operand form: launch counts, the focus gate against the f32 image and
    the plain replay, fused1 bit for bit equal to fused3, resident to
    staged. At 4096^2 f16 and bs16 overflow f16's range (the range
    launch's inverse sums a compressed line past 65504 before its 1/N,
    behind bs16's per-line exponents too): there the plain replay must be
    non-finite as well, and the counts of non-finite points are printed.
    Returns the
    ``kernels`` records of each form's paths (launch counts and errors
    from these runs, times from phase 16.4)."""
    from repro_torch.core.sar import build_pipeline
    f32_img = build_pipeline(cfg, "fused3").run(raw)
    rep_f32 = score(f32_img)
    del f32_img
    out = {}
    for precision, kara in FORMS16[1:] + (("f32", True),):
        if (precision, kara) in out:
            continue
        kw = form_kw(precision, kara)
        p3 = build_pipeline(cfg, "fused3", **kw)
        reset_launch_counts()
        img3 = p3.run(raw)
        torch.cuda.synchronize()
        c3, want = launch_counts(spectral=3)
        check(c3 == want, f"fused3 {precision} kara={kara}: {c3}")
        p1 = build_pipeline(cfg, "fused1", **kw)
        reset_launch_counts()
        img1 = p1.run(raw)
        torch.cuda.synchronize()
        c1, want = launch_counts(mega_staged=1)
        check(c1 == want, f"fused1 {precision} kara={kara}: {c1}")
        check(bit_equal(torch, img1, img3),
              f"fused1 != fused3 at {precision} kara={kara}")
        plain = replay_plain(p3, raw)
        torch.cuda.synchronize()
        # the kernels' image has the plain replay's non-finite points, no
        # others, and is within FORM_TOL of it on the rest
        fin = torch.isfinite(plain)
        check(torch.equal(torch.isfinite(img3), fin),
              f"fused3 {precision} kara={kara}: non-finite points differ "
              f"from the plain replay's")
        err = rel = 0.0              # f16 at 4096^2: no finite point
        if bool(fin.any()):
            got, want = img3[fin], plain[fin]
            err, rel = rel_err((got.real, got.imag), (want.real, want.imag))
            del got, want
        check(rel <= FORM_TOL[precision],
              f"fused3 {precision} kara={kara} vs plain on its finite "
              f"points: {rel:.3e}")
        finite = bool(fin.all())
        rec = dict(variant="fused3+fused1", precision=precision,
                   karatsuba=kara, scene=[cfg.na, cfg.nr],
                   launches=[c3, c1], fused1_equals_fused3=True,
                   finite=finite, max_abs_err_vs_plain=err,
                   rel_err_vs_plain=rel, tol=FORM_TOL[precision])
        if finite:
            rep = score(img3)
            rec.update(
                targets=rep,
                snr_delta_db_vs_f32=check_focus(
                    f"fused3 {precision} vs f32", rep, rep_f32),
                snr_delta_db_vs_plain=check_focus(
                    f"fused3 {precision} vs plain", rep, score(plain)))
        else:
            # f16's range: a compressed range line's partial sums pass
            # 65504 (PERF.md §6)
            check(precision in ("f16", "bs16"),
                  f"fused3 {precision} kara={kara}: non-finite image")
            rec.update(nonfinite_points=int((~fin).sum()))
        del img1, img3, plain, fin
        # 128^2: mega_resident, and staged
        f3s = build_pipeline(small, "fused3", **kw).run(small_raw)
        p1s = build_pipeline(small, "fused1", **kw)
        reset_launch_counts()
        img1s = p1s.run(small_raw)
        torch.cuda.synchronize()
        cs, want = launch_counts(mega_resident=1)
        check(cs == want, f"fused1 128^2 {precision} kara={kara}: {cs}")
        check(bit_equal(torch, img1s, f3s),
              f"fused1 != fused3 at 128^2, {precision} kara={kara}")
        staged = build_pipeline(small, "fused1", residency="staged",
                                **kw).run(small_raw)
        check(bit_equal(torch, staged, img1s),
              f"resident != staged at 128^2, {precision} kara={kara}")
        rec.update(launches_128=cs, resident_equals_staged_128=True)
        emit("form_image", **rec)
        out[(precision, kara)] = rec
    return out


def tuning_path(torch, smi_line, cfg, raw, score, replay_plain, small,
                small_raw):
    """Phase 16.3: the tuning path at full width, its cache in a temporary
    directory: ``search_kernel`` at N = 4096 (f32, bf16, bs16 behind the
    SNR gate), the winner persisted and read back by ``build_pipeline``'s
    default ``tune="cached"`` into every fused3 launch of the paper's
    scene; ``search_schedule`` for fused1 at 4096^2 (staged) and 128^2
    (both lanes), fused1 compiled through each winner, bit for bit equal
    to ``mega_spectral_op`` with the same knobs given by hand; a schedule
    whose azimuth and range segments split differently reaching
    ``mega_staged`` as those segment records."""
    import tempfile
    from repro_torch import tuning
    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import build_pipeline
    from repro_torch.kernels import ops
    outer_cache = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
            tmp, "autotune_cache.json")
        tuning.clear_memory_cache()
        planlib.clear_pipeline_cache()
        # -- search_kernel ---------------------------------------------------
        gates, timed = {}, []

        def log(what, t, r):
            if isinstance(what, str):       # gate_<precision>, dB, admitted
                gates[what[5:]] = dict(
                    snr_delta_db=t if t != float("inf") else None,
                    image_finite=t != float("inf"), admitted=r)
            else:
                timed.append(dict(config=what.to_dict(), seconds=t,
                                  rung=r))

        t0 = time.perf_counter()
        key = tuning.TuneKey.kernel(cfg.nr, lines=16)
        res = tuning.search_kernel(key, precisions=("f32", "bf16", "bs16"),
                                   log=log)
        search_s = time.perf_counter() - t0
        check(res.measured < res.space,
              f"search timed {res.measured} of {res.space}")
        # a candidate the cost model admits and the kernel refuses is a
        # bug in the cut, not noise: measured_search records it as None
        check(all(t is not None for _, t in res.trace),
              f"search_kernel candidates raised at launch: "
              f"{[c.to_dict() for c, t in res.trace if t is None]}")
        check(tuning.cached_config(cfg.nr) == res.config,
              "the search's winner did not persist")
        win = res.config
        emit("tuning_search", key=key.encode(), space=res.space,
             measured=res.measured, gates=gates, times=timed,
             winner=win.to_dict(), winner_seconds=res.seconds,
             predicted_rank=res.predicted_rank, seconds=search_s,
             nvidia_smi=smi_line)

        # -- fused3 through the cache ---------------------------------------
        pipe = build_pipeline(cfg, "fused3")
        for s in pipe.steps:
            kk = s.kernel_kw
            got = (kk["n1"], kk["n2"], kk["karatsuba"], kk["precision"])
            check(got == (win.n1, win.n2, bool(win.karatsuba),
                          win.precision or "f32"),
                  f"fused3 launch {s.name} took {got}, not the winner")
            n = cfg.nr if kk["axis"] == 1 else cfg.na
            line = (1, 1, n) if kk["axis"] == 1 else (1, n, 1)
            spec = ops._prepare(
                torch.empty(line), torch.empty(line), None, None, None,
                None, axis=kk["axis"], fwd=kk["fwd"], inv=kk["inv"],
                filter_mode="none", block=1, fft_impl=kk["fft_impl"],
                karatsuba=kk["karatsuba"], precision=kk["precision"],
                n1=kk["n1"], n2=kk["n2"], n3=kk["n3"])[0]
            check((spec.factors(), spec.karatsuba, spec.precision) ==
                  ((win.n1, win.n2), bool(win.karatsuba),
                   win.precision or "f32"), f"{s.name}: spec {spec}")
        reset_launch_counts()
        img = pipe.run(raw)
        torch.cuda.synchronize()
        counts, want = launch_counts(spectral=3)
        check(counts == want, f"tuned fused3 launches {counts}")
        rep = score(img)
        dsnr = check_focus("tuned fused3 vs plain", rep,
                           score(replay_plain(pipe, raw)))
        emit("tuned_main", variant="fused3", scene=[cfg.na, cfg.nr],
             launches=counts, winner=win.to_dict(), targets=rep,
             snr_delta_db_vs_plain=dsnr)
        del img

        # -- search_schedule and fused1 through its winners ---------------
        scheds = {}
        for scene, sraw, lanes in ((cfg, raw, ("staged",)),
                                   (small, small_raw, ("vmem", "staged"))):
            problem = tuning.ScheduleProblem.mega_2d(
                scene.na, scene.nr,
                tuple(tuning.SegmentShape(**d) for d in FUSED1_SEGMENTS))
            skey = tuning.TuneKey.pipeline("fused1", scene.na, scene.nr)
            t0 = time.perf_counter()
            # search_schedule has no SNR gate (as the reference's): the
            # precisions whose 4096^2 images are finite
            sres = tuning.search_schedule(
                problem, skey, k=8, precisions=("f32", "bf16"))
            check({s.residency for s, _ in sres.trace} <= set(lanes),
                  f"{scene.na}^2: a lane the kernels refuse was measured")
            check(all(t is not None for _, t in sres.trace),
                  f"{scene.na}^2: a frontier schedule raised at launch")
            best = sres.schedule
            p1 = build_pipeline(scene, "fused1", schedule=best)
            step = p1.steps[0]
            check(step.kernel_kw["residency"] == best.residency,
                  "fused1 compiled a residency its schedule did not pick")
            reset_launch_counts()
            img = p1.run(sraw)
            torch.cuda.synchronize()
            kernel = ("mega_resident" if best.residency == "vmem"
                      else "mega_staged")
            counts, want = launch_counts(**{kernel: 1})
            check(counts == want, f"scheduled fused1 launches {counts}")
            by_hand = tuple(
                (d["axis"], d.get("fwd", False), d.get("inv", False), mode,
                 sc.n1, sc.n2, sc.n3, sc.karatsuba)
                for d, mode, sc in zip(
                    FUSED1_SEGMENTS, [r[3] for r in step.kernel_kw[
                        "segments"]], best.segments))
            xr, xi = planlib.split(sraw)
            explicit = planlib.unsplit(*ops.mega_spectral_op(
                xr, xi, *[t for a in step.seg_filter_args for t in a],
                segments=by_hand, residency=best.residency,
                precision=best.precision or "f32"))
            check(bit_equal(torch, img, explicit),
                  f"fused1 through the schedule != by hand at "
                  f"{scene.na}^2")
            emit("tuning_schedule", scene=[scene.na, scene.nr],
                 frontier=sres.space, measured=sres.measured,
                 winner=best.to_dict(), winner_seconds=sres.seconds,
                 predicted_rank=sres.predicted_rank, launches=counts,
                 equal_to_explicit=True,
                 seconds=time.perf_counter() - t0)
            scheds[scene.na] = best
            del img, explicit

        # -- different splits for the azimuth and range segments -----------
        # at 4096^2: (64, 64) with Karatsuba on azimuth, (128, 32) on range
        az = (*tuning.factorizations(cfg.na)[0], None, True)
        rg = (*tuning.factorizations(cfg.nr)[1], None, False)
        mixed = tuning.Schedule(
            segments=tuple(tuning.SegmentConfig(*r) for r in (az, rg, az)),
            residency="staged")
        # tune="off": f32, not the cached winner's precision
        p1 = build_pipeline(cfg, "fused1", schedule=mixed, tune="off")
        recs = [r[4:] for r in p1.steps[0].kernel_kw["segments"]]
        check(recs == [az, rg, az], f"segment records {recs}")
        reset_launch_counts()
        img = p1.run(raw)
        torch.cuda.synchronize()
        counts, want = launch_counts(mega_staged=1)
        check(counts == want, f"mixed-split fused1 launches {counts}")
        plain = replay_mega_plain(p1.steps[0], raw)
        _, rel = rel_err((img.real, img.imag), (plain.real, plain.imag))
        check(rel <= TOL, f"mixed-split fused1 vs plain: {rel:.3e}")
        default = build_pipeline(cfg, "fused1", tune="off").run(raw)
        check(not torch.equal(img, default),
              "the mixed splits did not reach the kernel")
        emit("tuning_mixed_splits", scene=[cfg.na, cfg.nr],
             segment_records=recs, launches=counts, rel_err_vs_plain=rel,
             differs_from_default_splits=True)
        del img, plain, default
        os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE")
        if outer_cache is not None:
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = outer_cache
        tuning.clear_memory_cache()
        planlib.clear_pipeline_cache()
    return search_s


def form_times(torch, smi_line, cfg, raw, small, small_raw, images):
    """Phase 16.4: each fused3 launch and both megakernels at bf16, bs16
    and f32 with Karatsuba, beside f32, in turns (f32, forms..., forms
    reversed, f32): the first pass times kernel, plain version and
    library, the second the kernel again. Returns the ``kernels`` records
    of the timed forms."""
    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import build_pipeline
    from repro_torch.kernels import ops
    batch_raw = small_raw.expand(MEGA_BATCH, *small_raw.shape).contiguous()
    paths = {}
    for form in TIMED_FORMS:
        kw = form_kw(*form)
        p3 = build_pipeline(cfg, "fused3", **kw)
        paths[form] = dict(
            launches=[(s, *planlib.split(x), x)
                      for s, x in step_inputs(p3, raw)[0]],
            staged=build_pipeline(cfg, "fused1", **kw).steps[0],
            resident=build_pipeline(small, "fused1", **kw).steps[0])
    first = {}
    for form in TIMED_FORMS:
        p = paths[form]
        variant = "fused3" if form == ("f32", False) else \
            f"fused3_{form[0]}{'_kara' if form[1] else ''}"
        first[form] = dict(
            launches=[time_spectral_launch(smi_line, s, xr, xi, x,
                                           variant=variant)
                      for s, xr, xi, x in p["launches"]],
            staged=time_mega_kernel(torch, smi_line, "mega_staged",
                                    p["staged"], raw, cfg),
            resident=time_mega_kernel(torch, smi_line, "mega_resident",
                                      p["resident"], batch_raw, small))
    second = {}
    scenes = {"staged": planlib.split(raw),
              "resident": planlib.split(batch_raw)}

    def mega_ms(step, x):
        args = [t for a in step.seg_filter_args for t in a]
        return cuda_median_ms(lambda: ops.mega_spectral_op(
            *x, *args, **step.kernel_kw), queued=True)

    for form in reversed(TIMED_FORMS):
        p = paths[form]
        second[form] = dict(
            launches=[cuda_median_ms(lambda: ops.spectral_op(
                xr, xi, **s.filter_kw, **s.kernel_kw), queued=True)
                for s, xr, xi, x in p["launches"]],
            **{k: mega_ms(p[k], x) for k, x in scenes.items()})
    order = [list(f) for f in TIMED_FORMS + tuple(reversed(TIMED_FORMS))]
    for form in TIMED_FORMS:
        f1, f2 = first[form], second[form]
        emit("time_forms", precision=form[0], karatsuba=form[1],
             order=order, fused3_launch_ms=[
                 [r["ms"], t] for r, t in zip(f1["launches"],
                                              f2["launches"])],
             fused3_sum_ms=[sum(r["ms"] for r in f1["launches"]),
                            sum(f2["launches"])],
             fused3_mma_floor_ms=sum(r["mma_floor_ms"]
                                     for r in f1["launches"]),
             fused3_bound_ms=sum(r["bound_ms"] for r in f1["launches"]),
             fused3_plain_ms=sum(r["plain_ms"] for r in f1["launches"]),
             fused3_library_ms=sum(r["library_ms"]
                                   for r in f1["launches"]),
             mega_staged_ms=[f1["staged"]["ms"], f2["staged"]],
             mega_staged_mma_floor_ms=f1["staged"]["mma_floor_ms"],
             mega_resident_ms=[f1["resident"]["ms"], f2["resident"]],
             mega_resident_mma_floor_ms=f1["resident"]["mma_floor_ms"],
             nvidia_smi=smi_line)
    records = []
    for form in TIMED_FORMS[1:]:
        img = images.get(form, {})
        counts3, counts1 = img.get("launches", [{}, {}])
        err = img.get("max_abs_err_vs_plain", 0.0)
        variant = f"{form[0]}{'+karatsuba' if form[1] else ''}"
        records.append(kernel_record(
            "spectral", f"fused3 {variant}", "matmul",
            counts3.get("spectral", 0), err, first[form]["launches"]))
        records.append(kernel_record(
            "mega_staged", f"fused1 {variant}", "matmul",
            counts1.get("mega_staged", 0), err, [first[form]["staged"]],
            source="mega_forms.cu"))
        records.append(kernel_record(
            "mega_resident", f"fused1 128^2 {variant}", "matmul",
            img.get("launches_128", {}).get("mega_resident", 0), err,
            [first[form]["resident"]], source="mega_forms.cu"))
    return records


STREAM_STRIPS = 4              # phase 17's strips a streamed launch
STREAM_VARIANTS = (("fused3", "matmul"), ("fused3", "stockham"),
                   ("csa_fused", "matmul"), ("unfused", None))
BURST = 16                     # phase 17's 128^2 default-tier requests


def host_ms(torch, fn, reps=5):
    """Median host-clock ms of ``fn`` with a device synchronisation after
    it (a request or a streamed run: the host's time is the point)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def percentiles(values):
    """p50 / p99 of request latencies, nearest rank (the service's own
    ``metrics.percentile``)."""
    from repro_torch.service.metrics import percentile
    return {"p50_ms": percentile(values, 50),
            "p99_ms": percentile(values, 99), "n": len(values)}


def strip_launches(torch, pipe, raw_host, strips):
    """The spectral launches ``run_streamed`` makes, each with its own
    strip of the host scene on the card and its sliced filter payloads
    (for timing each beside its plain version and bound)."""
    import types
    from repro_torch.core import plan as planlib
    out = []
    x = torch.from_numpy(raw_host)
    for s in pipe.steps:
        n = x.shape[s.stream_axis]
        sizes = [n // strips + (1 if i < n % strips else 0)
                 for i in range(strips)]
        lo = 0
        for size in sizes:
            sl = planlib._strip(s.stream_axis, lo, lo + size)
            xs = x[sl].contiguous().cuda()
            fk = planlib._slice_filter_kwargs(
                s.filter_kw, s.filter_mode, s.phys_axis, lo, lo + size)
            out.append((types.SimpleNamespace(
                name=f"{s.name}[{lo}:{lo + size}]", kernel_kw=s.kernel_kw,
                filter_kw=fk), *planlib.split(xs), xs))
            lo += size
        x = s.fn(x.cuda()).cpu()
    return out


def service_breakdown(torch, backend, key, batch_host, strips=None):
    """Host-clock ms (median of 3, each ending in a synchronisation) of
    the steps a request's batch takes through ``backend`` outside the
    event loop: stacking, the copy up through pinned memory, the run, the
    copy back, the output sentinel; for a streamed key, ``run_streamed``
    alone and the backend's ``execute_streamed``."""
    import numpy as np
    from repro_torch.service.resilience import HealthSentinel
    sentinel = HealthSentinel()
    if strips is not None:
        pipe = backend._pipeline(key, variant=key.variant)
        img = pipe.run_streamed(batch_host[0], strips=strips)
        return dict(
            run_streamed_ms=host_ms(torch, lambda: pipe.run_streamed(
                batch_host[0], strips=strips), reps=3),
            execute_streamed_ms=host_ms(torch, lambda: backend.
                                        execute_streamed(key, batch_host[0],
                                                         strips), reps=3),
            sentinel_ms=host_ms(torch, lambda: sentinel.check(
                batch_host[0], img), reps=3))
    fn = backend._fn(key)
    padded = backend._to_device(batch_host)
    out = fn(padded)
    imgs = backend._to_host(out)
    return dict(
        stack_ms=host_ms(torch, lambda: np.stack(list(batch_host)), reps=3),
        to_device_ms=host_ms(torch, lambda: backend._to_device(batch_host),
                             reps=3),
        run_ms=host_ms(torch, lambda: fn(padded), reps=3),
        to_host_ms=host_ms(torch, lambda: backend._to_host(out), reps=3),
        sentinel_ms=host_ms(torch, lambda: [
            sentinel.check(r, i) for r, i in zip(batch_host, imgs)], reps=3),
        execute_ms=host_ms(torch, lambda: backend.execute(key, batch_host),
                           reps=3))


def service_phase(torch, smi_line, cfg, raw, score, small, small_raw):
    """Phase 17: the focusing service (``repro_torch.service``) on the
    card; returns its ``kernels`` records (path ``service:*``)."""
    import asyncio

    import numpy as np
    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import build_pipeline
    from repro_torch.kernels import ops
    from repro_torch.service import (BatchKey, ChaosBackend, FaultInjector,
                                     FocusService, LocalBackend,
                                     OutputCorrupted, ServiceConfig,
                                     SimulatedFailure, seeded_schedule)
    from repro_torch.service.resilience import LaneStalled
    raw_host = raw.cpu().numpy()
    small_host = small_raw.cpu().numpy()

    # -- 17.1 streamed pipelines at 4096^2 -----------------------------------
    streamed = {}
    for variant, fft_impl in STREAM_VARIANTS:
        kw = {} if fft_impl is None else {"fft_impl": fft_impl}
        pipe = build_pipeline(cfg, variant, **kw)
        want = pipe.run(raw).cpu().numpy()
        reset_launch_counts()
        got = pipe.run_streamed(raw_host, strips=STREAM_STRIPS)
        torch.cuda.synchronize()
        spectral = 3 * STREAM_STRIPS if variant != "unfused" else 0
        counts, want_counts = launch_counts(spectral=spectral)
        check(counts == want_counts,
              f"streamed {variant}/{fft_impl}: launches {counts}")
        check(np.array_equal(got, want),
              f"streamed {variant}/{fft_impl} != run at 4096^2")
        rec = dict(
            variant=variant, fft_impl=fft_impl, strips=STREAM_STRIPS,
            launches=counts, equal_to_run=True,
            streamed_ms=host_ms(torch, lambda: pipe.run_streamed(
                raw_host, strips=STREAM_STRIPS), reps=3),
            in_memory_ms=host_ms(torch, lambda: pipe.run(raw), reps=3),
            in_memory_from_host_ms=host_ms(
                torch, lambda: pipe.run(raw_host).cpu().numpy(), reps=3))
        streamed[(variant, fft_impl)] = rec
        emit("streamed", scene=[cfg.na, cfg.nr], nvidia_smi=smi_line, **rec)
        del want, got
    for variant in ("fused", "fused1"):
        try:
            build_pipeline(cfg, variant).run_streamed(raw_host)
        except ValueError:
            continue
        raise RuntimeError(f"check failed: run_streamed took {variant}")

    # -- 17.2 the service: burst, 4096^2 in memory, 4096^2 streamed ----------
    scenes = [small_host * np.float32(1 + 0.1 * i) for i in range(BURST)]

    async def timed(svc, x, c, **kw):
        t0 = time.perf_counter()
        img = await svc.focus(x, c, **kw)
        return img, (time.perf_counter() - t0) * 1e3

    async def main_service():
        svc = FocusService(ServiceConfig(), device=None)
        await svc.start(warm=[(small, "fused3", None),
                              (small, "fused3", "bs16"),
                              (cfg, "fused3", "f32")])
        await svc._ensure_gate_measured("bs16")
        reset_launch_counts()
        burst = await asyncio.gather(*[timed(svc, x, small)
                                       for x in scenes])
        torch.cuda.synchronize()
        burst_counts = launch_counts()[0]
        burst_snap = svc.metrics.snapshot()
        reset_launch_counts()
        big = [await timed(svc, raw_host, cfg, precision="f32")]
        torch.cuda.synchronize()
        big_counts = launch_counts()[0]
        for _ in range(4):
            big.append(await timed(svc, raw_host, cfg, precision="f32"))
        # a cooperative mega_staged launch (a request naming fused1 at
        # 4096^2) on one lane beside resident bursts on the other
        hist = dict(svc.metrics.snapshot()["batch_size_hist"])
        reset_launch_counts()
        mixed = await asyncio.gather(
            timed(svc, raw_host, cfg, variant="fused1", precision="f32"),
            *[timed(svc, x, small) for x in scenes[:8]])
        torch.cuda.synchronize()
        mixed_counts = launch_counts()[0]
        mixed_snap = svc.metrics.snapshot()
        mixed_batches = sum(mixed_snap["batch_size_hist"].values()) \
            - sum(hist.values()) - 1
        await svc.stop()
        return (svc, burst, burst_counts, burst_snap, big, big_counts,
                mixed, mixed_counts, mixed_batches, mixed_snap)

    t0 = time.perf_counter()
    (svc, burst, burst_counts, burst_snap, big, big_counts, mixed,
     mixed_counts, mixed_batches, mixed_snap) = asyncio.run(main_service())
    service_s = time.perf_counter() - t0
    deviation = svc._gate_cache["bs16"]
    tier = "bs16" if deviation <= GATE_DB else "f32"
    check(burst_snap["tier_fallbacks"] == (0 if tier == "bs16" else BURST),
          f"served tier: {burst_snap['tier_fallbacks']} fallbacks, gate "
          f"{deviation} dB")
    check(not svc.backend.fallbacks,
          f"off tier 0: {dict(svc.backend.fallbacks)}")
    batches = sum(burst_snap["batch_size_hist"].values())
    _, want_counts = launch_counts(mega_resident=batches)
    check(burst_counts == want_counts,
          f"burst launches {burst_counts} for {batches} batches")
    pipe1 = build_pipeline(small, "fused1", precision=tier)
    for x, (img, _) in zip(scenes, burst):
        check(np.array_equal(img, pipe1.run(x).cpu().numpy()),
              f"burst reply != fused1 at {tier}")
    _, want_counts = launch_counts(spectral=3)
    check(big_counts == want_counts, f"4096^2 launches {big_counts}")
    pipe3 = build_pipeline(cfg, "fused3")
    img3 = pipe3.run(raw)
    big_img = big[0][0]
    check(np.array_equal(big_img, img3.cpu().numpy()),
          "4096^2 served image != fused3")
    rep = score(torch.from_numpy(big_img))
    check_focus("service 4096^2", rep)
    _, want_counts = launch_counts(mega_staged=1,
                                   mega_resident=mixed_batches)
    check(mixed_counts == want_counts,
          f"mixed lanes: launches {mixed_counts}, {mixed_batches} bursts")
    check(np.array_equal(mixed[0][0], big_img),
          "4096^2 fused1 request != fused3 request")
    for x, (img, _) in zip(scenes[:8], mixed[1:]):
        check(np.array_equal(img, pipe1.run(x).cpu().numpy()),
              "mixed-lane burst reply != fused1")
    emit("service_concurrent", lanes=mixed_snap["lane_batches"],
         launches=mixed_counts, staged_equal_to_fused3=True,
         staged_latency_ms=mixed[0][1],
         burst_latency=percentiles([t for _, t in mixed[1:]]),
         nvidia_smi=smi_line)
    batch4 = torch.from_numpy(np.stack(scenes[:4])).cuda()
    emit("service", scene=[small.na, small.nr], requests=BURST,
         served_tier=tier, gate_snr_deviation_db=deviation,
         gate_db=GATE_DB, batch_size_hist=burst_snap["batch_size_hist"],
         lane_batches=burst_snap["lane_batches"], launches=burst_counts,
         equal_to_fused1=True, latency=percentiles([t for _, t in burst]),
         run_alone_batch4_ms=cuda_median_ms(lambda: pipe1.run(batch4)),
         run_alone_one_ms=cuda_median_ms(
             lambda: pipe1.run(small_raw)), nvidia_smi=smi_line)
    emit("service", scene=[cfg.na, cfg.nr], precision="f32",
         launches=big_counts, equal_to_fused3=True, targets=rep,
         latency=percentiles([t for _, t in big]),
         run_alone_ms=cuda_median_ms(lambda: pipe3.run(raw)),
         run_from_host_ms=host_ms(
             torch, lambda: pipe3.run(raw_host).cpu().numpy(), reps=3),
         service_seconds=service_s, nvidia_smi=smi_line)

    async def stream_service():
        svc2 = FocusService(ServiceConfig(
            device_budget_bytes=raw_host.nbytes - 1,
            stream_strips=STREAM_STRIPS), backend=svc.backend)
        await svc2.start()
        reset_launch_counts()
        out = [await timed(svc2, raw_host, cfg, precision="f32")]
        torch.cuda.synchronize()
        counts = launch_counts()[0]
        for _ in range(2):
            out.append(await timed(svc2, raw_host, cfg, precision="f32"))
        await svc2.stop()
        return out, counts, svc2.metrics.snapshot()

    stream_out, stream_counts, stream_snap = asyncio.run(stream_service())
    _, want_counts = launch_counts(spectral=3 * STREAM_STRIPS)
    check(stream_counts == want_counts,
          f"streamed request launches {stream_counts}")
    check(stream_snap["lane_batches"] == {"stream": 3}
          and stream_snap["streamed"] == 3,
          f"stream lane: {stream_snap['lane_batches']}")
    check(np.array_equal(stream_out[0][0], big_img),
          "streamed request != in-memory request")
    check(not svc.backend.fallbacks,
          f"off tier 0: {dict(svc.backend.fallbacks)}")
    emit("service_stream", scene=[cfg.na, cfg.nr], precision="f32",
         strips=STREAM_STRIPS, launches=stream_counts,
         equal_to_in_memory=True,
         latency=percentiles([t for _, t in stream_out]),
         in_memory_latency=percentiles([t for _, t in big]),
         nvidia_smi=smi_line)
    del big, stream_out, big_img
    for name, scene_cfg, prec, batch_host, strips in (
            ("burst", small, tier, np.stack(scenes[:4]), None),
            ("in_memory", cfg, "f32", raw_host[None], None),
            ("stream", cfg, "f32", raw_host[None], STREAM_STRIPS)):
        key = BatchKey(scene_cfg, "fused3", prec, strips is not None)
        emit("service_breakdown", request=name,
             scene=[scene_cfg.na, scene_cfg.nr], precision=prec,
             batch=len(batch_host), nvidia_smi=smi_line,
             **service_breakdown(torch, svc.backend, key, batch_host,
                                 strips))

    # -- 17.3 the seeded chaos replay ----------------------------------------
    ref = build_pipeline(small, "fused1").run(small_raw).cpu().numpy()
    injector = FaultInjector(
        seeded_schedule(20260808, 7,
                        ("dispatch_error", "nan_output", "lane_hang")),
        hang_timeout_s=60.0)
    inner = LocalBackend(sweep=((None, None),))
    chaos = ChaosBackend(inner, injector)

    async def replay():
        svc3 = FocusService(ServiceConfig(
            max_batch=2, max_delay_ms=20.0, precision=None, lanes=2,
            inflight_cap=1, max_retries=2, retry_backoff_ms=5.0,
            stall_factor=3.0, stall_floor_s=1.5), backend=chaos)
        await svc3.start(warm=[(small, "fused3", None)])
        outs = await asyncio.gather(
            *[svc3.focus(small_host, small) for _ in range(14)],
            return_exceptions=True)
        await svc3.stop()
        return outs, svc3.metrics.snapshot()

    try:
        outs, chaos_snap = asyncio.run(replay())
    finally:
        injector.release_hangs()
    lost = sum(1 for o in outs
               if not (isinstance(o, np.ndarray) and np.array_equal(o, ref))
               and not isinstance(o, (SimulatedFailure, OutputCorrupted,
                                      LaneStalled)))
    check(lost == 0, f"chaos replay lost {lost} requests")
    check(len(injector.seams_fired()) == 3,
          f"seams fired {injector.seams_fired()}")
    check(not inner.fallbacks, f"chaos off tier 0: {dict(inner.fallbacks)}")
    emit("service_chaos", scene=[small.na, small.nr], requests=14, lost=0,
         seams=injector.seams_fired(), completed=chaos_snap["completed"],
         failed=chaos_snap["failed"], retries=chaos_snap["retries"],
         lane_stalls=chaos_snap["lane_stalls"],
         bisections=chaos_snap["bisections"])

    # -- the service paths' kernels, each beside its plain version -----------
    key = BatchKey(small, "fused3", tier, False)
    step = svc.backend._pipeline(key).steps[0]
    check(step.kind == "mega" and step.kernel_kw["residency"] == "vmem",
          "the 128^2 service route is one resident mega step")
    xr, xi = planlib.split(batch4)
    args = [t for a in step.seg_filter_args for t in a]
    got = ops.mega_spectral_op(xr, xi, *args, **step.kernel_kw)
    want = ops.mega_spectral_op_plain(xr, xi, *args, **step.kernel_kw)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    check(rel <= FORM_TOL[tier], f"service mega_resident: {rel:.3e}")
    t_res = time_mega_kernel(torch, smi_line, "mega_resident", step, batch4,
                             small)
    records = [kernel_record("mega_resident", "service:fused1", "matmul",
                             burst_counts["mega_resident"], err, [t_res])]
    for path, pipe, counts, inputs in (
            ("service:fused3", pipe3, big_counts,
             [(s, *planlib.split(x), x)
              for s, x in step_inputs(pipe3, raw)[0]]),
            ("service:stream", pipe3, stream_counts,
             strip_launches(torch, pipe3, raw_host, STREAM_STRIPS))):
        err = 0.0
        for s, sxr, sxi, _ in inputs:
            got = ops.spectral_op(sxr, sxi, **s.filter_kw, **s.kernel_kw)
            want = ops.spectral_op_plain(sxr, sxi, **s.filter_kw,
                                         **s.kernel_kw)
            torch.cuda.synchronize()
            e, rel = rel_err(got, want)
            check(rel <= TOL, f"{path} launch {s.name}: {rel:.3e}")
            err = max(err, e)
        timed_launches = [time_spectral_launch(smi_line, s, sxr, sxi, x)
                          for s, sxr, sxi, x in inputs]
        records.append(kernel_record("spectral", path, "matmul",
                                     counts["spectral"], err,
                                     timed_launches))
    return records


SHARD_PS = (1, 2, 8)           # phase 18's slab counts on one card
SHARD_BATCH = 132              # 128^2 scenes of the resident lowering
SHARD_ROUTES = ("matmul", "stockham")
# bs16 at 4096^2 runs on the Stockham route: on the matmul route a
# compressed range line's partial sums overflow f16's range at this size,
# in the plain version too (phase 16)
SHARD_BS16_ROUTES = ("stockham",)
# every phase-18 line says what its P means on a one-card machine
SHARD_MESH = ("P slabs emulated on one H100 (a mesh repeating cuda:0): "
              "each slab its own launches, each corner turn on-card "
              "copies, not NVLink")
SHARD_TWINS = (("fused3", "fused3"), ("fused1", "fused3"),
               ("csa_fused1", "csa_fused"), ("omegak_fused1", "omegak"))


def slab_replay(torch, run, devices, raw):
    """A lowered f32 runner replayed unit by unit on its slabs: each
    unit's input slabs [(unit, xr, xi)] and each turn's [(from_axis, xr,
    xi)], and the output slabs."""
    from repro_torch.core import plan as planlib
    from repro_torch.distributed import mesh as meshlib
    bpre = raw.ndim - 2
    cur = run.units[0].stream_axis
    planes = [planlib.split(s)
              for s in meshlib.shard(raw, bpre + cur, devices)]
    xr, xi = [a for a, _ in planes], [b for _, b in planes]
    units, turns = [], []
    for u in run.units:
        if u.stream_axis != cur:
            turns.append((cur, bpre, xr, xi))
            xr = meshlib.all_to_all(xr, bpre + 1 - cur, bpre + cur)
            xi = meshlib.all_to_all(xi, bpre + 1 - cur, bpre + cur)
            cur = u.stream_axis
        units.append((u, xr, xi))
        outs = [u.apply(i, xr[i], xi[i]) for i in range(len(devices))]
        xr, xi = [o[0] for o in outs], [o[1] for o in outs]
    return units, turns


def _unit_plain(u, i, xr, xi):
    from repro_torch.kernels import ops
    if u.kind == "spectral":
        return ops.spectral_op_plain(xr, xi, **u.filter_args[i],
                                     **u.kernel_kw)
    return ops.mega_spectral_op_plain(xr, xi, *u.filter_args[i],
                                      **u.kernel_kw)


def _unit_library(torch, u, i, xr, xi):
    """One unit's math on one slab through torch.fft and torch multiplies
    (the yardstick library call): a spectral launch one ``_torch_apply``,
    a mega group one per segment."""
    from repro_torch.core import plan as planlib
    from repro_torch.kernels.fft4step import _filter_ref_count
    x = torch.complex(xr, xi)
    kk = u.kernel_kw
    if u.kind == "spectral":
        return planlib._torch_apply(x, kk["fwd"], kk["inv"],
                                    kk["filter_mode"], u.filter_args[i],
                                    kk["axis"])
    args = iter(u.filter_args[i])
    names = {"none": (), "shared": ("hr", "hi"), "full": ("hr", "hi"),
             "outer": ("u", "v"), "shared_outer": ("hr", "hi", "u", "v")}
    for rec in kk["segments"]:
        axis, fwd, inv, mode = rec[:4]
        fk = {n: next(args) for n in names[mode]}
        assert len(fk) == _filter_ref_count(mode)
        x = planlib._torch_apply(x, fwd, inv, mode, fk, axis)
    return x


def time_units(torch, smi_line, units, p, path, plain=True):
    """Each unit of a lowering timed alone on its P slabs (queued: the
    card's work, not the host's), beside its plain version, its
    torch.fft yardstick and its bound (the P slabs' bytes over 3.35 TB/s
    vs their nominal FLOP over 67 TFLOP/s); each launch held to its plain
    version at 2e-4 x max|want|. Returns the records."""
    from repro_torch.kernels.fft4step import (MegaSpec, SegmentSpec,
                                              SpectralSpec, _mega_flops,
                                              flops_nominal)
    recs = []
    for u, xr, xi in units:
        kk = u.kernel_kw
        err = 0.0
        nbytes = 0
        flops = 0.0
        for i in range(p):
            got = u.apply(i, xr[i], xi[i])
            want = _unit_plain(u, i, xr[i], xi[i])
            torch.cuda.synchronize()
            e, rel = rel_err(got, want)
            check(rel <= TOL, f"{path} {u.name} slab {i}: {rel:.3e}")
            err = max(err, e)
            fa = u.filter_args[i]
            fa = fa.values() if isinstance(fa, dict) else fa
            nbytes += 16 * xr[i].numel() + sum(4 * t.numel() for t in fa)
            batch = xr[i].shape[0] if xr[i].ndim == 3 else 1
            na, nr = xr[i].shape[-2:]
            if u.kind == "spectral":
                n = nr if kk["axis"] == 1 else na
                lines = batch * (na if kk["axis"] == 1 else nr)
                flops += flops_nominal(SpectralSpec(
                    n=n, fwd=kk["fwd"], inv=kk["inv"],
                    filter_mode=kk["filter_mode"], axis=kk["axis"]), lines)
            else:
                flops += batch * _mega_flops(MegaSpec(na, nr, tuple(
                    SegmentSpec(*r[:4]) for r in kk["segments"])))
        t_mem = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3

        def launch_all(fn):
            return lambda: [fn(i) for i in range(p)]
        rec = dict(
            path=path, unit=u.name, kind=u.kind, residency=u.residency,
            fft_impl=kk["fft_impl"], precision=kk["precision"], slabs=p,
            slab=list(xr[0].shape),
            ms=cuda_median_ms(launch_all(
                lambda i: u.apply(i, xr[i], xi[i])), queued=True),
            plain_ms=(cuda_median_ms(launch_all(
                lambda i: _unit_plain(u, i, xr[i], xi[i])), queued=True)
                if plain else None),
            library_ms=(cuda_median_ms(launch_all(
                lambda i: _unit_library(torch, u, i, xr[i], xi[i])),
                queued=True) if plain else None),
            bytes=nbytes, flops_nominal=flops, bound_ms=max(t_mem, t_ops),
            bound_by="bytes" if t_mem >= t_ops else "operations",
            max_abs_err=err, mesh=SHARD_MESH)
        emit("time_sharded_unit", nvidia_smi=smi_line, **rec)
        recs.append(rec)
    return recs


def time_turns(torch, smi_line, turns, path):
    """Each corner turn's copies alone (queued): the all-to-all of the re
    and im slabs, beside the bytes bound of its HBM traffic (the scene
    read and written once)."""
    from repro_torch.distributed import mesh as meshlib
    recs = []
    for k, (cur, bpre, xr, xi) in enumerate(turns):
        nbytes = 2 * 2 * 4 * sum(t.numel() for t in xr)
        ms = cuda_median_ms(lambda: (
            meshlib.all_to_all(xr, bpre + 1 - cur, bpre + cur),
            meshlib.all_to_all(xi, bpre + 1 - cur, bpre + cur)),
            queued=True)
        rec = dict(path=path, turn=k, from_axis=cur, slabs=len(xr),
                   bytes=nbytes, ms=ms,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, mesh=SHARD_MESH)
        emit("time_sharded_turn", nvidia_smi=smi_line, **rec)
        recs.append(rec)
    return recs


def mega_kernel(run):
    """The megakernel a lowering's groups launch, by their residency."""
    res = {u["residency"] for u in run.unit_info}
    check(len(res) == 1, f"mixed residencies {res}")
    return "mega_resident" if res == {"vmem"} else "mega_staged"


def sharded_record(name, path, launches, timed):
    """One ``kernels`` entry for a kernel on a phase-18 path: the sums over
    its units' P-slab launches."""
    line = {"spectral": 598, "mega_resident": 931, "mega_staged": 1002}[name]
    source = "spectral.cu" if name == "spectral" else "mega.cu"
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/fft4step.py:{line}",
            "path": path, "fft_impl": timed[0]["fft_impl"],
            "precision": timed[0]["precision"], "karatsuba": False,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in timed),
            "ms": sum(r["ms"] for r in timed),
            "plain_ms": sum(r["plain_ms"] for r in timed),
            "bound_ms": sum(r["bound_ms"] for r in timed),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in timed) else "operations",
            "library_ms": sum(r["library_ms"] for r in timed),
            "mesh": SHARD_MESH}


def sharded_phase(torch, smi_line, cfg, raw, score):
    """Phase 18: the multi-device lowering on one card. Returns its
    ``kernels`` records."""
    import asyncio

    import numpy as np

    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import (build_pipeline, filters, metrics,
                                      paper_targets, simulate)
    from repro_torch.core.sar import distributed as D
    from repro_torch.core.sar.geometry import test_scene as small_scene
    from repro_torch.service import (BatchKey, FocusService, LocalBackend,
                                     ServiceConfig)

    dev = torch.device("cuda", 0)
    scene = [cfg.na, cfg.nr]

    def counted(fn, **want):
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got, want = launch_counts(**want)
        return out, got, want

    # the local twins, each through the five-target gate once (a sharded
    # image equal to its twin passes it by that equality)
    local = {}
    for route in SHARD_ROUTES:
        for variant in ("fused3", "csa_fused", "omegak"):
            local[(variant, route, "f32")] = build_pipeline(
                cfg, variant, fft_impl=route).run(raw)
            check_focus(f"local {variant} {route}",
                        score(local[(variant, route, "f32")]))
        if route in SHARD_BS16_ROUTES:
            local[("fused1", route, "bs16")] = build_pipeline(
                cfg, "fused1", fft_impl=route, precision="bs16").run(raw)
            check_focus(f"local fused1 bs16 {route}",
                        score(local[("fused1", route, "bs16")]),
                        score(local[("fused3", route, "f32")]))
    torch.cuda.synchronize()
    unfused = build_pipeline(cfg, "unfused").run(raw)
    unfused_score = score(unfused)

    meshes = [(p, D.make_sar_mesh(devices=[dev] * p)) for p in SHARD_PS]
    visible = D.make_sar_mesh()
    meshes.append((visible.size(), visible))
    records = []
    timing = {}
    for p, mesh in meshes:
        devices = mesh.device_list()
        all_cards = mesh is visible
        for route in SHARD_ROUTES:
            for variant, twin in SHARD_TWINS:
                if all_cards and (variant, route) != ("fused1", "matmul"):
                    continue
                pins = [None, "staged"] if variant == "fused1" else [None]
                for res in pins:
                    kw = {} if res is None else {"residency": res}
                    run = build_pipeline(cfg, variant,
                                         fft_impl=route).lower_sharded(
                        mesh, **kw)
                    n = run.dispatches_per_device * p
                    kernel = ("spectral" if variant == "fused3"
                              else mega_kernel(run))
                    img, got, want = counted(lambda: run(raw),
                                             **{kernel: n})
                    check(got == want, f"{variant} P={p}: {got}")
                    check(run.devices == p and run.turns == 2
                          and run.dispatches_per_device == 3,
                          f"{variant} P={p}: shape")
                    ref = local[(twin, route, "f32")]
                    equal = bool(torch.equal(img, ref))
                    dsnr = []
                    if variant == "omegak_fused1" and not equal:
                        dsnr = check_focus(f"{variant} P={p}", score(img),
                                           score(ref))
                    else:
                        check(equal, f"{variant} {route} P={p} != {twin}")
                    emit("sharded", variant=variant, twin=twin,
                         fft_impl=route, precision="f32", residency=res,
                         slabs=p, all_visible_cards=all_cards, scene=scene,
                         launches=got, equal_to_twin=equal,
                         snr_delta_db=dsnr, unit_info=run.unit_info,
                         mesh=SHARD_MESH)
                    if route == "matmul" and res is None and \
                            variant in ("fused3", "fused1") and \
                            not all_cards:
                        units, turns = slab_replay(torch, run, devices, raw)
                        timing[(variant, p)] = dict(
                            run_ms=cuda_median_ms(lambda: run(raw)),
                            units=time_units(torch, smi_line, units, p,
                                             f"{variant} P={p}",
                                             plain=p == 8),
                            turns=time_turns(torch, smi_line, turns,
                                             f"{variant} P={p}"),
                            launches=got)
                        del units, turns
                    del run, img
            if all_cards or route not in SHARD_BS16_ROUTES:
                continue
            # bs16: the carried exponents all-gathered across the turns
            run = build_pipeline(cfg, "fused1", fft_impl=route,
                                 precision="bs16").lower_sharded(mesh)
            img, got, want = counted(lambda: run(raw),
                                     **{mega_kernel(run): 3 * p})
            check(got == want, f"fused1 bs16 P={p}: {got}")
            check(torch.equal(img, local[("fused1", route, "bs16")]),
                  f"fused1 bs16 {route} P={p} != local bs16")
            emit("sharded", variant="fused1", twin="fused1", fft_impl=route,
                 precision="bs16", slabs=p, scene=scene, launches=got,
                 equal_to_twin=True, unit_info=run.unit_info,
                 mesh=SHARD_MESH)
            del run, img
        if all_cards:
            continue
        # corner2, and its bf16 wire
        for turn_dtype in (None, torch.bfloat16):
            c2 = D.build_corner2(cfg, mesh, turn_dtype=turn_dtype)
            img, got, want = counted(lambda: c2(raw), spectral=3 * p)
            check(got == want, f"corner2 P={p}: {got}")
            ref = local[("fused3", "matmul", "f32")]
            if turn_dtype is None:
                check(torch.equal(img, ref), f"corner2 P={p} != fused3")
                dsnr = []
            else:
                dsnr = check_focus(f"corner2 bf16 P={p}", score(img),
                                   score(ref))
            emit("sharded_corner2", slabs=p, scene=scene,
                 turn_dtype=None if turn_dtype is None else "bfloat16",
                 launches=got, snr_delta_db=dsnr,
                 l2_rel_vs_fused3=l2_rel(torch, img, ref), mesh=SHARD_MESH)
            del img
    # halo at the largest P its bound admits (build_halo's own bound):
    # bit for bit its one-device plan (the same launches and sinc RCMC),
    # within 0.01 dB of unfused; the reference's l2 < 1e-5 against
    # unfused holds at its own scale, 256^2 (at 4096^2 the on-chip rank-2
    # azimuth phase against unfused's exact FULL filter alone gives ~1e-5,
    # in the one-device plan as in the halo runner)
    need = int(np.ceil(np.max(filters.rcmc_shift_samples(cfg)))) + 8
    p_halo = max(p for p in SHARD_PS if need <= cfg.nr // p)
    halo = D.build_halo(cfg, D.make_sar_mesh(devices=[dev] * p_halo))
    img, got, want = counted(lambda: halo(raw), spectral=3 * p_halo)
    check(got == want, f"halo P={p_halo}: {got}")
    twin = planlib.compile_plan(D.plan_halo(), cfg).run(raw)
    check(torch.equal(img, twin), f"halo P={p_halo} != its one-device plan")
    l2 = l2_rel(torch, img, unfused)
    dsnr = check_focus("halo", score(img), unfused_score, gate=0.01)
    hs = small_scene(256)
    hs_raw = simulate(hs, paper_targets(hs))
    hs_img = D.build_halo(hs, D.make_sar_mesh(devices=[dev] * 8))(hs_raw)
    hs_un = build_pipeline(hs, "unfused").run(hs_raw)
    hs_cmp = metrics.compare_pipelines(hs_img.cpu().numpy(),
                                       hs_un.cpu().numpy(), hs,
                                       paper_targets(hs))
    check(hs_cmp["l2_relative_error"] < 1e-5
          and max(hs_cmp["snr_delta_db"]) < 0.01,
          f"halo 256^2 vs unfused: {hs_cmp['l2_relative_error']:.3e}, "
          f"{hs_cmp['snr_delta_db']}")
    emit("sharded_halo", slabs=p_halo, halo=halo.halo, scene=scene,
         launches=got, equal_to_one_device_plan=True, l2_rel_vs_unfused=l2,
         snr_delta_db=dsnr, small_scene=[hs.na, hs.nr], small_slabs=8,
         small_l2_rel_vs_unfused=hs_cmp["l2_relative_error"],
         small_snr_delta_db=hs_cmp["snr_delta_db"], mesh=SHARD_MESH)
    del img, twin, halo, unfused, hs_img, hs_un

    # 132 x 128^2 lowered fused1 at P = 8: resident groups
    small = small_scene(128)
    one = simulate(small, paper_targets(small))
    batch = torch.stack([one * (1.0 + 0.01 * k) for k in range(SHARD_BATCH)])
    want_img = build_pipeline(small, "fused3").run(batch)
    mesh8 = dict(meshes[:len(SHARD_PS)])[8]
    run = build_pipeline(small, "fused1").lower_sharded(mesh8)
    check([u["residency"] for u in run.unit_info] == ["vmem"] * 3,
          f"128^2 / 8 residency {run.unit_info}")
    img, res_counts, want = counted(lambda: run(batch),
                                    mega_resident=3 * 8)
    check(res_counts == want, f"resident lowering: {res_counts}")
    check(torch.equal(img, want_img), "132 x 128^2 lowered != fused3")
    emit("sharded", variant="fused1", twin="fused3", fft_impl="matmul",
         precision="f32", slabs=8, scene=[small.na, small.nr],
         batch=SHARD_BATCH, launches=res_counts, equal_to_twin=True,
         unit_info=run.unit_info, mesh=SHARD_MESH)
    units, turns = slab_replay(torch, run, mesh8.device_list(), batch)
    res_timed = time_units(torch, smi_line, units, 8, "fused1 128^2 P=8")
    res_turns = time_turns(torch, smi_line, turns, "fused1 128^2 P=8")
    emit("time_sharded_run", variant="fused1", scene=[small.na, small.nr],
         batch=SHARD_BATCH, slabs=8, run_ms=cuda_median_ms(
             lambda: run(batch)),
         kernels_ms=sum(r["ms"] for r in res_timed),
         turns_ms=sum(r["ms"] for r in res_turns),
         local_run_ms=cuda_median_ms(
             lambda: build_pipeline(small, "fused1").run(batch)),
         nvidia_smi=smi_line, mesh=SHARD_MESH)
    del units, turns, img, batch, want_img, run

    # the runs per P: the run, the kernels alone, the turns' copies
    for (variant, p), t in sorted(timing.items()):
        emit("time_sharded_run", variant=variant, scene=scene, slabs=p,
             run_ms=t["run_ms"], kernels_ms=sum(r["ms"] for r in t["units"]),
             turns_ms=sum(r["ms"] for r in t["turns"]),
             turns_bound_ms=sum(r["bound_ms"] for r in t["turns"]),
             nvidia_smi=smi_line, mesh=SHARD_MESH)

    # the sharded backend through the service, and the local backend's
    # sharded route for a streamed scene
    raw_host = raw.cpu().numpy()
    ref_host = local[("fused3", "matmul", "f32")].cpu().numpy()

    async def serve():
        svc = FocusService(ServiceConfig(
            backend="sharded", precision=None, max_batch=2,
            max_delay_ms=200.0), mesh=mesh8)
        await svc.start()
        outs = await asyncio.gather(*[svc.focus(raw_host, cfg)
                                      for _ in range(3)])
        await svc.stop()
        return outs, svc.metrics.snapshot()

    (outs, snap), got, _ = counted(lambda: asyncio.run(serve()))
    batches = sum(snap["batch_size_hist"].values())
    check(got["spectral"] == 3 * 8 * batches and sum(got.values())
          == got["spectral"], f"sharded service launches {got}")
    check(all(np.array_equal(o, ref_host) for o in outs),
          "sharded service != local fused3")
    emit("sharded_service", backend="sharded", scene=scene, requests=3,
         batch_size_hist=snap["batch_size_hist"], launches=got,
         mesh=SHARD_MESH)
    backend = LocalBackend(sweep=((None, None),), mesh=mesh8)
    key = BatchKey(cfg, "fused3", None, True)
    check(backend._sharded_twin(key) == "fused1", "no sharded twin")
    out, got, _ = counted(lambda: backend.execute_streamed(key, raw_host))
    check(key in backend._sharded_fns, "the sharded route did not run")
    _, want = launch_counts(**{mega_kernel(backend._sharded_fns[key]): 24})
    check(got == want, f"sharded stream route: {got}")
    check(not backend.fallbacks, f"fallbacks {dict(backend.fallbacks)}")
    check(np.array_equal(out, ref_host), "sharded stream != fused3")
    emit("sharded_service", backend="local", route="sharded fused1 twin",
         scene=scene, launches=got, fallbacks={}, mesh=SHARD_MESH)

    t8 = timing[("fused3", 8)], timing[("fused1", 8)]
    records += [
        sharded_record("spectral", "sharded:fused3 P=8",
                       t8[0]["launches"]["spectral"], t8[0]["units"]),
        sharded_record("mega_staged", "sharded:fused1 P=8",
                       t8[1]["launches"]["mega_staged"], t8[1]["units"]),
        sharded_record("mega_resident", "sharded:fused1 128^2 P=8",
                       res_counts["mega_resident"], res_timed)]
    return records


LONG_SIZES = (8192, 16384, 32768, 2 ** 18, 2 ** 21)   # phase 19's sweep
LONG_ALL_MODES = (8192, 32768)   # every filter mode x fwd/inv at these N
LONG_SPLITS = ((8, 8, 8), (16, 8, 4), (16, 16, 16), (32, 16, 16))
LONG_ORACLE_N = 16384            # complex128 at ORACLE_TOL up to this N
LONG_ORACLE_TOL = 4e-5           # x max|want| past it (f32 over 2^21)
LONG_SCENE = (8192, 16384)       # the paper's geometry, 2^27 points
LONG_MEGA_SHAPES = ((8192, 64), (64, 8192))
LONG_FFT_KW = dict(n1=16, n2=16, n3=16)   # fused3's range split at 4096^2
LONG_FAMILIES = (("fused3", "fused1"), ("csa_fused", "csa_fused1"),
                 ("omegak", "omegak_fused1"))
LONG_PRECISIONS = {"matmul": ["f32"], "stockham": ["f32"]}
LONG_KARATSUBA = {"matmul": [False], "stockham": [False]}


def long_sweep(torch, ops, rand, fft_impl):
    """Phase 19's kernel sweep on one route: the spectral kernel past one
    block against its plain version (the Stockham route ``torch.equal``,
    the matmul route within TOL) at N in ``LONG_SIZES``, rows and columns,
    ragged line counts — every filter mode x fwd/inv at ``LONG_ALL_MODES``,
    fwd * FULL * inv at the others — and on the matmul route the explicit
    three-factor ``LONG_SPLITS``; each case against the complex128 oracle,
    held to ORACLE_TOL up to ``LONG_ORACLE_N`` and to ``LONG_ORACLE_TOL``
    past it. Then ``mega_staged`` on ``mega_chains()`` with a segment of
    8192 points against ``mega_plain`` and the oracle chain."""
    from repro_torch.kernels.fft4step import FILTER_MODES
    combos = [(m, f, i) for m in FILTER_MODES
              for f, i in ((True, False), (False, True), (True, True),
                           (False, False)) if m != "none" or f or i]
    jobs = []
    for n in LONG_SIZES:
        for axis in (0, 1):
            for c in (combos if n in LONG_ALL_MODES
                      else [("full", True, True)]):
                jobs.append((n, axis, c, None))
    if fft_impl == "matmul":
        for split in LONG_SPLITS:
            for axis in (0, 1):
                for c in (("shared", True, True), ("none", True, False),
                          ("full", False, True), ("outer", True, True)):
                    jobs.append((split[0] * split[1] * split[2], axis, c,
                                 split))
    out = dict(fft_impl=fft_impl, cases=0, equal_cases=0, max_rel_err=0.0,
               oracle_cases=0, max_oracle_err=0.0,
               max_oracle_err_past=0.0, launches=0)
    before = ops.SPECTRAL_LAUNCHES
    for n, axis, (mode, fwd, inv), split in jobs:
        lines, batch = (37, 2) if n <= 32768 else (3, 1)
        scene = (lines, n) if axis == 1 else (n, lines)
        xr, xi = rand(batch, *scene), rand(batch, *scene)
        filt = filter_payload(rand, mode, n, scene, lines)
        kw = dict(axis=axis, fwd=fwd, inv=inv, filter_mode=mode, block=1,
                  fft_impl=fft_impl)
        if split:
            kw.update(n1=split[0], n2=split[1], n3=split[2])
        got = ops.spectral_op(xr, xi, **filt, **kw)
        want = ops.spectral_op_plain(xr, xi, **filt, **kw)
        torch.cuda.synchronize()
        _, rel = rel_err(got, want)
        where = f"{kw} n={n} B={batch}"
        check(rel <= TOL, f"long kernel vs plain {where}: {rel:.3e}")
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        check(fft_impl == "matmul" or equal,
              f"long kernel != plain {where}: {rel:.3e}")
        out["equal_cases"] += int(equal)
        out["max_rel_err"] = max(out["max_rel_err"], rel)
        o = oracle_err(torch, got, oracle_op(
            torch, torch.complex(xr, xi), axis, fwd, inv, mode, **filt))
        tol = ORACLE_TOL if n <= LONG_ORACLE_N else LONG_ORACLE_TOL
        check(o <= tol, f"long kernel vs complex128 {where}: {o:.3e}")
        key = "max_oracle_err" if n <= LONG_ORACLE_N else \
            "max_oracle_err_past"
        out[key] = max(out[key], o)
        out["oracle_cases"] += 1
        out["cases"] += 1
        del got, want, xr, xi, filt
    out["launches"] = ops.SPECTRAL_LAUNCHES - before
    check(out["launches"] == out["cases"], "one launch a case")
    emit("long_kernel", sizes=list(LONG_SIZES),
         splits=[list(sp) for sp in LONG_SPLITS] if fft_impl == "matmul"
         else [], tol=TOL, oracle_tol=ORACLE_TOL,
         oracle_tol_past=LONG_ORACLE_TOL, oracle_n=LONG_ORACLE_N, **out)

    mega = dict(fft_impl=fft_impl, cases=0, equal_cases=0, max_rel_err=0.0,
                max_oracle_err=0.0)
    for na, nr in LONG_MEGA_SHAPES:
        x = (rand(1, na, nr), rand(1, na, nr))
        for segments in mega_chains():
            args = []
            for axis, _fwd, _inv, mode in segments:
                n, lines = (nr, na) if axis == 1 else (na, nr)
                if mode in ("shared", "shared_outer"):
                    args += [rand(n), rand(n)]
                if mode == "full":
                    args += [rand(na, nr), rand(na, nr)]
                if mode in ("outer", "shared_outer"):
                    args += [rand(lines, 2), rand(n, 2)]
            kw = dict(segments=segments, residency="staged",
                      fft_impl=fft_impl)
            before = ops.MEGA_LAUNCHES["mega_staged"]
            got = ops.mega_spectral_op(*x, *args, **kw)
            want = ops.mega_spectral_op_plain(*x, *args, **kw)
            torch.cuda.synchronize()
            check(ops.MEGA_LAUNCHES["mega_staged"] == before + 1,
                  "mega_staged: one launch")
            _, rel = rel_err(got, want)
            where = f"mega_staged {fft_impl} {segments} {na}x{nr}"
            check(rel <= TOL, f"{where} vs plain: {rel:.3e}")
            equal = all(torch.equal(g, w) for g, w in zip(got, want))
            check(fft_impl == "matmul" or equal, f"{where} != plain")
            o = oracle_err(torch, got, oracle_chain(
                torch, torch.complex(*x), segments, args))
            check(o <= ORACLE_TOL, f"{where} vs complex128: {o:.3e}")
            mega["equal_cases"] += int(equal)
            mega["max_rel_err"] = max(mega["max_rel_err"], rel)
            mega["max_oracle_err"] = max(mega["max_oracle_err"], o)
            mega["cases"] += 1
            del got, want
        del x
    emit("long_mega_kernel", shapes=[list(sh) for sh in LONG_MEGA_SHAPES],
         tol=TOL, oracle_tol=ORACLE_TOL, **mega)


# mega_staged's Stockham fused1 at 8192 x 16384 against the sum of its
# three spectral launches, timed in the same run: the same device
# functions, so no slower than those launches beyond noise
STAGED_VS_LAUNCHES = 1.15


def filter_only_time(torch, smi_line, cfg, p3, raw):
    """The long passes' streaming I/O alone: fused3's range launch as a
    filter-only op (no transform: one elementwise pass over device
    memory) on its input and filter, beside its bound (the slab read and
    written once, the filter read once)."""
    from repro_torch.core import plan as planlib
    from repro_torch.kernels import ops
    x = raw
    for s in p3.steps:
        if s.kernel_kw["axis"] == 1:
            break
        x = s.fn(x)
    xr, xi = planlib.split(x)
    kk = dict(s.kernel_kw, fwd=False, inv=False)
    fk = s.filter_kw
    got = ops.spectral_op(xr, xi, **fk, **kk)
    want = ops.spectral_op_plain(xr, xi, **fk, **kk)
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "filter-only pass != plain")
    del got, want
    nbytes = 16 * xr.numel() + sum(4 * t.numel() for t in fk.values())
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    ms = cuda_median_ms(lambda: ops.spectral_op(xr, xi, **fk, **kk),
                        queued=True)
    emit("long_filter_only", launch=s.name, fft_impl=kk["fft_impl"],
         mode=kk["filter_mode"], scene=[cfg.na, cfg.nr], ms=ms,
         bound_ms=bound, vs_bound=ms / bound, nvidia_smi=smi_line)


def kernel_spec(kk, n):
    """The ``SpectralSpec`` of a spectral op's kernel keywords on lines of
    n points."""
    from repro_torch.kernels.fft4step import SpectralSpec
    return SpectralSpec(
        n=n, fwd=kk["fwd"], inv=kk["inv"], filter_mode=kk["filter_mode"],
        axis=kk["axis"], fft_impl=kk["fft_impl"],
        precision=kk.get("precision", "f32"), n1=kk.get("n1"),
        n2=kk.get("n2"), n3=kk.get("n3"))


def step_spec(cfg, step):
    """The ``SpectralSpec`` of one spectral step of a pipeline on cfg."""
    kk = step.kernel_kw
    return kernel_spec(kk, cfg.nr if kk["axis"] == 1 else cfg.na)


def spec_passes(spec):
    """The device-memory passes of one op (1: a line of one block)."""
    from repro_torch.kernels import ops
    geom = ops.long_geometry(spec)
    return 1 if geom is None else geom.passes(spec.fwd, spec.inv)


def long_grid(torch, kernel, specs):
    """Blocks per SM and the cooperative grid of a long launch (the f32
    form's) at its largest shared memory: ``spectral_long`` for one op,
    ``mega_staged``'s long chains' instantiation for a chain's ops."""
    from repro_torch.kernels import ops
    geoms = [ops.long_geometry(sp) for sp in specs]
    smem = max((g.smem_bytes() for g in geoms if g is not None), default=0)
    per_sm = ops.long_blocks_per_sm(kernel, specs[0].fft_impl, smem)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(smem=smem, blocks_per_sm=per_sm, sms=sms,
                grid=per_sm * sms)


def long_pass_record(torch, smi_line, cfg, name, rec, specs, kernel):
    """Phase 19's pass accounting of one timed long launch (``rec``: a
    ``time_launch`` / ``time_kernel`` record): each op's device-memory
    passes, the one-pass bound (the slab read and written once, the
    filters read once), the design floor (passes x each op's one-pass
    bytes) and the MMA floor, beside the time; the grid."""
    slab = 16 * cfg.na * cfg.nr
    passes = [spec_passes(sp) for sp in specs]
    one = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    floor = (sum(passes) * slab + rec["bytes"] - slab) \
        / HBM_BYTES_PER_S * 1e3
    out = dict(launch=name, fft_impl=specs[0].fft_impl, passes=passes,
               ms=rec["ms"], one_pass_ms=one, pass_floor_ms=floor,
               mma_floor_ms=rec.get("mma_floor_ms"),
               vs_one_pass=rec["ms"] / one, vs_pass_floor=rec["ms"] / floor,
               **long_grid(torch, kernel, specs))
    emit("long_pass", nvidia_smi=smi_line, **out)
    return out


# ``--long-passes``: the libraries the long ops run from, its parts, the
# FFTConvMixer's lines at S = 4096 (stablelm-1.6b: 8192 rows of 8192
# points) and rows past a whole-line tile (the ring's rows passes)
LONG_PASS_LIBS = ("spectral", "staged_long", "spectral_long_forms")
LONG_PASS_PARTS = ("ops", "ring", "mixer", "mega")
MIXER_LINES = (8192, 8192)
RING_ROWS = (2048, 32768)


def long_op_time(torch, xr, xi, fk, kk, n):
    """One long op on the card: its device-memory passes, its time
    (queued, median of 7), the one-pass bound (the slab read and written
    once, the filter read once, over 3.35 TB/s), the pass floor (passes
    x that bound), its tiles, shared memory and ``spectral_long``'s grid
    there."""
    from repro_torch.kernels import ops
    spec = kernel_spec(kk, n)
    g = ops.long_geometry(spec)
    one = (16 * xr.numel() + sum(4 * t.numel() for t in fk.values())) \
        / HBM_BYTES_PER_S * 1e3
    passes = spec_passes(spec)
    ms = cuda_median_ms(lambda: ops.spectral_op(xr, xi, **fk, **kk),
                        queued=True)
    out = dict(fft_impl=spec.fft_impl, precision=spec.precision,
               axis=spec.axis, fwd=spec.fwd, inv=spec.inv,
               mode=spec.filter_mode, n=n, lines=xr.numel() // n,
               passes=passes, ms=ms, one_pass_ms=one,
               pass_floor_ms=passes * one, vs_one_pass=ms / one)
    if g is not None:
        out.update(digit_tiles=list(g.digit_tiles), tail_tile=g.tail_tile,
                   whole_line=g.whole_line, ring=g.ring,
                   **long_grid(torch, "spectral", [spec]))
    return out


def long_scene_ops(torch, fft_impl):
    """The 8192 x 16384 paper scene's fused3 launches on one route, each
    on its own input: (name, xr, xi, filter kw, kernel kw, n)."""
    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import build_pipeline, paper_scene, \
        paper_targets, simulate
    cfg = paper_scene(*LONG_SCENE)
    x = simulate(cfg, paper_targets(cfg))
    for s in build_pipeline(cfg, "fused3", fft_impl=fft_impl).steps:
        kk = s.kernel_kw
        yield (s.name, *planlib.split(x), s.filter_kw, kk,
               cfg.nr if kk["axis"] == 1 else cfg.na)
        x = s.fn(x)


def long_ops_part(torch, smi_line):
    """Each fused3 launch as the pipeline has it and as a fwd-only,
    inv-only, fwd * H * inv and filter-only op on the same input and
    filter, and the range launch at bs16."""
    for fft_impl in ("matmul", "stockham"):
        for name, xr, xi, fk, kk, n in long_scene_ops(torch, fft_impl):
            for tag, f, i in ((None, kk["fwd"], kk["inv"]),
                              ("fwd", True, False), ("inv", False, True),
                              ("fwd_inv", True, True),
                              ("filter_only", False, False)):
                if tag and (f, i) == (kk["fwd"], kk["inv"]):
                    continue
                emit("long_op", op=name + (f":{tag}" if tag else ""),
                     nvidia_smi=smi_line, **long_op_time(
                         torch, xr, xi, fk, dict(kk, fwd=f, inv=i), n))
            if kk["axis"] == 1 and kk["fwd"] and kk["inv"]:
                emit("long_op", op=f"{name}:bs16", nvidia_smi=smi_line,
                     **long_op_time(torch, xr, xi, fk,
                                    dict(kk, precision="bs16"), n))
        torch.cuda.empty_cache()


# long_ring_part's settings: (name, ops.LONG_RING, the record's ring flag
# cleared): the ring; the loads without it on today's tiles; and on the
# ring's tiles (halved to fit its slots), which splits the ring's cost
# into its tiles' and its own
RING_SETTINGS = (("ring", True, False), ("none", False, False),
                 ("ring_tiles", True, True))


def ring_setting(ops, ring, clear):
    """Applies one of ``RING_SETTINGS`` (the ring flag of every long
    record cleared through ``ops._long_fields`` where ``clear``); returns
    the undo."""
    fields = ops._long_fields

    def cleared(*a, **kw):
        head, f, keep = fields(*a, **kw)
        f[3] = 0
        return head, f, keep
    ops.LONG_RING = ring
    if clear:
        ops._long_fields = cleared

    def undo():
        ops.LONG_RING = False
        ops._long_fields = fields
    return undo


def ring_check(torch, smi_line, p3, raw):
    """Phase 19: fused3's first column launch with the tile passes' ring
    (``ops.LONG_RING``) bit for bit the launch without it, both timed."""
    from repro_torch.core import plan as planlib
    from repro_torch.kernels import ops
    x = raw
    for s in p3.steps:
        if s.kernel_kw["axis"] == 0:
            break
        x = s.fn(x)
    xr, xi = planlib.split(x)
    run = lambda: ops.spectral_op(xr, xi, **s.filter_kw, **s.kernel_kw)
    want = run()
    ms = cuda_median_ms(run, queued=True)
    undo = ring_setting(ops, True, False)
    try:
        got = run()
        ring_ms = cuda_median_ms(run, queued=True)
    finally:
        undo()
    torch.cuda.synchronize()
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    emit("long_ring_check", launch=s.name,
         fft_impl=s.kernel_kw["fft_impl"], equal=equal, ms=ms,
         ring_ms=ring_ms, nvidia_smi=smi_line)
    check(equal, f"{s.name}: the ring's output differs")


def long_ring_part(torch, smi_line):
    """The tile passes' asynchronous ring against their loads without it
    (``RING_SETTINGS``), in turns ring, none, ring_tiles, ring_tiles,
    none, ring on the same input: the scene's column launches one
    direction at a time and together, and rows past a whole-line tile,
    at f32 and bs16. Every output must be equal bit for bit."""
    from repro_torch.kernels import ops
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(271)
    lines, n = RING_ROWS
    rows = torch.randn(2, lines, n, generator=gen, device=dev)
    hr = torch.randn(n, generator=gen, device=dev)
    for fft_impl in ("matmul", "stockham"):
        cases = []
        for name, xr, xi, fk, kk, nn in long_scene_ops(torch, fft_impl):
            if kk["axis"] == 0:
                for f, i in ((True, False), (False, True), (True, True)):
                    cases.append((f"{name}:{'fwd' * f}{'_' * (f and i)}"
                                  f"{'inv' * i}", xr, xi, fk,
                                  dict(kk, fwd=f, inv=i), nn))
        rk = dict(fwd=True, inv=True, axis=1, filter_mode="shared",
                  fft_impl=fft_impl)
        cases.append((f"rows {lines} x {n}", rows[0], rows[1],
                       dict(hr=hr, hi=hr), rk, n))
        cases += [(f"{c[0]}:bs16", *c[1:4], dict(c[4], precision="bs16"),
                   c[5]) for c in (cases[-2], cases[-1])]
        turns = RING_SETTINGS + RING_SETTINGS[::-1]
        for name, xr, xi, fk, kk, nn in cases:
            recs = {s[0]: [] for s in RING_SETTINGS}
            outs = {}
            for setting, ring, clear in turns:
                undo = ring_setting(ops, ring, clear)
                try:
                    outs[setting] = ops.spectral_op(xr, xi, **fk, **kk)
                    recs[setting].append(
                        long_op_time(torch, xr, xi, fk, kk, nn))
                finally:
                    undo()
            equal = all(torch.equal(a, b) for o in outs.values()
                        for a, b in zip(o, outs["none"]))
            emit("long_ring", op=name, equal=equal,
                 **{f"{k}_ms": [r["ms"] for r in v]
                    for k, v in recs.items()},
                 **{k: v[0] for k, v in recs.items()},
                 nvidia_smi=smi_line)
            check(equal, f"{name} ({fft_impl}): the ring's output differs")
            del outs
        torch.cuda.empty_cache()


def long_mixer_part(torch, smi_line):
    """The FFTConvMixer's launch at S = 4096: 8192 lines of 8192 points,
    FULL filter, fwd * H * inv, on both routes."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(27)
    lines, n = MIXER_LINES
    xr = torch.randn(1, lines, n, generator=gen, device=dev)
    xi = torch.zeros_like(xr)
    fk = dict(hr=torch.randn(lines, n, generator=gen, device=dev),
              hi=torch.randn(lines, n, generator=gen, device=dev))
    for fft_impl in ("matmul", "stockham"):
        kk = dict(fwd=True, inv=True, axis=1, filter_mode="full",
                  fft_impl=fft_impl)
        emit("long_op", op="lm_mixer S=4096", nvidia_smi=smi_line,
             **long_op_time(torch, xr, xi, fk, kk, n))


def long_mega_part(torch, smi_line):
    """fused1's ``mega_staged`` at the paper scene on both routes beside
    the sum of its three launches, and each of its segments alone as a
    one-segment ``mega_staged`` chain beside its ``spectral_long``
    launch."""
    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import build_pipeline, paper_scene, \
        paper_targets, simulate
    from repro_torch.kernels import ops
    for fft_impl in ("matmul", "stockham"):
        cfg = paper_scene(*LONG_SCENE)
        raw = simulate(cfg, paper_targets(cfg))
        p3 = build_pipeline(cfg, "fused3", fft_impl=fft_impl)
        s1 = build_pipeline(cfg, "fused1", fft_impl=fft_impl).steps[0]
        kk = s1.kernel_kw
        args = [t for a in s1.seg_filter_args for t in a]
        xr, xi = planlib.split(raw)
        mega_ms = cuda_median_ms(lambda: ops.mega_spectral_op(
            xr, xi, *args, **kk), queued=True)
        launch_ms, x = [], raw
        for s in p3.steps:
            sr, si = planlib.split(x)
            launch_ms.append(cuda_median_ms(lambda: ops.spectral_op(
                sr, si, **s.filter_kw, **s.kernel_kw), queued=True))
            x = s.fn(x)
        emit("long_mega", chain="fused1", fft_impl=fft_impl, ms=mega_ms,
             launch_ms=launch_ms, launch_ms_sum=sum(launch_ms),
             ratio=mega_ms / sum(launch_ms), nvidia_smi=smi_line)
        x = raw
        for k, (seg, sa, s) in enumerate(zip(kk["segments"],
                                              s1.seg_filter_args,
                                              p3.steps)):
            sr, si = planlib.split(x)
            one = dict(kk, segments=(seg,))
            ms = cuda_median_ms(lambda: ops.mega_spectral_op(
                sr, si, *sa, **one), queued=True)
            emit("long_mega", chain=f"segment {k}", segment=list(seg),
                 fft_impl=fft_impl, ms=ms, launch_ms=launch_ms[k],
                 ratio=ms / launch_ms[k], nvidia_smi=smi_line)
            x = s.fn(x)
        del raw, x, xr, xi, args
        torch.cuda.empty_cache()


def long_passes_main(parts) -> int:
    """``--long-passes [PARTS]``: the long-line passes op by op (what
    phase 19 times a launch at a time) — builds ``LONG_PASS_LIBS`` where
    stale, prints the card's name and power limit, the long kernels'
    ptxas report where it compiled them, then the JSON lines of each part
    (``LONG_PASS_PARTS``: ``long_op``, ``long_ring``, ``long_mega``)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True, names=LONG_PASS_LIBS)
    ptxas = {k: v for log in logs.values()
             for k, v in ptxas_report(log).items()
             if "long" in k.split("/")[0]}
    emit("long_build", seconds=time.perf_counter() - t0,
         source_seconds=dict(_build.BUILD_SECONDS), ptxas=ptxas,
         nvidia_smi=smi_line)
    bad = set(parts) - set(LONG_PASS_PARTS)
    check(not bad, f"unknown parts {sorted(bad)}")
    run = dict(ops=long_ops_part, ring=long_ring_part,
               mixer=long_mixer_part, mega=long_mega_part)
    for part in parts:
        t0 = time.perf_counter()
        run[part](torch, smi_line)
        emit("long_part_seconds", part=part,
             seconds=time.perf_counter() - t0)
    return 0


def long_record(name, variant, fft_impl, launches, err, timed, scene):
    """A ``kernels`` entry of phase 19's paths: f32 alone, no Karatsuba
    (``mega_staged`` for such chains builds from ``staged_long.cu``)."""
    rec = kernel_record(name, f"{variant} {scene[0]}x{scene[1]}", fft_impl,
                        launches, err, timed,
                        source="staged_long.cu" if name == "mega_staged"
                        else None)
    rec.update(scene=list(scene), precisions=LONG_PRECISIONS,
               karatsuba_by_route=LONG_KARATSUBA)
    return rec


def long_lines_phase(torch, smi_line, cfg4096, raw4096, score4096,
                     replay_plain):
    """Phase 19: lines past one block. The kernel sweeps on both routes;
    the 8192 x 16384 paper scene through every variant on each route
    (launch counts, five targets, the plain replay, complex128 for
    fused3, fused1 == fused3, csa_fused beside the torch backend's csa),
    each launch and ``mega_staged`` call timed beside its bound, plain
    version and ``library_ms``, and the whole fused3 run; fused3 with the
    three-factor split (16, 16, 16) on the 4096^2 scene; the 4096^2 fused3
    launches timed again on both routes. Returns the ``kernels``
    records."""
    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import (build_pipeline, paper_scene,
                                      paper_targets, simulate)
    from repro_torch.kernels import ops
    dev = torch.device("cuda", 0)
    lap = part_clock(19)
    for i, fft_impl in enumerate(ops.FFT_IMPLS):
        long_sweep(torch, ops, seeded_randn(torch, dev, 190 + i), fft_impl)
    sweep_s = lap("sweep")

    cfg = paper_scene(*LONG_SCENE)
    targets = paper_targets(cfg)
    raw = simulate(cfg, targets)
    torch.cuda.synchronize()
    check(raw.shape == LONG_SCENE, "long scene shape")
    score = card_scorer(torch, cfg, targets)
    scene = [cfg.na, cfg.nr]
    base = build_pipeline(cfg, "csa")        # torch backend: the baseline
    reset_launch_counts()
    img = base.run(raw)
    torch.cuda.synchronize()
    counts, want = launch_counts()
    check(counts == want, f"csa {scene} (torch backend) launches {counts}")
    rep_base = score(img)
    check_focus("csa long", rep_base)
    emit("long_main", variant="csa", backend="torch", scene=scene,
         launches=counts, targets=rep_base)
    del img
    lap("scene and csa baseline")

    records = []
    run_ms = {}
    for fft_impl in ops.FFT_IMPLS:
        for three, one in LONG_FAMILIES:
            p3 = build_pipeline(cfg, three, fft_impl=fft_impl)
            p1 = build_pipeline(cfg, one, fft_impl=fft_impl)
            check(p1.steps[0].kernel_kw["residency"] == "staged",
                  f"{one}: staged")
            reset_launch_counts()
            img3 = p3.run(raw)
            torch.cuda.synchronize()
            counts3, want = launch_counts(spectral=3)
            check(counts3 == want, f"{three} {scene} ({fft_impl}) "
                  f"launches {counts3}")
            check(bool(torch.isfinite(img3).all()), f"{three}: non-finite")
            rep3 = score(img3)
            check_focus(f"{three} {scene} ({fft_impl})", rep3)
            img_p = replay_plain(p3, raw)
            torch.cuda.synchronize()
            dsnr_p = check_focus(f"{three} {scene} ({fft_impl}) vs plain",
                                 rep3, score(img_p))
            del img_p
            oracle = None
            if three == "fused3":
                want_o = image_oracle(torch, p3, raw)
                oracle = oracle_err(torch, (img3.real, img3.imag), want_o)
                check(oracle <= ORACLE_TOL, f"fused3 {scene} ({fft_impl}) "
                      f"vs complex128: {oracle:.3e}")
                del want_o
            dsnr_b = (check_focus(f"csa_fused {scene} ({fft_impl}) vs csa",
                                  rep3, rep_base)
                      if three == "csa_fused" else None)
            reset_launch_counts()
            img1 = p1.run(raw)
            torch.cuda.synchronize()
            counts1, want = launch_counts(mega_staged=1)
            check(counts1 == want, f"{one} {scene} ({fft_impl}) launches "
                  f"{counts1}")
            check(torch.equal(img1, img3),
                  f"{one} != {three} {scene} ({fft_impl})")
            img1_p = replay_mega_plain(p1.steps[0], raw)
            torch.cuda.synchronize()
            err1, rel1 = rel_err((img1.real, img1.imag),
                                 (img1_p.real, img1_p.imag))
            check(rel1 <= TOL, f"{one} {scene} vs plain: {rel1:.3e}")
            # img1 == img3: its score is rep3
            dsnr_1 = check_focus(f"{one} {scene} ({fft_impl}) vs plain",
                                 rep3, score(img1_p))
            del img1, img1_p, img3
            launch_err = 0.0
            timed = []
            for s, x in step_inputs(p3, raw)[0]:
                xr, xi = planlib.split(x)
                got = ops.spectral_op(xr, xi, **s.filter_kw, **s.kernel_kw)
                want_p = ops.spectral_op_plain(xr, xi, **s.filter_kw,
                                               **s.kernel_kw)
                torch.cuda.synchronize()
                err, rel = rel_err(got, want_p)
                check(rel <= TOL and (fft_impl == "matmul" or all(
                    torch.equal(g, w) for g, w in zip(got, want_p))),
                      f"{three} {scene} launch {s.name} ({fft_impl}): "
                      f"{rel:.3e}")
                launch_err = max(launch_err, err)
                del got, want_p
                rec = time_spectral_launch(smi_line, s, xr, xi, x,
                                           variant=f"{three} {scene}",
                                           plain_timing=PLAIN_ONCE)
                timed.append(rec)
            t1 = time_mega_kernel(torch, smi_line, "mega_staged",
                                  p1.steps[0], raw, cfg, variant=one,
                                  plain_timing=PLAIN_ONCE)
            specs = [step_spec(cfg, s) for s in p3.steps]
            for s, sp, rec in zip(p3.steps, specs, timed):
                long_pass_record(torch, smi_line, cfg, f"{three} {s.name}",
                                 rec, [sp], "spectral")
            long_pass_record(torch, smi_line, cfg, f"{one} mega_staged",
                             t1, specs, "mega_staged")
            launch_sum = sum(r["ms"] for r in timed)
            emit("long_staged_vs_launches", variant=one, twin=three,
                 fft_impl=fft_impl, ms=t1["ms"], launch_ms_sum=launch_sum,
                 ratio=t1["ms"] / launch_sum, limit=STAGED_VS_LAUNCHES,
                 nvidia_smi=smi_line)
            if fft_impl == "stockham" and one == "fused1":
                check(t1["ms"] <= STAGED_VS_LAUNCHES * launch_sum,
                      f"mega_staged Stockham fused1 {scene}: {t1['ms']:.4f}"
                      f" ms over {STAGED_VS_LAUNCHES} x its three "
                      f"launches' {launch_sum:.4f} ms")
            if three == "fused3":
                filter_only_time(torch, smi_line, cfg, p3, raw)
                ring_check(torch, smi_line, p3, raw)
            if three == "fused3":
                run_ms[fft_impl] = cuda_median_ms(lambda: p3.run(raw))
                emit("long_time_run", variant="fused3", fft_impl=fft_impl,
                     scene=scene, ms=run_ms[fft_impl],
                     launch_ms_sum=sum(r["ms"] for r in timed),
                     launch_bound_ms_sum=sum(r["bound_ms"] for r in timed),
                     launch_plain_ms_sum=sum(r["plain_ms"] for r in timed),
                     launch_library_ms_sum=sum(r["library_ms"]
                                               for r in timed),
                     nvidia_smi=smi_line)
            emit("long_main", variant=three, twin=one, fft_impl=fft_impl,
                 scene=scene, launches=counts3, twin_launches=counts1,
                 targets=rep3, snr_delta_db_vs_plain=dsnr_p,
                 twin_snr_delta_db_vs_plain=dsnr_1,
                 snr_delta_db_vs_csa=dsnr_b, oracle_rel_err=oracle,
                 twin_equal=True, twin_rel_err_vs_plain=rel1,
                 max_abs_err_launches=launch_err,
                 passes=[spec_passes(step_spec(cfg, s)) for s in p3.steps])
            records.append(long_record("spectral", three, fft_impl,
                                       counts3["spectral"], launch_err,
                                       timed, scene))
            records.append(long_record("mega_staged", one, fft_impl,
                                       counts1["mega_staged"], err1, [t1],
                                       scene))
        lap(f"variants {fft_impl}")
    del raw
    torch.cuda.empty_cache()

    # three factors on the main path: fused3 at 4096^2, range (16, 16, 16)
    split = LONG_FFT_KW
    p = build_pipeline(cfg4096, "fused3", fft_kw=split)
    check(any(s.kernel_kw.get("n3") == split["n3"] for s in p.steps),
          "fused3 fft_kw: a three-factor launch")
    reset_launch_counts()
    img = p.run(raw4096)
    torch.cuda.synchronize()
    counts, want = launch_counts(spectral=3)
    check(counts == want, f"fused3 (16, 16, 16) launches {counts}")
    rep = score4096(img)
    check_focus("fused3 (16, 16, 16)", rep)
    want_o = image_oracle(torch, p, raw4096)
    o3 = oracle_err(torch, (img.real, img.imag), want_o)
    check(o3 <= ORACLE_TOL, f"fused3 (16, 16, 16) vs complex128: {o3:.3e}")
    del img, want_o
    timed3 = []
    err3 = 0.0
    for s, x in step_inputs(p, raw4096)[0]:
        xr, xi = planlib.split(x)
        got = ops.spectral_op(xr, xi, **s.filter_kw, **s.kernel_kw)
        want_p = ops.spectral_op_plain(xr, xi, **s.filter_kw, **s.kernel_kw)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want_p)
        check(rel <= TOL, f"fused3 (16, 16, 16) {s.name}: {rel:.3e}")
        err3 = max(err3, err)
        timed3.append(time_spectral_launch(smi_line, s, xr, xi, x,
                                           variant="fused3 (16,16,16)"))
    emit("long_main", variant="fused3", fft_kw=split,
         scene=[cfg4096.na, cfg4096.nr], launches=counts, targets=rep,
         oracle_rel_err=o3, max_abs_err_launches=err3)
    records.append(long_record(
        "spectral", "fused3 n1,n2,n3=" + ",".join(map(str, split.values())),
        "matmul", counts["spectral"], err3, timed3,
        [cfg4096.na, cfg4096.nr]))
    lap("three factors at 4096^2")

    # the 4096^2 fused3 launches again on both routes: the N <= 4096 code
    sums = {}
    for fft_impl in ops.FFT_IMPLS:
        p = build_pipeline(cfg4096, "fused3", fft_impl=fft_impl)
        timed = [time_spectral_launch(smi_line, s, *planlib.split(x)[:2], x)
                 for s, x in step_inputs(p, raw4096)[0]]
        sums[fft_impl] = {k: sum(r[k] for r in timed)
                          for k in ("ms", "plain_ms", "bound_ms",
                                    "library_ms")}
    emit("long_time_4096", scene=[cfg4096.na, cfg4096.nr], sums=sums,
         long_fused3_run_ms=run_ms, sweep_seconds=sweep_s,
         nvidia_smi=smi_line)
    lap("4096^2 launches")
    return records


LONG_FORM_SIZES = (8192, 16384, 2 ** 21)        # phase 20's sweep
LONG_FORM_SPLITS = ((32, 16, 16), (16, 16, 16))
# the forms past one block besides f32: (precision, karatsuba) by route
# (the Stockham route has no matrix operand: bf16 and f16 are its f32
# passes, Karatsuba changes nothing)
LONG_FORMS = {"matmul": (("bf16", False), ("f16", False), ("bs16", False),
                         ("f32", True), ("bf16", True), ("f16", True),
                         ("bs16", True)),
              "stockham": (("bf16", False), ("f16", False), ("bs16", False))}
LONG_FORM_SCENE_PRECISIONS = ("bs16", "bf16")
# the forms timed at 8192 x 16384, beside phase 19's f32 rows
LONG_FORM_TIMED = {"matmul": (("bf16", False), ("f16", False),
                              ("bs16", False), ("f32", True),
                              ("bs16", True)),
                   "stockham": (("bs16", False),)}
LONG_FORM_GATE_N = 8192          # the SNR gate's scene, n x n
LONG_FORM_REQUESTS = 3           # the service's default-tier requests


def finite_err(torch, got, want):
    """(max abs error, over max|want|) on the points where both are
    finite, and whether the non-finite masks are equal."""
    masks = all(torch.equal(torch.isfinite(g), torch.isfinite(w))
                for g, w in zip(got, want))
    fin = [torch.isfinite(g) & torch.isfinite(w) for g, w in zip(got, want)]
    scale = max((float(w[f].abs().max()) if bool(f.any()) else 0.0)
                for w, f in zip(want, fin))
    err = max((float((g - w)[f].abs().max()) if bool(f.any()) else 0.0)
              for g, w, f in zip(got, want, fin))
    return err, err / max(scale, 1e-30), masks


def long_form_cases(n, fft_impl):
    """(axis, split, (mode, fwd, inv)) of phase 20's sweep at N = n: every
    filter mode and direction at 8192, both axes; fwd * shared * inv, fwd
    and FULL * inv at 16384 and 2^21; on the matmul route the splits
    (32, 16, 16) and (16, 16, 16) likewise."""
    from repro_torch.kernels.fft4step import FILTER_MODES
    few = (("shared", True, True), ("none", True, False),
           ("full", False, True))
    every = [(m, True, True) for m in FILTER_MODES] + \
        [("none", True, False), ("outer", False, True), ("full", False, False)]
    jobs = [(axis, None, c) for axis in (0, 1)
            for c in (every if n == 8192 else few)]
    if fft_impl == "matmul" and n == 8192:
        jobs += [(axis, sp, c) for sp in LONG_FORM_SPLITS for axis in (0, 1)
                 for c in (("shared_outer", True, True),
                           ("none", True, False), ("full", False, True))]
    return jobs


def long_form_cut(torch):
    """Phase 20.0: the compiler's residency cut on the card. A 128^2 scene
    with the range split (8, 4, 4) and a 2 x 8192 scene (random echoes:
    its geometry does not validate) fit one block's shared memory, and
    ``mega_resident`` runs their long lines on its slab: with no residency
    pinned fused1 compiles to ``vmem`` and runs in one ``mega_resident``
    launch, bit for bit fused3's image and a pinned ``staged`` fused1's
    (one ``mega_staged`` launch)."""
    import dataclasses

    from repro_torch.core.sar import build_pipeline, paper_targets, simulate
    from repro_torch.core.sar.geometry import test_scene
    out = []
    small = test_scene(128)
    for cfg, kw in ((small, dict(fft_kw=dict(n1=8, n2=4, n3=4))),
                    (dataclasses.replace(small, na=2, nr=8192), {})):
        if kw:
            raw = simulate(cfg, paper_targets(cfg))
        else:
            rand = seeded_randn(torch, torch.device("cuda", 0), 7)
            raw = torch.complex(rand(cfg.na, cfg.nr), rand(cfg.na, cfg.nr))
        p1 = build_pipeline(cfg, "fused1", **kw)
        residency = p1.steps[0].kernel_kw["residency"]
        check(residency == "vmem", f"fused1 {cfg.na}x{cfg.nr} {kw}: "
              f"{residency}")
        three = build_pipeline(cfg, "fused3", **kw).run(raw)
        reset_launch_counts()
        one = p1.run(raw)
        torch.cuda.synchronize()
        counts, want = launch_counts(mega_resident=1)
        check(counts == want, f"fused1 {cfg.na}x{cfg.nr}: {counts}")
        check(bit_equal(torch, one, three),
              f"fused1 != fused3 at {cfg.na}x{cfg.nr} {kw}")
        reset_launch_counts()
        staged = build_pipeline(cfg, "fused1", residency="staged",
                                **kw).run(raw)
        torch.cuda.synchronize()
        staged_counts, want = launch_counts(mega_staged=1)
        check(staged_counts == want,
              f"pinned staged {cfg.na}x{cfg.nr}: {staged_counts}")
        check(bit_equal(torch, one, staged),
              f"resident != pinned staged at {cfg.na}x{cfg.nr} {kw}")
        out.append(dict(scene=[cfg.na, cfg.nr], fft_kw=kw.get("fft_kw"),
                        residency=residency, launches=counts,
                        fused1_equals_fused3=True,
                        pinned_staged_launches=staged_counts,
                        fused1_equals_pinned_staged=True))
    emit("long_form_cut", scenes=out)
    return out


def long_form_sweep(torch, ops, rand, fft_impl):
    """Phase 20.1: the spectral kernel past one block at each form of
    ``LONG_FORMS[fft_impl]``, against its plain version — the matmul
    route within ``FORM_TOL`` where both are finite, with equal non-finite
    masks; the Stockham route ``torch.equal`` (bs16 with odd lines
    subnormal) — one launch a case; f32 with Karatsuba also against
    complex128 (ORACLE_TOL up to ``LONG_ORACLE_N``, ``LONG_ORACLE_TOL``
    past it, as phase 19's f32 sweep). Then ``mega_staged`` on
    ``mega_chains()`` with a segment of 8192 points at each form against
    ``mega_plain``."""
    out = {}
    for precision, kara in LONG_FORMS[fft_impl]:
        t0 = time.perf_counter()
        rec = dict(cases=0, equal_cases=0, max_rel_err=0.0, nonfinite_cases=0,
                   oracle_cases=0, max_oracle_err=0.0, launches=0,
                   mega_cases=0, mega_equal_cases=0, mega_max_rel_err=0.0)
        tol = FORM_TOL[precision]
        before = ops.SPECTRAL_LAUNCHES
        for n in LONG_FORM_SIZES:
            for axis, split, (mode, fwd, inv) in long_form_cases(n, fft_impl):
                nn = n if split is None else split[0] * split[1] * split[2]
                lines, batch = (13, 2) if nn <= 16384 else (3, 1)
                scene = (lines, nn) if axis == 1 else (nn, lines)
                xr, xi = rand(batch, *scene), rand(batch, *scene)
                if precision == "bs16":
                    xr, xi = subnormal_lines(torch, (xr, xi), axis)
                filt = filter_payload(rand, mode, nn, scene, lines)
                kw = dict(axis=axis, fwd=fwd, inv=inv, filter_mode=mode,
                          block=1, fft_impl=fft_impl, precision=precision,
                          karatsuba=kara)
                if split:
                    kw.update(n1=split[0], n2=split[1], n3=split[2])
                got = ops.spectral_op(xr, xi, **filt, **kw)
                want = ops.spectral_op_plain(xr, xi, **filt, **kw)
                torch.cuda.synchronize()
                where = f"{kw} n={nn} B={batch}"
                _, rel, masks = finite_err(torch, got, want)
                check(masks, f"long form vs plain {where}: non-finite "
                      f"masks differ")
                equal = all(torch.equal(g, w) for g, w in zip(got, want))
                check(equal if fft_impl == "stockham" else rel <= tol,
                      f"long form vs plain {where}: {rel:.3e}")
                rec["nonfinite_cases"] += int(not all(
                    bool(torch.isfinite(w).all()) for w in want))
                rec["equal_cases"] += int(equal)
                rec["max_rel_err"] = max(rec["max_rel_err"], rel)
                if precision == "f32":
                    o = oracle_err(torch, got, oracle_op(
                        torch, torch.complex(xr, xi), axis, fwd, inv, mode,
                        **filt))
                    otol = ORACLE_TOL if nn <= LONG_ORACLE_N else \
                        LONG_ORACLE_TOL
                    check(o <= otol, f"long form vs complex128 {where}: "
                          f"{o:.3e}")
                    rec["max_oracle_err"] = max(rec["max_oracle_err"], o)
                    rec["oracle_cases"] += 1
                rec["cases"] += 1
                del got, want, xr, xi, filt
        rec["launches"] = ops.SPECTRAL_LAUNCHES - before
        check(rec["launches"] == rec["cases"], "one launch a case")
        for na, nr in LONG_MEGA_SHAPES:
            x = (rand(1, na, nr), rand(1, na, nr))
            if precision == "bs16":
                x = subnormal_lines(torch, x, 1)
            for segments in mega_chains():
                args = []
                for axis, _fwd, _inv, mode in segments:
                    n, lines = (nr, na) if axis == 1 else (na, nr)
                    if mode in ("shared", "shared_outer"):
                        args += [rand(n), rand(n)]
                    if mode == "full":
                        args += [rand(na, nr), rand(na, nr)]
                    if mode in ("outer", "shared_outer"):
                        args += [rand(lines, 2), rand(n, 2)]
                kw = dict(segments=segments, residency="staged",
                          fft_impl=fft_impl, precision=precision,
                          karatsuba=kara)
                b = ops.MEGA_LAUNCHES["mega_staged"]
                got = ops.mega_spectral_op(*x, *args, **kw)
                want = ops.mega_spectral_op_plain(*x, *args, **kw)
                torch.cuda.synchronize()
                where = f"mega_staged {fft_impl} {precision} K={kara} " \
                    f"{segments} {na}x{nr}"
                check(ops.MEGA_LAUNCHES["mega_staged"] == b + 1,
                      f"{where}: one launch")
                _, rel, masks = finite_err(torch, got, want)
                check(masks, f"{where}: non-finite masks differ")
                equal = all(torch.equal(g, w) for g, w in zip(got, want))
                check(equal if fft_impl == "stockham" else rel <= tol,
                      f"{where} vs plain: {rel:.3e}")
                rec["mega_equal_cases"] += int(equal)
                rec["mega_max_rel_err"] = max(rec["mega_max_rel_err"], rel)
                rec["mega_cases"] += 1
                del got, want
            del x
        key = precision + ("+K" if kara else "")
        out[key] = rec
        emit("long_form_kernel", fft_impl=fft_impl, precision=precision,
             karatsuba=kara, tol=tol, sizes=list(LONG_FORM_SIZES),
             splits=[list(s) for s in LONG_FORM_SPLITS]
             if fft_impl == "matmul" else [],
             mega_shapes=[list(s) for s in LONG_MEGA_SHAPES],
             seconds=time.perf_counter() - t0, **rec)
    return out


def long_form_scene(torch, smi_line, cfg, raw, score, replay_plain):
    """Phase 20.2: the 8192 x 16384 scene at each of
    ``LONG_FORM_SCENE_PRECISIONS`` through fused3 / fused1, csa_fused /
    csa_fused1 and omegak / omegak_fused1 on both routes: 3 spectral
    launches and 1 ``mega_staged``, every ``*fused1`` bit for bit equal to
    its three launches, the non-finite points those of the plain replay,
    and where the image is finite the five targets at their pixels within
    0.1 dB of the plain replay. Returns {(fft_impl, precision, variant):
    (launches, max abs error against the plain replay, finite)}."""
    from repro_torch.core.sar import build_pipeline
    from repro_torch.kernels import ops
    out = {}
    for fft_impl in ops.FFT_IMPLS:
        for precision in LONG_FORM_SCENE_PRECISIONS:
            for three, one in LONG_FAMILIES:
                kw = dict(fft_impl=fft_impl, precision=precision)
                p3 = build_pipeline(cfg, three, **kw)
                p1 = build_pipeline(cfg, one, **kw)
                check(p1.steps[0].kernel_kw["residency"] == "staged",
                      f"{one}: staged")
                reset_launch_counts()
                img3 = p3.run(raw)
                torch.cuda.synchronize()
                c3, want = launch_counts(spectral=3)
                check(c3 == want, f"{three} {precision} ({fft_impl}): {c3}")
                reset_launch_counts()
                img1 = p1.run(raw)
                torch.cuda.synchronize()
                c1, want = launch_counts(mega_staged=1)
                check(c1 == want, f"{one} {precision} ({fft_impl}): {c1}")
                check(bit_equal(torch, img1, img3),
                      f"{one} != {three} at {precision} ({fft_impl})")
                del img1
                plain = replay_plain(p3, raw)
                torch.cuda.synchronize()
                fin = torch.isfinite(plain)
                check(torch.equal(torch.isfinite(img3), fin),
                      f"{three} {precision} ({fft_impl}): non-finite points "
                      f"differ from the plain replay's")
                finite = bool(fin.all())
                err = rel = 0.0
                if bool(fin.any()):
                    g, w = img3[fin], plain[fin]
                    err, rel = rel_err((g.real, g.imag), (w.real, w.imag))
                    del g, w
                check(rel <= FORM_TOL[precision],
                      f"{three} {precision} ({fft_impl}) vs plain: {rel:.3e}")
                rec = dict(variant=three, twin=one, fft_impl=fft_impl,
                           precision=precision, scene=[cfg.na, cfg.nr],
                           launches=c3, twin_launches=c1, twin_equal=True,
                           finite=finite, rel_err_vs_plain=rel,
                           max_abs_err_vs_plain=err)
                if finite:
                    rep = score(img3)
                    rec.update(targets=rep, snr_delta_db_vs_plain=check_focus(
                        f"{three} {precision} ({fft_impl}) vs plain", rep,
                        score(plain)))
                else:
                    rec.update(nonfinite_points=int((~fin).sum()))
                emit("long_form_main", **rec)
                out[(fft_impl, precision, three)] = (c3, c1, err, finite)
                del img3, plain, fin
    return out


def long_form_service(torch, smi_line, cfg, raw):
    """Phase 20.3: a ``FocusService`` at its defaults (the bs16 tier,
    fused3, the fused1 twin) serving ``LONG_FORM_REQUESTS`` requests for
    the 8192 x 16384 scene that name no precision: the tier and route
    that served them (a non-finite bs16 image is the sentinel's to catch
    and the tier fallback's to serve at f32), the gate's dB, the launches
    of one request, the host-clock p50, and the reply equal to the
    pipeline of that tier."""
    import asyncio

    import numpy as np
    from repro_torch.core.sar import build_pipeline
    from repro_torch.service import FocusService, ServiceConfig
    raw_host = raw.cpu().numpy()

    async def main_service():
        svc = FocusService(ServiceConfig(), device=None)
        await svc.start()
        await svc._ensure_gate_measured("bs16")
        imgs, ms, counts = [], [], []
        for _ in range(LONG_FORM_REQUESTS):
            reset_launch_counts()
            t0 = time.perf_counter()
            imgs.append(await svc.focus(raw_host, cfg))
            ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            counts.append(launch_counts()[0])
        snap = svc.metrics.snapshot()
        await svc.stop()
        return svc, imgs, ms, counts, snap

    svc, imgs, ms, counts, snap = asyncio.run(main_service())
    deviation = svc._gate_cache["bs16"]
    fell = snap["tier_fallbacks"]
    tier = "bs16" if fell == 0 else "f32"
    routes = dict(svc.backend.fallbacks)
    route = "fused3" if not routes else f"fallbacks {routes}"
    want = build_pipeline(cfg, "fused3", precision=tier).run(raw)
    check(np.array_equal(imgs[0], want.cpu().numpy()),
          f"served image != fused3 at {tier}")
    check(all(bool(np.isfinite(i).all()) for i in imgs),
          "served a non-finite image")
    rec = dict(scene=[cfg.na, cfg.nr], requests=LONG_FORM_REQUESTS,
               served_tier=tier, tier_fallbacks=fell, route=route,
               gate_snr_delta_db=deviation, gate_n=256,
               launches=counts, p50_ms=percentiles(ms)["p50_ms"],
               ms=ms, corrupted=snap.get("corrupted"), nvidia_smi=smi_line)
    emit("long_form_service", **rec)
    return rec


def long_form_tuning(torch, smi_line):
    """Phase 20.4: the SNR gate at n = ``LONG_FORM_GATE_N`` for bf16, f16
    and bs16 on both routes (``inf`` where the image is not finite), and
    ``search_kernel`` at N = 8192 over f32, bf16 and bs16 with its cache
    in a temporary directory: timed / space, the winner and whether its
    operands are narrow."""
    import tempfile
    from repro_torch import tuning
    from repro_torch.kernels import ops
    from repro_torch.tuning import quality
    gates = {}
    t0 = time.perf_counter()
    for fft_impl in ops.FFT_IMPLS:
        for precision in ("bf16", "f16", "bs16"):
            d = quality.precision_snr_deviation(
                precision, n=LONG_FORM_GATE_N, fft_impl=fft_impl)
            gates[f"{fft_impl}:{precision}"] = None if d == float("inf") \
                else d
    gate_s = time.perf_counter() - t0
    emit("long_form_gate", n=LONG_FORM_GATE_N, snr_delta_db=gates,
         seconds=gate_s, nvidia_smi=smi_line)
    outer = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
            tmp, "autotune_cache.json")
        tuning.clear_memory_cache()
        found = {}

        def log(what, t, r):
            if isinstance(what, str):
                found[what[5:]] = dict(
                    snr_delta_db=t if t != float("inf") else None,
                    admitted=r)

        t0 = time.perf_counter()
        key = tuning.TuneKey.kernel(8192, lines=16)
        space = tuning.candidates(8192, precisions=("f32", "bf16", "bs16"))
        narrow_space = sum(1 for c in space
                           if (c.precision or "f32") != "f32")
        check(narrow_space > 0, "no narrow config at 8192")
        res = tuning.search_kernel(key, precisions=("f32", "bf16", "bs16"),
                                   log=log)
        search_s = time.perf_counter() - t0
        check(all(t is not None for _, t in res.trace),
              "search_kernel candidates raised at launch")
        timed_narrow = len({json.dumps(c.to_dict(), sort_keys=True)
                            for c, _ in res.trace
                            if (c.precision or "f32") != "f32"})
        rec = dict(n=8192, space=res.space, narrow_in_space=narrow_space,
                   timed=res.measured, timed_narrow=timed_narrow,
                   winner=res.config.to_dict(),
                   winner_narrow=(res.config.precision or "f32") != "f32",
                   gates=found, seconds=search_s, nvidia_smi=smi_line)
        emit("long_form_search", **rec)
    if outer is None:
        os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE", None)
    else:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = outer
    tuning.clear_memory_cache()
    return gates, rec


def long_form_record(name, variant, fft_impl, launches, err, timed, scene):
    """A ``kernels`` entry of phase 20's paths (the forms' libraries)."""
    rec = kernel_record(name, f"{variant} {scene[0]}x{scene[1]}", fft_impl,
                        launches, err, timed,
                        source="mega_long_forms.cu" if name == "mega_staged"
                        else "spectral_long_forms.cu")
    rec.update(scene=list(scene))
    return rec


def long_form_times(torch, smi_line, cfg, raw):
    """Phase 20.5: each form of ``LONG_FORM_TIMED`` at 8192 x 16384: fused3
    (3 launches) and fused1 (one ``mega_staged``, bit for bit equal) run
    with the counts reset, each launch held to its plain version, then
    timed queued — Σ fused3 and ``mega_staged`` beside their plain
    versions, ``library_ms`` and bounds. Returns the ``kernels``
    records."""
    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import build_pipeline
    from repro_torch.kernels import ops
    records = []
    for fft_impl, forms in LONG_FORM_TIMED.items():
        for precision, kara in forms:
            kw = form_kw(precision, kara)
            kw["fft_impl"] = fft_impl
            p3 = build_pipeline(cfg, "fused3", **kw)
            p1 = build_pipeline(cfg, "fused1", **kw)
            reset_launch_counts()
            img3 = p3.run(raw)
            torch.cuda.synchronize()
            c3, _ = launch_counts(spectral=3)
            reset_launch_counts()
            img1 = p1.run(raw)
            torch.cuda.synchronize()
            c1, _ = launch_counts(mega_staged=1)
            check(c3["spectral"] == 3 and c1["mega_staged"] == 1,
                  f"timed form {precision} K={kara}: {c3} {c1}")
            check(bit_equal(torch, img1, img3),
                  f"fused1 != fused3 at {precision} K={kara} ({fft_impl})")
            del img1, img3
            timed, err = [], 0.0
            for s, x in step_inputs(p3, raw)[0]:
                xr, xi = planlib.split(x)
                got = ops.spectral_op(xr, xi, **s.filter_kw, **s.kernel_kw)
                want = ops.spectral_op_plain(xr, xi, **s.filter_kw,
                                             **s.kernel_kw)
                torch.cuda.synchronize()
                e, rel, masks = finite_err(torch, got, want)
                check(masks and (rel <= FORM_TOL[precision] if fft_impl ==
                                 "matmul" else all(torch.equal(g, w) for g, w
                                                   in zip(got, want))),
                      f"timed launch {s.name} {precision} K={kara}: {rel}")
                err = max(err, e)
                del got, want
                timed.append(time_spectral_launch(
                    smi_line, s, xr, xi, x,
                    variant=f"fused3 {cfg.na}x{cfg.nr} {precision}"
                    f"{'+K' if kara else ''}", plain_timing=PLAIN_ONCE))
            t1 = time_mega_kernel(torch, smi_line, "mega_staged", p1.steps[0],
                                  raw, cfg, variant="fused1",
                                  plain_timing=PLAIN_ONCE)
            scene = [cfg.na, cfg.nr]
            variant = f"fused3 {precision}{'+K' if kara else ''}"
            emit("long_form_time", fft_impl=fft_impl, precision=precision,
                 karatsuba=kara, scene=scene,
                 fused3_ms=sum(r["ms"] for r in timed),
                 fused3_plain_ms=sum(r["plain_ms"] for r in timed),
                 fused3_library_ms=sum(r["library_ms"] for r in timed),
                 fused3_bound_ms=sum(r["bound_ms"] for r in timed),
                 mega_staged_ms=t1["ms"], mega_staged_plain_ms=t1["plain_ms"],
                 mega_staged_library_ms=t1["library_ms"],
                 mega_staged_bound_ms=t1["bound_ms"], nvidia_smi=smi_line)
            records.append(long_form_record("spectral", variant, fft_impl,
                                            c3["spectral"], err, timed,
                                            scene))
            records.append(long_form_record(
                "mega_staged", variant.replace("fused3", "fused1"), fft_impl,
                c1["mega_staged"], err, [t1], scene))
    return records


def long_forms_phase(torch, smi_line, replay_plain):
    """Phase 20: every precision past one block. The residency cut for
    such lines (20.0); the kernel sweeps of each form on both routes
    (20.1); the 8192 x 16384 scene at bs16 and
    bf16 through every variant on both routes (20.2); a default-tier
    service request for that scene (20.3); the SNR gate at 8192^2 and
    ``search_kernel`` at N = 8192 (20.4); each form's times there (20.5).
    Returns the ``kernels`` records."""
    from repro_torch.core.sar import paper_scene, paper_targets, simulate
    from repro_torch.kernels import ops
    dev = torch.device("cuda", 0)
    lap = part_clock(20)
    long_form_cut(torch)
    lap("cut")
    t0 = time.perf_counter()
    for i, fft_impl in enumerate(ops.FFT_IMPLS):
        long_form_sweep(torch, ops, seeded_randn(torch, dev, 200 + i),
                        fft_impl)
    sweep_s = lap("sweep")
    cfg = paper_scene(*LONG_SCENE)
    targets = paper_targets(cfg)
    raw = simulate(cfg, targets)
    torch.cuda.synchronize()
    score = card_scorer(torch, cfg, targets)
    lap("simulate")
    long_form_scene(torch, smi_line, cfg, raw, score, replay_plain)
    scene_s = lap("scene")
    long_form_service(torch, smi_line, cfg, raw)
    service_s = lap("service")
    long_form_tuning(torch, smi_line)
    tuning_s = lap("tuning")
    records = long_form_times(torch, smi_line, cfg, raw)
    emit("long_form_seconds", sweep=sweep_s, scene=scene_s,
         service=service_s, tuning=tuning_s, times=lap("times"))
    del raw
    torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------------------
# Phase 21: mega_resident past one block
# ---------------------------------------------------------------------------

# (batch, na, nr, batch_block, range split): lines of 8192 and 16384
# points on either axis, a three-factor split, batch_block scenes a block
RESIDENT_LONG = ((1, 2, 8192, None, None), (1, 8192, 2, None, None),
                 (1, 1, 16384, None, None), (1, 16384, 1, None, None),
                 (1, 128, 128, None, (8, 4, 4)), (4, 64, 64, 2, None),
                 (2, 2, 8192, None, None), (2, 1, 8192, 2, None))
# fused1's chain and one with one-direction segments: every filter mode
# across them (tests/test_torch_cuda.py holds the same cases)
RESIDENT_CHAINS = (((0, True, False, "none"), (1, True, True, "shared_outer"),
                    (0, False, True, "outer")),
                   ((1, True, False, "outer"), (0, True, True, "full"),
                    (1, False, True, "none")))
# every form mega_resident takes past one block, by route
RESIDENT_FORMS = {r: (("f32", False),) + LONG_FORMS[r] for r in LONG_FORMS}
# phase 21.2's batches, one scene a block: (name, scene, range split, route)
RESIDENT_TIMED = (("2x8192", (2, 8192), None, "matmul"),
                  ("2x8192", (2, 8192), None, "stockham"),
                  ("128^2 (8,4,4)", (128, 128), dict(n1=8, n2=4, n3=4),
                   "matmul"))


def resident_chains(na, nr, fft_impl):
    """RESIDENT_CHAINS; on the Stockham route, which transforms no 1-point
    line (nor does its plain version), a 1-point axis only filtered."""
    out = []
    for chain in RESIDENT_CHAINS:
        if fft_impl == "stockham":
            chain = tuple(
                (a, False, False, m if m != "none" else "full")
                if (nr if a == 1 else na) == 1 else (a, f, i, m)
                for a, f, i, m in chain)
        out.append(chain)
    return out


def chain_payload(rand, segments, na, nr, rank=2):
    """Each segment's filter operands in scene coordinates."""
    args = []
    for axis, _fwd, _inv, mode in segments:
        n, lines = (nr, na) if axis == 1 else (na, nr)
        if mode in ("shared", "shared_outer"):
            args += [rand(n), rand(n)]
        if mode == "full":
            args += [rand(na, nr), rand(na, nr)]
        if mode in ("outer", "shared_outer"):
            args += [0.1 * rand(lines, rank), rand(n, rank)]
    return args


def chain_launches(ops, x, segments, args, **kw):
    """The chain as one spectral launch a segment (fused3's form)."""
    it = iter(args)
    y = x
    for axis, fwd, inv, mode in segments:
        filt = {}
        if mode in ("shared", "full", "shared_outer"):
            filt.update(hr=next(it), hi=next(it))
        if mode in ("outer", "shared_outer"):
            filt.update(u=next(it), v=next(it))
        # the split is the range axis's (fft_kw's); a filter-only launch
        # has no route (the spectral launcher's Stockham check refuses a
        # 1-point line it would not transform)
        seg = {k: v for k, v in kw.items()
               if axis == 1 or k not in ("n1", "n2", "n3")}
        if not (fwd or inv):
            seg["fft_impl"] = "matmul"
        y = ops.spectral_op(*y, **filt, axis=axis, fwd=fwd, inv=inv,
                            filter_mode=mode, **seg)
    return y


def split_bit_equal(torch, a, b):
    """Split (re, im) results equal bit for bit, NaN payloads included."""
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(a, b))


def resident_long_sweep(torch, ops, rand, fft_impl):
    """Phase 21.1: ``mega_resident`` past one block at every form of
    ``RESIDENT_FORMS[fft_impl]`` over ``RESIDENT_LONG`` x the chains: one
    launch a case, bit for bit ``mega_staged``, the chain's spectral
    launches and (batch_block > 1) the one-scene blocks; against the plain
    version ``torch.equal`` on the Stockham route, within ``FORM_TOL`` on
    the matmul route (equal non-finite masks); f32 against complex128
    (``ORACLE_TOL``)."""
    out = dict(cases=0, staged_equal=0, launches_equal=0, batch_block_equal=0,
               max_rel_err={}, oracle_cases=0, max_oracle_err=0.0)
    for precision, kara in RESIDENT_FORMS[fft_impl]:
        tag = precision + ("+K" if kara else "")
        kw = dict(fft_impl=fft_impl, precision=precision, karatsuba=kara)
        for batch, na, nr, bb, split in RESIDENT_LONG:
            ckw = dict(kw, **dict(zip(("n1", "n2", "n3"), split or ())))
            for segs in resident_chains(na, nr, fft_impl):
                x = (rand(batch, na, nr), rand(batch, na, nr))
                args = chain_payload(rand, segs, na, nr)
                where = f"{tag} ({fft_impl}) {batch}x{na}x{nr} bb={bb} {segs}"
                reset_launch_counts()
                got = ops.mega_spectral_op(*x, *args, segments=segs,
                                           residency="vmem", batch_block=bb,
                                           **ckw)
                torch.cuda.synchronize()
                counts, want = launch_counts(mega_resident=1)
                check(counts == want, f"{where}: {counts}")
                staged = ops.mega_spectral_op(*x, *args, segments=segs,
                                              residency="staged", **ckw)
                check(split_bit_equal(torch, got, staged),
                      f"{where}: resident != staged")
                check(split_bit_equal(torch, got, chain_launches(
                    ops, x, segs, args, **ckw)),
                      f"{where}: resident != its spectral launches")
                if bb:
                    check(split_bit_equal(torch, got, ops.mega_spectral_op(
                        *x, *args, segments=segs, residency="vmem",
                        **ckw)), f"{where}: batch_block != 1 scene a block")
                    out["batch_block_equal"] += 1
                plain = ops.mega_spectral_op_plain(
                    *x, *args, segments=segs, residency="vmem",
                    batch_block=bb, **ckw)
                _, rel, masks = finite_err(torch, got, plain)
                if fft_impl == "stockham":
                    check(split_bit_equal(torch, got, plain),
                          f"{where}: != plain (rel {rel:.3e})")
                else:
                    check(masks and rel <= FORM_TOL[precision],
                          f"{where}: vs plain {rel:.3e}, masks {masks}")
                out["max_rel_err"][tag] = max(out["max_rel_err"].get(tag, 0.0),
                                              rel)
                if precision == "f32" and not kara:
                    o = oracle_err(torch, got, oracle_chain(
                        torch, torch.complex(*x), segs, args))
                    check(o <= ORACLE_TOL, f"{where}: vs complex128 {o:.3e}")
                    out["max_oracle_err"] = max(out["max_oracle_err"], o)
                    out["oracle_cases"] += 1
                out["cases"] += 1
                out["staged_equal"] += 1
                out["launches_equal"] += 1
                del x, args, got, staged, plain
    emit("resident_long_kernel", fft_impl=fft_impl, **out,
         form_tol=FORM_TOL, oracle_tol=ORACLE_TOL)
    return out


def resident_long_times(torch, smi_line):
    """Phase 21.2: ``RESIDENT_TIMED``, each a batch of ``MEGA_BATCH``
    scenes (one a block): fused1 compiled with no residency pinned (vmem)
    run with the counts reset — one ``mega_resident`` launch, bit for bit
    fused3's and a pinned staged fused1's images, within TOL of the plain
    version — then ``mega_resident`` and, on the same batch,
    ``mega_staged`` timed queued beside their plain versions, the library
    chain (torch.fft and torch multiplies) and the bound (one read and
    write of the slab and the filters). Returns the ``kernels``
    records."""
    import dataclasses

    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import build_pipeline, paper_targets, simulate
    from repro_torch.core.sar.geometry import test_scene
    from repro_torch.kernels import ops
    small = test_scene(128)
    records = []
    for name, (na, nr), fft_kw, fft_impl in RESIDENT_TIMED:   # 21.2
        cfg = dataclasses.replace(small, na=na, nr=nr)
        kw = dict(fft_impl=fft_impl)
        if fft_kw:
            kw["fft_kw"] = fft_kw
        if (na, nr) == (small.na, small.nr):
            one = simulate(small, paper_targets(small))
        else:   # random echoes: the 2 x 8192 geometry does not validate
            rand = seeded_randn(torch, torch.device("cuda", 0), 21)
            one = torch.complex(rand(na, nr), rand(na, nr))
        raw = one.expand(MEGA_BATCH, na, nr).contiguous()
        p1 = build_pipeline(cfg, "fused1", **kw)
        step = p1.steps[0]
        check(step.kernel_kw["residency"] == "vmem", f"{name}: resident")
        reset_launch_counts()
        img = p1.run(raw)
        torch.cuda.synchronize()
        counts, want = launch_counts(mega_resident=1)
        check(counts == want, f"{name} x{MEGA_BATCH} ({fft_impl}): {counts}")
        p1s = build_pipeline(cfg, "fused1", residency="staged", **kw)
        reset_launch_counts()
        staged = p1s.run(raw)
        torch.cuda.synchronize()
        staged_counts, want = launch_counts(mega_staged=1)
        check(staged_counts == want,
              f"{name} x{MEGA_BATCH} staged ({fft_impl}): {staged_counts}")
        check(torch.equal(img, staged),
              f"{name} ({fft_impl}): resident != staged")
        del staged
        check(torch.equal(img, build_pipeline(cfg, "fused3", **kw).run(raw)),
              f"{name} ({fft_impl}): fused1 != fused3")
        args = [t for a in step.seg_filter_args for t in a]
        plain = ops.mega_spectral_op_plain(*planlib.split(raw), *args,
                                           **step.kernel_kw)
        err, rel = rel_err((img.real, img.imag), plain)
        check(rel <= TOL, f"{name} ({fft_impl}) vs plain: {rel:.3e}")
        del img, plain
        t_res = time_mega_kernel(torch, smi_line, "mega_resident", step, raw,
                                 cfg)
        t_stg = time_mega_kernel(torch, smi_line, "mega_staged",
                                 p1s.steps[0], raw, cfg)
        emit("resident_long_time", scene=[na, nr], split=fft_kw,
             fft_impl=fft_impl, batch=MEGA_BATCH,
             mega_resident_ms=t_res["ms"], mega_staged_ms=t_stg["ms"],
             plain_ms=t_res["plain_ms"], library_ms=t_res["library_ms"],
             bound_ms=t_res["bound_ms"],
             slab_bound_ms=MEGA_BATCH * na * nr * 16 / HBM_BYTES_PER_S * 1e3,
             nvidia_smi=smi_line)
        for kname, t, launches in (("mega_resident", t_res,
                                    counts["mega_resident"]),
                                   ("mega_staged", t_stg,
                                    staged_counts["mega_staged"])):
            rec = kernel_record(kname, f"fused1 {name} x{MEGA_BATCH}",
                                fft_impl, launches, err, [t],
                                source="mega_long.cu"
                                if kname == "mega_resident"
                                else "staged_long.cu")
            rec.update(scene=[na, nr], batch=MEGA_BATCH)
            records.append(rec)
        del raw
    return records


def resident_long_phase(torch, smi_line):
    """Phase 21: ``mega_resident`` past one block — the sweep on both
    routes (21.1) and the batches' times (21.2). Returns the ``kernels``
    records."""
    from repro_torch.kernels import ops
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    for i, fft_impl in enumerate(ops.FFT_IMPLS):
        resident_long_sweep(torch, ops, seeded_randn(torch, dev, 210 + i),
                            fft_impl)
    sweep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    records = resident_long_times(torch, smi_line)
    emit("resident_long_seconds", sweep=sweep_s,
         times=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    return records


LM_TOL = 1e-4                  # x max|want|: decode vs forward, card vs CPU
FUSION_N = 4096                # phase 22.1's line length
FUSION_LINES = 37              # ragged against every tile
MIXER_D, MIXER_BATCH = 2048, 4           # stablelm-1.6b's width, B = 4
MIXER_SEQS = (2048, 4096)      # S: lines of 4096 (one block), 8192 (passes)
SERVE_ARCH = "stablelm-1.6b"
SERVE = dict(batch=4, prompt=32, new=32)  # the LM serving cell
SWEEP = dict(batch=2, prompt=16, steps=4)  # one period of every other arch
CPU_LAYERS = 2                 # stablelm's depth cut for the card-vs-CPU check


def fusion_phase(torch, smi_line, dev):
    """22.1: ``SpectralPipeline`` on the kernel backend, every filter mode
    on rows and columns on both FFT routes at f32 (one launch each, against
    the plain version, complex128 and the torch backend), one bs16 case
    (through the deprecated ``compute_dtype`` alias), and ``fft_conv``."""
    import dataclasses
    from repro_torch.core import SpectralPipeline, fft_conv
    from repro_torch.kernels import ops
    rand = seeded_randn(torch, dev, 220)
    n, lines = FUSION_N, FUSION_LINES
    worst = dict(plain=0.0, oracle=0.0, torch_backend=0.0)
    cases = 0
    for fft_impl in ops.FFT_IMPLS:
        for axis in (1, 0):
            for mode in MEGA_MODES:
                scene = (lines, n) if axis == 1 else (n, lines)
                x = (rand(*scene), rand(*scene))
                filt = filter_payload(rand, mode, n, scene, lines)
                pipe = SpectralPipeline(filter_mode=mode, axis=axis,
                                        fft_impl=fft_impl)
                before = ops.SPECTRAL_LAUNCHES
                got = pipe(*x, **filt)
                torch.cuda.synchronize()
                check(ops.SPECTRAL_LAUNCHES == before + 1,
                      f"SpectralPipeline {fft_impl} {mode} axis {axis}: "
                      f"{ops.SPECTRAL_LAUNCHES - before} launches")
                want = ops.spectral_op_plain(
                    *x, **filt, axis=axis, filter_mode=mode,
                    fft_impl=fft_impl)
                _, rel = rel_err(got, want)
                z = oracle_op(torch, torch.complex(*x), axis, True, True,
                              mode, **filt)
                orc = oracle_err(torch, got, z)
                tb = dataclasses.replace(pipe, backend="torch")(*x, **filt)
                _, rel_t = rel_err(got, tb)
                check(rel <= TOL and orc <= ORACLE_TOL and rel_t <= TOL,
                      f"SpectralPipeline {fft_impl} {mode} axis {axis}: "
                      f"plain {rel:.3e} oracle {orc:.3e} torch {rel_t:.3e}")
                worst = dict(plain=max(worst["plain"], rel),
                             oracle=max(worst["oracle"], orc),
                             torch_backend=max(worst["torch_backend"],
                                               rel_t))
                cases += 1
    # bs16 on the Stockham route, named through the deprecated alias
    x = (rand(lines, n), rand(lines, n))
    filt = filter_payload(rand, "shared", n, (lines, n), lines)
    before = ops.SPECTRAL_LAUNCHES
    got = SpectralPipeline(filter_mode="shared", fft_impl="stockham",
                           compute_dtype="bs16")(*x, **filt)
    torch.cuda.synchronize()
    check(ops.SPECTRAL_LAUNCHES == before + 1, "bs16 SpectralPipeline")
    same = SpectralPipeline(filter_mode="shared", fft_impl="stockham",
                            precision="bs16")(*x, **filt)
    want = ops.spectral_op_plain(*x, **filt, filter_mode="shared",
                                 fft_impl="stockham", precision="bs16")
    _, bs16_rel = rel_err(got, want)
    check(split_bit_equal(torch, got, same) and bs16_rel <= FORM_TOL["bs16"],
          f"bs16 SpectralPipeline: {bs16_rel:.3e}")
    # fft_conv: a real circular convolution in one launch
    xr = rand(lines, n)
    kf = torch.fft.fft(rand(n))
    kr, ki = kf.real.contiguous(), kf.imag.contiguous()
    before = ops.SPECTRAL_LAUNCHES
    y = fft_conv(xr, kr, ki)
    torch.cuda.synchronize()
    conv_launches = ops.SPECTRAL_LAUNCHES - before
    y_plain = ops.spectral_op_plain(xr, torch.zeros_like(xr), hr=kr, hi=ki,
                                    filter_mode="shared")[0]
    y_torch = fft_conv(xr, kr, ki, backend="torch")
    _, conv_rel = rel_err((y,), (y_plain,))
    _, conv_rel_t = rel_err((y,), (y_torch,))
    check(conv_launches == 1 and conv_rel <= TOL and conv_rel_t <= TOL,
          f"fft_conv: {conv_launches} launches, plain {conv_rel:.3e}, "
          f"torch {conv_rel_t:.3e}")
    emit("lm_fusion", nvidia_smi=smi_line, n=n, lines=lines, cases=cases,
         max_rel_err_vs_plain=worst["plain"], tol=TOL,
         max_oracle_err=worst["oracle"], oracle_tol=ORACLE_TOL,
         max_rel_err_vs_torch_backend=worst["torch_backend"],
         bs16_rel_err=bs16_rel, bs16_tol=FORM_TOL["bs16"],
         fft_conv_launches=conv_launches, fft_conv_rel_err=conv_rel,
         fft_conv_rel_err_vs_torch=conv_rel_t)


def rel_to(got, want):
    """max|got - want| / max|want| of two tensors."""
    return float((got - want).abs().max() / want.abs().max())


def mixer_record(torch, mixer, x, launches, path, stockham=True):
    """The ``kernels`` record of the FFTConvMixer's launch on ``x``: the
    kernel against its plain version, timed beside the plain version,
    the torch.fft chain and its bound; with ``stockham`` the same lines
    on the Stockham route too (held bit for bit to its plain version)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fft4step import SpectralSpec, flops_nominal
    from repro_torch.models import fftconv
    s = x.shape[1]
    with torch.no_grad():
        lines, hr, hi, _ = fftconv.mixer_lines(mixer, x)
        zeros = torch.zeros_like(lines)
        kw = dict(hr=hr, hi=hi, fwd=True, inv=True, axis=1,
                  filter_mode="full", block=8)
        max_abs = float((ops.spectral_op(lines, zeros, **kw)[0]
                         - ops.spectral_op_plain(lines, zeros, **kw)[0]
                         ).abs().max())
        h = torch.complex(hr, hi)
        spec = SpectralSpec(n=2 * s, fwd=True, filter_mode="full",
                            inv=True, axis=1)
        nbytes = 6 * 4 * lines.numel()    # x re/im, H re/im in; y out
        flops = flops_nominal(spec, lines.shape[0])
        t_mem = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        rec = dict(
            name="spectral", route="cuda",
            source="src/repro_torch/kernels/csrc/spectral.cu",
            replaces="src/repro/kernels/fft4step.py:598",
            path=path,
            fft_impl="matmul", precision="f32", karatsuba=False,
            lines=lines.shape[0], n=2 * s, launches=launches,
            max_abs_err=max_abs,
            ms=cuda_median_ms(lambda: ops.spectral_op(lines, zeros, **kw),
                              queued=True),
            plain_ms=cuda_median_ms(
                lambda: ops.spectral_op_plain(lines, zeros, **kw),
                queued=True),
            library_ms=cuda_median_ms(lambda: torch.fft.ifft(
                torch.fft.fft(torch.complex(lines, zeros), dim=1) * h,
                dim=1), queued=True),
            bytes=nbytes, flops_nominal=flops, bound_ms=max(t_mem, t_ops),
            bound_by="bytes" if t_mem >= t_ops else "operations")
        rec["vs_library"] = rec["ms"] / rec["library_ms"]
        rec["vs_bound"] = rec["ms"] / rec["bound_ms"]
        if not stockham:
            return rec
        # the same lines on the Stockham route (SpectralPipeline's
        # fft_impl="stockham"; the mixer itself takes the default)
        sk = dict(kw, fft_impl="stockham")
        got_s = ops.spectral_op(lines, zeros, **sk)[0]
        plain_s = ops.spectral_op_plain(lines, zeros, **sk)[0]
        check(torch.equal(got_s, plain_s),
              f"fftconv S={s}: the Stockham route differs from plain")
        rec.update(
            stockham_ms=cuda_median_ms(
                lambda: ops.spectral_op(lines, zeros, **sk), queued=True),
            stockham_plain_ms=cuda_median_ms(
                lambda: ops.spectral_op_plain(lines, zeros, **sk),
                queued=True))
        del got_s, plain_s
    return rec


def mixer_phase(torch, smi_line, dev, d=MIXER_D, batch=MIXER_BATCH,
                seqs=MIXER_SEQS):
    """22.2: the FFTConvMixer at stablelm-1.6b's width — ``fftconv_forward``
    in one spectral launch against its plain version and
    ``fftconv_reference``, the gradients through the autograd.Function
    against autograd through the reference, and the launch timed beside
    its plain version, the torch.fft chain and its bound. Returns the
    ``kernels`` records."""
    from repro_torch.kernels import ops
    from repro_torch.models import fftconv
    records = []
    for s in seqs:
        gen = torch.Generator(device=dev)
        gen.manual_seed(222 + s)
        mixer = fftconv.init_fftconv(gen, d, s)
        x = torch.randn((batch, s, d), generator=gen, device=dev)
        with torch.no_grad():
            reset_launch_counts()
            y = mixer(x)
            torch.cuda.synchronize()
            got_counts, want_counts = launch_counts(spectral=1)
            check(got_counts == want_counts,
                  f"fftconv S={s}: launches {got_counts}")
            launches = got_counts["spectral"]
            y_plain = fftconv.fftconv_forward(mixer, x, backend="plain")
            y_ref = fftconv.fftconv_reference(mixer, x)
        err_plain, err_ref = rel_to(y, y_plain), rel_to(y, y_ref)
        check(err_plain <= TOL and err_ref <= TOL,
              f"fftconv S={s}: plain {err_plain:.3e} reference "
              f"{err_ref:.3e}")
        params = list(mixer.parameters())
        xg = x.clone().requires_grad_()
        before = ops.SPECTRAL_LAUNCHES
        grads = torch.autograd.grad((mixer(xg) ** 2).sum(), params + [xg])
        check(ops.SPECTRAL_LAUNCHES == before + 1,
              f"fftconv S={s}: forward and backward in one launch")
        want = torch.autograd.grad(
            (fftconv.fftconv_reference(mixer, xg) ** 2).sum(), params + [xg])
        grad_err = max(rel_to(g, w) for g, w in zip(grads, want))
        check(grad_err <= TOL, f"fftconv S={s} gradients: {grad_err:.3e}")
        del grads, want, xg
        rec = mixer_record(torch, mixer, x, launches,
                           f"fftconv_forward d={d} B={batch} S={s} "
                           "(src/repro/models/fftconv.py:44)")
        emit("lm_mixer", nvidia_smi=smi_line, d=d, batch=batch, seq=s,
             rel_err_vs_plain=err_plain, rel_err_vs_reference=err_ref,
             grad_rel_err=grad_err, tol=TOL, **rec)
        records.append(rec)
        del mixer, x, y, y_plain, y_ref
        torch.cuda.empty_cache()
    return records


def lm_batch(torch, cfg, tokens, gen):
    """The prompt batch of ``cfg``: tokens, and the stub frontends' inputs
    (patch embeddings on the first 4 positions, encoder frames)."""
    batch = {"tokens": tokens}
    b = tokens.shape[0]
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.randn(
            (b, 4, cfg.d_model), generator=gen, device=tokens.device)
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn(
            (b, cfg.encoder.n_frames, cfg.d_model), generator=gen,
            device=tokens.device)
    return batch


def decode_vs_forward(torch, model, batch, prompt, steps):
    """Prefill ``prompt`` tokens of ``batch``, then ``steps`` greedy decode
    steps; each step's logits (and the prefill's) against a full
    ``forward`` over the same prefix. Returns the worst relative error,
    the greedy tokens' agreement with the forward's argmax where its top
    two differ by more than ``LM_TOL`` x max|want|, and the tokens."""
    from repro_torch.models.layers import logits_last
    tokens = batch["tokens"]
    b = tokens.shape[0]
    max_len = prompt + steps
    table = (model.embed.table if model.cfg.tie_embeddings
             else model.lm_head.table)
    worst, decided, agree = 0.0, 0, 0
    with torch.no_grad():
        cache, logits = model.prefill(dict(batch, tokens=tokens[:, :prompt]),
                                      max_len)
        seq = tokens[:, :prompt]
        for step in range(steps + 1):
            x, _, _ = model.forward(dict(batch, tokens=seq), train=False)
            want = logits_last(x[:, -1], table)
            worst = max(worst, rel_to(logits, want))
            top2 = torch.topk(want, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > LM_TOL * float(
                want.abs().max())
            tok = torch.argmax(logits, dim=-1)
            decided += int(clear.sum())
            agree += int((clear & (tok == torch.argmax(want, dim=-1))).sum())
            if step == steps:
                break
            seq = torch.cat([seq, tok[:, None]], dim=1)
            logits, cache = model.decode_step(cache, tok[:, None])
    check(seq.shape == (b, max_len), f"decoded {tuple(seq.shape)}")
    return worst, decided, agree


def serve_phase(torch, smi_line, dev):
    """22.3: stablelm-1.6b at full width and depth on the card — served at
    its bf16 compute (prefill, decode a token, tokens/s, the decode step's
    bound), then at f32 every decode step against a full forward, then the
    card's f32 forward at 2 layers against the CPU's."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model
    cfg = registry.get(SERVE_ARCH)
    b, prompt, new = SERVE["batch"], SERVE["prompt"], SERVE["new"]
    max_len = prompt + new
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = Model(cfg, device=dev).init(gen)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (b, prompt), generator=gen,
                            device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    spectral0 = ops.SPECTRAL_LAUNCHES
    toks = generate(model, prompts, new, max_len)          # first call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks2 = generate(model, prompts, new, max_len)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check(toks.shape == (b, new) and torch.equal(toks, toks2),
          f"generate: {tuple(toks.shape)}, repeatable "
          f"{bool(torch.equal(toks, toks2))}")
    batch = {"tokens": prompts}
    with torch.inference_mode(), model.compute_cast():
        prefill_ms = cuda_median_ms(lambda: model.prefill(batch, max_len),
                                    warm=1, reps=5)
        cache, logits = model.prefill(batch, max_len)
        tok = torch.argmax(logits, dim=-1)[:, None]
        step_ms = []
        for _ in range(new - 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, cache = model.decode_step(cache, tok)
            end.record()
            tok = torch.argmax(logits, dim=-1)[:, None]
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
        del cache
    check(ops.SPECTRAL_LAUNCHES == spectral0, "the LM path launched the "
          "spectral kernel")
    weight_bytes = 2 * cfg.param_count()           # bf16 weights, read once
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    step_ms.sort()
    emit("lm_serve", nvidia_smi=smi_line, arch=cfg.name,
         layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
         params=cfg.param_count(), dtype=cfg.dtype, batch=b, prompt=prompt,
         new_tokens=new, init_seconds=init_s, generate_ms=gen_s * 1e3,
         tokens_per_s=b * new / gen_s, prefill_ms=prefill_ms,
         decode_ms_p50=step_ms[len(step_ms) // 2],
         decode_ms_mean=sum(step_ms) / len(step_ms),
         decode_ms_min=step_ms[0], decode_ms_max=step_ms[-1],
         decode_bound_ms=bound_ms, bound_by="bytes",
         bound_bytes=weight_bytes,
         decode_vs_bound=step_ms[len(step_ms) // 2] / bound_ms,
         sample=toks[0, :8].tolist())

    # f32 compute, the same weights: decode == forward at every step
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = Model(cfg32, device=dev)
    model32.load_state_dict(model.state_dict())
    del model
    torch.cuda.empty_cache()
    worst, decided, agree = decode_vs_forward(
        torch, model32, batch, prompt, new)
    check(worst <= LM_TOL and agree == decided,
          f"{cfg.name} f32 decode vs forward: {worst:.3e}, greedy "
          f"{agree}/{decided}")
    emit("lm_decode_vs_forward", nvidia_smi=smi_line, arch=cfg.name,
         layers=cfg.n_layers, dtype="float32", batch=b, prompt=prompt,
         steps=new, max_rel_err=worst, tol=LM_TOL, greedy_decided=decided,
         greedy_agree=agree)
    del model32
    torch.cuda.empty_cache()

    # the card's f32 forward against the CPU's, same weights, 2 layers
    cfg2 = dataclasses.replace(cfg32, n_layers=CPU_LAYERS)
    gen.manual_seed(2)
    card = Model(cfg2, device=dev).init(gen)
    host = Model(cfg2, device="cpu")
    host.load_state_dict(card.state_dict())
    with torch.no_grad():
        x_card, _, _ = card.forward(batch, train=False)
        x_host, _, _ = host.forward({"tokens": prompts.cpu()}, train=False)
    cpu_err = rel_to(x_card.cpu(), x_host)
    check(cpu_err <= LM_TOL, f"{cfg.name} 2 layers card vs CPU: "
          f"{cpu_err:.3e}")
    emit("lm_card_vs_cpu", nvidia_smi=smi_line, arch=cfg.name,
         layers=CPU_LAYERS, dtype="float32", rel_err=cpu_err, tol=LM_TOL)
    del card, host
    torch.cuda.empty_cache()


def arch_sweep(torch, smi_line, dev):
    """22.4: every other architecture at full width, one pattern period
    deep, f32 (MoE dropless at capacity_factor = n_experts): prefill, then
    decode steps, each against a full forward."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    b, prompt, steps = SWEEP["batch"], SWEEP["prompt"], SWEEP["steps"]
    spectral0 = ops.SPECTRAL_LAUNCHES
    for arch in registry.ARCHS:
        if arch == SERVE_ARCH:
            continue
        t0 = time.perf_counter()
        cfg = registry.get(arch)
        moe = cfg.moe and dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts))
        cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern),
                                  dtype="float32", moe=moe)
        gen = torch.Generator(device=dev)
        gen.manual_seed(3)
        model = Model(cfg, device=dev).init(gen)
        tokens = torch.randint(0, cfg.vocab_size, (b, prompt + steps),
                               generator=gen, device=dev)
        batch = lm_batch(torch, cfg, tokens, gen)
        worst, decided, agree = decode_vs_forward(torch, model, batch,
                                                  prompt, steps)
        check(worst <= LM_TOL and agree == decided,
              f"{arch} one period f32 decode vs forward: {worst:.3e}, "
              f"greedy {agree}/{decided}")
        emit("lm_arch", nvidia_smi=smi_line, arch=arch,
             layers=cfg.n_layers, pattern=list(cfg.pattern),
             params=cfg.param_count(), d_model=cfg.d_model, batch=b,
             prompt=prompt, steps=steps, max_rel_err=worst, tol=LM_TOL,
             greedy_decided=decided, greedy_agree=agree,
             peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
             seconds=time.perf_counter() - t0)
        del model, batch, tokens
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    check(ops.SPECTRAL_LAUNCHES == spectral0,
          "the LM path launched the spectral kernel")


def lm_phase(torch, smi_line):
    """Phase 22: ``core.fusion``, the FFTConvMixer and the LM serving path.
    Returns the ``kernels`` records."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32, "f32 matmuls")
    seconds = {}
    t0 = time.perf_counter()
    fusion_phase(torch, smi_line, dev)
    seconds["fusion"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    records = mixer_phase(torch, smi_line, dev)
    seconds["mixer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve_phase(torch, smi_line, dev)
    seconds["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arch_sweep(torch, smi_line, dev)
    seconds["arch_sweep"] = time.perf_counter() - t0
    emit("lm_seconds", nvidia_smi=smi_line, **seconds)
    return records


TRAIN_ARCH = "stablelm-1.6b"
TRAIN = dict(batch=8, seq=128, steps=30)       # launch/train.py's defaults
TRAIN_LONG = dict(batch=2, seq=2048, steps=3)  # remat on against off
TRAIN_CPU = dict(layers=2, batch=2, seq=64)    # the card against the CPU
RESTART = dict(layers=2, batch=8, seq=128, steps=8, ckpt_every=2, fail_at=5)
TRAIN_SWEEP = dict(batch=2, seq=64)            # one step of every other arch
TRAIN_SKIP = {"llama4-scout-17b-a16e":
              "10.88 B parameters at 18 B each (f32 weights, gradients, mu "
              "and nu, a bf16 compute copy): 196 GB, over one 80 GB card"}
REMAT_TOL = 1e-6               # x max|want|: the card's remat on vs off
RESTART_FLAG = "--train-restart-child"


def train_bound(cfg, batch, seq):
    """A train step's least time on the card, its two terms from the
    code: (1) the FLOP over dense bf16 — 6 N T for the matmuls (forward
    2 N T, backward 4 N T; N the parameters, the tied table counted once,
    as the logits' matmul) plus the attention scores the code forms in
    full, QK^T and AV at 4 S H Dh a token and attention layer forward, x 3
    with the backward; (2) the bytes over HBM that the optimizer and the
    compute cast move — AdamW reads p, g, mu, nu and writes p, mu, nu
    (28 B a parameter), the cast reads f32 and writes bf16 (6 B)."""
    n = cfg.param_count()
    tokens = batch * seq
    attn = sum(k in ("global", "local") for k in cfg.layer_kinds)
    flops = 6 * n * tokens + 3 * 4 * seq * cfg.n_heads * \
        cfg.resolved_head_dim * attn * tokens
    nbytes = 34 * n
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_flops=flops, bound_bytes=nbytes, bound_flops_ms=t_ops,
                bound_bytes_ms=t_mem, bound_ms=max(t_ops, t_mem),
                bound_by="operations" if t_ops >= t_mem else "bytes")


def timed_step(torch, step_fn, events):
    """``step_fn`` with CUDA events around each call, appended to
    ``events``: the card's time from the step's first launch being
    issued to its last finishing, the host's gaps included."""
    def step(opt_state, batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step_fn(opt_state, batch)
        end.record()
        events.append((start, end))
        return out
    return step


def step_parts(torch, model, run, batch):
    """One more train step with its parts apart (CUDA events): the
    forward (``Model.loss``), the backward, the AdamW update (the same
    schedule as ``launch/train.py``'s ``build``), and the step's wall
    time with the loss read back; in ms."""
    from repro_torch.optim import AdamWConfig, adamw
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for p in run.params.values():
        p.grad = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    loss = model.loss(batch)
    ev[1].record()
    loss.backward()
    ev[2].record()
    grads = {k: p.grad for k, p in run.params.items()}
    adamw.update(run.params, grads, run.opt_state,
                 AdamWConfig(warmup_steps=10, decay_steps=1000))
    ev[3].record()
    float(loss.detach())
    wall = (time.perf_counter() - t0) * 1e3
    for p in run.params.values():
        p.grad = None
    return dict(part_forward_ms=ev[0].elapsed_time(ev[1]),
                part_backward_ms=ev[1].elapsed_time(ev[2]),
                part_update_ms=ev[2].elapsed_time(ev[3]),
                part_wall_ms=wall)


def train_full(torch, smi_line, dev):
    """23 (a): stablelm-1.6b at full width and depth trained through
    ``launch/train.py`` (f32 weights, bf16 compute, AdamW, the token
    stream; batch 8, seq 128, 30 steps) and one more step timed in parts,
    then 3 steps at seq 2048 with remat on and off."""
    import dataclasses
    import statistics
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch import train as T
    b, s, n = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold on the card (cached pipelines' filters)
    other = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model, cfg, step_fn, data = T.build(TRAIN_ARCH, False, b, s, device=dev)
    run = T.init_state(model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    events = []
    reset_launch_counts()
    t0 = time.perf_counter()
    run, losses, watchdog = T.train_loop(
        run, timed_step(torch, step_fn, events), data, n, log_every=10)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    got_counts, want_counts = launch_counts()
    check(got_counts == want_counts, f"Model.loss launched {got_counts}")
    ms = [a.elapsed_time(e) for a, e in events]
    first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(len(losses) == n and all(math.isfinite(v) for v in losses),
          f"{cfg.name}: losses {losses}")
    check(last5 < first5, f"{cfg.name}: loss did not fall, first 5 "
          f"{first5:.4f}, last 5 {last5:.4f}")
    step_ms = statistics.median(ms[-20:])
    peak = torch.cuda.max_memory_allocated()
    params = cfg.param_count()
    bound = train_bound(cfg, b, s)
    parts = step_parts(torch, model, run, data.batch(n))
    emit("train", nvidia_smi=smi_line, arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab_size, params=params,
         dtype=cfg.dtype, remat=cfg.remat, batch=b, seq=s, steps=n,
         init_seconds=init_s, loop_seconds=loop_s, losses=losses,
         loss_first5=first5, loss_last5=last5, step_ms_median_last20=step_ms,
         step_ms_first=ms[0], step_ms_min=min(ms[1:]),
         step_ms_max=max(ms[1:]), tokens_per_s=b * s / step_ms * 1e3,
         peak_gib=peak / 2 ** 30, peak_bytes_per_param=peak / params,
         reckoned_gib_at_18_b=18 * params / 2 ** 30, **bound,
         vs_bound=step_ms / bound["bound_ms"], **parts,
         stragglers=len(watchdog.flagged), launches=got_counts)

    # seq 2048: the same model and optimizer, remat on, then off
    bl, sl = TRAIN_LONG["batch"], TRAIN_LONG["seq"]
    data_l = TokenStream(DataConfig(cfg.vocab_size, sl, bl), device=dev)
    opt_state = run.opt_state
    long = {}
    state = sum(t.numel() * t.element_size() for t in
                [*run.params.values(), *opt_state["mu"].values(),
                 *opt_state["nu"].values(), opt_state["step"]])
    for remat in (True, False):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        other_l = torch.cuda.memory_allocated() - state
        events, ls = [], []
        step = timed_step(torch, step_fn, events)
        for i in range(TRAIN_LONG["steps"]):
            opt_state, stats = step(opt_state, data_l.batch(i))
            ls.append(float(stats["loss"]))
        torch.cuda.synchronize()
        check(all(math.isfinite(v) for v in ls),
              f"seq {sl} remat={remat}: losses {ls}")
        long[remat] = dict(peak_gib=torch.cuda.max_memory_allocated()
                           / 2 ** 30,
                           peak_bytes=torch.cuda.max_memory_allocated(),
                           other_bytes=other_l,
                           step_ms=[a.elapsed_time(e) for a, e in events],
                           losses=ls)
    model.cfg = cfg
    run.opt_state = opt_state
    measured = {(b, s, cfg.remat): (peak, other, step_ms)}
    measured.update({(bl, sl, r): (long[r]["peak_bytes"],
                                   long[r]["other_bytes"],
                                   long[r]["step_ms"][-1]) for r in long})
    check(long[True]["peak_gib"] < long[False]["peak_gib"],
          f"seq {sl}: remat peak {long[True]['peak_gib']:.2f} GiB, without "
          f"{long[False]['peak_gib']:.2f}")
    bound_l = train_bound(cfg, bl, sl)
    emit("train_remat", nvidia_smi=smi_line, arch=cfg.name, batch=bl,
         seq=sl, steps=TRAIN_LONG["steps"],
         remat_on=long[True], remat_off=long[False],
         remat_on_step_ms=long[True]["step_ms"][-1],
         remat_off_step_ms=long[False]["step_ms"][-1],
         peak_ratio=long[True]["peak_gib"] / long[False]["peak_gib"],
         **bound_l)
    del model, run, opt_state, step_fn, data, data_l
    torch.cuda.empty_cache()
    return measured


DRYRUN_PEAK_TOL = 0.10     # predicted peak vs max_memory_allocated


def dryrun_checks(torch, smi_line, measured):
    """23 (e): the dry run's counting context (``launch/dryrun.py``) over
    23 (a)'s three step calls, on meta: ``launch/train.py``'s step on one
    device at the same configuration, its arguments (the f32 weights,
    AdamW's moments and step, the batch) and the high-water mark of what
    the step makes; the predicted peak against ``max_memory_allocated``
    less what earlier phases held on the card when its count started
    (within 10 %; both raw numbers on the line), the roofline's terms
    beside the measured step and ``train_bound``'s two terms."""
    import dataclasses
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as T
    from repro_torch.optim import adamw
    for (b, s, remat), (raw_peak, other, step_ms) in measured.items():
        peak = raw_peak - other
        model, cfg, step_fn, data = T.build(TRAIN_ARCH, False, b, s,
                                            device="meta")
        model.cfg = cfg = dataclasses.replace(cfg, remat=remat)
        params = dict(model.named_parameters())
        args = (adamw.init(params), data.batch(0))
        held = sum(t.numel() * t.element_size() for t in
                   [*params.values(), *args[0]["mu"].values(),
                    *args[0]["nu"].values(), args[0]["step"],
                    *args[1].values()])
        counter, _, secs = dryrun.count_step(step_fn, args, placed=params)
        dev = counter.devices[()]
        roof = dev.roofline()
        bound = train_bound(cfg, b, s)
        predicted = held + dev.peak
        err = (predicted - peak) / peak
        emit("dryrun_check", nvidia_smi=smi_line, arch=cfg.name, batch=b,
             seq=s, remat=remat, argument_bytes=held, temp_bytes=dev.peak,
             predicted_peak_bytes=predicted, measured_peak_bytes=peak,
             max_memory_allocated=raw_peak, other_phases_bytes=other,
             predicted_peak_gib=predicted / 2 ** 30,
             measured_peak_gib=peak / 2 ** 30, peak_rel_err=err,
             tol=DRYRUN_PEAK_TOL, flops=dev.flops, hbm_bytes=dev.hbm_bytes,
             t_compute_ms=roof.t_compute * 1e3,
             t_memory_ms=roof.t_memory * 1e3, bottleneck=roof.bottleneck,
             roofline_bound_ms=roof.bound * 1e3, measured_step_ms=step_ms,
             train_bound_flops_ms=bound["bound_flops_ms"],
             train_bound_bytes_ms=bound["bound_bytes_ms"],
             trace_seconds=secs)
        check(abs(err) <= DRYRUN_PEAK_TOL,
              f"dry run: {cfg.name} batch {b} seq {s} remat={remat}: "
              f"predicted peak {predicted / 2 ** 30:.4f} GiB, measured "
              f"{peak / 2 ** 30:.4f}")


def conditioned_state(torch, grads, step, device="cpu"):
    """AdamW moments as a run holds them, drawn on ``device`` (the CPU
    unless named) from a seed: per leaf mu ~ N(0, sigma^2) and nu = mu^2 +
    sigma^2 z^2 (nu >= mu^2), sigma the gradient's RMS. From zero moments
    the first step is lr * g / |g|, whose sign flips where g is rounding
    noise on either side; these make the step depend smoothly on g."""
    gen = torch.Generator(device=device)
    gen.manual_seed(6)
    mu, nu = {}, {}
    for name, g in grads.items():
        sig = float(g.pow(2).mean().sqrt()) + 1e-12
        m = torch.randn(g.shape, generator=gen, device=device) * sig
        mu[name] = m
        nu[name] = m * m + (torch.randn(g.shape, generator=gen,
                                        device=device) * sig) ** 2
    return {"mu": mu, "nu": nu,
            "step": torch.tensor(step, dtype=torch.int32, device=device)}


def train_vs_cpu(torch, smi_line, dev):
    """23 (b): stablelm-1.6b at full width, 2 layers deep, f32 compute:
    the token stream's batch on the card equal to the CPU's; every
    parameter's gradient and one AdamW step's new weights and moments on
    the card within 1e-4 x max|want| of the CPU's; the card's gradients
    with remat on and off within 1e-6."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw
    t0 = time.perf_counter()
    cfg = dataclasses.replace(registry.get(TRAIN_ARCH),
                              n_layers=TRAIN_CPU["layers"], dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    card = Model(cfg, device=dev).init(gen)
    host = Model(cfg, device="cpu")
    host.load_state_dict(card.state_dict())
    dc = DataConfig(cfg.vocab_size, TRAIN_CPU["seq"], TRAIN_CPU["batch"],
                    seed=5)
    batch_c = TokenStream(dc, dev).batch(3)
    batch_h = TokenStream(dc, "cpu").batch(3)
    check(all(batch_c[k].device.type == dev.type
              and torch.equal(batch_c[k].cpu(), batch_h[k])
              for k in batch_h), "TokenStream: the card's batch differs")

    def grads(model, batch):
        model.zero_grad(set_to_none=True)
        loss = model.loss(batch)
        loss.backward()
        out = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), out

    loss_c, g_c = grads(card, batch_c)                 # remat on
    loss_h, g_h = grads(host, batch_h)
    grad_err = max(rel_to(g_c[n].cpu(), g_h[n]) for n in g_h)
    check(grad_err <= LM_TOL, f"{cfg.name} 2 layers gradients card vs CPU: "
          f"{grad_err:.3e}")
    card.cfg = dataclasses.replace(cfg, remat=False)
    _, g_off = grads(card, batch_c)
    card.cfg = cfg
    remat_err = max(rel_to(g_off[n], g_c[n]) for n in g_c)
    check(remat_err <= REMAT_TOL, f"remat on vs off on the card: "
          f"{remat_err:.3e}")
    del g_off
    opt = AdamWConfig(warmup_steps=10, decay_steps=1000)
    state_h = conditioned_state(torch, g_h, 10)
    state_c = {k: {n: t.to(dev, copy=True) for n, t in state_h[k].items()}
               for k in ("mu", "nu")}
    state_c["step"] = state_h["step"].to(dev, copy=True)
    p_c, p_h = dict(card.named_parameters()), dict(host.named_parameters())
    _, _, stats_c = adamw.update(p_c, g_c, state_c, opt)
    _, _, stats_h = adamw.update(p_h, g_h, state_h, opt)
    step_err = max(max(rel_to(p_c[n].detach().cpu(), p_h[n].detach()),
                       rel_to(state_c["mu"][n].cpu(), state_h["mu"][n]),
                       rel_to(state_c["nu"][n].cpu(), state_h["nu"][n]))
                   for n in p_h)
    gnorm_err = abs(float(stats_c["grad_norm"]) - float(stats_h["grad_norm"])
                    ) / float(stats_h["grad_norm"])
    check(step_err <= LM_TOL and gnorm_err <= LM_TOL,
          f"one AdamW step card vs CPU: {step_err:.3e}, grad norm "
          f"{gnorm_err:.3e}")
    emit("train_card_vs_cpu", nvidia_smi=smi_line, arch=cfg.name,
         layers=cfg.n_layers, dtype=cfg.dtype, batch=TRAIN_CPU["batch"],
         seq=TRAIN_CPU["seq"], loss_card=loss_c, loss_cpu=loss_h,
         grad_rel_err=grad_err, step_rel_err=step_err,
         grad_norm_rel_err=gnorm_err, tol=LM_TOL,
         remat_rel_err=remat_err, remat_tol=REMAT_TOL,
         stream_equal=True, seconds=time.perf_counter() - t0)
    del card, host, g_c, g_h, state_c, state_h, p_c, p_h
    torch.cuda.empty_cache()


def restart_child(dev=None) -> int:
    """23 (c), in a process of its own (``chip_smoke.py --train-restart-
    child``, with ``CUBLAS_WORKSPACE_CONFIG`` set before cuBLAS starts):
    under deterministic algorithms, stablelm-1.6b at full width, 2 layers,
    bf16, trains 8 steps uninterrupted from step 0; then, from the same
    step 0, checkpointing every 2 steps, fails at step 5 and restarts from
    its step-4 checkpoint (``run_with_restarts``): every final weight and
    moment ``torch.equal`` to the uninterrupted run's. Then a preemption: one
    more step, a blocking checkpoint of it, a stop. Prints one JSON line;
    exit 0 when every check holds."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.distributed import (FailureInjector, PreemptionHandler,
                                         run_with_restarts)
    from repro_torch.launch import steps
    from repro_torch.launch import train as T
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    dev = dev or torch.device("cuda", 0)
    r = RESTART
    cfg = dataclasses.replace(registry.get(TRAIN_ARCH), n_layers=r["layers"])
    model = Model(cfg, device=dev)
    step_fn = steps.build_train_step(
        model, AdamWConfig(warmup_steps=10, decay_steps=1000))
    data = TokenStream(DataConfig(cfg.vocab_size, r["seq"], r["batch"]),
                       device=dev)
    run0 = T.init_state(model)
    n = r["steps"]
    # the step-0 state held in host memory, not written: each checkpoint
    # of 2 full-width layers is 3.6 GB to write and to read back
    initial = {k: t.detach().to("cpu", copy=True)
               for k, t in run0.params.items()}
    initial_opt = {o: {k: t.to("cpu", copy=True)
                       for k, t in run0.opt_state[o].items()}
                   for o in ("mu", "nu")}
    initial_opt["step"] = run0.opt_state["step"].to("cpu", copy=True)

    def from_start():
        with torch.no_grad():
            for k, p in run0.params.items():
                p.copy_(initial[k])
            for o in ("mu", "nu"):
                for k, t in run0.opt_state[o].items():
                    t.copy_(initial_opt[o][k])
        run0.opt_state["step"] = initial_opt["step"].to(dev, copy=True)
        run0.step = 0
        return run0

    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, keep=2)
        ref, losses, _ = T.train_loop(from_start(), step_fn, data, n,
                                      log_every=0)
        want = {k: p.detach().clone() for k, p in ref.params.items()}
        want_opt = {k: {m: t.clone() for m, t in ref.opt_state[k].items()}
                    for k in ("mu", "nu")}
        injector = FailureInjector(at_steps=(r["fail_at"],))
        seen = []

        def train(state):
            seen.append(state.step)
            out, _, _ = T.train_loop(state, step_fn, data, n, ckpt=mgr,
                                     ckpt_every=r["ckpt_every"],
                                     injector=injector, log_every=0,
                                     async_ckpt=False)
            return out

        def restore():
            """The latest checkpoint, or step 0 before the first."""
            if mgr.latest_step() is None:
                return from_start()
            return T.restore(mgr, run0)

        final, restarts = run_with_restarts(train, restore)
        unequal = [k for k, p in final.params.items()
                   if not torch.equal(p.detach(), want[k])]
        unequal += [f"{o}/{k}" for o in ("mu", "nu")
                    for k, t in final.opt_state[o].items()
                    if not torch.equal(t, want_opt[o][k])]
        preempt = PreemptionHandler(install=False)
        preempt.trigger()
        final, more, _ = T.train_loop(final, step_fn, data, n + 3, ckpt=mgr,
                                      ckpt_every=100, preempt=preempt,
                                      log_every=0)
        tree, saved = mgr.restore(T.checkpoint_tree(final), device="cpu")
        preempt_equal = saved == n + 1 and all(
            torch.equal(tree["params"][k], p.detach().cpu())
            for k, p in final.params.items())
    ok = (restarts == 1 and seen == [0, 4] and not unequal
          and final.step == n + 1 and len(more) == 1 and preempt_equal
          and all(math.isfinite(v) for v in losses))
    print(json.dumps({
        "ok": ok, "arch": cfg.name, "layers": cfg.n_layers,
        "dtype": cfg.dtype, "batch": r["batch"], "seq": r["seq"],
        "steps": n, "ckpt_every": r["ckpt_every"], "fail_at": r["fail_at"],
        "restarts": restarts, "started_at": seen, "losses": losses,
        "unequal": unequal[:10], "n_unequal": len(unequal),
        "preempt_step": final.step, "preempt_checkpoint_equal": preempt_equal,
        "deterministic": torch.are_deterministic_algorithms_enabled(),
        "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
        "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if ok else 1


def start_restart(torch):
    """23 (c): start the child process (its checkpoints' disk traffic
    overlaps parts (b) and (d); it needs ~10 GB of the card)."""
    torch.cuda.empty_cache()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             RESTART_FLAG], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def train_restart(torch, smi_line, proc):
    """23 (c) in the parent: wait for the child and read its line."""
    try:
        out, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    lines = out.strip().splitlines()
    check(proc.returncode in (0, 1) and lines,
          f"restart child rc {proc.returncode}: {err[-3000:]}")
    result = json.loads(lines[-1])
    emit("train_restart", nvidia_smi=smi_line, rc=proc.returncode, **result)
    check(proc.returncode == 0 and result["ok"],
          f"restart != uninterrupted: {result}")


def train_sweep(torch, smi_line, dev):
    """23 (d): every other architecture at full width, one pattern period
    deep, f32 weights at its config's compute dtype: every parameter's
    gradient from ``Model.loss`` finite, then one ``build_train_step``
    step (loss, gradient norm, new weights finite), its peak memory."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch import steps
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    b, s = TRAIN_SWEEP["batch"], TRAIN_SWEEP["seq"]
    reset_launch_counts()
    for arch in registry.ARCHS:
        if arch == TRAIN_ARCH:
            continue
        cfg = registry.get(arch)
        cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern))
        if arch in TRAIN_SKIP:
            emit("train_arch", nvidia_smi=smi_line, arch=arch,
                 skipped=TRAIN_SKIP[arch], params=cfg.param_count())
            continue
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        model = Model(cfg, device=dev).init(gen)
        stream = TokenStream(DataConfig(cfg.vocab_size, s, b, seed=8),
                             device=dev).batch(0)
        batch = dict(lm_batch(torch, cfg, stream["tokens"], gen),
                     labels=stream["labels"])
        model.loss(batch).backward()
        bad = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        check(not bad, f"{arch}: no finite gradient for {bad[:5]}")
        model.zero_grad(set_to_none=True)
        params = dict(model.named_parameters())
        state, stats = steps.build_train_step(model)(adamw.init(params),
                                                     batch)
        torch.cuda.synchronize()
        loss, gnorm = float(stats["loss"]), float(stats["grad_norm"])
        finite = all(bool(torch.isfinite(p).all()) for p in params.values())
        check(math.isfinite(loss) and math.isfinite(gnorm) and finite,
              f"{arch}: loss {loss}, grad norm {gnorm}, weights finite "
              f"{finite}")
        emit("train_arch", nvidia_smi=smi_line, arch=arch,
             layers=cfg.n_layers, pattern=list(cfg.pattern),
             params=cfg.param_count(), d_model=cfg.d_model, dtype=cfg.dtype,
             batch=b, seq=s, loss=loss, grad_norm=gnorm,
             lr=float(stats["lr"]), n_params=len(params),
             peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
             seconds=time.perf_counter() - t0)
        del model, params, state, stats, batch, stream
    got_counts, want_counts = launch_counts()
    check(got_counts == want_counts, f"the LM train steps launched "
          f"{got_counts}")
    torch.cuda.empty_cache()


def mixer_train(torch, smi_line, dev, d=MIXER_D, batch=MIXER_BATCH,
                s=MIXER_SEQS[0]):
    """23 (d): one AdamW step of the FFTConvMixer at stablelm-1.6b's width
    (D = 2048, B = 4, S = 2048) on a regression loss: its forward one
    spectral launch, its backward the oracle's VJP; the gradients within
    2e-4 x max|want| of the plain version's. Returns the ``kernels``
    record of the launch on this path."""
    from repro_torch.models import fftconv
    from repro_torch.optim import AdamWConfig, adamw
    gen = torch.Generator(device=dev)
    gen.manual_seed(230)
    mixer = fftconv.init_fftconv(gen, d, s)
    data = {"x": torch.randn((batch, s, d), generator=gen, device=dev),
            "y": 0.1 * torch.randn((batch, s, d), generator=gen, device=dev)}
    params = dict(mixer.named_parameters())

    def loss_fn(backend):
        def loss(b):
            y = fftconv.fftconv_forward(mixer, b["x"], backend=backend)
            return torch.mean((y - b["y"]) ** 2)
        return loss

    got = torch.autograd.grad(loss_fn("kernel")(data), list(params.values()))
    want = torch.autograd.grad(loss_fn("plain")(data), list(params.values()))
    grad_err = max(rel_to(g, w) for g, w in zip(got, want))
    check(grad_err <= TOL, f"FFTConvMixer gradients vs plain: {grad_err:.3e}")
    del got, want
    step = adamw.make_train_step(loss_fn("kernel"), params,
                                 AdamWConfig(warmup_steps=0))
    reset_launch_counts()
    state, stats = step(adamw.init(params), data)
    torch.cuda.synchronize()
    got_counts, want_counts = launch_counts(spectral=1)
    check(got_counts == want_counts, f"FFTConvMixer AdamW step: launches "
          f"{got_counts}")
    loss = float(stats["loss"])
    check(math.isfinite(loss), f"FFTConvMixer AdamW step: loss {loss}")
    rec = mixer_record(torch, mixer, data["x"], got_counts["spectral"],
                       f"FFTConvMixer AdamW step d={d} B={batch} S={s} "
                       "(src/repro/models/fftconv.py:44)", stockham=False)
    emit("train_mixer", nvidia_smi=smi_line, d=d, batch=batch, seq=s,
         loss=loss, grad_norm=float(stats["grad_norm"]),
         grad_rel_err_vs_plain=grad_err, tol=TOL, **rec)
    del mixer, data, params, state, stats
    torch.cuda.empty_cache()
    return [rec]


def train_phase(torch, smi_line):
    """Phase 23: the LM stack's training path. Returns the ``kernels``
    records (the mixer's launch on its training step)."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    seconds = {}
    t0 = time.perf_counter()
    measured = train_full(torch, smi_line, dev)
    seconds["a_full"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dryrun_checks(torch, smi_line, measured)
    seconds["e_dryrun"] = time.perf_counter() - t0
    child = start_restart(torch)
    try:
        t0 = time.perf_counter()
        train_vs_cpu(torch, smi_line, dev)
        seconds["b_card_vs_cpu"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        train_sweep(torch, smi_line, dev)
        records = mixer_train(torch, smi_line, dev)
        seconds["d_sweep"] = time.perf_counter() - t0
    finally:
        t0 = time.perf_counter()
        train_restart(torch, smi_line, child)
        seconds["c_restart_wait"] = time.perf_counter() - t0
    emit("train_seconds", nvidia_smi=smi_line, **seconds)
    return records


SHARD_ARCH = "stablelm-1.6b"
SHARD_TRAIN = dict(batch=8, seq=128, step0=4, reps=5)  # 24 (a)
SHARD_F32 = dict(layers=2, batch=8, seq=128)           # 24 (b)
SHARD_MOE = dict(arch="granite-moe-3b-a800m", layers=2, batch=4, seq=128,
                 mesh=(4, 1))   # 24 (b): groups of 256 over positions of 128
SHARD_SERVE = dict(arch="gemma3-12b", prompt=1500, max_len=2048, steps=2)
SHARD_GEN = dict(batch=4, prompt=32, new=16)            # 24 (c) generate
SHARD_TOL = 5e-3       # the reference's sharded-vs-single bars
SHARD_BF16_TOL = 2e-2  # x max|want|: bf16 logits of a batch cut otherwise
                       # (tests/test_torch_train_dense.py's bf16 bar)
SHARD_F32_TOL = 1e-5   # x max|want|: sharded vs single at f32
SHARD_UPDATE_TOL = 1e-2  # x max|p - p0|: a step's update, sharded vs single
SHARD_SECONDS = 180    # the phase's time limit (e)
SHARD_TP = dict(mesh=(1, 4), batch=4, prompt=32, new=8, layers32=2,
                train_batch=8, train_seq=128)                   # 24 (f)
SHARD_TP_TOL = 1e-2    # x max|want|: bf16 logits, split vs one device
# (4, 2) with every weight gathered whole a position, the layout before
# the split (PERF.md §5)
SHARD_WHOLE_WEIGHTS = dict(step_ms=1660.41, peak_gib=34.74)
SHARD_DRYRUN_TOL = 0.10  # 24 (g): the dry run's peak vs the card's / 4


def slab_mesh(torch, dev, shape):
    """A mesh of slabs of the one card: (data, model), or (pod, data,
    model) for a 3-tuple."""
    import numpy as np
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.launch import mesh as lm
    if len(shape) == 2:
        return lm.make_host_mesh(shape[1], [dev] * (shape[0] * shape[1]))
    devs = np.empty(shape, dtype=object)
    devs[...] = dev
    return Mesh(devs, ("pod", "data", "model"))


def shard_values(values, cfg, mesh):
    """``{name: tensor}`` laid out by ``param_shardings`` under the mesh's
    activation rules: (params, rules)."""
    from repro_torch.launch import mesh as lm
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    rules = lm.activation_rules(mesh)
    return steps.shard_params(values, shd.param_shardings(
        values, cfg, mesh, rules)), rules


def tree_bytes(torch, tree) -> int:
    """The bytes of every tensor in a tree of dicts."""
    if isinstance(tree, dict):
        return sum(tree_bytes(torch, v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def timed_steps(torch, step, state, batches):
    """CUDA-event ms of each call of ``step`` over ``batches``, the loss
    read back after each; returns (state, ms, losses)."""
    ms, losses = [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, stats = step(state, batch)
        end.record()
        losses.append(float(stats["loss"]))
        ms.append(start.elapsed_time(end))
    return state, ms, losses


def sharded_full(torch, smi_line, dev):
    """24 (a): stablelm-1.6b at full width and depth (bf16 compute,
    remat), batch 8, seq 128: one AdamW step from the same weights and
    non-zero moments on one device, then split over a (4, 2) mesh of
    slabs of the card; the loss within 5e-3 (relative: it reads ~500 at
    init) and every parameter within 5e-3; each slab's resident
    parameters and moments exactly ``shard_shape``'s; the step ms (median
    of 5 more) and peak GiB both ways.

    The update p - p0 within 1e-2 x its largest, against the step of one
    device that sums as the (4, 2) ranks sum (``same_association``: at
    bf16 any other order of a split contraction moves a full-depth step's
    update by ~8 % of its largest, one device's own halves included); and
    the control: the split with its row-parallel partial sums rounded to
    bf16 before their reduction (``partial_sums_in_bf16``) must miss that
    bar. The update against one device's plain step is printed. The
    single-device runs go first; the weights and moments they start from
    and the weights they end at stay on the card as the comparison's
    snapshots, and the peaks are given without them."""
    import statistics
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.distributed import mesh as M
    from repro_torch.launch import steps
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    t0 = time.perf_counter()
    cfg = registry.get(SHARD_ARCH)
    b, s, reps = SHARD_TRAIN["batch"], SHARD_TRAIN["seq"], SHARD_TRAIN["reps"]
    data = TokenStream(DataConfig(cfg.vocab_size, s, b, seed=24), dev)
    batches = [data.batch(i) for i in range(reps + 1)]
    opt = AdamWConfig(warmup_steps=10, decay_steps=1000)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    model = Model(cfg, device=dev).init(gen)
    snap = {"p0": {n: p.detach().clone()
                   for n, p in model.named_parameters()}}
    loss = model.loss(batches[0])
    loss.backward()
    snap["state0"] = conditioned_state(
        torch, {n: p.grad for n, p in model.named_parameters()},
        SHARD_TRAIN["step0"], dev)
    model.zero_grad(set_to_none=True)
    del loss

    def held():
        return tree_bytes(torch, snap)

    def fresh_state():
        state = {k: {n: t.clone() for n, t in snap["state0"][k].items()}
                 for k in ("mu", "nu")}
        state["step"] = snap["state0"]["step"].clone()
        return state

    def restart():
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(snap["p0"][n])

    def update_err(params, want):
        errs = {n: float((params[n].gather(dev) - w).abs().max())
                for n, w in want.items()}
        worst = max(errs, key=errs.get)
        return errs[worst], worst

    step = steps.build_train_step(model, opt)
    state = fresh_state()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    state, ms_one, (loss_single,) = timed_steps(torch, step, state,
                                                batches[:1])
    got_counts, want_counts = launch_counts()
    check(got_counts == want_counts, f"single-device step launched "
          f"{got_counts}")
    snap["want"] = {n: p.detach().clone()
                    for n, p in model.named_parameters()}
    moved = max(float((w - snap["p0"][n]).abs().max())
                for n, w in snap["want"].items())
    state, ms_single, _ = timed_steps(torch, step, state, batches[1:])
    peak_single = (torch.cuda.max_memory_allocated() - held()) / 2 ** 30
    del step, state
    mesh = slab_mesh(torch, dev, (4, 2))
    restart()
    with patched(same_association(torch, mesh.shape["model"])):
        steps.build_train_step(model, opt, accum_steps=mesh.shape["data"])(
            fresh_state(), batches[0])
    snap["same"] = {n: p.detach().clone()
                    for n, p in model.named_parameters()}
    same_moved = max(float((w - snap["p0"][n]).abs().max())
                     for n, w in snap["same"].items())
    del model
    torch.cuda.empty_cache()

    params, rules = shard_values(snap["p0"], cfg, mesh)
    opt_state = {k: {n: M.distribute(t, params[n].sharding)
                     for n, t in snap["state0"][k].items()}
                 for k in ("mu", "nu")}
    opt_state["step"] = snap["state0"]["step"].clone()
    torch.cuda.empty_cache()
    resident = {}
    for n, st in params.items():
        sub = M.shard_shape(st.shape, st.sharding)
        resident[n] = all(tuple(x.shape) == sub and x.numel() * 4
                          == x.untyped_storage().nbytes()
                          for tree in (params, opt_state["mu"],
                                       opt_state["nu"])
                          for _, x in tree[n].items())
    check(all(resident.values()), "slabs holding other than their shard: "
          f"{[n for n, ok in resident.items() if not ok]}")
    sstep = steps.build_train_step(Model(cfg, device="meta"), opt,
                                   mesh=mesh, rules=rules, params=params)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    opt_state, ms_first, (loss_sharded,) = timed_steps(
        torch, sstep, opt_state, batches[:1])
    got_counts, want_counts = launch_counts()
    check(got_counts == want_counts, f"sharded step launched {got_counts}")
    param_err, worst = update_err(params, snap["want"])
    same_err, same_worst = update_err(params, snap["same"])
    opt_state, ms_sharded, _ = timed_steps(torch, sstep, opt_state,
                                           batches[1:])
    peak_sharded = (torch.cuda.max_memory_allocated() - held()) / 2 ** 30
    slab_bytes = sum(st.nbytes() for tree in (
        params, opt_state["mu"], opt_state["nu"]) for st in tree.values())
    del params, opt_state, sstep
    torch.cuda.empty_cache()

    # the control: the same split step with the fault the bar must catch
    params, rules = shard_values(snap["p0"], cfg, mesh)
    opt_state = {k: {n: M.distribute(t, params[n].sharding)
                     for n, t in snap["state0"][k].items()}
                 for k in ("mu", "nu")}
    opt_state["step"] = snap["state0"]["step"].clone()
    with patched(partial_sums_in_bf16(torch)):
        steps.build_train_step(Model(cfg, device="meta"), opt, mesh=mesh,
                               rules=rules, params=params)(opt_state,
                                                           batches[0])
    control_err, control_worst = update_err(params, snap["same"])
    del params, opt_state
    loss_err = abs(loss_sharded - loss_single) / abs(loss_single)
    emit("sharded_train", nvidia_smi=smi_line, arch=cfg.name,
         layers=cfg.n_layers, params=cfg.param_count(), dtype=cfg.dtype,
         remat=cfg.remat, batch=b, seq=s, mesh=dict(mesh.shape),
         loss_single=loss_single, loss_sharded=loss_sharded,
         loss_rel_err=loss_err, param_max_abs_err=param_err,
         param_worst=worst, tol=SHARD_TOL, update_max_abs=moved,
         update_rel_err=param_err / moved,
         same_association_update_max_abs=same_moved,
         same_association_rel_err=same_err / moved,
         same_association_worst=same_worst,
         control_bf16_partials_rel_err=control_err / moved,
         control_worst=control_worst, update_tol=SHARD_UPDATE_TOL,
         slabs_exact=True, slab_gib=slab_bytes / 2 ** 30,
         step_ms_single_first=ms_one[0], step_ms_sharded_first=ms_first[0],
         step_ms_single_median=statistics.median(ms_single),
         step_ms_sharded_median=statistics.median(ms_sharded),
         step_ms_single=ms_single, step_ms_sharded=ms_sharded,
         peak_gib_single=peak_single, peak_gib_sharded=peak_sharded,
         ranks_a_position=mesh.shape["model"],
         whole_weights_step_ms=SHARD_WHOLE_WEIGHTS["step_ms"],
         whole_weights_peak_gib=SHARD_WHOLE_WEIGHTS["peak_gib"],
         launches=got_counts, seconds=time.perf_counter() - t0)
    del batches, snap
    torch.cuda.empty_cache()
    check(param_err <= SHARD_TOL and loss_err <= SHARD_TOL,
          f"sharded step vs single: parameters {param_err:.3e}, loss "
          f"{loss_err:.3e}")
    # the update itself, far under 5e-3: max|Δgot - Δwant| = max|got -
    # want| against the largest move, the split against one device
    # summing as its ranks do; and the bar sees the fault
    check(same_err <= SHARD_UPDATE_TOL * moved,
          f"sharded step's update vs the same association on one device: "
          f"{same_err:.3e} of a largest move {moved:.3e}")
    check(control_err > SHARD_UPDATE_TOL * moved,
          f"the update bar misses partial sums rounded to bf16: "
          f"{control_err:.3e} of a largest move {moved:.3e}")
    sharded_full_f32(torch, smi_line, dev)


def same_association(torch, m):
    """Patches (``(module, name, function)``) that make one device sum
    every contraction a (., ``m``) mesh's ranks split as the ranks sum it,
    each rank's slice of heads, hidden columns and vocabulary rows taken
    on its own: the query, key and value products and the MLP's gate and
    up products of each rank's columns; the attention of each rank's
    heads; the output projections' partial sums in float32, added in rank
    order and rounded once; the loss's logits of each rank's vocabulary
    rows, their log-sum-exps combined and their label logits added; and
    in the backward each rank's input gradient of those products summed
    over the ranks in float32 in rank order and rounded once
    (``distributed.mesh.Group``)."""
    from repro_torch.models import attention, layers
    from repro_torch.models import model as model_mod

    class Fork(torch.autograd.Function):
        """``x`` once a rank; the ranks' gradients summed as the group's
        all-gather transposes them."""

        @staticmethod
        def forward(ctx, x):
            return tuple(x.view_as(x) for _ in range(m))

        @staticmethod
        def backward(ctx, *gs):
            total = gs[0].float()
            for g in gs[1:]:
                total = total + g.float()
            return total.to(gs[0].dtype)

    def cols(w, r):
        n = w.shape[1] // m
        return w[:, r * n:(r + 1) * n].contiguous()

    def rows(w, r):
        n = w.shape[0] // m
        return w[r * n:(r + 1) * n]

    def reduce(parts, dt):
        total = parts[0]
        for y in parts[1:]:
            total = total + y
        return total.to(dt)

    def qkv(p, spec, x, src):
        assert src is x and spec.n_kv % m == 0
        dt = x.dtype
        xs = Fork.apply(x)
        out = []
        for name, n in (("wq", spec.n_heads), ("wk", spec.n_kv),
                        ("wv", spec.n_kv)):
            w = layers.cast(p[name], dt)
            out.append(torch.cat([attention._split_heads(
                xs[r] @ cols(w, r), n // m, spec.head_dim)
                for r in range(m)], dim=2))
        return out

    def sdpa(q, k, v, mask, q_chunk=None):
        hq, hk = q.shape[2] // m, k.shape[2] // m
        return torch.cat([attention_sdpa(
            q[:, :, r * hq:(r + 1) * hq], k[:, :, r * hk:(r + 1) * hk],
            v[:, :, r * hk:(r + 1) * hk], mask, q_chunk)
            for r in range(m)], dim=2)

    def out(p, o, dt):
        w = layers.cast(p["wo"], dt)
        n = o.shape[-1] // m
        return reduce([layers.matmul_f32(o[..., r * n:(r + 1) * n],
                                         rows(w, r)) for r in range(m)], dt)

    def mlp(p, x, act="silu"):
        dt = x.dtype
        xs = Fork.apply(x)
        gate, up, wo = (layers.cast(p[k], dt)
                        for k in ("wi_gate", "wi_up", "wo"))
        return reduce([layers.matmul_f32(
            layers.ACTS[act](xs[r] @ cols(gate, r)) * (xs[r] @ cols(up, r)),
            rows(wo, r)) for r in range(m)], dt)

    def loss(x, table, labels, mask=None, chunk=512, z_loss=0.0,
             denom=None):
        assert mask is None and not z_loss
        dt = x.dtype
        b, s, _ = x.shape
        wt = layers.cast(table, dt)
        n = wt.shape[0] // m
        xs = Fork.apply(x)
        chunk = min(chunk, s)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for lo in range(0, s, chunk):
            hi = min(lo + chunk, s)
            yc = labels[:, lo:hi].long()
            lses, lls = [], []
            for r in range(m):
                logits = layers.matmul_f32(xs[r][:, lo:hi], rows(wt, r).T)
                local = yc - r * n
                hit = (local >= 0) & (local < n)
                ll = torch.gather(logits, -1,
                                  torch.where(hit, local, 0)[..., None])
                lses.append(torch.logsumexp(logits, dim=-1))
                lls.append(ll[..., 0] * hit)
            lse = torch.logsumexp(torch.stack(lses), dim=0)
            total = total + (lse - reduce(lls, torch.float32)).sum()
        return total / (b * s if denom is None else denom)

    attention_sdpa = attention.sdpa
    return [(attention, "_qkv", qkv), (attention, "sdpa", sdpa),
            (attention, "_out", out), (model_mod, "mlp", mlp),
            (model_mod, "lm_loss_chunked", loss)]


def partial_sums_in_bf16(torch):
    """Patches that round each row-parallel product's partial sums to bf16
    before the ranks' reduction (attention's and the MLP's ``wo``, Mamba's
    ``x_proj``, the mixers' ``out_proj``, the ``ff``-parallel experts'
    ``wo``): the fault a split step's update check must catch
    (``sharded_full``'s and ``tp_mixers_update``'s control)."""
    from repro_torch.models import attention, layers, moe, recurrent
    from repro_torch.models import sharding

    def reduce_to(x, *logical):
        return sharding.reduce_to(x.to(torch.bfloat16), *logical)

    def sum_ranks(x, dim=None):
        return sharding.sum_ranks(x.to(torch.bfloat16), dim)
    return [(attention, "reduce_to", reduce_to),
            (layers, "reduce_to", reduce_to),
            (recurrent, "reduce_to", reduce_to),
            (recurrent, "sum_ranks", sum_ranks),
            (moe, "sum_ranks", sum_ranks)]


@contextlib.contextmanager
def patched(patches):
    """``patches`` (``(module, name, value)``) applied inside."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, value in patches:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def sharded_full_f32(torch, smi_line, dev):
    """24 (a), at f32: stablelm-1.6b at full width and depth, one AdamW
    step on (4, 2) against one device from the same weights and non-zero
    moments, the update p - p0 within 1e-2 x its largest (no allowance:
    at f32 the rounding of a re-associated sum does not reach it)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.distributed import mesh as M
    from repro_torch.launch import steps
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    t0 = time.perf_counter()
    cfg = dataclasses.replace(registry.get(SHARD_ARCH), dtype="float32")
    b, s = SHARD_TRAIN["batch"], SHARD_TRAIN["seq"]
    batch = TokenStream(DataConfig(cfg.vocab_size, s, b, seed=33),
                        dev).batch(0)
    opt = AdamWConfig(warmup_steps=10, decay_steps=1000)
    gen = torch.Generator(device=dev)
    gen.manual_seed(33)
    model = Model(cfg, device=dev).init(gen)
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss = model.loss(batch)
    loss.backward()
    state0 = conditioned_state(torch, {n: p.grad for n, p in
                                       model.named_parameters()},
                               SHARD_TRAIN["step0"], dev)
    model.zero_grad(set_to_none=True)
    del loss
    state = {k: {n: t.clone() for n, t in state0[k].items()}
             for k in ("mu", "nu")}
    state["step"] = state0["step"].clone()
    _, stats = steps.build_train_step(model, opt)(state, batch)
    loss_single = float(stats["loss"])
    want = {n: p.detach() for n, p in model.named_parameters()}
    moved = max(float((w - p0[n]).abs().max()) for n, w in want.items())
    del state
    mesh = slab_mesh(torch, dev, (4, 2))
    params, rules = shard_values(p0, cfg, mesh)
    del p0
    opt_state = {k: {n: M.distribute(t, params[n].sharding)
                     for n, t in state0[k].items()} for k in ("mu", "nu")}
    opt_state["step"] = state0["step"].clone()
    del state0
    sstep = steps.build_train_step(Model(cfg, device="meta"), opt,
                                   mesh=mesh, rules=rules, params=params)
    _, sstats = sstep(opt_state, batch)
    err = max(float((params[n].gather(dev) - w).abs().max())
              for n, w in want.items())
    loss_err = abs(float(sstats["loss"]) - loss_single) / abs(loss_single)
    emit("sharded_train_f32", nvidia_smi=smi_line, arch=cfg.name,
         layers=cfg.n_layers, dtype=cfg.dtype, batch=b, seq=s,
         mesh=dict(mesh.shape), loss_single=loss_single,
         loss_rel_err=loss_err, update_max_abs=moved,
         param_max_abs_err=err, update_rel_err=err / moved,
         update_tol=SHARD_UPDATE_TOL, seconds=time.perf_counter() - t0)
    check(err <= SHARD_UPDATE_TOL * moved and loss_err <= SHARD_F32_TOL,
          f"f32 sharded step vs single: update {err:.3e} of {moved:.3e}, "
          f"loss {loss_err:.3e}")
    del model, want, params, opt_state, sstep
    torch.cuda.empty_cache()


def sharded_f32(torch, smi_line, dev):
    """24 (b): stablelm-1.6b at full width, 2 layers, f32 compute: the
    gradients over (4, 2) and (2, 2, 2) meshes of slabs within 1e-5 x
    max|want| of the single-device gradients, leaf by leaf; then
    granite's (``sharded_moe``)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch import steps
    from repro_torch.models import Model
    cfg = dataclasses.replace(registry.get(SHARD_ARCH),
                              n_layers=SHARD_F32["layers"], dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    model = Model(cfg, device=dev).init(gen)
    batch = TokenStream(DataConfig(cfg.vocab_size, SHARD_F32["seq"],
                                   SHARD_F32["batch"], seed=25), dev).batch(0)
    loss = model.loss(batch)
    loss.backward()
    want = {n: p.grad for n, p in model.named_parameters()}
    values = {n: p.detach() for n, p in model.named_parameters()}
    out = {}
    for shape in ((4, 2), (2, 2, 2)):
        mesh = slab_mesh(torch, dev, shape)
        params, rules = shard_values(values, cfg, mesh)
        got_loss, grads = steps.lm_value_and_grad(
            Model(cfg, device="meta"), params, batch, mesh, rules)
        err = max(rel_to(grads[n].gather(), w) for n, w in want.items())
        loss_err = abs(float(got_loss) - float(loss.detach())) / abs(
            float(loss.detach()))
        out["x".join(map(str, shape))] = dict(grad_rel_err=err,
                                              loss_rel_err=loss_err)
        check(err <= SHARD_F32_TOL and loss_err <= SHARD_F32_TOL,
              f"f32 sharded gradients on {shape}: {err:.3e}, loss "
              f"{loss_err:.3e}")
        del params, grads
    emit("sharded_f32", nvidia_smi=smi_line, arch=cfg.name,
         layers=cfg.n_layers, batch=SHARD_F32["batch"],
         seq=SHARD_F32["seq"], tol=SHARD_F32_TOL, meshes=out)
    del model, want, values
    torch.cuda.empty_cache()
    sharded_moe(torch, smi_line, dev)


def sharded_moe(torch, smi_line, dev):
    """24 (b): granite-moe-3b at full width, 2 layers, f32, every layer
    rematerialised, on (4, 1): routing groups of 256 tokens over
    positions of 128, so the positions run in lockstep and the backward's
    recomputation (on autograd's own thread for the card) must route the
    forward's groups. Gradients and loss within 1e-5 x max|want| of one
    device."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch import steps
    from repro_torch.models import Model
    from repro_torch.models.moe import spans_positions
    from repro_torch.models.sharding import Position
    cfg = dataclasses.replace(registry.get(SHARD_MOE["arch"]),
                              n_layers=SHARD_MOE["layers"], dtype="float32",
                              remat=True)
    b, s = SHARD_MOE["batch"], SHARD_MOE["seq"]
    count = SHARD_MOE["mesh"][0]
    check(spans_positions(cfg.moe, b * s // count, Position(0, count)),
          "granite's groups do not span the positions")
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    model = Model(cfg, device=dev).init(gen)
    batch = TokenStream(DataConfig(cfg.vocab_size, s, b, seed=29),
                        dev).batch(0)
    loss = model.loss(batch)
    loss.backward()
    want = {n: p.grad for n, p in model.named_parameters()}
    mesh = slab_mesh(torch, dev, SHARD_MOE["mesh"])
    params, rules = shard_values(
        {n: p.detach() for n, p in model.named_parameters()}, cfg, mesh)
    got_loss, grads = steps.lm_value_and_grad(
        Model(cfg, device="meta"), params, batch, mesh, rules)
    err = max(float((grads[n].gather() - w).abs().max()
                    / w.abs().max().clamp(min=1e-30))
              for n, w in want.items())
    loss_err = abs(float(got_loss) - float(loss.detach())) / abs(
        float(loss.detach()))
    emit("sharded_moe", nvidia_smi=smi_line, arch=cfg.name,
         layers=cfg.n_layers, remat=cfg.remat, batch=b, seq=s,
         group_size=cfg.moe.group_size, mesh=dict(mesh.shape),
         grad_rel_err=err, loss_rel_err=loss_err, tol=SHARD_F32_TOL)
    check(err <= SHARD_F32_TOL and loss_err <= SHARD_F32_TOL,
          f"f32 sharded granite gradients, remat, spanning groups: "
          f"{err:.3e}, loss {loss_err:.3e}")
    del model, want, params, grads
    torch.cuda.empty_cache()


def sharded_serve(torch, smi_line, dev):
    """24 (c): gemma3-12b, one pattern period (5 local + 1 global) at full
    width, bf16: a batch-1 prompt past the window, then decode steps with
    every KV cache's sequence over "data" on (4, 2) (each slab attends
    its part, merged by log-sum-exp), the logits within 5e-3 x max|want|
    of the single-device decode. stablelm-1.6b ``generate`` under (4, 1)
    against one device: at full depth, bf16, the prefill logits within
    2e-2 x max|want| (cuBLAS rounds a 1-row and a 4-row bf16 product
    differently) and the share of equal tokens; at 2 layers, f32, the
    same tokens."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.distributed.mesh import ShardedTensor
    from repro_torch.launch import serve, steps
    from repro_torch.models import Model
    t0 = time.perf_counter()
    full = registry.get(SHARD_SERVE["arch"])
    cfg = dataclasses.replace(full, n_layers=len(full.pattern))
    gen = torch.Generator(device=dev)
    gen.manual_seed(26)
    model = Model(cfg, device=dev).init(gen)
    toks = torch.randint(0, cfg.vocab_size,
                         (1, SHARD_SERVE["prompt"] + SHARD_SERVE["steps"]),
                         generator=torch.Generator().manual_seed(26))
    toks = toks.to(dev)
    n, max_len = SHARD_SERVE["prompt"], SHARD_SERVE["max_len"]
    mesh = slab_mesh(torch, dev, (4, 2))
    params, rules = shard_values(
        {k: p.detach() for k, p in model.named_parameters()}, cfg, mesh)
    with torch.no_grad(), model.compute_cast():
        cache, pre = model.prefill({"tokens": toks[:, :n]}, max_len)
        want = []
        for i in range(SHARD_SERVE["steps"]):
            logits, cache = model.decode_step(cache, toks[:, n + i:n + i + 1])
            want.append(logits)
    del cache
    scache, spre = steps.build_prefill(model, max_len, mesh, rules,
                                       params)({"tokens": toks[:, :n]})
    check(all(isinstance(e["k"], ShardedTensor)
              and tuple(e["k"].spec)[:2] == (None, "data")
              for e in scache["layers"]),
          "the batch-1 KV caches are not cut along their sequence")
    decode = steps.build_decode(model, mesh, rules, params)
    errs = [rel_to(spre, pre)]
    for i in range(SHARD_SERVE["steps"]):
        logits, scache = decode(scache, toks[:, n + i:n + i + 1])
        errs.append(rel_to(logits, want[i]))
    check(max(errs) <= SHARD_TOL, f"{cfg.name} sequence-parallel decode vs "
          f"one device: {errs}")
    del model, params, scache, want
    torch.cuda.empty_cache()

    lm_cfg = registry.get(SHARD_ARCH)
    gen.manual_seed(27)
    lm = Model(lm_cfg, device=dev).init(gen)
    b, p, new = SHARD_GEN["batch"], SHARD_GEN["prompt"], SHARD_GEN["new"]
    prompts = torch.randint(0, lm_cfg.vocab_size, (b, p),
                            generator=torch.Generator().manual_seed(27))
    gmesh = slab_mesh(torch, dev, (4, 1))
    t1 = time.perf_counter()
    single = serve.generate(lm, prompts, new, p + new)
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t1
    t1 = time.perf_counter()
    shard = serve.generate(lm, prompts, new, p + new, mesh=gmesh)
    torch.cuda.synchronize()
    t_shard = time.perf_counter() - t1
    same = float((single == shard).to(torch.float32).mean())
    # the prefill logits both ways (the tokens' first choice)
    gparams, grules = shard_values(
        {k: v.detach() for k, v in lm.named_parameters()}, lm_cfg, gmesh)
    with torch.no_grad(), lm.compute_cast():
        _, want_pre = lm.prefill({"tokens": prompts.to(dev)}, p + new)
    _, got_pre = steps.build_prefill(lm, p + new, gmesh, grules, gparams)(
        {"tokens": prompts.to(dev)})
    pre_err = rel_to(got_pre, want_pre)
    check(pre_err <= SHARD_BF16_TOL, f"stablelm generate under (4, 1): "
          f"bf16 prefill logits {pre_err:.3e}")
    # open check C: on one device, the batch of 4 against its 4 rows one
    # at a time, which is what each data position of (4, 1) runs; a gap of
    # the sharded one's size (within 2x) clears the sharded layout
    with torch.no_grad(), lm.compute_cast():
        rows = torch.cat([lm.prefill({"tokens": prompts[i:i + 1].to(dev)},
                                     p + new)[1] for i in range(b)])
    rows_err = rel_to(rows, want_pre)
    rows_equal = torch.equal(got_pre.to(rows.device), rows)
    emit("check_c", nvidia_smi=smi_line, arch=lm_cfg.name, dtype=lm_cfg.dtype,
         batch=b, prompt=p, sharded_vs_batch_rel_err=pre_err,
         rows_vs_batch_rel_err=rows_err, ratio=rows_err / pre_err,
         sharded_equals_rows=rows_equal)
    check(pre_err / 2 <= rows_err <= 2 * pre_err,
          f"one device's batch-1 rows {rows_err:.3e} from the batch of "
          f"{b}, the sharded prefill {pre_err:.3e}: not within 2x")
    del lm, gparams, rows
    cfg32 = dataclasses.replace(lm_cfg, n_layers=2, dtype="float32")
    gen.manual_seed(28)
    lm32 = Model(cfg32, device=dev).init(gen)
    toks32 = serve.generate(lm32, prompts, new, p + new)
    same32 = torch.equal(toks32, serve.generate(lm32, prompts, new, p + new,
                                                mesh=gmesh))
    check(same32, "stablelm 2 layers f32 generate under (4, 1): tokens "
          "differ from one device")
    del lm32
    emit("sharded_serve", nvidia_smi=smi_line, arch=cfg.name,
         layers=cfg.n_layers, d_model=cfg.d_model, dtype=cfg.dtype,
         prompt=n, max_len=max_len, mesh=dict(mesh.shape),
         logits_rel_err=errs, tol=SHARD_TOL, generate_arch=lm_cfg.name,
         generate_mesh=dict(gmesh.shape), generate_batch=b,
         generate_new=new, generate_tokens_equal_share=same,
         generate_prefill_rel_err=pre_err, generate_tol=SHARD_BF16_TOL,
         generate_s_single=t_single, generate_s_sharded=t_shard,
         generate_f32_2_layers_tokens_equal=same32,
         seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()


def sharded_mixer(torch, smi_line, dev, d=MIXER_D, batch=MIXER_BATCH,
                  s=MIXER_SEQS[0]):
    """24 (d): the FFTConvMixer's sharded AdamW step at stablelm-1.6b's
    width (D = 2048, B = 4, S = 2048) on (4, 2): one spectral launch a
    data position (4), the gradients within 2e-4 x max|want| of the same
    sharded step through the plain version. Returns the ``kernels``
    record: the four positions' launches, each timed on its own lines."""
    from repro_torch.launch import steps
    from repro_torch.models import fftconv
    from repro_torch.optim import AdamWConfig
    gen = torch.Generator(device=dev)
    gen.manual_seed(240)
    mixer = fftconv.init_fftconv(gen, d, s)
    data = {"x": torch.randn((batch, s, d), generator=gen, device=dev),
            "y": 0.1 * torch.randn((batch, s, d), generator=gen, device=dev)}
    mesh = slab_mesh(torch, dev, (4, 2))
    params, rules = shard_values(
        {n: p.detach() for n, p in mixer.named_parameters()}, None, mesh)
    denom = torch.tensor(float(data["x"].numel()))

    def share(backend):
        def loss(local, leaves, denom):
            y = fftconv.fftconv_forward(leaves, local["x"], backend=backend)
            return ((y - local["y"]) ** 2).sum() / denom
        return loss

    _, got = steps.sharded_value_and_grad(share("kernel"), params, data,
                                          mesh, rules, denom)
    _, want = steps.sharded_value_and_grad(share("plain"), params, data,
                                           mesh, rules, denom)
    grad_err = max(rel_to(got[n].gather(), w.gather())
                   for n, w in want.items())
    check(grad_err <= TOL, f"sharded FFTConvMixer gradients vs plain: "
          f"{grad_err:.3e}")
    del got, want
    step = steps.make_sharded_train_step(
        share("kernel"), params, AdamWConfig(warmup_steps=0), mesh, rules,
        denom_fn=lambda b: torch.tensor(float(b["x"].numel())))
    reset_launch_counts()
    state, stats = step(steps.init_sharded_opt(params), data)
    torch.cuda.synchronize()
    got_counts, want_counts = launch_counts(spectral=4)
    check(got_counts == want_counts, f"sharded FFTConvMixer AdamW step: "
          f"launches {got_counts}")
    loss = float(stats["loss"])
    check(math.isfinite(loss), f"sharded FFTConvMixer step: loss {loss}")
    weights = {n: st.gather() for n, st in params.items()}
    path = (f"FFTConvMixer sharded AdamW step d={d} B={batch} S={s} on "
            "(4, 2) slabs, one launch a data position "
            "(src/repro/models/fftconv.py:44)")
    parts = [mixer_record(torch, weights, data["x"][i:i + 1], 1, path,
                          stockham=False) for i in range(4)]
    rec = dict(parts[0], launches=got_counts["spectral"],
               lines=sum(r["lines"] for r in parts),
               max_abs_err=max(r["max_abs_err"] for r in parts),
               **{k: sum(r[k] for r in parts)
                  for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "bytes", "flops_nominal")})
    rec["vs_library"] = rec["ms"] / rec["library_ms"]
    rec["vs_bound"] = rec["ms"] / rec["bound_ms"]
    emit("sharded_mixer", nvidia_smi=smi_line, d=d, batch=batch, seq=s,
         mesh=dict(mesh.shape), loss=loss,
         grad_norm=float(stats["grad_norm"]), grad_rel_err_vs_plain=grad_err,
         tol=TOL, **rec)
    del mixer, data, params, state, weights
    torch.cuda.empty_cache()
    return [rec]


def decode_logits(torch, prefill, decode, tokens, steps_):
    """Prefill ``tokens`` (B, P) then decode ``steps_`` tokens fed from
    ``steps_`` (B, N) one at a time: every step's logits."""
    cache, logits = prefill({"tokens": tokens})
    out = [logits]
    for i in range(steps_.shape[1]):
        logits, cache = decode(cache, steps_[:, i:i + 1])
        out.append(logits)
    return out, cache


def sharded_tp(torch, smi_line, dev):
    """24 (f): stablelm-1.6b at full width on (1, 4) slabs of the card, its
    one data position computing as 4 ranks. bf16 at full depth: the
    prefill and 8 decode tokens (fed one device's greedy tokens) within
    1e-2 x max|want| of one device, each rank's KV cache its own slab (a
    quarter of the 32 kv heads); at f32, 2 layers, every logit within 1e-5 x
    max|want| and ``generate``'s tokens equal; one bf16 AdamW step (batch
    8, seq 128) timed, its peak. Returns (the step's configuration, its
    peak bytes on the card) for (g)."""
    import dataclasses
    import statistics
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch import serve, steps
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    t0 = time.perf_counter()
    tp = SHARD_TP
    b, p, new = tp["batch"], tp["prompt"], tp["new"]
    cfg = registry.get(SHARD_ARCH)
    mesh = slab_mesh(torch, dev, tp["mesh"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(30)
    model = Model(cfg, device=dev).init(gen)
    prompts = torch.randint(0, cfg.vocab_size, (b, p),
                            generator=torch.Generator().manual_seed(30))
    prompts = prompts.to(dev)
    with torch.no_grad(), model.compute_cast():
        toks = serve.generate(model, prompts, new, p + new)
        want, _ = decode_logits(
            torch, lambda bt: model.prefill(bt, p + new),
            model.decode_step, prompts, toks[:, :new])
    params, rules = shard_values(
        {k: v.detach() for k, v in model.named_parameters()}, cfg, mesh)
    t1 = time.perf_counter()
    got, cache = decode_logits(
        torch, steps.build_prefill(model, p + new, mesh, rules, params),
        steps.build_decode(model, mesh, rules, params), prompts,
        toks[:, :new])
    t_split = time.perf_counter() - t1
    errs = [rel_to(g, w) for g, w in zip(got, want)]
    k = cache["layers"][0]["k"]
    slab_heads = [s.shape[2] for _, s in k.items()]
    check(tuple(k.spec)[2] == "model" and slab_heads == [
        cfg.n_kv_heads // 4] * 4, f"the KV cache's slabs: {k.spec}, "
          f"{slab_heads}")
    del model, params, cache, got, want
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, n_layers=tp["layers32"],
                                dtype="float32")
    gen.manual_seed(31)
    m32 = Model(cfg32, device=dev).init(gen)
    with torch.no_grad():
        want32 = serve.generate(m32, prompts, new, p + new)
        w32, _ = decode_logits(
            torch, lambda bt: m32.prefill(bt, p + new), m32.decode_step,
            prompts, want32[:, :new])
    p32, r32 = shard_values({k: v.detach() for k, v in
                             m32.named_parameters()}, cfg32, mesh)
    g32, _ = decode_logits(
        torch, steps.build_prefill(m32, p + new, mesh, r32, p32),
        steps.build_decode(m32, mesh, r32, p32), prompts, want32[:, :new])
    errs32 = [rel_to(g, w) for g, w in zip(g32, w32)]
    same32 = torch.equal(serve.generate(m32, prompts, new, p + new,
                                        mesh=mesh), want32)
    del m32, p32, g32, w32
    torch.cuda.empty_cache()

    bt, st = tp["train_batch"], tp["train_seq"]
    data = TokenStream(DataConfig(cfg.vocab_size, st, bt, seed=32), dev)
    batches = [data.batch(i) for i in range(3)]
    gen.manual_seed(32)
    model = Model(cfg, device=dev).init(gen)
    params, rules = shard_values(
        {k: v.detach() for k, v in model.named_parameters()}, cfg, mesh)
    del model
    torch.cuda.empty_cache()
    # what the card holds besides the step's slabs (earlier phases' own)
    base = torch.cuda.memory_allocated() - sum(
        st_.nbytes() for st_ in params.values())
    opt_state = steps.init_sharded_opt(params)
    sstep = steps.build_train_step(Model(cfg, device="meta"),
                                   AdamWConfig(warmup_steps=10,
                                               decay_steps=1000),
                                   mesh=mesh, rules=rules, params=params)
    torch.cuda.reset_peak_memory_stats()
    opt_state, ms, losses = timed_steps(torch, sstep, opt_state, batches)
    peak = torch.cuda.max_memory_allocated() - base
    emit("sharded_tp", nvidia_smi=smi_line, arch=cfg.name,
         layers=cfg.n_layers, dtype=cfg.dtype, mesh=dict(mesh.shape),
         batch=b, prompt=p, new=new, logits_rel_err=errs,
         logits_rel_err_max=max(errs), tol=SHARD_TP_TOL,
         err_over_tol=max(errs) / SHARD_TP_TOL, split_decode_s=t_split,
         kv_slab_heads=slab_heads, f32_layers=cfg32.n_layers,
         f32_logits_rel_err_max=max(errs32), f32_tol=SHARD_F32_TOL,
         f32_generate_tokens_equal=same32, train_batch=bt, train_seq=st,
         train_step_ms_first=ms[0], train_step_ms=ms[1:],
         train_step_ms_median=statistics.median(ms[1:]), losses=losses,
         train_peak_gib=peak / 2 ** 30,
         train_peak_gib_a_rank=peak / 4 / 2 ** 30,
         seconds=time.perf_counter() - t0)
    check(max(errs) <= SHARD_TP_TOL, f"stablelm (1, 4) bf16 logits vs one "
          f"device: {errs}")
    check(max(errs32) <= SHARD_F32_TOL and same32, f"stablelm (1, 4) f32 "
          f"2 layers: logits {max(errs32):.3e}, tokens equal {same32}")
    check(all(math.isfinite(x) for x in losses), f"(1, 4) step: {losses}")
    del params, opt_state, sstep, batches
    torch.cuda.empty_cache()
    return dict(cfg=cfg, batch=bt, seq=st), peak


def sharded_dryrun_check(torch, smi_line, step, measured):
    """24 (g): the dry run's count of (f)'s train step on a (1, 4) meta
    mesh (the view of the first rank's device): its argument and temp
    bytes, beside the card's peak / 4 (the four ranks' slabs and work on
    one card)."""
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as lm
    mesh = lm.make_host_mesh(4, [torch.device("meta")] * 4)
    rules = lm.activation_rules(mesh)
    shape = registry.ShapeSpec("train", step["seq"], step["batch"], "train")
    fn, args, held, params = dryrun._cell(step["cfg"], shape, mesh, rules)
    counter, _, secs = dryrun.count_step(fn, args, mesh, rules, params)
    dev = counter.devices[counter.home]
    predicted = held + dev.peak
    per_device = measured / 4
    err = (predicted - per_device) / per_device
    emit("sharded_dryrun_check", nvidia_smi=smi_line,
         arch=step["cfg"].name, mesh={"data": 1, "model": 4},
         batch=step["batch"], seq=step["seq"], argument_bytes=held,
         temp_bytes=dev.peak, predicted_peak_bytes=predicted,
         measured_card_peak_bytes=measured,
         measured_peak_bytes_a_device=per_device,
         predicted_peak_gib=predicted / 2 ** 30,
         measured_peak_gib_a_device=per_device / 2 ** 30,
         peak_rel_err=err, tol=SHARD_DRYRUN_TOL,
         flops_a_device=dev.flops, trace_seconds=secs)
    return err


def sharded_lm_phase(torch, smi_line):
    """Phase 24: the LM stack over a mesh of slabs of the one card.
    Returns the ``kernels`` records (the mixer's sharded step)."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    seconds = {}
    t0 = time.perf_counter()
    sharded_full(torch, smi_line, dev)
    seconds["a_full"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded_f32(torch, smi_line, dev)
    seconds["b_f32"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded_serve(torch, smi_line, dev)
    seconds["c_serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    records = sharded_mixer(torch, smi_line, dev)
    seconds["d_mixer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    step, peak = sharded_tp(torch, smi_line, dev)
    seconds["f_tp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded_dryrun_check(torch, smi_line, step, peak)
    seconds["g_dryrun"] = time.perf_counter() - t0
    total = sum(seconds.values())
    emit("sharded_seconds", nvidia_smi=smi_line, total=total,
         limit=SHARD_SECONDS, **seconds)
    check(total <= SHARD_SECONDS, f"phase 24 took {total:.1f} s")
    return records


TP_MIX_SECONDS = 150   # phase 25's time limit (f)
# 25 (a): granite's 40 experts on 16 ranks: the ``ff`` route. The bf16
# update's check runs 2 periods deep (``update_periods``), (c)'s 8 and 1:
# at one period partial sums rounded to bf16 move granite's update by
# 0.96 % of its largest move and falcon's by 0.50 %, inside the 1e-2 bar
# the control must miss; at 2 / 8 periods by 21.64 % / 3.88 % (falcon at
# 2, 4: 0.68, 1.26 %); recurrentgemma's by 1.39 % at one period, the most
# the card holds of its step's snapshots (scripts/tp_update_probe.py, H100
# 80GB HBM3, 700.00 W).
TP_MIX_MOE = dict(arch="granite-moe-3b-a800m", mesh=(1, 16), batch=4,
                  seq=128, prompt=32, new=8, update_periods=2)
# 25 (b): llama4's 16 experts on 8 ranks: expert parallel. Two layers:
# 2 x 2.20e9 + 2 x 1.03e9 (embedding, head) parameters, 25.8 GB at f32,
# held once as one device's weights and once as the ranks' slabs (51.7
# GB), plus 12.9 GB of bf16 compute copies; a third layer (+8.8 GB twice)
# does not fit the card's 79.2 GiB beside them
TP_MIX_EP = dict(arch="llama4-scout-17b-a16e", mesh=(1, 8), layers=2,
                 batch=4, prompt=16, new=4)
# 25 (c): the recurrent mixers' channels on 4 ranks
TP_MIX_REC = dict(archs=("falcon-mamba-7b", "recurrentgemma-9b"),
                  mesh=(1, 4), batch=4, seq=128, prompt=16, new=4,
                  update_periods={"falcon-mamba-7b": 8,
                                  "recurrentgemma-9b": 1})
# 25 (d): whisper's 6 heads on 2 ranks
TP_MIX_CROSS = dict(arch="whisper-tiny", mesh=(1, 2), batch=4, prompt=16,
                    new=8)


def period_cfg(arch, periods=1, **changes):
    """``arch``'s full configuration cut to ``periods`` pattern periods."""
    import dataclasses
    from repro_torch.configs import registry
    cfg = registry.get(arch)
    return dataclasses.replace(cfg, n_layers=periods * len(cfg.pattern),
                               **changes)


class CudaClock:
    """CUDA-event ms and the peak bytes allocated above what was allocated
    at the start, of the work inside."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        torch = self.torch
        torch.cuda.synchronize()
        self.base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record()
        return self

    def __exit__(self, *exc):
        torch = self.torch
        self.end.record()
        torch.cuda.synchronize()
        self.ms = self.start.elapsed_time(self.end)
        self.peak_gib = (torch.cuda.max_memory_allocated()
                         - self.base) / 2 ** 30


def split_association(torch, m, cfg):
    """Patches that make one device compute as a (1, ``m``) mesh's ranks
    do, rank by rank, and sum every contraction they split as they sum
    it: each layer's input and each weight a rank gathers whole is copied
    once a rank (``Fork``: the ranks' gradients of the copies summed in
    float32 in rank order, rounded once, as the group's all-gather
    transposes them); each rank's products take its slices (heads,
    ``ff`` columns, channels, vocabulary rows) apart; the partial sums of
    a row-parallel product are added in float32 in rank order and
    rounded once; a rank keeps its slice of the sequence. Attention (its
    heads, or, where they do not divide ``m``, whole on every rank),
    the MLP and the vocabulary-parallel loss as ``same_association``
    (or the loss of each rank's own tokens against the whole table);
    the ``ff``-parallel experts (each rank routing the tokens whole, its
    ``ff`` columns of every expert, the partial outputs summed and
    rounded once, each rank combining its columns of D);
    Mamba (its ``in_proj`` columns of both halves, its channels' conv and
    scan, ``x_proj``'s partial sums all-reduced, ``out_proj``
    row-parallel); RG-LRU (its channels, ``xc`` gathered for its ``wa``
    / ``wx`` columns, ``out_proj`` row-parallel). A weight whole over
    "model" that a rank casts to the compute dtype itself (the router, a
    table whose vocabulary does not divide ``m``: the embedding looked up
    whole, each rank keeping its slice) is kept float32 in the compute
    copy and forked there, each copy cast once a rank (``copies``), as
    the ranks sum its float32 gradients."""
    from repro_torch.models import attention, layers, moe, recurrent
    from repro_torch.models import model as model_mod
    whole_table = cfg.vocab_size % m != 0
    memo = {}

    class Fork(torch.autograd.Function):
        """``x`` once a rank; the ranks' gradients summed in float32 in
        rank order, rounded once (the group's all-gather transposed)."""

        @staticmethod
        def forward(ctx, x):
            return tuple(x.view_as(x) for _ in range(m))

        @staticmethod
        def backward(ctx, *gs):
            total = gs[0].float()
            for g in gs[1:]:
                total = total + g.float()
            return total.to(gs[0].dtype)

    def cols(w, r):
        n = w.shape[-1] // m
        return w[..., r * n:(r + 1) * n].contiguous()

    def rows(w, r, dim=0):
        n = w.shape[dim] // m
        return w.narrow(dim, r * n, n).contiguous()

    def reduce(parts, dt=None):
        total = parts[0]
        for y in parts[1:]:
            total = total + y
        return total if dt is None else total.to(dt)

    def copies(w, dt):
        """A float32 weight's compute copy once a rank (made on first use,
        kept for the step's other uses of it)."""
        if w.dtype == dt:
            return Fork.apply(w)
        if id(w) not in memo:
            memo[id(w)] = [c.to(dt) for c in Fork.apply(w)]
        return memo[id(w)]

    cast_params = model_mod.cast_params_for_compute

    def cast_params_for_compute(params, dtype):
        """The compute copy, the router and a whole table kept float32."""
        tree = cast_params(params, dtype)
        source = cast_params(params, "float32")

        def keep(t, src, path):
            if isinstance(t, dict):
                return {k: keep(t[k], src[k], path + (k,)) for k in t}
            if isinstance(t, (list, tuple)):
                return [keep(a, b, path) for a, b in zip(t, src)]
            if path[-1] == "router" or (whole_table and path[-1] == "table"):
                return src
            return t
        return keep(tree, source, ())

    def embed(p, tokens, dtype):
        tables = copies(p["table"], dtype)
        return seq_slices([tables[r][tokens] for r in range(m)])

    def seq_slices(ys):
        """Each rank's slice of the sequence of its whole ``ys[r]``."""
        n = ys[0].shape[1] // m
        return torch.cat([y[:, r * n:(r + 1) * n] for r, y in
                          enumerate(ys)], 1)

    same = {(mod, name): fn for mod, name, fn in same_association(torch, m)}
    attention_forward = attention.attn_forward

    def attn_forward(p, spec, x, positions, k_pos=None, xkv=None):
        assert xkv is None and k_pos is None
        dt = x.dtype
        xs = Fork.apply(x)
        if spec.n_heads % m:                 # whole on every rank
            ws = {k: Fork.apply(layers.cast(p[k], dt))
                  for k in ("wq", "wk", "wv", "wo")}
            outs = [attention_forward({k: w[r] for k, w in ws.items()},
                                      spec, xs[r], positions)
                    for r in range(m)]
            return seq_slices([y for y, _ in outs]), outs[0][1]
        hq, dh = spec.n_heads // m, spec.head_dim
        local = spec.n_kv % m == 0
        assert local or dh % m == 0
        w = {k: layers.cast(p[k], dt) for k in ("wq", "wk", "wv", "wo")}
        q, kp, vp = [], [], []
        for r in range(m):
            q.append(attention._split_heads(xs[r] @ cols(w["wq"], r), hq,
                                            dh))
            kp.append(xs[r] @ cols(w["wk"], r))
            vp.append(xs[r] @ cols(w["wv"], r))
        if not local:
            kp = Fork.apply(torch.cat(kp, -1))
            vp = Fork.apply(torch.cat(vp, -1))
        nk = spec.n_kv // m if local else spec.n_kv
        pos = positions if positions.ndim == 2 else positions[..., 0]
        mask = attention._score_mask(pos, pos, spec.causal, spec.window)
        g = spec.n_heads // spec.n_kv
        parts = []
        for r in range(m):
            k = attention._split_heads(kp[r], nk, dh)
            v = attention._split_heads(vp[r], nk, dh)
            qr = q[r]
            if spec.use_rope:
                qr = layers.apply_rope(qr, layers.rope_angles(
                    positions, dh, spec.theta, spec.sections))
                k = layers.apply_rope(k, layers.rope_angles(
                    positions, dh, spec.theta, spec.sections))
            if not local:              # attention._kv_select
                idx = [(r * hq + j) // g for j in range(hq)]
                run = sorted(set(idx))
                if hq % len(run) == 0 and idx == [
                        h for h in run for _ in range(hq // len(run))]:
                    idx = slice(run[0], run[-1] + 1)
                k, v = k[:, :, idx], v[:, :, idx]
            o = attention.sdpa(qr, k, v, mask, spec.q_chunk)
            parts.append(layers.matmul_f32(o.reshape(*o.shape[:2], -1),
                                           rows(w["wo"], r)))
        return reduce(parts, dt), (None, None)

    def moe_ffn(p, x, mcfg, act="silu", train=True):
        assert not mcfg.shared_expert
        dt = x.dtype
        xs = Fork.apply(x)
        routers = copies(p["router"], dt)
        routed = [moe._dispatch({**p, "router": routers[r]}, xs[r], mcfg,
                                "ff", None) for r in range(m)]
        wg, wu, wo = (layers.cast(p[k], dt)
                      for k in ("wi_gate", "wi_up", "wo"))
        partials = []
        for r in range(m):
            xe = routed[r]["xe"]
            e, g, c, _ = xe.shape
            h = layers.ACTS[act](torch.einsum("egcd,edf->egcf", xe,
                                              cols(wg, r)))
            h = h * torch.einsum("egcd,edf->egcf", xe, cols(wu, r))
            partials.append(layers.matmul_f32(h.reshape(e, g * c, -1),
                                              rows(wo, r, 1)))
        ye = reduce(partials, dt).reshape(e, g, c, -1)
        outs = [moe._combine(p, routed[r], cols(ye, r), mcfg, act, False)
                for r in range(m)]
        y = torch.cat([y for y, _ in outs], -1)
        return seq_slices([y] * m), outs[0][1]

    def lm_loss_chunked(x, table, labels, mask=None, chunk=512, z_loss=0.0,
                        denom=None):
        if cfg.vocab_size % m == 0:
            return same[model_mod, "lm_loss_chunked"](
                x, table, labels, mask, chunk, z_loss, denom)
        assert mask is None
        dt = x.dtype
        b, s, _ = x.shape
        denom = float(b * s) if denom is None else denom
        xs = Fork.apply(x)
        tables = copies(table, dt)
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
        totals = []
        for r in range(m):
            lo0, hi0 = r * s // m, (r + 1) * s // m
            totals.append(layers._chunked(
                layers._nll_sum(tables[r], z_loss), hi0 - lo0, chunk,
                x.device, lambda lo, hi, r=r, lo0=lo0: (
                    xs[r][:, lo0 + lo:lo0 + hi],
                    labels[:, lo0 + lo:lo0 + hi],
                    mask[:, lo0 + lo:lo0 + hi])) / denom)
        return torch.stack(totals).sum()

    def mamba_forward(p, x, scfg, chunk=128, h0=None):
        assert h0 is None
        dt = x.dtype
        xs = Fork.apply(x)
        w = layers.cast(p["in_proj"], dt)
        di = w.shape[1] // 2
        c = di // m
        conv = {k: layers.cast(p["conv"][k], dt) for k in ("w", "b")}
        xp = layers.cast(p["x_proj"], dt)
        xin, z, xc, partials = [], [], [], []
        for r in range(m):
            both = torch.cat([w[:, r * c:(r + 1) * c],
                              w[:, di + r * c:di + (r + 1) * c]], 1)
            a, b = torch.chunk(xs[r] @ both, 2, dim=-1)
            xin.append(a)
            z.append(b)
            xc.append(torch.nn.functional.silu(recurrent.conv1d(
                {"w": cols(conv["w"], r), "b": rows(conv["b"], r)}, a)))
            partials.append(layers.matmul_f32(xc[r], rows(xp, r)))
        projs = Fork.apply(reduce(partials))
        dtr = p["dt_proj"]["w"].shape[0]
        n = scfg.state_dim
        wd = layers.cast(p["dt_proj"]["w"], dt)
        outs, hs = [], []
        for r in range(m):
            proj = projs[r].to(dt)
            dt_in, b_in, c_out = torch.split(
                proj, [dtr, n, proj.shape[-1] - dtr - n], dim=-1)
            dtr_ = torch.nn.functional.softplus(
                (dt_in @ cols(wd, r)).to(torch.float32)
                + rows(p["dt_proj"]["b"], r))
            y, h = recurrent._mamba_scan(
                {"a_log": rows(p["a_log"], r),
                 "d_skip": rows(p["d_skip"], r)}, xc[r], z[r], dtr_,
                b_in.to(torch.float32), c_out.to(torch.float32), scfg, chunk)
            outs.append(layers.matmul_f32(y, rows(layers.cast(
                p["out_proj"], dt), r)))
            hs.append(h)
        buf = torch.cat([a[:, -(scfg.conv_width - 1):] for a in xin], -1)
        return reduce(outs, dt), (torch.cat(hs, 1), buf.to(torch.float32))

    def rglru_forward(p, x, rcfg, h0=None, chunk=512):
        assert h0 is None
        dt = x.dtype
        xs = Fork.apply(x)
        gp, rp, wa, wx, wo = (layers.cast(p[k], dt) for k in (
            "gate_proj", "rec_proj", "wa", "wx", "out_proj"))
        conv = {k: layers.cast(p["conv"][k], dt) for k in ("w", "b")}
        gate, xr, xc = [], [], []
        for r in range(m):
            gate.append(recurrent._gelu(xs[r] @ cols(gp, r)))
            xr.append(xs[r] @ cols(rp, r))
            xc.append(recurrent.conv1d(
                {"w": cols(conv["w"], r), "b": rows(conv["b"], r)}, xr[r]))
        xw = Fork.apply(torch.cat(xc, -1))
        outs, hs = [], []
        for r in range(m):
            a, b = recurrent._rglru_gates(
                {"lambda": rows(p["lambda"], r)}, xc[r], xw[r] @ cols(wa, r),
                xw[r] @ cols(wx, r), rcfg)
            h0r = torch.zeros((x.shape[0], a.shape[-1]), dtype=torch.float32,
                              device=x.device)
            h, last = recurrent.chunked_linear_scan(a, b, chunk, h0r)
            outs.append(layers.matmul_f32(h.to(dt) * gate[r], rows(wo, r)))
            hs.append(last)
        buf = torch.cat([t[:, -(rcfg.conv_width - 1):] for t in xr], -1)
        return reduce(outs, dt), (torch.cat(hs, -1), buf.to(torch.float32))

    out = [(attention, "attn_forward", attn_forward),
           (model_mod, "lm_loss_chunked", lm_loss_chunked),
           (model_mod, "cast_params_for_compute", cast_params_for_compute)]
    if whole_table:
        out.append((model_mod, "embed", embed))
    if cfg.ffn == "mlp" and cfg.d_ff % m == 0:
        out.append((model_mod, "mlp", same[model_mod, "mlp"]))
    if cfg.moe is not None:
        assert cfg.moe.n_experts % m and cfg.d_ff % m == 0
        out.append((model_mod, "moe_ffn", moe_ffn))
    if cfg.ssm is not None:
        out.append((recurrent, "mamba_forward", mamba_forward))
    if cfg.rglru is not None:
        out.append((recurrent, "rglru_forward", rglru_forward))
    return out


def tp_mixers_grads(torch, dev, cfg, shape, b, s, seed):
    """One f32 train step's loss and gradients over a (1, M) mesh of
    slabs of the card against one device's, within 1e-5 x max|want|,
    each with its ms and peak GiB."""
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch import steps
    from repro_torch.models import Model
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = Model(cfg, device=dev).init(gen)
    batch = TokenStream(DataConfig(cfg.vocab_size, s, b, seed=seed),
                        dev).batch(0)
    with CudaClock(torch) as one:
        loss = model.loss(batch)
        loss.backward()
    want = {n: p.grad for n, p in model.named_parameters()}
    mesh = slab_mesh(torch, dev, shape)
    params, rules = shard_values(
        {n: p.detach() for n, p in model.named_parameters()}, cfg, mesh)
    with CudaClock(torch) as split:
        got, grads = steps.lm_value_and_grad(
            Model(cfg, device="meta"), params, batch, mesh, rules)
    err = max(rel_to(grads[n].gather(), w) for n, w in want.items())
    loss_err = abs(float(got) - float(loss.detach())) / abs(float(loss.detach()))
    del model, want, params, grads
    torch.cuda.empty_cache()
    check(err <= SHARD_F32_TOL and loss_err <= SHARD_F32_TOL,
          f"{cfg.name} f32 gradients on {shape}: {err:.3e}, loss "
          f"{loss_err:.3e}")
    return dict(grad_rel_err=err, loss_rel_err=loss_err, tol=SHARD_F32_TOL,
                batch=b, seq=s, grad_ms_single=one.ms,
                grad_ms_split=split.ms, grad_peak_gib_single=one.peak_gib,
                grad_peak_gib_split=split.peak_gib)


def tp_mixers_update(torch, dev, cfg, shape, b, s, seed):
    """One bf16 AdamW step from non-zero moments over a (1, M) mesh of
    slabs against one device summing every split contraction as the ranks
    sum it (``split_association``): the update p - p0 within 1e-2 x its
    largest, and the control (partial sums rounded to bf16 before their
    reduction) outside that bar; the update against one device's own step
    beside them, each step's ms and peak GiB."""
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.distributed import mesh as M
    from repro_torch.launch import steps
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = Model(cfg, device=dev).init(gen)
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = TokenStream(DataConfig(cfg.vocab_size, s, b, seed=seed),
                        dev).batch(0)
    loss = model.loss(batch)
    loss.backward()
    state0 = conditioned_state(torch, {n: p.grad for n, p in
                                       model.named_parameters()}, 4, dev)
    model.zero_grad(set_to_none=True)
    del loss
    opt = AdamWConfig(warmup_steps=10, decay_steps=1000)

    def fresh():
        state = {k: {n: t.clone() for n, t in state0[k].items()}
                 for k in ("mu", "nu")}
        state["step"] = state0["step"].clone()
        return state

    def sharded_state(params):
        state = {k: {n: M.distribute(t, params[n].sharding)
                     for n, t in state0[k].items()} for k in ("mu", "nu")}
        state["step"] = state0["step"].clone()
        return state

    def err_to(params, want):
        return max(float((params[n].gather(dev) - w).abs().max())
                   for n, w in want.items())

    m = shape[1]
    with CudaClock(torch) as one:
        steps.build_train_step(model, opt)(fresh(), batch)
    want = {n: p.detach().clone() for n, p in model.named_parameters()}
    moved = max(float((w - p0[n]).abs().max()) for n, w in want.items())
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(p0[n])
    with patched(split_association(torch, m, cfg)):
        steps.build_train_step(model, opt)(fresh(), batch)
    same = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model
    torch.cuda.empty_cache()
    mesh = slab_mesh(torch, dev, shape)
    params, rules = shard_values(p0, cfg, mesh)
    meta = Model(cfg, device="meta")
    state = sharded_state(params)
    with CudaClock(torch) as split:
        steps.build_train_step(meta, opt, mesh=mesh, rules=rules,
                               params=params)(state, batch)
    same_err, plain_err = err_to(params, same), err_to(params, want)
    del params, state
    params, rules = shard_values(p0, cfg, mesh)
    with patched(partial_sums_in_bf16(torch)):
        steps.build_train_step(meta, opt, mesh=mesh, rules=rules,
                               params=params)(sharded_state(params), batch)
    control_err = err_to(params, same)
    del params, p0, want, same, state0
    torch.cuda.empty_cache()
    rec = dict(update_max_abs=moved, update_rel_err_same=same_err / moved,
               update_rel_err_single=plain_err / moved,
               control_bf16_partials_rel_err=control_err / moved,
               update_tol=SHARD_UPDATE_TOL, step_ms_single=one.ms,
               step_ms_split=split.ms, step_peak_gib_single=one.peak_gib,
               step_peak_gib_split=split.peak_gib)
    emit("tp_mixers_update", arch=cfg.name, layers=cfg.n_layers,
         mesh=list(shape), batch=b, seq=s, **rec)
    check(same_err <= SHARD_UPDATE_TOL * moved,
          f"{cfg.name} split update vs the same association: "
          f"{same_err:.3e} of a largest move {moved:.3e}")
    check(control_err > SHARD_UPDATE_TOL * moved,
          f"{cfg.name}: the update bar misses partial sums rounded to "
          f"bf16: {control_err:.3e} of a largest move {moved:.3e}")
    return rec


def tp_mixers_serve(torch, dev, cfg, shape, b, p, new, seed, tol):
    """Prefill ``p`` tokens and ``new`` decode steps (fed one device's
    greedy tokens) over a (1, M) mesh of slabs against one device: every
    logit within ``tol`` x max|want|, the greedy tokens equal; and what
    each rank reads after the prefill: its channel slice of each
    recurrent state (of its own copy), its heads of each cross cache.
    Returns (record, the split's cache)."""
    from repro_torch.launch import serve, steps
    from repro_torch.models import Model
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = Model(cfg, device=dev).init(gen)
    prompts = torch.randint(0, cfg.vocab_size, (b, p),
                            generator=torch.Generator().manual_seed(seed))
    prompts = prompts.to(dev)
    max_len = p + new

    def frames(fn):
        if not cfg.is_encoder_decoder:
            return fn
        f = torch.zeros((b, cfg.encoder.n_frames, cfg.d_model),
                        device=dev)
        return lambda bt: fn(dict(bt, frames=f))

    with torch.no_grad(), model.compute_cast():
        toks = serve.generate(model, prompts, new, max_len)
        with CudaClock(torch) as one:
            want, _ = decode_logits(
                torch, frames(lambda bt: model.prefill(bt, max_len)),
                model.decode_step, prompts, toks[:, :new])
    mesh = slab_mesh(torch, dev, shape)
    params, rules = shard_values(
        {k: v.detach() for k, v in model.named_parameters()}, cfg, mesh)
    with CudaClock(torch) as split:
        got, cache = decode_logits(
            torch, frames(steps.build_prefill(model, max_len, mesh, rules,
                                              params)),
            steps.build_decode(model, mesh, rules, params), prompts,
            toks[:, :new])
    errs = [rel_to(g, w) for g, w in zip(got, want)]
    greedy = torch.stack([g.argmax(-1) for g in got[:new]], 1)
    views = rank_views(torch, cfg, cache, shape[1], dev)
    del model, params, got, want
    torch.cuda.empty_cache()
    check(max(errs) <= tol and torch.equal(greedy, toks),
          f"{cfg.name} on {shape}: logits {max(errs):.3e} (bar {tol}), "
          f"greedy tokens equal {torch.equal(greedy, toks)}")
    return dict(prompt=p, new=new, logits_rel_err_max=max(errs),
                logits_tol=tol, greedy_tokens_equal=True,
                decode_ms_single=one.ms, decode_ms_split=split.ms,
                decode_peak_gib_single=one.peak_gib,
                decode_peak_gib_split=split.peak_gib, rank_views=views)


def rank_views(torch, cfg, cache, m, dev):
    """Each rank's view of the cache (``launch.steps.local_cache``): a
    recurrent state's channels are the rank's slice of its own copy, a
    cross cache's kv heads the rank's slab where they divide; checked,
    and returned as the channels / heads a rank reads."""
    from repro_torch.launch import steps
    from repro_torch.models import recurrent as rec
    out = {}
    for r in range(m):
        view = steps.local_cache(cache, {}, dev, r)
        for i, kind in enumerate(cfg.layer_kinds):
            if kind not in ("mamba", "rglru"):
                continue
            for k, d in enumerate(rec.STATE_CHANNEL_DIMS):
                st, part = cache["layers"][i][k], view["layers"][i][k]
                n = st.shape[d] // m
                own = st.slabs[0, r].narrow(d, r * n, n)
                check(part.shape[d] == n and part.data_ptr()
                      == own.data_ptr(), f"rank {r}'s view of layer {i}'s "
                      f"state: {tuple(part.shape)}")
                out["state_channels_a_rank"] = n
        if cfg.is_encoder_decoder:
            k = cache["cross"][0]["k"]
            part = view["cross"][0]["k"]
            check(cfg.n_kv_heads % m == 0 and part.shape[2]
                  == cfg.n_kv_heads // m and part.data_ptr()
                  == k.slabs[0, r].data_ptr(), f"rank {r}'s cross cache: "
                  f"{tuple(part.shape)}")
            out["cross_kv_heads_a_rank"] = part.shape[2]
    return out


def tp_mixers_moe(torch, smi_line, dev):
    """25 (a): granite-moe-3b at full width, one pattern period, on (1,
    16): 40 experts do not divide 16, so each rank holds its 32 ``ff``
    columns of every expert."""
    c = TP_MIX_MOE
    cfg32 = period_cfg(c["arch"], dtype="float32")
    check(cfg32.moe.n_experts % c["mesh"][1] != 0
          and cfg32.d_ff % c["mesh"][1] == 0, "granite is not ff-parallel")
    rec = tp_mixers_grads(torch, dev, cfg32, c["mesh"], c["batch"],
                          c["seq"], 40)
    rec.update(tp_mixers_update(
        torch, dev, period_cfg(c["arch"], c["update_periods"]), c["mesh"],
        c["batch"], c["seq"], 46))
    cfg = period_cfg(c["arch"])
    serve_rec = tp_mixers_serve(torch, dev, cfg, c["mesh"], c["batch"],
                                c["prompt"], c["new"], 42, SHARD_TP_TOL)
    emit("tp_mixers_moe", nvidia_smi=smi_line, arch=cfg.name,
         layers=cfg.n_layers, mesh=dict(zip(("data", "model"), c["mesh"])),
         route="ff", experts=cfg.moe.n_experts, ff_a_rank=cfg.d_ff // 16,
         rank_threads=c["mesh"][1], **rec, serve=serve_rec)


def tp_mixers_ep(torch, smi_line, dev):
    """25 (b): llama4-scout at full width, 2 layers (local attention, each
    with its MoE and shared expert), on (1, 8): 16 experts, 2 a rank, and
    40 heads, 5 a rank. At f32 the prefill of 16 tokens and 4 decode
    steps, every logit within 1e-5 x max|want| of one device and the
    greedy tokens equal; whether the bf16 prefill's logits are one
    device's bit for bit (reported)."""
    import dataclasses
    from repro_torch.launch import serve, steps
    from repro_torch.models import Model
    c = TP_MIX_EP
    full = period_cfg(c["arch"])
    cfg32 = dataclasses.replace(full, n_layers=c["layers"],
                                dtype="float32")
    cfg16 = dataclasses.replace(cfg32, dtype=full.dtype)
    m = c["mesh"][1]
    check(cfg32.moe.n_experts % m == 0 and cfg32.n_heads % m == 0
          and cfg32.moe.shared_expert and cfg32.ffn == "moe",
          "llama4 is not expert parallel with its shared expert")
    b, p, new = c["batch"], c["prompt"], c["new"]
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(43)
    model = Model(cfg32, device=dev).init(gen)
    prompts = torch.randint(0, cfg32.vocab_size, (b, p),
                            generator=torch.Generator().manual_seed(43))
    prompts = prompts.to(dev)
    with torch.no_grad():
        toks = serve.generate(model, prompts, new, p + new)
        with CudaClock(torch) as one:
            want, _ = decode_logits(
                torch, lambda bt: model.prefill(bt, p + new),
                model.decode_step, prompts, toks[:, :new])
        meta16 = Model(cfg16, device="meta")
        tree = meta16.compute_params(dict(model.named_parameters()))
        want16 = meta16.prefill({"tokens": prompts}, p + new,
                                params=tree)[1]
        del tree
    torch.cuda.empty_cache()
    mesh = slab_mesh(torch, dev, c["mesh"])
    params, rules = shard_values(
        {k: v.detach() for k, v in model.named_parameters()}, cfg32, mesh)
    card_gib = torch.cuda.memory_allocated() / 2 ** 30
    with CudaClock(torch) as split:
        got, _ = decode_logits(
            torch, steps.build_prefill(model, p + new, mesh, rules, params),
            steps.build_decode(model, mesh, rules, params), prompts,
            toks[:, :new])
    errs = [rel_to(g, w) for g, w in zip(got, want)]
    greedy = torch.stack([g.argmax(-1) for g in got[:new]], 1)
    got16 = steps.build_prefill(meta16, p + new, mesh, rules, params)(
        {"tokens": prompts})[1]
    same16 = torch.equal(got16, want16)
    err16 = rel_to(got16, want16)
    del model, params, got, want, got16, want16
    torch.cuda.empty_cache()
    emit("tp_mixers_ep", nvidia_smi=smi_line, arch=cfg32.name,
         layers=cfg32.n_layers, mesh=dict(zip(("data", "model"), c["mesh"])),
         route="experts", experts_a_rank=cfg32.moe.n_experts // m,
         heads_a_rank=cfg32.n_heads // m, batch=b, prompt=p, new=new,
         logits_rel_err=errs, logits_rel_err_max=max(errs),
         tol=SHARD_F32_TOL, greedy_tokens_equal=torch.equal(greedy, toks),
         bf16_prefill_logits_equal=same16, bf16_prefill_rel_err=err16,
         weights_and_slabs_gib=card_gib, decode_ms_single=one.ms,
         decode_ms_split=split.ms, decode_peak_gib_single=one.peak_gib,
         decode_peak_gib_split=split.peak_gib, rank_threads=m)
    check(max(errs) <= SHARD_F32_TOL and torch.equal(greedy, toks),
          f"llama4 (1, 8) f32: logits {max(errs):.3e}, greedy tokens "
          f"equal {torch.equal(greedy, toks)}")


def tp_mixers_rec(torch, smi_line, dev):
    """25 (c): falcon-mamba-7b (1 layer) and recurrentgemma-9b (2 RG-LRU
    layers and a local attention layer) at full width on (1, 4): the
    gradients at f32, the prefill and decode at f32 (each rank's state its
    channel slice), one bf16 AdamW step's update and its control."""
    import dataclasses
    c = TP_MIX_REC
    for arch in c["archs"]:
        cfg = period_cfg(arch)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        rec = tp_mixers_grads(torch, dev, cfg32, c["mesh"], c["batch"],
                              c["seq"], 44)
        rec["serve"] = tp_mixers_serve(torch, dev, cfg32, c["mesh"],
                                       c["batch"], c["prompt"], c["new"],
                                       45, SHARD_F32_TOL)
        rec.update(tp_mixers_update(
            torch, dev, period_cfg(arch, c["update_periods"][arch]),
            c["mesh"], c["batch"], c["seq"], 46))
        emit("tp_mixers_rec", nvidia_smi=smi_line, arch=cfg.name,
             layers=cfg.n_layers, mesh=dict(zip(("data", "model"),
                                                c["mesh"])),
             rank_threads=c["mesh"][1], **rec)


def tp_mixers_cross(torch, smi_line, dev):
    """25 (d): whisper-tiny at full depth on (1, 2), where its 6 heads
    divide: ``generate`` at f32 gives one device's tokens, and each rank
    reads its own 3 heads of the cross cache."""
    import dataclasses
    from repro_torch.configs import registry
    c = TP_MIX_CROSS
    cfg = dataclasses.replace(registry.get(c["arch"]), dtype="float32")
    check(cfg.n_heads % c["mesh"][1] == 0, "whisper's heads do not divide")
    rec = tp_mixers_serve(torch, dev, cfg, c["mesh"], c["batch"],
                          c["prompt"], c["new"], 47, SHARD_F32_TOL)
    emit("tp_mixers_cross", nvidia_smi=smi_line, arch=cfg.name,
         layers=cfg.n_layers, mesh=dict(zip(("data", "model"), c["mesh"])),
         rank_threads=c["mesh"][1], **rec)


def sharded_mixers_phase(torch, smi_line):
    """Phase 25: MoE, the recurrent mixers and cross-attention split over
    "model" on meshes of slabs of the one card."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    seconds = {}
    for part, fn in (("a_moe", tp_mixers_moe), ("b_ep", tp_mixers_ep),
                     ("c_rec", tp_mixers_rec), ("d_cross", tp_mixers_cross)):
        t0 = time.perf_counter()
        fn(torch, smi_line, dev)
        seconds[part] = time.perf_counter() - t0
    total = sum(seconds.values())
    emit("tp_mixers_seconds", nvidia_smi=smi_line, total=total,
         limit=TP_MIX_SECONDS, **seconds)
    check(total <= TP_MIX_SECONDS, f"phase 25 took {total:.1f} s")


def replay_plain(pipe, x):
    """The compiled steps through the plain versions, on the card: a
    spectral step through ``spectral_op_plain``, a transpose through
    ``transpose_plain``, the sinc RCMC (plain PyTorch already) through its
    own ``fn``."""
    from repro_torch.core import plan as planlib
    from repro_torch.kernels import ops, transpose
    for s in pipe.steps:
        if s.kind == "spectral":
            xr, xi = planlib.split(x)
            x = planlib.unsplit(*ops.spectral_op_plain(
                xr, xi, **s.filter_kw, **s.kernel_kw))
        elif s.kind == "transpose":
            x = transpose.transpose_plain(x)
        else:
            x = s.fn(x)
    return x


def main() -> int:
    import tempfile

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # tune="cached" is the compile default: every compile reads an empty
    # tuning cache of this run's own (phase 16 searches in another), so
    # what the user's cache holds never reaches a check
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
            tmp, "autotune_cache.json")
        return run(torch)


def part_clock(number):
    """``lap(part)``: emits the seconds since the clock started or since
    the last lap as a ``phase_seconds`` line of phase ``number``'s
    ``part``, and returns them."""
    last = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        seconds = now - last[0]
        emit("phase_seconds", number=number, part=part, seconds=seconds)
        last[0] = now
        return seconds
    return lap


def phase_clock():
    """``lap(number)``: emits the seconds since the clock started or since
    the last lap as that phase's ``phase_seconds`` line."""
    last = [time.perf_counter()]

    def lap(number):
        now = time.perf_counter()
        emit("phase_seconds", number=number, seconds=now - last[0])
        last[0] = now
    return lap


def run(torch) -> int:
    """Phases 1-25 on the card (``main`` has found it)."""
    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import (build_pipeline, metrics, paper_scene,
                                      paper_targets, simulate)
    from repro_torch.core.sar.geometry import test_scene as small_scene
    from repro_torch.kernels import _build, ops, transpose

    # ---- 1. device ---------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi_line, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)),
         total_memory=torch.cuda.get_device_properties(0).total_memory,
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)
    # start-up: the interpreter, torch, the card's context, nvidia-smi
    emit("phase_seconds", number=1, seconds=time.perf_counter() - T_START)

    # ---- 2. build ----------------------------------------------------------
    # forced: every source compiles again, so the ptxas report is there on
    # a second run in the same checkout too
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True, force=True)
    build_s = time.perf_counter() - t0
    check(set(logs) >= {"spectral", "spectral_long_forms", "mega",
                        "mega_forms", "mega_long", "mega_long_forms",
                        "staged", "staged_forms", "staged_long_forms",
                        "resident_bs16", "transpose"},
          f"built {sorted(logs)}")
    emit("phase_seconds", number=2, seconds=build_s)
    t0 = time.perf_counter()
    ptxas = {}
    hmma = {}
    with concurrent.futures.ThreadPoolExecutor(len(logs)) as pool:
        sass = dict(zip(logs, pool.map(
            lambda name: sass_hmma(_build.lib_path(name)), logs)))
    for name, log in logs.items():
        ptxas.update(ptxas_report(log))
        hmma.update(sass[name])
    for kernel in MMA_KERNELS:
        check(hmma.get(kernel, {}).get("tf32", 0) > 0,
              f"{kernel}: no HMMA TF32 in its SASS")
    # the operand forms (bf16 / f16 / bs16 / Karatsuba) on the matmul route
    forms = sorted(k for k in hmma if hmma_wanted(k) and k not in MMA_KERNELS)
    for kernel in forms:
        check(hmma[kernel][hmma_wanted(kernel)] > 0,
              f"{kernel}: no HMMA {hmma_wanted(kernel)} in its SASS")
    # the forms past one block: their libraries run every operand type on
    # the tensor cores (the stages are out-of-line functions)
    long_hmma = {}
    for name in ("spectral_long_forms", "mega_long_forms",
                 "staged_long_forms"):
        long_hmma[name] = {t: sum(v[t] for v in sass[name].values())
                           for t in ("tf32", "bf16", "f16")}
        check(all(long_hmma[name].values()),
              f"{name}: HMMA by operand type {long_hmma[name]}")
    emit("build", seconds=build_s, source_seconds=_build.BUILD_SECONDS,
         sources=sorted(_build.sources()), ptxas=ptxas, hmma=hmma,
         long_forms_hmma=long_hmma,
         operand_form_instantiations=len(forms), operand_forms=forms)
    # the SASS and ptxas checks of every library (cuobjdump, in parallel)
    emit("phase_seconds", number="2b", seconds=time.perf_counter() - t0)

    # ---- 3. kernel vs plain version on the card ----------------------------
    lap = phase_clock()
    sw = spectral_sweep(torch, ops, seeded_randn(torch, dev, 0), "matmul")
    emit("kernel", cases=sw["cases"], max_rel_err=sw["max_rel_err"], tol=TOL,
         oracle_cases=sw["oracle_cases"],
         max_oracle_err=sw["max_oracle_err"], oracle_tol=ORACLE_TOL)

    # ---- 4. the main path at the paper's size ------------------------------
    cfg = paper_scene()
    targets = paper_targets(cfg)
    raw = simulate(cfg, targets)
    torch.cuda.synchronize()
    check(raw.shape == (cfg.na, cfg.nr) and raw.device.type == "cuda",
          "simulated scene shape/device")

    score = scorer(cfg, targets)

    main_inputs = {}
    results = {}
    images = {}
    for variant, want_launches in (("fused3", 3), ("fused_tfree", 4)):
        pipe = build_pipeline(cfg, variant)
        check(pipe.dispatches == want_launches, f"{variant} dispatches")
        reset_launch_counts()
        img = pipe.run(raw)
        torch.cuda.synchronize()
        got_counts, want = launch_counts(spectral=want_launches)
        check(got_counts == want, f"{variant}: launches {got_counts}")
        launches = got_counts["spectral"]
        check(bool(torch.isfinite(img).all()), f"{variant}: non-finite image")
        rep_k = score(img)
        img_p = replay_plain(pipe, raw)
        torch.cuda.synchronize()
        dsnr = check_focus(f"{variant} vs plain", rep_k, score(img_p))
        l2 = l2_rel(torch, img, img_p)
        results[variant] = dict(launches=launches, targets=rep_k,
                                snr_delta_db_vs_plain=dsnr,
                                l2_rel_vs_plain=l2)
        images[variant] = img
        emit("main", variant=variant, scene=[cfg.na, cfg.nr], **results[
            variant])
        if variant == "fused3":
            # each launch's own inputs, for phase 5 and the kernel line
            x = raw
            for s in pipe.steps:
                xr, xi = planlib.split(x)
                main_inputs[s.name] = (s, xr, xi, x)
                yr, yi = ops.spectral_op(xr, xi, **s.filter_kw,
                                         **s.kernel_kw)
                x = planlib.unsplit(yr, yi)
            fused3_pipe = pipe
    del img, img_p, images["fused_tfree"]

    # the 4096^2 image against the same plan in complex128 (fused1 is held
    # torch.equal to this image in phase 7)
    want = image_oracle(torch, fused3_pipe, raw)
    img3 = images["fused3"]
    main_oracle = oracle_err(torch, (img3.real, img3.imag), want)
    check(main_oracle <= ORACLE_TOL,
          f"fused3 4096^2 vs complex128: {main_oracle:.3e}")
    emit("main_oracle", variant="fused3", scene=[cfg.na, cfg.nr],
         rel_err=main_oracle, tol=ORACLE_TOL)
    del want, img3

    main_err = 0.0
    for name, (s, xr, xi, _x) in main_inputs.items():
        got = ops.spectral_op(xr, xi, **s.filter_kw, **s.kernel_kw)
        want = ops.spectral_op_plain(xr, xi, **s.filter_kw, **s.kernel_kw)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        check(rel <= TOL, f"main-path launch {name}: rel err {rel:.3e}")
        main_err = max(main_err, err)
    emit("main_launches", max_abs_err=main_err, tol=TOL)

    small = small_scene(128)
    small_raw = simulate(small, paper_targets(small))
    on_card = build_pipeline(small, "fused3").run(small_raw).cpu()
    on_cpu = build_pipeline(small, "fused3", device="cpu").run(
        small_raw.cpu())
    _, small_rel = rel_err((on_card.real, on_card.imag),
                           (on_cpu.real, on_cpu.imag))
    small_peaks = [
        [(r.row, r.col) for r in metrics.analyze_scene(
            im.numpy(), small, paper_targets(small))]
        for im in (on_card, on_cpu)]
    check(small_rel <= TOL and small_peaks[0] == small_peaks[1],
          f"128^2 fused3 card vs CPU: rel err {small_rel:.3e}")
    emit("small_reference", scene=[128, 128], rel_err_vs_cpu=small_rel,
         peaks=small_peaks[0])

    # ---- 5. times ----------------------------------------------------------
    launches_t = [time_spectral_launch(smi_line, s, xr, xi, x)
                  for s, xr, xi, x in main_inputs.values()]
    run_ms = cuda_median_ms(lambda: fused3_pipe.run(raw))
    total = {k: sum(r[k] for r in launches_t)
             for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                       "mma_floor_ms")}
    emit("time_run", variant="fused3", ms=run_ms, nvidia_smi=smi_line,
         launch_ms_sum=total["ms"], launch_sums=total,
         launch_vs_library=total["ms"] / total["library_ms"])
    t_mem = sum(r["bytes"] for r in launches_t) / HBM_BYTES_PER_S * 1e3
    kernels = [{
        "name": "spectral",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spectral.cu",
        "replaces": "src/repro/kernels/fft4step.py:598",
        "launches": results["fused3"]["launches"],
        "max_abs_err": main_err,
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes" if t_mem >= total["bound_ms"] - 1e-12
        else "operations",
        "library_ms": total["library_ms"],
        "oracle_rel_err": main_oracle,
    }]
    kernels += mega_phases(torch, dev, smi_line, cfg, raw, images["fused3"],
                           score, small, small_raw, fused3_pipe)
    kernels += baseline_phases(torch, dev, smi_line, cfg, raw, score,
                               replay_plain, small, small_raw, fused3_pipe,
                               main_inputs, images.pop("fused3"))
    lap("3-13")

    # ---- 14. CSA and omega-K ------------------------------------------------
    records, f32_images, _ = family_phases(
        torch, smi_line, cfg, raw, score, replay_plain, small, small_raw)
    kernels += records
    lap(14)

    # ---- 15. bf16 / f16 / bs16 on the Stockham route ------------------------
    precision_sweeps(torch, ops, dev)
    f32_images["fused3"] = build_pipeline(cfg, "fused3",
                                          fft_impl="stockham").run(raw)
    f32_images["fused1"] = f32_images["fused3"]
    f32_images["csa_fused1"] = f32_images["csa_fused"]
    f32_images["omegak_fused1"] = f32_images["omegak"]
    kernels += precision_phases(torch, smi_line, cfg, raw, score,
                                replay_plain, small, small_raw, f32_images)
    del f32_images
    lap(15)

    # ---- 16. tuning: the matmul route's operand forms and the tuner --------
    form_sweeps(torch, ops, dev)
    images = form_images(torch, smi_line, cfg, raw, score, replay_plain,
                         small, small_raw)
    tuning_path(torch, smi_line, cfg, raw, score, replay_plain, small,
                small_raw)
    kernels += form_times(torch, smi_line, cfg, raw, small, small_raw,
                          images)
    lap(16)

    # ---- 17. the focusing service -------------------------------------------
    kernels += service_phase(torch, smi_line, cfg, raw, score, small,
                             small_raw)
    lap(17)

    # ---- 18. the multi-device lowering, P slabs on one card ----------------
    kernels += sharded_phase(torch, smi_line, cfg, raw, score)
    lap(18)

    # ---- 19. lines past one block: 8192 x 16384, three factors ------------
    kernels += long_lines_phase(torch, smi_line, cfg, raw, score,
                                replay_plain)
    del raw
    torch.cuda.empty_cache()
    lap(19)

    # ---- 20. every precision past one block --------------------------------
    t0 = time.perf_counter()
    kernels += long_forms_phase(torch, smi_line, replay_plain)
    emit("phase_seconds", number=20, seconds=time.perf_counter() - t0)

    # ---- 21. mega_resident past one block ----------------------------------
    t0 = time.perf_counter()
    kernels += resident_long_phase(torch, smi_line)
    emit("phase_seconds", number=21, seconds=time.perf_counter() - t0)

    # ---- 22. core.fusion, the FFTConvMixer and the LM serving path ---------
    t0 = time.perf_counter()
    kernels += lm_phase(torch, smi_line)
    emit("phase_seconds", number=22, seconds=time.perf_counter() - t0)

    # ---- 23. the LM training path -------------------------------------------
    t0 = time.perf_counter()
    kernels += train_phase(torch, smi_line)
    emit("phase_seconds", number=23, seconds=time.perf_counter() - t0)

    # ---- 24. the LM stack over a mesh of slabs of the card ------------------
    t0 = time.perf_counter()
    kernels += sharded_lm_phase(torch, smi_line)
    emit("phase_seconds", number=24, seconds=time.perf_counter() - t0)

    # ---- 25. MoE, the recurrent mixers and cross-attention split ----------
    t0 = time.perf_counter()
    sharded_mixers_phase(torch, smi_line)
    emit("phase_seconds", number=25, seconds=time.perf_counter() - t0)
    for k in kernels:
        k.setdefault("precisions", kernel_precisions(k["name"]))
        k.setdefault("karatsuba_by_route", kernel_karatsuba(k["name"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == [RESTART_FLAG]:
        sys.exit(restart_child())
    if sys.argv[1:2] == ["--long-passes"]:
        sys.exit(long_passes_main(sys.argv[2].split(",") if sys.argv[2:]
                                  else LONG_PASS_PARTS))
    sys.exit(main())
