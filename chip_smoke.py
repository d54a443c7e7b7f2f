#!/usr/bin/env python3
"""Drive the PyTorch port's serving, continuous-batching engine and its
supervised scheduler, training, the baseline TNN's scoring, training and
hist-replay serving, the attention decoder gemma3-4b's and the MoE
decoder granite-moe-3b-a800m's scoring and serving (with the paper's
mixers dropped in), the encoder-decoder whisper-medium's scoring and
serving with cross-attention, the prefix-VLM paligemma-3b's scoring under
the prefix mask (the paper's SKI there bidirectional), SKI scoring, SKI
training, unfused SKI, large-rank SKI, bf16 SKI scoring and training on
every SKI route, the TNN models trained through the distribution layer's
``StepBuilder`` on a one-rank mesh, Mamba-2 serving and training and the
jamba hybrid's scoring and serving paths on one NVIDIA card and check
them.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; exits non-zero without a
card or outside a checkout of this repository. Phases:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is switched off for matmuls and cuDNN;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, all started together;
3. kernels: each kernel against its plain torch version on the card, at
   the main paths' shapes and ragged ones, and its time (CUDA events,
   median of 50 runs, L2 evicted before each) beside the plain version's,
   one PyTorch library call's (where one computes the same function), and
   the bound (bytes or operations over the card's published peak rate);
   ``interp_reduce`` at the SKI path's shape also as ``ms_run``: 64
   launches between one event pair over input and output sets of more
   than 200 MB, median of 5 (``time_ms_run``); ``interp_expand`` so at
   the path, at r = 8 and at r = n, beside the same timing of
   ``y.zero_()`` on the path's y (the card's floor for the write alone);
   the fused ``causal_spectrum`` (plain and conjugated) and
   ``causal_spectrum_adjoint`` at the FD path's (512, 513) and at d = 37
   with n = 1, 2, 64 and 4096, also bitwise against a second call, timed
   beside the plain PyTorch composition (irfft, window, rfft) and the
   port's window route (cuFFT, ``hilbert_window``, cuFFT);
   the whole FD-TNO backward against autograd through the plain
   ``ref.fd_tno_ref`` at n = 512 (the fused route: 2 ``causal_spectrum``
   and 1 ``causal_spectrum_adjoint`` launches) and n = 448 (the window
   route: 3 ``hilbert_window``), and under ``REPRO_PALLAS_GRAD=0``; the
   window route's spectrum cotangent (``window_route_cotangent``, its
   edge bins' imaginary parts non-zero) at n = 448 and 8192 and the whole
   FD-TNO backward at x (1, 8192, 37) against the CPU's plain versions;
   ``hilbert_window`` is differentiable, standalone ``fd_mul`` and
   ``fd_khat_grad`` refuse an input that requires grad; the SKI kernels
   ``interp_reduce``, ``interp_expand``, ``short_conv``,
   ``ski_fused_pass2``, ``gram_grad`` and ``conv_tap_grad`` at the SKI
   path's shape (causal and bidirectional taps, and the mirrored offsets
   of the backward), ragged, n < m, r = n and m = 1, the interp pair also
   at r = 2 and as adjoints on the card; pass 2 at the dense-rank ceiling
   (r = 181 at d = 512, r = 512 at d = 64) in the forward orientation and
   the backward's (A transposed, taps flipped, left mirrored); ``gram_grad``
   also at both ceilings (dA of 67 MB) and ``conv_tap_grad`` also with
   m = 400 taps and with b = 12, both also bitwise against a second call;
   the whole
   SKIFusedTNO backward against autograd through ``ref.ski_fused_tno_ref``
   (causal, bidirectional, r = 181), and under ``REPRO_PALLAS_GRAD=0``;
   the large-rank ``ski_windowed_pass2`` and ``ski_expand_pass2`` at the
   large-r path's shape (x (8, 512, 512), r = 512, the four offsets), at
   r = 513 and 4096 (n = 4096, d = 16), ragged, n < m, r = n, r = 2 and
   m = 1, the windowed one also under ``REPRO_SKI_BAND_MAX=16``, against
   a float64 version and against itself (two calls, the same bits; its
   Gram runs on the tensor cores in 3xTF32 and its bound prices it at
   three TF32 products), the expand one also at n = r = 8192 and at a
   large "fft"-route input x (2, 8192, 512), r = 8192 and 4097; the
   whole SKIFusedTNOCoef backward, both variants, causal and
   bidirectional, against autograd through ``ref.ski_fused_tno_coef_ref``
   and under ``REPRO_PALLAS_GRAD=0``;
4. serve: the full-width fd-tnn-lm-wt103 (6 layers, d=512, vocab 50265,
   fp32, random weights from seed 0) scores 8 prompts of 448 tokens with
   ``prefill`` and greedily generates 64 tokens each (max_len 512) with
   ``generate``; the serving launch counts are read from this phase (a
   prefill of 448 tokens completes its spectra on the window route);
4b. engine: the same model through the continuous-batching engine
   (``repro_torch.serving_engine.Engine``, S = 8 slots, max_len 512, C =
   64, prompt buckets 64/128/256/512): 16 requests with prompts of 1, 17,
   63, 64, 65, 100, 128, 200, 255, 300, 333, 384, 400, 420, 447 and 448
   tokens and 8-64 new tokens each (seed 0), the first 8 admitted as one
   ``prefill_packed`` wave, the rest one by one by ``prefill`` as slots
   free, one masked ``generate`` step over all slots at a time; each
   request's tokens held against ``launch.serve.generate`` of its prompt
   alone at max_len 512 up to the first new token where the kernel-path
   forward over the solo sequence has a top-2 margin <= 1e-3 (cuBLAS may
   round an 8-row product differently from a 1-row one), the positions
   checked and skipped printed; the same traffic with request 3's slot
   poisoned before step 5 (it alone ends not ok, after 6 tokens, and the
   others keep the clean run's tokens under the same rule); a sampled
   engine (T = 0.7, top_k = 8, seeds 100 + i) run twice with the same
   tokens; asserted launches: 6 ``hilbert_window`` (one per layer: one
   Engine realises its kernel constants once and every template shares
   them) and no other kernel, for the greedy Engine with both its runs and
   for the sampled Engine with both of its; printed, not claimed: each
   run's new tokens/s over its ``generate`` steps, each prefill wave's
   ms, the counts of steps, prefills and packed prefills, and beside them
   the solo decode rate of the same requests (host clock, synchronised);
4c. scheduler: the same traffic through the supervised
   ``repro_torch.serving_engine.Scheduler`` (packing 4, asynchronous
   detokenising, a metrics registry and a span tracer): greedy, every
   outcome ok and the tokens held against solo decode under the same
   margin rule, every request span closed; a chaos run (a seeded
   ``FaultInjector``, the launchers' ``--chaos`` rates): every request
   terminal, every error an ``InjectedFault``, the ok requests held as
   before; a run preempted after 20 decode steps, snapshotted and restored
   into a new Engine and Scheduler whose tokens equal the greedy run's
   exactly; ``launch.serve.main --engine --batch 16 --slots 8`` in
   process, its metrics JSON and one closed request span per request;
   asserted launches: 6 ``hilbert_window`` for the Engine and its greedy
   run, and 6 for the restored Engine and its run; printed, not claimed,
   beside the card's name and power limit: new tokens/s over ``run()``'s
   wall and over its decode steps beside the engine phase's rate, steps,
   prefills, packed waves, the TTFT and TPOT medians (the registry's
   buckets and the spans), the snapshot's bytes and write ms;
5. train: the same model, from seed 0, takes 30 AdamW steps through the
   port's ``Trainer`` on the synthetic pipeline (8 × 512 tokens a step):
   5 warm-up steps, then a resume whose wall over the other 25 gives the
   tokens/s; the training launch counts are read from this phase (per
   layer a step: 2 ``causal_spectrum``, 1 ``causal_spectrum_adjoint``, 2
   ``fd_mul``, 1 ``fd_khat_grad``);
5a. obs: ``launch.train.main`` trains the same model (seed 0) 6 steps of
   8 × 512 with ``--metrics-file``, ``--trace-file`` and
   ``REPRO_PROFILE_DIR`` set: the registry's ``repro_train_steps_total``
   is 6 and ``repro_compiles_total`` exactly one ``train.train_step``, 12
   ``train_step`` span events and a Chrome export; the profiler's trace
   read by ``obs.devstats.aggregate_chrome`` (device time: the regions'
   ``gpu_user_annotation`` ranges) and ``region_kernels`` (each kernel by
   its launch's correlation id): every launch of ``causal_spectrum``,
   ``causal_spectrum_adjoint``, ``fd_mul`` and ``fd_khat_grad`` lies under
   the ``fd_tno`` region; printed (``[obs train]``), beside the card's name
   and power limit: the launcher's median ``train_step`` span (one
   device, the mesh-free step, under the profiler), the region's ms a step, its share of the steps'
   device ranges, its host ranges, its kernels' busy time, and its
   achieved fraction of the roofline bound (the causal FD plan's
   ``obs.cost`` cost times the region's forwards and backwards, against
   ``obs.cost.peaks("gpu", float32)``), which must lie in (0, 1.05]; then
   ``attribute_engine`` over the scheduler phase's greedy drain
   (``[obs engine]``: its path, coverage and rows); run after phase moe,
   the first that traces, since a profiler session leaves later launches
   dearer on the host;
5b. tno: the full-width baseline tnn-lm-wt103 (the ``tno`` mixer: the
   RPE MLP at every lag times the decay bias, an FFT Toeplitz matvec;
   66,031,744 parameters, as many as the FD model; random weights from
   seed 0) scores 8 × 512 tokens through ``make_forward`` and the eval
   ``loss_fn`` (card vs CPU logits and loss on 1 × 512 within 1e-4 ×
   max), takes 10 AdamW steps of 8 × 512 through the ``Trainer`` (5
   warm-up, 5 timed; the loss falls), and its smoke model's step-0
   gradients, three losses and a checkpoint resume are held card vs CPU as
   in phase 10; it serves the serve phase's shape (8 × (448 + 64), max_len
   512) greedily through the hist-replay cache, held to the kernel-path
   forward over the 512-token sequences under the margin rule, and four of
   the engine phase's requests (prompts of 17, 100, 255 and 420 tokens)
   through an ``Engine`` of 4 slots at max_len 512, held to solo
   ``generate`` under the margin rule with the forward at n = 512;
   asserted: no launch of any hand-written kernel in all of that, the taps
   realised once a layer a ``generate`` and an Engine; then the serve
   phase's FD model under ``REPRO_FD_STREAM=0`` on its prompts through the
   hist cache, its tokens held to the streaming ones under the margin
   rule, asserted 6 ``hilbert_window`` (``kcoef`` realised once a layer)
   and no other kernel; printed, not claimed, beside the card's name and
   power limit: the scoring and training tokens/s and the new tokens/s of
   the decode steps alone (the prompt fed untimed) of the baseline's and
   FD's hist replay and of FD's stream; and, stage by stage on layer 0
   with the same weights and inputs on both, the baseline's card-vs-CPU
   gap (``[tno stages]``, ROADMAP Queue 3 item 9): ``decay_bias``,
   ``baseline_coeffs``, cuFFT's Toeplitz matvec against pocketfft and the
   GTU each within 1e-5 of its scale, the TF32 switches and a fp32
   product against fp64, the FFT lengths, the gap after each layer and
   the CPU's own logits with the matvec in fp64;
5c. zoo: the full-width gemma3-4b (34 layers: 5 blocks of 5 sliding-window
   ``local`` layers and one global, then 4 tail layers; d=2560, 8 heads
   over 4 kv heads of 256, window 1,024, vocab 262,144, bf16, random
   weights from seed 0) scores 8 × 512 through ``make_forward`` and the
   eval ``loss_fn`` (parameters against ``param_count()``, init seconds,
   peak memory); at one period's depth (6 layers: 5 local and the
   global one, every leaf the full model's own tensor) serves 4 prompts
   of 1,088 tokens with 32 greedy new tokens each at max_len 1,152
   through the KV caches (the window binds in every local layer); the
   decode path teacher-forced over the generated
   sequences (its steps after the prompt timed) reproduces the generated
   tokens and picks the forward's token wherever the forward's top-2
   margin exceeds max(1e-3, twice the two paths' largest logit difference)
   (bf16 rounds at other places in a one-row step and a full forward; the
   count under the bare 1e-3 rule is printed beside it); then ``--mixer
   fd`` and ``--mixer ski`` at full width and one period's depth (6
   layers; the mixers drawn from seed 0, the other leaves the full
   model's) score 8 × 512: 6 ``causal_spectrum`` + 6 ``fd_mul``, and 6
   ``interp_reduce`` + 6 ``ski_fused_pass2``, and no other kernel, their
   logits within 2e-2 of the scale of the same forward through the plain
   versions on the card (or twice that forward's distance from its
   fp32-activation run, where larger); then the 6-layer cut's weights in
   fp32: one served row teacher-forced through all 1,119 decode steps
   against the
   fp32 forward, and 4 ragged requests (9, 30, 50 and 100 tokens) through
   an Engine of 4 slots at max_len 512 against solo ``generate``, both
   under the 1e-3 margin rule; asserted: no launch of any hand-written
   kernel on the scoring, serving and engine paths; the smoke gemma3-4b
   and its FD override card vs CPU (bf16 logits within 2e-2 of their
   scale, or twice the CPU's bf16-vs-fp32-activation distance where
   larger; in fp32 the step-0 gradients, three losses and a bitwise
   checkpoint resume, as in phase 10); printed, not claimed, beside the
   card's name and power limit: the scoring tokens/s, the decode steps'
   new tokens/s, the fp32 engine's and the two overrides' scoring
   tokens/s;
5d. moe: the full-width granite-moe-3b-a800m (32 (attention, moe)
   layers, d=1,536, 24 heads over 8 kv heads of 64, 40 experts top-8 of
   d_ff 512, vocab 49,155, bf16, random weights from seed 0; parameters
   against ``param_count()`` plus the norm scales, init seconds) scores 8
   × 512 through ``make_forward`` and the eval ``loss_fn`` at the
   config's capacity factor 1.25 (the dropped assignments counted, the
   loss beside its aux term, peak memory, two forwards the same bits);
   the capacity path at cf = E / k = 5 (nothing drops) against the
   dropless ragged path on that batch, within 2e-2 of the scale or twice
   the ragged path's distance from its fp32-activation run, with the
   (layer, token) pairs routed to other experts counted and the ragged
   forward twice the same bits; the three forwards timed (CUDA events)
   and one scoring forward and a short ``generate`` traced; serves 4
   prompts of 224 tokens with 32 greedy new tokens at max_len 256 (4 rows
   a step: no assignment drops); the decode path teacher-forced over the
   generated sequences (its steps after the prompt timed) reproduces
   them and picks the ragged forward's token under phase zoo's bf16 rule,
   with the positions whose top-8 expert sets differ between the two
   counted; ``--mixer fd`` at 6 layers, its FFNs MoE: 6
   ``causal_spectrum`` + 6 ``fd_mul``, held to the plain versions as in
   phase zoo; the same weights in fp32: one served row through its 255
   decode steps against the fp32 ragged forward and phase zoo's 4
   engine requests over 4 slots against solo ``generate``, both under
   the 1e-3 margin rule; asserted: no hand-kernel launch on the scoring,
   serving and engine paths; the smoke granite, grok-1 and granite
   ``--mixer fd`` card vs CPU as in phase zoo; printed, not claimed,
   beside the card: the scoring, decode, engine and override rates;
5e. encdec: ``hilbert_window`` and ``fd_mul`` at whisper ``--mixer fd``'s
   shape (d = 1,024, n = 448, the window route); the full-width
   whisper-medium (24 encoder + 24 decoder layers, d = 1,024, 16 heads of
   64, vocab 51,865, bf16, 1,012,525,056 parameters against
   ``param_count()``'s 509,083,648, which leaves out the encoder and the
   cross-attention; drawn on the card from seed 0) scores 8 rows of 1,500
   stub frames and 448 tokens through ``make_forward`` and the eval
   ``loss_fn`` (peak memory); ``serving.encode``s 4 rows of frames once
   and serves 4 × (16 + 64) greedily with ``enc_out`` (every step's cross
   sublayers recompute k and v from the 1,500 frames), the decode steps
   timed and 8 traced, the decode path held to the forward under phase
   zoo's bf16 rule; ``--mixer fd`` with 2 decoder layers: 2
   ``hilbert_window`` + 2 ``fd_mul`` a forward, held to the plain
   versions, and served (2 ``hilbert_window`` a ``generate``) under the
   same rule; the Engine refuses the arch; the same weights in fp32: one
   row through its 79 decode steps against the fp32 forward under the
   1e-3 margin rule; no hand-kernel launch on the scoring, serving and
   fp32 paths; the smoke whisper and its FD override card vs CPU (bf16
   logits as phase zoo's smoke check, fp32 loss and every gradient 1e-4);
5f. prefix_vlm: ``interp_reduce``, ``short_conv`` and ``ski_fused_pass2``
   bidirectional (left = m // 2) at paligemma ``--mixer ski``'s shape x
   (8, 512, 2,048), r = 64, m = 32; the full-width paligemma-3b (18
   layers, d = 2,048, MQA: 8 heads over 1 kv head of 256, d_ff 16,384,
   vocab 257,216, bf16, drawn on the card from seed 0) scores 8 rows of
   256 stub patches + 256 tokens under the prefix mask (the loss over the
   text); serves the text alone, 4 × (32 + 32), as JAX's decode does, the
   steps timed and 8 traced, held to the forward with the prefix cut to 0
   under phase zoo's bf16 rule; ``--mixer ski`` and ``--mixer tno`` at 2
   layers, which the prefix mask runs bidirectionally: 2
   ``interp_reduce`` + 2 ``ski_fused_pass2`` and none, each held to the
   plain versions; ``--mixer fd`` refused; no hand-kernel launch on the
   scoring and serving paths; the smoke paligemma and its SKI override
   card vs CPU as in phase 5e;
6. score: the full-width ski-tnn-lm-wt103 (random weights from seed 0)
   scores 8 × 512 tokens through ``launch.steps.make_forward`` and the
   evaluation ``loss_fn`` under ``torch.no_grad()``: 6 ``interp_reduce``
   and 6 ``ski_fused_pass2`` launches a forward, card vs CPU logits and
   loss on 1 × 512 tokens, peak memory; the six standalone SKI kernel
   wrappers refuse an input that requires grad on the card; one op-level
   line times ``ops.ski_fused_tno`` against ``ops.fd_tno`` at
   (8, 512, 512);
7. ski train: the full-width ski-tnn-lm-wt103 from seed 0 takes 30 AdamW
   steps as in phase 5: 18 ``interp_reduce``, 12 ``ski_fused_pass2``, 6
   ``gram_grad`` and 6 ``conv_tap_grad`` launches and 6 kernel backwards
   a step;
8. ski unfused: the unfused SKI-TNO (``TNOConfig(variant="ski",
   fused=False)`` through ``tno_plan``/``tno_apply``) at x (8, 512, 512)
   and the SKI model's width (d=512, r=64, m=32, seed 0), causal and
   bidirectional, forward and backward: y and the gradients for x, the
   taps and the RPE values against the fused op (1e-4 × max) and autograd
   through the plain versions (1e-5 × max), y against the CPU (1e-5 ×
   max), 1 ``interp_reduce`` / ``short_conv`` / ``interp_expand`` launch
   forward and one more each plus one ``conv_tap_grad`` backward, and
   ``REPRO_PALLAS_GRAD=0``; then, recorded and not claimed, the fused and
   unfused forward and grad times and Figure 11's component times at the
   SKI benchmark's shapes (b=4, d=64, n 2048 and 8192), and the Appendix-B
   ``causal_ski_lowrank`` against its masked dense oracle, timed beside
   the causal FD-TNO;
9. large-r: ski-tnn-lm-wt103 at tno_rank 512 (full width, seed 0; the
   policy routes it "windowed") scores 8 × 512 tokens (6 ``interp_reduce``
   + 6 ``ski_windowed_pass2`` a forward, card vs CPU logits on 1 × 512)
   and trains 30 steps (18 / 12 / 6 ``interp_reduce`` /
   ``ski_windowed_pass2`` / ``conv_tap_grad`` launches and 6 kernel
   backwards of SKIFusedTNOCoef a step); then, under
   ``REPRO_SKI_WINDOWED_RMAX=256`` (the "fft" route), the same scoring and
   10 steps with ``ski_expand_pass2`` in its place; recorded, not
   claimed, the forward and grad times at ``bench_ski_components.py``'s
   large-r shapes (r 64 to 8192, the dense op beside where it fits) and
   dense against windowed at r = 181 and 182, d = 512;
9a. ski_bf16: the bf16 SKI path. ``interp_reduce_bf16`` at x (8, 512,
   512) bf16, r = 64, ``ski_fused_pass2_bf16`` (left 0) and
   ``ski_fused_pass2_at_bf16`` (Aᵀ, left 31) at x (8, 512, 512), z (8,
   64, 512) bf16, A (512, 64, 64) fp32 and bf16 taps, and
   ``gram_grad_bf16`` at (8, 64, 512) against their plain versions on the
   same bf16 inputs on the card (1e-2 × max|plain| for the bf16 outputs,
   1e-6 for dA, whose products of bf16 values are exact), both
   orientations also at left 31 and 0, each also at every SKI_SHAPES
   shape, and each timed (CUDA events, L2 evicted) beside its plain
   version and a bf16 ``torch.einsum`` (none for pass 2); then the
   full-width ski-tnn-lm-wt103 with dtype and param_dtype bf16 and its
   parameters through ``nn.layers.cast_params`` (seed 0) scores 8 × 512
   through ``make_forward`` (6 + 6 bf16 launches, no fp32 SKI launch;
   tokens/s; the logits beside the same weights in fp32), takes
   ``loss_and_grads`` at 8 × 512 (18 / 6 / 6 / 6 / 6 launches of
   ``interp_reduce_bf16`` / ``ski_fused_pass2_bf16`` /
   ``ski_fused_pass2_at_bf16`` / ``gram_grad_bf16`` /
   ``conv_tap_grad_bf16``, none of the fp32 instances), holds its
   gradients at 2 × 512 to the same model's on the CPU (each leaf's
   relative L2 distance within max(2e-2, twice the CPU bf16 gradients'
   own distance from the CPU fp32 ones)), and takes 5 ``make_train_step``
   steps at 8 × 512 (a new batch each), every loss after the first below
   it and all finite (tokens/s, peak memory);
9b. ski_bf16_routes: bf16 SKI past the dense route.
   ``ski_windowed_pass2_bf16`` and ``ski_expand_pass2_bf16`` at x (8, 512,
   512), z (8, 512, 512) bf16, r = 512, m = 32 (fp32 coefficients, bf16
   taps) and ``interp_expand_bf16`` at z (8, 64, 512) against their plain
   versions on the same bf16 inputs on the card (1e-2 × max|plain|), pass
   2 at left 0 and 16 and in the backward's orientation of each
   (coefficients and taps flipped, left 31 and 15), all three also at
   every other SKI_SHAPES shape, each timed beside its plain version and
   its fp32 instance on the same values widened (interp_expand also beside
   a bf16 ``torch.einsum``); SKIFusedTNOCoef on a bf16 x at (8, 512, 512),
   r = 512, both variants, causal and bidirectional, against autograd
   through ``ref.ski_fused_tno_coef_ref`` in bf16 (2e-2 × max, 3 / 2 / 1
   bf16 launches); the full-width bf16 ski-tnn-lm-wt103 at tno_rank 512
   (``cast_params``, seed 0) on the "windowed" route and, under
   ``REPRO_SKI_WINDOWED_RMAX=256``, the "fft" route: scores 8 × 512 (6 +
   6 bf16 launches), one ``loss_and_grads`` (18 / 12 / 6 launches of
   ``interp_reduce_bf16`` / the route's pass 2 / ``conv_tap_grad_bf16``,
   6 kernel backwards of SKIFusedTNOCoef, no fp32 SKI instance), 3
   ``make_train_step`` steps with finite losses, and the first row's
   logits against the CPU's under the zoo's bf16 rule (fp32 rates: phase
   large-r's lines); the unfused layer in bf16 at x (8, 512, 512),
   r = 64, forward and backward against autograd through the plain
   versions (``interp_expand_bf16`` once each way);
9c. mesh: the distribution layer on the card. A one-rank NCCL process
   group in this process (``file://`` rendezvous), ``make_host_mesh()``
   on the card, and the full-width ``ski-tnn-lm-wt103`` (r = 64, m = 32)
   and ``fd-tnn-lm-wt103`` trained 3 steps of 8 × 512 through
   ``StepBuilder`` (DTensor parameters and moments, the mixers' kernels
   on the local tensors) beside the mesh-free ``make_train_step`` from
   the same init and batches: the losses and every parameter and moment
   after 3 steps must agree within 1e-6 × max (bitwise expected; the
   worst difference is printed), the kernel launches and the autograd
   Functions' forwards and kernel backwards of the two runs must be equal
   (the plain backward never), and the median ``train_step`` ms of both
   paths is printed (the DTensor path's host cost);
10. check: the kernel-path forward over the generated sequences reproduces
   every decoded token whose top-2 logit margin exceeds 1e-3; the
   smoke-size model gives the same logits, step-0 gradients and three
   training losses on the card as on the CPU; a run stopped at step 2 and
   restored from its checkpoint into a fresh model ends bitwise where an
   uninterrupted run ends; the same gradients, losses and resume for the
   smoke-size SKI model;
11. mamba: ``ssd_scan`` against ``ssd_chunked.ssd_scan_chunked`` in bf16
   (BF16_TOL × max) and fp32 (1e-5 × max, and against the float64
   ``ref.ssd_scan_ref``) at the path shape x (8, 2048, 80, 64), B and C (8,
   2048, 1, 128), chunk 128, at n = 2000, 100 and 1, at g = 2 and 4 and at
   the smoke shape; both instances timed at the path shape (the bf16 one,
   on the tensor cores, against the TF32 peak); the bf16 ``short_conv``
   and the bf16 ``conv_tap_grad`` (1e-5 × max, bitwise against a second
   call) at Mamba's conv shape (8, 2048, 5376), m = 4, and at the SKI
   path's shape with its four offsets, each timed beside its bound, its
   plain version and cuDNN; SSDScan's six cotangents at one full-width
   layer's training shape x (4, 2048, 80, 64) in bf16 and fp32 against
   autograd through the chunked scan; the raw ``ssd_scan`` wrapper
   refuses an input that requires grad; the bf16 ShortConv backward
   against autograd through its plain version; the full-width
   mamba2-2.7b (64 layers, d=2560, bf16, 2,831,730,176 parameters,
   random weights from seed 0) scores 8 ×
   2048 tokens through ``make_forward`` (64 ``ssd_scan`` + 64
   ``short_conv`` launches a forward, median of 5, peak memory, the
   kernels' device time by the profiler), ``prefill``s 8 prompts of 128
   tokens and greedily generates 32 tokens each (max_len 160, the prompt
   token by token); the decode path teacher-forced over the generated
   sequences against the kernel-path forward (0 mismatches where the
   forward's top-2 margin exceeds twice their largest logit difference);
   the kernel-path bf16 forward no farther from the same forward through
   the plain ``ssd_scan`` and ``short_conv`` than that plain forward is
   from the fp32 one; and the same in fp32 on the same weights, where that
   margin is small enough that positions are checked (at least one must
   be); the smoke mamba model card vs CPU (logits 1e-4 × max in fp32,
   2e-2 × max in bf16; fp32 greedy generate token-exact; one training
   step's loss and every gradient in both dtypes);
11a. mamba_train: the full-width mamba2-2.7b (random weights from seed
   0, drawn on the card, its config's per-layer remat) trains 2 + 4
   AdamW steps of 4 × 2048 tokens through two ``Trainer.run`` calls:
   tokens/s over the last 4 (host clock and CUDA events), every loss
   finite, peak memory, and each step 2 ``ssd_scan``, 3 bf16
   ``short_conv`` and 1 ``conv_tap_grad_bf16`` launches a layer and one
   SSDScan backward, nothing else; one more step traced;
11b. jamba: ``ssd_scan`` at the hybrid's Mamba shape x (8, 512, 256, 64),
   B and C (8, 512, 8, 128) (8 groups of 32 heads), chunk 128, also at n
   = 100 and 1, bf16 and fp32 as in phase 11, and the bf16 ``short_conv``
   at (8, 512, 18,432), m = 4, each timed beside its bound; the
   full-width jamba-1.5-large-398b cut to its first 5 layers ((mamba,
   dense), (mamba, moe) twice, (attention, dense); d=8,192, 16 experts
   top-2 of d_ff 24,576, 256 Mamba heads of 64, vocab 65,536, bf16;
   24,050,696,192 parameters by ``param_count()`` plus the vectors it
   leaves out, drawn on the card from seed 0; init seconds, host RSS,
   peak memory) scores 8 × 512 through ``make_forward`` and the eval
   ``loss_fn`` at cf 1.25 (4 ``ssd_scan`` + 4 bf16 ``short_conv`` a
   forward and no other kernel, two forwards the same bits, the dropped
   assignments of each MoE layer, CUDA events beside the host clock, one
   forward traced); ``prefill``s and greedily serves 4 × (224 + 32) at
   max_len 256 (4 rows: nothing drops), the decode steps timed by CUDA
   events and the host clock and 8 traced (launches, busy, idle) beside
   the step's weight-read bound, and the decode path held to the ragged
   forward under phase zoo's bf16 rule; 4 ragged requests through a
   ``Scheduler`` over an Engine of 4 slots whose cache mixes KV, conv and
   fp32 state leaves, held to solo ``generate`` up to their first
   difference, which must fall on a top-2 margin within that rule, then
   preempted, snapshotted and restored into a new Engine with the same
   tokens exactly; ``--mixer fd`` on the cut (the attention layer FD): 1
   ``causal_spectrum`` + 1 ``fd_mul`` + 4 + 4, held to the plain versions
   as in phase zoo; the smoke hybrid (16 layers) card vs CPU (fp32 1e-4 ×
   max, bf16 as phase zoo's smoke check, fp32 ``generate`` and Engine
   token-exact, one training step's loss and every gradient in both
   dtypes);
12. a JSON line with each kernel's numbers, then the card's name and power
    limit, then ``{"ok": true, "device": ...}`` as the last line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.obs.cost import GPU_PEAKS, gpu_peaks  # noqa: E402

#: NVIDIA data-sheet peaks (bytes/s of device memory, dense FLOP/s: fp32
#: outside the tensor cores, TF32 and bf16 on them, without sparsity), by
#: the name nvidia-smi reports; "H100" alone is the SXM part. The table is
#: ``obs/cost.py``'s, which ``obs.cost.peaks("gpu")`` reads too.
PEAKS = GPU_PEAKS
PROMPTS, PROMPT_LEN, GEN_LEN = 8, 448, 64
MARGIN = 1e-3
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_WARMUP = 30, 512, 8, 5
SCORE_BATCH, SCORE_SEQ, SCORE_REPS = 8, 512, 20
FD_SRC = "src/repro_torch/kernels/csrc/fd_fused.cu"
SKI_SRC = "src/repro_torch/kernels/csrc/ski.cu"
SKI_GRAD_SRC = "src/repro_torch/kernels/csrc/ski_grad.cu"
SHORT_CONV_SRC = "src/repro_torch/kernels/csrc/short_conv.cu"
SSD_SRC = "src/repro_torch/kernels/csrc/ssd_scan.cu"
MAMBA = "mamba2-2.7b"
MAMBA_BATCH, MAMBA_SEQ, MAMBA_REPS = 8, 2048, 5
MAMBA_PROMPTS, MAMBA_PROMPT_LEN, MAMBA_GEN = 8, 128, 32
#: a kernel with a bf16 output against its plain version on the same bf16
#: inputs: both sum in fp32 and round once, so they differ by at most one
#: bf16 ulp (2^-8 relative) where the two fp32 sums straddle a rounding
BF16_TOL = 1e-2


def _peaks(name: str):
    return gpu_peaks(name)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, reps: int = 50) -> float:
    """Median device time of ``fn`` over ``reps`` runs, with the 50 MB L2
    evicted before each run (inputs come from device memory, as the
    bound assumes). The eviction reads a 256 MB buffer, so L2 holds clean
    lines afterwards and the timed call pays no write-back for it."""
    flush = torch.ones(64 << 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


#: time_ms_run: launches between one event pair, runs (median taken), and
#: the bytes its input and output sets must exceed (four times the 50 MB L2)
RUN_LAUNCHES, RUN_REPS, RUN_COLD_BYTES = 64, 5, 200e6


def time_ms_run(calls, k: int = RUN_LAUNCHES, runs: int = RUN_REPS) -> dict:
    """Device time a launch, the median over ``runs`` of one event pair
    around ``k`` launches, divided by ``k``: for a launch of a few
    microseconds one event pair around one launch (``time_ms``) reads
    mostly the timer. ``calls`` are closures over distinct input sets,
    taken in turn; each launch's output is kept until the run ends, so the
    inputs and outputs together exceed ``RUN_COLD_BYTES`` and every launch
    starts cold in L2. A ``torch.cuda._sleep`` ahead of the start event
    holds the stream while the host enqueues the k launches, so the host's
    launch cost stays out of the figure; that the enqueue ended inside the
    sleep is checked. Returns {"ms_run", "enqueue_ms" (the median over the
    runs), "sleep_ms" (the sleep's one reading)}."""
    seq = [calls[i % len(calls)] for i in range(k)]
    for _ in range(2):                   # warm-up; the allocator keeps blocks
        outs = [fn() for fn in seq]
        del outs
    torch.cuda.synchronize()
    cycles = 40_000_000
    s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s0.record()
    torch.cuda._sleep(cycles)
    s1.record()
    s1.synchronize()
    sleep_ms = s0.elapsed_time(s1)
    times, enqueue = [], []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        outs = [fn() for fn in seq]
        enqueue.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        del outs
        times.append(start.elapsed_time(end) / k)
    if max(enqueue) >= sleep_ms:
        raise AssertionError(f"time_ms_run: enqueuing {k} launches took "
                             f"{max(enqueue):.3f} ms, past the "
                             f"{sleep_ms:.3f} ms sleep")
    return {"ms_run": statistics.median(times),
            "enqueue_ms": statistics.median(enqueue), "sleep_ms": sleep_ms}


# ------------------------------------------------------------- phase 1-2
def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi)
    print(f"[device] {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    return smi


def phase_build() -> None:
    from repro_torch.kernels import backend
    t0 = time.perf_counter()
    paths = backend.build()
    print(f"[build] {', '.join(p.name for p in paths)} built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


# --------------------------------------------------------------- phase 3
def _bound(nbytes, nops, peaks):
    """(bound ms, "bytes" or "operations"): the bytes over ``peaks[0]`` or
    the operations, whichever take longer. ``nops`` runs at ``peaks[1]``
    (fp32 on the CUDA cores), or is triples (operations, peak FLOP/s,
    unit), one for each type the kernel computes in. Work on one unit adds
    up; the tensor cores and the CUDA cores run side by side, so the
    operations take the busiest unit's time."""
    if not isinstance(nops, tuple):
        nops = ((nops, peaks[1], "cuda cores"),)
    t_bytes = nbytes / peaks[0] * 1e3
    per_unit = {}
    for ops, flops, unit in nops:
        per_unit[unit] = per_unit.get(unit, 0.0) + ops / flops * 1e3
    t_ops = max(per_unit.values())
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _kernel_entry(name, replaces, got, want, fn, plain, library, nbytes,
                  nops, peaks, tol=1e-6, source=FD_SRC, reps=50):
    """Check ``got`` within ``tol`` × max|want| and time the kernel, its
    plain version and the library call (None: there is none), each the
    median of ``reps`` runs; the bound is ``_bound``'s."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max abs err {err} > {tol} x {scale}")
    bound_ms, bound_by = _bound(nbytes, nops, peaks)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "tolerance": tol,
            "scale": scale, "limit": tol * scale, "ms": time_ms(fn, reps),
            "plain_ms": time_ms(plain, reps),
            "library_ms": None if library is None else time_ms(library,
                                                               reps),
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_kernels(peaks) -> dict:
    from repro_torch.kernels import fd_fused, ref
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    # hilbert_window at the serving shape (d=512, n=512) and a ragged one.
    # The function reads lags 0..n (the rest are zero whatever kt holds)
    # and writes all 2n: 4·d(n+1) + 4·2dn bytes, d(n+1) multiplies.
    for d, n in ((512, 512), (37, 45)):          # odd n: scalar path
        kt = torch.randn(d, 2 * n, device="cuda", generator=g)
        w = ref.hilbert_window_ref(torch.ones(1, 2 * n, device="cuda"), n)[0]
        e = _kernel_entry(
            "hilbert_window", "src/repro/kernels/fd_fused.py:80",
            fd_fused.hilbert_window(kt, n), ref.hilbert_window_ref(kt, n),
            lambda: fd_fused.hilbert_window(kt, n),
            lambda: ref.hilbert_window_ref(kt, n), lambda: kt * w,
            nbytes=4 * d * (n + 1) + 4 * kt.numel(), nops=d * (n + 1),
            peaks=peaks)
        print(f"[kernel] hilbert_window kt ({d}, {2 * n}): {e}", flush=True)
        out.setdefault("hilbert_window", e)
    out.update(phase_causal_spectrum(peaks))
    # fd_mul at the serving shape: 8 rows of the channel-major (d, n+1)
    # spectrum, d=512, n=512; and a ragged one
    for b, d, f in ((8, 512, 513), (3, 37, 45)):  # odd row: scalar path
        x = torch.randn(b, d, f, dtype=torch.complex64, device="cuda",
                        generator=g)
        k = torch.randn(d, f, dtype=torch.complex64, device="cuda",
                        generator=g)
        got, want = fd_fused.fd_mul(x, k), ref.fd_mul_ref(x, k)
        e = _kernel_entry(
            "fd_mul", "src/repro/kernels/fd_fused.py:162",
            torch.view_as_real(got), torch.view_as_real(want),
            lambda: fd_fused.fd_mul(x, k), lambda: ref.fd_mul_ref(x, k),
            lambda: torch.mul(x, k),
            nbytes=8 * (2 * x.numel() + k.numel()), nops=6 * x.numel(),
            peaks=peaks)
        print(f"[kernel] fd_mul x̂ ({b}, {d}, {f}) complex64: {e}", flush=True)
        out.setdefault("fd_mul", e)
    # fd_khat_grad at the training shape: ĝ, x̂ (8, 512, 513) complex64,
    # d=512, n=512; and a ragged one. Reads ĝ and x̂ once, writes (d, n+1):
    # 8·(2·b·d·f + d·f) bytes; 8 flops per complex product-add.
    for b, d, f in ((8, 512, 513), (3, 37, 45)):  # odd row: scalar path
        gh = torch.randn(b, d, f, dtype=torch.complex64, device="cuda",
                         generator=g)
        xh = torch.randn(b, d, f, dtype=torch.complex64, device="cuda",
                         generator=g)
        got, want = fd_fused.fd_khat_grad(gh, xh), ref.fd_khat_grad_ref(gh, xh)
        e = _kernel_entry(
            "fd_khat_grad", "src/repro/kernels/fd_fused.py:238",
            torch.view_as_real(got), torch.view_as_real(want),
            lambda: fd_fused.fd_khat_grad(gh, xh),
            lambda: ref.fd_khat_grad_ref(gh, xh),
            lambda: torch.einsum("bdf,bdf->df", gh, xh.conj()),
            nbytes=8 * (2 * gh.numel() + d * f), nops=8 * gh.numel(),
            peaks=peaks)
        print(f"[kernel] fd_khat_grad ĝ, x̂ ({b}, {d}, {f}) complex64: {e}",
              flush=True)
        out.setdefault("fd_khat_grad", e)
    check_fd_tno_backward(g)
    check_window_route_cotangent(g)
    # hilbert_window is differentiable (self-adjoint: its gradient is the
    # window of the cotangent); standalone fd_mul and fd_khat_grad are
    # forward-only and refuse an input that requires grad, not detach it
    kt = torch.randn(4, 8, device="cuda", requires_grad=True)
    win = fd_fused.hilbert_window(kt, 4)
    cot = torch.randn(4, 8, device="cuda", generator=g)
    (dkt,) = torch.autograd.grad(win, kt, cot)
    if win.grad_fn is None or not torch.equal(
            dkt, ref.hilbert_window_ref(cot, 4)):
        raise AssertionError("hilbert_window's gradient is not the window "
                             "of the cotangent")
    print("[kernel] hilbert_window is differentiable: gradient = window of "
          "the cotangent", flush=True)
    x = torch.randn(2, 4, 5, dtype=torch.complex64, device="cuda")
    calls = {"fd_mul": lambda: fd_fused.fd_mul(
                 x, x[0].clone().requires_grad_()),
             "fd_khat_grad": lambda: fd_fused.fd_khat_grad(
                 x, x.clone().requires_grad_())}
    for name, call in calls.items():
        try:
            call()
        except NotImplementedError:
            print(f"[kernel] {name} refuses an input that requires grad",
                  flush=True)
        else:
            raise AssertionError(f"{name} accepted an input requiring grad")
    return out


#: causal-spectrum shapes (label, d, n): the FD path (the response of
#: d = 512 channels on the rfft grid of 2n = 1024) and the fused route's
#: edges at a ragged d
CS_SHAPES = (("path", 512, 512), ("n=1", 37, 1), ("n=2", 37, 2),
             ("n=64", 37, 64), ("n=4096", 37, 4096))
CS_REPLACES = "src/repro/kernels/fd_fused.py:80"


def _cs_cost(d: int, n: int):
    """(bytes, flops) of either causal-spectrum kernel: a (d, n+1) fp32
    and a (d, n+1) complex64 tensor, one read and one written, and two
    real FFTs of length 2n a row at 2.5 N log2 N flops each."""
    return 12 * d * (n + 1), d * 2 * 2.5 * (2 * n) * math.log2(2 * n)


def _cs_entry(name, label, d, n, kernel, plain, library, window, peaks):
    """One causal-spectrum entry: the kernel within 1e-5 × max|plain| (two
    FFTs a side, summed in another order than cuFFT's) and bitwise the same
    over two calls; its time beside the plain version's, the plain PyTorch
    composition's (``library_ms``) and the port's window route's (cuFFT,
    ``hilbert_window``, cuFFT: ``window_route_ms``), each the median of 50
    with L2 evicted."""
    got = _repeat_equal(name, label, kernel)
    want = plain()
    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    nbytes, nops = _cs_cost(d, n)
    e = _kernel_entry(name, CS_REPLACES, got, want, kernel, plain, library,
                      nbytes=nbytes, nops=nops, peaks=peaks, tol=1e-5)
    e["window_route_ms"] = time_ms(window)
    print(f"[kernel] {name} {label} ({d}, {n + 1}): {e}", flush=True)
    return e


def phase_causal_spectrum(peaks) -> dict:
    """The fused causal spectrum (plain and conjugated) and its adjoint at
    every ``CS_SHAPES`` shape against their plain versions on the card,
    with the timings of ``_cs_entry``; the adjoint's random cotangent keeps
    imaginary parts at bins 0 and n, which both sides drop."""
    from repro_torch.kernels import backend, fd_fused, ref
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for label, d, n in CS_SHAPES:
        if backend.causal_spectrum_route(n) != "fused":
            raise AssertionError(f"causal spectrum {label}: n = {n} is off "
                                 "the fused route")
        w = ref.hilbert_window_ref(torch.ones(1, 2 * n, device="cuda"),
                                   n)[0]
        c = torch.full((n + 1,), 1.0 / n, device="cuda")
        c[0] = c[n] = 0.5 / n
        u = torch.randn(d, n + 1, device="cuda", generator=g)
        dk = torch.randn(d, n + 1, dtype=torch.complex64, device="cuda",
                         generator=g)
        for conj in (False, True):
            tag = f"{label} conj" if conj else label

            def library(conj=conj):
                k = torch.fft.rfft(torch.fft.irfft(u, n=2 * n) * w, n=2 * n)
                return torch.conj_physical(k) if conj else k
            e = _cs_entry(
                "causal_spectrum", tag, d, n,
                lambda conj=conj: fd_fused.causal_spectrum(u, conj),
                lambda conj=conj: ref.causal_spectrum_ref(u, conj), library,
                lambda conj=conj: fd_fused.window_route_spectrum(u, conj),
                peaks)
            out.setdefault("causal_spectrum", e)
        e = _cs_entry(
            "causal_spectrum_adjoint", label, d, n,
            lambda: fd_fused.causal_spectrum_adjoint(dk, n),
            lambda: ref.causal_spectrum_adjoint_ref(dk, n),
            lambda: c * torch.fft.rfft(torch.fft.irfft(dk, n=2 * n) * w,
                                       n=2 * n).real,
            lambda: fd_fused.window_route_cotangent(dk, u, n), peaks)
        out.setdefault("causal_spectrum_adjoint", e)
    return out


def reference_grad():
    """``REPRO_PALLAS_GRAD=0`` for the duration of a ``with``: the autograd
    Functions keep their kernel forwards and return autograd's cotangents
    through the plain version."""
    return mock.patch.dict(os.environ, {"REPRO_PALLAS_GRAD": "0"})


def _grads_close(what, got, want, names, tol=1e-5) -> str:
    """Each of ``got`` within ``tol`` × max|want|; returns the report."""
    errs = []
    for name, a, w in zip(names, got, want):
        err, scale = float((a - w).abs().max()), float(w.abs().max())
        errs.append(f"{name} max abs err {err:.3e} (scale {scale:.3e}, limit "
                    f"{tol * scale:.3e})")
        if not err <= tol * scale:
            raise AssertionError(f"{what} {name}: {err} > {tol} x {scale}")
    return "; ".join(errs)


#: FDTNO launches for one differentiated forward and its kernel backward,
#: and with the backward through the reference (REPRO_PALLAS_GRAD=0: the
#: forward's launches alone, as in an inference forward), by the route of
#: n: the fused route's causal spectrum is one launch forward
#: and one conjugated plus one adjoint backward; the window route's
#: Hilbert completion is one ``hilbert_window`` each time
FD_OP_LAUNCHES = {
    "fused": ({"hilbert_window": 0, "causal_spectrum": 2,
               "causal_spectrum_adjoint": 1, "fd_mul": 2, "fd_khat_grad": 1},
              {"hilbert_window": 0, "causal_spectrum": 1,
               "causal_spectrum_adjoint": 0, "fd_mul": 1,
               "fd_khat_grad": 0}),
    "window": ({"hilbert_window": 3, "causal_spectrum": 0,
                "causal_spectrum_adjoint": 0, "fd_mul": 2, "fd_khat_grad": 1},
               {"hilbert_window": 1, "causal_spectrum": 0,
                "causal_spectrum_adjoint": 0, "fd_mul": 1,
                "fd_khat_grad": 0})}


def check_fd_tno_backward(g) -> None:
    """The whole FDTNO backward (conj-spectrum fd_mul, fd_khat_grad, the
    causal spectrum's adjoint) at the training shape, x (8, 512, 512) fp32
    and khat_real (512, 513), on the fused route, and at n = 448 (the
    prefill's length) on the window route, against torch.autograd through
    the plain ref.fd_tno_ref on the card: dx and dkhat_real within 1e-5 ×
    max (the fp32 tier: the batch sums and FFTs run in another order), with
    the launches of ``FD_OP_LAUNCHES``. Under REPRO_PALLAS_GRAD=0 the
    backward is that autograd, counted as bwd_ref, with no backward kernel
    launched."""
    from repro_torch.kernels import backend, fd_fused, ops, ref
    for b, n, d in ((8, 512, 512), (8, 448, 512)):
        route = backend.causal_spectrum_route(n)
        launches, ref_launches = FD_OP_LAUNCHES[route]
        x = torch.randn(b, n, d, device="cuda", generator=g,
                        requires_grad=True)
        k = torch.randn(d, n + 1, device="cuda", generator=g,
                        requires_grad=True)
        cot = torch.randn(b, n, d, device="cuda", generator=g)
        fd_fused.reset_counters()
        got = torch.autograd.grad(ops.fd_tno(x, k), (x, k), cot)
        ran = dict(fd_fused.counters, **fd_fused.op_counters)
        want = torch.autograd.grad(ref.fd_tno_ref(x, k), (x, k), cot)
        names = ("dx", "dkhat_real")
        report = _grads_close("FDTNO backward", got, want, names)
        if ran != {**launches, "fwd": 1, "bwd_kernel": 1, "bwd_ref": 0}:
            raise AssertionError(f"FDTNO forward + backward launched {ran}")
        print(f"[kernel] FDTNO backward x ({b}, {n}, {d}), {route} route, "
              f"vs autograd through ref.fd_tno_ref: {report}; launches "
              f"{ran}", flush=True)
        fd_fused.reset_counters()
        with reference_grad():
            ref_got = torch.autograd.grad(ops.fd_tno(x, k), (x, k), cot)
        ran = dict(fd_fused.counters, **fd_fused.op_counters)
        report = _grads_close("FDTNO REPRO_PALLAS_GRAD=0 backward", ref_got,
                              got, names)
        if ran != {**ref_launches, "fwd": 1, "bwd_kernel": 0, "bwd_ref": 1}:
            raise AssertionError(f"FDTNO under REPRO_PALLAS_GRAD=0 launched "
                                 f"{ran}")
        print(f"[kernel] FDTNO x ({b}, {n}, {d}) under REPRO_PALLAS_GRAD=0 "
              f"vs the kernel backward: {report}; launches {ran}", flush=True)


#: window-route lengths of the spectrum-cotangent checks: the FD prefill's
#: 448 and 8192 (2n = 16384, past the fused route, where cuFFT's C2R keeps
#: the edge bins' imaginary parts that pocketfft drops)
WINDOW_ROUTE_NS = (448, 8192)


def check_window_route_cotangent(g) -> None:
    """The window route's spectrum cotangent on the card against the CPU's
    plain versions, within 1e-5 × max (FFTs summed in another order):

    * ``fd_fused.window_route_cotangent`` of a dk (37, n+1) whose bins 0
      and n have non-zero imaginary parts, at each ``WINDOW_ROUTE_NS``,
      against ``ref.causal_spectrum_adjoint_ref`` on the CPU (which drops
      them, as pocketfft's irfft and the fused kernel do);
    * the whole FDTNO backward at x (1, 8192, 37) (the window route: 3
      ``hilbert_window`` launches) against autograd through
      ``ref.fd_tno_ref`` on the CPU.

    Prints every reading, then raises if any missed."""
    from repro_torch.kernels import backend, fd_fused, ops, ref
    d, missed = 37, []
    for n in WINDOW_ROUTE_NS:
        if backend.causal_spectrum_route(n) != "window":
            raise AssertionError(f"n = {n} is on the fused route")
        dk = torch.randn(d, n + 1, dtype=torch.complex64, device="cuda",
                         generator=g)
        k = torch.randn(d, n + 1, device="cuda", generator=g)
        edge = float(dk.imag[:, [0, n]].abs().max())
        got = fd_fused.window_route_cotangent(dk, k, n).cpu()
        want = ref.causal_spectrum_adjoint_ref(dk.cpu(), n)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        print(f"[kernel] window_route_cotangent dk ({d}, {n + 1}), edge "
              f"bins' imaginary parts up to {edge:.3f}, vs the CPU's "
              f"ref.causal_spectrum_adjoint_ref: max abs err {err:.3e} "
              f"(scale {scale:.3e}, limit {1e-5 * scale:.3e})", flush=True)
        if not err <= 1e-5 * scale:
            missed.append(f"window_route_cotangent n={n}: {err} > 1e-5 x "
                          f"{scale}")
    b, n = 1, 8192
    x = torch.randn(b, n, d, device="cuda", generator=g, requires_grad=True)
    k = torch.randn(d, n + 1, device="cuda", generator=g, requires_grad=True)
    cot = torch.randn(b, n, d, device="cuda", generator=g)
    fd_fused.reset_counters()
    got = torch.autograd.grad(ops.fd_tno(x, k), (x, k), cot)
    ran = dict(fd_fused.counters)
    xc, kc = (t.detach().cpu().requires_grad_() for t in (x, k))
    want = torch.autograd.grad(ref.fd_tno_ref(xc, kc), (xc, kc), cot.cpu())
    try:
        report = _grads_close("FDTNO backward n=8192",
                              tuple(t.cpu() for t in got), want,
                              ("dx", "dkhat_real"))
    except AssertionError as e:
        report = str(e)
        missed.append(report)
    if ran != FD_OP_LAUNCHES["window"][0]:
        missed.append(f"FDTNO at n = {n} launched {ran}")
    print(f"[kernel] FDTNO backward x ({b}, {n}, {d}), window route, vs "
          f"autograd through ref.fd_tno_ref on the CPU: {report}; launches "
          f"{ran}", flush=True)
    if missed:
        raise AssertionError("; ".join(missed))


#: SKI kernel shapes (label, b, n, d, r, m, left): the SKI path with
#: causal and bidirectional taps and the offsets the backward mirrors them
#: to, ragged, n < m, r = n (h = 1), one tap
SKI_SHAPES = (("path", 8, 512, 512, 64, 32, 0),
              ("path bidirectional", 8, 512, 512, 64, 32, 16),
              ("path mirrored", 8, 512, 512, 64, 32, 31),
              ("path bidirectional mirrored", 8, 512, 512, 64, 32, 15),
              ("ragged", 3, 37, 45, 11, 4, 2), ("n<m", 2, 3, 5, 3, 4, 0),
              ("r=n", 2, 64, 40, 64, 8, 3), ("m=1", 2, 40, 33, 7, 1, 0))
#: interp_expand and interp_reduce with the fewest inducing points
#: (label, b, n, d, r)
INTERP_R2 = ("r=2", 2, 40, 33, 2)
#: pass 2 at the ceiling of ``backend.ski_rank_variant``'s dense variant
#: (d·r²·4 <= 64 MB, r <= 512): (label, b, n, d, r, m)
PASS2_CEILING = (("r=181", 8, 512, 512, 181, 32), ("r=512", 8, 512, 64, 512,
                                                    32))


def _tap_pairs(n: int, m: int, left: int) -> int:
    """(j, k) pairs of one batch row and channel whose x row j-k+left lies
    in [0, n): the multiply-adds the tap gradient needs."""
    return sum(max(0, min(n, n + k - left) - max(0, k - left))
               for k in range(m))


def _pass2_entry(label, x, z, a, f, left, peaks, transpose_a=False):
    """ski_fused_pass2 at one shape and offset, 1e-5 × max|plain| (the
    Gram and the conv sum in another order than the plain einsum and
    shift-adds); ``transpose_a`` applies Aᵀ read in place, as the signal
    backward does."""
    from repro_torch.kernels import ref, ski_fused
    b, n, d = x.shape
    r, m = z.shape[1], f.shape[1]

    def kernel():
        return ski_fused.ski_fused_pass2(x, z, a, f, True, left=left,
                                         transpose_a=transpose_a)

    def plain():
        return ref.ski_fused_pass2_ref(x, z, a, f, True, left=left,
                                       transpose_a=transpose_a)
    # conv 2·b·n·d·m, Gram 2·b·d·r², expansion 2·2·b·n·d flops; x, z, A, f
    # read once, y written once
    e = _kernel_entry(
        "ski_fused_pass2", "src/repro/kernels/ski_fused.py:143", kernel(),
        plain(), kernel, plain, None,
        nbytes=4 * (2 * x.numel() + z.numel() + a.numel() + f.numel()),
        nops=2 * b * d * (n * m + r * r + 2 * n), peaks=peaks, tol=1e-5,
        source=SKI_SRC)
    print(f"[kernel] ski_fused_pass2 {label} x ({b}, {n}, {d}), r={r}, m={m}, "
          f"left={left}{', A transposed in place' if transpose_a else ''}: "
          f"{e}", flush=True)
    return e


def _interp_entries(label, x, z, lo, w_lo, peaks) -> dict:
    """interp_reduce and interp_expand at one (n, r), each within 1e-6 ×
    max|plain| (sums of at most 2h+1 terms; two)."""
    from repro_torch.kernels import interp_matvec, ref
    b, n, d = x.shape
    r = z.shape[1]
    w = ref.dense_interp_matrix(lo, w_lo, r)
    nnz_w = int((w != 0).sum())           # W's non-zeros at this (n, r)
    out = {}
    # x read once and z written once (reduce), or the other way (expand);
    # 2 flops a non-zero of W for each (batch row, channel)
    out["interp_reduce"] = _kernel_entry(
        "interp_reduce", "src/repro/kernels/interp_matvec.py:65",
        interp_matvec.interp_reduce(x, lo, w_lo, r),
        ref.interp_reduce_ref(x, lo, w_lo, r),
        lambda: interp_matvec.interp_reduce(x, lo, w_lo, r),
        lambda: ref.interp_reduce_ref(x, lo, w_lo, r),
        lambda: torch.einsum("nr,bnd->brd", w, x),
        nbytes=4 * (x.numel() + z.numel()), nops=2 * b * d * nnz_w,
        peaks=peaks, tol=1e-6, source=SKI_SRC)
    print(f"[kernel] interp_reduce {label} x ({b}, {n}, {d}), r={r}: "
          f"{out['interp_reduce']}", flush=True)
    out["interp_expand"] = _kernel_entry(
        "interp_expand", "src/repro/kernels/interp_matvec.py:154",
        interp_matvec.interp_expand(z, lo, w_lo),
        ref.interp_expand_ref(z, lo, w_lo),
        lambda: interp_matvec.interp_expand(z, lo, w_lo),
        lambda: ref.interp_expand_ref(z, lo, w_lo),
        lambda: torch.einsum("nr,brd->bnd", w, z),
        nbytes=4 * (x.numel() + z.numel()), nops=2 * b * d * nnz_w,
        peaks=peaks, tol=1e-6, source=SKI_SRC)
    print(f"[kernel] interp_expand {label} z ({b}, {r}, {d}), n={n}: "
          f"{out['interp_expand']}", flush=True)
    return out


def _short_conv_entry(label, x, f, left, peaks, tol=1e-5,
                      name="short_conv") -> dict:
    """short_conv at one shape and offset, within 1e-5 × max|plain| in fp32
    (m-term sums with fused multiply-adds against the plain shift-adds;
    ``tol`` BF16_TOL for bf16 x and taps). The library yardstick is
    cuDNN's depthwise conv1d (TF32 off) in x's dtype on a channel-major
    copy of x padded by the taps' reach, made outside the timed call, with
    the taps reversed."""
    from repro_torch.kernels import ref, short_conv
    b, n, d = x.shape
    m = f.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, m - 1 - left, left))
    xp = xp.transpose(1, 2).contiguous()
    wt = f.flip(-1)[:, None, :].contiguous()

    def library():
        return torch.nn.functional.conv1d(xp, wt, groups=d)
    want = ref.short_conv_left_ref(x, f, left)
    lib_err = float((library().transpose(1, 2).float()
                     - want.float()).abs().max())
    if not lib_err <= tol * float(want.float().abs().max()):
        raise AssertionError(f"conv1d is not the short conv: {lib_err}")
    # x and the taps read once, y written once; 2 flops a (j, k) pair whose
    # x row is in range
    e = _kernel_entry(
        name, "src/repro/kernels/short_conv.py:69",
        short_conv.short_conv(x, f, left), want,
        lambda: short_conv.short_conv(x, f, left),
        lambda: ref.short_conv_left_ref(x, f, left), library,
        nbytes=x.element_size() * (2 * x.numel() + f.numel()),
        nops=2 * b * d * _tap_pairs(n, m, left), peaks=peaks, tol=tol,
        source=SHORT_CONV_SRC)
    print(f"[kernel] {name} {label} x ({b}, {n}, {d}) {x.dtype}, m={m}, "
          f"left={left}: {e} (conv1d max abs err {lib_err:.3e})", flush=True)
    return e


def check_interp_adjoint(device="cuda") -> None:
    """The card's interp pair are adjoints: <Wᵀx, z> = <x, W z> within 1e-6
    relative, at the path shape, on positive inputs (no cancellation in
    the inner products, taken in fp64 of the kernels' fp32 outputs)."""
    from repro_torch.core import ski
    from repro_torch.kernels import interp_matvec
    g = torch.Generator(device=device).manual_seed(3)
    b, n, d, r = 8, 512, 512, 64
    x = torch.rand(b, n, d, device=device, generator=g)
    z = torch.rand(b, r, d, device=device, generator=g)
    lo, w_lo, _ = ski.make_inducing(n, r, device)
    lhs = float((interp_matvec.interp_reduce(x, lo, w_lo, r).double()
                 * z.double()).sum())
    rhs = float((x.double()
                 * interp_matvec.interp_expand(z, lo, w_lo).double()).sum())
    rel = abs(lhs - rhs) / abs(rhs)
    print(f"[kernel] adjoint x ({b}, {n}, {d}), r={r}: <W^T x, z> {lhs!r}, "
          f"<x, W z> {rhs!r}, relative difference {rel:.3e} (limit 1e-6)",
          flush=True)
    if not rel <= 1e-6:
        raise AssertionError(f"interp_reduce and interp_expand are not "
                             f"adjoint on the card: {rel}")


#: interp_expand's ``ms_run`` shapes (label, b, n, d, r): the SKI path
#: (h = 8.1), eight nodes (h = 73, the most rows on one node pair) and
#: r = n (h = 1: a node a row)
EXPAND_RUN_SHAPES = (("path", 8, 512, 512, 64), ("r=8", 8, 512, 512, 8),
                     ("r=n", 8, 512, 512, 512))


def _run_sets(nbytes: int) -> int:
    """Distinct input sets of ``nbytes`` each that a ``time_ms_run`` cycles
    through, so that the launches' inputs and outputs exceed
    RUN_COLD_BYTES."""
    return math.ceil(RUN_COLD_BYTES / nbytes) + 1


def expand_runs(peaks, device, g) -> dict:
    """``ms_run`` and ``ms`` of interp_expand at EXPAND_RUN_SHAPES with
    their bytes bounds, {label: {"ms_run", "ms", "bound_ms", "sets"}}, and
    under "write floor" the card's floor for writing the path's y alone in
    one launch: ``y.zero_()`` on a (8, 512, 512) fp32 tensor, timed the
    same way."""
    from repro_torch.core import ski
    from repro_torch.kernels import interp_matvec
    out = {}
    for label, b, n, d, r in EXPAND_RUN_SHAPES:
        lo, w_lo, _ = ski.make_inducing(n, r, device)
        sets = _run_sets(4 * (b * n * d + b * r * d))
        zs = [torch.randn(b, r, d, device=device, generator=g)
              for _ in range(sets)]
        calls = [lambda z=z: interp_matvec.interp_expand(z, lo, w_lo)
                 for z in zs]
        out[label] = {"ms_run": time_ms_run(calls)["ms_run"],
                      "ms": time_ms(calls[0]),
                      "bound_ms": 4 * (b * n * d + b * r * d) / peaks[0] * 1e3,
                      "sets": sets}
        del zs, calls
    _, b, n, d, _ = EXPAND_RUN_SHAPES[0]
    sets = _run_sets(4 * b * n * d)
    ys = [torch.empty(b, n, d, device=device) for _ in range(sets)]
    calls = [lambda y=y: y.zero_() for y in ys]
    out["write floor"] = {"ms_run": time_ms_run(calls)["ms_run"],
                          "ms": time_ms(calls[0]),
                          "bound_ms": 4 * b * n * d / peaks[0] * 1e3,
                          "sets": sets}
    return out


def interp_runs(entries, peaks, device, g) -> None:
    """``ms_run`` (``time_ms_run``: 64 launches an event pair over input and
    output sets of more than 200 MB, median of 5) of interp_reduce at the
    SKI path's shape into its entry, and of interp_expand at
    EXPAND_RUN_SHAPES beside the write floor (``expand_runs``); the path's
    into interp_expand's entry."""
    from repro_torch.core import ski
    from repro_torch.kernels import interp_matvec
    _, b, n, d, r, _, _ = SKI_SHAPES[0]
    lo, w_lo, _ = ski.make_inducing(n, r, device)
    sets = _run_sets(4 * (b * n * d + b * r * d))
    xs = [torch.randn(b, n, d, device=device, generator=g)
          for _ in range(sets)]
    run = time_ms_run([lambda x=x: interp_matvec.interp_reduce(x, lo, w_lo, r)
                       for x in xs])
    del xs
    e = entries["interp_reduce"]
    e["ms_run"] = run["ms_run"]
    print(f"[kernel] interp_reduce path x ({b}, {n}, {d}), r={r}: ms_run "
          f"{run['ms_run']:.5f} ({RUN_LAUNCHES} launches an event pair over "
          f"{sets} input sets and {RUN_LAUNCHES} outputs, median of "
          f"{RUN_REPS}; host enqueue {run['enqueue_ms']:.3f} ms inside a "
          f"{run['sleep_ms']:.3f} ms sleep); ms (one launch an event pair) "
          f"{e['ms']:.5f}; bound {e['bound_ms']:.5f} ({e['bound_by']}); "
          f"ms_run / bound {run['ms_run'] / e['bound_ms']:.2f}", flush=True)
    runs = expand_runs(peaks, device, g)
    entries["interp_expand"]["ms_run"] = runs["path"]["ms_run"]
    entries["interp_expand"]["ms_run_shapes"] = runs
    for label, t in runs.items():
        what = ("y.zero_() of the path's y" if label == "write floor" else
                "interp_expand " + label)
        print(f"[kernel] {what}: ms_run {t['ms_run']:.5f} (over {t['sets']} "
              f"sets), ms (one launch an event pair) {t['ms']:.5f}; bound "
              f"{t['bound_ms']:.5f} (bytes); ms_run / bound "
              f"{t['ms_run'] / t['bound_ms']:.2f}", flush=True)


def phase_ski_kernels(peaks, device="cuda") -> dict:
    """The dense forward's four SKI kernels against their plain versions at
    SKI_SHAPES: interp_reduce and interp_expand within 1e-6 × max|plain|
    (sums of at most 2h+1 and two terms), ski_fused_pass2 and short_conv
    within 1e-5 × max|plain|; the interp pair also at r = 2 and as
    adjoints; then pass 2 at PASS2_CEILING in both orientations. Returns
    the entries at every SKI_SHAPES shape and the interp pair's at
    INTERP_R2, {label: {kernel: entry}}."""
    from repro_torch.core import ski
    g = torch.Generator(device=device).manual_seed(1)
    out = {}
    for label, b, n, d, r, m, left in SKI_SHAPES:
        x = torch.randn(b, n, d, device=device, generator=g)
        z = torch.randn(b, r, d, device=device, generator=g)
        a = torch.randn(d, r, r, device=device, generator=g)
        f = torch.randn(d, m, device=device, generator=g)
        lo, w_lo, _ = ski.make_inducing(n, r, device)
        entries = _interp_entries(label, x, z, lo, w_lo, peaks)
        entries["short_conv"] = _short_conv_entry(label, x, f, left, peaks)
        entries["ski_fused_pass2"] = _pass2_entry(label, x, z, a, f, left,
                                                  peaks)
        out[label] = entries
    interp_runs(out["path"], peaks, device, g)
    label, b, n, d, r = INTERP_R2
    lo, w_lo, _ = ski.make_inducing(n, r, device)
    out[label] = _interp_entries(
        label, torch.randn(b, n, d, device=device, generator=g),
        torch.randn(b, r, d, device=device, generator=g), lo, w_lo, peaks)
    check_interp_adjoint(device)
    for label, b, n, d, r, m in PASS2_CEILING:
        x = torch.randn(b, n, d, device=device, generator=g)
        z = torch.randn(b, r, d, device=device, generator=g)
        a = torch.randn(d, r, r, device=device, generator=g)
        f = torch.randn(d, m, device=device, generator=g)
        f_t = f.flip(-1).contiguous()
        for left in (0, m // 2):
            _pass2_entry(f"ceiling {label}", x, z, a, f, left, peaks)
            _pass2_entry(f"ceiling {label} backward orientation", x, z, a,
                         f_t, m - 1 - left, peaks, transpose_a=True)
    return out


def _repeat_equal(name, label, fn) -> torch.Tensor:
    """``fn()`` twice on the same inputs gives the same bits (the kernels
    sum in a fixed order, with no atomics)."""
    got = fn()
    if not torch.equal(got, fn()):
        raise AssertionError(f"{name} {label}: two calls differ")
    return got


def _gram_grad_entry(label, gz, z, peaks) -> dict:
    """gram_grad within 1e-6 × max|plain| (sums of b terms) and bitwise
    the same over two calls; gz, z read once, dA written once; 2·b·d·r²
    flops. The library yardstick: the plain version's one einsum."""
    from repro_torch.kernels import ref, ski_grad
    b, r, d = z.shape
    e = _kernel_entry(
        "gram_grad", "src/repro/kernels/ski_grad.py:149",
        _repeat_equal("gram_grad", label,
                      lambda: ski_grad.gram_grad(gz, z)),
        ref.gram_grad_ref(gz, z), lambda: ski_grad.gram_grad(gz, z),
        lambda: ref.gram_grad_ref(gz, z),
        lambda: torch.einsum("bsc,btc->cst", gz, z),
        nbytes=4 * (2 * z.numel() + d * r * r), nops=2 * b * d * r * r,
        peaks=peaks, tol=1e-6, source=SKI_GRAD_SRC)
    print(f"[kernel] gram_grad {label} gz, z ({b}, {r}, {d}), two calls "
          f"bitwise equal: {e}", flush=True)
    return e


def _conv_tap_grad_entry(label, cot, x, m, left, peaks,
                         name="conv_tap_grad") -> dict:
    """conv_tap_grad within 1e-5 × max|plain| (4,096 terms at the SKI path
    shape, 16,384 at Mamba's conv, in another order; bf16 inputs are exact
    and both sides sum in fp32, so the bf16 instance ``name`` =
    "conv_tap_grad_bf16" takes the same limit) and bitwise the same over
    two calls; g, x read once (in their dtype), df written once (fp32); 2
    flops a (j, k) pair in range. The library yardstick: cuDNN's depthwise
    conv1d weight gradient (TF32 off) in the inputs' dtype on
    channel-major copies of g and of x padded by the taps' reach, made
    outside the timed call; it gives the taps in reverse order (in bf16
    rounded once to bf16, so held within BF16_TOL)."""
    from repro_torch.kernels import ref, ski_grad
    b, n, d = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, m - 1 - left, left))
    xp = xp.transpose(1, 2).contiguous()
    gt = cot.transpose(1, 2).contiguous()

    def library():
        return torch.nn.grad.conv1d_weight(xp, (d, 1, m), gt, groups=d)
    want = ref.conv_tap_grad_ref(cot, x, m, left)
    lib_err = float((library()[:, 0].flip(-1).float() - want).abs().max())
    lib_tol = 1e-5 if x.dtype == torch.float32 else BF16_TOL
    if not lib_err <= lib_tol * float(want.abs().max()):
        raise AssertionError(f"conv1d_weight is not the tap gradient: "
                             f"{lib_err}")
    e = _kernel_entry(
        name, "src/repro/kernels/ski_grad.py:71",
        _repeat_equal(name, label,
                      lambda: ski_grad.conv_tap_grad(cot, x, m, left)),
        want, lambda: ski_grad.conv_tap_grad(cot, x, m, left),
        lambda: ref.conv_tap_grad_ref(cot, x, m, left), library,
        nbytes=2 * x.element_size() * x.numel() + 4 * d * m,
        nops=2 * b * d * _tap_pairs(n, m, left), peaks=peaks, tol=1e-5,
        source=SKI_GRAD_SRC)
    print(f"[kernel] {name} {label} g, x ({b}, {n}, {d}) {x.dtype}, m={m}, "
          f"left={left}, two calls bitwise equal: {e} (conv1d_weight max "
          f"abs err {lib_err:.3e})", flush=True)
    return e


#: conv_tap_grad beyond SKI_SHAPES (label, b, n, d, m, left): more taps
#: than a tap pass (13 passes), and more batch rows than a tile's blocks
#: (a block takes two, its x ring carried from one to the next)
TAP_GRAD_SHAPES = (("m=400", 8, 512, 512, 400, 200),
                   ("b=12", 12, 300, 40, 32, 16))


def phase_grad_kernels(peaks, device="cuda") -> dict:
    """The dense backward's two parameter-cotangent kernels against their
    plain versions, each also bitwise against a second call: gram_grad and
    conv_tap_grad at SKI_SHAPES, gram_grad at PASS2_CEILING (dA of 67 MB,
    the dense route's largest), conv_tap_grad at TAP_GRAD_SHAPES; then the
    whole SKIFusedTNO backward. Returns the entries at the path's shape."""
    g = torch.Generator(device=device).manual_seed(2)
    out = {}
    for label, b, n, d, r, m, left in SKI_SHAPES:
        x = torch.randn(b, n, d, device=device, generator=g)
        cot = torch.randn(b, n, d, device=device, generator=g)
        z = torch.randn(b, r, d, device=device, generator=g)
        gz = torch.randn(b, r, d, device=device, generator=g)
        entries = {"gram_grad": _gram_grad_entry(label, gz, z, peaks),
                   "conv_tap_grad": _conv_tap_grad_entry(label, cot, x, m,
                                                         left, peaks)}
        if label == "path":
            out.update(entries)
    for label, b, n, d, r, m in PASS2_CEILING:
        _gram_grad_entry(f"ceiling {label}",
                         torch.randn(b, r, d, device=device, generator=g),
                         torch.randn(b, r, d, device=device, generator=g),
                         peaks)
    for label, b, n, d, m, left in TAP_GRAD_SHAPES:
        _conv_tap_grad_entry(label,
                             torch.randn(b, n, d, device=device, generator=g),
                             torch.randn(b, n, d, device=device, generator=g),
                             m, left, peaks)
    check_ski_backward(g)
    return out


#: the launch count of every SKI kernel at 0, for the exact-count checks
NO_SKI_LAUNCHES = {"interp_reduce": 0, "interp_reduce_bf16": 0,
                   "interp_expand": 0, "interp_expand_bf16": 0,
                   "short_conv": 0, "ski_fused_pass2": 0,
                   "ski_fused_pass2_bf16": 0, "ski_fused_pass2_at_bf16": 0,
                   "ski_windowed_pass2": 0, "ski_windowed_pass2_bf16": 0,
                   "ski_expand_pass2": 0, "ski_expand_pass2_bf16": 0,
                   "gram_grad": 0, "gram_grad_bf16": 0, "conv_tap_grad": 0,
                   "conv_tap_grad_bf16": 0}
#: SKIFusedTNO backward checks (label, r, d, causal), b = 8, n = 512, m = 32
SKI_BACKWARD = (("causal", 64, 512, True), ("bidirectional", 64, 512, False),
                ("causal r=181", 181, 512, True))


def check_ski_backward(g) -> None:
    """The whole SKIFusedTNO backward (interp_reduce twice, the transposed
    pass 2, gram_grad, conv_tap_grad) against torch.autograd through the
    plain ref.ski_fused_tno_ref on the card: dx, dA and df within 1e-5 ×
    max (the fp32 tier), with 3 / 2 / 1 / 1 launches and one kernel
    backward. Then the same under REPRO_PALLAS_GRAD=0: one reference
    backward, no gram_grad or conv_tap_grad launch, and the same gradients
    within the same tolerance."""
    from repro_torch.core import ski
    from repro_torch.kernels import ops, ref, ski_vjp
    b, n, m = 8, 512, 32
    names = ("dx", "dA", "df")
    for label, r, d, causal in SKI_BACKWARD:
        x = torch.randn(b, n, d, device="cuda", generator=g,
                        requires_grad=True)
        a = torch.randn(d, r, r, device="cuda", generator=g,
                        requires_grad=True)
        f = torch.randn(d, m, device="cuda", generator=g, requires_grad=True)
        cot = torch.randn(b, n, d, device="cuda", generator=g)
        lo, w_lo, _ = ski.make_inducing(n, r, "cuda")

        def grads():
            ops.reset_ski_counters()
            out = torch.autograd.grad(
                ops.ski_fused_tno(x, a, f, lo, w_lo, r, causal), (x, a, f),
                cot)
            return out, dict(ops.ski_counters(), **ski_vjp.counters)
        got, ran = grads()
        want = torch.autograd.grad(
            ref.ski_fused_tno_ref(x, a, f, lo, w_lo, r, causal), (x, a, f),
            cot)
        report = _grads_close(f"SKIFusedTNO backward ({label})", got, want,
                              names)
        if ran != {**NO_SKI_LAUNCHES, "interp_reduce": 3,
                   "ski_fused_pass2": 2, "gram_grad": 1, "conv_tap_grad": 1,
                   "fwd": 1, "bwd_kernel": 1, "bwd_ref": 0}:
            raise AssertionError(f"SKIFusedTNO ({label}) launched {ran}")
        print(f"[kernel] SKIFusedTNO backward ({label}) x ({b}, {n}, {d}), "
              f"r={r}, m={m} vs autograd through ref.ski_fused_tno_ref: "
              f"{report}; launches {ran}", flush=True)
        with reference_grad():
            ref_got, ran = grads()
        report = _grads_close(f"SKIFusedTNO REPRO_PALLAS_GRAD=0 ({label})",
                              ref_got, got, names)
        if ran != {**NO_SKI_LAUNCHES, "interp_reduce": 1,
                   "ski_fused_pass2": 1, "fwd": 1, "bwd_kernel": 0,
                   "bwd_ref": 1}:
            raise AssertionError(f"SKIFusedTNO under REPRO_PALLAS_GRAD=0 "
                                 f"({label}) launched {ran}")
        print(f"[kernel] SKIFusedTNO under REPRO_PALLAS_GRAD=0 ({label}) vs "
              f"the kernel backward: {report}; launches {ran}", flush=True)


#: windowed pass-2 shapes (label, b, n, d, r, m, left): the large-rank
#: path (ski-tnn-lm-wt103 at tno_rank 512) with causal and bidirectional
#: taps and their mirrors, r just past the dense ceiling and at the
#: windowed one, odd r (r % 4 != 0) with the 16-byte x copies (8 batch
#: rows, d % 4 == 0) and without, ragged, n < m, r = n, r = 2, one tap
WINDOW_SHAPES = (("path", 8, 512, 512, 512, 32, 0),
                 ("path bidirectional", 8, 512, 512, 512, 32, 16),
                 ("path mirrored", 8, 512, 512, 512, 32, 31),
                 ("path bidirectional mirrored", 8, 512, 512, 512, 32, 15),
                 ("r=513", 2, 4096, 16, 513, 32, 0),
                 ("r=4096", 2, 4096, 16, 4096, 32, 16),
                 ("r=181", 8, 512, 64, 181, 32, 16),
                 ("r=4097", 2, 4099, 16, 4097, 32, 3),
                 ("ragged", 3, 37, 45, 11, 4, 2), ("n<m", 2, 3, 5, 3, 4, 0),
                 ("r=n", 2, 64, 40, 64, 8, 3), ("r=2", 2, 40, 33, 2, 8, 3),
                 ("m=1", 2, 40, 33, 7, 1, 0))
WINDOWED_REPLACES = "src/repro/kernels/ski_fused.py:296"
#: ski_expand_pass2 beyond WINDOW_SHAPES (label, b, n, d, r, m, left):
#: n = r = 8192, and a large input at the model's width on the "fft"
#: route (r past the windowed ceiling of 4096, and just past it), x (2,
#: 8192, 512) fp32: x, z2 and y 96 MB at r = 8192
EXPAND_SHAPES = (("n=r=8192", 2, 8192, 16, 8192, 32, 16),
                 ("large r=8192", 2, 8192, 512, 8192, 32, 0),
                 ("large r=4097", 2, 8192, 512, 4097, 32, 0))


def _window_tol(r: int) -> float:
    """1e-5 × max|plain| to r = 512, 1e-4 beyond, as the JAX package's
    tests/test_ski_large_r.py gates (sums of r terms in another order)."""
    return 1e-5 if r <= 512 else 1e-4


def _windowed_cost(b, n, d, r, m):
    """(bytes, Gram flops, conv and expansion flops) of ski_windowed_pass2:
    x, z, the (d, 2r - 1) coefficients and f read once, y written once;
    the Gram 2·b·d·r², the conv 2·b·n·d·m, the expansion 2·2·b·n·d."""
    nbytes = 4 * (2 * b * n * d + b * r * d + d * (2 * r - 1) + d * m)
    return nbytes, 2 * b * d * r * r, 2 * b * d * (n * m + 2 * n)


def _windowed_entry(label, x, z, coef, f, left, peaks):
    """ski_windowed_pass2 against the plain rfft Gram and expansion, and
    against itself: two calls give the same bits. The Gram is 2·b·d·r²
    flops (the windows of neighbouring tiles overlap by a few rows more),
    run on the tensor cores as three TF32 products (3xTF32), so it is
    priced at three times that over the TF32 peak; the conv (2·b·n·d·m)
    and the expansion (2·2·b·n·d) at the fp32 peak on the CUDA cores,
    which run beside the tensor cores. x, z, the coefficients and f read
    once, y written once. The printed line keeps each term of the bound and
    the all-CUDA-core figure (every flop at the fp32 peak, the bound
    before the Gram moved to the tensor cores) for the record."""
    from repro_torch.kernels import ref, ski_fused
    b, n, d = x.shape
    r, m = z.shape[1], f.shape[1]

    def plain():
        return ref.ski_expand_pass2_ref(
            x, ref.toeplitz_gram_matvec_ref(coef, z), f, True, left=left)

    def kernel():
        return ski_fused.ski_windowed_pass2(x, z, coef, f, True, left=left)
    got = kernel()
    if not torch.equal(got, kernel()):
        raise AssertionError(f"ski_windowed_pass2 {label}: two calls differ")
    nbytes, gram, rest = _windowed_cost(b, n, d, r, m)
    e = _kernel_entry(
        "ski_windowed_pass2", WINDOWED_REPLACES, got, plain(), kernel, plain,
        None, nbytes=nbytes, nops=((3 * gram, peaks[2], "tensor cores"),
                                   (rest, peaks[1], "cuda cores")),
        peaks=peaks, tol=_window_tol(r), source=SKI_SRC)
    print(f"[kernel] ski_windowed_pass2 {label} x ({b}, {n}, {d}), r={r}, "
          f"m={m}, left={left}, band_max "
          f"{os.environ.get('REPRO_SKI_BAND_MAX') or 'default'}: {e}; "
          f"beside the bound: bytes {nbytes / peaks[0] * 1e3:.5f} ms, "
          f"Gram on the tensor cores {3 * gram / peaks[2] * 1e3:.5f} ms, "
          f"conv and expansion on the CUDA cores "
          f"{rest / peaks[1] * 1e3:.5f} ms, all at the fp32 peak "
          f"{(gram + rest) / peaks[1] * 1e3:.5f} ms", flush=True)
    return e


def _expand_entry(label, x, z2, f, left, peaks):
    """ski_expand_pass2 against the plain expansion: x, z2, f read once, y
    written once; 2·b·n·d·m conv and 2·2·b·n·d expansion flops."""
    from repro_torch.kernels import ref, ski_fused
    b, n, d = x.shape
    r, m = z2.shape[1], f.shape[1]
    e = _kernel_entry(
        "ski_expand_pass2", WINDOWED_REPLACES,
        ski_fused.ski_expand_pass2(x, z2, f, True, left=left),
        ref.ski_expand_pass2_ref(x, z2, f, True, left=left),
        lambda: ski_fused.ski_expand_pass2(x, z2, f, True, left=left),
        lambda: ref.ski_expand_pass2_ref(x, z2, f, True, left=left), None,
        nbytes=4 * (2 * x.numel() + z2.numel() + f.numel()),
        nops=2 * b * d * (n * m + 2 * n), peaks=peaks, tol=_window_tol(r),
        source=SKI_SRC)
    print(f"[kernel] ski_expand_pass2 {label} x ({b}, {n}, {d}), r={r}, "
          f"m={m}, left={left}: {e}", flush=True)
    return e


def _windowed_vs_fp64(x, z, coef, f, left) -> None:
    """The windowed kernel and the fp32 plain version (rfft Gram) against a
    float64 version (dense Gram, dense W, shifted adds), so that the
    kernel's own error shows apart from the FFT's round-off: the kernel
    within 1e-5 × max."""
    from repro_torch.core import ski, toeplitz
    from repro_torch.kernels import ref, ski_fused
    b, n, d = x.shape
    r, m = z.shape[1], f.shape[1]
    z2 = torch.einsum("dst,btd->bsd",
                      toeplitz.dense_toeplitz(coef.double(), r), z.double())
    lo, w_lo, _ = ski.make_inducing(n, r, x.device)
    want = torch.einsum("nr,brd->bnd",
                        ref.dense_interp_matrix(lo, w_lo, r).double(), z2)
    xp = torch.nn.functional.pad(x.double(), (0, 0, m - 1 - left, left))
    for k in range(m):
        want += xp[:, m - 1 - k:m - 1 - k + n] * f[:, k].double()
    scale = float(want.abs().max())
    got = ski_fused.ski_windowed_pass2(x, z, coef, f, True, left=left)
    plain = ref.ski_expand_pass2_ref(
        x, ref.toeplitz_gram_matvec_ref(coef, z), f, True, left=left)
    err = float((got.double() - want).abs().max())
    perr = float((plain.double() - want).abs().max())
    print(f"[kernel] ski_windowed_pass2 x ({b}, {n}, {d}), r={r}, left={left} "
          f"vs float64: kernel max abs err {err:.3e}, fp32 plain (rfft) "
          f"{perr:.3e} (scale {scale:.3e}, limit {1e-5 * scale:.3e})",
          flush=True)
    if not err <= 1e-5 * scale:
        raise AssertionError(f"ski_windowed_pass2 vs float64: {err}")


def phase_window_kernels(peaks, device="cuda") -> dict:
    """ski_windowed_pass2 and ski_expand_pass2 against their plain versions
    at WINDOW_SHAPES; the windowed one also under REPRO_SKI_BAND_MAX=16
    (a tile then takes a window of 16 rows: many tiles, many chunks) and
    against float64, the expand one also at EXPAND_SHAPES (n = r = 8192,
    and x (2, 8192, 512) at r = 8192 and 4097). Returns the entries at
    every shape, {label: {kernel: entry}}."""
    g = torch.Generator(device=device).manual_seed(7)
    out = {}
    for label, b, n, d, r, m, left in WINDOW_SHAPES:
        x = torch.randn(b, n, d, device=device, generator=g)
        z = torch.randn(b, r, d, device=device, generator=g)
        coef = torch.randn(d, 2 * r - 1, device=device,
                           generator=g) / math.sqrt(r)
        f = torch.randn(d, m, device=device, generator=g)
        entries = {"ski_windowed_pass2": _windowed_entry(label, x, z, coef, f,
                                                         left, peaks),
                   "ski_expand_pass2": _expand_entry(label, x, z, f, left,
                                                     peaks)}
        out[label] = entries
        if label == "path":
            _windowed_vs_fp64(x, z, coef, f, left)
        if label in ("path", "r=4096"):
            with mock.patch.dict(os.environ, {"REPRO_SKI_BAND_MAX": "16"}):
                _windowed_entry(label, x, z, coef, f, left, peaks)
    for label, b, n, d, r, m, left in EXPAND_SHAPES:
        out[label] = {"ski_expand_pass2": _expand_entry(
            label, torch.randn(b, n, d, device=device, generator=g),
            torch.randn(b, r, d, device=device, generator=g),
            torch.randn(d, m, device=device, generator=g), left, peaks)}
    return out


# --------------------------------------------------------------- phase 4
def phase_serve(cfg, device, prompts: int, prompt_len: int, gen_len: int):
    """Returns (model, prompt length, generated sequences, launch counts,
    decode new tokens/s)."""
    from repro_torch.kernels import backend, fd_fused
    from repro_torch.launch.serve import generate
    from repro_torch.models.serving import prefill
    from repro_torch.models.transformer import init_model
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator().manual_seed(0), device=device)
    n_params = sum(p.numel() for p in model.parameters())
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (prompts, prompt_len))).to(device)
    max_len = prompt_len + gen_len
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"vocab {cfg.vocab} (padded {cfg.vocab_padded}), {n_params} "
          f"parameters, built in {time.perf_counter() - t0:.2f} s; "
          f"{prompts} prompts x {prompt_len} tokens + {gen_len} new, "
          f"max_len {max_len}", flush=True)
    with torch.inference_mode():
        # warm-up (cuFFT plans, cuBLAS handles); its launches are not counted
        prefill(model, cfg, prompt)
        generate(model, cfg, prompt, 2, max_len=max_len)
        _sync(device)

        fd_fused.reset_counters()
        t_wall = time.perf_counter()
        logits = prefill(model, cfg, prompt)
        _sync(device)
        t_prefill = time.perf_counter() - t_wall
        in_prefill = dict(fd_fused.counters)
        t0 = time.perf_counter()
        generate(model, cfg, prompt, 1, max_len=max_len)
        _sync(device)
        t_ingest = time.perf_counter() - t0
        t0 = time.perf_counter()
        seqs = generate(model, cfg, prompt, gen_len, max_len=max_len)
        _sync(device)
        t_gen = time.perf_counter() - t0
        launches = dict(fd_fused.counters)
        wall = time.perf_counter() - t_wall
    if not (logits.shape == (prompts, prompt_len, cfg.vocab_padded)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             "not finite or of the wrong shape")
    if seqs.shape != (prompts, max_len) or not torch.equal(
            seqs[:, :prompt_len], prompt):
        raise AssertionError(f"generate returned {tuple(seqs.shape)}")
    decode_tps = prompts * (gen_len - 1) / (t_gen - t_ingest)
    print(f"[serve] prefill {prompts}x{prompt_len}: {t_prefill * 1e3:.3f} ms "
          f"({prompts * prompt_len / t_prefill:.0f} tok/s); generate "
          f"{gen_len} new: {t_gen:.3f} s ({prompts * gen_len / t_gen:.1f} "
          f"new tok/s incl. chunked prefill {t_ingest:.3f} s); decode "
          f"{decode_tps:.1f} tok/s; wall {wall:.3f} s", flush=True)
    print(f"[serve] kernel launches: prefill {in_prefill}, prefill + "
          f"generate {launches}", flush=True)
    # one inference forward a layer: its Hilbert completion on the route of
    # the prompt's length (n = 448: the window route) and one fd_mul
    route = backend.causal_spectrum_route(prompt_len)
    want = {k: v * cfg.n_layers for k, v in FD_OP_LAUNCHES[route][1].items()}
    if in_prefill != want:
        raise AssertionError(f"prefill ({route} route) launched "
                             f"{in_prefill}, not {want}")
    return model, prompt_len, seqs, launches, decode_tps


# -------------------------------------------------------------- phase 4b
#: the engine phase's traffic: 16 prompt lengths, chunk-aligned (64, 128,
#: 384, 448) and ones that need the token remainder, each with 8-64 new
#: tokens (seeded), through S = 8 slots of max_len 512 (C = 64, buckets
#: 64/128/256/512): the first 8 as one packed prefill wave, the rest one
#: by one as slots free
ENGINE_PLENS = (1, 17, 63, 64, 65, 100, 128, 200, 255, 300, 333, 384, 400,
                420, 447, 448)
ENGINE_SLOTS, ENGINE_MAX_LEN = 8, 512
#: the poison run poisons this request's slot before this generate step
ENGINE_POISON = (5, 3)
#: the sampled runs' settings; request i is seeded 100 + i
ENGINE_SAMPLED = {"temperature": 0.7, "top_k": 8}


def _engine_traffic(vocab: int, plens, max_len: int):
    """Seeded prompts and new-token counts (8-64, within max_len)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, (p,)) for p in plens]
    gens = [min(int(g), max_len - p)
            for g, p in zip(rng.integers(8, 65, len(plens)), plens)]
    return prompts, gens


def engine_run(eng, prompts, gens, seeds=None, poison=None) -> dict:
    """Serve every request through ``eng``: the first S prompts as one
    ``prefill_packed`` wave, the others one by one by ``prefill`` as slots
    free, one ``generate`` a step, finished slots released. ``poison`` =
    (step, request) poisons that request's slot before that step. Returns
    tokens and ok per request, the prefill waves' ms, the generate steps'
    seconds and the counts (host clock, ``_sync`` before each read)."""
    dev = eng.device
    seeds = seeds or [0] * len(prompts)
    queue = list(range(len(prompts)))
    out = {i: [] for i in queue}
    oks = {i: True for i in queue}
    slot_of, free = {}, list(range(eng.slots))
    waves, t_gen, steps, packed = [], 0.0, 0, 0
    state = eng.init_state()

    def admit(state, i, slot, cache, first, plen, row=None):
        out[i].append(int(first))
        slot_of[slot] = i
        if row is None:
            return eng.insert(state, cache, plen, first, slot, seed=seeds[i])
        return eng.insert_from(state, cache, row, plen, first, slot,
                               seed=seeds[i])

    _sync(dev)
    t0 = time.perf_counter()
    wave = [queue.pop(0) for _ in range(min(len(free), len(queue)))]
    cache, first, plens = eng.prefill_packed([prompts[i] for i in wave],
                                             [seeds[i] for i in wave])
    _sync(dev)
    waves.append((len(wave), (time.perf_counter() - t0) * 1e3))
    packed += 1
    for row, i in enumerate(wave):
        state = admit(state, i, free.pop(0), cache, first[row], plens[row],
                      row)
    while queue or slot_of:
        while queue and free:
            i = queue.pop(0)
            t0 = time.perf_counter()
            cache, first, plen = eng.prefill(prompts[i], seed=seeds[i])
            _sync(dev)
            waves.append((1, (time.perf_counter() - t0) * 1e3))
            state = admit(state, i, free.pop(0), cache, first, plen)
        if poison is not None and steps == poison[0]:
            slot = next(s for s, i in slot_of.items() if i == poison[1])
            state = eng.poison_slot(state, slot)
        t0 = time.perf_counter()
        state, toks, ok = eng.generate(state)      # reads back: synced
        t_gen += time.perf_counter() - t0
        steps += 1
        for slot, i in list(slot_of.items()):
            if ok[slot]:
                out[i].append(int(toks[slot]))
            else:
                oks[i] = False
            if not ok[slot] or len(out[i]) >= gens[i]:
                state = eng.release(state, slot)
                del slot_of[slot]
                free.append(slot)
    new = sum(len(t) - 1 for t in out.values())     # tokens of the steps
    return {"tokens": out, "ok": oks, "waves": waves, "t_gen": t_gen,
            "steps": steps, "prefills": len(waves), "packed": packed,
            "new": new}


def _engine_report(tag: str, run: dict) -> None:
    waves = ", ".join(f"{b}x{ms:.3f}" for b, ms in run["waves"])
    print(f"[engine] {tag}: {run['steps']} generate steps, {run['new']} new "
          f"tokens in {run['t_gen']:.3f} s ({run['new'] / run['t_gen']:.1f} "
          f"new tok/s); {run['prefills']} prefills ({run['packed']} packed); "
          f"prefill waves (prompts x ms): {waves}", flush=True)


def _margin_limits(model, cfg, solo, prompts, n: int | None = None) -> list:
    """For each request, how many of its new tokens come before the first
    position where the kernel-path forward over its solo sequence has a
    top-2 margin <= MARGIN (the first new token has none before it).
    ``n`` pads each sequence with zeros to n tokens before the forward (a
    causal model's earlier logits do not see the padding): the baseline's
    kernel depends on the length, and its decode is the forward at n =
    max_len."""
    from repro_torch.models.transformer import forward
    limits = []
    with torch.inference_mode():
        for seq, pr in zip(solo, prompts):
            m = len(seq)
            if n is not None:
                seq = torch.nn.functional.pad(seq, (0, n - m))
            logits = forward(model, cfg, seq[None])[0, len(pr) - 1:m - 1]
            top2 = torch.topk(logits, 2, dim=-1).values
            low = ((top2[:, 0] - top2[:, 1]) <= MARGIN).nonzero()
            limits.append(int(low[0]) if len(low) else logits.shape[0])
    return limits


def _held(what: str, got: dict, want: list, limits: list,
          skip=()) -> tuple[int, int]:
    """Compare each request's tokens with ``want`` up to its limit; a
    mismatch raises. Returns (positions checked, positions skipped)."""
    checked = skipped = 0
    for i, lim in enumerate(limits):
        if i in skip:
            continue
        n = min(lim, len(got[i]), len(want[i]))
        if got[i][:n] != want[i][:n]:
            bad = next(k for k in range(n) if got[i][k] != want[i][k])
            raise AssertionError(f"{what}: request {i} differs at new token "
                                 f"{bad} (margin limit {lim}): "
                                 f"{got[i][:n]} != {want[i][:n]}")
        checked += n
        skipped += len(want[i]) - n
    return checked, skipped


def phase_engine(cfg, model, device, plens=ENGINE_PLENS,
                 slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN) -> dict:
    """The continuous-batching engine on the serve phase's model: the
    traffic of :data:`ENGINE_PLENS` greedily (launch counts read from
    this run: one Engine realises its kernel constants once), each
    request's tokens held against ``launch.serve.generate`` of its prompt
    alone at the same max_len under the margin rule; the same traffic
    with one slot poisoned (only that request ends not-ok, the others keep
    the clean run's tokens); and a sampled engine run twice (the same
    tokens). Returns the launch counts of the engine path, the traffic,
    the solo tokens and margin limits, and the greedy run's new tok/s."""
    from repro_torch.kernels import fd_fused
    from repro_torch.launch.serve import generate
    from repro_torch.serving_engine import Engine
    prompts, gens = _engine_traffic(cfg.vocab, plens, max_len)
    print(f"[engine] {cfg.name}: {len(prompts)} requests, prompts "
          f"{list(plens)}, new tokens {gens}, S={slots}, max_len {max_len}",
          flush=True)
    fd_fused.reset_counters()
    eng = Engine(cfg, model, slots=slots, max_len=max_len)
    clean = engine_run(eng, prompts, gens)
    poisoned = engine_run(eng, prompts, gens, poison=ENGINE_POISON)
    launches = dict(fd_fused.counters)
    print(f"[engine] buckets {eng.buckets}, C={eng._chunk_c}, capacity "
          f"{eng.capacity}; shapes {eng.trace_counts}; kernel launches "
          f"(Engine + clean and poisoned runs) {launches}", flush=True)
    _engine_report("greedy", clean)
    if torch.device(device).type == "cuda":
        want = {k: 0 for k in launches}
        want["hilbert_window"] = cfg.n_layers
        if launches != want:
            raise AssertionError(f"engine path launched {launches}, not "
                                 f"{want}: the kernel constants are "
                                 "realised once per Engine and prefill "
                                 "runs no fd_mul")

    # solo decode of each request alone, and its rate beside the engine's
    solo, t_new, n_new = [], 0.0, 0
    with torch.inference_mode():
        for pr, g in zip(prompts, gens):
            p = torch.from_numpy(pr)[None].to(device)
            _sync(device)
            t0 = time.perf_counter()
            generate(model, cfg, p, 1, max_len=max_len)
            _sync(device)
            t1 = time.perf_counter()
            seq = generate(model, cfg, p, g, max_len=max_len)
            _sync(device)
            t_new += time.perf_counter() - t1 - (t1 - t0)
            n_new += g - 1
            solo.append(seq[0])
    solo_new = [s[len(pr):].tolist() for s, pr in zip(solo, prompts)]
    print(f"[engine] solo decode of the same requests: {n_new} new tokens "
          f"in {t_new:.3f} s ({n_new / t_new:.1f} new tok/s, prefill "
          f"excluded)", flush=True)
    limits = _margin_limits(model, cfg, solo, prompts)
    checked, skipped = _held("engine vs solo", clean["tokens"], solo_new,
                             limits)
    print(f"[engine] engine vs solo decode: {checked} new tokens checked, "
          f"{skipped} skipped (after a top-2 margin <= {MARGIN}), 0 "
          "mismatches", flush=True)
    if not all(clean["ok"].values()):
        raise AssertionError(f"clean run not ok: {clean['ok']}")

    step, victim = ENGINE_POISON
    bad = [i for i, ok in poisoned["ok"].items() if not ok]
    if bad != [victim] or len(poisoned["tokens"][victim]) != step + 1:
        raise AssertionError(f"poisoned run: not ok {bad}, request "
                             f"{victim} kept "
                             f"{len(poisoned['tokens'][victim])} tokens")
    pc, ps = _held("poisoned vs clean", poisoned["tokens"],
                   [clean["tokens"][i] for i in range(len(prompts))], limits,
                   skip=(victim,))
    print(f"[engine] poisoned request {victim} before step {step}: it alone "
          f"ended not ok after {step + 1} tokens; the others equal the "
          f"clean run ({pc} checked, {ps} skipped)", flush=True)

    fd_fused.reset_counters()
    sampler = Engine(cfg, model, slots=slots, max_len=max_len,
                     **ENGINE_SAMPLED)
    seeds = [100 + i for i in range(len(prompts))]
    runs = [engine_run(sampler, prompts, gens, seeds=seeds)
            for _ in range(2)]
    sampled_launches = dict(fd_fused.counters)
    same = runs[0]["tokens"] == runs[1]["tokens"]
    toks = [t for r in runs for v in r["tokens"].values() for t in v]
    differ = sum(runs[0]["tokens"][i] != clean["tokens"][i]
                 for i in range(len(prompts)))
    print(f"[engine] sampled T={ENGINE_SAMPLED['temperature']} "
          f"top_k={ENGINE_SAMPLED['top_k']}, seeds 100+i, run twice: same "
          f"tokens {same}; {differ}/{len(prompts)} requests differ from "
          f"greedy; launches {sampled_launches}", flush=True)
    _engine_report("sampled, second run", runs[1])
    if not (same and all(r["ok"][i] for r in runs for i in r["ok"])
            and min(toks) >= 0 and max(toks) < cfg.vocab):
        raise AssertionError("sampled engine runs differ or went wrong")
    if torch.device(device).type == "cuda" and sampled_launches != want:
        raise AssertionError(f"sampled engine launched {sampled_launches}")
    return {"launches": launches, "prompts": prompts, "gens": gens,
            "solo_new": solo_new, "limits": limits, "slots": slots,
            "max_len": max_len, "rate": clean["new"] / clean["t_gen"]}


# -------------------------------------------------------------- phase 4c
#: the chaos run's fault rates (the launchers' ``--chaos``) and seed
SCHED_CHAOS, SCHED_CHAOS_SEED = ({"prefill": 0.15, "decode": 0.02,
                                  "callback": 0.1}, 0)
#: the preempted run stops once this many decode steps have run
SCHED_PREEMPT_STEPS = 20


def _sched_requests(prompts, gens, on_token=None):
    from repro_torch.serving_engine import Request
    return [Request(uid=f"r{i}", prompt=pr, max_new=g, on_token=on_token)
            for i, (pr, g) in enumerate(zip(prompts, gens))]


def _by_index(results: dict) -> dict:
    return {int(uid[1:]): list(toks) for uid, toks in results.items()}


def _hist_median(reg, name: str) -> float:
    """The upper bound of the bucket that holds the median observation of
    a registry histogram (``inf`` past the last bucket)."""
    series = reg.to_dict()[name]["series"][0]
    half = series["count"] / 2
    for le, cum in zip(series["buckets"], series["counts"]):
        if cum >= half:
            return le
    return math.inf


def _span_latencies(events) -> tuple[list, list]:
    """Exact TTFT (request begin → first_token) and TPOT (gaps between a
    request's token instants) in seconds from a trace."""
    begin, last, ttft, tpot = {}, {}, [], []
    for ev in events:
        uid = ev.get("uid")
        if ev["name"] == "request" and ev["ph"] == "B":
            begin[uid] = ev["ts"]
        elif ev["name"] == "first_token":
            ttft.append(ev["ts"] - begin[uid])
            last[uid] = ev["ts"]
        elif ev["name"] == "token":
            tpot.append(ev["ts"] - last[uid])
            last[uid] = ev["ts"]
    return ttft, tpot


def phase_scheduler(cfg, model, device, engine: dict, smi: str,
                    cli=("--arch", "fd-tnn-lm-wt103")) -> dict:
    """The engine phase's traffic through the supervised ``Scheduler``
    (default packing of 4, asynchronous detokenising, a metrics registry
    and a span tracer): (1) greedy, every outcome ok and each request's
    tokens held against solo decode under the margin rule; (2) chaos, a
    seeded ``FaultInjector`` at the launchers' ``--chaos`` rates: every
    request terminal, every error an ``InjectedFault``, the ok requests
    held as in (1); (3) preempted after ``SCHED_PREEMPT_STEPS`` decode
    steps, snapshotted, restored into a new Engine and Scheduler: the
    tokens equal (1)'s exactly, and the restored Engine launches only its
    6 ``hilbert_window``; (4) ``launch.serve.main --engine`` in process,
    its metrics JSON and request spans checked. Prints, recorded and not
    claimed, beside the card: the served new tok/s over ``run()``'s wall
    and over its decode steps, the engine phase's rate, steps, prefills,
    packed prefills, the TTFT and TPOT medians, snapshot bytes and write
    ms. Returns the launch counts of (1) and its drain (the Engine, the
    registry and the wall of ``run()``) for phase ``obs``."""
    from repro_torch.kernels import fd_fused
    from repro_torch.launch import serve
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import tracing as obs_tracing
    from repro_torch.serving_engine import (Engine, EngineStepError,
                                            FaultInjector, Scheduler)
    prompts, gens = engine["prompts"], engine["gens"]
    geometry = {"slots": engine["slots"], "max_len": engine["max_len"]}
    n_req = len(prompts)
    cuda = torch.device(device).type == "cuda"

    # (1) greedy
    fd_fused.reset_counters()
    reg, tracer = obs_metrics.Registry(), obs_tracing.Tracer()
    eng = Engine(cfg, model, metrics=reg, **geometry)
    sched = Scheduler(eng, metrics=reg, tracer=tracer)
    for r in _sched_requests(prompts, gens):
        sched.submit(r)
    _sync(device)
    t0 = time.perf_counter()
    results, _ = sched.run()
    _sync(device)
    wall = time.perf_counter() - t0
    launches = dict(fd_fused.counters)
    if cuda:
        want = {k: 0 for k in launches}
        want["hilbert_window"] = cfg.n_layers
        if launches != want:
            raise AssertionError(f"scheduler path launched {launches}, not "
                                 f"{want}")
    bad = {u: o for u, o in sched.outcomes.items() if o.status != "ok"}
    if bad:
        raise AssertionError(f"greedy scheduler run: outcomes not ok {bad}")
    clean = _by_index(results)
    checked, skipped = _held("scheduler vs solo", clean,
                             engine["solo_new"], engine["limits"])
    spans = obs_tracing.validate_spans(tracer.events)
    if sorted(spans) != sorted(f"r{i}" for i in range(n_req)):
        raise AssertionError(f"greedy trace spans for {sorted(spans)}")
    new = sum(len(t) - 1 for t in clean.values())
    step_s = reg.to_dict()["repro_decode_step_seconds"]["series"][0]["sum"]
    ttft, tpot = _span_latencies(tracer.events)
    print(f"[scheduler] {cfg.name}, {n_req} requests over S={eng.slots}, "
          f"max_len {eng.max_len}, prefill_pack {sched.prefill_pack}, "
          f"detok_async {sched.detok_async}: launches {launches}; scheduler "
          f"vs solo {checked} new tokens checked, {skipped} skipped (after "
          f"a top-2 margin <= {MARGIN}), 0 mismatches; {len(spans)} request "
          "spans closed", flush=True)
    print(f"[scheduler] greedy ({smi}): {new} new tokens in {wall:.3f} s of "
          f"run() ({new / wall:.1f} new tok/s; over its {sched.steps} decode "
          f"steps' {step_s:.3f} s: {new / step_s:.1f}); the engine phase "
          f"{engine['rate']:.1f} new tok/s over its generate steps; "
          f"prefills {sched.prefills} (packed waves "
          f"{sched.packed_prefills}); TTFT median <= "
          f"{_hist_median(reg, 'repro_ttft_seconds')} s by the registry's "
          f"buckets ({statistics.median(ttft):.4f} s from the spans), TPOT "
          f"median <= {_hist_median(reg, 'repro_tpot_seconds')} s "
          f"({statistics.median(tpot) * 1e3:.3f} ms)", flush=True)

    # (2) chaos
    inj = FaultInjector(seed=SCHED_CHAOS_SEED, rates=SCHED_CHAOS)
    streamed = {}
    chaos = Scheduler(eng, injector=inj)
    for r in _sched_requests(prompts, gens, on_token=lambda u, t:
                             streamed.setdefault(u, []).append(t)):
        chaos.submit(r)
    reruns = 0
    while True:
        try:
            chaos.run()
            break
        except EngineStepError:          # retries exhausted: queue kept
            reruns += 1
            if reruns > 3:
                raise
    status = {u: o.status for u, o in chaos.outcomes.items()}
    for u, o in chaos.outcomes.items():
        if o.status not in ("ok", "error"):
            raise AssertionError(f"chaos: {u} ended {o.status}")
        for msg in (o.error, o.callback_error):
            if msg is not None and "InjectedFault" not in msg:
                raise AssertionError(f"chaos: {u} failed without an "
                                     f"injected fault: {msg}")
    not_ok = {int(u[1:]) for u, st in status.items() if st != "ok"}
    c_checked, c_skipped = _held("chaos vs solo", _by_index(chaos.results),
                                 engine["solo_new"], engine["limits"],
                                 skip=not_ok)
    cb_errors = sum(o.callback_error is not None
                    for o in chaos.outcomes.values())
    print(f"[scheduler] chaos (FaultInjector seed {SCHED_CHAOS_SEED}, rates "
          f"{SCHED_CHAOS}): {inj.fired} faults fired, {chaos.retries} "
          f"retries, {reruns} re-runs after EngineStepError; outcomes "
          f"{sorted(status.items())}; {cb_errors} callbacks detached; every "
          "error an InjectedFault; the ok requests vs solo: "
          f"{c_checked} checked, {c_skipped} skipped, 0 mismatches; "
          f"log {inj.log}", flush=True)

    # (3) preempt, snapshot, restore into a new Engine and Scheduler
    with tempfile.TemporaryDirectory() as snap_dir:
        reg3 = obs_metrics.Registry()
        pre = Scheduler(eng, snapshot_dir=snap_dir, metrics=reg3)

        def stop_at(uid, tok):
            if pre.steps >= SCHED_PREEMPT_STEPS:
                pre.preempt()

        for r in _sched_requests(prompts, gens, on_token=stop_at):
            pre.submit(r)
        pre.run()
        if not pre.preempted:
            raise AssertionError("the preempted run was not preempted")
        snap_bytes = reg3.get("repro_snapshot_bytes").get()
        snap_ms = reg3.to_dict()["repro_snapshot_seconds"]["series"][0][
            "sum"] * 1e3
        partial = sum(len(t) for t in pre.results.values())
        fd_fused.reset_counters()
        eng_b = Engine(cfg, model, **geometry)
        resumed = Scheduler(eng_b, snapshot_dir=snap_dir)
        t0 = time.perf_counter()
        if not resumed.try_restore():
            raise AssertionError("no snapshot to restore")
        _sync(device)
        restore_ms = (time.perf_counter() - t0) * 1e3
        resumed.run()
        restored_launches = dict(fd_fused.counters)
    if cuda and restored_launches != want:
        raise AssertionError(f"restored Engine and run launched "
                             f"{restored_launches}, not {want}")
    if _by_index(resumed.results) != clean or any(
            o.status != "ok" for o in resumed.outcomes.values()):
        raise AssertionError("the restored run's tokens differ from the "
                             "uninterrupted greedy run's")
    print(f"[scheduler] preempted at decode step {pre.steps} with {partial} "
          f"tokens served, snapshot {int(snap_bytes)} bytes written in "
          f"{snap_ms:.3f} ms, restored into a new Engine in {restore_ms:.3f} "
          f"ms ({smi}); the union of tokens equals the greedy run's "
          f"exactly; launches of the new Engine and the resumed run "
          f"{restored_launches}", flush=True)

    # (4) the launcher, in process
    with tempfile.TemporaryDirectory() as out:
        mfile, tfile = os.path.join(out, "m.json"), os.path.join(out,
                                                                  "t.jsonl")
        try:
            rc = serve.main(list(cli) + ["--engine", "--batch", str(n_req),
                                         "--slots", str(eng.slots), "--device",
                                         str(device), "--metrics-file", mfile,
                                         "--trace-file", tfile])
        finally:
            obs_metrics.set_default_registry(None)
        if rc != 0:
            raise AssertionError(f"launch.serve --engine returned {rc}")
        with open(mfile) as f:
            dump = json.load(f)["metrics"]
        cli_spans = obs_tracing.validate_spans(obs_tracing.load_jsonl(tfile))
    finished = {s["labels"]["status"]: s["value"]
                for s in dump["repro_requests_finished_total"]["series"]}
    cli_status = {u: [x["status"] for x in r] for u, r in cli_spans.items()}
    if (cli_status != {f"req{i}": ["ok"] for i in range(n_req)}
            or finished != {"ok": n_req}):
        raise AssertionError(f"launch.serve --engine: spans {cli_status}, "
                             f"finished {finished}")
    print(f"[scheduler] launch.serve --engine --batch {n_req} --slots "
          f"{eng.slots}: metrics JSON of {len(dump)} metrics, "
          f"{len(cli_spans)} closed request spans, all ok", flush=True)
    return launches, {"engine": eng, "metrics": reg, "drain_s": wall}


# --------------------------------------------------------------- phase 5
def _train_setup(cfg, device, seed: int, steps: int, warmup: int):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import adamw
    model = init_model(cfg, torch.Generator().manual_seed(seed),
                       device=device)
    ocfg = adamw.OptConfig(lr=3e-4, warmup_steps=warmup, total_steps=steps)
    opt = adamw.init(ocfg, dict(model.named_parameters()))
    return model, opt, make_train_step(cfg, ocfg)


def _fd_counts():
    from repro_torch.kernels import fd_fused
    return dict(fd_fused.counters), dict(fd_fused.op_counters)


def _kernel_counts() -> dict:
    """Launches of every hand-written kernel of the port since the last
    :func:`_reset_kernel_counts` (``short_conv`` counts both dtypes)."""
    from repro_torch.kernels import fd_fused, ops, ssd_scan
    return {**fd_fused.counters, **ops.ski_counters(), **ssd_scan.counters}


def _reset_kernel_counts() -> None:
    from repro_torch.kernels import fd_fused, ops, ssd_scan
    fd_fused.reset_counters()
    ops.reset_ski_counters()
    ssd_scan.reset_counters()


def _ski_counts(coef: bool = False):
    """SKI launches and the counts of SKIFusedTNO (dense Gram) or, with
    ``coef``, SKIFusedTNOCoef."""
    from repro_torch.kernels import ops, ski_vjp
    return ops.ski_counters(), dict(ski_vjp.coef_counters if coef
                                    else ski_vjp.counters)


#: kernel launches a layer makes in one training step (forward + backward):
#: the FD model, the SKI model on the dense Gram, and on the large-rank
#: "windowed" and "fft" routes
TRAIN_LAUNCHES = {"tno": {},
                  "fd": FD_OP_LAUNCHES["fused"][0],
                  "ski": {"interp_reduce": 3, "ski_fused_pass2": 2,
                          "gram_grad": 1, "conv_tap_grad": 1},
                  "ski_windowed": {"interp_reduce": 3,
                                   "ski_windowed_pass2": 2,
                                   "conv_tap_grad": 1},
                  "ski_fft": {"interp_reduce": 3, "ski_expand_pass2": 2,
                              "conv_tap_grad": 1}}
TRAIN_TAGS = {"tno": "[tno train]", "fd": "[train]", "ski": "[ski-train]",
              "ski_windowed": "[large-r train]",
              "ski_fft": "[large-r fft train]"}


def phase_train(cfg, device, steps: int, seq: int, batch: int,
                mixer: str = "fd", report: dict | None = None) -> dict:
    """Returns the launch counts of the training run. The run is two
    ``Trainer.run`` calls on one model: steps 0..TRAIN_WARMUP-1, then a
    resume to ``steps``, whose wall (data, pre-step clone, step and
    logging, to a synchronise) gives the throughput. Every step must make
    TRAIN_LAUNCHES[mixer] launches a layer and one kernel backward a layer
    (none through the reference); the baseline ``tno`` makes no launch of
    any kernel of the port and has no autograd Function. ``report`` gets
    the tokens/s and the losses."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    model, opt, step_fn = _train_setup(cfg, device, 0, steps, warmup=5)
    data = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0)
    tag = TRAIN_TAGS[mixer]

    def trainer(total):
        return Trainer(TrainerConfig(total_steps=total, log_every=10), step_fn,
                       data, log=lambda line: print(line, flush=True))
    warm, timed = trainer(TRAIN_WARMUP), trainer(steps)
    torch.cuda.reset_peak_memory_stats(device)
    _reset_kernel_counts()
    t0 = time.perf_counter()
    opt, _ = warm.run(model, opt)
    _sync(device)
    t1 = time.perf_counter()
    opt, end = timed.run(model, opt, TRAIN_WARMUP)
    _sync(device)
    t2 = time.perf_counter()
    if mixer == "tno":
        launches, op_counts = _kernel_counts(), {}
    else:
        launches, op_counts = (_fd_counts() if mixer == "fd"
                               else _ski_counts(coef=mixer != "ski"))
    peak = torch.cuda.max_memory_allocated(device)
    losses = [float(m["loss"])
              for m in warm.metrics_history + timed.metrics_history]
    step_ms = statistics.median(timed.step_seconds) * 1e3
    window = t2 - t1
    tok_s = (end - TRAIN_WARMUP) * batch * seq / window
    first_ms = [round(t * 1e3, 3) for t in warm.step_seconds]
    print(f"{tag} {cfg.name}: {end} AdamW steps of {batch} x {seq} tokens "
          f"in {t2 - t0:.3f} s (steps 0-{TRAIN_WARMUP - 1}: {t1 - t0:.3f} s, "
          f"train_step ms {first_ms}); steps {TRAIN_WARMUP}-{end - 1}: "
          f"{window:.3f} s, {window / (end - TRAIN_WARMUP) * 1e3:.3f} ms a "
          f"step, {tok_s:.0f} tokens/s (median train_step {step_ms:.3f} ms, "
          f"max {max(timed.step_seconds) * 1e3:.3f} ms); loss step 0 "
          f"{losses[0]:.6f}, step {end - 1} {losses[-1]:.6f} (mean of the "
          f"last 5 {statistics.mean(losses[-5:]):.6f}); "
          f"max_memory_allocated {peak} bytes ({peak / 2**30:.3f} GiB)",
          flush=True)
    per_step = {k: v / steps for k, v in launches.items()}
    ops_per_step = {k: v / steps for k, v in op_counts.items()}
    print(f"{tag} kernel launches per step {per_step}; differentiated "
          f"forwards and backwards per step {ops_per_step}", flush=True)
    if not all(math.isfinite(v) for v in losses) or len(losses) != steps:
        raise AssertionError(f"training losses {losses}")
    if not (statistics.mean(losses[-5:]) < losses[0]
            and losses[-1] < losses[0]):
        raise AssertionError(f"loss did not fall: {losses}")
    want = {k: TRAIN_LAUNCHES[mixer].get(k, 0) * cfg.n_layers
            for k in launches}
    want_ops = ({} if mixer == "tno" else
                {"fwd": cfg.n_layers, "bwd_kernel": cfg.n_layers,
                 "bwd_ref": 0})
    if end != steps or per_step != want or ops_per_step != want_ops:
        raise AssertionError(f"{steps} steps of {cfg.n_layers} layers made "
                             f"{per_step} launches and {ops_per_step} "
                             f"forwards/backwards a step, not {want} and "
                             f"{want_ops}")
    if report is not None:
        report.update(tok_s=tok_s, losses=losses)
    return launches


# -------------------------------------------------------------- phase 5a
OBS_STEPS = 6
#: the FD kernels of a training step by their CUDA function names in
#: csrc/fd_fused.cu (``causal_spectrum_adjoint`` runs
#: ``spectrum_adjoint_kernel``)
OBS_FD_KERNELS = {"causal_spectrum": "causal_spectrum_kernel",
                  "causal_spectrum_adjoint": "spectrum_adjoint_kernel",
                  "fd_mul": "fd_mul_", "fd_khat_grad": "fd_khat_grad_"}
_DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def _fd_region_cost(d: int, n: int, batch: int):
    """(forward, backward) Cost of one ``fd_tno`` region at x (batch, n, d):
    the forward is the causal FD plan's cost (``obs.cost.cost_of_plan`` on
    the keys of ``core/tno.tno_plan``'s causal plan); the backward adds one
    more length-2n transform (it takes rfft(g), rfft(x) and irfft(dx)
    where the forward takes two), the ``fd_khat_grad`` reduction and the
    spectrum's adjoint (a second completion)."""
    from repro_torch.obs import cost as obs_cost
    fwd = obs_cost.total(obs_cost.cost_of_plan({"khat_real": None}, n=n,
                                               d=d, batch=batch))
    bwd = (fwd + obs_cost.rfft_cost(2 * n, d, batch)
           + obs_cost.fd_khat_grad_cost(n + 1, d, batch)
           + obs_cost.hilbert_window_cost(n, d))
    return fwd, bwd


def _device_busy_s(events) -> float:
    """Union of the card's kernel, copy and fill intervals (seconds)."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events
                   if str(e.get("cat", "")).lower() in _DEVICE_WORK)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-6


def phase_obs(cfg, smi: str, drain: dict, device="cuda") -> dict:
    """The kernel tier of ``obs`` on the card: ``launch.train.main`` on the
    full-width model (fp32, 8 x 512, ``OBS_STEPS`` steps) with
    ``--metrics-file``, ``--trace-file`` and ``REPRO_PROFILE_DIR`` set.
    Asserts the registry's ``repro_train_steps_total`` and
    ``repro_compiles_total`` (one first call of ``train.train_step``), the
    span events and the Chrome export; reads the profiler's trace with
    ``aggregate_chrome`` (device time) and ``region_kernels``: every launch
    of the four FD kernels lies under the ``fd_tno`` region, whose achieved
    fraction of its roofline bound (the plan's cost times the region's
    forwards and backwards, against ``obs.cost.peaks("gpu", float32)``)
    must lie in (0, 1.05]. Then ``attribute_engine`` over the scheduler
    phase's greedy drain (``drain``). Returns the run's kernel launches."""
    from repro_torch.kernels import fd_fused
    from repro_torch.launch import train
    from repro_torch.obs import cost as obs_cost
    from repro_torch.obs import devstats
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import tracing as obs_tracing
    t_phase = time.perf_counter()
    n_step = OBS_STEPS
    with tempfile.TemporaryDirectory() as out:
        prof_dir = os.path.join(out, "profile")
        mfile = os.path.join(out, "train.json")
        tfile = os.path.join(out, "train.jsonl")
        _reset_kernel_counts()
        try:
            with mock.patch.dict(os.environ, {"REPRO_PROFILE_DIR": prof_dir}):
                rc = train.main([
                    "--arch", cfg.name, "--steps", str(n_step),
                    "--seq-len", str(TRAIN_SEQ), "--global-batch",
                    str(TRAIN_BATCH), "--device", device,
                    "--metrics-file", mfile, "--trace-file", tfile])
        finally:
            obs_metrics.set_default_registry(None)
            obs_tracing.set_default_tracer(None)
        launches, op_counts = _fd_counts()
        t_run = time.perf_counter() - t_phase
        if rc != 0:
            raise AssertionError(f"launch.train returned {rc}")
        with open(mfile) as f:
            dump = json.load(f)["metrics"]
        events = obs_tracing.load_jsonl(tfile)
        chrome = os.path.exists(tfile + ".chrome.json")
        t0 = time.perf_counter()
        trace = devstats.load_profile_traces(prof_dir)
        regions = devstats.aggregate_chrome(trace)
        by_region = devstats.region_kernels(trace)
        t_read = time.perf_counter() - t0
    steps = dump["repro_train_steps_total"]["series"][0]["value"]
    compiles = [(x["labels"]["fn"], x["value"])
                for x in dump["repro_compiles_total"]["series"]]
    spans = [e for e in events if e["name"] == "train_step"]
    if (steps != n_step or compiles != [("train.train_step", 1)]
            or len(spans) != 2 * n_step
            or {e["ph"] for e in spans} != {"B", "E"} or not chrome):
        raise AssertionError(f"launch.train obs: steps {steps}, compiles "
                             f"{compiles}, {len(spans)} span events, chrome "
                             f"{chrome}")
    want = {k: v * cfg.n_layers * n_step
            for k, v in TRAIN_LAUNCHES["fd"].items()}
    if launches != want or op_counts != {
            "fwd": cfg.n_layers * n_step,
            "bwd_kernel": cfg.n_layers * n_step, "bwd_ref": 0}:
        raise AssertionError(f"launch.train launched {launches} and "
                             f"{op_counts}, not {want}")
    cats = {}
    for e in trace:
        c = str(e.get("cat", "")).lower()
        cats[c] = cats.get(c, 0) + 1
    annotated = sum(1 for e in trace
                    if str(e.get("cat", "")).lower() == "gpu_user_annotation"
                    and str(e.get("name", "")).startswith(
                        devstats.KERNEL_SCOPE_PREFIX))
    print(f"[obs train] profiler trace: {len(trace)} events, categories "
          f"{dict(sorted(cats.items()))}; {annotated} device-side region "
          f"ranges; read and aggregated in {t_read:.2f} s", flush=True)
    # every launch of the four FD kernels lies under the fd_tno region
    under = {k: sum(c for name, (c, _) in by_region.get("fd_tno", {}).items()
                    if sym in name)
             for k, sym in OBS_FD_KERNELS.items()}
    if any(under[k] != launches[k] for k in OBS_FD_KERNELS):
        raise AssertionError(f"FD kernel launches under the fd_tno region "
                             f"{under}, launched {launches}")
    busy_s = _device_busy_s(trace)
    # the steps' own device ranges, and the regions' host ranges
    step_s = sum(float(e.get("dur", 0)) * 1e-6 for e in trace
                 if str(e.get("cat", "")).lower() == "gpu_user_annotation"
                 and e.get("name") == "train_step")
    host = devstats.aggregate_chrome(
        [e for e in trace if str(e.get("cat", "")).lower()
         == "user_annotation"])
    if step_s <= 0 or busy_s <= 0:
        raise AssertionError(f"the trace holds {busy_s} s of device work "
                             f"and {step_s} s of train_step device ranges")
    name = torch.cuda.get_device_name(0)
    pk = obs_cost.peaks("gpu", dtype=torch.float32, name=name)
    fwd, bwd = _fd_region_cost(cfg.d_model, TRAIN_SEQ, TRAIN_BATCH)
    work = {"fd_tno": fwd.scale(op_counts["fwd"])
            + bwd.scale(op_counts["bwd_kernel"])}
    rows = []
    for region, sec in sorted(regions.items()):
        if region not in work:
            raise AssertionError(f"region {region} on the FD training path")
        frac = obs_cost.achieved_fraction(work[region], sec, pk)
        bound = obs_cost.seconds(work[region], pk)
        kern_s = sum(s for _, s in by_region.get(region, {}).values())
        rows.append(f"{region} {sec / n_step * 1e3:.3f} ms a step of "
                    f"device ranges ({sec / step_s:.4f} of the train_step "
                    f"ranges' {step_s / n_step * 1e3:.3f} ms; host ranges "
                    f"{host.get(region, 0.0) / n_step * 1e3:.3f} ms), its "
                    f"kernels busy {kern_s / n_step * 1e3:.3f} ms "
                    f"({kern_s / busy_s:.4f} of the card's busy "
                    f"{busy_s / n_step * 1e3:.3f} ms), bound "
                    f"{bound['bound_s'] / n_step * 1e3:.4f} ms a step "
                    f"({bound['dominant']}), achieved fraction {frac:.4f}")
        if not 0 < frac <= 1.05:
            raise AssertionError(f"region {region}: achieved fraction "
                                 f"{frac} outside (0, 1.05]")
    if set(regions) != set(work):
        raise AssertionError(f"kernel regions {sorted(regions)}")
    top = sorted(((s, n, c) for n, (c, s) in
                  by_region.get("fd_tno", {}).items()), reverse=True)[:8]
    begun, walls = {}, []
    for e in spans:
        if e["ph"] == "B":
            begun[e["attrs"]["step"]] = e["ts"]
        else:
            walls.append((e["ts"] - begun[e["attrs"]["step"]]) * 1e3)
    print(f"[obs train] {cfg.name} via launch.train.main, {n_step} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} ({smi}; peaks of {name}: "
          f"{pk.flops / 1e12} TFLOP/s fp32, {pk.mem_bw / 1e12} TB/s): "
          f"the launcher's train_step span (ends after a synchronise, "
          f"under the profiler) median {statistics.median(walls[1:]):.3f} "
          f"ms after the first ({walls[0]:.3f} ms); " + "; ".join(rows),
          flush=True)
    print(f"[obs train] under fd_tno, by device time over {n_step} steps: "
          + "; ".join(f"{n[:60]} x{c} {t * 1e3:.3f} ms" for t, n, c in top)
          + f"; launches {launches}; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s ({t_run:.1f} s the run)",
          flush=True)

    attr = devstats.attribute_engine(drain["engine"], drain["metrics"],
                                     drain_s=drain["drain_s"])
    print(f"[obs engine] attribute_engine over the scheduler phase's greedy "
          f"drain ({drain['drain_s']:.3f} s, {smi}): path {attr['path']}, "
          f"device_s {attr['device_s']:.3f}, coverage "
          f"{attr['coverage']:.3f}; "
          + "; ".join(f"{r['kernel']} {r['seconds'] * 1e3:.3f} ms "
                      f"({r['frac']:.3f})" for r in attr["rows"]),
          flush=True)
    if not attr["rows"] or not 0 < attr["coverage"] <= 1.0:
        raise AssertionError(f"attribute_engine: {attr}")
    return launches


# -------------------------------------------------------------- phase 5b
TNO_ARCH, TNO_TRAIN_STEPS = "tnn-lm-wt103", 10
#: the engine phase's requests the tno phase serves (prompts of 17, 100,
#: 255 and 420 tokens) through S slots at max_len PROMPT_LEN + GEN_LEN
TNO_ENGINE_REQUESTS, TNO_ENGINE_SLOTS = (1, 5, 8, 13), 4


def _decode_timed(model, cfg, seqs, p: int, max_len: int, device,
                  keep: bool = True, enc_out=None):
    """The decode steps alone: ``seqs``' first p tokens teacher-forced
    untimed into a fresh cache (params-aware, so the cache
    ``REPRO_FD_STREAM`` selects), then its other steps timed, each with
    the argmax a greedy ``generate`` takes, on the host clock
    (synchronised) and between one CUDA event pair. Returns (host ms a
    step, event ms a step, and with ``keep`` the decode path's logits (b,
    n - p, V) at positions p - 1 .. n - 2, each predicting the next
    token, else None). (The serve phase's rate is the difference of two
    ``generate`` walls, which reads noise where the decode steps are a
    small part of them. An encdec model's steps take ``enc_out``.)"""
    from repro_torch.models import serving
    b, n = seqs.shape
    kept = []
    with torch.inference_mode():
        cache = serving.init_cache(cfg, b, max_len, params=model)
        for t in range(p):
            logits, cache = serving.decode_step(model, cfg, seqs[:, t:t + 1],
                                                cache, t, enc_out)
        if keep:
            kept.append(logits[:, -1])
        _sync(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for t in range(p, n - 1):
            logits, cache = serving.decode_step(model, cfg, seqs[:, t:t + 1],
                                                cache, t, enc_out)
            torch.argmax(logits[:, -1], dim=-1)
            if keep:
                kept.append(logits[:, -1])
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
    steps = n - 1 - p
    return (wall * 1e3 / steps, start.elapsed_time(end) / steps,
            torch.stack(kept, 1) if keep else None)


def _hist_generate(tag: str, model, cfg, prompt, gen_len: int, max_len: int,
                   device):
    """One greedy ``generate`` of gen_len tokens at max_len through the
    hist-replay cache (the prompt teacher-forced token by token), after a
    short warm-up. Returns (sequences, new tokens/s of the decode steps
    (:func:`_decode_timed` over the sequences), the kernel launches and
    ``PLAN_EVALS`` of the ``generate`` call)."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import serving
    b, p = prompt.shape
    with torch.inference_mode():
        generate(model, cfg, prompt[:, :8], 2, max_len=max_len)   # warm-up
        _sync(device)
        _reset_kernel_counts()
        serving.PLAN_EVALS.update({k: 0 for k in serving.PLAN_EVALS})
        t0 = time.perf_counter()
        seqs = generate(model, cfg, prompt, gen_len, max_len=max_len)
        _sync(device)
        t_gen = time.perf_counter() - t0
        counts, evals = _kernel_counts(), dict(serving.PLAN_EVALS)
    if seqs.shape != (b, p + gen_len) or not torch.equal(seqs[:, :p],
                                                         prompt):
        raise AssertionError(f"{tag} generate returned {tuple(seqs.shape)}")
    host_ms, _, _ = _decode_timed(model, cfg, seqs, p, max_len, device,
                                  keep=False)
    rate = b / host_ms * 1e3
    steps = p + gen_len - 1
    print(f"{tag} {cfg.name} hist-replay generate {b} x ({p} + {gen_len}) "
          f"at max_len {max_len}: {t_gen:.3f} s, {steps} decode steps "
          f"({steps / t_gen:.1f} steps/s); decode alone {rate:.1f} new "
          f"tok/s; kernel launches {counts}; PLAN_EVALS {evals}",
          flush=True)
    return seqs, rate, counts, evals


def _expect_no_launches(what: str, counts: dict) -> None:
    if any(counts.values()):
        raise AssertionError(f"{what} launched {counts}: the baseline path "
                             "runs no hand-written kernel (cuFFT, cuBLAS)")


def phase_tno(fd_cfg, fd_model, fd_seqs, fd_rate: float, engine: dict,
              smi: str, device="cuda") -> dict:
    """The baseline TNN at full width from seed 0: (1) score 8 × 512
    through ``make_forward`` and the eval ``loss_fn``, card vs CPU on
    1 × 512; (2) train TNO_TRAIN_STEPS AdamW steps through the Trainer,
    and the smoke model's gradients, losses and checkpoint resume card vs
    CPU; (3) serve 8 × (448 + 64) greedily at max_len 512 through the
    hist-replay cache, held to the kernel-path forward under the margin
    rule; (4) four of the engine phase's requests through an Engine of
    TNO_ENGINE_SLOTS slots, held to solo ``generate`` under the margin
    rule, with the forward at n = max_len; 0 launches of any hand-written
    kernel in (1)-(4); (5) the serve phase's FD model under
    REPRO_FD_STREAM=0 on the serve phase's prompts: its tokens held to
    the streaming ones under the margin rule, 6 ``hilbert_window`` (one a
    layer, realising ``kcoef``) and no other kernel. Prints the rates,
    recorded and not claimed, beside the card. Returns the launch counts
    by path."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_forward
    from repro_torch.models import serving
    from repro_torch.models.transformer import init_model, loss_fn
    from repro_torch.serving_engine import Engine
    t_phase = time.perf_counter()
    cfg = get_config(TNO_ARCH)
    model = init_model(cfg, torch.Generator().manual_seed(0), device=device)
    n_params = sum(p.numel() for p in model.parameters())
    n_fd = sum(p.numel() for p in fd_model.parameters())
    print(f"[tno] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"vocab {cfg.vocab}, {n_params} parameters ({fd_cfg.name}: "
          f"{n_fd})", flush=True)
    if n_params != n_fd:
        raise AssertionError("the baseline and FD models should hold one "
                             "RPE MLP of width d each")
    launches = {}

    # (1) score
    batch = _ski_batch(cfg, SCORE_BATCH, SCORE_SEQ, device)
    fwd = make_forward(cfg)
    fwd(model, batch["tokens"])                        # warm-up
    _sync(device)
    _reset_kernel_counts()
    logits = fwd(model, batch["tokens"])
    with torch.no_grad():
        loss = float(loss_fn(model, cfg, batch)[0])
    launches["tno_score"] = _kernel_counts()
    if not (logits.shape == (SCORE_BATCH, SCORE_SEQ, cfg.vocab_padded)
            and bool(torch.isfinite(logits).all()) and math.isfinite(loss)):
        raise AssertionError(f"tno logits {tuple(logits.shape)} or loss "
                             f"{loss} not finite or of the wrong shape")
    walls = []
    for _ in range(SCORE_REPS):
        t0 = time.perf_counter()
        fwd(model, batch["tokens"])
        _sync(device)
        walls.append(time.perf_counter() - t0)
    ms = statistics.median(walls) * 1e3
    score_tok_s = SCORE_BATCH * SCORE_SEQ / ms * 1e3
    print(f"[tno score] make_forward {SCORE_BATCH}x{SCORE_SEQ}: median "
          f"{ms:.3f} ms of {SCORE_REPS} (min {min(walls) * 1e3:.3f}, max "
          f"{max(walls) * 1e3:.3f}), {score_tok_s:.0f} tokens/s; eval loss "
          f"{loss:.6f}; kernel launches {launches['tno_score']}", flush=True)
    one = {k: v[:1] for k, v in batch.items()}
    cpu_model = init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    want = fwd(cpu_model, one["tokens"].cpu())
    got = fwd(model, one["tokens"]).cpu()
    with torch.no_grad():
        want_loss = float(loss_fn(cpu_model, cfg,
                                  {k: v.cpu() for k, v in one.items()})[0])
        got_loss = float(loss_fn(model, cfg, one)[0])
    del cpu_model
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    lerr = abs(got_loss - want_loss)
    print(f"[tno score] card vs CPU, 1 x {SCORE_SEQ} tokens: logits max abs "
          f"err {err:.3e} (scale {scale:.3e}, limit 1e-4 x scale); loss "
          f"{got_loss:.6f} vs {want_loss:.6f}, err {lerr:.3e} (limit 1e-4 x "
          f"loss)", flush=True)
    if not (err <= 1e-4 * scale and lerr <= 1e-4 * abs(want_loss)):
        raise AssertionError("card baseline scoring differs from the CPU's")
    check_tno_stages(device)

    # (2) train
    report = {}
    launches["tno_train"] = phase_train(cfg, device, TNO_TRAIN_STEPS,
                                        TRAIN_SEQ, TRAIN_BATCH, mixer="tno",
                                        report=report)
    small = reduce_for_smoke(cfg)
    check_train_card_vs_cpu(small, device)
    check_checkpoint_resume(small, device)

    # (3) serve
    max_len = PROMPT_LEN + GEN_LEN
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (PROMPTS, PROMPT_LEN))).to(device)
    seqs, rate, launches["tno_serve"], evals = _hist_generate(
        "[tno serve]", model, cfg, prompt, GEN_LEN, max_len, device)
    if evals != {"fd": 0, "tno": cfg.n_layers}:
        raise AssertionError(f"tno generate realised its taps {evals} times, "
                             f"not once a layer")
    check_decoded("[tno serve]", cfg, model, PROMPT_LEN, seqs)

    # (4) engine
    prompts = [engine["prompts"][i] for i in TNO_ENGINE_REQUESTS]
    gens = [engine["gens"][i] for i in TNO_ENGINE_REQUESTS]
    _reset_kernel_counts()
    serving.PLAN_EVALS["tno"] = 0
    eng = Engine(cfg, model, slots=TNO_ENGINE_SLOTS, max_len=max_len)
    run = engine_run(eng, prompts, gens)
    launches["tno_engine"] = _kernel_counts()
    _engine_report(f"tno ({len(prompts)} requests, prompts "
                   f"{[len(p) for p in prompts]}, S={TNO_ENGINE_SLOTS}, "
                   f"buckets {eng.buckets})", run)
    if serving.PLAN_EVALS["tno"] != cfg.n_layers or not all(
            run["ok"].values()):
        raise AssertionError(f"tno engine: PLAN_EVALS "
                             f"{serving.PLAN_EVALS}, ok {run['ok']}")
    with torch.inference_mode():
        solo = [generate(model, cfg, torch.from_numpy(pr)[None].to(device), g,
                         max_len=max_len)[0] for pr, g in zip(prompts, gens)]
    limits = _margin_limits(model, cfg, solo, prompts, n=max_len)
    checked, skipped = _held("tno engine vs solo", run["tokens"],
                             [s[len(pr):].tolist()
                              for s, pr in zip(solo, prompts)], limits)
    print(f"[tno engine] engine vs solo decode at max_len {max_len}: "
          f"{checked} new tokens checked, {skipped} skipped (after a top-2 "
          f"margin <= {MARGIN} of the forward at n = {max_len}), 0 "
          "mismatches", flush=True)
    for path in ("tno_score", "tno_train", "tno_serve", "tno_engine"):
        _expect_no_launches(path, launches[path])
    del model, eng

    # (5) FD through the hist cache
    fprompt = fd_seqs[:, :PROMPT_LEN]
    with mock.patch.dict(os.environ, {"REPRO_FD_STREAM": "0"}):
        fseqs, frate, counts, evals = _hist_generate(
            "[tno fd-hist]", fd_model, fd_cfg, fprompt, GEN_LEN, max_len,
            device)
    want = {k: 0 for k in counts}
    if torch.device(device).type == "cuda":      # the plain versions count 0
        want["hilbert_window"] = fd_cfg.n_layers
    if counts != want or evals != {"fd": fd_cfg.n_layers, "tno": 0}:
        raise AssertionError(f"FD hist generate launched {counts} and "
                             f"realised {evals}, not {want} and one a layer")
    launches["fd_hist"] = counts
    limits = _margin_limits(fd_model, fd_cfg, list(fd_seqs), list(fprompt))
    checked, skipped = _held(
        "fd hist vs stream", {i: r[PROMPT_LEN:].tolist()
                              for i, r in enumerate(fseqs)},
        [r[PROMPT_LEN:].tolist() for r in fd_seqs], limits)
    print(f"[tno fd-hist] hist-replay vs streaming tokens: {checked} checked, "
          f"{skipped} skipped (after a top-2 margin <= {MARGIN}), 0 "
          "mismatches", flush=True)
    stream_ms, _, _ = _decode_timed(fd_model, fd_cfg, fd_seqs, PROMPT_LEN,
                                    max_len, device, keep=False)
    stream_rate = fd_seqs.shape[0] / stream_ms * 1e3
    print(f"[tno] rates ({smi}; host clock, recorded, not claimed): scoring "
          f"{score_tok_s:.0f} tokens/s; training {report['tok_s']:.0f} "
          f"tokens/s; decode alone, new tok/s: baseline hist {rate:.1f}, FD "
          f"hist {frate:.1f}, FD streaming {stream_rate:.1f} (the serve "
          f"phase's FD decode rate: {fd_rate:.1f})", flush=True)
    print(f"[tno] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def _stage_err(what: str, got, want) -> float:
    """Print one stage's card-vs-CPU max abs error beside its scale and
    dtypes; returns the error over the scale."""
    err = float((got.cpu().float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    print(f"[tno stages] {what}: max abs err {err:.3e}, scale {scale:.3e}, "
          f"{err / scale:.3e} of it; dtype card {got.dtype}, CPU "
          f"{want.dtype}", flush=True)
    return err / scale


@contextlib.contextmanager
def _fft_lengths(log: list):
    """Record the signal length of every ``torch.fft.rfft``/``irfft``
    call inside the block as (name, device, n)."""
    real = {"rfft": torch.fft.rfft, "irfft": torch.fft.irfft}

    def wrap(name):
        def call(x, n=None, dim=-1, norm=None):
            log.append((name, x.device.type, n or x.shape[dim]))
            return real[name](x, n=n, dim=dim, norm=norm)
        return call
    with mock.patch.object(torch.fft, "rfft", wrap("rfft")), \
            mock.patch.object(torch.fft, "irfft", wrap("irfft")):
        yield


def check_tno_stages(device="cuda") -> None:
    """ROADMAP Queue 3, item 9: the full-width baseline's card-vs-CPU gap,
    stage by stage on layer 0 with the same weights (drawn on the CPU
    from seed 0) and the same inputs (the CPU's) on both: ``decay_bias``
    (λ^|t| in fp32), ``baseline_coeffs`` (the RPE MLP at the 2n - 1 lags
    times the decay), ``toeplitz_matvec`` on the same coefficients and u
    (cuFFT against pocketfft), and the whole GTU; each must be within
    1e-5 of its scale. Then the gap of both models run layer by layer
    from the same embedding, after each layer and at the logits, beside
    the CPU's own fp32 sensitivity: its logits with the Toeplitz matvec
    taken in fp64 instead. Prints the TF32 switches, a 512 x 512 fp32
    product against fp64 on the card (TF32 would miss by about 1e-3) and
    the FFT lengths each device ran."""
    from repro_torch.configs import get_config
    from repro_torch.core import rpe, tno, toeplitz
    from repro_torch.core.block import gtu_apply
    from repro_torch.models.transformer import (_tno_cfg, embed_tokens,
                                                forward, init_model,
                                                layer_apply, unembed)
    from repro_torch.nn.layers import ACTS, dense, rmsnorm
    cfg = get_config(TNO_ARCH)
    n = SCORE_SEQ
    cpu = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = init_model(cfg, torch.Generator().manual_seed(0), device=device)
    tokens = _ski_batch(cfg, 1, n, "cpu")["tokens"]
    bcfg = _tno_cfg(cfg, "tno")
    tcfg = bcfg.tno
    a = torch.randn(512, 512, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    b = torch.randn(512, 512, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    prod = (a.float().to(device) @ b.float().to(device)).cpu().double()
    mm_err = float((prod - a @ b).abs().max() / (a @ b).abs().max())
    print(f"[tno stages] TF32: allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}, float32 matmul precision "
          f"{torch.get_float32_matmul_precision()!r}; a 512x512 fp32 "
          f"product on the card is {mm_err:.3e} of its scale from fp64 "
          "(TF32: about 1e-3)", flush=True)
    rel, ffts = {}, []
    lc, lg = cpu.layers[0].mixer, card.layers[0].mixer
    with torch.no_grad(), _fft_lengths(ffts):
        t = toeplitz.lags(n).float()
        rel["decay_bias"] = _stage_err(
            "decay_bias (lambda^|t|, 2n - 1 lags)",
            rpe.decay_bias(t.to(device), tcfg.lam), rpe.decay_bias(t,
                                                                   tcfg.lam))
        coef = tno.baseline_coeffs(lc.tno, tcfg, n)
        rel["baseline_coeffs"] = _stage_err(
            "baseline_coeffs (RPE MLP x decay)",
            tno.baseline_coeffs(lg.tno, tcfg, n), coef)
        h = rmsnorm(cpu.layers[0].norm1.scale, embed_tokens(cpu, cfg, tokens),
                    cfg.norm_eps)
        u = ACTS[bcfg.act](dense(lc.wu.w, h)).transpose(1, 2)      # (1, d, n)
        rel["toeplitz_matvec"] = _stage_err(
            "toeplitz_matvec (the CPU's coefficients and u)",
            toeplitz.toeplitz_matvec(coef.to(device)[None], u.to(device)),
            toeplitz.toeplitz_matvec(coef[None], u))
        rel["gtu"] = _stage_err("the GTU (u, v, the mixer, wo)",
                                gtu_apply(lg, bcfg, h.to(device)),
                                gtu_apply(lc, bcfg, h))
        # layer by layer from the same embedding: the gap as it grows
        xc = embed_tokens(cpu, cfg, tokens)
        xg = xc.to(device)
        growth = []
        for i, (mixer, ffn) in enumerate(cfg.layers_spec):
            xc = layer_apply(cpu.layers[i], cfg, mixer, ffn, xc)[0]
            xg = layer_apply(card.layers[i], cfg, mixer, ffn, xg)[0]
            growth.append(float((xg.cpu() - xc).abs().max()
                                / xc.abs().max()))
        lc_out = unembed(cpu, cfg, rmsnorm(cpu.norm_f.scale, xc,
                                           cfg.norm_eps))
        lg_out = unembed(card, cfg, rmsnorm(card.norm_f.scale, xg,
                                            cfg.norm_eps))
        logits_rel = float((lg_out.cpu() - lc_out).abs().max()
                           / lc_out.abs().max())
        peak_to_rms = float(xc.abs().max() / xc.square().mean().sqrt())
    lengths = sorted({(name, dev, m) for name, dev, m in ffts})
    print(f"[tno stages] FFT calls (name, device, length): {lengths}",
          flush=True)

    def matvec64(t_, x):
        m = x.shape[-1]
        fc = torch.fft.rfft(toeplitz._circulant_coeffs(t_, m).double(),
                            dim=-1)
        fx = torch.fft.rfft(x.double(), n=2 * m, dim=-1)
        return torch.fft.irfft(fc * fx, n=2 * m, dim=-1)[..., :m].to(x.dtype)
    with torch.no_grad():
        with mock.patch.object(toeplitz, "toeplitz_matvec", matvec64):
            exact = forward(cpu, cfg, tokens)
        sens = float((exact - lc_out).abs().max() / lc_out.abs().max())
    print(f"[tno stages] layer by layer from one embedding, card vs CPU over "
          f"the residual's scale: {[f'{g:.3e}' for g in growth]}; logits "
          f"{logits_rel:.3e} of their scale (the last residual's max is "
          f"{peak_to_rms:.1f} x its rms, and the final norm scales by the "
          f"rms); the CPU's own logits with the Toeplitz matvec in fp64 "
          f"move {sens:.3e} of it", flush=True)
    bad = {k: v for k, v in rel.items() if not v <= 1e-5}
    if bad or mm_err > 1e-5:
        raise AssertionError(f"baseline stages beyond 1e-5 of their scale: "
                             f"{bad}; fp32 product {mm_err:.3e}")
    del cpu, card


# -------------------------------------------------------------- phase 5c
ZOO_ARCH = "gemma3-4b"
#: served prompts: 1,088 tokens and 32 new at max_len 1,152, so that the
#: last ~96 positions of every local layer (window 1,024) see the window
#: bind
ZOO_PROMPTS, ZOO_PROMPT_LEN, ZOO_GEN, ZOO_MAX_LEN = 4, 1088, 32, 1152
#: the engine's 4 ragged requests through S = 4 slots at max_len 512
ZOO_ENGINE_PLENS, ZOO_ENGINE_GENS = (9, 30, 50, 100), (24, 16, 12, 8)
ZOO_ENGINE_SLOTS, ZOO_ENGINE_MAX_LEN = 4, 512
#: a mixer override's launches a scoring forward makes a layer, and the
#: override path's name in ``main``'s paths
ZOO_OVERRIDES = {"fd": {"causal_spectrum": 1, "fd_mul": 1},
                 "ski": {"interp_reduce": 1, "ski_fused_pass2": 1}}
#: the depth a mixer override scores at, and phase zoo's serve passes run
#: at (gemma3-4b's one period: five local layers and the global one)
OVERRIDE_LAYERS = 6
#: the bf16 tier of a kernel path against its plain path on the card
ZOO_BF16_TOL = 2e-2


@contextlib.contextmanager
def _plain_tno_ops():
    """Inside the block the FD and SKI mixers call their plain versions on
    the card too (``ref.fd_tno_ref``, ``ref.ski_fused_tno_ref``)."""
    from repro_torch.kernels import ops, ref
    with mock.patch.object(ops, "fd_tno", ref.fd_tno_ref), \
            mock.patch.object(ops, "ski_fused_tno", ref.ski_fused_tno_ref):
        yield


def _zoo_score(tag: str, cfg, model, batch, device,
               reps: int = SCORE_REPS, inputs=None) -> tuple:
    """One counted ``make_forward`` over the batch after a warm-up, then
    ``reps`` timed ones; ``inputs`` are the forward's other inputs (an
    encdec's ``enc_embed``, a prefix_vlm's ``patches``). Returns (logits,
    launches, text tokens/s)."""
    from repro_torch.launch.steps import make_forward
    fwd = make_forward(cfg)
    inputs = inputs or {}
    fwd(model, batch["tokens"], **inputs)              # warm-up
    _sync(device)
    _reset_kernel_counts()
    logits = fwd(model, batch["tokens"], **inputs)
    _sync(device)
    launches = _kernel_counts()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fwd(model, batch["tokens"], **inputs)
        _sync(device)
        walls.append(time.perf_counter() - t0)
    ms = statistics.median(walls) * 1e3
    tok_s = batch["tokens"].numel() / ms * 1e3
    b, s = batch["tokens"].shape
    if not (logits.shape == (b, s, cfg.vocab_padded)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{tag} logits {tuple(logits.shape)} not "
                             "finite or of the wrong shape")
    print(f"{tag} make_forward {b}x{s}: median {ms:.3f} ms of {reps} "
          f"(min {min(walls) * 1e3:.3f}, max {max(walls) * 1e3:.3f}), "
          f"{tok_s:.0f} tokens/s; kernel launches {launches}", flush=True)
    return logits, launches, tok_s


def _override_model(base, base_model, mixer: str, device,
                    n_layers=OVERRIDE_LAYERS):
    """The full-width arch with ``mixer_override`` at ``n_layers`` layers
    (default OVERRIDE_LAYERS, gemma3-4b's one period; None keeps the
    base's): the layers the override turns into the paper's mixer draw it
    from seed 0 on the CPU, in layer order; every other leaf is
    ``base_model``'s own tensor, shared, not copied (drawing gemma3's 1.9 B
    leaves again would take about 20 s, and the jamba cut holds 48 GB of
    an 80 GB card). A hybrid's Mamba layers keep their mixer, as in JAX."""
    from repro_torch.models.transformer import Model
    from repro_torch.nn.layers import reset_parameters
    cfg = dataclasses.replace(base, mixer_override=mixer,
                              n_layers=n_layers or base.n_layers)
    model = Model(cfg, device="meta")
    gen = torch.Generator().manual_seed(0)
    fresh = {}
    for i, (m, _) in enumerate(cfg.layers_spec):
        if m == mixer:
            layer = model.layers[i]
            layer.mixer.to_empty(device=device)
            reset_parameters(layer.mixer, gen)
            fresh.update({f"layers.{i}.mixer.{k}": v for k, v
                          in layer.mixer.state_dict(keep_vars=True).items()})
    have = base_model.state_dict(keep_vars=True)
    model.load_state_dict({k: fresh[k] if k in fresh else have[k]
                           for k in model.state_dict()}, assign=True)
    return cfg, model


def _cut_model(base, base_model, n_layers=OVERRIDE_LAYERS):
    """The arch at its first ``n_layers`` layers (default one period of
    gemma3-4b, both of its layer kinds), every leaf ``base_model``'s own
    tensor, shared, not copied: the serve passes of phase zoo run on it,
    so that their host-bound decode steps launch a sixth of the full
    model's kernels."""
    from repro_torch.models.transformer import Model
    cfg = dataclasses.replace(base, n_layers=n_layers)
    model = Model(cfg, device="meta")
    have = base_model.state_dict(keep_vars=True)
    model.load_state_dict({k: have[k] for k in model.state_dict()},
                          assign=True)
    return cfg, model


def _zoo_override(mixer: str, base, base_model, batch, device,
                  tag: str = "", n_layers=OVERRIDE_LAYERS,
                  plain=_plain_tno_ops, also=None,
                  reps: int = SCORE_REPS, inputs=None,
                  per_layer=None) -> tuple:
    """:func:`_override_model` at ``n_layers``: the scoring launches
    (``per_layer``, default ZOO_OVERRIDES[mixer], a layer of the paper's
    mixer, ``also`` (launches of the other layers' kernels a forward), no
    other kernel; ``inputs`` the forward's other inputs, as
    :func:`_zoo_score` takes them) and its logits
    against the same forward through the plain versions on the card (the
    ``plain`` context), within ZOO_BF16_TOL of their scale or, where
    larger, twice the plain path's own distance from its fp32-activation
    forward (bf16 rounding of the residual stream; the tier of
    tests/test_torch_zoo.py). Returns (launches, tokens/s)."""
    from repro_torch.models.transformer import forward
    t0 = time.perf_counter()
    cfg, model = _override_model(base, base_model, mixer, device, n_layers)
    tag = tag or f"[zoo {mixer}]"
    print(f"{tag} {cfg.name} --mixer {mixer}: {cfg.n_layers} layers, "
          f"d={cfg.d_model}, {cfg.dtype} (mixer leaves fp32), "
          f"{sum(p.numel() for p in model.parameters())} parameters (the "
          f"mixers drawn from seed 0, the rest the full model's), built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    inputs = inputs or {}
    logits, launches, tok_s = _zoo_score(tag, cfg, model, batch, device,
                                         reps, inputs)
    n_mixer = sum(m == mixer for m, _ in cfg.layers_spec)
    want = {k: 0 for k in launches}
    per_layer = ZOO_OVERRIDES[mixer] if per_layer is None else per_layer
    want.update({k: v * n_mixer for k, v in per_layer.items()})
    want.update(also or {})
    with torch.inference_mode(), plain():
        _reset_kernel_counts()
        plain = forward(model, cfg, batch["tokens"], **inputs).float()
        plain_counts = _kernel_counts()
        act32 = forward(model, dataclasses.replace(cfg, dtype="float32"),
                        batch["tokens"], **inputs)
    err = float((logits.float() - plain).abs().max())
    scale = float(plain.abs().max())
    noise = float((plain - act32).abs().max()) / scale
    tol = max(ZOO_BF16_TOL, 2 * noise)
    print(f"{tag} kernel path vs plain path on the card: logits max abs err "
          f"{err:.4f} (scale {scale:.3f}; limit max({ZOO_BF16_TOL}, 2 x "
          f"{noise:.4f}) = {tol:.4f} x scale, the second the plain path's "
          f"bf16 against fp32 activations); plain path launches "
          f"{plain_counts}", flush=True)
    if launches != want or any(plain_counts.values()):
        raise AssertionError(f"{tag} launched {launches}, not {want}; the "
                             f"plain path {plain_counts}")
    if not err <= tol * scale:
        raise AssertionError(f"{tag} kernel path differs from the plain path")
    del model
    return launches, tok_s


def _check_smoke_card_vs_cpu(small, device, inputs_of=None,
                             tag: str = "[zoo check]") -> None:
    """The smoke model on the card and on the CPU, the same init: in bf16
    the logits within ZOO_BF16_TOL of their scale, or within twice the
    CPU's own bf16 logits' distance from its fp32 activations' on the same
    weights where that is larger (the tier of tests/test_torch_zoo.py); in
    fp32 (the same arch with fp32 dtypes) the step-0 gradients, three
    losses and a bitwise checkpoint resume as in phase 10. ``inputs_of``
    (device -> the forward's other inputs: an encdec's frames, a
    prefix_vlm's patches, which the trainer's pipeline does not make)
    holds the fp32 model by its eval loss (1e-4 relative) and every
    gradient (1e-4 × its leaf's max|g|) instead."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.transformer import forward, init_model
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, small.vocab, (2, 64)))
    act32 = dataclasses.replace(small, dtype="float32")

    def inputs(dev):
        return {} if inputs_of is None else inputs_of(dev)
    with torch.inference_mode():
        cpu = init_model(small, torch.Generator().manual_seed(1),
                         device="cpu")
        want = forward(cpu, small, toks, **inputs("cpu")).float()
        want32 = forward(cpu, act32, toks, **inputs("cpu"))
        got = forward(init_model(small, torch.Generator().manual_seed(1),
                                 device=device), small,
                      toks.to(device), **inputs(device)).float().cpu()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    noise = float((want - want32).abs().max()) / scale
    tol = max(ZOO_BF16_TOL, 2 * noise)
    print(f"{tag} smoke {small.name} ({small.dtype}) card vs CPU "
          f"logits {tuple(want.shape)}: max abs err {err:.4f} (scale "
          f"{scale:.3f}; limit max({ZOO_BF16_TOL}, 2 x {noise:.4f}) = "
          f"{tol:.4f} x scale, the second the CPU's bf16 against fp32 "
          "activations)", flush=True)
    if not err <= tol * scale:
        raise AssertionError("card smoke logits differ from the CPU's")
    fp32 = dataclasses.replace(small, dtype="float32", param_dtype="float32")
    if inputs_of is None:
        check_train_card_vs_cpu(fp32, device)
        check_checkpoint_resume(fp32, device)
        return
    runs = {}
    for dev in ("cpu", device):
        model = init_model(fp32, torch.Generator().manual_seed(2),
                           device=dev)
        batch = {"tokens": toks.to(dev), "labels": toks.roll(-1, 1).to(dev),
                 **{k: v.float() for k, v in inputs(dev).items()}}
        loss, _, grads = loss_and_grads(model, fp32, batch)
        runs[dev] = float(loss), {k: v.cpu() for k, v in grads.items()}
    (l_cpu, g_cpu), (l_dev, g_dev) = runs["cpu"], runs[device]
    worst = max(float((g_dev[k] - g_cpu[k]).abs().max())
                / max(float(g_cpu[k].abs().max()), 1e-30) for k in g_cpu)
    lerr = abs(l_dev - l_cpu) / abs(l_cpu)
    print(f"{tag} smoke {fp32.name} fp32 card vs CPU: loss {l_dev:.6f} vs "
          f"{l_cpu:.6f} (rel err {lerr:.3e}, limit 1e-4), gradients worst "
          f"leaf {worst:.3e} x max|g| (limit 1e-4)", flush=True)
    if not (lerr <= 1e-4 and worst <= 1e-4):
        raise AssertionError(f"{tag} the card's fp32 smoke model differs "
                             "from the CPU's")


def _pick(cfg, logits):
    """The token a greedy ``generate`` picks from logits (…, V_pad)."""
    return torch.clamp(torch.argmax(logits, dim=-1), max=cfg.vocab - 1)


def _check_decoded_bf16(tag: str, cfg, model, p: int, seqs, dec,
                        inputs=None) -> float:
    """The bf16 decode path's logits ``dec`` (b, n - p, V) at the generated
    positions, teacher-forced over the generated ``seqs``, against the
    forward over them. The decode path must reproduce its own tokens, and
    pick the forward's token wherever the forward's top-2 margin exceeds
    max(MARGIN, twice the two paths' largest logit difference): bf16
    rounds at other places in the two paths (one row a product against
    all of them), so a margin of one or two bf16 steps can flip. The
    count under the bare MARGIN rule is printed beside it. ``inputs`` are
    the forward's other inputs (:func:`_zoo_score`). Returns the largest
    logit difference."""
    from repro_torch.models.transformer import forward
    with torch.inference_mode():
        fwd = forward(model, cfg, seqs, **(inputs or {}))
        fwd = fwd[:, p - 1:-1].float()
    dec = dec.float()
    new = seqs[:, p:]
    diff = float((dec - fwd).abs().max())
    top2 = torch.topk(fwd, 2, dim=-1).values
    gaps = top2[..., 0] - top2[..., 1]
    off = _pick(cfg, fwd) != new
    margin = max(MARGIN, 2 * diff)
    wrong = off & (gaps > margin)
    bare = off & (gaps > MARGIN)
    same = torch.equal(_pick(cfg, dec), new)
    worst = float(gaps[bare].max()) if bool(bare.any()) else 0.0
    print(f"{tag} bf16 decode path vs the forward over generated "
          f"{tuple(seqs.shape)}: largest logit difference {diff:.4f} (logit "
          f"scale {float(fwd.abs().max()):.3f}); margin max({MARGIN}, 2 x "
          f"{diff:.4f}) = {margin:.4f}: {int((gaps > margin).sum())} of "
          f"{gaps.numel()} generated positions checked, {int(wrong.sum())} "
          f"mismatches; under the bare {MARGIN} rule {int((gaps > MARGIN).sum())} "
          f"checked, {int(bare.sum())} off (their largest top-2 margin "
          f"{worst:.4f}); the teacher-forced decode reproduces the generated "
          f"tokens: {same}", flush=True)
    if int(wrong.sum()) or not same:
        raise AssertionError(f"{tag} decoded tokens disagree with the "
                             "forward")
    return diff


def _fp32_copy(cfg, model, device):
    """The same weights in fp32 (parameters and activations)."""
    from repro_torch.models.transformer import Model
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model32 = Model(cfg32, device=device)
    model32.load_state_dict({k: v.float()
                             for k, v in model.state_dict().items()})
    return cfg32, model32


def _check_zoo_fp32(cfg32, model32, seqs, tag: str = "[zoo fp32]",
                    ref_cfg=None, inputs=None) -> None:
    """One served row teacher-forced through every decode step (past the
    local layers' window) of the fp32 copy against its fp32 forward (under
    ``ref_cfg``, default ``cfg32``: an MoE arch's dropless one; ``inputs``
    the forward's other inputs, an encdec's ``enc_embed`` also encoded
    for the decode): the two paths differ by sums in another order only,
    so every position whose top-2 margin exceeds MARGIN must pick the
    forward's token."""
    from repro_torch.models.transformer import forward
    t0 = time.perf_counter()
    inputs = inputs or {}
    with torch.inference_mode():
        dec = _teacher_forced(model32, cfg32, seqs,
                              _enc_out(model32, cfg32, inputs))
        fwd = forward(model32, ref_cfg or cfg32, seqs,
                      **inputs)[:, :-1].float()
    diff = float((dec - fwd).abs().max())
    top2 = torch.topk(fwd, 2, dim=-1).values
    checked = (top2[..., 0] - top2[..., 1]) > MARGIN
    wrong = (_pick(cfg32, dec) != _pick(cfg32, fwd)) & checked
    print(f"{tag} the same weights in fp32, {tuple(seqs.shape)} "
          f"teacher-forced through {seqs.shape[1] - 1} decode steps against "
          f"the fp32 forward: largest logit difference {diff:.3e} (logit "
          f"scale {float(fwd.abs().max()):.3f}); {int(checked.sum())} of "
          f"{checked.numel()} positions checked (top-2 margin > {MARGIN}), "
          f"{int(wrong.sum())} mismatches; {time.perf_counter() - t0:.1f} s",
          flush=True)
    if int(wrong.sum()) or not int(checked.sum()):
        raise AssertionError("the fp32 decode path disagrees with the fp32 "
                             "forward, or no position was checked")


def _zoo_engine(name: str, cfg32, model32, device, ref_cfg=None) -> tuple:
    """ZOO_ENGINE_PLENS through an Engine of ZOO_ENGINE_SLOTS slots of the
    fp32 model, each request held to solo ``generate`` under the margin
    rule (the margins from the forward under ``ref_cfg``, default
    ``cfg32``). Returns (the engine run's launches, new tok/s over its
    generate steps)."""
    from repro_torch.launch.serve import generate
    from repro_torch.serving_engine import Engine
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg32.vocab, (p,)) for p in ZOO_ENGINE_PLENS]
    gens = list(ZOO_ENGINE_GENS)
    _reset_kernel_counts()
    eng = Engine(cfg32, model32, slots=ZOO_ENGINE_SLOTS,
                 max_len=ZOO_ENGINE_MAX_LEN)
    run = engine_run(eng, prompts, gens)
    launches = _kernel_counts()
    _engine_report(f"{name} fp32 ({len(prompts)} requests, prompts "
                   f"{list(ZOO_ENGINE_PLENS)}, S={ZOO_ENGINE_SLOTS}, buckets "
                   f"{eng.buckets})", run)
    if not all(run["ok"].values()):
        raise AssertionError(f"{name} engine: ok {run['ok']}")
    with torch.inference_mode():
        solo = [generate(model32, cfg32, torch.from_numpy(pr)[None].to(
            device), g, max_len=ZOO_ENGINE_MAX_LEN)[0]
            for pr, g in zip(prompts, gens)]
    limits = _margin_limits(model32, ref_cfg or cfg32, solo, prompts)
    checked, skipped = _held(f"{name} engine vs solo", run["tokens"],
                             [s[len(pr):].tolist()
                              for s, pr in zip(solo, prompts)], limits)
    print(f"[{name} engine] fp32 engine vs solo decode at max_len "
          f"{ZOO_ENGINE_MAX_LEN}: {checked} new tokens checked, {skipped} "
          f"skipped (after a top-2 margin <= {MARGIN}), 0 mismatches",
          flush=True)
    return launches, run["new"] / run["t_gen"]


def phase_zoo(smi: str, device="cuda") -> dict:
    """The attention decoder gemma3-4b at full width, bf16, from seed 0:
    (1) score 8 × 512 through ``make_forward`` and the eval ``loss_fn``;
    (2) at one period's depth (:func:`_cut_model`, OVERRIDE_LAYERS layers
    of the full model's tensors) serve ZOO_PROMPTS × (ZOO_PROMPT_LEN +
    ZOO_GEN) greedily at ZOO_MAX_LEN through the KV caches; the decode
    path, teacher-forced over the generated sequences (its steps alone
    timed), against the forward over them (:func:`_check_decoded_bf16`);
    (3) ``--mixer fd``
    and ``--mixer ski`` at one period's depth: their kernels launched
    and held to the plain versions; (4) the cut's weights in fp32: one
    served row through every decode step against the fp32 forward, and
    ZOO_ENGINE_PLENS through an Engine of ZOO_ENGINE_SLOTS slots held to
    solo ``generate``, both under the margin rule; 0 hand-kernel launches
    in (1), (2) and (4); (5) the smoke model and its FD override card vs
    CPU. Prints the rates, recorded and not claimed, beside the card.
    Returns the launch counts by path."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import init_model, loss_fn
    t_phase = time.perf_counter()
    cfg = get_config(ZOO_ARCH)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator().manual_seed(0), device=device)
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[zoo] {cfg.name}: {cfg.n_layers} layers ({cfg.n_scan_blocks} "
          f"blocks of period {cfg.period} + {cfg.n_tail_layers} tail), "
          f"d={cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv heads "
          f"x {cfg.head_dim}, window {cfg.window}, vocab {cfg.vocab}, "
          f"{cfg.dtype}; {n_params} parameters (param_count() "
          f"{cfg.param_count()['total']}, which leaves out the norm scales); "
          f"init {t_init:.2f} s", flush=True)
    launches = {}

    # (1) score
    batch = _ski_batch(cfg, SCORE_BATCH, SCORE_SEQ, device)
    _, launches["zoo_score"], score_tok_s = _zoo_score(
        "[zoo score]", cfg, model, batch, device)
    with torch.no_grad():
        loss = float(loss_fn(model, cfg, batch)[0])
    peak = torch.cuda.max_memory_allocated(device)
    print(f"[zoo score] eval loss {loss:.6f} (ln V = "
          f"{math.log(cfg.vocab):.6f}); max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.3f} GiB)", flush=True)
    if not math.isfinite(loss):
        raise AssertionError(f"zoo eval loss {loss}")

    # (2) serve, at one period's depth
    cut_cfg, cut = _cut_model(cfg, model)
    print(f"[zoo serve] the serve passes run on {cut_cfg.n_layers} layers "
          f"({', '.join(m for m, _ in cut_cfg.layers_spec)}), the full "
          "model's tensors", flush=True)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (ZOO_PROMPTS, ZOO_PROMPT_LEN))).to(device)
    with torch.inference_mode():
        generate(cut, cut_cfg, prompt[:, :8], 2, max_len=ZOO_MAX_LEN)
        _sync(device)
        _reset_kernel_counts()
        t0 = time.perf_counter()
        seqs = generate(cut, cut_cfg, prompt, ZOO_GEN, max_len=ZOO_MAX_LEN)
        _sync(device)
        t_gen = time.perf_counter() - t0
        launches["zoo_serve"] = _kernel_counts()
    if seqs.shape != (ZOO_PROMPTS, ZOO_PROMPT_LEN + ZOO_GEN) or not \
            torch.equal(seqs[:, :ZOO_PROMPT_LEN], prompt):
        raise AssertionError(f"zoo generate returned {tuple(seqs.shape)}")
    steps = ZOO_PROMPT_LEN + ZOO_GEN - 1
    print(f"[zoo serve] generate {ZOO_PROMPTS} x ({ZOO_PROMPT_LEN} + "
          f"{ZOO_GEN}) at max_len {ZOO_MAX_LEN} through the KV caches of "
          f"{cut_cfg.n_layers} layers (the prompt token by token): "
          f"{t_gen:.3f} s, {steps} decode steps ({steps / t_gen:.1f} "
          f"steps/s); kernel launches {launches['zoo_serve']}", flush=True)
    host_ms, _, dec = _decode_timed(cut, cut_cfg, seqs, ZOO_PROMPT_LEN,
                                    ZOO_MAX_LEN, device)
    decode_rate = seqs.shape[0] / host_ms * 1e3
    _check_decoded_bf16("[zoo serve]", cut_cfg, cut, ZOO_PROMPT_LEN, seqs,
                        dec)
    del dec

    # (3) the paper's mixers in the zoo arch
    rates = {}
    for mixer in ZOO_OVERRIDES:
        launches[f"zoo_{mixer}"], rates[mixer] = _zoo_override(
            mixer, cfg, model, batch, device)

    # (4) the cut's weights in fp32: decode against the forward, and the
    # engine against solo decode, under the margin rule
    cfg32, model32 = _fp32_copy(cut_cfg, cut, device)
    del model, cut
    _check_zoo_fp32(cfg32, model32, seqs[:1])
    launches["zoo_engine"], engine_rate = _zoo_engine("zoo", cfg32, model32,
                                                      device)
    for path in ("zoo_score", "zoo_serve", "zoo_engine"):
        _expect_no_launches(path, launches[path])
    del model32

    # (5) card vs CPU at smoke size
    small = reduce_for_smoke(cfg)
    _check_smoke_card_vs_cpu(small, device)
    _check_smoke_card_vs_cpu(dataclasses.replace(
        small, mixer_override="fd", name=small.name + "-fd"), device)
    print(f"[zoo] rates ({smi}; host clock, recorded, not claimed): scoring "
          f"{score_tok_s:.0f} tokens/s; decode alone {decode_rate:.1f} new "
          f"tok/s ({ZOO_PROMPTS} rows at positions {ZOO_PROMPT_LEN}-"
          f"{ZOO_MAX_LEN - 2}, {OVERRIDE_LAYERS} layers); fp32 engine "
          f"{engine_rate:.1f} new tok/s over its generate steps "
          f"({OVERRIDE_LAYERS} layers); --mixer fd scoring "
          f"{rates['fd']:.0f} tokens/s, --mixer ski {rates['ski']:.0f} "
          f"tokens/s ({OVERRIDE_LAYERS} layers)", flush=True)
    print(f"[zoo] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# ------------------------------------------------------------------- MoE
MOE_ARCH = "granite-moe-3b-a800m"
#: served prompts: 4 rows (a step of at most 4 tokens never drops an
#: assignment, whatever the capacity factor) of 224 tokens and 32 new at
#: max_len 256
MOE_PROMPTS, MOE_PROMPT_LEN, MOE_GEN, MOE_MAX_LEN = 4, 224, 32, 256


@contextlib.contextmanager
def _routing():
    """Inside the block every MoE routing appends its expert ids (T, k), a
    device tensor (no sync), to the yielded list."""
    from repro_torch.models import moe
    calls, route = [], moe.route

    def recording(x2d, router, k):
        w, ids, aux = route(x2d, router, k)
        calls.append(ids)
        return w, ids, aux
    with mock.patch.object(moe, "route", recording):
        yield calls


def _n_dropped(ids, cap: int, e: int) -> int:
    """Assignments of ids (T, k) past their expert's ``cap`` slots in the
    flat (token, k) order: those the capacity path drops."""
    from repro_torch.models import moe
    return int((moe.slot_positions(ids.reshape(-1), e) >= cap).sum())


def _set_flips(a, b) -> torch.Tensor:
    """Where two routings (…, k) chose other expert sets."""
    return (a.sort(-1).values != b.sort(-1).values).any(-1)


def _routing_flips(dec_calls, fwd_calls, n_layers: int, b: int,
                   n: int) -> tuple:
    """Routing of the decode steps (one call a layer a step, b rows each,
    steps at positions 0, 1, …) against the forward's over the same (b, n)
    tokens (one call a layer): (positions where some layer chose another
    top-k set, (layer, position) pairs that did, positions compared)."""
    dec = torch.stack(dec_calls)                     # (steps·L, b, k)
    steps = dec.shape[0] // n_layers
    dec = dec.view(steps, n_layers, b, -1).permute(2, 0, 1, 3)
    fwd = torch.stack([c.view(b, n, -1)[:, :steps] for c in fwd_calls], 2)
    flips = _set_flips(dec, fwd)                     # (b, steps, L)
    return int(flips.any(-1).sum()), int(flips.sum()), b * steps


def phase_moe(smi: str, device="cuda") -> dict:
    """The MoE decoder granite-moe-3b-a800m at full width, bf16, from seed
    0: (1) score 8 × 512 through ``make_forward`` and the eval ``loss_fn``
    at the config's capacity factor (the assignments it drops counted, two
    forwards the same bits); (2) the capacity path at cf = E / k (cap ≥ T,
    nothing drops) against the dropless ragged path on the same batch,
    within ZOO_BF16_TOL of the scale or twice the ragged path's distance
    from its fp32-activation run, and the ragged forward twice the same
    bits; (3) serve MOE_PROMPTS × (MOE_PROMPT_LEN + MOE_GEN) greedily at
    MOE_MAX_LEN (4 rows: dropless); the decode path, teacher-forced over
    the generated sequences (its steps alone timed), against the ragged
    forward (:func:`_check_decoded_bf16`), with the positions whose top-k
    expert sets differ between the two counted; (4) ``--mixer fd`` at
    OVERRIDE_LAYERS layers, its FFNs MoE; (5) the same weights in fp32: one
    served row through every decode step against the fp32 ragged forward,
    and the Engine of :func:`_zoo_engine` (4 slots: dropless) against solo
    decode, under the margin rule; 0 hand-kernel launches in (1), (3) and
    (5); (6) the smoke granite, grok-1 and granite ``--mixer fd`` card vs
    CPU. Prints the rates, recorded and not claimed, beside the card.
    Returns the launch counts by path."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_forward
    from repro_torch.models import moe
    from repro_torch.models.transformer import forward, init_model, loss_fn
    t_phase = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    e, k, cf = cfg.n_experts, cfg.top_k, cfg.moe_capacity_factor
    ragged = dataclasses.replace(cfg, moe_impl="ragged")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator().manual_seed(0), device=device)
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    n_norms = sum(p.numel() for name, p in model.named_parameters()
                  if name.endswith(".scale"))
    pc = cfg.param_count()
    print(f"[moe] {cfg.name}: {cfg.n_layers} (attention, moe) layers, "
          f"d={cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv heads "
          f"x {cfg.head_dim}, {e} experts top-{k} of d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab} (padded {cfg.vocab_padded}), {cfg.dtype}, "
          f"moe_impl {cfg.moe_impl} at cf {cf}; {n_params} parameters "
          f"(param_count() {pc['total']} + {n_norms} norm scales; active "
          f"{pc['active']}); init {t_init:.2f} s", flush=True)
    if n_params != pc["total"] + n_norms:
        raise AssertionError("moe parameter count")
    launches = {}

    # (1) score at the config's capacity factor
    batch = _ski_batch(cfg, SCORE_BATCH, SCORE_SEQ, device)
    t = SCORE_BATCH * SCORE_SEQ
    logits, launches["moe_score"], score_tok_s = _zoo_score(
        "[moe score]", cfg, model, batch, device)
    with torch.inference_mode(), _routing() as score_ids:
        again = forward(model, cfg, batch["tokens"])
        loss, metrics = loss_fn(model, cfg, batch)
    cap = moe.capacity(t, k, cf, e)
    dropped = sum(_n_dropped(ids, cap, e) for ids in score_ids[:cfg.n_layers])
    peak = torch.cuda.max_memory_allocated(device)
    print(f"[moe score] cap {cap} slots an expert for {t} tokens x top-{k}: "
          f"{dropped} of {t * k * cfg.n_layers} assignments dropped "
          f"({dropped / (t * k * cfg.n_layers):.4%}); two forwards the same "
          f"bits: {torch.equal(again, logits)}; eval loss {float(loss):.6f} "
          f"= nll {float(metrics['nll']):.6f} + 0.01 x aux "
          f"{float(metrics['aux']):.6f} (ln V = {math.log(cfg.vocab):.6f}, "
          f"aux 1.0 a layer when balanced); max_memory_allocated {peak} "
          f"bytes ({peak / 2**30:.3f} GiB)", flush=True)
    if not (torch.equal(again, logits) and math.isfinite(float(loss))):
        raise AssertionError("moe scoring: two forwards differ or the loss "
                             "is not finite")
    del again, logits

    # (2) capacity at cf = E / k (nothing drops) against ragged
    nodrop = dataclasses.replace(cfg, moe_capacity_factor=e / k)
    torch.cuda.reset_peak_memory_stats(device)
    with torch.inference_mode():
        with _routing() as cap_ids:
            got = forward(model, nodrop, batch["tokens"]).float()
        cap_peak = torch.cuda.max_memory_allocated(device)
        with _routing() as rag_ids:
            want = _repeat_equal("moe", "ragged forward", lambda: forward(
                model, ragged, batch["tokens"])).float()
        act32 = forward(model, dataclasses.replace(ragged, dtype="float32"),
                        batch["tokens"])
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    noise = float((want - act32).abs().max()) / scale
    tol = max(ZOO_BF16_TOL, 2 * noise)
    pairs = sum(int(_set_flips(a, b).sum())
                for a, b in zip(cap_ids, rag_ids[:cfg.n_layers]))
    print(f"[moe cap-vs-ragged] capacity path at cf {e / k} (cap "
          f"{moe.capacity(t, k, e / k, e)} >= {t}) vs the ragged path, "
          f"8 x 512 on the card: logits max abs err {err:.4f} (scale "
          f"{scale:.3f}; limit max({ZOO_BF16_TOL}, 2 x {noise:.4f}) = "
          f"{tol:.4f} x scale, the second the ragged path's bf16 against "
          f"fp32 activations); {pairs} of {t * cfg.n_layers} (layer, token) "
          f"pairs routed to another top-{k} set; the ragged forward twice "
          f"the same bits; peak {cap_peak / 2**30:.3f} GiB at cf {e / k}",
          flush=True)
    if not err <= tol * scale:
        raise AssertionError("moe capacity path differs from the ragged")
    del got, want, act32
    with torch.inference_mode():
        runs = {f"capacity cf {cf}": cfg, f"capacity cf {e / k}": nodrop,
                "ragged": ragged}
        ms = {name: time_ms(lambda c=c: forward(model, c, batch["tokens"]),
                            reps=5) for name, c in runs.items()}
        _profile_forward(make_forward(cfg), model, batch["tokens"], device,
                         reps=1, tag="[moe score]")
    print("[moe cap-vs-ragged] a forward over 8 x 512, CUDA events, median "
          "of 5: " + "; ".join(f"{name} {t:.3f} ms" for name, t in ms.items()),
          flush=True)

    # (3) serve (4 rows: no step drops)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (MOE_PROMPTS, MOE_PROMPT_LEN))).to(device)
    with torch.inference_mode():
        generate(model, cfg, prompt[:, :8], 2, max_len=MOE_MAX_LEN)
        _sync(device)
        _reset_kernel_counts()
        t0 = time.perf_counter()
        seqs = generate(model, cfg, prompt, MOE_GEN, max_len=MOE_MAX_LEN)
        _sync(device)
        t_gen = time.perf_counter() - t0
        launches["moe_serve"] = _kernel_counts()
    if seqs.shape != (MOE_PROMPTS, MOE_PROMPT_LEN + MOE_GEN) or not \
            torch.equal(seqs[:, :MOE_PROMPT_LEN], prompt):
        raise AssertionError(f"moe generate returned {tuple(seqs.shape)}")
    steps = MOE_PROMPT_LEN + MOE_GEN - 1
    print(f"[moe serve] generate {MOE_PROMPTS} x ({MOE_PROMPT_LEN} + "
          f"{MOE_GEN}) at max_len {MOE_MAX_LEN} (capacity path, cap "
          f"{moe.capacity(MOE_PROMPTS, k, cf, e)} >= {MOE_PROMPTS} rows a "
          f"step: nothing drops): {t_gen:.3f} s, {steps} decode steps "
          f"({steps / t_gen:.1f} steps/s); kernel launches "
          f"{launches['moe_serve']}", flush=True)
    with torch.inference_mode():
        _profile_forward(lambda m, p: generate(m, cfg, p, 2,
                                               max_len=MOE_MAX_LEN),
                         model, prompt[:, :8], device, reps=1,
                         tag="[moe serve]",
                         unit="generate of 4 x (8 + 2) (9 decode steps)")
    with _routing() as dec_ids:
        host_ms, _, dec = _decode_timed(model, cfg, seqs, MOE_PROMPT_LEN,
                                        MOE_MAX_LEN, device)
        decode_rate = seqs.shape[0] / host_ms * 1e3
    with _routing() as fwd_ids:
        _check_decoded_bf16("[moe serve]", ragged, model, MOE_PROMPT_LEN,
                            seqs, dec)
    flips, pairs, n_pos = _routing_flips(dec_ids, fwd_ids, cfg.n_layers,
                                         MOE_PROMPTS, seqs.shape[1])
    print(f"[moe serve] routing flips, decode (capacity, {MOE_PROMPTS} rows "
          f"a step) vs the ragged forward: {flips} of {n_pos} positions "
          f"with some layer on another top-{k} set ({pairs} of "
          f"{n_pos * cfg.n_layers} (layer, position) pairs)", flush=True)
    del dec, dec_ids, fwd_ids

    # (4) the paper's FD mixer in the MoE arch
    launches["moe_fd"], fd_rate = _zoo_override("fd", cfg, model, batch,
                                                device, tag="[moe fd]")

    # (5) the same weights in fp32
    cfg32, model32 = _fp32_copy(cfg, model, device)
    ragged32 = dataclasses.replace(cfg32, moe_impl="ragged")
    del model
    _check_zoo_fp32(cfg32, model32, seqs[:1], tag="[moe fp32]",
                    ref_cfg=ragged32)
    launches["moe_engine"], engine_rate = _zoo_engine(
        "moe", cfg32, model32, device, ref_cfg=ragged32)
    for path in ("moe_score", "moe_serve", "moe_engine"):
        _expect_no_launches(path, launches[path])
    del model32

    # (6) card vs CPU at smoke size
    small = reduce_for_smoke(cfg)
    _check_smoke_card_vs_cpu(small, device)
    _check_smoke_card_vs_cpu(reduce_for_smoke(get_config("grok-1-314b")),
                             device)
    _check_smoke_card_vs_cpu(dataclasses.replace(
        small, mixer_override="fd", name=small.name + "-fd"), device)
    print(f"[moe] rates ({smi}; host clock, recorded, not claimed): scoring "
          f"{score_tok_s:.0f} tokens/s; decode alone {decode_rate:.1f} new "
          f"tok/s ({MOE_PROMPTS} rows at positions {MOE_PROMPT_LEN}-"
          f"{MOE_MAX_LEN - 2}); fp32 engine {engine_rate:.1f} new tok/s over "
          f"its generate steps; --mixer fd scoring {fd_rate:.0f} tokens/s "
          f"({OVERRIDE_LAYERS} layers)", flush=True)
    print(f"[moe] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# ---------------------------------------- encoder-decoder and prefix-VLM
ENCDEC_ARCH = "whisper-medium"
#: stub encoder frames (Whisper's 30-s window) and text tokens (Whisper's
#: text context) a scored row
ENCDEC_FRAMES, ENCDEC_SEQ = 1500, 448
#: served rows: 16 prompt and 64 new tokens each, every step attending
#: over ENCDEC_FRAMES encoded frames
ENCDEC_PROMPTS, ENCDEC_PROMPT_LEN, ENCDEC_GEN = 4, 16, 64
#: the decoder's depth under ``--mixer fd`` (the encoder keeps its 24)
ENCDEC_FD_LAYERS = 2
#: whisper-medium's parameters (the port's leaves) and ``param_count()``
#: (the decoder's matrices and the embeddings, as JAX counts them)
ENCDEC_PARAMS = (1_012_525_056, 509_083_648)
VLM_ARCH = "paligemma-3b"
#: text tokens a scored row (after paligemma's 256 stub patches)
VLM_SEQ = 256
#: served rows: the text alone, 32 prompt and 32 new tokens each
VLM_PROMPTS, VLM_PROMPT_LEN, VLM_GEN = 4, 32, 32
#: the depth ``--mixer ski`` and ``--mixer tno`` score at
VLM_OVERRIDE_LAYERS = 2
#: paligemma-3b's ``param_count()`` (every matrix; the port adds the norm
#: scales)
VLM_PARAM_COUNT = 3_035_627_520


def _expect_launches(what: str, got: dict, want: dict) -> None:
    """``want`` launches of its kernels on a path, and none of another."""
    want = {**{k: 0 for k in got}, **want}
    if got != want:
        raise AssertionError(f"{what} launched {got}, not {want}")


def _enc_out(model, cfg, inputs: dict):
    """An encdec model's ``serving.encode`` of ``inputs["enc_embed"]``;
    None for other inputs."""
    from repro_torch.models import serving
    if "enc_embed" not in inputs:
        return None
    return serving.encode(model, cfg, inputs["enc_embed"])


def _stub(b: int, s: int, d: int, seed: int, device, dtype):
    """(b, s, d) standard normals from a numpy seed: the stub frames or
    patches a frontend would make."""
    a = np.random.default_rng(seed).standard_normal((b, s, d),
                                                    dtype=np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _draw_on_card(cfg, device):
    """``init_model`` from seed 0 drawn by a CUDA generator (no host copy
    of a leaf), timed; returns (model, init seconds, peak bytes)."""
    from repro_torch.models.transformer import init_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    model = init_model(cfg, gen, device=device)
    _sync(device)
    t_init = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return model, t_init, peak


def _score_kind(tag: str, cfg, model, batch, inputs, device) -> tuple:
    """:func:`_zoo_score` with the kind's inputs, then the eval
    ``loss_fn`` over the text; prints the loss and the peak memory.
    Returns (launches, text tokens/s)."""
    from repro_torch.models.transformer import loss_fn
    _, launches, tok_s = _zoo_score(tag, cfg, model, batch, device,
                                    inputs=inputs)
    with torch.no_grad():
        loss = float(loss_fn(model, cfg, {**batch, **inputs})[0])
    peak = torch.cuda.max_memory_allocated(device)
    print(f"{tag} eval loss over the text {loss:.6f} (ln V = "
          f"{math.log(cfg.vocab):.6f}); max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.3f} GiB)", flush=True)
    if not math.isfinite(loss):
        raise AssertionError(f"{tag} eval loss {loss}")
    return launches, tok_s


def _serve_kind(tag: str, cfg, model, prompt, gen: int, device,
                enc_out=None) -> tuple:
    """A warm-up, then one counted greedy ``generate`` of ``gen`` tokens
    at max_len p + gen (``enc_out`` to every step); returns (sequences,
    launches, seconds)."""
    from repro_torch.launch.serve import generate
    b, p = prompt.shape
    with torch.inference_mode():
        generate(model, cfg, prompt[:, :4], 2, max_len=p + gen,
                 enc_out=enc_out)
        _sync(device)
        _reset_kernel_counts()
        t0 = time.perf_counter()
        seqs = generate(model, cfg, prompt, gen, max_len=p + gen,
                        enc_out=enc_out)
        _sync(device)
        t_gen = time.perf_counter() - t0
        launches = _kernel_counts()
    if seqs.shape != (b, p + gen) or not torch.equal(seqs[:, :p], prompt):
        raise AssertionError(f"{tag} generate returned {tuple(seqs.shape)}")
    print(f"{tag} generate {b} x ({p} + {gen}) at max_len {p + gen} (the "
          f"prompt token by token): {t_gen:.3f} s, {p + gen - 1} decode "
          f"steps ({(p + gen - 1) / t_gen:.1f} steps/s); kernel launches "
          f"{launches}", flush=True)
    return seqs, launches, t_gen


def _trace_decode(tag: str, model, cfg, seqs, device, enc_out=None) -> dict:
    """``torch.profiler`` over 8 decode steps of the served rows
    teacher-forced (:func:`_profile_forward`'s numbers)."""
    with torch.inference_mode():
        return _profile_forward(
            lambda m, toks: _teacher_forced(m, cfg, toks, enc_out), model,
            seqs[:, :9], device, reps=1, tag=tag,
            unit=f"teacher-forced pass of 8 decode steps of {len(seqs)} rows")


def _fd_row1(n: int) -> str:
    """The kernel of row 1 (``fd_fused.py:80``) that the causal FD
    spectrum at length n launches: the fused ``causal_spectrum`` or the
    window route's ``hilbert_window``."""
    from repro_torch.kernels import backend
    return ("causal_spectrum" if backend.causal_spectrum_route(n) == "fused"
            else "hilbert_window")


def _encdec_kernels(peaks, device) -> dict:
    """``hilbert_window`` and ``fd_mul`` at whisper ``--mixer fd``'s
    scoring shape (d = 1,024, n = 448: the window route), each against
    its plain version, timed beside its bound and library call."""
    from repro_torch.kernels import fd_fused, ref
    g = torch.Generator(device=device).manual_seed(6)
    d, n, b = 1024, ENCDEC_SEQ, SCORE_BATCH
    kt = torch.randn(d, 2 * n, device=device, generator=g)
    w = ref.hilbert_window_ref(torch.ones(1, 2 * n, device=device), n)[0]
    out = {"hilbert_window": _kernel_entry(
        "hilbert_window", "src/repro/kernels/fd_fused.py:80",
        fd_fused.hilbert_window(kt, n), ref.hilbert_window_ref(kt, n),
        lambda: fd_fused.hilbert_window(kt, n),
        lambda: ref.hilbert_window_ref(kt, n), lambda: kt * w,
        nbytes=4 * d * (n + 1) + 4 * kt.numel(), nops=d * (n + 1),
        peaks=peaks)}
    x = torch.randn(b, d, n + 1, dtype=torch.complex64, device=device,
                    generator=g)
    k = torch.randn(d, n + 1, dtype=torch.complex64, device=device,
                    generator=g)
    out["fd_mul"] = _kernel_entry(
        "fd_mul", "src/repro/kernels/fd_fused.py:162",
        torch.view_as_real(fd_fused.fd_mul(x, k)),
        torch.view_as_real(ref.fd_mul_ref(x, k)),
        lambda: fd_fused.fd_mul(x, k), lambda: ref.fd_mul_ref(x, k),
        lambda: torch.mul(x, k), nbytes=8 * (2 * x.numel() + k.numel()),
        nops=6 * x.numel(), peaks=peaks)
    for name, e in out.items():
        print(f"[encdec kernel] {name} at whisper --mixer fd's shape (d="
              f"{d}, n={n}, b={b}): {e}", flush=True)
    return out


def phase_encdec(smi: str, peaks, device="cuda") -> tuple:
    """The encoder-decoder whisper-medium at full width (24 encoder + 24
    decoder layers, d = 1,024, 16 heads of 64, vocab 51,865, bf16, drawn
    on the card from seed 0; the audio frontend a stub: frames from a
    numpy seed): (1) score SCORE_BATCH rows of ENCDEC_FRAMES frames and
    ENCDEC_SEQ tokens through ``make_forward`` and the eval ``loss_fn``;
    (2) ``serving.encode`` ENCDEC_PROMPTS rows of frames once, then serve
    ENCDEC_PROMPTS × (ENCDEC_PROMPT_LEN + ENCDEC_GEN) greedily through
    ``generate`` with ``enc_out``: each step's cross sublayers recompute k
    and v from all 1,500 frames, as JAX's; the decode path teacher-forced
    over the generated rows (its steps after the prompt timed) against
    the forward under phase zoo's bf16 rule; (3) ``--mixer fd`` with the
    decoder cut to ENCDEC_FD_LAYERS layers: scored (one row-1 kernel and
    one ``fd_mul`` a layer at n = 448, held to the plain versions as phase
    zoo holds its overrides) and served (the stream caches' kernels
    realised once a layer), its decode held to its forward under the same
    rule; (4) the same weights in fp32: one served row through every
    decode step against the fp32 forward under the 1e-3 margin rule; (5)
    the ``Engine`` refuses the arch, as JAX's; (6) the smoke whisper and
    its FD override card vs CPU. Asserted: 0 hand-kernel launches in (1),
    (2) and (4). Returns (the kernel entries at the FD shape, the launches
    by path)."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import serving
    from repro_torch.serving_engine import Engine
    t_phase = time.perf_counter()
    entries = _encdec_kernels(peaks, device)
    cfg = get_config(ENCDEC_ARCH)
    dt = getattr(torch, cfg.dtype)
    model, t_init, init_peak = _draw_on_card(cfg, device)
    parts = {part: sum(p.numel() for k, p in model.named_parameters()
                       if k.startswith(part))
             for part in ("enc_", "layers.", "embed", "unembed")}
    n_params = sum(p.numel() for p in model.parameters())
    pc = cfg.param_count()["total"]
    print(f"[encdec] {cfg.name}: {cfg.enc_layers} encoder + {cfg.n_layers} "
          f"decoder layers, d={cfg.d_model}, {cfg.n_heads} heads x "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab} (padded "
          f"{cfg.vocab_padded}), {cfg.dtype}; {n_params} parameters: encoder "
          f"{parts['enc_']}, decoder layers with cross-attention "
          f"{parts['layers.']}, embeddings {parts['embed'] + parts['unembed']}"
          f"; param_count() {pc}, which, as JAX's, counts the decoder's "
          f"self-attention and FFN matrices and the embeddings and leaves "
          f"out the encoder, the cross-attention and the norm scales; "
          f"init_model {t_init:.2f} s drawing on the card; "
          f"max_memory_allocated {init_peak} bytes", flush=True)
    if (n_params, pc) != ENCDEC_PARAMS:
        raise AssertionError("whisper-medium parameter count")
    launches = {}

    # (1) score
    batch = _ski_batch(cfg, SCORE_BATCH, ENCDEC_SEQ, device)
    frames = _stub(SCORE_BATCH, ENCDEC_FRAMES, cfg.d_model, 0, device, dt)
    inputs = {"enc_embed": frames}
    launches["encdec_score"], score_tok_s = _score_kind(
        "[encdec score]", cfg, model, batch, inputs, device)

    # (2) serve through encode + generate with enc_out
    p, gen = ENCDEC_PROMPT_LEN, ENCDEC_GEN
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (ENCDEC_PROMPTS, p))).to(device)
    serve_in = {"enc_embed": frames[:ENCDEC_PROMPTS]}
    with torch.inference_mode():
        serving.encode(model, cfg, serve_in["enc_embed"])       # warm-up
        _sync(device)
        t0 = time.perf_counter()
        enc_out = serving.encode(model, cfg, serve_in["enc_embed"])
        _sync(device)
        t_enc = time.perf_counter() - t0
    seqs, launches["encdec_serve"], t_gen = _serve_kind(
        "[encdec serve]", cfg, model, prompt, gen, device, enc_out)
    host_ms, ev_ms, dec = _decode_timed(model, cfg, seqs, p, p + gen,
                                        device, enc_out=enc_out)
    cross_flop = (2 * 2 * ENCDEC_PROMPTS * ENCDEC_FRAMES * cfg.d_model
                  * cfg.n_heads * cfg.head_dim * cfg.n_layers)
    tr = _trace_decode("[encdec decode]", model, cfg, seqs, device, enc_out)
    print(f"[encdec serve] encode {ENCDEC_PROMPTS} x {ENCDEC_FRAMES} frames "
          f"once: {t_enc * 1e3:.3f} ms; a decode step of {ENCDEC_PROMPTS} "
          f"rows alone ({gen - 1} steps after the prompt, {smi}): "
          f"{host_ms:.3f} ms host clock, {ev_ms:.3f} ms CUDA events; "
          f"traced: {tr['launches'] / 8:.1f} kernel launches and "
          f"{tr['busy_ms'] / 8:.3f} ms device busy a step (idle share "
          f"{1 - tr['busy_ms'] / tr['wall_ms']:.3f}); the cross k/v "
          f"projections recomputed every step are {cross_flop} FLOP "
          f"({cross_flop / peaks[3] * 1e3:.3f} ms at the bf16 peak)",
          flush=True)
    _check_decoded_bf16("[encdec serve]", cfg, model, p, seqs, dec,
                        serve_in)
    del dec

    # (3) --mixer fd at ENCDEC_FD_LAYERS decoder layers
    row1 = _fd_row1(ENCDEC_SEQ)
    launches["encdec_fd"], fd_rate = _zoo_override(
        "fd", cfg, model, batch, device, tag="[encdec fd]",
        n_layers=ENCDEC_FD_LAYERS, inputs=inputs,
        per_layer={row1: 1, "fd_mul": 1})
    fd_cfg, fd_model = _override_model(cfg, model, "fd", device,
                                       ENCDEC_FD_LAYERS)
    fd_seqs, launches["encdec_fd_serve"], _ = _serve_kind(
        "[encdec fd serve]", fd_cfg, fd_model, prompt, gen, device, enc_out)
    # init_cache realises each FD layer's kernel once (core/hilbert's
    # causal_spectrum: the window); the steps run cuFFT and cuBLAS
    _expect_launches("[encdec fd serve] generate",
                     launches["encdec_fd_serve"],
                     {"hilbert_window": ENCDEC_FD_LAYERS})
    _, _, fd_dec = _decode_timed(fd_model, fd_cfg, fd_seqs, p, p + gen,
                                 device, enc_out=enc_out)
    _check_decoded_bf16("[encdec fd serve]", fd_cfg, fd_model, p, fd_seqs,
                        fd_dec, serve_in)
    del fd_model, fd_dec

    # (5) the serving engine refuses the arch, as JAX's does
    try:
        Engine(cfg, model, slots=2, max_len=64)
    except NotImplementedError as e:
        print(f"[encdec] the Engine refuses {cfg.name}: {e}", flush=True)
    else:
        raise AssertionError("the Engine accepted an encdec arch")

    # (4) the same weights in fp32
    cfg32, model32 = _fp32_copy(cfg, model, device)
    del model, enc_out
    _reset_kernel_counts()
    _check_zoo_fp32(cfg32, model32, seqs[:1], tag="[encdec fp32]",
                    inputs={"enc_embed": frames[:1].float()})
    launches["encdec_fp32"] = _kernel_counts()
    for path in ("encdec_score", "encdec_serve", "encdec_fp32"):
        _expect_no_launches(path, launches[path])
    del model32, frames, batch
    torch.cuda.empty_cache()

    # (6) card vs CPU at smoke size
    small = reduce_for_smoke(cfg)

    def frames_of(dev):
        return {"enc_embed": _stub(2, 40, small.d_model, 3, dev,
                                   getattr(torch, small.dtype))}
    for mixer in ("", "fd"):
        _check_smoke_card_vs_cpu(dataclasses.replace(
            small, mixer_override=mixer,
            name=small.name + (f"-{mixer}" if mixer else "")), device,
            frames_of, "[encdec check]")
    print(f"[encdec] rates ({smi}; host clock, recorded, not claimed): "
          f"scoring {score_tok_s:.0f} text tokens/s ({ENCDEC_FRAMES} frames "
          f"a row); generate {t_gen:.3f} s; decode alone "
          f"{ENCDEC_PROMPTS / host_ms * 1e3:.1f} new tok/s; --mixer fd "
          f"scoring {fd_rate:.0f} text tokens/s ({ENCDEC_FD_LAYERS} decoder "
          f"layers)", flush=True)
    print(f"[encdec] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return entries, launches


def _vlm_kernels(peaks, device) -> dict:
    """The bidirectional SKI kernels at paligemma ``--mixer ski``'s
    shape: x (8, 512, 2,048) (256 patches + 256 tokens), r = 64, m = 32,
    left = m // 2: ``interp_reduce``, ``ski_fused_pass2`` and
    ``short_conv`` (which the fused route's pass 2 subsumes; held here at
    the path's offset), each against its plain version, timed beside its
    bound."""
    from repro_torch.core import ski
    g = torch.Generator(device=device).manual_seed(7)
    b, n, d, r, m = SCORE_BATCH, 2 * VLM_SEQ, 2048, 64, 32
    x = torch.randn(b, n, d, device=device, generator=g)
    z = torch.randn(b, r, d, device=device, generator=g)
    a = torch.randn(d, r, r, device=device, generator=g)
    f = torch.randn(d, m, device=device, generator=g)
    lo, w_lo, _ = ski.make_inducing(n, r, device)
    label = "paligemma bidirectional"
    out = {"interp_reduce": _interp_entries(label, x, z, lo, w_lo,
                                            peaks)["interp_reduce"]}
    out["short_conv"] = _short_conv_entry(label, x, f, m // 2, peaks)
    out["ski_fused_pass2"] = _pass2_entry(label, x, z, a, f, m // 2, peaks)
    return out


def phase_prefix_vlm(smi: str, peaks, device="cuda") -> tuple:
    """The prefix-VLM paligemma-3b at full width (18 layers, d = 2,048, MQA:
    8 heads over 1 kv head of 256, d_ff 16,384, vocab 257,216, bf16, drawn
    on the card from seed 0; the SigLIP frontend a stub: 256 patches from
    a numpy seed): (1) score SCORE_BATCH rows of 256 patches + VLM_SEQ
    tokens under the prefix mask through ``make_forward`` and the eval
    ``loss_fn`` (over the text alone); (2) serve the text alone,
    VLM_PROMPTS × (VLM_PROMPT_LEN + VLM_GEN), as JAX's decode does (it
    never sees the patches), held to the text-only forward with the prefix
    cut to 0 under phase zoo's bf16 rule; (3) ``--mixer ski`` and
    ``--mixer tno`` at VLM_OVERRIDE_LAYERS layers under the prefix mask,
    which runs them bidirectionally (the SKI kernels' bidirectional route,
    d = 2,048, n = 512, r = 64: 1 ``interp_reduce`` + 1 ``ski_fused_pass2``
    a layer; tno: none), held to the plain versions as phase zoo holds its
    overrides, and ``--mixer fd`` refused; (4) the smoke paligemma, plain
    and with SKI, card vs CPU. Asserted: 0 hand-kernel launches in (1)
    and (2). Returns (the kernel entries at the SKI shape, the launches by
    path)."""
    from repro_torch.configs import get_config, reduce_for_smoke
    t_phase = time.perf_counter()
    entries = _vlm_kernels(peaks, device)
    cfg = get_config(VLM_ARCH)
    dt = getattr(torch, cfg.dtype)
    model, t_init, init_peak = _draw_on_card(cfg, device)
    n_params = sum(p.numel() for p in model.parameters())
    pc = cfg.param_count()["total"]
    print(f"[vlm] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv head x {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab} (padded {cfg.vocab_padded}), "
          f"{cfg.n_prefix} stub patches, {cfg.dtype}; {n_params} parameters "
          f"(param_count() {pc} + {n_params - pc} norm scales); init_model "
          f"{t_init:.2f} s drawing on the card; max_memory_allocated "
          f"{init_peak} bytes", flush=True)
    if pc != VLM_PARAM_COUNT or n_params != pc + (2 * cfg.n_layers
                                                  + 1) * cfg.d_model:
        raise AssertionError("paligemma-3b parameter count")
    launches = {}

    # (1) score under the prefix mask
    batch = _ski_batch(cfg, SCORE_BATCH, VLM_SEQ, device)
    inputs = {"patches": _stub(SCORE_BATCH, cfg.n_prefix, cfg.d_model, 0,
                               device, dt)}
    launches["vlm_score"], score_tok_s = _score_kind(
        "[vlm score]", cfg, model, batch, inputs, device)

    # (2) serve the text alone
    p, gen = VLM_PROMPT_LEN, VLM_GEN
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (VLM_PROMPTS, p))).to(device)
    seqs, launches["vlm_serve"], t_gen = _serve_kind(
        "[vlm serve]", cfg, model, prompt, gen, device)
    host_ms, ev_ms, dec = _decode_timed(model, cfg, seqs, p, p + gen, device)
    tr = _trace_decode("[vlm decode]", model, cfg, seqs, device)
    print(f"[vlm serve] a decode step of {VLM_PROMPTS} rows alone (MQA at "
          f"head_dim {cfg.head_dim}; {gen - 1} steps after the prompt, "
          f"{smi}): {host_ms:.3f} ms host clock, {ev_ms:.3f} ms CUDA events; "
          f"traced: {tr['launches'] / 8:.1f} kernel launches and "
          f"{tr['busy_ms'] / 8:.3f} ms device busy a step (idle share "
          f"{1 - tr['busy_ms'] / tr['wall_ms']:.3f})", flush=True)
    text = dataclasses.replace(cfg, n_prefix=0)
    _check_decoded_bf16("[vlm serve] (forward with the prefix cut to 0)",
                        text, model, p, seqs, dec,
                        {"patches": inputs["patches"][:VLM_PROMPTS, :0]})
    del dec
    for path in ("vlm_score", "vlm_serve"):
        _expect_no_launches(path, launches[path])

    # (3) the paper's mixers, bidirectional under the prefix mask
    rates = {}
    for mixer, per_layer in (("ski", ZOO_OVERRIDES["ski"]), ("tno", {})):
        launches[f"vlm_{mixer}"], rates[mixer] = _zoo_override(
            mixer, cfg, model, batch, device, tag=f"[vlm {mixer}]",
            n_layers=VLM_OVERRIDE_LAYERS, inputs=inputs, per_layer=per_layer)
    try:
        _override_model(cfg, model, "fd", device, VLM_OVERRIDE_LAYERS)
    except NotImplementedError as e:
        print(f"[vlm fd] refused: {e}", flush=True)
    else:
        raise AssertionError("paligemma --mixer fd was not refused")
    del model, batch, inputs
    torch.cuda.empty_cache()

    # (4) card vs CPU at smoke size
    small = reduce_for_smoke(cfg)

    def patches_of(dev):
        return {"patches": _stub(2, small.n_prefix, small.d_model, 3, dev,
                                 getattr(torch, small.dtype))}
    for mixer in ("", "ski"):
        _check_smoke_card_vs_cpu(dataclasses.replace(
            small, mixer_override=mixer,
            name=small.name + (f"-{mixer}" if mixer else "")), device,
            patches_of, "[vlm check]")
    print(f"[vlm] rates ({smi}; host clock, recorded, not claimed): scoring "
          f"{score_tok_s:.0f} text tokens/s ({cfg.n_prefix} patches a row); "
          f"generate {t_gen:.3f} s; decode alone "
          f"{VLM_PROMPTS / host_ms * 1e3:.1f} new tok/s; --mixer ski "
          f"{rates['ski']:.0f}, --mixer tno {rates['tno']:.0f} text tokens/s "
          f"({VLM_OVERRIDE_LAYERS} layers)", flush=True)
    print(f"[vlm] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return entries, launches


# ------------------------------------------------------------ SKI scoring
def _ski_batch(cfg, b: int, s: int, device):
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, s + 1))).to(device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _standalone_wrappers_refuse_grad(device) -> None:
    """Each of the eight SKI kernel wrappers called on its own writes a
    tensor autograd cannot see, so on the card it refuses an input that
    requires grad (gradients go through the ops entries), before any
    launch."""
    from repro_torch.kernels import (interp_matvec, ops, short_conv,
                                     ski_fused, ski_grad)
    x = torch.randn(2, 16, 8, device=device)
    z = torch.randn(2, 4, 8, device=device)
    a = torch.randn(8, 4, 4, device=device)
    f = torch.randn(8, 3, device=device)
    req = lambda t: t.clone().requires_grad_()
    lo = torch.zeros(16, dtype=torch.int32, device=device)
    calls = {"interp_reduce": lambda: interp_matvec.interp_reduce(
                 req(x), None, None, 4),
             "interp_expand": lambda: interp_matvec.interp_expand(
                 req(z), lo, None),
             "short_conv": lambda: short_conv.short_conv(x, req(f), 1),
             "ski_fused_pass2": lambda: ski_fused.ski_fused_pass2(
                 x, z, req(a), f, True),
             "ski_windowed_pass2": lambda: ski_fused.ski_windowed_pass2(
                 x, z, req(torch.randn(8, 7, device=device)), f, True),
             "ski_expand_pass2": lambda: ski_fused.ski_expand_pass2(
                 req(x), z, f, False),
             "gram_grad": lambda: ski_grad.gram_grad(z, req(z)),
             "conv_tap_grad": lambda: ski_grad.conv_tap_grad(req(x), x, 3, 0)}
    ops.reset_ski_counters()
    for name, call in calls.items():
        try:
            call()
        except NotImplementedError:
            pass
        else:
            raise AssertionError(f"{name} accepted an input requiring grad")
    if any(ops.ski_counters().values()):
        raise AssertionError(f"a refused call launched {ops.ski_counters()}")
    print(f"[score] standalone {', '.join(calls)} refuse an input that "
          "requires grad on the card, no kernel launched", flush=True)


def _profile_forward(fwd, model, tokens, device, reps: int = 3,
                     tag: str = "[score]", kernels_of=(),
                     unit: str = "forwards") -> dict:
    """Where a scoring forward's time goes: ``torch.profiler`` over
    ``reps`` forwards (traced, so the wall is inflated), the device-busy
    share of the wall, the kernel launches and the kernels with the most
    device time. Returns the device ms a forward of the kernels whose
    names hold each of ``kernels_of``, and under "busy_ms", "wall_ms" and
    "launches" those of the traced run."""
    from torch.profiler import ProfilerActivity, profile
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fwd(model, tokens)
        _sync(device)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3   # ms
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"{tag} traced: {reps} {unit}, wall {wall * 1e3:.3f} ms, "
          f"device busy {busy:.3f} ms, idle share "
          f"{1 - busy / (wall * 1e3):.3f}, "
          f"{sum(e.count for e in kernels)} kernel launches; top kernels by "
          "device time: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} "
                      f"ms x{e.count}" for e in top), flush=True)
    out = {name: sum(e.self_device_time_total for e in kernels
                     if name in e.key) / 1e3 / reps
           for name in kernels_of}
    return dict(out, busy_ms=busy, wall_ms=wall * 1e3,
                launches=sum(e.count for e in kernels))


def phase_ski_score(device, cfg=None, pass2: str = "ski_fused_pass2",
                    tag: str = "[score]") -> dict:
    """A full-width SKI scoring path: ``cfg`` (default ski-tnn-lm-wt103)
    must launch one ``interp_reduce`` and one ``pass2`` a layer and no
    other SKI kernel a forward. The default path also profiles a forward
    and checks the standalone wrappers' refusals. Returns its launch
    counts (one forward)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_forward
    from repro_torch.models.transformer import init_model, loss_fn
    default = cfg is None
    cfg = cfg or get_config("ski-tnn-lm-wt103")
    model = init_model(cfg, torch.Generator().manual_seed(0), device=device)
    batch = _ski_batch(cfg, SCORE_BATCH, SCORE_SEQ, device)
    fwd = make_forward(cfg)
    print(f"{tag} {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"r={cfg.tno_rank}, m={cfg.tno_filter}, vocab {cfg.vocab}, "
          f"{sum(p.numel() for p in model.parameters())} parameters; "
          f"{SCORE_BATCH} x {SCORE_SEQ} tokens", flush=True)
    fwd(model, batch["tokens"])                        # warm-up
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_ski_counters()
    logits = fwd(model, batch["tokens"])
    _sync(device)
    launches = ops.ski_counters()
    peak = torch.cuda.max_memory_allocated(device)
    if launches != {**NO_SKI_LAUNCHES, "interp_reduce": cfg.n_layers,
                    pass2: cfg.n_layers}:
        raise AssertionError(f"one SKI forward launched {launches}")
    if not (logits.shape == (SCORE_BATCH, SCORE_SEQ, cfg.vocab_padded)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"SKI logits {tuple(logits.shape)} not finite "
                             "or of the wrong shape")
    walls = []
    for _ in range(SCORE_REPS):
        t0 = time.perf_counter()
        fwd(model, batch["tokens"])
        _sync(device)
        walls.append(time.perf_counter() - t0)
    ms = statistics.median(walls) * 1e3
    with torch.no_grad():
        loss, _ = loss_fn(model, cfg, batch)
    if not math.isfinite(float(loss)):
        raise AssertionError(f"SKI eval loss {float(loss)}")
    print(f"{tag} make_forward {SCORE_BATCH}x{SCORE_SEQ}: median {ms:.3f} "
          f"ms of {SCORE_REPS} (min {min(walls) * 1e3:.3f}, max "
          f"{max(walls) * 1e3:.3f}), {SCORE_BATCH * SCORE_SEQ / ms * 1e3:.0f} "
          f"tokens/s; eval loss {float(loss):.6f}; launches per forward "
          f"{launches}; max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.3f} GiB)", flush=True)
    if default:
        _profile_forward(fwd, model, batch["tokens"], device)
    # card vs CPU at full width on 1 x 512 tokens
    one = {k: v[:1] for k, v in batch.items()}
    cpu_model = init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    want = fwd(cpu_model, one["tokens"].cpu())
    got = fwd(model, one["tokens"]).cpu()
    with torch.no_grad():
        want_loss = float(loss_fn(cpu_model, cfg,
                                  {k: v.cpu() for k, v in one.items()})[0])
        got_loss = float(loss_fn(model, cfg, one)[0])
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    lerr = abs(got_loss - want_loss)
    print(f"{tag} card vs CPU, 1 x {SCORE_SEQ} tokens: logits max abs err "
          f"{err:.3e} (scale {scale:.3e}, limit 1e-4 x scale); loss "
          f"{got_loss:.6f} vs {want_loss:.6f}, err {lerr:.3e} (limit 1e-4)",
          flush=True)
    if not (err <= 1e-4 * scale and lerr <= 1e-4):
        raise AssertionError("card SKI scoring differs from the CPU's")
    if default:
        _standalone_wrappers_refuse_grad(device)
    return launches


def ski_vs_fd_op(device="cuda") -> None:
    """The paper's SKI-vs-FD comparison at the op level on this card:
    ``ops.ski_fused_tno`` against ``ops.fd_tno`` at x (8, 512, 512),
    forward only (recorded, not claimed)."""
    from repro_torch.core import ski, toeplitz
    from repro_torch.kernels import ops
    g = torch.Generator(device=device).manual_seed(2)
    b, n, d, r, m = 8, 512, 512, 64, 32
    x = torch.randn(b, n, d, device=device, generator=g)
    coef = toeplitz.causal_mask_coeffs(
        torch.randn(d, 2 * r - 1, device=device, generator=g), r)
    a = toeplitz.dense_toeplitz(coef, r).contiguous()
    f = torch.randn(d, m, device=device, generator=g)
    lo, w_lo, _ = ski.make_inducing(n, r, device)
    khat = torch.randn(d, n + 1, device=device, generator=g)
    with torch.inference_mode():
        t_ski = time_ms(lambda: ops.ski_fused_tno(x, a, f, lo, w_lo, r, True))
        t_fd = time_ms(lambda: ops.fd_tno(x, khat))
    print(f"[op] forward at x ({b}, {n}, {d}), r={r}, m={m}: ski_fused_tno "
          f"{t_ski:.5f} ms, fd_tno {t_fd:.5f} ms (ratio fd/ski "
          f"{t_fd / t_ski:.3f})", flush=True)


# ---------------------------------------------------------- ski unfused
#: the unfused SKI op's launches: forward, and forward + backward
UNFUSED_FWD = {**NO_SKI_LAUNCHES, "interp_reduce": 1, "interp_expand": 1,
               "short_conv": 1}
UNFUSED_STEP = {**NO_SKI_LAUNCHES, "interp_reduce": 2, "interp_expand": 2,
                "short_conv": 2, "conv_tap_grad": 1}
_UNFUSED_FUNCTIONS = ("ShortConv", "InterpReduce", "InterpExpand")


def _ski_tno(d, r, m, causal, device, seed=0, lam=0.99):
    """(TNOConfig with fused=False, SKI parameters drawn from ``seed``)."""
    from repro_torch.core import tno
    from repro_torch.nn.layers import reset_parameters
    cfg = tno.TNOConfig(d=d, variant="ski", causal=causal, lam=lam, rank=r,
                        filter_size=m, fused=False)
    params = tno.tno_init(cfg, device=device)
    reset_parameters(params, torch.Generator().manual_seed(seed))
    return cfg, params


def _unfused_plain(params, cfg, x):
    """The unfused SKI op through the kernels' plain versions (autograd
    differentiates it): reduce, short conv, FFT Gram, expand."""
    from repro_torch.core import tno, toeplitz
    from repro_torch.kernels import ref
    plan = tno.tno_plan(params, cfg, x.shape[1])
    lo, w_lo, r = plan["idx_lo"], plan["w_lo"], plan["r"]
    z = ref.interp_reduce_ref(x, lo, w_lo, r)
    z2 = toeplitz.toeplitz_matvec(plan["a_coef"][None], z.transpose(1, 2))
    return (ref.short_conv_ref(x, params.filt, cfg.causal)
            + ref.interp_expand_ref(z2.transpose(1, 2), lo, w_lo))


def _ski_grads(params, cfg, x, cot, fn=None):
    """(y, dx, dfilt, dvals) of Σ y·cot, y = ``fn`` (default: the op through
    ``tno_plan``/``tno_apply``, as a TNN block calls it)."""
    from repro_torch.core import tno
    if fn is None:
        y = tno.tno_apply(params, cfg, x,
                          plan=tno.tno_plan(params, cfg, x.shape[1]))
    else:
        y = fn(params, cfg, x)
    return (y.detach(), *torch.autograd.grad(
        y, (x, params.filt, params.rpe.vals), cot))


def phase_ski_unfused(device="cuda") -> dict:
    """The unfused SKI-TNO (``TNOConfig(variant="ski", fused=False)``)
    forward and backward at x (8, 512, 512) and ski-tnn-lm-wt103's SKI
    width (d=512, r=64, m=32, parameters from seed 0), causal and
    bidirectional: y and the gradients of Σ y·g for x, the taps and the
    RPE values against the fused op within 1e-4 × max (the fused-vs-unfused
    tier of tests/test_ski_fused.py: dense Gram against FFT Gram) and
    against autograd through the plain versions within 1e-5 × max (the
    fp32 tier); y against the same call on the CPU within 1e-5 × max|y|;
    the launches exactly UNFUSED_FWD / UNFUSED_STEP and one kernel backward
    each of ShortConv, InterpReduce and InterpExpand; under
    REPRO_PALLAS_GRAD=0 one reference backward each, no kernel launched
    in the backward and the same gradients. Returns the launches of the
    two forward + backward runs (the path's counts)."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import tno
    from repro_torch.kernels import ops
    arch = get_config("ski-tnn-lm-wt103")
    b, n, d, r, m = 8, 512, arch.d_model, arch.tno_rank, arch.tno_filter
    g = torch.Generator(device=device).manual_seed(4)
    x = torch.randn(b, n, d, device=device, generator=g, requires_grad=True)
    cot = torch.randn(b, n, d, device=device, generator=g)
    names = ("y", "dx", "dfilt", "dvals")
    path = {k: 0 for k in UNFUSED_STEP}
    for causal in (True, False):
        tag = "causal" if causal else "bidirectional"
        cfg, params = _ski_tno(d, r, m, causal, device, lam=arch.tno_lam)
        ops.reset_ski_counters()
        plan = tno.tno_plan(params, cfg, n)
        y = tno.tno_apply(params, cfg, x, plan=plan)
        fwd = ops.ski_counters()
        grads = torch.autograd.grad(y, (x, params.filt, params.rpe.vals), cot)
        step, op_counts = ops.ski_counters(), ops.ski_op_counters()
        got = (y.detach(), *grads)
        for k, v in step.items():
            path[k] += v
        want_ops = {name: {"fwd": 1, "bwd_kernel": 1, "bwd_ref": 0}
                    for name in _UNFUSED_FUNCTIONS}
        want_ops["SKIFusedTNO"] = want_ops["SKIFusedTNOCoef"] = {
            "fwd": 0, "bwd_kernel": 0, "bwd_ref": 0}
        if fwd != UNFUSED_FWD or step != UNFUSED_STEP or op_counts != want_ops:
            raise AssertionError(f"unfused SKI ({tag}) launched {fwd} forward,"
                                 f" {step} in all, Functions {op_counts}")
        print(f"[unfused] {tag} x ({b}, {n}, {d}), r={r}, m={m}: launches "
              f"forward {fwd}, forward + backward {step}; Functions "
              f"{op_counts}", flush=True)
        fused = _ski_grads(params, dataclasses.replace(cfg, fused=True), x,
                           cot)
        report = _grads_close(f"unfused vs fused ({tag})", got, fused, names,
                              tol=1e-4)
        print(f"[unfused] {tag} vs the fused op: {report}", flush=True)
        plain = _ski_grads(params, cfg, x, cot, fn=_unfused_plain)
        report = _grads_close(f"unfused vs plain ({tag})", got, plain, names)
        print(f"[unfused] {tag} vs autograd through the plain versions: "
              f"{report}", flush=True)
        with torch.no_grad():
            cpu_params = copy.deepcopy(params).cpu()
            want = tno.tno_apply(cpu_params, cfg, x.detach().cpu())
        report = _grads_close(f"unfused card vs CPU ({tag})",
                              (y.detach().cpu(),),
                              (want,), ("y",))
        print(f"[unfused] {tag} card vs CPU: {report}", flush=True)
        ops.reset_ski_counters()
        with reference_grad():
            ref_got = _ski_grads(params, cfg, x, cot)
        step, op_counts = ops.ski_counters(), ops.ski_op_counters()
        want_ops = {name: {"fwd": 1, "bwd_kernel": 0, "bwd_ref": 1}
                    for name in _UNFUSED_FUNCTIONS}
        want_ops["SKIFusedTNO"] = want_ops["SKIFusedTNOCoef"] = {
            "fwd": 0, "bwd_kernel": 0, "bwd_ref": 0}
        if step != UNFUSED_FWD or op_counts != want_ops:
            raise AssertionError(f"unfused SKI ({tag}) under "
                                 f"REPRO_PALLAS_GRAD=0 launched {step}, "
                                 f"Functions {op_counts}")
        report = _grads_close(f"unfused REPRO_PALLAS_GRAD=0 ({tag})",
                              ref_got, got, names)
        print(f"[unfused] {tag} under REPRO_PALLAS_GRAD=0 vs the kernel "
              f"backward: {report}; launches {step} (the forward's only)",
              flush=True)
    return path


def ski_unfused_times(device="cuda") -> None:
    """The repo's SKI benchmark shapes (benchmarks/bench_ski_components.py:
    b=4, d=64, r=64, m=32, bidirectional): fused and unfused forward (plan
    built beforehand) and grad of Σy for x, the taps and the RPE values
    (plan built inside) at n = 2048 and 8192; Figure 11's three forwards
    at n = 2048 (both components through the unfused op, low rank only:
    reduce, FFT Gram, expand; sparse only: short_conv). Recorded, not
    claimed."""
    import dataclasses
    from repro_torch.core import ski, tno, toeplitz
    from repro_torch.kernels import ops
    b, d, r, m = 4, 64, 64, 32
    g = torch.Generator(device=device).manual_seed(5)
    cfg_u, params = _ski_tno(d, r, m, False, device)
    cfg_f = dataclasses.replace(cfg_u, fused=True)
    leaves = (params.filt, params.rpe.vals)
    times = {}
    for n in (2048, 8192):
        x = torch.randn(b, n, d, device=device, generator=g)
        xg = x.clone().requires_grad_()
        for name, cfg in (("fused", cfg_f), ("unfused", cfg_u)):
            with torch.inference_mode():
                plan = tno.tno_plan(params, cfg, n)
                times[f"n{n}/{name}_fwd"] = time_ms(
                    lambda: tno.tno_apply(params, cfg, x, plan=plan))

            def grad():
                y = tno.tno_apply(params, cfg, xg,
                                  plan=tno.tno_plan(params, cfg, n))
                return torch.autograd.grad(y.sum(), (xg, *leaves))
            times[f"n{n}/{name}_grad"] = time_ms(grad)
    n = 2048
    x = torch.randn(b, n, d, device=device, generator=g)
    lo, w_lo, h = ski.make_inducing(n, r, device)
    scfg = cfg_u.ski_cfg()

    def low_only():
        z = ops.interp_reduce(x, lo, w_lo, r)
        a_coef = ski.inducing_gram_coeffs(params, scfg, r, h)
        z2 = toeplitz.toeplitz_matvec(a_coef[None], z.transpose(1, 2))
        return ops.interp_expand(z2.transpose(1, 2).contiguous(), lo, w_lo)
    with torch.inference_mode():
        times["fig11/both"] = time_ms(lambda: tno.tno_apply(params, cfg_u, x))
        times["fig11/low_rank_only"] = time_ms(low_only)
        times["fig11/sparse_only"] = time_ms(
            lambda: ops.short_conv(x, params.filt, False))
    print(f"[unfused] times ms (b={b}, d={d}, r={r}, m={m}, bidirectional, "
          f"CUDA-event medians of 50, L2 evicted): {json.dumps(times)}",
          flush=True)


def causal_ski_vs_fd(device="cuda") -> None:
    """Appendix B at benchmarks/bench_appendix_b.py's shape (b=2, d=32,
    m=16, r=64, n=2048): ``causal_ski_lowrank`` against the masked dense
    oracle tril(W A Wᵀ) x in fp64 within 1e-5 × max (a cumulative sum of
    2,048 fp32 rows), timed beside the causal FD-TNO (its RPE included, as
    the benchmark times it). Recorded, not claimed."""
    from repro_torch.core import fd, ski, toeplitz
    from repro_torch.core.causal_ski import causal_ski_lowrank
    from repro_torch.kernels import ref
    from repro_torch.nn.layers import reset_parameters
    b, n, d, r, m = 2, 2048, 32, 64, 16
    scfg = ski.SKIConfig(d, rank=r, filter_size=m)
    sparams = ski.ski_init(scfg, device=device)
    reset_parameters(sparams, torch.Generator().manual_seed(0))
    fcfg = fd.FDConfig(d)
    fparams = fd.fd_init(fcfg, device=device)
    reset_parameters(fparams, torch.Generator().manual_seed(0))
    x = torch.randn(b, n, d, device=device,
                    generator=torch.Generator(device=device).manual_seed(6))
    with torch.inference_mode():
        y = causal_ski_lowrank(sparams, scfg, x)
        lo, w_lo, h = ski.make_inducing(n, r, device)
        w = ref.dense_interp_matrix(lo, w_lo, r).double()
        a = toeplitz.dense_toeplitz(
            ski.inducing_gram_coeffs(sparams, scfg, r, h), r).double()
        t_masked = torch.tril(torch.einsum("nr,drs,ms->dnm", w, a, w))
        want = torch.einsum("dnm,bmd->bnd", t_masked, x.double())
        report = _grads_close("causal_ski_lowrank vs the masked oracle",
                              (y.double(),), (want,), ("y",))
        t_ski = time_ms(lambda: causal_ski_lowrank(sparams, scfg, x))
        t_fd = time_ms(lambda: fd.fd_tno_apply(fparams, fcfg, x))
    print(f"[unfused] Appendix B x ({b}, {n}, {d}), r={r}: "
          f"causal_ski_lowrank vs tril(W A W^T) x: {report}; "
          f"causal_ski_lowrank {t_ski:.5f} ms, causal fd_tno_apply "
          f"{t_fd:.5f} ms (ratio {t_ski / t_fd:.3f})", flush=True)


# ------------------------------------------------------------ ski large-r
LARGE_RANK = 512
LARGE_FFT_STEPS = 10                  # the "fft" route's training steps


def _large_r_cfg():
    """ski-tnn-lm-wt103 at tno_rank 512: at d = 512 its (d, r, r) Gram is
    512 MB, over the dense route's 64 MB, so backend.ski_rank_variant sends
    it to "windowed" (and to "fft" under REPRO_SKI_WINDOWED_RMAX=256)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("ski-tnn-lm-wt103"),
                               tno_rank=LARGE_RANK)


def phase_large_r(device="cuda") -> dict:
    """The full-width ski-tnn-lm-wt103 at tno_rank 512 through the model's
    entry points: scoring 8 × 512 tokens (6 interp_reduce + 6
    ski_windowed_pass2 a forward, card vs CPU on 1 × 512) and 30 training
    steps (18 / 12 / 6 launches and 6 kernel backwards of SKIFusedTNOCoef
    a step); then the same scoring and LARGE_FFT_STEPS steps on the "fft"
    route, ski_expand_pass2 in place of ski_windowed_pass2. Returns the
    four paths' launch counts."""
    from repro_torch.kernels import backend
    cfg = _large_r_cfg()
    r = min(cfg.tno_rank, SCORE_SEQ)
    paths = {}
    if backend.ski_rank_variant(r, cfg.d_model) != "windowed":
        raise AssertionError(f"r={r}, d={cfg.d_model} is not routed windowed")
    paths["large_r_score"] = phase_ski_score(
        device, cfg, "ski_windowed_pass2", "[large-r score]")
    paths["large_r_train"] = phase_train(cfg, device, TRAIN_STEPS, TRAIN_SEQ,
                                         TRAIN_BATCH, mixer="ski_windowed")
    with mock.patch.dict(os.environ, {"REPRO_SKI_WINDOWED_RMAX": "256"}):
        if backend.ski_rank_variant(r, cfg.d_model) != "fft":
            raise AssertionError(f"r={r} is not routed to fft")
        paths["large_r_fft_score"] = phase_ski_score(
            device, cfg, "ski_expand_pass2", "[large-r fft score]")
        paths["large_r_fft_train"] = phase_train(
            cfg, device, LARGE_FFT_STEPS, TRAIN_SEQ, TRAIN_BATCH,
            mixer="ski_fft")
    return paths


def check_coef_backward(device="cuda") -> None:
    """SKIFusedTNOCoef at x (8, 512, 512), r = 512, m = 32, both variants,
    causal and bidirectional taps: (dx, dcoef, df) against autograd through
    ref.ski_fused_tno_coef_ref within 1e-5 × max (the fp32 tier), with 3
    interp_reduce, 2 pass-2 and 1 conv_tap_grad launches and one kernel
    backward; under REPRO_PALLAS_GRAD=0 one reference backward, the
    forward's launches only and the same gradients."""
    from repro_torch.core import ski
    from repro_torch.kernels import ops, ref, ski_vjp
    g = torch.Generator(device=device).manual_seed(8)
    b, n, d, r, m = 8, 512, 512, LARGE_RANK, 32
    names = ("dx", "dcoef", "df")
    lo, w_lo, _ = ski.make_inducing(n, r, device)
    for variant, pass2 in (("windowed", "ski_windowed_pass2"),
                           ("fft", "ski_expand_pass2")):
        for causal in (True, False):
            tag = f"{variant}, {'causal' if causal else 'bidirectional'}"
            x = torch.randn(b, n, d, device=device, generator=g,
                            requires_grad=True)
            coef = (torch.randn(d, 2 * r - 1, device=device, generator=g)
                    / math.sqrt(r)).requires_grad_()
            f = torch.randn(d, m, device=device, generator=g,
                            requires_grad=True)
            cot = torch.randn(b, n, d, device=device, generator=g)

            def grads():
                ops.reset_ski_counters()
                out = torch.autograd.grad(ops.ski_fused_tno_coef(
                    x, coef, f, lo, w_lo, r, causal, variant), (x, coef, f),
                    cot)
                return out, dict(ops.ski_counters(), **ski_vjp.coef_counters)
            got, ran = grads()
            want = torch.autograd.grad(ref.ski_fused_tno_coef_ref(
                x, coef, f, lo, w_lo, r, causal), (x, coef, f), cot)
            report = _grads_close(f"SKIFusedTNOCoef backward ({tag})", got,
                                  want, names)
            if ran != {**NO_SKI_LAUNCHES, "interp_reduce": 3, pass2: 2,
                       "conv_tap_grad": 1, "fwd": 1, "bwd_kernel": 1,
                       "bwd_ref": 0}:
                raise AssertionError(f"SKIFusedTNOCoef ({tag}) launched {ran}")
            print(f"[large-r] SKIFusedTNOCoef backward ({tag}) x ({b}, {n}, "
                  f"{d}), r={r}, m={m} vs autograd through "
                  f"ref.ski_fused_tno_coef_ref: {report}; launches {ran}",
                  flush=True)
            with reference_grad():
                ref_got, ran = grads()
            report = _grads_close(f"SKIFusedTNOCoef REPRO_PALLAS_GRAD=0 "
                                  f"({tag})", ref_got, got, names)
            if ran != {**NO_SKI_LAUNCHES, "interp_reduce": 1, pass2: 1,
                       "fwd": 1, "bwd_kernel": 0, "bwd_ref": 1}:
                raise AssertionError(f"SKIFusedTNOCoef under "
                                     f"REPRO_PALLAS_GRAD=0 ({tag}) launched "
                                     f"{ran}")
            print(f"[large-r] SKIFusedTNOCoef under REPRO_PALLAS_GRAD=0 "
                  f"({tag}) vs the kernel backward: {report}; launches {ran}",
                  flush=True)


def _ski_op_times(d, r, n, b, variants, device, seed) -> dict:
    """Forward (plan built inside, under inference mode) and grad of Σy for
    the RPE values and the taps of the bidirectional SKI op on each of
    ``variants``, as benchmarks/bench_ski_components.py:_large_r times
    them: SKIConfig(d, rank r, filter_size 32), x (b, n, d) from ``seed``."""
    from repro_torch.core import ski
    from repro_torch.nn.layers import reset_parameters
    cfg = ski.SKIConfig(d, rank=r, filter_size=32)
    params = ski.ski_init(cfg, device=device)
    reset_parameters(params, torch.Generator().manual_seed(0))
    x = torch.randn(b, n, d, device=device,
                    generator=torch.Generator(device=device).manual_seed(seed))
    times = {}
    for v in variants:
        def fwd():
            return ski.ski_tno_apply(params, cfg, x, plan=ski.ski_plan(
                params, cfg, n, variant=v)).sum()
        with torch.inference_mode():
            times[f"{v}_fwd"] = time_ms(fwd)
        times[f"{v}_grad"] = time_ms(lambda: torch.autograd.grad(
            fwd(), (params.rpe.vals, params.filt)))
    return times


def large_r_times(device="cuda") -> None:
    """Recorded, not claimed: at bench_ski_components.py:_large_r's shapes
    (b=2, d=16, n=8192, m=32, bidirectional) the coefficient op on the
    policy's route (windowed to r = 4096, fft beyond) beside the dense op
    up to the dense route's rank ceiling; then dense and
    windowed at the dense ceiling of d = 512 (r = 181, the last dense
    rank, and 182; b = 8, n = 512), the op and its pass-2 kernels."""
    from repro_torch.core import toeplitz
    from repro_torch.kernels import backend, ski_fused
    times = {}
    for r in (64, 512, 2048, 8192):
        coef = "windowed" if r <= backend.ski_windowed_rank_max() else "fft"
        dense = r <= backend.ski_dense_rank_max()
        times[f"r{r}"] = _ski_op_times(16, r, 8192, 2, (coef,) + (
            ("dense",) if dense else ()), device, seed=9)
        if not dense:
            times[f"r{r}"]["dense"] = (
                f"not run: past the dense route's rank ceiling "
                f"({backend.ski_dense_rank_max()}); its Gram alone would be "
                f"{16 * r * r * 4} bytes")
    g = torch.Generator(device=device).manual_seed(11)
    b, n, d, m = 8, 512, 512, 32
    x = torch.randn(b, n, d, device=device, generator=g)
    f = torch.randn(d, m, device=device, generator=g)
    for r in (181, 182):
        times[f"d512 r{r}"] = _ski_op_times(d, r, n, b, ("dense", "windowed"),
                                            device, seed=10)
        # the two pass-2 kernels alone, the dense one past the policy's
        # ceiling too
        z = torch.randn(b, r, d, device=device, generator=g)
        coef = torch.randn(d, 2 * r - 1, device=device,
                           generator=g) / math.sqrt(r)
        a = toeplitz.dense_toeplitz(coef, r).contiguous()
        times[f"d512 r{r}"]["kernel ski_fused_pass2"] = time_ms(
            lambda: ski_fused.ski_fused_pass2(x, z, a, f, True))
        times[f"d512 r{r}"]["kernel ski_windowed_pass2"] = time_ms(
            lambda: ski_fused.ski_windowed_pass2(x, z, coef, f, True))
    print(f"[large-r] times ms (CUDA-event medians of 50, L2 evicted; "
          f"forward with the plan, grad of sum(y) for the RPE values and "
          f"taps; the pass-2 kernels alone at x (8, 512, 512)): "
          f"{json.dumps(times)}", flush=True)


# -------------------------------------------------------------- phase 9a
#: the bf16 SKI path: kernel launches a layer makes in one scoring forward
#: and in one training step (forward + backward); no fp32 instance of a
#: SKI kernel may launch
SKI_BF16_SCORE = {"interp_reduce_bf16": 1, "ski_fused_pass2_bf16": 1}
SKI_BF16_STEP = {"interp_reduce_bf16": 3, "ski_fused_pass2_bf16": 1,
                 "ski_fused_pass2_at_bf16": 1, "gram_grad_bf16": 1,
                 "conv_tap_grad_bf16": 1}
SKI_FP32_INSTANCES = ("interp_reduce", "interp_expand", "ski_fused_pass2",
                      "ski_windowed_pass2", "ski_expand_pass2", "gram_grad",
                      "conv_tap_grad")
#: training of phase ski_bf16: AdamW steps of 8 x 512, and the batch rows
#: of the card-vs-CPU gradient check
SKI_BF16_STEPS, SKI_BF16_CPU_ROWS = 5, 2


def _ski_bf16_cfg():
    """ski-tnn-lm-wt103 at full width with dtype and param_dtype bf16."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("ski-tnn-lm-wt103"),
                               dtype="bfloat16", param_dtype="bfloat16")


def _ski_bf16_model(cfg, device):
    """The bf16 model from seed 0 (drawn on the CPU generator, so the same
    values on every device), its parameters through ``cast_params``."""
    from repro_torch.models.transformer import init_model
    from repro_torch.nn.layers import cast_params
    return cast_params(init_model(cfg, torch.Generator().manual_seed(0),
                                  device=device), torch.bfloat16)


def _bf16_check(name, label, got, want, tol) -> None:
    """``got`` within ``tol`` × max|want| (no timing)."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if not err <= tol * scale:
        raise AssertionError(f"{name} {label}: max abs err {err} > {tol} x "
                             f"{scale}")


def ski_bf16_kernels(peaks, device="cuda") -> dict:
    """The bf16 instances against their plain versions on the same bf16
    inputs on the card: ``interp_reduce_bf16``, ``ski_fused_pass2_bf16``
    and ``ski_fused_pass2_at_bf16`` within BF16_TOL × max|plain| (fp32
    sums in another order, rounded once to bf16: one ulp apart where the
    two straddle a rounding), ``gram_grad_bf16`` within 1e-6 (products of
    bf16 values are exact in fp32; b-term sums), the last bitwise against
    a second call. At the SKI path's shapes (pass 2 at left 0, its Aᵀ
    orientation at left 31, the backward's mirror; each also at the other
    offset) each is timed beside its plain version and, for the reduce
    and the Gram cotangent, a bf16 ``torch.einsum``; every SKI_SHAPES
    shape is checked, untimed. Returns the path's entries by kernel."""
    from repro_torch.core import ski
    from repro_torch.kernels import interp_matvec, ref, ski_fused, ski_grad
    bf16 = torch.bfloat16
    g = torch.Generator(device=device).manual_seed(9)
    out = {}
    for label, b, n, d, r, m, _ in SKI_SHAPES:
        x = torch.randn(b, n, d, device=device, generator=g).to(bf16)
        z = torch.randn(b, r, d, device=device, generator=g).to(bf16)
        gz = torch.randn(b, r, d, device=device, generator=g).to(bf16)
        a = torch.randn(d, r, r, device=device, generator=g)
        f = torch.randn(d, m, device=device, generator=g).to(bf16)
        f_t = f.flip(-1).contiguous()
        lo, w_lo, _ = ski.make_inducing(n, r, device)
        lefts = {"forward": 0, "backward": m - 1}

        def pass2(left, at, fn=ski_fused.ski_fused_pass2):
            return lambda: fn(x, z, a, f_t if at else f, True, left=left,
                              transpose_a=at)

        def pass2_plain(left, at):
            return pass2(left, at, ref.ski_fused_pass2_ref)
        if label != "path":
            _bf16_check("interp_reduce_bf16", label,
                        interp_matvec.interp_reduce(x, lo, w_lo, r),
                        ref.interp_reduce_ref(x, lo, w_lo, r), BF16_TOL)
            for at in (False, True):
                for left in lefts.values():
                    _bf16_check(
                        "ski_fused_pass2_at_bf16" if at else
                        "ski_fused_pass2_bf16", f"{label} left={left}",
                        pass2(left, at)(), pass2_plain(left, at)(), BF16_TOL)
            _bf16_check("gram_grad_bf16", label,
                        _repeat_equal("gram_grad_bf16", label,
                                      lambda: ski_grad.gram_grad(gz, z)),
                        ref.gram_grad_ref(gz, z), 1e-6)
            continue
        w = ref.dense_interp_matrix(lo, w_lo, r).to(bf16)
        nnz_w = int((w != 0).sum())
        out["interp_reduce_bf16"] = _kernel_entry(
            "interp_reduce_bf16", "src/repro/kernels/interp_matvec.py:65",
            interp_matvec.interp_reduce(x, lo, w_lo, r),
            ref.interp_reduce_ref(x, lo, w_lo, r),
            lambda: interp_matvec.interp_reduce(x, lo, w_lo, r),
            lambda: ref.interp_reduce_ref(x, lo, w_lo, r),
            lambda: torch.einsum("nr,bnd->brd", w, x),
            nbytes=2 * (x.numel() + z.numel()), nops=2 * b * d * nnz_w,
            peaks=peaks, tol=BF16_TOL, source=SKI_SRC)
        print(f"[ski_bf16 kernel] interp_reduce_bf16 x ({b}, {n}, {d}) bf16, "
              f"r={r}: {out['interp_reduce_bf16']}", flush=True)
        # x, z (bf16), A (fp32), the taps (bf16) read once, y (bf16)
        # written once; conv 2·b·n·d·m, Gram 2·b·d·r², expansion 2·2·b·n·d
        nbytes = (2 * (2 * x.numel() + z.numel()) + 4 * a.numel()
                  + 2 * f.numel())
        nops = 2 * b * d * (n * m + r * r + 2 * n)
        for at, name in ((False, "ski_fused_pass2_bf16"),
                         (True, "ski_fused_pass2_at_bf16")):
            left = lefts["backward" if at else "forward"]
            other = lefts["forward" if at else "backward"]
            _bf16_check(name, f"{label} left={other}", pass2(other, at)(),
                        pass2_plain(other, at)(), BF16_TOL)
            out[name] = _kernel_entry(
                name, "src/repro/kernels/ski_fused.py:143", pass2(left, at)(),
                pass2_plain(left, at)(), pass2(left, at),
                pass2_plain(left, at), None, nbytes=nbytes, nops=nops,
                peaks=peaks, tol=BF16_TOL, source=SKI_SRC)
            print(f"[ski_bf16 kernel] {name} x ({b}, {n}, {d}), z ({b}, {r}, "
                  f"{d}) bf16, A ({d}, {r}, {r}) fp32, bf16 taps m={m}, "
                  f"left={left}{', A transposed in place' if at else ''}: "
                  f"{out[name]}", flush=True)
        out["gram_grad_bf16"] = _kernel_entry(
            "gram_grad_bf16", "src/repro/kernels/ski_grad.py:149",
            _repeat_equal("gram_grad_bf16", label,
                          lambda: ski_grad.gram_grad(gz, z)),
            ref.gram_grad_ref(gz, z), lambda: ski_grad.gram_grad(gz, z),
            lambda: ref.gram_grad_ref(gz, z),
            lambda: torch.einsum("bsc,btc->cst", gz, z),
            nbytes=2 * 2 * z.numel() + 4 * d * r * r, nops=2 * b * d * r * r,
            peaks=peaks, tol=1e-6, source=SKI_GRAD_SRC)
        print(f"[ski_bf16 kernel] gram_grad_bf16 gz, z ({b}, {r}, {d}) bf16 "
              f"-> dA fp32, two calls bitwise equal: {out['gram_grad_bf16']}",
              flush=True)
    print(f"[ski_bf16 kernel] the four bf16 instances also held at every "
          f"SKI_SHAPES shape: {', '.join(s[0] for s in SKI_SHAPES[1:])}",
          flush=True)
    return out


def _expect_bf16_launches(what: str, counts: dict, per_layer: dict,
                          n_layers: int) -> None:
    want = {k: per_layer.get(k, 0) * n_layers for k in counts}
    if counts != want:
        raise AssertionError(f"{what} launched {counts}, not {want}")


def phase_ski_bf16(smi: str, peaks, device="cuda") -> tuple:
    """The bf16 SKI path (:func:`ski_bf16_kernels`, then the full-width
    bf16 ski-tnn-lm-wt103 scored, its gradients taken and held to the
    CPU's, and 5 steps trained; see the module docstring, item 9a).
    Returns (the kernel entries, the launch counts by path)."""
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import ski_vjp
    from repro_torch.launch.steps import (loss_and_grads, make_forward,
                                          make_train_step)
    from repro_torch.nn.layers import cast_params
    from repro_torch.optim import adamw
    t_phase = time.perf_counter()
    kernels = ski_bf16_kernels(peaks, device)
    cfg = _ski_bf16_cfg()
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model = _ski_bf16_model(cfg, device)
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    print(f"[ski_bf16] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"r={cfg.tno_rank}, m={cfg.tno_filter}, dtype {cfg.dtype}, "
          f"parameters {dtypes} (cast_params), "
          f"{sum(p.numel() for p in model.parameters())} parameters",
          flush=True)
    launches = {}

    # scoring
    batch = _ski_batch(cfg, SCORE_BATCH, SCORE_SEQ, device)
    logits, launches["ski_bf16_score"], score_tok_s = _zoo_score(
        "[ski_bf16 score]", cfg, model, batch, device)
    _expect_bf16_launches("[ski_bf16 score]", launches["ski_bf16_score"],
                          SKI_BF16_SCORE, cfg.n_layers)
    model32 = cast_params(_ski_bf16_model(cfg, device), torch.float32)
    logits32 = make_forward(cfg32)(model32, batch["tokens"])
    del model32
    score_rel = _rel(logits, logits32)
    print(f"[ski_bf16 score] bf16 logits against the same weights in fp32: "
          f"max abs err {score_rel:.4e} of the fp32 logits' scale "
          f"{float(logits32.abs().max()):.3f} (reported)", flush=True)
    del logits, logits32

    # training: one loss_and_grads at 8 x 512, counted
    torch.cuda.reset_peak_memory_stats(device)
    _reset_kernel_counts()
    ski_vjp.reset_counters()
    loss, _, grads = loss_and_grads(model, cfg, batch)
    _sync(device)
    launches["ski_bf16_train"] = _kernel_counts()
    ops_counts = dict(ski_vjp.counters)
    _expect_bf16_launches("[ski_bf16 train] loss_and_grads",
                          launches["ski_bf16_train"], SKI_BF16_STEP,
                          cfg.n_layers)
    want_ops = {"fwd": cfg.n_layers, "bwd_kernel": cfg.n_layers,
                "bwd_ref": 0}
    if ops_counts != want_ops or not all(
            g.dtype == torch.bfloat16 for g in grads.values()):
        raise AssertionError(f"[ski_bf16 train] SKIFusedTNO {ops_counts}, "
                             f"gradient dtypes "
                             f"{sorted({str(g.dtype) for g in grads.values()})}")
    print(f"[ski_bf16 train] loss_and_grads {SCORE_BATCH} x {SCORE_SEQ}: "
          f"loss {float(loss):.6f}; launches {launches['ski_bf16_train']}; "
          f"SKIFusedTNO {ops_counts}; every gradient bf16", flush=True)
    del grads

    # the card's gradients against the CPU's, 2 x 512
    rows = {k: v[:SKI_BF16_CPU_ROWS] for k, v in batch.items()}
    t0 = time.perf_counter()
    _, _, got = loss_and_grads(model, cfg, rows)
    cpu = _ski_bf16_model(cfg, "cpu")
    cpu_rows = {k: v.cpu() for k, v in rows.items()}
    _, _, want = loss_and_grads(cpu, cfg, cpu_rows)
    _, _, want32 = loss_and_grads(cast_params(cpu, torch.float32), cfg32,
                                  cpu_rows)
    del cpu
    worst, report = 0.0, []
    for k in want:
        err = _rel_l2(got[k].cpu(), want[k])
        tol = max(ZOO_BF16_TOL, 2 * _rel_l2(want32[k], want[k]))
        worst = max(worst, err / tol)
        report.append(f"{k} {err:.3e}/{tol:.3e} (max abs "
                      f"{_rel(got[k].cpu(), want[k]):.3e})")
        if not err <= tol:
            raise AssertionError(f"[ski_bf16 train] {k}: card vs CPU "
                                 f"relative L2 {err} > {tol}")
    print(f"[ski_bf16 train] card vs CPU gradients, {SKI_BF16_CPU_ROWS} x "
          f"{SCORE_SEQ} tokens, each leaf's relative L2 distance / limit "
          f"max({ZOO_BF16_TOL}, 2 x the CPU bf16 gradients' own distance "
          f"from the CPU fp32 ones): worst ratio {worst:.3f}; "
          f"{'; '.join(report)}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    del got, want, want32

    # 5 AdamW steps at 8 x 512
    ocfg = adamw.OptConfig(lr=3e-4, warmup_steps=1,
                           total_steps=SKI_BF16_STEPS)
    opt = adamw.init(ocfg, dict(model.named_parameters()))
    step = make_train_step(cfg, ocfg)
    data = DataConfig(vocab=cfg.vocab, seq_len=SCORE_SEQ,
                      global_batch=SCORE_BATCH, seed=0)
    losses, walls = [], []
    torch.cuda.reset_peak_memory_stats(device)
    for i in range(SKI_BF16_STEPS):
        b = {k: torch.from_numpy(np.asarray(v)).long().to(device)
             for k, v in batch_at(data, i).items()}
        t0 = time.perf_counter()
        opt, metrics = step(model, opt, b)
        losses.append(float(metrics["loss"]))     # synchronises
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(device)
    step_ms = statistics.median(walls[1:]) * 1e3
    train_tok_s = SCORE_BATCH * SCORE_SEQ / step_ms * 1e3
    print(f"[ski_bf16 train] {SKI_BF16_STEPS} make_train_step steps of "
          f"{SCORE_BATCH} x {SCORE_SEQ}: losses {[round(v, 6) for v in losses]}"
          f"; median step (after the first) {step_ms:.3f} ms, "
          f"{train_tok_s:.0f} tokens/s; max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.3f} GiB)", flush=True)
    # each step draws a new batch of the synthetic stream, so the losses
    # after the first must fall below it, not below each other
    if not (all(math.isfinite(v) for v in losses)
            and max(losses[1:]) < losses[0]):
        raise AssertionError(f"[ski_bf16 train] losses {losses}")
    print(f"[ski_bf16] rates ({smi}; host clock, recorded, not claimed): "
          f"scoring {score_tok_s:.0f} tokens/s, training {train_tok_s:.0f} "
          f"tokens/s; phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    del model, opt
    return kernels, launches


# ---------------------------------------------------------- phase 9b
#: bf16 SKI on the large-rank routes: launches a layer makes in one
#: scoring forward and in one loss_and_grads, by route (pass 2's bf16
#: instance counts the forward and the backward's orientation alike)
LARGE_BF16_PASS2 = {"windowed": "ski_windowed_pass2_bf16",
                    "fft": "ski_expand_pass2_bf16"}
LARGE_BF16_STEPS = 3                  # AdamW steps of 8 x 512 a route
#: the unfused op's bf16 launches: forward, and forward + backward
UNFUSED_BF16_FWD = {**NO_SKI_LAUNCHES, "interp_reduce_bf16": 1,
                    "interp_expand_bf16": 1, "short_conv": 1}
UNFUSED_BF16_STEP = {**NO_SKI_LAUNCHES, "interp_reduce_bf16": 2,
                     "interp_expand_bf16": 2, "short_conv": 2,
                     "conv_tap_grad_bf16": 1}


def _large_bf16_launches(variant: str, step: bool) -> dict:
    """Launches a layer: 1 + 1 a forward; 3 interp_reduce_bf16, 2 pass 2
    and 1 conv_tap_grad_bf16 a loss_and_grads."""
    pass2 = LARGE_BF16_PASS2[variant]
    if not step:
        return {"interp_reduce_bf16": 1, pass2: 1}
    return {"interp_reduce_bf16": 3, pass2: 2, "conv_tap_grad_bf16": 1}


def _check_orientations(name, label, kernel, plain, m) -> None:
    """``kernel(left, flip)`` against ``plain(left, flip)`` within BF16_TOL
    × max|plain| at both offsets of the forward (causal left 0,
    bidirectional m // 2) and the backward's orientation of each
    (coefficients and taps flipped, left mirrored to m - 1 - left)."""
    for left in (0, m // 2):
        for flip in (False, True):
            at = m - 1 - left if flip else left
            _bf16_check(name, f"{label} left={at}"
                        f"{' flipped' if flip else ''}", kernel(at, flip),
                        plain(at, flip), BF16_TOL)


def ski_bf16_route_kernels(peaks, device="cuda") -> dict:
    """The three bf16 instances of the large-rank and unfused routes
    against their plain versions on the same bf16 inputs on the card,
    within BF16_TOL × max|plain| (fp32 sums in another order, y rounded
    once; the plain windowed version also rounds z₂ = A z to bf16, as
    JAX's does, where the kernel keeps it in fp32): ski_windowed_pass2_bf16
    and ski_expand_pass2_bf16 at the large-rank path (x (8, 512, 512) bf16,
    r = 512, m = 32, fp32 coefficients, bf16 taps) and interp_expand_bf16
    at the unfused path (z (8, 64, 512) -> y (8, 512, 512)), each timed
    beside its plain version and its fp32 instance on the same values
    widened, interp_expand_bf16 also beside a bf16 ``torch.einsum``; then
    every SKI_SHAPES shape, untimed. Pass 2 is held at both offsets and
    in both orientations everywhere. Returns the path's entries."""
    from repro_torch.core import ski
    from repro_torch.kernels import interp_matvec, ref, ski_fused
    bf16 = torch.bfloat16
    g = torch.Generator(device=device).manual_seed(13)
    shapes = (("path", 8, 512, 512, LARGE_RANK, 32, 0),
              *(s for s in SKI_SHAPES if not s[0].startswith("path")))
    out = {}
    for label, b, n, d, r, m, _ in shapes:
        x = torch.randn(b, n, d, device=device, generator=g).to(bf16)
        z = torch.randn(b, r, d, device=device, generator=g).to(bf16)
        coef = torch.randn(d, 2 * r - 1, device=device,
                           generator=g) / math.sqrt(r)
        f = torch.randn(d, m, device=device, generator=g).to(bf16)
        lo, w_lo, _ = ski.make_inducing(n, r, device)

        def windowed(left, flip, xx=x, zz=z, cc=coef, ff=f,
                     fn=ski_fused.ski_windowed_pass2):
            if flip:
                cc, ff = cc.flip(-1).contiguous(), ff.flip(-1).contiguous()
            return fn(xx, zz, cc, ff, True, left=left)

        def windowed_plain(left, flip):
            return windowed(left, flip, fn=lambda xx, zz, cc, ff, causal,
                            left: ref.ski_expand_pass2_ref(
                                xx, ref.toeplitz_gram_matvec_ref(cc, zz),
                                ff, causal, left=left))

        def expand(left, flip, xx=x, zz=z, ff=f,
                   fn=ski_fused.ski_expand_pass2):
            return fn(xx, zz, ff.flip(-1).contiguous() if flip else ff,
                      True, left=left)

        def expand_plain(left, flip):
            return expand(left, flip, fn=ref.ski_expand_pass2_ref)
        _check_orientations("ski_windowed_pass2_bf16", label, windowed,
                            windowed_plain, m)
        _check_orientations("ski_expand_pass2_bf16", label, expand,
                            expand_plain, m)
        _bf16_check("interp_expand_bf16", label,
                    interp_matvec.interp_expand(z, lo, w_lo),
                    ref.interp_expand_ref(z, lo, w_lo), BF16_TOL)
        if label != "path":
            continue
        # timed on taps widened beforehand (the wrapper widens bf16 taps
        # with a launch of its own, which would sit between the events),
        # the backward's flipped coefficients and taps made beforehand;
        # the fp32 instances on the same values, widened
        x32, z32, f32 = x.float(), z.float(), f.float()
        coef_t, f32_t = coef.flip(-1).contiguous(), f32.flip(-1).contiguous()
        # x, z (bf16), the coefficients (fp32) and the taps (bf16) read
        # once, y (bf16) written once; the Gram as two TF32 products on
        # the tensor cores (a bf16 z has no lo half), the conv and the
        # expansion on the CUDA cores beside them
        nbytes, gram, rest = _windowed_cost(b, n, d, r, m)
        nbytes = (2 * (2 * x.numel() + z.numel()) + 4 * coef.numel()
                  + 2 * f.numel())
        e = _kernel_entry(
            "ski_windowed_pass2_bf16", WINDOWED_REPLACES, windowed(0, False),
            windowed_plain(0, False),
            lambda: windowed(0, False, ff=f32),
            lambda: windowed_plain(0, False), None, nbytes=nbytes,
            nops=((2 * gram, peaks[2], "tensor cores"),
                  (rest, peaks[1], "cuda cores")),
            peaks=peaks, tol=BF16_TOL, source=SKI_SRC)
        e["fp32_ms"] = time_ms(lambda: ski_fused.ski_windowed_pass2(
            x32, z32, coef, f32, True, left=0))
        e["ms_backward"] = time_ms(lambda: ski_fused.ski_windowed_pass2(
            x, z, coef_t, f32_t, True, left=m - 1))
        e["fp32_ms_backward"] = time_ms(lambda: ski_fused.ski_windowed_pass2(
            x32, z32, coef_t, f32_t, True, left=m - 1))
        e["ms_taps_widened"] = time_ms(lambda: windowed(0, False))
        out["ski_windowed_pass2_bf16"] = e
        print(f"[ski_bf16_routes kernel] ski_windowed_pass2_bf16 x ({b}, {n}, "
              f"{d}), z ({b}, {r}, {d}) bf16, coefficients ({d}, {2 * r - 1})"
              f" fp32, bf16 taps m={m}, left=0 (ms_backward: flipped, left="
              f"{m - 1}; fp32_ms: the fp32 instance on the same values; "
              f"these timed on the taps widened beforehand, ms_taps_widened "
              f"with the wrapper widening them): {e}", flush=True)
        # x, z2 (bf16), the taps (bf16) read once, y (bf16) written once
        e = _kernel_entry(
            "ski_expand_pass2_bf16", WINDOWED_REPLACES, expand(0, False),
            expand_plain(0, False), lambda: expand(0, False, ff=f32),
            lambda: expand_plain(0, False), None,
            nbytes=2 * (2 * x.numel() + z.numel() + f.numel()), nops=rest,
            peaks=peaks, tol=BF16_TOL, source=SKI_SRC)
        e["fp32_ms"] = time_ms(lambda: ski_fused.ski_expand_pass2(
            x32, z32, f32, True, left=0))
        e["ms_taps_widened"] = time_ms(lambda: expand(0, False))
        out["ski_expand_pass2_bf16"] = e
        print(f"[ski_bf16_routes kernel] ski_expand_pass2_bf16 x ({b}, {n}, "
              f"{d}), z2 ({b}, {r}, {d}) bf16, bf16 taps m={m}, left=0 (ms "
              f"and fp32_ms: the taps widened beforehand, fp32_ms the fp32 "
              f"instance on the same values; ms_taps_widened: the wrapper "
              f"widening them): {e}", flush=True)
        # interp_expand at the unfused path: z (8, 64, 512) -> (8, 512, 512)
        ru = 64
        zu = torch.randn(b, ru, d, device=device, generator=g).to(bf16)
        lou, wu, _ = ski.make_inducing(n, ru, device)
        w = ref.dense_interp_matrix(lou, wu, ru)
        wb = w.to(bf16)
        e = _kernel_entry(
            "interp_expand_bf16", "src/repro/kernels/interp_matvec.py:154",
            interp_matvec.interp_expand(zu, lou, wu),
            ref.interp_expand_ref(zu, lou, wu),
            lambda: interp_matvec.interp_expand(zu, lou, wu),
            lambda: ref.interp_expand_ref(zu, lou, wu),
            lambda: torch.einsum("nr,brd->bnd", wb, zu),
            nbytes=2 * (zu.numel() + b * n * d),
            nops=2 * b * d * int((w != 0).sum()), peaks=peaks, tol=BF16_TOL,
            source=SKI_SRC)
        zu32 = zu.float()
        e["fp32_ms"] = time_ms(lambda: interp_matvec.interp_expand(
            zu32, lou, wu))
        out["interp_expand_bf16"] = e
        print(f"[ski_bf16_routes kernel] interp_expand_bf16 z ({b}, {ru}, "
              f"{d}) bf16 -> y ({b}, {n}, {d}) (library: bf16 einsum with "
              f"the bf16 hat matrix; fp32_ms: the fp32 instance): {e}",
              flush=True)
    # interp_expand_bf16's three lane widths: 8 channels (d % 8 == 0, z
    # and y 16-byte aligned: the shapes above with d = 512 or 40), 4
    # (d = 12; and the path's z 8 bytes past alignment) and 1 (odd d
    # above; and the path's z 2 bytes past it)
    cases = [("d=12", torch.randn(2, 20, 12, device=device,
                                  generator=g).to(bf16), 77)]
    flat = torch.randn(8 * 64 * 512 + 4, device=device, generator=g).to(bf16)
    for skip in (4, 1):
        cases.append((f"path z {2 * skip} bytes past 16-byte alignment",
                      flat[skip:skip + 8 * 64 * 512].view(8, 64, 512), 512))
    for label, zz, n in cases:
        lo, w_lo, _ = ski.make_inducing(n, zz.shape[1], device)
        _bf16_check("interp_expand_bf16", label,
                    interp_matvec.interp_expand(zz, lo, w_lo),
                    ref.interp_expand_ref(zz, lo, w_lo), BF16_TOL)
    print(f"[ski_bf16_routes kernel] the three bf16 instances also held at "
          f"{', '.join(s[0] for s in shapes[1:])}, pass 2 at both offsets "
          f"and both orientations; interp_expand_bf16 also at "
          f"{', '.join(c[0] for c in cases)}", flush=True)
    return out


def check_coef_backward_bf16(device="cuda") -> None:
    """SKIFusedTNOCoef on a bf16 x at x (8, 512, 512), r = 512, m = 32
    (fp32 coefficients, bf16 taps, as the bf16 model hands them), both
    variants, causal and bidirectional: (dx, dcoef, df) against autograd
    through ref.ski_fused_tno_coef_ref in bf16 on the card within 2e-2 ×
    max|reference| (JAX's TOL[bf16]), in the primal dtypes, with 3
    interp_reduce_bf16, 2 pass-2 bf16 and 1 conv_tap_grad_bf16 launches,
    one kernel backward and no fp32 instance."""
    from repro_torch.core import ski
    from repro_torch.kernels import ops, ref, ski_vjp
    g = torch.Generator(device=device).manual_seed(14)
    b, n, d, r, m = 8, 512, 512, LARGE_RANK, 32
    lo, w_lo, _ = ski.make_inducing(n, r, device)
    for variant, pass2 in LARGE_BF16_PASS2.items():
        for causal in (True, False):
            tag = f"{variant}, {'causal' if causal else 'bidirectional'}"
            x = torch.randn(b, n, d, device=device, generator=g).to(
                torch.bfloat16).requires_grad_()
            coef = (torch.randn(d, 2 * r - 1, device=device, generator=g)
                    / math.sqrt(r)).requires_grad_()
            f = torch.randn(d, m, device=device, generator=g).to(
                torch.bfloat16).requires_grad_()
            cot = torch.randn(b, n, d, device=device, generator=g).to(
                torch.bfloat16)
            ops.reset_ski_counters()
            got = torch.autograd.grad(ops.ski_fused_tno_coef(
                x, coef, f, lo, w_lo, r, causal, variant), (x, coef, f), cot)
            ran = dict(ops.ski_counters(), **ski_vjp.coef_counters)
            want = torch.autograd.grad(ref.ski_fused_tno_coef_ref(
                x, coef, f, lo, w_lo, r, causal), (x, coef, f), cot)
            report = []
            for name, p, q in zip(("dx", "dcoef", "df"), got, want):
                if p.dtype != q.dtype:
                    raise AssertionError(f"SKIFusedTNOCoef bf16 ({tag}) {name}"
                                         f" {p.dtype}, not {q.dtype}")
                err = float((p.float() - q.float()).abs().max())
                scale = float(q.float().abs().max())
                report.append(f"{name} {p.dtype} max abs err {err:.3e} "
                              f"(scale {scale:.3e}, limit {2e-2 * scale:.3e})")
                if not err <= 2e-2 * scale:
                    raise AssertionError(f"SKIFusedTNOCoef bf16 ({tag}) "
                                         f"{name}: {err} > 2e-2 x {scale}")
            if ran != {**NO_SKI_LAUNCHES, "interp_reduce_bf16": 3, pass2: 2,
                       "conv_tap_grad_bf16": 1, "fwd": 1, "bwd_kernel": 1,
                       "bwd_ref": 0}:
                raise AssertionError(f"SKIFusedTNOCoef bf16 ({tag}) launched "
                                     f"{ran}")
            print(f"[ski_bf16_routes] SKIFusedTNOCoef backward ({tag}) x ({b},"
                  f" {n}, {d}) bf16, r={r}, m={m} vs autograd through "
                  f"ref.ski_fused_tno_coef_ref in bf16: {'; '.join(report)}; "
                  f"launches {ran}", flush=True)


def _large_bf16_route(variant: str, cfg, model, batch, device) -> dict:
    """One route of the bf16 large-rank model: score the batch (counted),
    one counted loss_and_grads, LARGE_BF16_STEPS AdamW steps. Returns
    {"score", "train": launch counts, "logits_one": the card's logits of
    the first row, "score_tok_s", "train_tok_s", "losses"}."""
    from repro_torch.kernels import ski_vjp
    from repro_torch.launch.steps import (loss_and_grads, make_forward,
                                          make_train_step)
    from repro_torch.optim import adamw
    tag = f"[ski_bf16_routes {variant}]"
    logits, score, score_tok_s = _zoo_score(f"{tag} score", cfg, model,
                                            batch, device)
    _expect_bf16_launches(f"{tag} score", score,
                          _large_bf16_launches(variant, False), cfg.n_layers)
    del logits
    logits_one = make_forward(cfg)(model, batch["tokens"][:1]).float().cpu()
    _reset_kernel_counts()
    ski_vjp.reset_counters()
    loss, _, grads = loss_and_grads(model, cfg, batch)
    _sync(device)
    train = _kernel_counts()
    ops_counts = dict(ski_vjp.coef_counters)
    _expect_bf16_launches(f"{tag} loss_and_grads", train,
                          _large_bf16_launches(variant, True), cfg.n_layers)
    want_ops = {"fwd": cfg.n_layers, "bwd_kernel": cfg.n_layers,
                "bwd_ref": 0}
    dtypes = sorted({str(v.dtype) for v in grads.values()})
    if (ops_counts != want_ops or dtypes != ["torch.bfloat16"]
            or not math.isfinite(float(loss))):
        raise AssertionError(f"{tag} SKIFusedTNOCoef {ops_counts}, gradient "
                             f"dtypes {dtypes}, loss {float(loss)}")
    print(f"{tag} loss_and_grads {SCORE_BATCH} x {SCORE_SEQ}: loss "
          f"{float(loss):.6f}; launches {train}; SKIFusedTNOCoef "
          f"{ops_counts}; every gradient bf16", flush=True)
    del grads
    ocfg = adamw.OptConfig(lr=3e-4, warmup_steps=1,
                           total_steps=LARGE_BF16_STEPS)
    opt = adamw.init(ocfg, dict(model.named_parameters()))
    step = make_train_step(cfg, ocfg)
    losses, walls = [], []
    for i in range(LARGE_BF16_STEPS):
        t0 = time.perf_counter()
        opt, metrics = step(model, opt, batch)
        losses.append(float(metrics["loss"]))     # synchronises
        walls.append(time.perf_counter() - t0)
    train_tok_s = batch["tokens"].numel() / statistics.median(walls[1:])
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag} losses {losses}")
    print(f"{tag} {LARGE_BF16_STEPS} make_train_step steps of {SCORE_BATCH} x"
          f" {SCORE_SEQ} (the same batch): losses "
          f"{[round(v, 6) for v in losses]}; step walls ms "
          f"{[round(t * 1e3, 3) for t in walls]}, {train_tok_s:.0f} tokens/s "
          f"(median after the first)", flush=True)
    del opt
    return {"score": score, "train": train, "logits_one": logits_one,
            "score_tok_s": score_tok_s, "train_tok_s": train_tok_s,
            "losses": losses}


def check_unfused_bf16(device="cuda") -> dict:
    """The unfused SKI layer (``TNOConfig(variant="ski", fused=False)``) in
    bf16 at ski-tnn-lm-wt103's SKI width (x (8, 512, 512), r = 64, m =
    32, parameters from seed 0 through ``cast_params``), causal: y within
    BF16_TOL × max and the gradients of Σ y·g for x, the taps and the RPE
    values within 2e-2 × max of autograd through the plain versions in
    bf16 on the card, every one bf16, with UNFUSED_BF16_FWD /
    UNFUSED_BF16_STEP launches (interp_expand_bf16 once each way) and
    one kernel backward each of ShortConv, InterpReduce and InterpExpand.
    Returns the forward + backward's launches (the path's counts)."""
    from repro_torch.configs import get_config
    from repro_torch.core import tno
    from repro_torch.kernels import ops
    from repro_torch.nn.layers import cast_params
    arch = get_config("ski-tnn-lm-wt103")
    b, n, d, r, m = 8, 512, arch.d_model, arch.tno_rank, arch.tno_filter
    g = torch.Generator(device=device).manual_seed(15)
    x = torch.randn(b, n, d, device=device, generator=g).to(
        torch.bfloat16).requires_grad_()
    cot = torch.randn(b, n, d, device=device, generator=g).to(torch.bfloat16)
    cfg, params = _ski_tno(d, r, m, True, device, lam=arch.tno_lam)
    params = cast_params(params, torch.bfloat16)
    leaves = (x, params.filt, params.rpe.vals)
    ops.reset_ski_counters()
    y = tno.tno_apply(params, cfg, x, plan=tno.tno_plan(params, cfg, n))
    fwd = ops.ski_counters()
    grads = torch.autograd.grad(y, leaves, cot)
    step, op_counts = ops.ski_counters(), ops.ski_op_counters()
    want_ops = {name: {"fwd": 1, "bwd_kernel": 1, "bwd_ref": 0}
                for name in _UNFUSED_FUNCTIONS}
    want_ops["SKIFusedTNO"] = want_ops["SKIFusedTNOCoef"] = {
        "fwd": 0, "bwd_kernel": 0, "bwd_ref": 0}
    if (fwd != UNFUSED_BF16_FWD or step != UNFUSED_BF16_STEP
            or op_counts != want_ops):
        raise AssertionError(f"unfused bf16 SKI launched {fwd} forward, "
                             f"{step} in all, Functions {op_counts}")
    plain = _ski_grads(params, cfg, x, cot, fn=_unfused_plain)
    report = []
    for name, p, q, tol in zip(("y", "dx", "dfilt", "dvals"),
                               (y.detach(), *grads), plain,
                               (BF16_TOL, 2e-2, 2e-2, 2e-2)):
        if p.dtype != torch.bfloat16:
            raise AssertionError(f"unfused bf16 {name} is {p.dtype}")
        err = float((p.float() - q.float()).abs().max())
        scale = float(q.float().abs().max())
        report.append(f"{name} max abs err {err:.3e} (scale {scale:.3e}, "
                      f"limit {tol * scale:.3e})")
        if not err <= tol * scale:
            raise AssertionError(f"unfused bf16 {name}: {err} > {tol} x "
                                 f"{scale}")
    print(f"[ski_bf16_routes unfused] causal x ({b}, {n}, {d}) bf16, r={r}, "
          f"m={m}, bf16 leaves: vs autograd through the plain versions in "
          f"bf16: {'; '.join(report)}; launches forward {fwd}, forward + "
          f"backward {step}; Functions {op_counts}", flush=True)
    return step


def phase_ski_bf16_routes(smi: str, peaks, device="cuda") -> tuple:
    """bf16 SKI on the routes past the dense one (module docstring, item
    9b): :func:`ski_bf16_route_kernels`; SKIFusedTNOCoef's bf16 cotangents
    (:func:`check_coef_backward_bf16`); the full-width bf16
    ski-tnn-lm-wt103 at tno_rank 512 scored (8 × 512) and trained (one
    counted loss_and_grads, LARGE_BF16_STEPS steps) on the "windowed"
    route and, under REPRO_SKI_WINDOWED_RMAX=256, the "fft" route, its
    first row's logits held to the CPU's under the zoo's bf16 rule; the
    unfused layer in bf16 (:func:`check_unfused_bf16`). Returns (the
    kernel entries, the launch counts by path)."""
    from repro_torch.kernels import backend
    from repro_torch.launch.steps import make_forward
    from repro_torch.nn.layers import cast_params
    t_phase = time.perf_counter()
    kernels = ski_bf16_route_kernels(peaks, device)
    check_coef_backward_bf16(device)
    cfg = dataclasses.replace(_ski_bf16_cfg(), tno_rank=LARGE_RANK)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    r = min(cfg.tno_rank, SCORE_SEQ)
    batch = _ski_batch(cfg, SCORE_BATCH, SCORE_SEQ, device)
    launches, runs = {}, {}
    for variant, env in (("windowed", {}), ("fft", {
            "REPRO_SKI_WINDOWED_RMAX": str(LARGE_RANK // 2)})):
        with mock.patch.dict(os.environ, env):
            if backend.ski_rank_variant(r, cfg.d_model) != variant:
                raise AssertionError(f"r={r}, d={cfg.d_model} is not routed "
                                     f"{variant}")
            model = _ski_bf16_model(cfg, device)
            runs[variant] = _large_bf16_route(variant, cfg, model, batch,
                                              device)
            del model
        suffix = "" if variant == "windowed" else "_fft"
        launches[f"ski_bf16_large_r{suffix}_score"] = runs[variant]["score"]
        launches[f"ski_bf16_large_r{suffix}_train"] = runs[variant]["train"]
    # card vs CPU on the first row: the CPU's plain versions compute the
    # same bits on both routes (one rfft Gram), so one CPU forward in bf16
    # and one in fp32 (the noise floor) serve both
    t0 = time.perf_counter()
    cpu = _ski_bf16_model(cfg, "cpu")
    one = batch["tokens"][:1].cpu()
    want = make_forward(cfg)(cpu, one).float()
    want32 = make_forward(cfg32)(cast_params(cpu, torch.float32), one)
    del cpu
    limit = max(ZOO_BF16_TOL, 2 * _rel(want32, want))
    for variant, run in runs.items():
        err = _rel(run["logits_one"], want)
        print(f"[ski_bf16_routes {variant}] card vs CPU logits, 1 x "
              f"{SCORE_SEQ} tokens: max abs err {err:.4e} of the CPU bf16 "
              f"logits' scale (limit {limit:.4e}: max({ZOO_BF16_TOL}, 2 x "
              f"the CPU bf16 logits' own distance from the CPU fp32 ones)); "
              f"{time.perf_counter() - t0:.1f} s of CPU", flush=True)
        if not err <= limit:
            raise AssertionError(f"[ski_bf16_routes {variant}] card vs CPU "
                                 f"logits {err} > {limit}")
    launches["ski_bf16_unfused"] = check_unfused_bf16(device)
    rates = "; ".join(
        f"{v}: scoring {run['score_tok_s']:.0f}, training "
        f"{run['train_tok_s']:.0f} tokens/s" for v, run in runs.items())
    print(f"[ski_bf16_routes] rates ({smi}; host clock, recorded, not "
          f"claimed) bf16 {rates} (the same model in fp32: this run's "
          f"[large-r score], [large-r train] and their fft lines); phase "
          f"took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return kernels, launches


# -------------------------------------------------------------- phase 9c
MESH_STEPS = 3
MESH_TOL = 1e-6


def _mesh_train(step, model, opt, put, data, device):
    """MESH_STEPS steps; (opt, losses, train_step ms, kernel launches,
    the mixer Functions' counts)."""
    from repro_torch.data.pipeline import batch_at
    from repro_torch.kernels import fd_fused, ski_vjp
    _reset_kernel_counts()
    losses, ms = [], []
    for i in range(MESH_STEPS):
        batch = put(batch_at(data, i))
        _sync(device)
        t0 = time.perf_counter()
        opt, m = step(model, opt, batch)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    ops = {k: fd_fused.op_counters[k] + ski_vjp.counters[k]
           for k in ("fwd", "bwd_kernel", "bwd_ref")}
    return opt, losses, ms, _kernel_counts(), ops


def _state_diff(model, opt, ref, ropt) -> tuple:
    """(worst |mesh - mesh-free| / max|mesh-free| over every parameter and
    moment, its leaf)."""
    want = {f"param {k}": p.detach() for k, p in ref.named_parameters()}
    want.update({f"mu {k}": v for k, v in ropt.mu.items()})
    want.update({f"nu {k}": v for k, v in ropt.nu.items()})
    got = {f"param {k}": p.detach() for k, p in model.named_parameters()}
    got.update({f"mu {k}": v for k, v in opt.mu.items()})
    got.update({f"nu {k}": v for k, v in opt.nu.items()})
    worst = (0.0, "")
    for k, w in want.items():
        g = got[k].full_tensor()
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        worst = max(worst, (err, k))
    return worst


def phase_mesh(smi: str, device="cuda") -> dict:
    """The distribution layer on the card (module docstring, item 9c).
    Returns the launch counts of the mesh runs by path."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.steps import StepBuilder
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import _device_batch, put_batch
    t_phase = time.perf_counter()
    store = Path(tempfile.mkdtemp(prefix="chip_smoke_pg_")) / "store"
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=0,
                            world_size=1)
    launches, backend = {}, dist.get_backend()
    try:
        mesh = mesh_mod.make_host_mesh(device)
        for arch, mixer in (("ski-tnn-lm-wt103", "ski"),
                            ("fd-tnn-lm-wt103", "fd")):
            cfg = get_config(arch)
            ocfg = adamw.OptConfig(lr=3e-4, warmup_steps=1,
                                   total_steps=MESH_STEPS)
            data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH, seed=0)
            sb = StepBuilder(cfg, mesh, opt_cfg=ocfg)
            model, opt = sb.init_state(torch.Generator().manual_seed(0),
                                       device=device)
            free = StepBuilder(cfg, None, opt_cfg=ocfg)
            ref, ropt = free.init_state(torch.Generator().manual_seed(0),
                                        device=device)
            ropt, rlosses, rms, rcounts, rops = _mesh_train(
                free.make_train_step(), ref, ropt, _device_batch(device),
                data, device)
            opt, losses, ms, counts, ops = _mesh_train(
                sb.make_train_step(), model, opt, put_batch(mesh), data,
                device)
            err, leaf = _state_diff(model, opt, ref, ropt)
            loss_err = max(abs(a - b) / abs(b)
                           for a, b in zip(losses, rlosses))
            tag = f"[mesh {mixer}]"
            print(f"{tag} {arch} on make_host_mesh() ({backend}, one rank, "
                  f"{smi}): {MESH_STEPS} StepBuilder steps of {TRAIN_BATCH}"
                  f" x {TRAIN_SEQ} beside the mesh-free make_train_step: "
                  f"losses {losses} vs {rlosses} (max rel diff "
                  f"{loss_err:.3e}); worst parameter or moment |mesh - "
                  f"mesh-free| / max {err:.3e} ({leaf or 'none'}; limit "
                  f"{MESH_TOL})", flush=True)
            if err or loss_err:
                print(f"{tag} not bitwise: the sharded step runs the same "
                      "ops on the same local tensors, so a difference "
                      "comes from a kernel or library call that is not "
                      "deterministic run to run on the card (cuBLAS "
                      "split-k, atomics), not from the mesh", flush=True)
            print(f"{tag} median train_step ms: mesh {statistics.median(ms):.3f}"
                  f", mesh-free {statistics.median(rms):.3f} (all: "
                  f"{[round(t, 3) for t in ms]} vs "
                  f"{[round(t, 3) for t in rms]}; host clock after a "
                  "synchronise, the first step included)", flush=True)
            print(f"{tag} kernel launches "
                  f"{ {k: v for k, v in counts.items() if v} }; Functions "
                  f"{ops}; mesh-free "
                  f"{ {k: v for k, v in rcounts.items() if v} }, {rops}",
                  flush=True)
            if not (err <= MESH_TOL and loss_err <= MESH_TOL):
                raise AssertionError(f"{tag} mesh vs mesh-free: {err} "
                                     f"({leaf}), losses {loss_err}")
            if counts != rcounts or ops != rops or ops["bwd_ref"] != 0:
                raise AssertionError(f"{tag} launches {counts}, {ops} vs "
                                     f"mesh-free {rcounts}, {rops}")
            want = {k: TRAIN_LAUNCHES[mixer].get(k, 0) * cfg.n_layers
                    * MESH_STEPS for k in counts}
            want_ops = {"fwd": cfg.n_layers * MESH_STEPS,
                        "bwd_kernel": cfg.n_layers * MESH_STEPS,
                        "bwd_ref": 0}
            if counts != want or ops != want_ops:
                raise AssertionError(f"{tag} launches {counts}, {ops}; "
                                     f"want {want}, {want_ops}")
            launches[f"mesh_{mixer}"] = counts
            del model, opt, ref, ropt
    finally:
        dist.destroy_process_group()
    print(f"[mesh] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# --------------------------------------------------------------- phase 7
def check_train_card_vs_cpu(small, device) -> None:
    """Same init and batches on the card and on the CPU: step-0 gradients
    within 1e-4 × max|g| per leaf and three training losses within 1e-4
    relative (the fp32 matmul sums run in another order in cuBLAS)."""
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch.steps import loss_and_grads
    dcfg = DataConfig(vocab=small.vocab, seq_len=64, global_batch=2, seed=1)
    runs = {}
    for dev in ("cpu", device):
        model, opt, step_fn = _train_setup(small, dev, 3, 3, warmup=1)
        batches = [{k: torch.from_numpy(v).to(dev, torch.long)
                    for k, v in batch_at(dcfg, i).items()} for i in range(3)]
        _, _, grads = loss_and_grads(model, small, batches[0])
        losses = []
        for bt in batches:
            opt, m = step_fn(model, opt, bt)
            losses.append(float(m["loss"]))
        runs[dev] = ({k: v.cpu() for k, v in grads.items()}, losses)
    (g_cpu, l_cpu), (g_dev, l_dev) = runs["cpu"], runs[device]
    worst = max(float((g_dev[k] - g_cpu[k]).abs().max())
                / float(g_cpu[k].abs().max()) for k in g_cpu)
    lerr = max(abs(a - b) / abs(b) for a, b in zip(l_dev, l_cpu))
    print(f"[check] smoke {small.name} training card vs CPU: step-0 grads "
          f"worst leaf "
          f"{worst:.3e} x max|g| (limit 1e-4), losses {l_dev} vs {l_cpu}, "
          f"max rel err {lerr:.3e} (limit 1e-4)", flush=True)
    if not (worst <= 1e-4 and lerr <= 1e-4):
        raise AssertionError("card training differs from the CPU's")


def check_checkpoint_resume(small, device) -> None:
    """A run checkpointed at step 2 and restored into a fresh model and
    optimizer ends, after one more step, bitwise where an uninterrupted
    three-step run ends."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    dcfg = DataConfig(vocab=small.vocab, seq_len=64, global_batch=2, seed=2)

    def run(total, ckpt_dir, seed):
        model, opt, step_fn = _train_setup(small, device, seed, 3, warmup=1)
        tr = Trainer(TrainerConfig(total_steps=total, ckpt_dir=ckpt_dir,
                                   ckpt_every=2, log_every=0), step_fn, dcfg)
        opt, start = tr.try_restore(model, opt)
        opt, end = tr.run(model, opt, start)
        return model, opt, start, end

    whole, whole_opt, _, _ = run(3, None, seed=4)
    with tempfile.TemporaryDirectory() as d:
        run(2, d, seed=4)
        resumed, res_opt, start, end = run(3, d, seed=5)   # other init
    same = all(torch.equal(a, b) for a, b in
               zip(whole.parameters(), resumed.parameters()))
    same_opt = all(torch.equal(whole_opt.mu[k], res_opt.mu[k])
                   and torch.equal(whole_opt.nu[k], res_opt.nu[k])
                   for k in whole_opt.mu)
    print(f"[check] {small.name}: checkpoint at step 2, restored into a "
          f"fresh model "
          f"(resumed at {start}, ended at {end}): parameters bitwise equal "
          f"to an uninterrupted run: {same}; moments: {same_opt}", flush=True)
    if not (start == 2 and end == 3 and same and same_opt):
        raise AssertionError("the resumed run differs from the uninterrupted")


def check_decoded(tag: str, cfg, model, prompt_len: int, seqs) -> None:
    """The kernel-path forward over the generated (b, max_len) sequences
    reproduces every decoded token where its top-2 margin exceeds
    MARGIN."""
    from repro_torch.models.transformer import forward
    with torch.inference_mode():
        logits = forward(model, cfg, seqs)                 # (b, max_len, V)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("forward logits not finite")
        lg = logits[:, prompt_len - 1:seqs.shape[1] - 1]
        top2 = torch.topk(lg, 2, dim=-1).values
        checked = (top2[..., 0] - top2[..., 1]) > MARGIN
        pred = torch.clamp(torch.argmax(lg, dim=-1), max=cfg.vocab - 1)
        wrong = (pred != seqs[:, prompt_len:]) & checked
        n_checked, n_wrong = int(checked.sum()), int(wrong.sum())
    print(f"{tag} forward over generated {tuple(seqs.shape)}: "
          f"{n_checked} positions checked, {checked.numel() - n_checked} "
          f"skipped (top-2 margin <= {MARGIN}), {n_wrong} mismatches",
          flush=True)
    if n_wrong:
        raise AssertionError(f"{n_wrong} decoded tokens disagree with the "
                             "kernel-path forward")


def phase_check(cfg, model, prompt_len: int, seqs, device) -> None:
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models.transformer import forward, init_model
    check_decoded("[check]", cfg, model, prompt_len, seqs)
    # the smoke model on the card (kernels) vs on the CPU (plain versions)
    small = reduce_for_smoke(cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, small.vocab, (2, 37)))
    with torch.inference_mode():
        want = forward(init_model(small, torch.Generator().manual_seed(1),
                                  device="cpu"), small, toks)
        got = forward(init_model(small, torch.Generator().manual_seed(1),
                                 device=device), small, toks.to(device))
    err = float((got.cpu() - want).abs().max())
    print(f"[check] smoke model {tuple(want.shape)} card vs CPU: max abs "
          f"err {err:.3e} (limit 1e-4)", flush=True)
    if not err <= 1e-4:
        raise AssertionError(f"card logits differ from CPU by {err}")
    check_train_card_vs_cpu(small, device)
    check_checkpoint_resume(small, device)
    ski_small = reduce_for_smoke(get_config("ski-tnn-lm-wt103"))
    print(f"[check] smoke SKI model: {ski_small.n_layers} layers, "
          f"d={ski_small.d_model}, r={ski_small.tno_rank}, "
          f"m={ski_small.tno_filter}", flush=True)
    check_train_card_vs_cpu(ski_small, device)
    check_checkpoint_resume(ski_small, device)


# ------------------------------------------------------------ mamba phases
#: ssd_scan checks: (label, bt, n, h, p, g, s, chunk), the path shape first
SSD_SHAPES = (("path", 8, 2048, 80, 64, 1, 128, 128),
              ("ragged n=2000", 2, 2000, 80, 64, 1, 128, 128),
              ("n<q n=100", 2, 100, 80, 64, 1, 128, 128),
              ("n=1", 2, 1, 80, 64, 1, 128, 128),
              ("g=2", 2, 128, 4, 16, 2, 16, 32),
              ("g=4 ragged", 1, 96, 4, 8, 4, 8, 32),
              ("smoke", 2, 37, 8, 32, 1, 16, 16),
              # rows of 12 and 24 bytes: the bf16 kernel's element loads
              ("p=6 s=12", 1, 70, 4, 6, 2, 12, 32))


def _ssd_inputs(bt, n, h, p, g, s, dtype, gen, device="cuda"):
    """x, B, C ~ N(0, 1) in ``dtype``; dt = softplus(N(0, 1) - 3) (a decay
    that reaches across chunks), a = -exp(0.1 N(0, 1)), D = 1 + 0.1 N(0, 1),
    fp32."""
    def rnd(*shape):
        return torch.randn(*shape, device=device, generator=gen)
    x = rnd(bt, n, h, p).to(dtype)
    dt = torch.nn.functional.softplus(rnd(bt, n, h) - 3.0)
    a = -torch.exp(0.1 * rnd(h))
    b, c = rnd(bt, n, g, s).to(dtype), rnd(bt, n, g, s).to(dtype)
    return x, dt, a, b, c, 1.0 + 0.1 * rnd(h)


def _ssd_cost(bt, n, h, p, g, s, q, elem):
    """(bytes, chunked flops of the three products with an fp32 operand,
    chunked flops of C Bᵀ, the fewer of chunked and sequential flops) of
    the SSD scan: x, dt, a, B, C, D read once and y written once.
    Chunked: per head and chunk of r rows, r (r + 1) p for the
    lower-triangular scores · X, 2 r s p for C Sᵀ and 2 p r s for the state
    update (TF32 on the tensor cores), plus r (r + 1) s for the lower
    triangle of C Bᵀ once a group (bf16): matrix products, the bound on
    tensor cores. Sequential: 5 p s per position and head (decay, outer
    product and add into S, then C S): rank-1 updates, the fewer on the
    CUDA cores."""
    nbytes = (elem * (2 * bt * n * h * p + 2 * bt * n * g * s)
              + 4 * (bt * n * h + 2 * h))
    rows = [min(q, n - i) for i in range(0, n, q)]
    fp32_operand = sum((r * (r + 1) * p + 4 * r * s * p) * bt * h
                       for r in rows)
    cb = sum(r * (r + 1) * s * bt * g for r in rows)
    return (nbytes, fp32_operand, cb,
            min(fp32_operand + cb, 5 * p * s * n * bt * h))


def check_ssd_scan(peaks, device="cuda", g=None, reps=10,
                   shapes=SSD_SHAPES, tag="[mamba kernel]") -> dict:
    """ssd_scan against ``ssd_chunked.ssd_scan_chunked`` on the same inputs
    at SSD_SHAPES, fp32 within 1e-5 × max|plain| (fp32 sums in another
    order) and bf16 within BF16_TOL × max|plain| (TF32 products, then one
    rounding to bf16 on each side: at most one bf16 ulp, 2^-7 × max, plus
    about 5e-4 × max; ``tests/test_torch_ssd_scan.py``), fp32 also against
    ``ref.ssd_scan_ref`` in float64 (1e-5 × max); both instances timed at
    the path shape (median of ``reps``), the bf16 one against the tensor
    cores' peaks (C Bᵀ in bf16, the other products in TF32) and the fp32
    one against the CUDA cores' fp32 peak. Returns the path shape's
    entries, ``ssd_scan`` (bf16) and ``ssd_scan_f32``. Inputs come from
    ``g`` (a generator seeded 3 when None); ``shapes`` (label, bt, n, h,
    p, g, s, chunk), the one labelled "path" timed; lines begin with
    ``tag``."""
    from repro_torch.kernels import ref, ssd_chunked, ssd_scan
    if g is None:
        g = torch.Generator(device=device).manual_seed(3)
    out = {}
    for label, bt, n, h, p, gr, s, q in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            args = _ssd_inputs(bt, n, h, p, gr, s, dtype, g, device)
            tol = BF16_TOL if dtype == torch.bfloat16 else 1e-5
            got = ssd_scan.ssd_scan(*args, chunk=q)
            want = ssd_chunked.ssd_scan_chunked(*args, chunk=q)
            if got.dtype != dtype or got.shape != (bt, n, h, p):
                raise AssertionError(f"ssd_scan gave {got.dtype} "
                                     f"{tuple(got.shape)}")
            if label == "path" and dtype == torch.bfloat16:
                nbytes, tf32_ops, bf16_ops, _ = _ssd_cost(bt, n, h, p, gr, s,
                                                          q, 2)
                out["ssd_scan"] = _kernel_entry(
                    "ssd_scan", "src/repro/kernels/ssd_scan.py:82", got,
                    want, lambda: ssd_scan.ssd_scan(*args, chunk=q),
                    lambda: ssd_chunked.ssd_scan_chunked(*args, chunk=q),
                    None, nbytes=nbytes,
                    nops=((tf32_ops, peaks[2], "tensor cores"),
                          (bf16_ops, peaks[3], "tensor cores")),
                    peaks=peaks, tol=tol, source=SSD_SRC, reps=reps)
                report = f"{out['ssd_scan']}"
            elif label == "path":
                nbytes, _, _, fewer = _ssd_cost(bt, n, h, p, gr, s, q, 4)
                e = out["ssd_scan_f32"] = _kernel_entry(
                    "ssd_scan_f32", "src/repro/kernels/ssd_scan.py:82", got,
                    want, lambda: ssd_scan.ssd_scan(*args, chunk=q),
                    lambda: ssd_chunked.ssd_scan_chunked(*args, chunk=q),
                    None, nbytes=nbytes, nops=fewer, peaks=peaks, tol=tol,
                    source=SSD_SRC, reps=reps)
                report = (f"fp32 {e['ms']:.4f} ms (plain {e['plain_ms']:.4f}"
                          f"; bound {e['bound_ms']:.4f} by {e['bound_by']} "
                          f"at fp32 on the CUDA cores); max abs err "
                          f"{e['max_abs_err']:.3e} at {e['scale']:.3f}")
            else:
                report = _grads_close(f"ssd_scan {label} {dtype}",
                                      [got.double()], [want.double()],
                                      ["y"], tol)
            if dtype == torch.float32:
                f64 = ref.ssd_scan_ref(*(t.double() for t in args))
                report += "; vs float64 ssd_scan_ref " + _grads_close(
                    f"ssd_scan {label} vs float64", [got.double()], [f64],
                    ["y"], 1e-5)
            print(f"{tag} ssd_scan {label} x ({bt}, {n}, {h}, {p}) "
                  f"{dtype}, g={gr}, s={s}, chunk={q}: {report}", flush=True)
    return out


def phase_mamba_kernels(peaks, device="cuda") -> dict:
    """:func:`check_ssd_scan`; the bf16 short_conv and the bf16
    conv_tap_grad at Mamba's conv shape and at the SKI path's shape with
    its four offsets; SSDScan's gradients at one full-width layer's shape
    (:func:`check_ssd_scan_grad`); the raw ssd_scan wrapper's refusal and
    the bf16 ShortConv backward. Returns the entries at the path shapes
    (bf16, the model's dtype)."""
    from repro_torch.kernels import ssd_scan
    g = torch.Generator(device=device).manual_seed(3)
    out = {"ssd_scan": check_ssd_scan(peaks, device, g)["ssd_scan"]}
    ssd_scan.reset_counters()
    out["short_conv_bf16"] = check_short_conv_bf16(peaks, g, device)["mamba"]
    out["conv_tap_grad_bf16"] = check_conv_tap_grad_bf16(peaks, g,
                                                         device)["mamba"]
    check_ssd_scan_grad(g, device)
    _mamba_kernels_refuse(device)
    return out


def short_conv_bf16_inputs(g, device="cuda") -> list:
    """The bf16 short conv's inputs, (label, x, f, left): Mamba's conv (x
    (8, 2048, 5376), m = 4), then the SKI path's shape at its four
    offsets."""
    x = torch.randn(MAMBA_BATCH, MAMBA_SEQ, 5376, device=device,
                    generator=g).bfloat16()
    f = (0.3 * torch.randn(5376, 4, device=device, generator=g)).bfloat16()
    out = [("mamba", x, f, 0)]
    x = torch.randn(8, 512, 512, device=device, generator=g).bfloat16()
    f = torch.randn(512, 32, device=device, generator=g).bfloat16()
    return out + [(f"ski path left={left}", x, f, left)
                  for left in (0, 16, 31, 15)]


def check_short_conv_bf16(peaks, g, device="cuda") -> dict:
    """The bf16 short conv at ``short_conv_bf16_inputs``, within
    ``BF16_TOL``. Returns the entries, {label: entry}."""
    return {label: _short_conv_entry(label, x, f, left, peaks, tol=BF16_TOL,
                                     name="short_conv_bf16")
            for label, x, f, left in short_conv_bf16_inputs(g, device)}


def check_conv_tap_grad_bf16(peaks, g, device="cuda") -> dict:
    """The bf16 conv_tap_grad (Mamba's conv backward) at Mamba's conv shape
    (g, x (8, 2048, 5376), m = 4, left = 0), then at the SKI path's shape
    (8, 512, 512), m = 32, at its four offsets, each as
    :func:`_conv_tap_grad_entry`. Returns the entries, {label: entry}."""
    shapes = [("mamba", MAMBA_BATCH, MAMBA_SEQ, 5376, 4, 0)] + [
        (f"ski path left={left}", 8, 512, 512, 32, left)
        for left in (0, 16, 31, 15)]
    out = {}
    for label, b, n, d, m, left in shapes:
        cot, x = (torch.randn(b, n, d, device=device, generator=g).bfloat16()
                  for _ in range(2))
        out[label] = _conv_tap_grad_entry(label, cot, x, m, left, peaks,
                                          name="conv_tap_grad_bf16")
    return out


def check_ssd_scan_grad(g, device="cuda") -> dict:
    """SSDScan (``ops.ssd_scan``) at one full-width Mamba layer's shape in
    training, x (MAMBA_TRAIN_BATCH, MAMBA_SEQ, 80, 64), B and C (.., 1,
    128), chunk 128 (the config's), in bf16 and fp32: y is the kernel's
    (one ``ssd_scan`` launch) within BF16_TOL / 1e-5 × max of the chunked
    scan, and the six cotangents (one ``bwd_chunked``) against autograd
    through ``ssd_chunked.ssd_scan_chunked`` on the same inputs: the same
    ops, which sum in another order only where ``repeat_interleave``'s
    backward adds with atomics, so the fp32 cotangents within 1e-5 ×
    max|g| and the bf16 ones of x, B and C within BF16_TOL (one rounding
    of each side's fp32 sum). Times a forward and backward of each by
    CUDA events (median of 5). Returns {dtype name: (SSDScan ms, plain
    ms)}."""
    from repro_torch.kernels import ops, ssd_chunked, ssd_scan
    bt, n, h, p, gr, s, q = MAMBA_TRAIN_BATCH, MAMBA_SEQ, 80, 64, 1, 128, 128
    names = ("x", "dt", "a", "B", "C", "d_skip")
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        ins = [t.requires_grad_() for t in _ssd_inputs(bt, n, h, p, gr, s,
                                                        dtype, g, device)]
        gy = torch.randn(bt, n, h, p, device=device, generator=g).to(dtype)
        ssd_scan.reset_counters()
        y = ops.ssd_scan(*ins, chunk=q)
        got = torch.autograd.grad(y, ins, gy)
        counts = (dict(ssd_scan.counters), dict(ssd_scan.op_counters))
        y_plain = ssd_chunked.ssd_scan_chunked(*ins, chunk=q)
        want = torch.autograd.grad(y_plain, ins, gy)
        if counts != ({"ssd_scan": 1}, {"fwd": 1, "bwd_chunked": 1}) or any(
                a.dtype != t.dtype for a, t in zip(got, ins)):
            raise AssertionError(f"SSDScan {dtype} ran {counts}, cotangents "
                                 f"{[a.dtype for a in got]}")
        tol_y = BF16_TOL if dtype == torch.bfloat16 else 1e-5
        report = _grads_close(f"SSDScan {dtype} y", [y.detach().float()],
                              [y_plain.detach().float()], ["y (kernel)"],
                              tol_y)
        for name, a, w, t in zip(names, got, want, ins):
            tol = BF16_TOL if t.dtype == torch.bfloat16 else 1e-5
            report += "; " + _grads_close(f"SSDScan {dtype}", [a.float()],
                                          [w.float()], [f"d{name}"], tol)
        del got, want, y, y_plain

        def step(fn):
            return lambda: torch.autograd.grad(fn(*ins, chunk=q), ins, gy)
        out[str(dtype)] = (time_ms(step(ops.ssd_scan), reps=5),
                           time_ms(step(ssd_chunked.ssd_scan_chunked),
                                   reps=5))
        print(f"[mamba kernel] SSDScan {dtype} x ({bt}, {n}, {h}, {p}), B/C "
              f"({bt}, {n}, {gr}, {s}), chunk {q}: {report}; launches "
              f"{counts}; forward + backward {out[str(dtype)][0]:.3f} ms "
              f"(autograd through the chunked scan alone "
              f"{out[str(dtype)][1]:.3f} ms; CUDA events, median of 5)",
              flush=True)
    return out


def _mamba_kernels_refuse(device) -> None:
    """On the card the raw ``ssd_scan`` wrapper refuses an input that
    requires grad (the kernel is forward-only, as the JAX one; training
    goes through ``ops.ssd_scan``, SSDScan), launching nothing; the bf16
    ShortConv backward runs its kernels (the bf16 ``short_conv`` for dx,
    ``conv_tap_grad_bf16`` for df) and its dx and df, bf16, lie within
    BF16_TOL × max of autograd's through the plain version (both sum in
    fp32 and round once)."""
    from repro_torch.kernels import ops, ref, short_conv, ski_grad, ssd_scan
    g = torch.Generator(device=device).manual_seed(4)
    x, dt, a, b, c, d = _ssd_inputs(1, 8, 2, 8, 1, 8, torch.float32, g,
                                    device)
    _reset_mamba_counts()
    try:
        ssd_scan.ssd_scan(x.requires_grad_(), dt, a, b, c, d, chunk=4)
    except NotImplementedError as e:
        if "SSDScan" not in str(e):
            raise
    else:
        raise AssertionError("ssd_scan accepted an input requiring grad")
    if ssd_scan.counters["ssd_scan"]:
        raise AssertionError("a refused ssd_scan call launched")
    xb = torch.randn(2, 300, 48, device=device,
                     generator=g).bfloat16().requires_grad_()
    fb = (0.3 * torch.randn(48, 4, device=device,
                            generator=g)).bfloat16().requires_grad_()
    cot = torch.randn(2, 300, 48, device=device, generator=g).bfloat16()
    got = torch.autograd.grad(ops.short_conv(xb, fb, causal=True), (xb, fb),
                              cot)
    ran = (short_conv.counters["short_conv"],
           ski_grad.counters["conv_tap_grad_bf16"],
           dict(short_conv.op_counters))
    want = torch.autograd.grad(ref.short_conv_left_ref(xb, fb, 0), (xb, fb),
                               cot)
    if ran != (2, 1, {"fwd": 1, "bwd_kernel": 1, "bwd_ref": 0}) or any(
            t.dtype != torch.bfloat16 for t in got):
        raise AssertionError(f"the bf16 ShortConv backward ran {ran}")
    report = _grads_close("bf16 ShortConv backward", [t.float() for t in got],
                          [t.float() for t in want], ["dx", "df"], BF16_TOL)
    print(f"[mamba kernel] ssd_scan refuses an input that requires grad on "
          f"the card; the bf16 ShortConv backward x (2, 300, 48), m = 4 "
          f"against autograd through ref.short_conv_left_ref: {report}; "
          f"launches short_conv, conv_tap_grad_bf16, ShortConv {ran}",
          flush=True)


def _mamba_counts():
    from repro_torch.kernels import ops, ssd_scan
    counts = ops.ski_counters()
    return {"ssd_scan": ssd_scan.counters["ssd_scan"],
            "short_conv_bf16": counts.pop("short_conv"),
            "conv_tap_grad_bf16": counts.pop("conv_tap_grad_bf16"),
            "other": sum(counts.values())}


def _reset_mamba_counts() -> None:
    from repro_torch.kernels import ops, ssd_scan
    ops.reset_ski_counters()
    ssd_scan.reset_counters()


def _expect_mamba_launches(what, counts, n_layers) -> None:
    want = {"ssd_scan": n_layers, "short_conv_bf16": n_layers,
            "conv_tap_grad_bf16": 0, "other": 0}
    if counts != want:
        raise AssertionError(f"{what} launched {counts}, want {want}")


def phase_mamba_score(device="cuda"):
    """The full-width mamba2-2.7b (bf16, random weights from seed 0) scores
    MAMBA_BATCH × MAMBA_SEQ tokens through ``launch.steps.make_forward``:
    one ``ssd_scan`` and one bf16 ``short_conv`` a layer, nothing else of
    the port's kernels. Returns (cfg, model, launch counts of a forward)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_forward
    from repro_torch.models.transformer import init_model
    cfg = get_config(MAMBA)
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator().manual_seed(0), device=device)
    _sync(device)
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (MAMBA_BATCH, MAMBA_SEQ))).to(device)
    fwd = make_forward(cfg)
    print(f"[mamba score] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model},"
          f" {cfg.ssm_heads} heads x {cfg.ssm_head_dim}, state "
          f"{cfg.ssm_state}, chunk {cfg.ssd_chunk}, vocab {cfg.vocab} "
          f"(padded {cfg.vocab_padded}), {cfg.param_dtype}, {n_params} "
          f"parameters; init_model {t_init:.3f} s; {MAMBA_BATCH} x "
          f"{MAMBA_SEQ} tokens", flush=True)
    fwd(model, toks)                                   # warm-up
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    _reset_mamba_counts()
    logits = fwd(model, toks)
    _sync(device)
    launches = _mamba_counts()
    peak = torch.cuda.max_memory_allocated(device)
    _expect_mamba_launches("one mamba forward", launches, cfg.n_layers)
    if not (logits.shape == (MAMBA_BATCH, MAMBA_SEQ, cfg.vocab_padded)
            and logits.dtype == torch.bfloat16
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"mamba logits {logits.dtype} "
                             f"{tuple(logits.shape)} not finite or of the "
                             "wrong shape")
    del logits
    walls = []
    for _ in range(MAMBA_REPS):
        t0 = time.perf_counter()
        fwd(model, toks)
        _sync(device)
        walls.append(time.perf_counter() - t0)
    ms = statistics.median(walls) * 1e3
    print(f"[mamba score] make_forward {MAMBA_BATCH}x{MAMBA_SEQ}: median "
          f"{ms:.3f} ms of {MAMBA_REPS} (min {min(walls) * 1e3:.3f}, max "
          f"{max(walls) * 1e3:.3f}), {MAMBA_BATCH * MAMBA_SEQ / ms * 1e3:.0f} "
          f"tokens/s; launches per forward {launches}; max_memory_allocated "
          f"{peak} bytes ({peak / 2**30:.3f} GiB)", flush=True)
    dev_ms = _profile_forward(fwd, model, toks, device, reps=1,
                              tag="[mamba score]",
                              kernels_of=("ssd_scan_bf16_kernel",
                                          "short_conv_kernel"))
    print(f"[mamba score] device ms a forward: ssd_scan "
          f"{dev_ms['ssd_scan_bf16_kernel']:.3f} ({cfg.n_layers} launches), "
          f"short_conv {dev_ms['short_conv_kernel']:.3f}", flush=True)
    return cfg, model, launches


def phase_mamba_serve(cfg, model, device="cuda"):
    """``serving.prefill`` of MAMBA_PROMPTS × MAMBA_PROMPT_LEN prompts (the
    kernels), then greedy ``generate`` of MAMBA_GEN tokens each (the prompt
    token by token, as in the JAX package; max_len 160); then the decode
    path teacher-forced over the generated sequences against the
    kernel-path forward over them: the generated tokens are the decode
    path's argmax, none disagrees with the forward's where its top-2
    margin exceeds twice the two paths' largest logit difference, and the
    decode path is no farther from the fp32 forward of the same weights
    than twice the bf16 forward is (bf16 rounds at other places in the
    two paths, over 64 layers); the kernel-path forward is no farther from
    the same bf16 forward through the plain ``ssd_scan`` and
    ``short_conv`` than that is from the fp32 forward
    (:func:`check_kernel_vs_plain_bf16`). The same weights in fp32 then
    take both paths, where they differ only by fp32 sums in another order:
    the fp32 decode picks the fp32 forward's token at every teacher-forced
    position whose top-2 margin exceeds twice their largest logit
    difference, and at least one position is checked. Returns the launch
    counts of the prefill (a forward) and of ``generate`` (none: decode
    runs no hand kernel)."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import serving
    from repro_torch.models.transformer import Model
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (MAMBA_PROMPTS, MAMBA_PROMPT_LEN))).to(device)
    max_len = MAMBA_PROMPT_LEN + MAMBA_GEN
    with torch.inference_mode():
        generate(model, cfg, prompt[:, :4], 2)         # warm-up
        _sync(device)
        _reset_mamba_counts()
        t0 = time.perf_counter()
        logits = serving.prefill(model, cfg, prompt)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        launches = _mamba_counts()
        _expect_mamba_launches("mamba prefill", launches, cfg.n_layers)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("mamba prefill logits not finite")
        _reset_mamba_counts()
        t0 = time.perf_counter()
        seqs = generate(model, cfg, prompt, MAMBA_GEN, max_len=max_len)
        _sync(device)
        t_gen = time.perf_counter() - t0
        gen_launches = _mamba_counts()
        if any(gen_launches.values()):
            raise AssertionError(f"mamba decode launched {gen_launches}")
        if seqs.shape != (MAMBA_PROMPTS, max_len) or not torch.equal(
                seqs[:, :MAMBA_PROMPT_LEN], prompt):
            raise AssertionError(f"generate returned {tuple(seqs.shape)}")
        # every position but the last goes through one decode step (the
        # prompt too, token by token): the decode path's rate is over all
        # of them, from one timed call
        steps = MAMBA_PROMPTS * (max_len - 1)
        print(f"[mamba serve] prefill {MAMBA_PROMPTS}x{MAMBA_PROMPT_LEN}: "
              f"{t_prefill * 1e3:.3f} ms; generate {MAMBA_GEN} new: "
              f"{t_gen:.3f} s for {steps} decode steps (the prompt token by "
              f"token); {steps / t_gen:.1f} steps/s (prompt included); "
              f"prefill launches {launches}", flush=True)
        dec = _teacher_forced(model, cfg, seqs)
        fwd = serving.prefill(model, cfg, seqs)[:, :-1].float()
        # the same bf16 forward with the plain ssd_scan and short_conv
        _reset_mamba_counts()
        with _plain_mamba_kernels():
            fwd_plain = serving.prefill(model, cfg, seqs)[:, :-1].float()
        if any(_mamba_counts().values()):
            raise AssertionError("the plain mamba forward launched "
                                 f"{_mamba_counts()}")
        # the bf16 noise floor: the same weights in fp32, fp32 activations
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    param_dtype="float32")
        model32 = Model(cfg32, device=device)
        model32.load_state_dict({k: v.float() for k, v
                                 in model.state_dict().items()})
        _reset_mamba_counts()
        fwd32 = serving.prefill(model32, cfg32, seqs)[:, :-1].float()
        _expect_mamba_launches("the fp32 mamba forward", _mamba_counts(),
                               cfg.n_layers)
        dec32 = _teacher_forced(model32, cfg32, seqs)
        del model32
    gen = slice(MAMBA_PROMPT_LEN - 1, None)       # positions that picked
    diff = float((dec - fwd).abs().max())
    diff_prompt = float((dec[:, :gen.start] - fwd[:, :gen.start]).abs().max())
    noise_fwd = float((fwd - fwd32).abs().max())
    noise_dec = float((dec - fwd32).abs().max())

    def pick(lg):                                 # as generate picks
        return torch.clamp(torch.argmax(lg, dim=-1), max=cfg.vocab - 1)
    # a token the decode path picked can differ from the forward's argmax
    # only where the forward's top-2 margin is at most twice the largest
    # logit difference between the two paths
    margin = 2 * diff
    top2 = torch.topk(fwd[:, gen], 2, dim=-1).values
    gaps = top2[..., 0] - top2[..., 1]
    checked = gaps > margin
    agree = pick(fwd[:, gen]) == seqs[:, MAMBA_PROMPT_LEN:]
    wrong = ~agree & checked
    same = torch.equal(pick(dec[:, gen]), seqs[:, MAMBA_PROMPT_LEN:])
    print(f"[mamba check] decode path vs kernel-path forward over "
          f"{tuple(seqs.shape)}: largest logit difference {diff:.4f} "
          f"(prompt positions {diff_prompt:.4f}, logit scale "
          f"{float(fwd.abs().max()):.3f}); against the fp32 forward of the "
          f"same weights: bf16 forward {noise_fwd:.4f}, decode "
          f"{noise_dec:.4f} (limit 2 x {noise_fwd:.4f}); margin 2 x "
          f"{diff:.4f} = {margin:.4f} (largest top-2 margin at a generated "
          f"position {float(gaps.max()):.4f}): "
          f"{int(checked.sum())} generated positions checked, "
          f"{int(wrong.sum())} mismatches; {int(agree.sum())} of "
          f"{agree.numel()} generated tokens are the forward's argmax; "
          f"teacher-forced decode reproduces the generated tokens: {same}",
          flush=True)
    if int(wrong.sum()) or not same:
        raise AssertionError("decoded tokens disagree with the kernel-path "
                             "forward")
    check_kernel_vs_plain_bf16(fwd, fwd_plain, fwd32)
    # bf16 over 64 layers: the decode path need not match the forward, but
    # it must be no farther from the fp32 forward than the bf16 forward is
    if not noise_dec <= 2 * noise_fwd:
        raise AssertionError(f"the decode path is {noise_dec} from the fp32 "
                             f"forward, over twice the bf16 forward's "
                             f"{noise_fwd}")
    # in fp32 the two paths differ by sums in another order only, so the
    # margin is small and the positions are really checked
    diff32 = float((dec32 - fwd32).abs().max())
    margin32 = 2 * diff32
    top2 = torch.topk(fwd32, 2, dim=-1).values
    checked32 = top2[..., 0] - top2[..., 1] > margin32
    wrong32 = (pick(dec32) != pick(fwd32)) & checked32
    print(f"[mamba check] fp32 decode path vs fp32 kernel-path forward, the "
          f"same weights, over {tuple(seqs.shape)}: largest logit difference "
          f"{diff32:.3e} (logit scale {float(fwd32.abs().max()):.3f}); margin "
          f"2 x {diff32:.3e} = {margin32:.3e}: {int(checked32.sum())} of "
          f"{checked32.numel()} teacher-forced positions checked "
          f"({int(checked32[:, gen].sum())} of {checked32[:, gen].numel()} "
          f"generated), {int(wrong32.sum())} mismatches", flush=True)
    if int(wrong32.sum()) or not int(checked32.sum()):
        raise AssertionError("the fp32 decode path disagrees with the fp32 "
                             "kernel-path forward, or no position was "
                             "checked")
    return launches, gen_launches


def _plain_mamba_kernels():
    """Inside the block the Mamba layers call the plain versions of their
    kernels on the card too: ``ssd_chunked.ssd_scan_chunked`` for
    ``ops.ssd_scan`` and ``ref.short_conv_left_ref`` for
    ``ops.short_conv`` (the wrappers take them only for CPU tensors)."""
    from repro_torch.kernels import ops, ref, ssd_chunked

    def short_conv(x, filt, causal, left=None):
        if left is None:
            left = 0 if causal else filt.shape[-1] // 2
        return ref.short_conv_left_ref(x, filt, left)
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(ops, "ssd_scan",
                                          ssd_chunked.ssd_scan_chunked))
    stack.enter_context(mock.patch.object(ops, "short_conv", short_conv))
    return stack


def check_kernel_vs_plain_bf16(kernel, plain, fp32) -> dict:
    """The bf16 logits of the kernel path against those of the plain path
    (the same weights, tokens and dtype, the plain ``ssd_scan`` and
    ``short_conv``): their largest difference may not exceed the plain
    path's own largest difference from the fp32 forward. bf16 rounding
    over the layers sets that distance; a kernel whose error outgrows it
    fails the run. Prints the three distances and returns them."""
    got = {"kernel_vs_plain": float((kernel - plain).abs().max()),
           "plain_vs_fp32": float((plain - fp32).abs().max()),
           "kernel_vs_fp32": float((kernel - fp32).abs().max())}
    print(f"[mamba check] bf16 kernel-path forward vs the plain-path bf16 "
          f"forward: {got['kernel_vs_plain']:.4f} (limit: the plain path's "
          f"distance from the fp32 forward, {got['plain_vs_fp32']:.4f}; the "
          f"kernel path's own {got['kernel_vs_fp32']:.4f})", flush=True)
    if not got["kernel_vs_plain"] <= got["plain_vs_fp32"]:
        raise AssertionError(
            f"the bf16 kernel path is {got['kernel_vs_plain']} from the "
            f"plain path, over the plain path's {got['plain_vs_fp32']} from "
            "fp32")
    return got


def _teacher_forced(model, cfg, seqs, enc_out=None):
    """The decode path's logits (fp32) over ``seqs`` fed token by token:
    (b, n - 1, V), position t predicting token t + 1 (an encdec model's
    steps take ``enc_out``)."""
    from repro_torch.models import serving
    b, n = seqs.shape
    cache = serving.init_cache(cfg, b, n, params=model)
    dec = []
    for t in range(n - 1):
        lg, cache = serving.decode_step(model, cfg, seqs[:, t:t + 1], cache, t,
                                        enc_out)
        dec.append(lg[:, 0].float())
    return torch.stack(dec, 1)


def check_mamba_card_vs_cpu(device="cuda") -> None:
    """The smoke mamba2-2.7b (2 layers, d 128, state 16, chunk 16) from
    seed 1: logits on 2 × 37 tokens (a ragged last chunk) card vs CPU in
    fp32 (1e-4 × max: fp32 sums in another order over two layers) and in
    bf16 (2e-2 × max, the bf16 tier: cuBLAS and the CPU round bf16
    products differently); greedy generate token-exact in fp32; one
    training step card vs CPU in both dtypes
    (:func:`check_train_grads_card_vs_cpu`)."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import forward, init_model
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512,
                                                              (2, 37)))
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        small = reduce_for_smoke(get_config(MAMBA), dtype=dtype,
                                 param_dtype=dtype)
        cpu = init_model(small, torch.Generator().manual_seed(1), "cpu")
        card = init_model(small, torch.Generator().manual_seed(1), device)
        with torch.inference_mode():
            want = forward(cpu, small, toks)
            _reset_mamba_counts()
            got = forward(card, small, toks.to(device)).cpu()
            launches = _mamba_counts()
            report = _grads_close(f"smoke mamba {dtype} card vs CPU",
                                  [got.double()], [want.double()],
                                  ["logits"], tol)
            tokens = ""
            if dtype == "float32":
                a = generate(cpu, small, toks[:, :9], 7)
                b = generate(card, small, toks[:, :9].to(device), 7).cpu()
                if not torch.equal(a, b):
                    raise AssertionError("smoke greedy generate differs card "
                                         "vs CPU")
                tokens = "; greedy generate 2 x (9 + 7) token-exact"
        if launches["ssd_scan"] != small.n_layers:
            raise AssertionError(f"smoke mamba launched {launches}")
        shape = tuple(want.shape)
        print(f"[mamba check] smoke {small.name} {dtype} logits {shape} "
              f"card vs CPU: {report}{tokens}", flush=True)
        print(f"[mamba check] smoke {small.name} {dtype} training card vs "
              f"CPU: {check_train_grads_card_vs_cpu(small, device)}",
              flush=True)


def _rel(got, want) -> float:
    return (float((got.float() - want.float()).abs().max())
            / max(float(want.float().abs().max()), 1e-30))


@contextlib.contextmanager
def _pinned_routing(ids: list, replay: bool):
    """``moe.top_k`` inside the block: without ``replay`` each call's ids
    are recorded (on the host) in ``ids``; with it each call returns the
    next recorded ids, on the probabilities' device, with the
    probabilities at them, and the yielded list counts the tokens whose
    own top-k set would have differed. A bf16 router's near-tie can fall
    otherwise on the card than on the CPU (phase moe), which moves a token to
    another expert and that expert's gradient by far more than rounding;
    pinned, two devices' gradients differ by rounding alone."""
    from repro_torch.models import moe
    top_k, it, moved = moe.top_k, iter(ids), [0]

    def recording(probs, k):
        vals, idx = top_k(probs, k)
        ids.append(idx.cpu())
        return vals, idx

    def replaying(probs, k):
        idx = next(it).to(probs.device)
        own = top_k(probs, k)[1]
        moved[0] += int((own.sort(-1).values != idx.sort(-1).values)
                        .any(-1).sum())
        return probs.gather(-1, idx), idx
    with mock.patch.object(moe, "top_k", replaying if replay else recording):
        yield moved


def _rel_l2(got, want) -> float:
    return (float(torch.linalg.vector_norm((got.float() - want.float())))
            / max(float(torch.linalg.vector_norm(want.float())), 1e-30))


def check_train_grads_card_vs_cpu(small, device="cuda",
                                  per_leaf: bool = True) -> str:
    """One training step of the smoke model ``small`` (a Mamba or hybrid
    config, drawn from seed 1 on the host: the same weights on both
    devices) on a 2 × 40 batch (a ragged last SSD chunk): the loss and
    every gradient leaf, card vs CPU. fp32: the loss within 1e-4 relative
    and each leaf within 1e-4 × its max|g| (sums in another order; the
    card's SSD forward is the kernel's). bf16: the loss within
    ZOO_BF16_TOL relative and each leaf within max(ZOO_BF16_TOL, 2 × the
    CPU's own distance between its bf16 gradient and its gradient of the
    same weights in fp32) × max|g|, phase zoo's rule: the card and the CPU
    round to bf16 at other places, so their distance is of the size of
    each one's bf16 noise; in bf16 the MoE layers' expert choices are
    pinned to the CPU's on the card and in the fp32 copy
    (:func:`_pinned_routing`), the tokens routed otherwise reported.
    Without ``per_leaf`` (the 16-layer hybrid in bf16) the bf16 rule holds
    the root mean square over the leaves of each leaf's relative L2
    distance instead, against twice the CPU's own from fp32: per leaf,
    the largest of 197 leaves' max-abs distances is a tail of bf16 noise
    (on an H100: the card's ``a_log`` of layer 7 7.4% of its scale from
    the CPU's, whose own distance from fp32 is 2.8%), and each leaf's
    distances, the card's from fp32 among them, are printed. On the card
    each Mamba layer launches
    ``ssd_scan`` once, the short conv twice (forward, dx) and the
    ``conv_tap_grad`` instance of the dtype once, and no other kernel of
    the port; SSDScan's backward runs once a layer. Returns the report."""
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.transformer import init_model
    n = sum(m == "mamba" for m, _ in small.layers_spec)
    host = {k: torch.from_numpy(v).long() for k, v in batch_at(DataConfig(
        vocab=small.vocab, seq_len=40, global_batch=2, seed=5), 0).items()}
    cpu = init_model(small, torch.Generator().manual_seed(1), "cpu")
    card = init_model(small, torch.Generator().manual_seed(1), device)
    pin = small.dtype != "float32"
    ids = []
    with (_pinned_routing(ids, replay=False) if pin
          else contextlib.nullcontext()):
        l_cpu, _, g_cpu = loss_and_grads(cpu, small, host)
    _reset_kernel_counts()
    with (_pinned_routing(ids, replay=True) if pin
          else contextlib.nullcontext([0])) as moved:
        l_dev, _, g_dev = loss_and_grads(card, small, {
            k: v.to(device) for k, v in host.items()})
    _sync(device)
    launches, ops_ran = _kernel_counts(), dict(ssd_scan.op_counters)
    tap = ("conv_tap_grad" if small.dtype == "float32"
           else "conv_tap_grad_bf16")
    want = {k: 0 for k in launches}
    want.update({"ssd_scan": n, "short_conv": 2 * n, tap: n})
    if launches != want or ops_ran != {"fwd": n, "bwd_chunked": n}:
        raise AssertionError(f"smoke {small.name} {small.dtype} training "
                             f"launched {launches}, SSDScan {ops_ran}")
    if small.dtype == "float32":
        loss_tol, limits = 1e-4, {k: 1e-4 for k in g_cpu}
        rule = "1e-4"
    else:
        cfg32, cpu32 = _fp32_copy(small, cpu, "cpu")
        with _pinned_routing(ids, replay=True) as moved32:
            _, _, g32 = loss_and_grads(cpu32, cfg32, host)
        loss_tol = ZOO_BF16_TOL
        limits = {k: max(ZOO_BF16_TOL, 2 * _rel(g_cpu[k], g32[k]))
                  for k in g_cpu}
        rule = (f"max({ZOO_BF16_TOL}, 2 x the CPU's bf16-vs-fp32 "
                f"distance); {len(ids)} routings pinned to the CPU's, "
                f"tokens the card's own top-k would move {moved[0]}, the "
                f"fp32 copy's {moved32[0]}")
    errs = {k: _rel(g_dev[k].cpu(), g_cpu[k]) for k in g_cpu}
    worst = max(errs, key=lambda k: errs[k] / limits[k])
    lerr = abs(float(l_dev) - float(l_cpu)) / abs(float(l_cpu))
    report = (f"loss {float(l_dev):.6f} vs {float(l_cpu):.6f} (rel "
              f"{lerr:.3e}, limit {loss_tol}); {len(errs)} gradient leaves, "
              f"worst against its limit {worst} {errs[worst]:.3e} x max|g| "
              f"(limit {limits[worst]:.3e}, {rule}); largest "
              f"{max(errs.values()):.3e}; launches {launches}, SSDScan "
              f"{ops_ran}")
    held = all(errs[k] <= limits[k] for k in errs)
    if not per_leaf:
        rms = math.sqrt(statistics.mean(
            _rel_l2(g_dev[k].cpu(), g_cpu[k]) ** 2 for k in g_cpu))
        own = math.sqrt(statistics.mean(
            _rel_l2(g_cpu[k], g32[k]) ** 2 for k in g_cpu))
        limit = max(ZOO_BF16_TOL, 2 * own)
        dev32 = {k: _rel(g_dev[k].cpu(), g32[k]) for k in g_cpu}
        cpu32 = {k: _rel(g_cpu[k], g32[k]) for k in g_cpu}
        report += (f"; held by the RMS over the leaves of each leaf's "
                   f"relative L2 distance: card vs CPU {rms:.4e}, limit "
                   f"max({ZOO_BF16_TOL}, 2 x the CPU's from fp32 "
                   f"{own:.4e}) = {limit:.4e}; the 8 leaves farthest card "
                   f"vs CPU, max-abs card vs CPU / card vs fp32 / CPU vs "
                   f"fp32: "
                   + ", ".join(f"{k} {errs[k]:.3e}/{dev32[k]:.3e}/"
                               f"{cpu32[k]:.3e}" for k in sorted(
                                   errs, key=lambda k: -errs[k])[:8]))
        held = rms <= limit
    if set(g_dev) != set(g_cpu) or not lerr <= loss_tol or not held:
        raise AssertionError(f"smoke {small.name} {small.dtype} training "
                             f"differs card vs CPU: {report}")
    return report


def phase_mamba(peaks, device="cuda") -> tuple[dict, dict]:
    """The Mamba-2 serving path (PR 19): kernels, score, serve, card vs
    CPU. Returns (kernel entries, launches by path); frees the model."""
    t0 = time.perf_counter()
    kernels = phase_mamba_kernels(peaks, device)
    cfg, model, score_launches = phase_mamba_score(device)
    prefill_launches, serve_launches = phase_mamba_serve(cfg, model, device)
    del model
    torch.cuda.empty_cache()
    check_mamba_card_vs_cpu(device)
    print(f"[mamba] phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return kernels, {"mamba_score": score_launches,
                     "mamba_prefill": prefill_launches,
                     "mamba_serve": serve_launches}


#: phase mamba_train: global batch (rows of MAMBA_SEQ tokens), warm-up
#: steps (the first Trainer.run) and all steps (the second resumes to it)
MAMBA_TRAIN_BATCH, MAMBA_TRAIN_WARMUP, MAMBA_TRAIN_STEPS = 4, 2, 6
#: launches a Mamba layer makes in one training step under remat="full":
#: the forward and the backward's recompute each launch ``ssd_scan`` and
#: the bf16 ``short_conv``, the backward the bf16 ``short_conv`` again (dx)
#: and ``conv_tap_grad_bf16`` (the taps' cotangent); SSDScan's and
#: ShortConv's forwards run twice, their backwards once
MAMBA_TRAIN_LAUNCHES = {"ssd_scan": 2, "short_conv_bf16": 3,
                        "conv_tap_grad_bf16": 1, "other": 0}
MAMBA_TRAIN_OPS = {"SSDScan": {"fwd": 2, "bwd_chunked": 1},
                   "ShortConv": {"fwd": 2, "bwd_kernel": 1, "bwd_ref": 0}}


def phase_mamba_train(smi: str, device="cuda") -> dict:
    """The full-width mamba2-2.7b (64 layers, d 2560, bf16, its config's
    ``remat="full"``; random weights from seed 0, drawn on the card)
    trains MAMBA_TRAIN_STEPS AdamW steps of MAMBA_TRAIN_BATCH × MAMBA_SEQ
    tokens through two ``Trainer.run`` calls, as :func:`phase_train`: the
    warm-up steps, then a resume to the end, whose wall (host clock to a
    synchronise, and CUDA events) gives tokens/s. Every step must make
    MAMBA_TRAIN_LAUNCHES launches a layer and MAMBA_TRAIN_OPS Function
    runs, and every loss must be finite. Prints the losses, the peak
    memory, and one more step traced (device busy and idle share, the
    share of SSDScan's backward). Returns the launch counts of the
    run."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import short_conv, ssd_scan
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config(MAMBA)
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device)
    _sync(device)
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != 2_831_730_176 or cfg.remat != "full":
        raise AssertionError(f"{cfg.name}: {n_params} parameters, remat "
                             f"{cfg.remat!r}")
    ocfg = adamw.OptConfig(lr=3e-4, warmup_steps=MAMBA_TRAIN_WARMUP,
                           total_steps=MAMBA_TRAIN_STEPS)
    opt = adamw.init(ocfg, dict(model.named_parameters()))
    step_fn = make_train_step(cfg, ocfg)
    data = DataConfig(vocab=cfg.vocab, seq_len=MAMBA_SEQ,
                      global_batch=MAMBA_TRAIN_BATCH, seed=0)

    def trainer(total):
        return Trainer(TrainerConfig(total_steps=total, log_every=0),
                       step_fn, data, log=lambda line: print(line, flush=True))
    warm, timed = trainer(MAMBA_TRAIN_WARMUP), trainer(MAMBA_TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats(device)
    _reset_mamba_counts()
    t0 = time.perf_counter()
    opt, _ = warm.run(model, opt)
    _sync(device)
    t1 = time.perf_counter()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    opt, end = timed.run(model, opt, MAMBA_TRAIN_WARMUP)
    ev1.record()
    _sync(device)
    t2 = time.perf_counter()
    launches = _mamba_counts()
    ops_ran = {"SSDScan": dict(ssd_scan.op_counters),
               "ShortConv": dict(short_conv.op_counters)}
    peak = torch.cuda.max_memory_allocated(device)
    losses = [float(m["loss"])
              for m in warm.metrics_history + timed.metrics_history]
    n_timed = end - MAMBA_TRAIN_WARMUP
    tokens = n_timed * MAMBA_TRAIN_BATCH * MAMBA_SEQ
    host_s, ev_s = t2 - t1, ev0.elapsed_time(ev1) / 1e3
    per_step = {k: v / MAMBA_TRAIN_STEPS for k, v in launches.items()}
    ops_per_step = {f: {k: v / MAMBA_TRAIN_STEPS for k, v in c.items()}
                    for f, c in ops_ran.items()}
    print(f"[mamba train] {cfg.name}: {cfg.n_layers} layers, d="
          f"{cfg.d_model}, {n_params} parameters, {cfg.param_dtype}, remat "
          f"{cfg.remat}; init_model {t_init:.3f} s drawing on the card; "
          f"{end} AdamW steps of {MAMBA_TRAIN_BATCH} x {MAMBA_SEQ} tokens "
          f"({smi}): steps 0-{MAMBA_TRAIN_WARMUP - 1} {t1 - t0:.3f} s "
          f"(train_step ms {[round(t * 1e3, 3) for t in warm.step_seconds]})"
          f"; steps {MAMBA_TRAIN_WARMUP}-{end - 1} {host_s:.3f} s host clock "
          f"after a synchronise, {ev_s:.3f} s CUDA events: "
          f"{tokens / host_s:.1f} tokens/s host, {tokens / ev_s:.1f} "
          f"tokens/s events, {host_s / n_timed * 1e3:.3f} ms a step (train_"
          f"step ms {[round(t * 1e3, 3) for t in timed.step_seconds]}); "
          f"losses {losses}; max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.3f} GiB)", flush=True)
    print(f"[mamba train] kernel launches per step {per_step}; Function "
          f"runs per step {ops_per_step}", flush=True)
    want = {k: v * cfg.n_layers for k, v in MAMBA_TRAIN_LAUNCHES.items()}
    want_ops = {f: {k: v * cfg.n_layers for k, v in c.items()}
                for f, c in MAMBA_TRAIN_OPS.items()}
    if (end != MAMBA_TRAIN_STEPS or len(losses) != MAMBA_TRAIN_STEPS
            or not all(math.isfinite(v) for v in losses)
            or per_step != want or ops_per_step != want_ops):
        raise AssertionError(f"mamba training: {end} steps, losses {losses}, "
                             f"{per_step} launches and {ops_per_step} "
                             f"Function runs a step, not {want} and "
                             f"{want_ops}")
    # one more step traced: where its device time goes
    batch = {k: torch.from_numpy(v).to(device, torch.long)
             for k, v in batch_at(data, end).items()}
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(model, opt, batch)
        _sync(device)
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    ssd_bwd = sum(e.device_time_total for e in events
                  if e.device_type != torch.autograd.DeviceType.CUDA
                  and e.key.endswith("SSDScanBackward")
                  and "evaluate_function" in e.key) / 1e3

    def dev_ms(name):
        return sum(e.self_device_time_total for e in kern
                   if name in e.key) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    print(f"[mamba train] one step traced: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}, "
          f"{sum(e.count for e in kern)} kernel launches; SSDScan backward "
          f"(autograd through the chunked scan) {ssd_bwd:.3f} ms device "
          f"({ssd_bwd / busy:.3f} of busy); ssd_scan kernel "
          f"{dev_ms('ssd_scan_bf16_kernel'):.3f} ms, short_conv "
          f"{dev_ms('short_conv_kernel'):.3f} ms, conv_tap_grad "
          f"{dev_ms('conv_tap_grad_kernel'):.3f} ms; top kernels: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} "
                      f"ms x{e.count}" for e in top), flush=True)
    del model, opt, step_fn, batch, prof
    torch.cuda.empty_cache()
    print(f"[mamba train] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# ------------------------------------------------------------------ jamba
JAMBA_ARCH = "jamba-1.5-large-398b"
#: the full-width cut: layers 0-4 of the 8-layer period, (mamba, dense),
#: (mamba, moe) twice, (attention, dense): 24,050,696,192 parameters
#: (48.1 GB in bf16), every layer kind of the arch
JAMBA_LAYERS = 5
#: served prompts: 4 rows (a step of at most 4 tokens drops nothing) of
#: 224 tokens and 32 new at max_len 256
JAMBA_PROMPTS, JAMBA_PROMPT_LEN, JAMBA_GEN, JAMBA_MAX_LEN = 4, 224, 32, 256
#: the Engine's 4 ragged requests over 4 slots (one packed wave in the 64
#: bucket), and the decode step after which the preempted run snapshots
JAMBA_ENGINE_PLENS, JAMBA_ENGINE_GENS = (9, 21, 40, 60), (24, 16, 12, 8)
JAMBA_PREEMPT_STEPS = 8
#: ssd_scan at the cut's Mamba shape (256 heads of 64 in 8 groups, state
#: 128, chunk 128), ragged and short, against its plain version
JAMBA_SSD_SHAPES = (("path", 8, 512, 256, 64, 8, 128, 128),
                    ("n<q n=100", 2, 100, 256, 64, 8, 128, 128),
                    ("n=1", 2, 1, 256, 64, 8, 128, 128))
#: the bf16 short conv at the cut's conv shape: d_inner + 2 g s channels
JAMBA_CONV = (8, 512, 16384 + 2 * 8 * 128)
JAMBA_REPS = 5


def _jamba_counts(counts: dict) -> dict:
    """Kernel counts of a jamba path with the short conv under its bf16
    entry's name (every short conv of the path is bf16), so that the
    kernels' JSON line adds them to ``short_conv_bf16``."""
    counts = dict(counts)
    counts["short_conv_bf16"] = counts.pop("short_conv")
    return counts


def _jamba_kernels(peaks, device) -> dict:
    """``ssd_scan`` at JAMBA_SSD_SHAPES (bf16 and fp32, as
    :func:`check_ssd_scan`) and the bf16 ``short_conv`` at JAMBA_CONV,
    m = 4, each against its plain version and timed beside its bound.
    Returns the bf16 entries at the path shapes, by kernel name."""
    g = torch.Generator(device=device).manual_seed(5)
    ssd = check_ssd_scan(peaks, device, g, shapes=JAMBA_SSD_SHAPES,
                         tag="[jamba kernel]")
    b, n, c = JAMBA_CONV
    x = torch.randn(b, n, c, device=device, generator=g).bfloat16()
    f = (0.3 * torch.randn(c, 4, device=device, generator=g)).bfloat16()
    conv = _short_conv_entry("jamba", x, f, 0, peaks, tol=BF16_TOL,
                             name="short_conv_bf16")
    return {"ssd_scan": ssd["ssd_scan"], "short_conv_bf16": conv}


@contextlib.contextmanager
def _plain_hybrid_ops():
    """The TNO mixers' and the Mamba layers' plain versions on the card
    (:func:`_plain_tno_ops` and :func:`_plain_mamba_kernels` together)."""
    with _plain_tno_ops(), _plain_mamba_kernels():
        yield


def _new_token_gaps(model, cfg, solo, prompts) -> list:
    """For each request, the top-2 margin of the forward over its solo
    sequence at each of its new tokens."""
    from repro_torch.models.transformer import forward
    out = []
    with torch.inference_mode():
        for seq, pr in zip(solo, prompts):
            logits = forward(model, cfg, seq[None])[0, len(pr) - 1:-1].float()
            top2 = torch.topk(logits, 2, dim=-1).values
            out.append((top2[:, 0] - top2[:, 1]).tolist())
    return out


def _held_to_flip(what: str, got: dict, want: list, gaps: list,
                  margin: float) -> tuple[int, int]:
    """Each request's tokens against ``want`` up to their first
    difference, which must fall where ``gaps`` (the forward's top-2
    margin over the wanted sequence at each new token) is at most
    ``margin``: two decode paths each within margin / 2 of the forward
    pick its token wherever its margin is larger, and once a near-tie
    flips the two sequences part. Returns (tokens the same up to the
    first difference, requests that parted)."""
    checked = parted = 0
    for i, w in enumerate(want):
        g = got[i]
        n = min(len(g), len(w))
        k = next((j for j in range(n) if g[j] != w[j]), n)
        if k < n:
            if gaps[i][k] > margin:
                raise AssertionError(
                    f"{what}: request {i} differs at new token {k}, where "
                    f"the forward's top-2 margin is {gaps[i][k]:.4f} > "
                    f"{margin:.4f}: {g[:k + 1]} != {w[:k + 1]}")
            parted += 1
        checked += k
    return checked, parted


def _jamba_engine(cfg, model, ragged, device, diff: float) -> tuple:
    """JAMBA_ENGINE_PLENS over a ``Scheduler`` on an Engine of 4 slots at
    JAMBA_MAX_LEN (the cache mixes KV, conv and fp32 state leaves), each
    request held to solo ``generate`` by :func:`_held_to_flip` at the
    serve check's bf16 margin max(MARGIN, 2 × ``diff``), ``diff`` its
    largest logit difference; then the same traffic preempted after
    JAMBA_PREEMPT_STEPS decode steps, snapshotted and restored into a new
    Engine and Scheduler, whose tokens equal the uninterrupted run's
    exactly. Returns (the launches of the uninterrupted run, its new tok/s
    over ``run()``, the snapshot's bytes)."""
    from repro_torch.launch.serve import generate
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serving_engine import Engine, Scheduler
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, (p,)) for p in JAMBA_ENGINE_PLENS]
    gens = list(JAMBA_ENGINE_GENS)
    geometry = {"slots": len(prompts), "max_len": JAMBA_MAX_LEN}
    _reset_kernel_counts()
    eng = Engine(cfg, model, **geometry)
    leaves = {k: v.dtype for lc in eng.init_state().cache
              for k, v in lc.items()}
    if eng.capacity != JAMBA_MAX_LEN:
        raise AssertionError(f"jamba Engine capacity {eng.capacity}")
    sched = Scheduler(eng)
    for r in _sched_requests(prompts, gens):
        sched.submit(r)
    _sync(device)
    t0 = time.perf_counter()
    results, _ = sched.run()
    _sync(device)
    wall = time.perf_counter() - t0
    launches = _jamba_counts(_kernel_counts())
    clean = _by_index(results)
    if any(o.status != "ok" for o in sched.outcomes.values()):
        raise AssertionError(f"jamba engine outcomes {sched.outcomes}")
    with torch.inference_mode():
        solo = [generate(model, cfg, torch.from_numpy(pr)[None].to(device),
                         g, max_len=JAMBA_MAX_LEN)[0]
                for pr, g in zip(prompts, gens)]
    margin = max(MARGIN, 2 * diff)
    checked, parted = _held_to_flip(
        "jamba engine vs solo", clean,
        [s[len(pr):].tolist() for s, pr in zip(solo, prompts)],
        _new_token_gaps(model, ragged, solo, prompts), margin)
    new = sum(len(t) - 1 for t in clean.values())
    print(f"[jamba engine] {len(prompts)} requests (prompts "
          f"{list(JAMBA_ENGINE_PLENS)}, new {gens}) over S={eng.slots} at "
          f"max_len {eng.max_len} (capacity {eng.capacity}, the KV layer's), "
          f"cache leaves {leaves}: {sched.steps} decode steps, "
          f"{sched.prefills} prefills ({sched.packed_prefills} packed), "
          f"{wall:.3f} s of run() ({new / wall:.1f} new tok/s); launches "
          f"{launches}; vs solo generate: {checked} of {new + len(clean)} "
          f"new tokens the same up to the first difference, {parted} "
          f"requests parted, each at a top-2 margin <= max({MARGIN}, 2 x "
          f"{diff:.4f}) = {margin:.4f}", flush=True)
    with tempfile.TemporaryDirectory() as snap_dir:
        reg = obs_metrics.Registry()
        pre = Scheduler(eng, snapshot_dir=snap_dir, metrics=reg)

        def stop_at(uid, tok):
            if pre.steps >= JAMBA_PREEMPT_STEPS:
                pre.preempt()

        for r in _sched_requests(prompts, gens, on_token=stop_at):
            pre.submit(r)
        pre.run()
        if not pre.preempted:
            raise AssertionError("the preempted jamba run was not preempted")
        snap_bytes = int(reg.get("repro_snapshot_bytes").get())
        partial = sum(len(t) for t in pre.results.values())
        resumed = Scheduler(Engine(cfg, model, **geometry),
                            snapshot_dir=snap_dir)
        if not resumed.try_restore():
            raise AssertionError("no jamba snapshot to restore")
        resumed.run()
    if _by_index(resumed.results) != clean or any(
            o.status != "ok" for o in resumed.outcomes.values()):
        raise AssertionError("the restored jamba run's tokens differ from "
                             "the uninterrupted run's")
    print(f"[jamba engine] preempted at decode step {pre.steps} with "
          f"{partial} tokens served, snapshot {snap_bytes} bytes (KV, conv "
          f"and fp32 state rows of {eng.slots} slots); restored into a new "
          f"Engine and Scheduler: its tokens equal the uninterrupted run's "
          f"exactly", flush=True)
    return launches, new / wall, snap_bytes


def check_jamba_card_vs_cpu(device="cuda") -> None:
    """The smoke jamba (16 layers: two blocks of the 8-layer period, d 128,
    4 experts top-2, state 16 in 2 groups) from seed 1, card vs CPU:
    logits on 2 × 37 tokens within 1e-4 × max in fp32 (sums in another
    order over 16 layers) and in bf16 within ZOO_BF16_TOL × max, or twice
    the CPU's own bf16-vs-fp32-activation distance where larger (bf16
    noise over 16 layers reaches about 5e-2 of the scale), and at least
    half that distance from the CPU's fp32-activation logits (bf16
    rounding of the card's own; fp32 activations on the card would differ
    from them only by sums in another order), one
    ``ssd_scan`` and one ``short_conv`` launched a Mamba layer and no
    other kernel; fp32 greedy ``generate``
    token-exact; the fp32 Engine (4 requests over 2 slots, max_len 32)
    token-exact against solo decode on the card; one training step card vs
    CPU in both dtypes (:func:`check_train_grads_card_vs_cpu`)."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import forward, init_model
    from repro_torch.serving_engine import Engine
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512,
                                                              (2, 37)))
    for dtype in ("float32", "bfloat16"):
        small = reduce_for_smoke(get_config(JAMBA_ARCH), dtype=dtype,
                                 param_dtype=dtype)
        n_mamba = sum(m == "mamba" for m, _ in small.layers_spec)
        cpu = init_model(small, torch.Generator().manual_seed(1), "cpu")
        card = init_model(small, torch.Generator().manual_seed(1), device)
        with torch.inference_mode():
            want = forward(cpu, small, toks)
            tol, noise = 1e-4, ""
            _reset_kernel_counts()
            got = forward(card, small, toks.to(device)).cpu()
            launches = _kernel_counts()
            if dtype == "bfloat16":
                act32 = forward(cpu, dataclasses.replace(
                    small, dtype="float32"), toks)
                scale = float(want.float().abs().max())
                rel = float((want.float() - act32).abs().max()) / scale
                own = float((got.float() - act32).abs().max()) / scale
                tol = max(ZOO_BF16_TOL, 2 * rel)
                noise = (f" (limit max({ZOO_BF16_TOL}, 2 x {rel:.4f}), the "
                         "second the CPU's bf16 against fp32 activations); "
                         f"the card's bf16 logits {own:.4f} x scale from the "
                         f"CPU's fp32-activation logits (at least "
                         f"{rel / 2:.4f})")
                if not own >= rel / 2:
                    raise AssertionError("smoke jamba bf16 on the card sits "
                                         "at the fp32-activation logits")
        report = _grads_close(f"smoke jamba {dtype} card vs CPU",
                              [got.double()], [want.double()], ["logits"],
                              tol)
        want_launches = {k: 0 for k in launches}
        want_launches.update(ssd_scan=n_mamba, short_conv=n_mamba)
        if launches != want_launches:
            raise AssertionError(f"smoke jamba launched {launches}")
        tokens = ""
        if dtype == "float32":
            with torch.inference_mode():
                a = generate(cpu, small, toks[:, :9], 7)
                b = generate(card, small, toks[:, :9].to(device), 7).cpu()
            if not torch.equal(a, b):
                raise AssertionError("smoke jamba greedy generate differs "
                                     "card vs CPU")
            rng = np.random.default_rng(3)
            prompts = [rng.integers(0, 512, (p,)) for p in (3, 11, 6, 2)]
            gens = [8, 5, 9, 12]
            run = engine_run(Engine(small, card, slots=2, max_len=32),
                             prompts, gens)
            with torch.inference_mode():
                solo = [generate(card, small, torch.from_numpy(pr)[None].to(
                    device), g, max_len=32)[0, len(pr):].tolist()
                    for pr, g in zip(prompts, gens)]
            if [run["tokens"][i] for i in range(4)] != solo:
                raise AssertionError("smoke jamba fp32 Engine differs from "
                                     "solo decode on the card")
            tokens = ("; greedy generate 2 x (9 + 7) token-exact; the "
                      "Engine (4 requests, 2 slots) token-exact against "
                      "solo decode on the card")
        print(f"[jamba check] smoke {small.name} {dtype} ({small.n_layers} "
              f"layers) logits {tuple(want.shape)} card vs CPU: {report}"
              f"{noise}; launches {launches}{tokens}", flush=True)
        report = check_train_grads_card_vs_cpu(
            small, device, per_leaf=dtype == "float32")
        print(f"[jamba check] smoke {small.name} {dtype} training card vs "
              f"CPU: {report}", flush=True)


def phase_jamba(smi: str, peaks, device="cuda") -> tuple:
    """The jamba hybrid at full width, cut to JAMBA_LAYERS layers, bf16,
    from seed 0 drawn on the card (drawn on the host, as the other phases
    draw, the cut took 203 s and 23.2 GiB of host memory, ``PERF.md``
    §6): (1) ``ssd_scan`` and the bf16 ``short_conv``
    at its shapes against their plain versions; (2) init seconds, the
    parameters against ``param_count()``, peak memory; (3) score 8 × 512
    through ``make_forward`` and the eval ``loss_fn`` at the config's
    capacity factor: 4 ``ssd_scan`` + 4 ``short_conv`` launches a forward
    and no other kernel, two forwards the same bits, the assignments
    dropped per MoE layer, CUDA events beside the host clock, one forward
    traced; (4) ``prefill`` of the JAMBA_PROMPTS × JAMBA_PROMPT_LEN
    prompts (one forward: 4 + 4 launches, its own path), then greedy
    ``generate`` of JAMBA_GEN tokens each at JAMBA_MAX_LEN (the prompt
    token by token, as in JAX; no hand kernel; 4 rows: nothing drops);
    the decode path teacher-forced over the generated sequences
    (its steps timed by CUDA events and the host clock, 8 steps traced)
    against the ragged forward (:func:`_check_decoded_bf16`), beside the
    step's weight-read bound; (5) the mixed-cache Engine
    (:func:`_jamba_engine`); (6) ``--mixer fd`` at the same layers: 1
    ``causal_spectrum`` + 1 ``fd_mul`` + 4 + 4 a forward, held to the
    plain versions as phase zoo holds its overrides; (7) the smoke hybrid
    card vs CPU (:func:`check_jamba_card_vs_cpu`). Returns (the kernel
    entries at the cut's shapes, the launches by path)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_forward
    from repro_torch.models import moe, serving
    from repro_torch.models.transformer import forward, init_model, loss_fn
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(device)
    entries = _jamba_kernels(peaks, device)                  # (1)

    # (2) init
    cfg = dataclasses.replace(get_config(JAMBA_ARCH), n_layers=JAMBA_LAYERS)
    e, k, cf = cfg.n_experts, cfg.top_k, cfg.moe_capacity_factor
    ragged = dataclasses.replace(cfg, moe_impl="ragged")
    torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    model = init_model(cfg, gen, device=device)
    _sync(device)
    t_init = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    n_params = sum(p.numel() for p in model.parameters())
    pc = cfg.param_count()
    n_extra = n_params - pc["total"]
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    print(f"[jamba] {cfg.name} cut to {cfg.n_layers} layers "
          f"{list(cfg.layers_spec)}, d={cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} kv heads x {cfg.head_dim}, {e} experts top-{k} "
          f"of d_ff {cfg.d_ff}, Mamba d_inner {cfg.d_inner} in "
          f"{cfg.ssm_heads} heads x {cfg.ssm_head_dim}, {cfg.ssm_groups} "
          f"groups, state {cfg.ssm_state}, vocab {cfg.vocab}, {cfg.dtype}, "
          f"moe_impl {cfg.moe_impl} at cf {cf}; {n_params} parameters "
          f"(param_count() {pc['total']}, active {pc['active']}, + {n_extra} "
          f"norm scales and Mamba's per-head and gate-norm vectors); "
          f"init_model {t_init:.2f} s drawing on {gen.device}; "
          f"max_memory_allocated {init_peak} bytes ({init_peak / 2**30:.3f} "
          f"GiB; {held} bytes held by earlier phases); host max RSS so far "
          f"{rss / 2**30:.3f} GiB", flush=True)
    if pc["total"] != 24_050_696_192 or n_extra != sum(
            p.numel() for name, p in model.named_parameters()
            if name.endswith((".scale", "norm_scale", "a_log", "dt_bias",
                              "d_skip"))):
        raise AssertionError("jamba parameter count")
    launches = {}
    n_mamba = sum(m == "mamba" for m, _ in cfg.layers_spec)
    per_fwd = {"ssd_scan": n_mamba, "short_conv_bf16": n_mamba}

    # (3) score
    batch = _ski_batch(cfg, SCORE_BATCH, SCORE_SEQ, device)
    t = SCORE_BATCH * SCORE_SEQ
    logits, counts, score_tok_s = _zoo_score("[jamba score]", cfg, model,
                                             batch, device, JAMBA_REPS)
    launches["jamba_score"] = _jamba_counts(counts)
    want = {k: 0 for k in launches["jamba_score"]}
    want.update(per_fwd)
    if launches["jamba_score"] != want:
        raise AssertionError(f"jamba scoring launched "
                             f"{launches['jamba_score']}, not {want}")
    with torch.inference_mode(), _routing() as score_ids:
        again = forward(model, cfg, batch["tokens"])
        loss, metrics = loss_fn(model, cfg, batch)
    n_moe = sum(f == "moe" for _, f in cfg.layers_spec)
    cap = moe.capacity(t, k, cf, e)
    dropped = [_n_dropped(ids, cap, e) for ids in score_ids[:n_moe]]
    peak = torch.cuda.max_memory_allocated(device)
    with torch.inference_mode():
        ev_ms = time_ms(lambda: forward(model, cfg, batch["tokens"]),
                        reps=JAMBA_REPS)
    print(f"[jamba score] cap {cap} slots an expert for {t} tokens x "
          f"top-{k}: dropped per MoE layer "
          f"{[f'{d} of {t * k} ({d / (t * k):.4%})' for d in dropped]}; two "
          f"forwards the same bits: {torch.equal(again, logits)}; eval loss "
          f"{float(loss):.6f} = nll {float(metrics['nll']):.6f} + 0.01 x aux "
          f"{float(metrics['aux']):.6f} (ln V = {math.log(cfg.vocab):.6f}, "
          f"aux 1.0 a layer when balanced); a forward by CUDA events, median "
          f"of {JAMBA_REPS}: {ev_ms:.3f} ms; max_memory_allocated {peak} "
          f"bytes ({peak / 2**30:.3f} GiB)", flush=True)
    if not (torch.equal(again, logits) and math.isfinite(float(loss))):
        raise AssertionError("jamba scoring: two forwards differ or the "
                             "loss is not finite")
    del again, logits
    with torch.inference_mode():
        dev_ms = _profile_forward(make_forward(cfg), model, batch["tokens"],
                                  device, reps=1, tag="[jamba score]",
                                  kernels_of=("ssd_scan_bf16_kernel",
                                              "short_conv_kernel"))
    print(f"[jamba score] device ms a forward: ssd_scan "
          f"{dev_ms['ssd_scan_bf16_kernel']:.3f} ({per_fwd['ssd_scan']} "
          f"launches), short_conv {dev_ms['short_conv_kernel']:.3f}",
          flush=True)

    # (4) serve (4 rows: no step drops)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (JAMBA_PROMPTS, JAMBA_PROMPT_LEN))).to(device)
    with torch.inference_mode():
        generate(model, cfg, prompt[:, :8], 2, max_len=JAMBA_MAX_LEN)
        _sync(device)
        _reset_kernel_counts()
        t0 = time.perf_counter()
        pre_logits = serving.prefill(model, cfg, prompt)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        launches["jamba_prefill"] = _jamba_counts(_kernel_counts())
        _reset_kernel_counts()
        t0 = time.perf_counter()
        seqs = generate(model, cfg, prompt, JAMBA_GEN, max_len=JAMBA_MAX_LEN)
        _sync(device)
        t_gen = time.perf_counter() - t0
        launches["jamba_serve"] = _jamba_counts(_kernel_counts())
    if launches["jamba_prefill"] != want or any(
            launches["jamba_serve"].values()):
        raise AssertionError(f"jamba prefill launched "
                             f"{launches['jamba_prefill']} and generate "
                             f"{launches['jamba_serve']}: the prefill is one "
                             f"forward ({want}), decode runs no hand kernel")
    if seqs.shape != (JAMBA_PROMPTS, JAMBA_MAX_LEN) or not torch.equal(
            seqs[:, :JAMBA_PROMPT_LEN], prompt) or not bool(
            torch.isfinite(pre_logits).all()):
        raise AssertionError(f"jamba generate returned {tuple(seqs.shape)}")
    del pre_logits
    steps = JAMBA_MAX_LEN - 1
    weights = sum(p.numel() * p.element_size()
                  for name, p in model.named_parameters() if name != "embed")
    bound = weights / peaks[0] * 1e3
    host_ms, ev_step_ms, dec = _decode_timed(model, cfg, seqs,
                                             JAMBA_PROMPT_LEN, JAMBA_MAX_LEN,
                                             device)
    with torch.inference_mode():
        tr = _profile_forward(
            lambda m, toks: _teacher_forced(m, cfg, toks), model,
            seqs[:, :9], device, reps=1, tag="[jamba decode]",
            unit="teacher-forced pass of 8 decode steps of 4 rows")
    print(f"[jamba serve] prefill {JAMBA_PROMPTS}x{JAMBA_PROMPT_LEN}: "
          f"{t_prefill * 1e3:.3f} ms; generate {JAMBA_PROMPTS} x "
          f"({JAMBA_PROMPT_LEN} + {JAMBA_GEN}) at max_len {JAMBA_MAX_LEN} "
          f"(the prompt token by token; capacity path, cap "
          f"{moe.capacity(JAMBA_PROMPTS, k, cf, e)} >= {JAMBA_PROMPTS} rows "
          f"a step: nothing drops): {t_gen:.3f} s, {steps} decode steps "
          f"({t_gen / steps * 1e3:.3f} ms a step); launches of prefill "
          f"{launches['jamba_prefill']}, of generate "
          f"{launches['jamba_serve']}", flush=True)
    print(f"[jamba serve] a decode step of {JAMBA_PROMPTS} rows alone "
          f"({JAMBA_GEN - 1} steps after the prompt, {smi}): {host_ms:.3f} "
          f"ms host clock, {ev_step_ms:.3f} ms CUDA events; traced: "
          f"{tr['launches'] / 8:.1f} kernel launches and "
          f"{tr['busy_ms'] / 8:.3f} ms device busy a step (idle share "
          f"{1 - tr['busy_ms'] / tr['wall_ms']:.3f}); weight-read bound "
          f"{weights} bytes / {peaks[0] / 1e12} TB/s = {bound:.3f} ms a step",
          flush=True)
    diff = _check_decoded_bf16("[jamba serve]", ragged, model,
                               JAMBA_PROMPT_LEN, seqs, dec)
    del dec

    # (5) the Engine with mixed caches
    launches["jamba_engine"], engine_rate, snap_bytes = _jamba_engine(
        cfg, model, ragged, device, diff)
    engine_want = {k: 0 for k in launches["jamba_engine"]}
    if launches["jamba_engine"] != engine_want:
        raise AssertionError(f"the jamba engine launched "
                             f"{launches['jamba_engine']}")

    # (6) the paper's FD mixer in place of the attention layer
    counts, fd_rate = _zoo_override(
        "fd", cfg, model, batch, device, tag="[jamba fd]",
        n_layers=None, plain=_plain_hybrid_ops,
        also={"ssd_scan": per_fwd["ssd_scan"],
              "short_conv": per_fwd["short_conv_bf16"]}, reps=JAMBA_REPS)
    launches["jamba_fd"] = _jamba_counts(counts)
    del model, batch, seqs
    torch.cuda.empty_cache()

    # (7) card vs CPU at smoke size
    check_jamba_card_vs_cpu(device)
    print(f"[jamba] rates ({smi}; host clock, recorded, not claimed): "
          f"scoring {score_tok_s:.0f} tokens/s; decode alone "
          f"{JAMBA_PROMPTS / host_ms * 1e3:.1f} new tok/s; engine "
          f"{engine_rate:.1f} new tok/s over run(); --mixer fd scoring "
          f"{fd_rate:.0f} tokens/s; snapshot {snap_bytes} bytes", flush=True)
    print(f"[jamba] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return entries, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    smi = phase_device()
    peak_name, peaks = _peaks(smi)
    phase_build()
    kernels = phase_kernels(peaks)
    kernels.update(phase_ski_kernels(peaks)["path"])
    kernels.update(phase_grad_kernels(peaks))
    kernels.update(phase_window_kernels(peaks)["path"])
    check_coef_backward()
    cfg = get_config("fd-tnn-lm-wt103")
    model, prompt_len, seqs, serve_launches, decode_tps = phase_serve(
        cfg, "cuda", PROMPTS, PROMPT_LEN, GEN_LEN)
    engine = phase_engine(cfg, model, "cuda")
    scheduler_launches, drain = phase_scheduler(cfg, model, "cuda", engine,
                                                smi)
    train_launches = phase_train(cfg, "cuda", TRAIN_STEPS, TRAIN_SEQ,
                                 TRAIN_BATCH)
    tno_launches = phase_tno(cfg, model, seqs, decode_tps, engine, smi)
    zoo_launches = phase_zoo(smi)
    moe_launches = phase_moe(smi)
    # after the first phase that traces: a profiler session leaves every
    # later launch's host cost higher (tools/profiler_launch_cost.py)
    obs_launches = phase_obs(cfg, smi, drain)
    del drain
    encdec_kernels, encdec_launches = phase_encdec(smi, peaks)
    vlm_kernels, vlm_launches = phase_prefix_vlm(smi, peaks)
    score_launches = phase_ski_score("cuda")
    ski_train_launches = phase_train(get_config("ski-tnn-lm-wt103"), "cuda",
                                     TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH,
                                     mixer="ski")
    ski_vs_fd_op()
    unfused_launches = phase_ski_unfused()
    ski_unfused_times()
    causal_ski_vs_fd()
    large_r = phase_large_r()
    large_r_times()
    bf16_kernels, bf16_launches = phase_ski_bf16(smi, peaks)
    kernels.update(bf16_kernels)
    route_kernels, route_launches = phase_ski_bf16_routes(smi, peaks)
    kernels.update(route_kernels)
    bf16_launches.update(route_launches)
    mesh_launches = phase_mesh(smi)
    phase_check(cfg, model, prompt_len, seqs, "cuda")
    del model
    mamba_kernels, mamba_launches = phase_mamba(peaks)
    kernels.update(mamba_kernels)
    mamba_train_launches = phase_mamba_train(smi)
    jamba_kernels, jamba_launches = phase_jamba(smi, peaks)
    for at, extra in (("at_jamba", jamba_kernels),
                      ("at_encdec", encdec_kernels),
                      ("at_prefix_vlm", vlm_kernels)):
        for name, e in extra.items():
            kernels[name][at] = {
                key: e[key] for key in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by",
                                        "max_abs_err", "scale")}
    # each path must have gone through each of its kernels
    paths = {"serve": (serve_launches, ("hilbert_window", "fd_mul")),
             "engine": (engine["launches"], ("hilbert_window",)),
             "scheduler": (scheduler_launches, ("hilbert_window",)),
             "train": (train_launches, tuple(
                 k for k, v in TRAIN_LAUNCHES["fd"].items() if v)),
             "obs_train": (obs_launches, tuple(OBS_FD_KERNELS)),
             "score": (score_launches, ("interp_reduce", "ski_fused_pass2")),
             "ski_train": (ski_train_launches,
                           tuple(TRAIN_LAUNCHES["ski"])),
             "ski_unfused": (unfused_launches,
                             tuple(k for k, v in UNFUSED_STEP.items() if v)),
             "large_r_score": (large_r["large_r_score"],
                               ("interp_reduce", "ski_windowed_pass2")),
             "large_r_train": (large_r["large_r_train"],
                               tuple(TRAIN_LAUNCHES["ski_windowed"])),
             "large_r_fft_score": (large_r["large_r_fft_score"],
                                   ("interp_reduce", "ski_expand_pass2")),
             "large_r_fft_train": (large_r["large_r_fft_train"],
                                   tuple(TRAIN_LAUNCHES["ski_fft"])),
             "ski_bf16_score": (bf16_launches["ski_bf16_score"],
                                tuple(SKI_BF16_SCORE)),
             "ski_bf16_train": (bf16_launches["ski_bf16_train"],
                                tuple(SKI_BF16_STEP)),
             **{f"ski_bf16_large_r{suffix}_{kind}": (
                 bf16_launches[f"ski_bf16_large_r{suffix}_{kind}"],
                 tuple(_large_bf16_launches(variant, kind == "train")))
                for variant, suffix in (("windowed", ""), ("fft", "_fft"))
                for kind in ("score", "train")},
             "ski_bf16_unfused": (bf16_launches["ski_bf16_unfused"], tuple(
                 k for k, v in UNFUSED_BF16_STEP.items() if v)),
             "mesh_ski": (mesh_launches["mesh_ski"],
                          tuple(TRAIN_LAUNCHES["ski"])),
             "mesh_fd": (mesh_launches["mesh_fd"], tuple(
                 k for k, v in TRAIN_LAUNCHES["fd"].items() if v)),
             **{path: (counts, ()) for path, counts in tno_launches.items()
                if path != "fd_hist"},
             "fd_hist": (tno_launches["fd_hist"], ("hilbert_window",)),
             **{path: (counts, tuple(ZOO_OVERRIDES.get(
                 path.split("_", 1)[1], ())))
                for path, counts in {**zoo_launches, **moe_launches}.items()},
             **{path: (counts, () if path.endswith(("_serve", "_engine"))
                       else ("ssd_scan", "short_conv_bf16"))
                for path, counts in {**mamba_launches,
                                     **jamba_launches}.items()
                if path != "jamba_fd"},
             "jamba_fd": (jamba_launches["jamba_fd"], (
                 *ZOO_OVERRIDES["fd"], "ssd_scan", "short_conv_bf16")),
             "mamba_train": (mamba_train_launches, tuple(
                 k for k, v in MAMBA_TRAIN_LAUNCHES.items() if v)),
             **{path: (counts, {
                 "encdec_fd": (_fd_row1(ENCDEC_SEQ), "fd_mul"),
                 "encdec_fd_serve": ("hilbert_window",),
                 "vlm_ski": tuple(ZOO_OVERRIDES["ski"])}.get(path, ()))
                for path, counts in {**encdec_launches,
                                     **vlm_launches}.items()}}
    for path, (counts, names) in paths.items():
        for name in names:
            if not counts[name] > 0:
                raise AssertionError(f"{name} not launched on the {path} "
                                     "path")
    # the bf16 paths run the bf16 instances alone
    for path in (p for p in paths if p.startswith("ski_bf16_")):
        fp32 = {k: paths[path][0][k] for k in SKI_FP32_INSTANCES}
        if any(fp32.values()):
            raise AssertionError(f"the {path} path launched fp32 instances "
                                 f"{fp32}")
    for name, e in kernels.items():
        by_path = {path: counts[name] for path, (counts, names)
                   in paths.items() if name in counts}
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
    print(f"[peaks] {peak_name} data sheet: {peaks[0] / 1e12} TB/s, "
          f"{peaks[1] / 1e12} TFLOP/s fp32, {peaks[2] / 1e12} TF32, "
          f"{peaks[3] / 1e12} bf16 (dense)")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
