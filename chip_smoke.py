#!/usr/bin/env python3
"""Drive the PyTorch port (``fedml_tpu_torch``) on one NVIDIA card.

Run from the repository root:  ``python3 chip_smoke.py``

Phases (any failure exits non-zero; no phase is caught):
1. Print the card's name and power limit (nvidia-smi) and build the CUDA
   kernels from ``fedml_tpu_torch/csrc/`` with nvcc for sm_90a (one nvcc
   per source, all started together).
2. Hold each of the four fused BasicBlock kernels against its plain PyTorch
   version on the card at the three flagship shapes in f32 and bf16 (TF32
   off): the forward bitwise in both dtypes, dy / dr bitwise in f32 and
   within one bf16 ulp in bf16, d_scale / d_shift within
   ``1e-5 * sum|terms|`` per channel (f32 sums in another order); each line
   names the variant that ran (16-byte "vector" loads or "scalar", the
   forward's prefixed "fwd_"), each forward line also gives the device time
   of the PyTorch elementwise op that moves the same bytes (``torch.relu(y)``
   beside the forward without the residual, ``torch.add(y, r)`` beside the
   one with it: the card's streaming yardstick, ``stream_ms``), and each
   fused kernel gets a line of its device time and bound over a local step,
   weighted by its launches at the three shapes.  The forward's scalar
   variant (odd C, a misaligned operand) is held bitwise too.  Hold the int8
   quantize and dequantize kernels against theirs at the FedSGD gradient's
   length (269,722 elements, 264 blocks), at 2^24 elements and at the
   lengths of ResNet-20's conv kernels that a qsgd8 upload compresses
   (2,304, 4,608, 9,216, 18,432, 36,864; phase 9): int8 values,
   scales and the dequantized vector bitwise; each line names the variant
   that ran and gives the same-bytes stream (``torch.lt(x, u)``,
   ``values.to(float32)``); then at 1,025 (vector) and at 269,722 with x
   one element off a 16-byte line (the scalar variant, checked), bitwise.
   Hold the noise kernel against its plain version at the SecAgg vector's
   length (271,098: ResNet-20's parameters and BN statistics), at 2^24 and
   at local DP's 64 x 271,098 = 17,350,272 with a flat draw (phase 10) and
   at Turbo-Aggregate's group, 16 x 271,098 = 4,337,568, with a flat draw
   (phase 12; also at its sigma, 10), bitwise, at the slice's DP sigma, at
   0.25 and at 0 (the identity); each line names the variant that ran;
   then at 271,098 with x one element off a 16-byte line (the scalar
   variant, checked).  Time each kernel and its plain version
   with CUDA events over CUDA-graph replays (device time; each kernel's
   inputs rotated through more than twice the 50 MB L2) and as eager calls (host overhead
   included), next to its bound (bytes at 3.35 TB/s vs operations at 67
   TFLOP/s); for the noise kernel also the one PyTorch call that computes
   the same function, ``torch.add(x, noise, alpha=sigma)``, also in 7
   alternating runs each (median, min and max), and for the dequantize
   (single-lane and lanes) ``values.view(-1, 1024) * scales[:, None]``.  The lane-batched
   variants (``*_lanes``: one launch for all lanes of the MESH round): the
   four fused kernels at L = 64 and the three stage shapes, f32 and bf16,
   every lane bitwise the single-lane kernel on its slice and each held
   against the plain version with the tolerances above; the quantize and
   dequantize at 16 x 269,722, bitwise per lane and against the plain
   versions; each with device time (CUDA-graph replays), eager time and
   bound.  Then a fused ResNet-20 step and one FedSGD client gradient on
   the card against the same on the CPU.
3. The FedAvg path: the flagship recipe
   ``examples/sp_fedavg_cifar10_resnet20/fedml_config.yaml`` through
   ``fedml_tpu_torch.init`` and ``FedMLRunner(cfg).run()`` with only
   ``comm_round``, ``frequency_of_the_test`` and ``extra.fused_blocks``
   overridden: 128 clients, 64 a round, batch 128, bf16, full-width
   ResNet-20 on the synthetic CIFAR-10 (50,000 / 10,000 images), on its
   default MESH backend: the 64 sampled clients are the lanes of one
   batched round.  Every kernel's launch count is zeroed just before and
   read just after; each fused kernel must launch in its lanes variant,
   each fused site once a batched step (never once a client; the
   single-lane backward never), the lane-steps computed must equal the
   lanes' own step budgets, and every loss must be finite.  Each round
   prints its time, trained samples/s, lane-steps, launches and
   ``max_memory_allocated``.  Then fused against unfused MESH rounds, the
   same rounds alternating after a warm-up round each; then one f32 round
   (TF32 off) of the same recipe with 8 of its 128 clients on ``sp`` and on
   MESH from the same initial weights, the globals held to the reference's
   own MESH-vs-SP tolerance (rtol 2e-4, atol 2e-5) and the largest
   difference printed.
4. The FedSGD path: ``examples/sp_fedsgd_eftopk_cifar10_resnet20`` the same
   way with only ``comm_round``, ``frequency_of_the_test`` and
   ``compression: qsgd_int8`` overridden: 16 clients, all 16 a round, one
   full-shard gradient each, batch 128, bf16, full-width ResNet-20, on
   MESH: the 16 lanes' gradients in lane-batched steps.  The counts are
   zeroed before and read after: the lane-batched quantize and dequantize
   must launch once a round for all 16 lanes (the single-lane ones never),
   and every test metric and weight must be finite.  Then one round on
   ``sp`` (the single-lane quantize and dequantize once a client: 16 each),
   then one MESH round of the recipe's own ``eftopk``, after which every
   client's residual must be non-zero.
5. The cross-silo path: the flagship recipe through ``fedml_tpu_torch.init``
   and ``FedMLRunner(cfg).run()`` with ``training_type: cross_silo``,
   ``role: server``, ``backend: INPROC``, 4 silos all in every round, 2
   rounds (cut from 3 for the script's budget) on an eighth of the
   stand-in's training images (6,250, ~50 local steps a silo round; cut
   from 50,000 in slice 15 and from 12,500 in slice 21), Shamir SecAgg with the streaming field fold
   (``extra.secagg_method: shamir``, ``extra.secagg_stream: true``),
   central DP (Gaussian, epsilon 50, delta 1e-5, sensitivity 0.01, clip 1.0)
   and ``extra.fused_blocks``: the server and 4 clients are threads of this
   process on the in-process fabric.  The counts are zeroed before and read
   after: the noise kernel must launch once per round, in its vector
   variant, each fused kernel must launch, the fold must keep at most 2
   updates, every test metric and weight must be finite, and round 0's
   noised global must be bitwise the plain version applied to its clipped
   global with the same draw (and differ from it).  After each round (outside
   its timed finalize) it prints the round delta's L2 norm before the clip,
   the BN running statistics' share of its squared norm, and its norm after
   the clip.
6. The rest of the FedAvg family: the FedOpt recipe
   ``examples/sp_fedopt_cifar10_resnet20`` as shipped (64 clients, 16 a
   round, batch 64, bf16, server Adam) with only ``comm_round``,
   ``frequency_of_the_test`` and ``extra.fused_blocks`` overridden, 3 rounds
   on MESH: each round's time, trained samples/s, losses and peak memory,
   each fused site once a batched step in its lanes variant and the
   single-lane kernels only in the test evaluation's forward (asserted);
   one more round under ``torch.profiler`` for the device busy share
   (``obs/profile_round.py``'s union of kernel intervals); one sp round
   (the single-lane kernels, once a lane-step).  Then FedProx, FedNova,
   SCAFFOLD, FedDyn and Mime, each 2 MESH rounds of that recipe with
   ``federated_optimizer`` swapped: finite losses, each fused site once a
   batched step (Mime also once a batch of its full gradient), and for
   SCAFFOLD and FedDyn the client-state rows of the clients not sampled
   bitwise unchanged, the sampled rows moved.  Then SCAFFOLD in f32 with 8
   clients, each lane its own random ``c_i``: one batched local step
   against each lane alone within rtol 2e-4 / atol 2e-5 (``c_i`` within
   that times ``1 / (K lr)``), then budgets of 1 and 2 steps alternating
   (the lanes run in another order than the clients'), each lane held to
   that tolerance or to twice its one-ulp spread, a neighbour's ``c_i``
   moving it ten times more.  Then one MESH round with ``client_optimizer:
   adam``, and the two logistic-regression recipes as shipped,
   ``sp_fedprox_synthetic_lr`` (10 of its 30 rounds since slice 21) and
   ``cross_silo_horizontal_lr`` (10 of its 20 rounds since slice 19), with
   their final test accuracy.
7. The paths of slice 10, none of which runs any of the seven kernels
   (every launch count read after each must be 0): ``sim_hierarchical_
   cifar10`` as shipped but for its depth (3 rounds instead of 20: 16
   clients in 4 balanced groups, 2 sub-rounds, batch 32, the FedAvg CNN
   with dropout on the bf16 input, 25,000 / 10,000 synthetic CIFAR-10
   images, cut from 50,000 in slice 21): each round's time, trained samples/s, peak memory and finite
   losses, a profiled round's device busy share, then one f32 batched
   sub-round step of 8 lanes (the sampler's dropout draws) against each
   lane alone within rtol 2e-4 / atol 2e-5.  ``myavg_condshift_mlp`` as
   shipped (40 rounds; CKA must run in no round), again with
   ``agg_mod_list: [2]`` (CKA every even round, counted), and under FedAvg,
   held to the reference's test: FedAvg accuracy < 0.55, personalized mean
   > FedAvg + 0.2, personalized minimum > 0.55.  ``cross_silo_lightsecagg_lr``
   as shipped but for its depth (4 silos, 5 of its 10 rounds since slice
   19, T = 2, U = 3, straggler timeout 10 s):
   each round's time, decode time and upload bytes, the final accuracy;
   then one round in which silo 4 sends its mask shares and drops out: the
   global must be bitwise the uniform mean of the three survivors'
   field-quantized models.
8. FedLLM and round checkpointing, neither through any of the seven
   kernels (every launch count read after must be 0).  8a:
   ``fedllm_shakespeare_lora`` as shipped (10 rounds of 2 of 4 clients, 16
   adamw steps each of 8 sequences of 80 tokens, LoRA r 8 on the tiny bf16
   transformer, the synthetic Markov-chain corpus): each round's time,
   trained tokens/s, train_loss and peak memory, test loss and perplexity
   at rounds 5 and 10, every loss finite and the last round's train_loss
   below the first's; a profiled round (busy share, ``cudaLaunchKernel`` a
   step); one f32 client update (TF32 off) on the card against the CPU,
   the adapters within a relative L2 of 2e-5 and 4e-5 elementwise.  8b:
   one round of 2 clients at Llama-2-7B's widths with the depth cut from
   32 layers to 4 (d_model 4096, 32 heads, d_ff 11008, vocab 32000, bf16,
   1.07e9 f32 base parameters): each client's step time, trained tokens/s,
   6 x tokens x parameters over the step time, peak memory, finite losses
   that fall.  8c: FedLLM 2 rounds + a checkpoint + a fresh simulator
   resumed for 2 more against 4 straight rounds, and the flagship on MESH
   with fused blocks 1 + 1 rounds against 2 with cuDNN deterministic: both
   bitwise.
9. Compressed cross-silo uploads (run right after phase 5, on its data):
   phase 5's recipe, 4 silos, fused blocks, in three forms ((a) 2 rounds,
   (b) and (c) 1 round each; phase 5 warms the same shapes): (a)
   ``extra.comm_compression: qsgd8``, (b)
   ``topk`` (ratio 0.01), (c) Shamir SecAgg with ``secagg_stream``, central
   DP and ``qsgd8`` (the quantize-then-mask ring).  Each round prints its
   time, upload bytes a silo and the ratio, the aggregate time (the
   server's fold and finalize host times), test metrics, launches by kernel
   and variant and the peak memory.  Asserted: the upload bytes computed
   from the tree's shapes (288,784 for qsgd8, 36,680 for topk, 542,196 for
   the masked u16 vector) and met every round; rows 5 and 6 (quantize,
   dequantize) 18 times an upload in (a) (the 18 conv kernels) and never
   in (b) or (c); row 7 once a round in (c); the server's streaming fold on
   in (a) and (b), at most 2 updates buffered, finite metrics and weights.
   Then (i) silo 1's round-0 qsgd8 frame built on the card (18 quantize
   launches) byte-identical to the same frame built by the plain versions
   on the CPU, from the same delta and draws; (ii) round 1's four frames
   folded again on the card: the dequantize kernel bitwise numpy's decode
   at each leaf length, the sums, the division and the new global bitwise
   the reference's numpy host fold of the same frames, and the run's own
   global.
10. Trust in the simulator (run after phase 8c, on phase 3's data): the
   flagship on MESH, 2 rounds a form, each with a test evaluation, every
   tenth client id an attacker (13 of 128).  (a) ``byzantine_random``
   against ``multikrum`` (``krum_param_m`` 32, 7 Byzantine): the sampled
   attackers kept with a non-zero weight and the test accuracy against the
   undefended attack; a profiled round's device busy share and
   ``cudaLaunchKernel`` a batched step with the defense and with no trust
   flag.  (b) local DP: the noise kernel once a round over the 64 updates
   laid end to end (17,350,272 elements, a flat draw); (c) central DP (once
   a round at 271,098), then NbAFL (both): every launch and length
   asserted.  (d) the last round of (a)'s matrix (64 x 271,098), weights and
   global through all 24 registered defenses on the card and on the CPU
   with the same draws and history: selections bitwise, every other result
   within 1e-5 of its scale (weights of FoolsGold and the residual
   reweighting within 1e-4 relative), ``weak_dp`` and ``crfl`` one launch
   of the noise kernel each, the others none.  (e) ``label_flipping`` and
   ``backdoor``, one round each: the attackers' shards on the card bitwise
   the host's poisoned stack.  (f) contribution with 2 clients a round
   (3 before slice 21)
   (leave-one-out, GTG-Shapley): the replayed round's global bitwise the
   run's (cuDNN deterministic), the scores finite.  (g)
   ``myavg_condshift_mlp`` with ``norm_diff_clipping`` and local DP, 3
   rounds: the noise kernel once a round.  (h) ``cross_round`` 1 + 1 rounds
   through a checkpoint against 2 straight: globals and history bitwise.
   Each round prints its time, test accuracy, peak memory and launches.
   Every phase from 3 on starts with the caching allocator emptied and
   prints its peak memory raw and as its own (less what was allocated when
   it started).

11. The rest of the model zoo, losses and loaders (run last), on the
   synthetic fallbacks at the published widths; every kernel's launches
   counted over the phase. (a) FedAvg Shakespeare with the character LSTM
   (``model: rnn``, 820,522 parameters): ``dataset: shakespeare`` (20,000
   / 4,000 sequences of 80 characters), f32, 100 clients with 10 a round,
   batch 10, one epoch of SGD, 1 MESH round (2 before slice 15) with a
   test evaluation (round time, trained sequences/s, peak memory), a
   profiled batched step (device busy share, ``cudaLaunchKernel``), one
   f32 batched step of the 10 lanes against each lane alone (rtol 2e-4 /
   atol 2e-5), and one MESH round against one sp round of 2 clients (10
   before slice 15, 5 before slice 18, 3 before slice 21) from the same
   weights at that
   tolerance. (b)
   StackOverflow next-word prediction with the word LSTM (``model:
   word_lstm``, vocab 10,004, sequences of 20; 2,000 / 512 synthetic
   sequences, cut from 20,000 / 4,000 and then 4,000 / 1,024 (slice 21):
   the stand-in's Markov generator is linear in the count and takes ~15 s
   at 4,000), 50 clients with 10 a
   round, batch 16: one MESH round and its evaluation. (c) The
   CIFAR-10 zoo in bf16 (12,800 / 2,000 synthetic images, cut from 50,000
   / 10,000 in slice 15; 32 clients, 8 a round, batch 64; a cut to 6,400
   saved nothing in slice 19, its time being cuDNN's set-up): ``mobilenet``,
   ``mobilenet_v3``, ``efficientnet``, ``vgg11``, ``vgg16`` with
   BatchNorm, ``mobilenet`` with GroupNorm and ``resnet18_gn``, one MESH
   round each (the first: cuDNN's set-up of each
   conv shape included) with a test evaluation, and one batched step
   against each lane alone (rtol 2e-4 / atol 2e-5): in f32, and in f64 for
   the BatchNorm models (their f32 gradient is ill-conditioned: a ReLU
   after a BN flips where two f32 forwards differ in the last bits, so an
   ulp of another summation order grows to 1e-3), and for MobileNet a
   profiled batched step (busy share, launches, top device and host ops);
   then ``resnet20`` with ``norm: group`` and ``fused_blocks``: none of
   kernels 1-4 may launch (nor on any other model of (c)).  (d) The FedSGD
   recipe with ``compression: qsgd_int8`` on ``femnist`` with ``model:
   cnn`` (62 classes, 1,690,046 parameters, dropout in the full-gradient
   pass): one MESH round (rows 5-6 once each in their lanes variants, for
   16 x 1,690,046 elements), one sp round (16 single-lane launches each),
   one Mime round (no quantize launch); then rows 5-6 lanes at that length
   bitwise per lane and against the plain versions, with device times and
   bounds (as phase 2).

12. The hub-model simulators and the population engine (run after phase
   10, on phase 3's and phase 6's data: the flagship's synthetic CIFAR-10,
   50,000 / 10,000 images, full-width ResNet-20 in bf16, fused, batch 128);
   every kernel's launches zeroed before each form and read after it.
   (a) ``decentralized_fl``: DSGD on the flagship recipe with
   ``client_num_in_total: 64``, every client a lane of every round, 2
   rounds; the ring 1 round; PushSum 1 round.  Each round prints its time,
   trained samples/s, batched steps, launches, ``consensus_dist`` and peak
   memory; rows 1-4 in their lane variants once a site a batched step;
   every mix on the card held against the same product in f64 on the CPU
   (the ring against ``ring_topology(n) @ P``) within 1e-6 relative L2;
   PushSum's weights sum to n within 1e-5.  (b) ``Async_FedAvg``, 16
   arrivals (32 before slice 18): the time a step and the staleness drawn; rows 1-4 single-lane,
   10 / 9 / 10 / 9 a local step.  (c) ``TA``: 64 of 128 clients a round as
   lanes, ``ta_group_num`` 4, ``ta_dropout_prob`` 0.1, 2 rounds: row 7
   once a non-empty group at ``members x 271,098`` (lengths printed), each
   group's masked rows bitwise the plain ``x + noise * 10``, the aggregate
   within 5e-4 relative L2 of the plain weighted mean of the survivors
   (f32 rounding of sums at the masks' scale of 10), every masked row of
   norm above 10.  (d) ``training_type: centralized``: the 50,000 images
   as one client, one epoch (391 single-lane steps) and an evaluation:
   samples/s and rows 1-4's launches.  (e) population mode: the flagship
   recipe over ``population_size`` 1,000,000 ids in shards of 16 (4 a
   cohort, 4 resident) in a temporary directory, 2 FedAvg rounds and 1
   SCAFFOLD round (client state through the store): the store's bytes on
   disk, shard lookups, gather and scatter seconds, the prefetch overlap,
   the round time against phase 3's; then the FedOpt recipe's 64 clients,
   all a round, store-backed against in-memory for one round under cuDNN
   deterministic: the globals within rtol 2e-5 / atol 2e-6 (the
   reference's population tolerance).
13. The simulators that build their own networks (run after phase 12), no
   kernel: the seven kernels' counts are zeroed before and must all read 0
   after.  Each form goes through ``fedml_tpu_torch.init`` and
   ``FedMLRunner(cfg).run()`` in f32 (TF32 off) with ``homo`` shards and
   prints its rounds' time, trained samples/s, losses, test metrics and
   peak memory; a non-finite metric fails.  (a) ``split_nn``: the CIFAR-10
   stand-in at 6,400 / 2,000 images (12,800 before slice 18), the
   GroupNorm ResNet-56 halves at full width, 8 clients in relay, batch
   128, 1 round (8 x 7 = 56 single-lane steps) and an evaluation; client 0's first 2 relay steps on
   the card against the CPU from the same start and draws within
   ``SPLIT_CARD_CPU_REL`` relative L2 of the CPU's movement, which the
   card's first step alone must exceed; ``norm: batch`` refused.  (b) ``FedGKT`` on the same data,
   the 8 clients as 8 lanes, 2 rounds (round 1 with distillation): the
   client and server phases timed apart, the server's steps and the probe
   features' bytes; one lane-batched client step against each lane alone
   within rtol 2e-4 / atol 2e-5.  (c) ``vertical_fl`` on the full
   lending-club stand-in (50,000 / 10,000 rows, 200 features), batch 128,
   391 joint steps a round, 2 rounds of 2 parties and 1 of 4; the parties'
   ``bmm`` against each party's bottom alone within rtol 2e-4 / atol 2e-5.
   (d) ``FedGan`` on the full MNIST stand-in, 10 of 100 clients a round as
   lanes, batch 64, ``gan_z_dim`` 64, 2 rounds; a lane step against the
   client alone within 1e-3 relative L2 of its movement (Adam); ``sample(16)``
   shaped ``(16, 28, 28, 1)`` within [-1, 1].  (e) ``FedNAS`` on the
   CIFAR-10 stand-in at 6,400 / 2,000, 8 of 16 clients a round as lanes,
   batch 64, 2 cells of 16 features, 2 rounds: the genotype and the
   largest |alpha|; the weights and alphas moved; a lane step against the
   client alone within rtol 2e-4 / atol 2e-5.  (f) ``FedSeg`` on the full
   FeTS2021 stand-in (2,000 / 400 slices of 64 x 64 x 4, 4 classes),
   ``seg_base`` 8, 4 of 8 clients a round as lanes, batch 16, lr 0.1, 4
   local epochs (64 steps a round), 2 rounds with evaluation: the training
   loss falls, at least half the foreground test pixels are predicted as
   foreground, and the test confusion matrix on the card equals numpy's on
   the model's predictions and on uniform draws of every class.
14. Cross-silo trust and fault tolerance (run after phase 13): the
   flagship recipe through ``FedMLRunner(cfg).run()`` with
   ``training_type: cross_silo``, ``backend: TCP`` (the server and 4 silos
   as threads over loopback, ports the system picks), 3 rounds on 1,600 of
   the stand-in's images (the data count cut, not the widths), fused
   blocks, ``comm_chunk_bytes`` 65,536, ``comm_compression: qsgd8`` with
   ``streaming_aggregation``, central DP, both journals and a fixed chaos
   schedule (``chaos_seed`` 2870: in round 1 one silo's upload dropped and
   another's held back behind its next upload, so the round closes on its
   15 s straggler timer with 2 of 4; duplicated uploads in every round;
   delays).  (a) Each round's time, fold and finalize host times, upload
   bytes, the silos folded and launches: kernels 1-4 launch, 5 18 an upload
   sent, 6 exactly 18 an upload folded, 7 once a round; every
   upload not lost to chaos is folded in its round; the fold keeps at most
   2 updates; finite metrics and weights, the test loss lower after the
   last round than after the first; the last round's global equals
   the plain numpy fold of the uploads the server took (decoded by numpy,
   then the server step and central DP on the same draw) within
   ``REFOLD_ATOL``, and leaving any one upload out moves it by more than ten
   times that.
   (b) Every duplicated upload the server read before it shut down is
   deduped by its key, and nothing else is (a duplicate of the final
   round's last upload may arrive after the server finished); the chunk
   frames
   received and the injections by fault are printed.  (c) Two raw uploads
   of weight 64 folded on the card on the streaming path and buffered on
   the exact path, both with central DP: the same global, bitwise.  (d)
   Under cuDNN deterministic, 2 rounds of the buffer-all CDP run over TCP
   (chunk frames, journals; its round 1 profiled for the device busy share)
   against the same run whose server is hard-killed at round 1's first
   dispatch and rebuilt over its journal and whose silo 2 is killed before
   the rebuilt server's round-1 dispatch reaches it and rebuilt over its
   journal (``cross_silo/crash_drill.py``): the final globals bitwise.  (e) The inversion attack on the LR at 60 features (400 Adam
   steps, lr 0.05) beats its random start by the reference's 0.6 factor; on
   a fused ResNet-20 at batch 1 the victim's first-order gradient runs
   through kernels 1-4 and the attack's second order raises the port's
   refusal; Soteria's mask on the card prunes exactly its percentile (10
   of 100 features).  The phase prints its seconds by form.
15. Silos as processes of their own and the buffered-async server (run
   after phase 14).  (a) Four ``role: client`` silo processes, each
   ``python -m fedml_tpu_torch.cross_silo.soak_worker`` started with
   ``sys.executable`` (``fedml_tpu_torch.init`` and ``FedMLRunner`` on the
   card), and the ``role: server`` async server in this process (its folds
   tapped), over TCP on a free block of fixed ports, silo 2 addressed as
   ``127.0.0.2``: phase 14's recipe (ResNet-20 bf16 fused, batch 128, 1,600
   images, qsgd8 with the streaming fold, central DP, chunk frames of
   65,536, both journals) with ``async_buffer_k`` 2, ``async_concurrency``
   4, exponent 0.5, 6 virtual rounds.  Each virtual round's time, arrivals,
   staleness, fold and finalize host times and the server's launches; one
   virtual round profiled in the server process (its device busy share)
   and the card's ``utilization.gpu`` (all processes) sampled by
   ``nvidia-smi`` over the run; the virtual rounds beside phase 14's
   threaded sync rounds (a measurement).  Each silo process reports the
   card's name, that it never imported ``jax`` or ``fedml_tpu``, its
   uploads trained and its launch counts: kernels 1-4 launch in every
   silo, kernel 5 18 an upload trained (summed over the silos); in the
   server kernel 6 18 a folded upload, kernel 7 once a virtual round; the
   staleness reaches 1; at most 2 updates buffered; finite metrics; the
   last virtual round's global equals the plain numpy refold of the uploads
   the server took, in its order, each weighted ``n * (1 + tau) ** -0.5``
   (computed here), then the server step and central DP on the same draw,
   within ``REFOLD_ATOL``, and leaving any one upload out moves it by more
   than ten times that.  (b) ``run_multiproc_kill_soak`` on the card: the
   flagship ResNet-20 in every worker process (3 silos of 256 images, K =
   3, 32 versions, the journal every 2), the default chaos on every worker,
   silos 1 and 2 SIGKILLed at versions 10 and 11 and the server at 12,
   each restarted over its journal: completed, monotone, 1 server and 2
   silo kills, session epoch >= 1, unaccounted 0, every silo restart a
   journal resume or a cold rejoin, chaos injected, no worker imported
   ``jax``.  The phase prints its seconds by form.
16. The hierarchical edge tree, the secure protocols over TCP and FHE (run
   after phase 15).  (a) The flagship ResNet-20 (bf16, fused, batch 128) as
   8 silo threads over loopback TCP (ports the system picks) under
   ``hier_fanout`` 4: 2 edge aggregators of 4 silos each, qsgd8 uploads
   folded at the edges as they land, each edge's partial re-encoded with
   qsgd8 (``hier_hop_codec``) and folded at the root with direct adds, the
   streaming fold, 2 rounds on 1,600 images.  Each round folds the 8
   silos' sources at the root; the root's ingress a round (2 partials) is
   at least ``SLICE19_INGRESS_RATIO`` times smaller than the 8 compressed
   uploads the edges took (what a flat root would take); kernel 5 launches
   once a compressed leaf an upload (18) and a partial (the leaves of 260
   elements or more), kernel 6 as often (the edges' folds of uploads, the
   root's of partials), kernels 1-4 in the silos; at most 2 updates
   buffered; finite metrics; the last round's global equals the numpy
   refold of the partials the root took within ``REFOLD_ATOL``, and leaving
   one partial out moves it by more than ten times that; each edge's
   partial, as the root decodes it, equals the numpy refold (f64) of that
   edge's child uploads under their tagged weights within the hop's qsgd8
   step plus the f32 sum's rounding, and leaving one child's upload out
   breaks that bound more than tenfold.  (b)
   ``run_edge_kill_soak`` on the card (ResNet-20 f32, 4 uploads a round of
   qsgd8 through kernel 5 folded at 2 edges through kernel 6, 2 rounds):
   an edge killed after its first child's fold and rebuilt over its
   journal ends bitwise at the clean leg's global, nothing unaccounted.
   (c) Shamir SecAgg with central DP on the ``cross_silo_horizontal_lr``
   recipe (2 rounds) over loopback TCP with the server journal: kernel 7
   once a round; the server killed at round 1's boundary, and after 2 of
   round 1's uploads, each rebuilt over its journal, ends bitwise at the
   uninterrupted global.  (d) FHE on the same recipe, 4 silos, 2 rounds: the
   decrypted mean of each round within ``n * 2^-16`` of the plaintext mean
   of the same uploads, and test accuracy within ``FHE_ACC_GAP`` of the
   plain run.  The phase prints its seconds by form.
17. (slice 20) The transports between processes.  (a) Phase 14's recipe
   and cut (the flagship ResNet-20, bf16, fused, batch 128, 4 silo threads,
   1,600 images, qsgd8 uploads folded as they land, central DP, 3 rounds)
   over MQTT_S3: the port's ``MiniMqttBroker`` and ``MiniObjectStoreServer``
   on loopback (``extra.mqtt_host``), the long payloads through the store;
   silo 2's session is kicked (no DISCONNECT) as round 1 closes, reconnects
   and re-subscribes before round 2's dispatch.  Every round folds all 4
   silos; kernels 5 / 6 18 launches an upload sent / folded, kernel 7 once a
   round; the bytes through the topics and the store; the last global
   against the numpy refold of its uploads within ``REFOLD_ATOL``, one
   upload left out moving it tenfold.  (b) The server alone in this process
   and 2 silo processes (``soak_worker``: ``init`` + ``FedMLRunner`` with
   ``role: client``, no jax) over the same broker and store, 2 rounds: the
   launches summed over the processes, the global against the refold.  (c)
   The ``cross_silo_horizontal_lr`` group over WEB3 (the in-memory ledger),
   2 rounds: history and global bitwise the INPROC group's (buffer-all).
   gRPC is not driven here: the card's machine has no ``grpcio``; the CPU
   tests hold it (``tests/test_torch_grpc.py``), and its device work is
   phase 14's over TCP.
18. (slice 21) Multi-process ports over ``torch.distributed`` on gloo, every
   collective over host copies, every rank on the card.  One pair of rank
   processes (this script with ``--slice21-rank``: a fresh interpreter each,
   no jax) serves the whole phase, after (b)'s flat runs here.  (a) The
   flagship recipe under ``backend_sim: MULTIPROCESS``, f32, fused, 64 lanes
   (32 a rank), 2 rounds: both ranks' globals bitwise equal, and within
   phase 3's MESH-against-sp tolerance (rtol 2e-4 / atol 2e-5, or twice the
   one-process run's own one-ulp spread) of the same rounds in one process
   on MESH from the same initial global; each rank's round
   times, trained samples/s, all-gather bytes and seconds, and launches
   (rows 1-4 in their lanes variants in each rank).  (b) A ResNet-20 silo
   spanning the pair (rank 0 the master over TCP, rank 1 its follower, each
   on half of every minibatch with BatchNorm over the global batch) beside
   one plain silo, this process serving; the flagship as 2 silos, f32,
   fused, 240 images (one local step of 128 a silo and round), 2 rounds:
   the final global within phase 3's tolerance of the flat run (rtol 2e-4
   / atol 2e-5, or twice the flat run's own move when one weight of its
   init moves by one ulp); rows 1-4 single-lane in both ranks.  The same
   spanning run with a planted fault, each rank's BatchNorm moments over
   its own half of the batch, must break that tolerance.  (c)
   ``LLMTrainer`` at Llama-2-7B's widths, 4 of 32 layers, f32: ``data:2``
   (ZeRO-3 storage) 3 steps against the one-process trainer's losses on the
   same batches (``SLICE21_LOSS_REL``), with each step's time, tokens/s and
   each rank's peak memory against the unsharded trainer's; ring attention
   over the pair at the step's shapes against dense attention, forward and
   backward (2e-5); one ``seq:2`` f32 step's logits and gradient against the
   dense step (``SLICE21_STEP_REL`` of the largest magnitude).  (d)
   UnitedLLM under ``training_type: cross_cloud``: the server and 2 LLM
   silos over loopback TCP, 2 rounds: every model payload under half the
   base model's bytes, a test loss that does not rise.  A rank that dies or
   a collective that times out fails the phase.

Each phase's wall time on one line, then the script's wall time, then the
``{"kernels": [...]}`` JSON (each kernel's launches from its own path's
run: the lane-batched kernels from the MESH rounds of phases 3-4, the
single-lane fused kernels from phase 5, the single-lane quantize kernels
from phase 4's sp round; ``wire_launches``: each kernel's launches on
phase 9's form (a), the noise kernel's on form (c); ``trust_launches``:
each kernel's launches on phase 10's forms (a)-(c); the noise kernel's
line also has its times at local DP's length, ``ldp_length``;
``zoo_launches``: each kernel's launches over phase 11, and for the
lane-batched quantize and dequantize ``zoo_length``, ``zoo_ms``,
``zoo_plain_ms``, ``zoo_bound_ms``, ``zoo_library_ms``,
``zoo_max_abs_err`` at FEMNIST's CNN's length; ``slice15_launches``: each
kernel's launches over phase 12, and for the noise kernel ``ta_length``:
its times at Turbo-Aggregate's group length, 16 x 271,098, with sigma 10,
and ``path_max``, the longest group of the run; ``slice16_launches``: each
kernel's launches over phase 13, all 0; ``slice17_launches``: each
kernel's launches over phase 14 (a); ``slice18_launches``: each kernel's
launches over phase 15 (a), summed over its five processes;
``slice19_launches``: each kernel's launches over phase 16;
``slice20_launches``: each kernel's launches over phase 17, summed over
its processes; ``slice21_launches``: each kernel's launches over phase 18
(a)-(b), summed over its processes), then the
card's name and power limit; the last line is ``{"ok": true, "device": {...}}``.
``--kernels-only`` stops after phase 2 and prints neither;
``--slice21-only`` builds the kernels, runs phase 18 alone and prints
neither.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
import types

FLAGSHIP = "examples/sp_fedavg_cifar10_resnet20/fedml_config.yaml"
FEDSGD = "examples/sp_fedsgd_eftopk_cifar10_resnet20/fedml_config.yaml"
SHAPES = [(128, 32, 32, 16), (128, 16, 16, 32), (128, 8, 8, 64)]
# launches of each fused kernel per local step at each of SHAPES (ResNet-20:
# the stem and each block's first BN + ReLU without a residual, each block's
# second with one; the backward mirrors the forward)
STEP_LAUNCHES = {"fused_bn_relu_fwd": (4, 3, 3), "fused_bn_residual_relu_fwd": (3, 3, 3),
                 "fused_bn_relu_bwd": (4, 3, 3), "fused_bn_residual_relu_bwd": (3, 3, 3)}
GRAD_LENGTH = 269722  # ResNet-20's parameters: the FedSGD gradient
# ResNet-20's 18 conv kernels: the leaves a qsgd8 upload compresses (phase 9)
WIRE_LENGTHS = [2304, 4608, 9216, 18432, 36864]
QUANT_LENGTHS = [GRAD_LENGTH, 2**24] + WIRE_LENGTHS
SECAGG_LENGTH = 271098  # ResNet-20's parameters and BN statistics: the SecAgg vector
LANES = 64  # the flagship's clients a round: the lanes of its MESH round
# local DP's one launch a round: the flagship's 64 client updates laid end to
# end, with a flat draw (phase 10)
LDP_LENGTH = LANES * SECAGG_LENGTH
# Turbo-Aggregate's masked group (phase 12 (c)): 16 members' rows end to end
TA_LENGTH = 16 * SECAGG_LENGTH
NOISE_LENGTHS = [SECAGG_LENGTH, 2**24, LDP_LENGTH, TA_LENGTH]
# the cross-silo path's central DP (the reference's own CDP test values)
DP = dict(enable_dp=True, dp_solution_type="cdp", mechanism_type="gaussian", epsilon=50.0,
          delta=1e-5, sensitivity=0.01, clipping_norm=1.0)
SILOS = 4
# phase 9's rounds a form: (a) needs two (check (ii) folds its last
# round's frames onto the first round's global); (b) and (c) were cut from
# two to one, and the warm-up round before them dropped, to keep the script
# within its budget
WIRE_FORM_ROUNDS = {"a": 2, "b": 1, "c": 1}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
L2_BYTES = 50e6
ROUNDS = 3
SILO_ROUNDS = 2  # phase 5's rounds, cut from ROUNDS for the script's budget
# phases 5 and 9: a quarter of the stand-in's 50,000 training images over the
# 4 silos (~100 local steps a silo round instead of 393), for the budget
SILO_TRAIN_SIZE = 6250  # phases 5 and 9: cut from 50,000 (slice 15), then 12,500 (slice 21)
NOISE_RUNS = 7  # alternating timings of the noise kernel and torch.add
FEDSGD_LANES = 16  # the FedSGD recipe's clients a round
# ResNet-20's fused sites a local step: the stem and each block's first
# epilogue without a residual, each block's second with one (either direction)
SITES = {name: sum(w) for name, w in STEP_LAUNCHES.items()}
AB_PAIRS = 3  # alternating fused / unfused MESH rounds
SP_CHECK_CLIENTS = 8  # the f32 MESH-vs-sp round's clients
MESH_SP_RTOL, MESH_SP_ATOL = 2e-4, 2e-5  # the reference's own (tests/test_m0_fedavg.py)
# a whole f32 round of ResNet-20 moves by as much as MESH and sp differ when
# its initial weights move by one ulp (PERF.md §6): the round is held to
# that spread, with room for the draw of the perturbation
ROUND_SPREADS = 2
FEDOPT = "examples/sp_fedopt_cifar10_resnet20/fedml_config.yaml"
LR_RECIPES = ("examples/sp_fedprox_synthetic_lr/fedml_config.yaml",
              "examples/cross_silo_horizontal_lr/fedml_config.yaml")
# the rest of the FedAvg family, each on the FedOpt recipe with the optimizer
# swapped; SCAFFOLD and FedDyn keep per-client state for every client
FAMILY = ("FedProx", "FedNova", "SCAFFOLD", "FedDyn", "Mime")
FAMILY_ROUNDS = 2
SCAFFOLD_CHECK_LANES = 8  # the f32 batched-step check's clients
# the FedOpt recipe's fused sites: ResNet-20's stages at its batch of 64,
# its 16 clients a round as lanes, and an active prefix of them (the lanes
# still inside their step budgets)
FEDOPT_SHAPES = [(64, 32, 32, 16), (64, 16, 16, 32), (64, 8, 8, 64)]
FEDOPT_LANES = (16, 7)
# the SCAFFOLD check's allowance past the MESH-vs-sp tolerance never
# exceeds this, however large the measured one-ulp spread (ROADMAP Queue 3)
SCAFFOLD_SPREAD_CAP = 1e-4
HIERARCHICAL = "examples/sim_hierarchical_cifar10/fedml_config.yaml"
HIER_CHECK_LANES = 8  # the f32 batched-sub-round check's clients
HIER_TRAIN = 25000  # the recipe's images, cut from 50,000 (slice 21)
MYAVG = "examples/myavg_condshift_mlp/fedml_config.yaml"
LIGHTSECAGG = "examples/cross_silo_lightsecagg_lr/fedml_config.yaml"
# depth cut in slice 19 for phase 16's budget: the LightSecAgg recipe's 10
# rounds (its test runs at round 4 and the last) and the cross-silo LR
# recipe's 20
LSA_ROUNDS = 5
LR_RECIPE_ROUNDS = {"examples/cross_silo_horizontal_lr/fedml_config.yaml": 10,
                    "examples/sp_fedprox_synthetic_lr/fedml_config.yaml": 10}  # of 20 and 30
FEDLLM = "examples/fedllm_shakespeare_lora/fedml_config.yaml"
FULL_WIDTH_LAYERS = 4  # Llama-2-7B's widths, its 32 layers cut to this depth
# an f32 FedLLM client update, card against CPU, as the update from where
# it started: the relative L2 of the difference and its largest element
# (adamw turns a rounding difference of a near-zero gradient element into
# a step's worth; the CPU parity test holds the JAX package to the same)
FEDLLM_CHECK_REL, FEDLLM_CHECK_ATOL = 2e-5, 4e-5


def _gen(shape, dtype, device, seed):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32).to(dtype)


def _eager_ms(fn, arg_sets, iters=100, repeats=10, warmup=20):
    """Per-call time of eager calls back to back (CUDA events): what the
    main path pays, host launch overhead included.  The least of
    ``repeats`` runs of ``iters`` calls: the host is shared, and other work
    on it only adds time."""
    import torch

    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start.record()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return min(runs)


def _device_ms(fn, arg_sets, replays=25):
    """Per-call device time: one call per input set captured in a CUDA graph,
    replayed (CUDA events), so host launch overhead drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in arg_sets:
            fn(*args)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(arg_sets))


def _kernel_cases(fb):
    """name -> (kernel call, plain call, operand maker, bytes(n, C, item), flops(n),
    the same-bytes PyTorch stream or None)."""
    def fwd_args(y, r, g, s, b):
        return y, s, b

    def fwd_res_args(y, r, g, s, b):
        return y, s, b, r

    def bwd_args(y, r, g, s, b):
        out = fb.fused_block_reference(y, s, b)
        return g, y, s, out

    def bwd_res_args(y, r, g, s, b):
        out = fb.fused_block_reference(y, s, b, r)
        return g, y, s, out

    import torch

    return {
        fb.FWD.name: (lambda y, s, b: fb.fused_block_forward(y, s, b),
                      lambda y, s, b: fb.fused_block_reference(y, s, b),
                      fwd_args, lambda n, c, it: 2 * n * it + 2 * c * 4, lambda n: 3 * n,
                      lambda y, s, b: torch.relu(y)),
        fb.FWD_RES.name: (lambda y, s, b, r: fb.fused_block_forward(y, s, b, r),
                          lambda y, s, b, r: fb.fused_block_reference(y, s, b, r),
                          fwd_res_args, lambda n, c, it: 3 * n * it + 2 * c * 4, lambda n: 4 * n,
                          lambda y, s, b, r: torch.add(y, r)),
        fb.BWD.name: (lambda g, y, s, o: fb.fused_block_backward(g, y, s, o, False),
                      lambda g, y, s, o: fb.fused_block_bwd_reference(g, y, s, o, False),
                      bwd_args, lambda n, c, it: 4 * n * it + 3 * c * 4, lambda n: 6 * n, None),
        fb.BWD_RES.name: (lambda g, y, s, o: fb.fused_block_backward(g, y, s, o, True),
                          lambda g, y, s, o: fb.fused_block_bwd_reference(g, y, s, o, True),
                          bwd_res_args, lambda n, c, it: 5 * n * it + 3 * c * 4, lambda n: 6 * n,
                          None),
    }


def _compare(name, got, want, operands, dtype):
    """Max abs error of one call against the plain version; raises past the
    stated tolerance."""
    import torch

    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None and b is None:
            continue
        a32, b32 = a.float(), b.float()
        err = max(err, float((a32 - b32).abs().max()))
        is_reduction = name.endswith("_bwd") and i in (1, 2)
        if is_reduction:
            g, y, s, out = operands
            gm = g.float() * (out > 0).float()
            terms = (gm * y.float()).abs() if i == 1 else gm.abs()
            # per channel, and per lane for (L, C) sums
            lead = tuple(a32.shape[:-1])
            bound = 1e-5 * terms.reshape(lead + (-1, terms.shape[-1])).sum(-2) + 1e-30
            if not bool(((a32 - b32).abs() <= bound).all()):
                raise AssertionError(f"{name} output {i} {dtype}: reduction beyond 1e-5*sum|terms|")
        elif dtype == torch.float32 or name.endswith("_fwd"):
            if not torch.equal(a, b):
                raise AssertionError(f"{name} output {i} {dtype}: not bitwise equal to the "
                                     "plain version")
        else:
            tol = 2.0 ** -8 * b32.abs()  # one bf16 ulp
            if not bool(((a32 - b32).abs() <= tol).all()):
                raise AssertionError(f"{name} output {i} bf16: beyond one bf16 ulp")
    return err


def phase_kernels(fb):
    import torch

    dev = torch.device("cuda")
    cases = _kernel_cases(fb)
    results = {name: {"max_abs_err": 0.0} for name in cases}
    rows = {}  # (name, dtype) -> [(ms, bound_ms, stream_ms)] in the order of SHAPES
    for shape in SHAPES:
        c = shape[-1]
        n = math.prod(shape)
        for dtype in (torch.float32, torch.bfloat16):
            item = torch.tensor([], dtype=dtype).element_size()
            # each kernel reads at least y (n * item bytes) a call, so every
            # kernel's operands rotate through more than twice the L2
            n_sets = max(2, int(2 * L2_BYTES // (n * item)) + 1)
            base = [(_gen(shape, dtype, dev, 10 * k + 1), _gen(shape, dtype, dev, 10 * k + 2),
                     _gen(shape, dtype, dev, 10 * k + 3), _gen((c,), torch.float32, dev, 10 * k + 4),
                     _gen((c,), torch.float32, dev, 10 * k + 5)) for k in range(n_sets)]
            for name, (kern, plain, build_args, nbytes, nflops, stream) in cases.items():
                arg_sets = [build_args(*b) for b in base]
                variants = fb.variant_counts()
                got, want = kern(*arg_sets[0]), plain(*arg_sets[0])
                torch.cuda.synchronize()
                variant = [k for k, v in fb.variant_counts().items() if v > variants[k]]
                err = _compare(name, got, want, arg_sets[0], dtype)
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
                ms, plain_ms = _device_ms(kern, arg_sets), _device_ms(plain, arg_sets)
                eager_ms = _eager_ms(kern, arg_sets)
                stream_ms = _device_ms(stream, arg_sets) if stream is not None else None
                bytes_ms = nbytes(n, c, item) / HBM_BYTES_PER_S * 1e3
                ops_ms = nflops(n) / F32_FLOPS_PER_S * 1e3
                bound_ms = max(bytes_ms, ops_ms)
                row = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
                       "ms": ms, "plain_ms": plain_ms, "eager_ms": eager_ms, "bound_ms": bound_ms,
                       "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                       "max_abs_err": err, "stream_ms": stream_ms}
                yardstick = "" if stream is None else (
                    f", same-bytes stream {stream_ms * 1e3:.2f} us ({ms / stream_ms:.2f}x)")
                print(f"kernel {name} {row['dtype']} {tuple(shape)}: ok, device {ms * 1e3:.2f} us "
                      f"(plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us, "
                      f"{100 * bound_ms / ms:.1f}% of bound{yardstick}), eager call "
                      f"{eager_ms * 1e3:.2f} us, max_abs_err {err:.3g}"
                      + (f", {variant[0]} variant" if variant else ""))
                rows.setdefault((name, row["dtype"]), []).append((ms, bound_ms, stream_ms))
                if shape == SHAPES[0] and dtype == torch.bfloat16:
                    results[name].update({k: row[k] for k in
                                          ("ms", "plain_ms", "bound_ms", "bound_by")})
                    if stream is not None:
                        results[name]["stream_ms"] = stream_ms
    for (name, dtype), times in rows.items():
        weights = STEP_LAUNCHES[name]
        ms = sum(w * t for w, (t, _, _) in zip(weights, times))
        bound_ms = sum(w * b for w, (_, b, _) in zip(weights, times))
        yardstick = "" if times[0][2] is None else (
            f", same-bytes stream {sum(w * x for w, (_, _, x) in zip(weights, times)) * 1e3:.2f} us")
        print(f"kernel {name} {dtype} over a local step ({sum(weights)} launches, "
              f"{'/'.join(map(str, weights))} at the three shapes): device {ms * 1e3:.2f} us, "
              f"bound {bound_ms * 1e3:.2f} us, {100 * bound_ms / ms:.1f}% of bound{yardstick}")
    phase_fwd_scalar(fb)
    return results


def _misaligned(t):
    """A contiguous copy of t that starts one element past a 16-byte line."""
    base = t.new_empty(t.numel() + 1)
    view = base[1:].view(t.shape)
    view.copy_(t)
    return view


def phase_fwd_scalar(fb):
    """The forward's scalar variant (C not a multiple of the 16-byte width,
    or an operand off a 16-byte line) against the plain version, bitwise,
    in f32 and bf16, with and without the residual; the variant that ran is
    checked."""
    import torch

    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        for what, shape in (("C=3", (128, 16, 16, 3)), ("C=300", (8, 8, 8, 300)),
                            ("misaligned y", SHAPES[1])):
            c = shape[-1]
            y, r = _gen(shape, dtype, dev, 41), _gen(shape, dtype, dev, 42)
            s, b = _gen((c,), torch.float32, dev, 43), _gen((c,), torch.float32, dev, 44)
            if what.startswith("misaligned"):
                y = _misaligned(y)
            want = "fwd_vector" if c % (16 // y.element_size()) == 0 and not what.startswith(
                "misaligned") else "fwd_scalar"
            for res in (None, r):
                before = fb.variant_counts()[want]
                got = fb.fused_block_forward(y, s, b, res)
                torch.cuda.synchronize()
                if fb.variant_counts()[want] != before + 1:
                    raise AssertionError(f"forward {what} {dtype}: {want} did not run")
                if not torch.equal(got, fb.fused_block_reference(y, s, b, res)):
                    raise AssertionError(f"forward {what} {dtype} residual={res is not None}: "
                                         "not bitwise equal to the plain version")
            print(f"kernel forward {what} {str(dtype).replace('torch.', '')} {shape}: ok "
                  f"(bitwise, with and without the residual), {want} variant")


def _equal_outputs(a, b) -> bool:
    """Whether two kernel results (a tensor, or a tuple with Nones) are
    bitwise equal."""
    import torch

    if not isinstance(a, tuple):
        a, b = (a,), (b,)
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


def phase_lane_kernels(fb):
    """Rows 1-4 lane-batched (``*_lanes``: one launch for L lane-major
    activations with per-lane scale and shift) at the MESH round's L = 64
    and the three stage shapes, f32 and bf16: every lane bitwise the
    single-lane kernel on its slice (all outputs, d_scale and d_shift too:
    each lane keeps the single-lane fold order), each held against the plain
    version with phase 2's tolerances (sums per lane and channel), device
    time from CUDA-graph replays and eager time, next to the bound."""
    import torch

    dev = torch.device("cuda")
    cases = _kernel_cases(fb)
    lane_kernel = {k.name: lk for k, lk in zip(fb.KERNELS, fb.LANE_KERNELS)}
    results = {k.name: {"max_abs_err": 0.0} for k in fb.LANE_KERNELS}
    rows = {}
    for shape in SHAPES:
        lshape, c = (LANES,) + shape, shape[-1]
        n = math.prod(lshape)
        for dtype in (torch.float32, torch.bfloat16):
            item = torch.tensor([], dtype=dtype).element_size()
            n_sets = max(2, int(2 * L2_BYTES // (n * item)) + 1)
            base = [(_gen(lshape, dtype, dev, 10 * k + 1), _gen(lshape, dtype, dev, 10 * k + 2),
                     _gen(lshape, dtype, dev, 10 * k + 3),
                     _gen((LANES, c), torch.float32, dev, 10 * k + 4),
                     _gen((LANES, c), torch.float32, dev, 10 * k + 5)) for k in range(n_sets)]
            for name, (kern, plain, build_args, nbytes, nflops, stream) in cases.items():
                lk = lane_kernel[name]
                arg_sets = [build_args(*b) for b in base]
                before = fb.launch_counts()[lk.name]
                got, want = kern(*arg_sets[0]), plain(*arg_sets[0])
                torch.cuda.synchronize()
                if fb.launch_counts()[lk.name] != before + 1:
                    raise AssertionError(f"{lk.name}: a lane-major call did not launch it once")
                err = _compare(name, got, want, arg_sets[0], dtype)
                results[lk.name]["max_abs_err"] = max(results[lk.name]["max_abs_err"], err)
                for lane in range(LANES):
                    one = kern(*(a[lane] for a in arg_sets[0]))
                    mine = tuple(None if t is None else t[lane] for t in got) if isinstance(
                        got, tuple) else got[lane]
                    if not _equal_outputs(mine, one):
                        raise AssertionError(f"{lk.name} {dtype} {lshape}: lane {lane} is not "
                                             "bitwise the single-lane kernel on its slice")
                ms, plain_ms = _device_ms(kern, arg_sets), _device_ms(plain, arg_sets)
                eager_ms = _eager_ms(kern, arg_sets, iters=20, repeats=5, warmup=5)
                stream_ms = _device_ms(stream, arg_sets) if stream is not None else None
                bytes_ms = nbytes(n, LANES * c, item) / HBM_BYTES_PER_S * 1e3
                ops_ms = nflops(n) / F32_FLOPS_PER_S * 1e3
                bound_ms = max(bytes_ms, ops_ms)
                dt = str(dtype).replace("torch.", "")
                yardstick = "" if stream is None else (
                    f", same-bytes stream {stream_ms * 1e3:.2f} us ({ms / stream_ms:.2f}x)")
                print(f"kernel {lk.name} {dt} {lshape}: ok (every lane bitwise the single-lane "
                      f"kernel), device {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, bound "
                      f"{bound_ms * 1e3:.2f} us, {100 * bound_ms / ms:.1f}% of bound{yardstick}), "
                      f"eager call {eager_ms * 1e3:.2f} us, max_abs_err {err:.3g}")
                rows.setdefault((lk.name, name, dt), []).append((ms, bound_ms))
                if shape == SHAPES[0] and dtype == torch.bfloat16:
                    results[lk.name].update({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                             "bound_by": "bytes" if bytes_ms >= ops_ms
                                             else "operations"})
                    if stream is not None:
                        results[lk.name]["stream_ms"] = stream_ms
            del base, arg_sets, got, want
    for (lname, name, dt), times in rows.items():
        weights = STEP_LAUNCHES[name]
        ms = sum(w * t for w, (t, _) in zip(weights, times))
        bound_ms = sum(w * b for w, (_, b) in zip(weights, times))
        print(f"kernel {lname} {dt} over a batched step of {LANES} lanes ({sum(weights)} launches): "
              f"device {ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us, "
              f"{100 * bound_ms / ms:.1f}% of bound")
    return results


def phase_fedopt_shapes(fb):
    """Rows 1-4 at the FedOpt path's own shapes (FEDOPT_SHAPES), f32 and
    bf16: the lanes variant at 16 lanes and at an active prefix of 7 (the
    first lanes of 16-lane operands, as a batched step passes them), held
    against the plain version with phase 2's tolerances; every lane bitwise
    the single-lane kernel on its slice, and each such single-lane call
    (the sp round's launch at batch 64) held against the plain version."""
    import torch

    dev = torch.device("cuda")
    cases = _kernel_cases(fb)
    lane_kernel = {k.name: lk for k, lk in zip(fb.KERNELS, fb.LANE_KERNELS)}
    for shape in FEDOPT_SHAPES:
        full, c = (FEDOPT_LANES[0],) + shape, shape[-1]
        for dtype in (torch.float32, torch.bfloat16):
            base = (_gen(full, dtype, dev, 61), _gen(full, dtype, dev, 62),
                    _gen(full, dtype, dev, 63), _gen((full[0], c), torch.float32, dev, 64),
                    _gen((full[0], c), torch.float32, dev, 65))
            dt = str(dtype).replace("torch.", "")
            for name, (kern, plain, build_args, _, _, _) in cases.items():
                lk = lane_kernel[name]
                errs = []
                for lanes in FEDOPT_LANES:
                    args = build_args(*(t[:lanes] for t in base))
                    before = fb.launch_counts()
                    got, want = kern(*args), plain(*args)
                    torch.cuda.synchronize()
                    after = fb.launch_counts()
                    if after[lk.name] != before[lk.name] + 1 or after[name] != before[name]:
                        raise AssertionError(f"{lk.name} {dt} {lanes} lanes x {shape}: not one "
                                             "lanes launch")
                    errs.append(_compare(name, got, want, args, dtype))
                    for lane in range(lanes):
                        one_args = tuple(a[lane] for a in args)
                        one = kern(*one_args)
                        mine = tuple(None if t is None else t[lane] for t in got) if isinstance(
                            got, tuple) else got[lane]
                        if not _equal_outputs(mine, one):
                            raise AssertionError(f"{lk.name} {dt} {lanes} lanes x {shape}: lane "
                                                 f"{lane} is not bitwise the single-lane kernel")
                        errs.append(_compare(name, one, plain(*one_args), one_args, dtype))
                print(f"kernel {lk.name} / {name} {dt} at the FedOpt path's {shape} x "
                      f"{'/'.join(map(str, FEDOPT_LANES))} lanes: ok (every lane bitwise the "
                      f"single-lane kernel, both against the plain version), max_abs_err "
                      f"{max(errs):.3g}")


def _quant_bytes(n):
    """Bytes each function must move: (quantize, dequantize)."""
    b = -(-n // 1024)
    return 4 * n + 4 * b * 1024 + b * 1024 + 4 * b, b * 1024 + 4 * b + 4 * n


def _variant_ran(mod, before):
    """kernel name -> the variant its launches since ``before`` ran (``mod``:
    a kernel module with ``variant_counts()``)."""
    ran = {}
    for name, counts in mod.variant_counts().items():
        moved = [v for v, c in counts.items() if c > before[name][v]]
        ran[name] = moved[0] if len(moved) == 1 else "none" if not moved else "both"
    return ran


def _check_quant(qz, x, u, what, variant):
    """Quantize and dequantize x on the card, bitwise against the plain
    versions, and check that ``variant`` ran (the values handed to the
    dequantize one byte off a 16-byte line for the scalar variant)."""
    import torch

    n = x.numel()
    before = qz.variant_counts()
    got, want = qz.quantize_int8_stochastic(x, u), qz.quantize_int8_reference(x, u)
    values = _misaligned(got[0]) if variant == "scalar" else got[0]
    deq = qz.dequantize_int8(values, got[1], n)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and got[2] == want[2]):
        bad = int((got[0] != want[0]).sum())
        raise AssertionError(f"quantize kernel at {what}: {bad} values differ, scales equal "
                             f"{torch.equal(got[1], want[1])}: not bitwise the plain version")
    if not torch.equal(deq, qz.dequantize_int8_reference(values, got[1], n)) or deq.shape != (n,):
        raise AssertionError(f"dequantize kernel at {what}: not bitwise the plain version")
    singles = {k.name for k in qz.KERNELS}
    ran = {k: v for k, v in _variant_ran(qz, before).items() if k in singles}
    if set(ran.values()) != {variant}:
        raise AssertionError(f"quantize kernels at {what}: ran {ran}, expected {variant}")
    return ran


def _dequantize_library(values, scales, n):
    """The one PyTorch call that computes the dequantize: int8 values times
    f32 scales promote to f32; the slice to the length is a view."""
    return (values.view(-1, 1024) * scales[:, None]).view(-1)[:n]


def phase_quantize(qz):
    """The int8 quantize / dequantize kernels against their plain versions:
    values, scales and the dequantized vector bitwise; each line names the
    variant that ran and the same-bytes stream (``torch.lt(x, u)``: reads
    x and u, writes a byte each; ``values.to(float32)``: reads a byte,
    writes four)."""
    import torch

    dev = torch.device("cuda")
    results = {k.name: {"max_abs_err": 0.0} for k in qz.KERNELS}
    for n in QUANT_LENGTHS:
        shape = qz.noise_shape(n)
        q_bytes, dq_bytes = _quant_bytes(n)
        n_sets = max(2, int(3 * L2_BYTES // q_bytes) + 1)
        sets = []
        for k in range(n_sets):
            g = torch.Generator(device=dev)
            g.manual_seed(100 + k)
            x = torch.randn(n, generator=g, device=dev) * torch.exp(
                3 * torch.randn(n, generator=g, device=dev))
            sets.append((x, torch.rand(shape, generator=g, device=dev)))
        ran = _check_quant(qz, *sets[0], f"n={n}", "vector")
        dq_sets = [qz.quantize_int8_stochastic(*a) for a in sets]

        def q_stream(x, u, n=n):
            return torch.lt(x, u.view(-1)[:n])

        def dq_stream(values, scales, n):
            return values.view(-1)[:n].to(torch.float32)

        cases = [(qz.QUANTIZE, qz.quantize_int8_stochastic, qz.quantize_int8_reference, sets,
                  q_bytes, 7 * shape[0] * 1024, q_stream, None),
                 (qz.DEQUANTIZE, qz.dequantize_int8, qz.dequantize_int8_reference, dq_sets,
                  dq_bytes, n, dq_stream, _dequantize_library)]
        for kern, fn, plain, arg_sets, nbytes, nops, stream, library in cases:
            ms, plain_ms = _device_ms(fn, arg_sets), _device_ms(plain, arg_sets)
            stream_ms = _device_ms(stream, arg_sets)
            library_ms = _device_ms(library, arg_sets) if library else None
            if library and not torch.equal(library(*arg_sets[0]), fn(*arg_sets[0])):
                raise AssertionError(f"{kern.name} n={n}: the PyTorch call computes another "
                                     "function")
            eager_ms = _eager_ms(fn, arg_sets)
            bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_FLOPS_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            print(f"kernel {kern.name} n={n} ({shape[0]} blocks): ok (bitwise), device "
                  f"{ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us, "
                  f"{100 * bound_ms / ms:.1f}% of bound, same-bytes stream {stream_ms * 1e3:.2f} us "
                  f"({ms / stream_ms:.2f}x)"
                  + (f", PyTorch call {library_ms * 1e3:.2f} us" if library else "")
                  + f"), eager call {eager_ms * 1e3:.2f} us, {ran[kern.name]} variant")
            if n == GRAD_LENGTH:
                results[kern.name].update({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                           "stream_ms": stream_ms, "library_ms": library_ms,
                                           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
    for n, misaligned in ((1025, False), (GRAD_LENGTH, True)):
        g = torch.Generator(device=dev)
        g.manual_seed(150 + n)
        x = torch.randn(n, generator=g, device=dev) * torch.exp(
            3 * torch.randn(n, generator=g, device=dev))
        u = torch.rand(qz.noise_shape(n), generator=g, device=dev)
        what = f"n={n}" + (" with x off a 16-byte line" if misaligned else "")
        ran = _check_quant(qz, _misaligned(x) if misaligned else x, u, what,
                           "scalar" if misaligned else "vector")
        print(f"kernel quantize / dequantize {what}: ok (bitwise), {ran[qz.QUANTIZE.name]} variant")
    return results


def phase_lane_quantize(qz, n=GRAD_LENGTH):
    """Rows 5-6 lane-batched (``*_lanes``: the L lanes padded to whole
    blocks and laid end to end, one launch each) at the FedSGD round's 16
    lanes of ``n`` (ResNet-20's 269,722; FEMNIST's CNN's 1,690,046 in
    phase 11): every lane's values, scales and dequantized vector
    bitwise the single-lane kernels' on that lane and the plain versions';
    device time of each kernel from CUDA-graph replays on the laid-out
    operands (and of the wrapper, the pad's copy included), eager time and
    bound."""
    import torch

    dev = torch.device("cuda")
    lanes = FEDSGD_LANES
    shape = (lanes,) + qz.noise_shape(n)
    q_bytes, dq_bytes = (lanes * b for b in _quant_bytes(n))
    sets = []
    for k in range(max(2, int(2 * L2_BYTES // min(q_bytes, dq_bytes)) + 1)):
        g = torch.Generator(device=dev)
        g.manual_seed(300 + k)
        x = torch.randn((lanes, n), generator=g, device=dev) * torch.exp(
            3 * torch.randn((lanes, n), generator=g, device=dev))
        sets.append((x, torch.rand(shape, generator=g, device=dev)))
    x, u = sets[0]
    before = qz.launch_counts()
    values, scales, length = qz.quantize_int8_lanes(x, u)
    deq = qz.dequantize_int8_lanes(values, scales, length)
    torch.cuda.synchronize()
    after = qz.launch_counts()
    for k in qz.LANE_KERNELS:
        if after[k.name] != before[k.name] + 1:
            raise AssertionError(f"{k.name}: {lanes} lanes did not take one launch")
    want = qz.quantize_int8_lanes_reference(x, u)
    if not (torch.equal(values, want[0]) and torch.equal(scales, want[1]) and torch.equal(
            deq, qz.dequantize_int8_lanes_reference(values, scales, length))):
        raise AssertionError("lane-batched quantize kernels: not bitwise the plain versions")
    for lane in range(lanes):
        v1, s1, _ = qz.quantize_int8_stochastic(x[lane], u[lane])
        if not (torch.equal(v1, values[lane]) and torch.equal(s1, scales[lane])
                and torch.equal(qz.dequantize_int8(v1, s1, n), deq[lane])):
            raise AssertionError(f"lane-batched quantize kernels: lane {lane} is not bitwise "
                                 "the single-lane kernels on its vector")
    laid_out = [qz.lanes_end_to_end(*a)[:2] for a in sets]
    dq_laid_out = [qz.quantize_int8_reference(*a) for a in laid_out]
    wrapped = {qz.QUANTIZE_LANES.name: (qz.quantize_int8_lanes, sets),
               qz.DEQUANTIZE_LANES.name: (qz.dequantize_int8_lanes,
                                          [qz.quantize_int8_lanes(*a) for a in sets])}
    results = {}
    for kern, fn, plain, arg_sets, nbytes, nops, stream, library in (
            (qz.QUANTIZE_LANES, lambda x, u: qz._quantize_cuda(x, u, qz.QUANTIZE_LANES),
             qz.quantize_int8_reference, laid_out, q_bytes, 7 * shape[1] * 1024 * lanes,
             lambda x, u: torch.lt(x, u.view(-1)), None),
            (qz.DEQUANTIZE_LANES,
             lambda v, s, m: qz._dequantize_cuda(v, s, m, qz.DEQUANTIZE_LANES),
             qz.dequantize_int8_reference, dq_laid_out, dq_bytes, n * lanes,
             lambda v, s, m: v.view(-1).to(torch.float32), _dequantize_library)):
        ms, plain_ms = _device_ms(fn, arg_sets), _device_ms(plain, arg_sets)
        stream_ms = _device_ms(stream, arg_sets)
        library_ms = _device_ms(library, arg_sets) if library else None
        if library and not torch.equal(library(*arg_sets[0]), fn(*arg_sets[0])):
            raise AssertionError(f"{kern.name}: the PyTorch call computes another function")
        wrapper_fn, wrapper_sets = wrapped[kern.name]
        wrapper_ms = _device_ms(wrapper_fn, wrapper_sets)
        eager_ms = _eager_ms(wrapper_fn, wrapper_sets)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"kernel {kern.name} {lanes} x {n}: ok (bitwise, every lane the single-lane "
              f"kernels'), device {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, bound "
              f"{bound_ms * 1e3:.2f} us, {100 * bound_ms / ms:.1f}% of bound, same-bytes stream "
              f"{stream_ms * 1e3:.2f} us ({ms / stream_ms:.2f}x)"
              + (f", PyTorch call {library_ms * 1e3:.2f} us" if library else "")
              + f"; the wrapper with its layout {wrapper_ms * 1e3:.2f} us), eager call "
              f"{eager_ms * 1e3:.2f} us")
        results[kern.name] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "stream_ms": stream_ms,
                              "library_ms": library_ms,
                              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    return results


def _check_noise(nz, x, noise, sigmas, what, variant):
    """The noise kernel on x at each sigma, bitwise against the plain
    version, and a check that ``variant`` ran; returns the variant."""
    import torch

    n = x.numel()
    before = nz.variant_counts()
    for s in sigmas:
        got, want = nz.apply_gaussian_noise(x, noise, s), nz.apply_gaussian_noise_reference(
            x, noise, s)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or got.shape != (n,):
            bad = int((got != want).sum())
            raise AssertionError(f"noise kernel at {what}, sigma={s}: {bad} elements not "
                                 "bitwise the plain version")
    ran = _variant_ran(nz, before)[nz.NOISE.name]
    if ran != variant:
        raise AssertionError(f"noise kernel at {what}: ran {ran}, expected {variant}")
    return ran


def phase_noise(nz):
    """The central-DP noise kernel against its plain version: bitwise at the
    DP sigma, at 0.25 and at 0 (the identity); each line names the variant
    that ran.  Then at the SecAgg vector's length with x off a 16-byte line
    (the scalar variant, checked)."""
    import torch

    from fedml_tpu_torch.trust.dp.dp import gaussian_sigma

    dev = torch.device("cuda")
    sigma = gaussian_sigma(DP["epsilon"], DP["delta"], DP["sensitivity"])
    results = {nz.NOISE.name: {"max_abs_err": 0.0}}
    for n in NOISE_LENGTHS:
        # the trust pipeline's and Turbo-Aggregate's draws are flat; the
        # SecAgg path's padded
        shape = (n,) if n in (LDP_LENGTH, TA_LENGTH) else nz.noise_shape(n)
        s_n = 10.0 if n == TA_LENGTH else sigma
        nbytes = 12 * n  # read x, read the first n noise values, write out
        sets = []
        for k in range(max(2, int(3 * L2_BYTES // nbytes) + 1)):
            g = torch.Generator(device=dev)
            g.manual_seed(200 + k)
            sets.append((torch.randn(n, generator=g, device=dev),
                         torch.randn(shape, generator=g, device=dev), s_n))
        x, noise, _ = sets[0]
        sigmas = tuple(dict.fromkeys((s_n, sigma, 0.25, 0.0)))
        ran = _check_noise(nz, x, noise, sigmas, f"n={n}", "vector")
        if not torch.equal(nz.apply_gaussian_noise(x, noise, 0.0), x):
            raise AssertionError(f"noise kernel at n={n}: sigma 0 is not the identity")

        def library(x, noise, s, n=n):
            return torch.add(x, noise.view(-1)[:n], alpha=s)

        ms = _device_ms(nz.apply_gaussian_noise, sets)
        plain_ms = _device_ms(nz.apply_gaussian_noise_reference, sets)
        library_ms = _device_ms(library, sets)
        eager_ms = _eager_ms(nz.apply_gaussian_noise, sets)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, 2 * n / F32_FLOPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"kernel {nz.NOISE.name} n={n} (draw {shape}): ok (bitwise at sigma "
              f"{', '.join(f'{v:.6g}' for v in sigmas)}), device {ms * 1e3:.2f} us (plain "
              f"{plain_ms * 1e3:.2f} us, torch.add {library_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us, "
              f"{100 * bound_ms / ms:.1f}% of bound), eager call {eager_ms * 1e3:.2f} us, "
              f"{ran} variant")
        # the kernel against torch.add in alternating runs: a median and its
        # spread, where one run of each cannot tell a gap from the noise
        runs = {"kernel": [], "torch.add": []}
        for _ in range(NOISE_RUNS):
            runs["kernel"].append(_device_ms(nz.apply_gaussian_noise, sets))
            runs["torch.add"].append(_device_ms(library, sets))
        print(f"kernel {nz.NOISE.name} n={n} against torch.add, {NOISE_RUNS} alternating runs: "
              + ", ".join(f"{k} median {statistics.median(v) * 1e3:.3f} us (min {min(v) * 1e3:.3f}, "
                          f"max {max(v) * 1e3:.3f})" for k, v in runs.items()))
        row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "library_ms": library_ms,
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        if n == SECAGG_LENGTH:
            results[nz.NOISE.name].update(row)
        if n == LDP_LENGTH:
            results[nz.NOISE.name]["ldp_length"] = {"n": n, **row}
        if n == TA_LENGTH:
            results[nz.NOISE.name]["ta_length"] = {"n": n, "sigma": s_n, **row}
    g = torch.Generator(device=dev)
    g.manual_seed(250)
    x = torch.randn(SECAGG_LENGTH, generator=g, device=dev)
    noise = torch.randn(nz.noise_shape(SECAGG_LENGTH), generator=g, device=dev)
    ran = _check_noise(nz, _misaligned(x), noise, (sigma, 0.25), "the SecAgg vector off a "
                       "16-byte line", "scalar")
    print(f"kernel {nz.NOISE.name} n={SECAGG_LENGTH} with x off a 16-byte line: ok (bitwise at "
          f"sigma {sigma:.6g}, 0.25), {ran} variant")
    return results


def phase_fedsgd_check():
    """One FedSGD client gradient (ResNet-20, f32, a 16-sample shard in
    batches of 8) on the card against the same on the CPU, then quantized
    with the same draw on both: int8 levels at most one apart."""
    import torch

    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.fl.local_sgd import make_full_grad_fn
    from fedml_tpu_torch.fl.types import HParams
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.ops import quantize

    model = resnet.resnet20(10, torch.float32)
    gen = torch.Generator()
    gen.manual_seed(1)
    variables = model.init(gen, "cpu")
    x, y = torch.randn((16, 32, 32, 3), generator=gen), torch.randint(0, 10, (16,), generator=gen)
    full_grad = make_full_grad_fn(model, HParams(batch_size=8))
    flats, sent = {}, {}
    for dev in ("cpu", "cuda"):
        v = pt.tree_map(lambda t: t.to(dev), variables)
        flats[dev], _ = weights.flatten_reference(full_grad(v, x.to(dev), y.to(dev)))
    noise = torch.rand(quantize.noise_shape(flats["cpu"].numel()), generator=gen)
    for dev in ("cpu", "cuda"):
        sent[dev] = [t.cpu() for t in quantize.quantize_int8_stochastic(flats[dev], noise.to(dev))[:2]]
    a, b = flats["cpu"], flats["cuda"].cpu()
    if not torch.allclose(b, a, rtol=1e-3, atol=1e-4):
        raise AssertionError(f"FedSGD gradient on the card disagrees with the CPU "
                             f"(max abs diff {float((a - b).abs().max()):.3g})")
    levels = (sent["cuda"][0].int() - sent["cpu"][0].int()).abs()
    if int(levels.max()) > 1 or not torch.allclose(sent["cuda"][1], sent["cpu"][1], rtol=1e-3):
        raise AssertionError("qsgd_int8 of the card's gradient: a level apart by more than one")
    print(f"fedsgd check: resnet20 f32 gradient of 16 samples, card vs CPU within rtol 1e-3 / "
          f"atol 1e-4 (max abs diff {float((a - b).abs().max()):.3g}); quantized with the same "
          f"draw: {int((levels > 0).sum())} of {a.numel()} int8 levels one apart")


def phase_model_check(fb):
    """One fused ResNet-20 train step (f32, batch 8) on the card against the
    same step on the CPU: logits, grads and new batch stats."""
    import torch

    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.models import resnet

    model = resnet.resnet20(10, torch.float32, fused=True)
    gen = torch.Generator()
    gen.manual_seed(0)
    var_cpu = model.init(gen, "cpu")
    x = torch.randn((8, 32, 32, 3), generator=gen)
    outs = {}
    for dev in ("cpu", "cuda"):
        leaves = [t.detach().to(dev, copy=True).requires_grad_(True)
                  for t in pt.tree_leaves(var_cpu["params"])]
        params = pt.tree_unflatten_like(var_cpu["params"], leaves)
        stats = pt.tree_map(lambda t: t.to(dev), var_cpu["batch_stats"])
        logits, new_stats = model.apply({"params": params, "batch_stats": stats}, x.to(dev), True)
        loss = (logits.float() - 1.0).square().mean()
        grads = torch.autograd.grad(loss, leaves)
        outs[dev] = [logits, *grads, *pt.tree_leaves(new_stats)]
    worst = 0.0
    for a, b in zip(outs["cpu"], outs["cuda"]):
        a, b = a.detach(), b.detach().cpu()
        if not torch.allclose(a, b, rtol=1e-3, atol=1e-4):
            raise AssertionError("fused resnet20 step on the card disagrees with the CPU "
                                 f"(max abs diff {float((a - b).abs().max()):.3g})")
        worst = max(worst, float((a - b).abs().max()))
    print(f"model check: fused resnet20 f32 step, card vs CPU within rtol 1e-3 / atol 1e-4 "
          f"(max abs diff {worst:.3g}); launches {fb.launch_counts()}")


class _RoundProbe:
    """Wraps the simulator's metrics logger: at each logged round it records
    the cumulative kernel launch counts and the peak device memory."""

    def __init__(self, inner, counts):
        self.inner, self.counts, self.rows = inner, counts, []

    def log(self, metrics, step=None):
        import torch

        torch.cuda.synchronize()
        self.rows.append((dict(metrics), self.counts(), torch.cuda.max_memory_allocated()))
        self.inner.log(metrics, step)


# the device allocation when the running phase started (``_phase_start``)
_PHASE_BASE = {"bytes": 0}


def _phase_start():
    """Free what earlier phases left (garbage, the caching allocator's
    blocks), reset the peak and note the allocation still held, so a
    phase's peak can be read as its own."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _PHASE_BASE["bytes"] = torch.cuda.memory_allocated()


def _mem(peak=None) -> str:
    """The raw peak (``max_memory_allocated``) and the phase's own: the
    peak less what was allocated when the phase started."""
    import torch

    peak = torch.cuda.max_memory_allocated() if peak is None else peak
    return (f"max_memory_allocated {peak / 2**30:.3f} GiB (this phase's own "
            f"{(peak - _PHASE_BASE['bytes']) / 2**30:.3f} GiB)")


def _all_counts(mods):
    return {k: v for m in mods for k, v in m.launch_counts().items()}


def _reset_counts(mods):
    for m in mods:
        m.reset_launch_counts()


def _check_finite(sim, history, keys):
    import torch

    from fedml_tpu_torch.core import pytree as pt

    for metrics in history:
        for key in keys:
            if not math.isfinite(metrics[key]):
                raise AssertionError(f"round {metrics['round']}: {key} = {metrics[key]}")
    for leaf in pt.tree_leaves(sim.global_vars):
        if not bool(torch.isfinite(leaf).all()):
            raise AssertionError("non-finite global variables after training")


def _own_steps(sim, round_idx):
    """The sampled lanes' own step budgets in a round (``step_mode`` match:
    ``epochs * ceil(count / batch)``, at most the local steps), from the
    host's sampling and counts."""
    import numpy as np

    counts = sim.counts[np.asarray(sim.sampler.sample(round_idx))]
    own = sim.hp.epochs * -(-counts // sim.cfg.batch_size)
    return np.minimum(own, sim.hp.local_steps)


def _recipe(path, dataset=None, **overrides):
    """The recipe at ``path`` through ``fedml_tpu_torch.init`` and
    ``FedMLRunner`` with ``overrides`` (attributes, ``fused_blocks`` to
    ``extra``, on unless given); ``dataset`` reuses an earlier run's data."""
    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = fedml_tpu_torch.init(argv=["--cf", path])
    cfg.extra["fused_blocks"] = overrides.pop("fused_blocks", True)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return FedMLRunner(cfg, dataset=dataset)


def _flagship(dataset=None, **overrides):
    return _recipe(FLAGSHIP, dataset, **overrides)


def phase_main_path(mods):
    """The flagship on MESH, fused: every fused kernel in its lanes variant,
    each fused site once a batched step (the steps the longest lane budget
    takes), never once a client; the single-lane backward never."""
    import torch

    fb = mods[0]
    t0 = time.perf_counter()
    runner = _flagship(comm_round=ROUNDS, frequency_of_the_test=1)
    sim, cfg = runner.runner, runner.cfg
    print(f"main path: set-up {time.perf_counter() - t0:.1f} s (data {sim.dataset.train_num}/"
          f"{sim.dataset.test_num}, {sim.dataset.n_clients} clients, capacity {sim.capacity}, "
          f"{cfg.client_num_per_round}/round, batch {cfg.batch_size}, {cfg.compute_dtype}, "
          f"backend {sim.backend}, fused)")
    if sim.backend != "MESH":
        raise AssertionError(f"the flagship recipe ran on {sim.backend}, not MESH")
    probe = _RoundProbe(sim.logger, lambda: _all_counts(mods))
    sim.logger = probe
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(mods)
    history = runner.run()
    torch.cuda.synchronize()
    counts = _all_counts(mods)
    prev = {k: 0 for k in counts}
    for metrics, cum, mem in probe.rows:
        r = metrics["round"]
        own = _own_steps(sim, r)
        steps = int(own.max())
        computed = metrics["num_steps"] * cfg.client_num_per_round
        delta = {k: cum[k] - prev[k] for k in cum}
        prev = cum
        print(f"round {r}: {metrics['round_time_s']:.3f} s, "
              f"{int(own.sum()) * cfg.batch_size / metrics['round_time_s']:.0f} trained samples/s, "
              f"{steps} batched steps of up to {len(own)} lanes, lane-steps computed "
              f"{computed:.0f} against the lanes' own steps {int(own.sum())} (every lane every "
              f"step: {len(own) * sim.hp.local_steps}), train_loss {metrics['train_loss']:.4f}, "
              f"test_acc {metrics.get('test_acc', float('nan')):.4f}, "
              f"{_mem(mem)}, launches {delta}")
        if round(computed) != int(own.sum()):
            raise AssertionError(f"round {r}: {computed} lane-steps, the budgets sum to "
                                 f"{int(own.sum())}")
        for k, lk in zip(fb.KERNELS, fb.LANE_KERNELS):
            if delta[lk.name] != SITES[k.name] * steps:
                raise AssertionError(f"round {r}: {lk.name} launched {delta[lk.name]} times, "
                                     f"expected {SITES[k.name]} sites x {steps} batched steps")
        for k in (fb.BWD, fb.BWD_RES):
            if delta[k.name]:
                raise AssertionError(f"round {r}: {k.name} launched {delta[k.name]} times: "
                                     "a client trained alone")
    if len(history) != ROUNDS:
        raise AssertionError(f"expected {ROUNDS} rounds, got {len(history)}")
    _check_finite(sim, history, ("train_loss", "test_loss", "test_acc"))
    _MAIN_ROUNDS[:] = [m["round_time_s"] for m in history]
    return counts, runner.dataset


def phase_fused_ab(dataset):
    """Fused against unfused MESH rounds of the flagship, the host bound
    gone: after a warm-up round each, AB_PAIRS pairs of the same rounds
    (same data, sampling and initial weights), the order alternating."""
    import statistics

    import torch

    sims = {fused: _flagship(dataset, fused_blocks=fused, metrics_jsonl_path="").runner
            for fused in (True, False)}
    for sim in sims.values():
        sim.run_round()
    torch.cuda.synchronize()
    times = {True: [], False: []}
    for i in range(AB_PAIRS):
        for fused in ((True, False) if i % 2 == 0 else (False, True)):
            sim = sims[fused]
            steps = int(_own_steps(sim, sim.round_idx).max())
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            metrics = sim.run_round()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            times[fused].append(dt / steps)
            print(f"fused A/B pair {i} fused={fused} round {sim.round_idx - 1}: {dt:.3f} s, "
                  f"{steps} batched steps, {dt / steps * 1e3:.2f} ms a batched step, train_loss "
                  f"{metrics['train_loss']:.4f}, {_mem()}")
    for fused, per_step in times.items():
        print(f"fused A/B fused={fused}: median {statistics.median(per_step) * 1e3:.2f} ms a "
              f"batched step over {AB_PAIRS} rounds (min {min(per_step) * 1e3:.2f}, max "
              f"{max(per_step) * 1e3:.2f})")


def _largest_difference(a, b):
    """(largest |a - b| over the leaves, the largest excess over the MESH-vs-sp
    tolerance)."""
    from fedml_tpu_torch.core import pytree as pt

    worst, excess = 0.0, -math.inf
    for x, y in zip(pt.tree_leaves(a), pt.tree_leaves(b)):
        diff = (x - y).abs()
        worst = max(worst, float(diff.max()))
        excess = max(excess, float((diff - MESH_SP_ATOL - MESH_SP_RTOL * y.abs()).max()))
    return worst, excess


def phase_mesh_vs_sp(dataset):
    """MESH against sp in f32 (TF32 off) at full width and data, with
    SP_CHECK_CLIENTS of the flagship's clients sampled.  First one local step
    of each sampled client: the lanes' one batched step against each client's
    single-lane step from the same weights and batch, held to the
    reference's own MESH-vs-SP tolerance.  Then one whole round on each
    backend from the same initial weights, and beside it the sp round from
    initial weights one f32 ulp apart (each weight scaled by 1 +- 2^-23): the
    round's f32 trajectory moves by as much as MESH and sp differ, so the
    round is held to that spread, and the largest difference printed."""
    import dataclasses

    import torch

    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.fl.local_sgd import make_batched_local_train_fn, make_local_train_fn

    sims = {}
    for name, backend in (("sp", "sp"), ("MESH", "MESH"), ("sp, weights an ulp apart", "sp")):
        sim = _flagship(dataset, backend_sim=backend, compute_dtype="float32",
                        client_num_per_round=SP_CHECK_CLIENTS, metrics_jsonl_path="").runner
        if name.startswith("sp, "):
            gen = torch.Generator(device=sim.device)
            gen.manual_seed(7)
            sim.global_vars = pt.tree_map(lambda t: t * (1 + 2.0 ** -23 * (2 * torch.randint(
                0, 2, t.shape, generator=gen, device=t.device) - 1)), sim.global_vars)
        sims[name] = sim

    sim = sims["MESH"]
    sampled = sim.sampler.sample(0)
    clients = torch.as_tensor(sampled, device=sim.device)
    perms = torch.stack([sim.sampler.perms(0, int(c), sim.hp.epochs, sim.capacity)
                         for c in sampled]).to(sim.device)
    one_step = dataclasses.replace(sim.hp, steps_per_epoch=1)
    lanes = pt.tree_map(lambda t: t.unsqueeze(0).expand((len(sampled),) + t.shape),
                        sim.global_vars)
    batched, _ = make_batched_local_train_fn(sim.model, one_step)(
        lanes, *sim._data, clients, sim.counts[sampled], perms)
    single = make_local_train_fn(sim.model, one_step)
    step_worst, step_excess = 0.0, -math.inf
    for lane, c in enumerate(sampled):
        alone, _ = single(sim.global_vars, sim._data[0][c], sim._data[1][c], int(sim.counts[c]),
                          None, perms=perms[lane])
        worst, excess = _largest_difference(pt.tree_map(lambda t: t[lane], batched), alone)
        step_worst, step_excess = max(step_worst, worst), max(step_excess, excess)
    print(f"mesh vs sp: one local step of {len(sampled)} lanes batched against each alone: "
          f"largest difference {step_worst:.3g} (rtol {MESH_SP_RTOL}, atol {MESH_SP_ATOL}: "
          f"{'within' if step_excess <= 0 else 'BEYOND'})")
    if step_excess > 0:
        raise AssertionError(f"a batched local step differs from the lanes' own steps by "
                             f"{step_worst:.3g}, beyond rtol {MESH_SP_RTOL} / atol {MESH_SP_ATOL}")

    for name, sim in sims.items():
        t0 = time.perf_counter()
        metrics = sim.run_round()
        torch.cuda.synchronize()
        print(f"mesh vs sp: {name}: f32 round of {SP_CHECK_CLIENTS} clients "
              f"{time.perf_counter() - t0:.3f} s, train_loss {metrics['train_loss']:.6f}")
    worst, excess = _largest_difference(sims["MESH"].global_vars, sims["sp"].global_vars)
    spread, _ = _largest_difference(sims["sp, weights an ulp apart"].global_vars,
                                    sims["sp"].global_vars)
    print(f"mesh vs sp: one round: largest difference of the globals {worst:.3g} (rtol "
          f"{MESH_SP_RTOL}, atol {MESH_SP_ATOL}: {'within' if excess <= 0 else 'beyond'}); sp "
          f"against itself from weights an ulp apart: {spread:.3g}")
    if excess > 0 and worst > ROUND_SPREADS * spread:
        raise AssertionError(f"MESH and sp globals differ by {worst:.3g} after a round, beyond "
                             f"rtol {MESH_SP_RTOL} / atol {MESH_SP_ATOL} and beyond "
                             f"{ROUND_SPREADS} x sp's own one-ulp spread {spread:.3g}")


def _fedsgd(dataset=None, **overrides):
    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = fedml_tpu_torch.init(argv=["--cf", FEDSGD])
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return FedMLRunner(cfg, dataset=dataset)


def phase_fedsgd(mods, qz):
    """FedSGD on MESH with ``qsgd_int8``: the 16 lanes' gradients in
    lane-batched steps, quantize and dequantize once a round for all of
    them; then one sp round (the single-lane kernels, once a client), then
    one MESH round of the recipe's own ``eftopk``.  Returns the counts of
    the MESH rounds and of the sp round."""
    import torch

    t0 = time.perf_counter()
    runner = _fedsgd(comm_round=ROUNDS, frequency_of_the_test=1, compression="qsgd_int8")
    sim, cfg = runner.runner, runner.cfg
    clients = cfg.client_num_per_round
    batches = clients * (sim.capacity // cfg.batch_size)
    print(f"fedsgd path: set-up {time.perf_counter() - t0:.1f} s (data {sim.dataset.train_num}/"
          f"{sim.dataset.test_num}, {sim.dataset.n_clients} clients, capacity {sim.capacity}, "
          f"{clients}/round, batch {cfg.batch_size}, {cfg.compute_dtype}, compression "
          f"{cfg.compression}, backend {sim.backend}, {sim.capacity // cfg.batch_size} batched "
          f"steps of {clients} lanes a round)")
    if sim.backend != "MESH":
        raise AssertionError(f"the FedSGD recipe ran on {sim.backend}, not MESH")
    probe = _RoundProbe(sim.logger, lambda: _all_counts(mods))
    sim.logger = probe
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(mods)
    history = runner.run()
    torch.cuda.synchronize()
    counts = _all_counts(mods)
    prev = {k: 0 for k in counts}
    for metrics, cum, mem in probe.rows:
        delta = {k: cum[k] - prev[k] for k in cum}
        prev = cum
        print(f"round {metrics['round']}: {metrics['round_time_s']:.3f} s, "
              f"{batches * cfg.batch_size / metrics['round_time_s']:.0f} gradient samples/s, "
              f"test_loss {metrics['test_loss']:.4f}, test_acc {metrics['test_acc']:.4f}, "
              f"{_mem(mem)}, launches {delta}")
        for k in qz.LANE_KERNELS:
            if delta[k.name] != 1:
                raise AssertionError(f"{k.name}: {delta[k.name]} launches in round "
                                     f"{metrics['round']}, expected 1 for all {clients} lanes")
        for k in qz.KERNELS:
            if delta[k.name]:
                raise AssertionError(f"{k.name}: a client quantized alone in round "
                                     f"{metrics['round']}")
    if len(history) != ROUNDS:
        raise AssertionError(f"expected {ROUNDS} rounds, got {len(history)}")
    _check_finite(sim, history, ("test_loss", "test_acc"))

    sp = _fedsgd(runner.dataset, comm_round=1, frequency_of_the_test=1, compression="qsgd_int8",
                 backend_sim="sp")
    _reset_counts(mods)
    t0 = time.perf_counter()
    history = sp.run()
    torch.cuda.synchronize()
    sp_counts = _all_counts(mods)
    print(f"fedsgd sp (the sequential twin): 1 round in {time.perf_counter() - t0:.3f} s, "
          f"test_loss {history[-1]['test_loss']:.4f}, launches {sp_counts}")
    for k in qz.KERNELS:
        if sp_counts[k.name] != clients:
            raise AssertionError(f"{k.name}: {sp_counts[k.name]} launches in the sp round, "
                                 f"expected {clients}")
    _check_finite(sp.runner, history, ("test_loss", "test_acc"))

    runner = _fedsgd(runner.dataset, comm_round=1, frequency_of_the_test=1)
    t0 = time.perf_counter()
    history = runner.run()
    torch.cuda.synchronize()
    sim = runner.runner
    _check_finite(sim, history, ("test_loss", "test_acc"))
    rows = sim.client_states.abs().sum(1)
    if not bool((rows > 0).all()) or not bool(torch.isfinite(sim.client_states).all()):
        raise AssertionError("eftopk: a client's residual is zero or not finite after its round")
    print(f"fedsgd eftopk (the recipe's own, {sim.backend}): 1 round in "
          f"{time.perf_counter() - t0:.3f} s, test_loss {history[-1]['test_loss']:.4f}, "
          f"test_acc {history[-1]['test_acc']:.4f}, residuals {tuple(sim.client_states.shape)} "
          f"non-zero for all {rows.numel()} clients")
    return counts, sp_counts


class _SecAggProbe(_RoundProbe):
    """The round probe of the cross-silo server: also the round's payload
    counters, the noise kernel's launches by variant, the round delta
    before its clip (its L2 norm and the BN running statistics' share of
    its squared norm) and after it (its norm), read after the timed
    finalize, and at round 0 the clipped global before its noise and the
    noised global (flat, on the card)."""

    def __init__(self, inner, counts, aggregator, nz):
        import torch

        from fedml_tpu_torch import weights

        super().__init__(inner, counts)
        self.aggregator, self.nz, self.payload, self.round0 = aggregator, nz, [], None
        self.variants, self.deltas = [], []
        self.prev = weights.flatten_reference(aggregator.global_vars)[0].clone()
        # sorted keys put the BN statistics first in the reference's flat layout
        stats = weights.flatten_reference({"batch_stats": aggregator.global_vars["batch_stats"]})[0]
        if not torch.equal(self.prev[:stats.numel()], stats):
            raise AssertionError("the BN statistics are not the head of the flat global")
        self.n_stats = stats.numel()

    def log(self, metrics, step=None):
        from fedml_tpu_torch import weights
        from fedml_tpu_torch.comm import codecs

        agg = self.aggregator
        self.payload.append(codecs.payload_counters().get("secagg_dense", {}).get("wire_bytes", 0))
        self.variants.append(self.nz.variant_counts()[self.nz.NOISE.name])
        delta = agg.dp_delta.double()
        sq = float(delta.square().sum())
        self.deltas.append((sq ** 0.5, float(delta[:self.n_stats].square().sum()) / sq,
                            float((agg.dp_pre_noise - self.prev).double().norm())))
        flat = weights.flatten_reference(agg.global_vars)[0]
        if self.round0 is None:
            self.round0 = (agg.dp_pre_noise.clone(), flat.clone())
        self.prev = flat.clone()
        super().log(metrics, step)


def phase_cross_silo(mods, nz):
    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.comm import codecs
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.runner import FedMLRunner

    t0 = time.perf_counter()
    cfg = fedml_tpu_torch.init(argv=["--cf", FLAGSHIP])
    cfg.training_type, cfg.role, cfg.backend = "cross_silo", "server", "INPROC"
    cfg.client_num_in_total = cfg.client_num_per_round = SILOS
    cfg.synthetic_train_size = SILO_TRAIN_SIZE
    cfg.comm_round = SILO_ROUNDS
    cfg.frequency_of_the_test = 1
    cfg.enable_secagg = True
    for k, v in DP.items():
        setattr(cfg, k, v)
    cfg.extra.update(secagg_method="shamir", secagg_stream=True, fused_blocks=True)
    runner = FedMLRunner(cfg)
    group = runner.runner
    t1 = time.perf_counter()
    group.setup()
    torch.cuda.synchronize()
    server, clients = group.server, group.clients
    agg = server.aggregator
    steps = sum(c.trainer.trained_samples for c in clients) // cfg.batch_size
    print(f"cross-silo path: set-up {time.perf_counter() - t0:.1f} s (data and model "
          f"{t1 - t0:.1f} s, server + {len(clients)} silos to the card "
          f"{time.perf_counter() - t1:.1f} s; data {runner.dataset.train_num}/"
          f"{runner.dataset.test_num}, silo shards {[c.trainer.count for c in clients]}, "
          f"{steps} local steps a round, batch {cfg.batch_size}, {cfg.compute_dtype}, "
          f"SecAgg T={agg.t} over {agg.model_dim} elements ({agg.ring.bits}-bit ring, "
          f"{agg.ring.frac_bits} fractional bits), DP sigma {agg._dp.sigma():.6g})")
    probe = _SecAggProbe(server.logger, lambda: _all_counts(mods + (nz,)), agg, nz)
    server.logger = probe
    torch.cuda.reset_peak_memory_stats()
    before = codecs.payload_counters().get("secagg_dense", {}).get("wire_bytes", 0)
    _reset_counts(mods + (nz,))
    history = runner.run()
    torch.cuda.synchronize()
    counts = _all_counts(mods + (nz,))
    prev, prev_bytes = {k: 0 for k in counts}, before
    samples = sum(c.trainer.trained_samples for c in clients)
    prev_vector = 0
    for (metrics, cum, mem), wire, variants, (norm, bn_share, clipped) in zip(
            probe.rows, probe.payload, probe.variants, probe.deltas):
        delta = {k: cum[k] - prev[k] for k in cum}
        prev = cum
        print(f"round {metrics['round']}: {metrics['round_time_s']:.3f} s, "
              f"{samples / metrics['round_time_s']:.0f} trained samples/s, test_loss "
              f"{metrics['test_loss']:.4f}, test_acc {metrics['test_acc']:.4f}, finalize "
              f"(unmask + clip + noise) {1e3 * metrics['finalize_time_s']:.1f} ms, uploads "
              f"{wire - prev_bytes} bytes (frames {metrics['upload_bytes']}), "
              f"{_mem(mem)}, launches {delta}")
        print(f"round {metrics['round']} delta: L2 norm before the clip {norm:.6g}, BN "
              f"statistics' share of its squared norm {bn_share:.6g} ({probe.n_stats} of "
              f"{agg.model_dim} elements), after the clip {clipped:.6g} (clip "
              f"{DP['clipping_norm']})")
        prev_bytes = wire
        if delta[nz.NOISE.name] != 1 or variants["vector"] != prev_vector + 1:
            raise AssertionError(f"round {metrics['round']}: {delta[nz.NOISE.name]} noise "
                                 f"launches ({variants}), expected 1 of the vector variant")
        prev_vector = variants["vector"]
    print(f"payload counters: {codecs.payload_counters()}")
    if len(history) != SILO_ROUNDS or counts[nz.NOISE.name] != SILO_ROUNDS:
        raise AssertionError(f"expected {SILO_ROUNDS} rounds and noise launches, got "
                             f"{len(history)} and {counts[nz.NOISE.name]}")
    bad = [k.name for k in mods[0].KERNELS if counts[k.name] == 0]
    if bad:
        raise AssertionError(f"fused kernels never launched on the cross-silo path: {bad}")
    if not agg.field_stream or agg.peak_buffered_updates > 2:
        raise AssertionError(f"streaming fold: field_stream {agg.field_stream}, peak buffered "
                             f"{agg.peak_buffered_updates}")
    for metrics in history:
        for key in ("test_loss", "test_acc"):
            if not math.isfinite(metrics[key]):
                raise AssertionError(f"round {metrics['round']}: {key} = {metrics[key]}")
    if not all(bool(torch.isfinite(leaf).all()) for leaf in pt.tree_leaves(agg.global_vars)):
        raise AssertionError("non-finite global variables after the cross-silo run")
    pre, post = probe.round0
    draw = agg.noise_sampler.gaussian(0, nz.noise_shape(pre.numel()), pre.device)
    if not torch.equal(post, nz.apply_gaussian_noise_reference(pre, draw, agg._dp.sigma())):
        raise AssertionError("round 0: the noised global is not the plain version's")
    if torch.equal(post, pre):
        raise AssertionError("round 0: the noise did not land (noised == clip-only global)")
    print(f"cross-silo check: round 0's global bitwise the plain noise of its clipped global, "
          f"max |noise| applied {float((post - pre).abs().max()):.3g}; peak buffered "
          f"{agg.peak_buffered_updates}; every client trained {[c.rounds_trained for c in clients]}")
    return counts, runner.dataset


# -- phase 9: compressed cross-silo uploads ------------------------------------

def _wire_cfg(codec, secagg=False, rounds=1):
    """The flagship recipe as phase 5 runs it (4 silos, all in every round,
    fused blocks), with ``extra.comm_compression`` set; ``secagg`` adds
    phase 5's Shamir SecAgg with the streaming fold and central DP."""
    import fedml_tpu_torch

    cfg = fedml_tpu_torch.init(argv=["--cf", FLAGSHIP])
    cfg.training_type, cfg.role, cfg.backend = "cross_silo", "server", "INPROC"
    cfg.client_num_in_total = cfg.client_num_per_round = SILOS
    cfg.comm_round = rounds
    cfg.frequency_of_the_test = 1
    cfg.extra.update(fused_blocks=True, comm_compression=codec)
    if secagg:
        cfg.enable_secagg = True
        for k, v in DP.items():
            setattr(cfg, k, v)
        cfg.extra.update(secagg_method="shamir", secagg_stream=True)
    return cfg


def _upload_bytes(tree, codec):
    """Payload bytes of one compressed upload of ``tree`` (flax layout),
    from its shapes: leaves of 1024 elements or more compress (qsgd8: a f32
    scale and 1024 int8 values a block; topk: k = int(0.01 n) int32 / f32
    pairs), the rest ride raw."""
    total = 0
    for leaf in tree:
        n = leaf.numel()
        if n < 1024:
            total += n * leaf.element_size()
        elif codec == "qsgd8":
            total += -(-n // 1024) * (4 + 1024)
        else:
            total += max(1, int(0.01 * n)) * 8
    return total


class _WireProbe(_RoundProbe):
    """The round probe of phase 9: also the payload counters and the
    launches by kernel and variant at each round, and the round's global
    (flat clone) for the fold check."""

    def __init__(self, inner, counts, payload, aggregator):
        super().__init__(inner, counts)
        self.payload, self.aggregator, self.wire, self.globals = payload, aggregator, [], []

    def log(self, metrics, step=None):
        from fedml_tpu_torch.core import pytree as pt

        self.wire.append(self.payload())
        self.globals.append(pt.tree_map(lambda t: t.clone(), self.aggregator.global_vars))
        super().log(metrics, step)


def _host_fold(frames, base, total_w, w_delta):
    """The reference's host fold (``HostStreamAccumulator``) in numpy over
    ``[(weight, decoded leaves)]``: ``sum += f32(w) * leaf``, then
    ``((sum + f32(w_delta) * base) / f32(total)).astype(dtype)``."""
    import numpy as np

    sums = [np.zeros(b.shape, np.float32) for b in base]
    for w, arrays in frames:
        for i, arr in enumerate(arrays):
            sums[i] += np.float32(w) * np.asarray(arr, dtype=np.float32)
    out = []
    for acc, b in zip(sums, base):
        if w_delta:
            acc = acc + np.float32(w_delta) * np.asarray(b, dtype=np.float32)
        out.append((acc / np.float32(total_w)).astype(b.dtype))
    return sums, out


def phase_wire(mods, qz, nz, dataset):
    """Phase 9: the compressed cross-silo path, three forms ((a) 2 rounds, (b)
    and (c) 1 each), then the card-against-CPU checks of the upload frame
    and of the fold."""
    import numpy as np
    import torch

    from fedml_tpu_torch import weights
    from fedml_tpu_torch.comm import codecs, wire
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.cross_silo import client as client_mod
    from fedml_tpu_torch.runner import FedMLRunner

    all_mods = mods + (nz,)
    forms = (("a", "qsgd8", False), ("b", "topk", False), ("c", "qsgd8", True))
    results, counts_by_form, captured = {}, {}, {}
    for form, codec, secagg in forms:
        runner = group = server = clients = agg = probe = None  # free the last form's
        _phase_start()
        runner = FedMLRunner(_wire_cfg(codec, secagg, WIRE_FORM_ROUNDS[form]), dataset=dataset)
        group = runner.runner
        t1 = time.perf_counter()
        group.setup()
        server, clients = group.server, group.clients
        agg = server.aggregator
        tmpl = wire.flatten_with_skeleton(weights.tensors_to_flax(agg.global_vars))[1]
        raw_bytes = sum(t.numel() * t.element_size() for t in tmpl)
        key = f"secagg_{codec}" if secagg else codec
        if secagg:
            expected = 2 * agg.model_dim
            if agg.ring.bits != 11 or agg.ring.codec != "qsgd8":
                raise AssertionError(f"form (c): ring {agg.ring.codec} of {agg.ring.bits} bits, "
                                     "expected the 11-bit qsgd8 ring")
        else:
            expected = _upload_bytes(tmpl, codec)
            if not agg.stream_mode:
                raise AssertionError(f"form ({form}): the server's streaming fold is off")
        want = {"qsgd8": 288784, "topk": 36680}[codec] if not secagg else 542196
        if expected != want:
            raise AssertionError(f"form ({form}): {expected} bytes an upload from the shapes, "
                                 f"{want} expected")
        if form == "a":
            # one silo's round-0 upload inputs (the trained and the received
            # global, on the card) and the server's round-1 frames, kept for
            # the checks after the runs
            rank1 = clients[0]
            inner = rank1.upload_payload

            def keep_inputs(new_vars, global_vars, round_idx, inner=inner):
                if round_idx == 0:
                    captured["upload"] = (pt.tree_map(torch.clone, new_vars),
                                          pt.tree_map(torch.clone, global_vars))
                return inner(new_vars, global_vars, round_idx)

            rank1.upload_payload = keep_inputs
            ingest = agg.ingest_streaming

            def keep_frames(cid, msg, n, is_delta, ingest=ingest, server=server):
                if server.round_idx == 1:
                    captured.setdefault("frames", []).append((cid, msg, n, is_delta))
                return ingest(cid, msg, n, is_delta)

            agg.ingest_streaming = keep_frames

        def payload(key=key):
            return codecs.payload_counters().get(key, {}).get("wire_bytes", 0)

        def counts():
            return (_all_counts(all_mods), {k: dict(v) for k, v in qz.variant_counts().items()},
                    nz.variant_counts()[nz.NOISE.name])

        probe = _WireProbe(server.logger, counts, payload, agg)
        server.logger = probe
        init = pt.tree_map(torch.clone, agg.global_vars)
        print(f"wire path ({form}) {codec}{' under SecAgg + CDP' if secagg else ''}: set-up "
              f"{time.perf_counter() - t1:.1f} s, {len(tmpl)} leaves, {raw_bytes} raw bytes, "
              f"{expected} bytes an upload ({raw_bytes / expected:.3f}x)")
        torch.cuda.reset_peak_memory_stats()
        before = payload()
        _reset_counts(all_mods)
        history = runner.run()
        torch.cuda.synchronize()
        counts_by_form[form] = _all_counts(all_mods)
        prev_counts, prev_var, prev_noise, prev_bytes = ({k: 0 for k in counts_by_form[form]},
                                                         None, 0, before)
        for (metrics, (cum, var, noise_var), mem), wire_b in zip(probe.rows, probe.wire):
            delta = {k: cum[k] - prev_counts[k] for k in cum if cum[k] - prev_counts[k]}
            prev_counts, r = cum, metrics["round"]
            per_upload = (wire_b - prev_bytes) / SILOS
            prev_bytes = wire_b
            fin = metrics.get("finalize_time_s", 0.0)
            print(f"round {r} ({form}): {metrics['round_time_s']:.3f} s, upload "
                  f"{per_upload:.0f} bytes a silo ({raw_bytes / per_upload:.3f}x; frames "
                  f"{metrics['upload_bytes']} bytes in all), aggregate "
                  f"{1e3 * metrics['aggregate_time_s']:.1f} ms (fold "
                  f"{1e3 * metrics.get('fold_time_s', 0.0):.1f} ms host, finalize "
                  f"{1e3 * fin:.1f} ms), test_acc {metrics['test_acc']:.4f}, test_loss "
                  f"{metrics['test_loss']:.4f}, {_mem(mem)}, launches {delta}, variants "
                  f"quantize {var[qz.QUANTIZE.name]} dequantize {var[qz.DEQUANTIZE.name]} "
                  f"noise {noise_var}")
            if per_upload != expected:
                raise AssertionError(f"round {r} ({form}): {per_upload} bytes an upload, "
                                     f"{expected} expected")
            quant, dequant = delta.get(qz.QUANTIZE.name, 0), delta.get(qz.DEQUANTIZE.name, 0)
            leaves = sum(1 for t in tmpl if t.numel() >= 1024) if form == "a" else 0
            if quant != leaves * SILOS or dequant != leaves * SILOS:
                raise AssertionError(f"round {r} ({form}): quantize {quant} / dequantize "
                                     f"{dequant} launches, expected {leaves} an upload x {SILOS}")
            if secagg and delta.get(nz.NOISE.name, 0) != 1:
                raise AssertionError(f"round {r} ({form}): {delta.get(nz.NOISE.name, 0)} noise "
                                     "launches, expected 1")
        if len(history) != WIRE_FORM_ROUNDS[form] or agg.peak_buffered_updates > 2:
            raise AssertionError(f"form ({form}): {len(history)} rounds, peak buffered "
                                 f"{agg.peak_buffered_updates}")
        for metrics in history:
            for k in ("test_loss", "test_acc"):
                if not math.isfinite(metrics[k]):
                    raise AssertionError(f"round {metrics['round']} ({form}): {k} = {metrics[k]}")
        if not all(bool(torch.isfinite(leaf).all()) for leaf in pt.tree_leaves(agg.global_vars)):
            raise AssertionError(f"form ({form}): non-finite global variables")
        bad = [k.name for k in mods[0].KERNELS if counts_by_form[form][k.name] == 0]
        if bad:
            raise AssertionError(f"form ({form}): fused kernels never launched: {bad}")
        print(f"wire path ({form}): peak buffered {agg.peak_buffered_updates}, every silo "
              f"trained {[c.rounds_trained for c in clients]}, launches "
              f"{ {k: v for k, v in counts_by_form[form].items() if v} }")
        results[form] = (init, probe.globals, agg.global_vars)
    print(f"payload counters: {codecs.payload_counters()}")

    # (i) one silo's round-0 qsgd8 frame: the card's against the plain
    # versions' on the CPU, from the same delta and the same draws
    new_vars, global_vars = captured["upload"]
    delta = weights.tensors_to_flax(pt.tree_map(client_mod._leaf_delta, new_vars, global_vars))
    gen = torch.Generator().manual_seed(9)
    draws = {}

    def uniform(i, shape, device):
        if i not in draws:
            draws[i] = torch.rand(shape, generator=gen)
        return draws[i].to(device)

    frames = []
    for tree in (delta, pt.tree_map(lambda t: t.cpu(), delta)):
        before = qz.launch_counts()[qz.QUANTIZE.name]
        out, _, _ = codecs.compress_pytree(tree, "qsgd8", uniform=uniform)
        frames.append((wire.encode_pytree({"model_params": out}),
                       qz.launch_counts()[qz.QUANTIZE.name] - before))
    if frames[0][0] != frames[1][0] or frames[0][1] != 18 or frames[1][1] != 0:
        raise AssertionError(f"check (i): the card's qsgd8 frame ({len(frames[0][0])} bytes, "
                             f"{frames[0][1]} launches) is not the CPU's ({len(frames[1][0])} "
                             "bytes)")
    print(f"wire check (i): silo 1's round-0 qsgd8 frame, {len(frames[0][0])} bytes, built on "
          f"the card (18 quantize launches) byte-identical to the plain versions' on the CPU")

    # (ii) round 1's four frames folded again on the card against the numpy
    # host fold: kernel 6 against numpy's decode at each leaf length, the
    # sums, the division and the new global bitwise; the run's own global too
    from fedml_tpu_torch.parallel.stream_fold import DeviceStreamAccumulator, decode_leaf

    init, globals_after, final = results["a"]
    base = wire.flatten_with_skeleton(weights.tensors_to_flax(globals_after[0]))[1]
    kept = captured["frames"]
    if len(kept) != SILOS:
        raise AssertionError(f"check (ii): {len(kept)} frames kept, expected {SILOS}")
    acc = DeviceStreamAccumulator(base, base[0].device)
    host, lengths = [], set()
    total_w = w_delta = 0.0
    for cid, msg, n, is_delta in kept:
        arrays = [arr for _, _, arr in msg.tensor_frame()[1]]  # numpy's decode
        for i, spec, segs in msg.tensor_segments()[1]:
            x = decode_leaf(spec, segs, acc.device)
            if spec.get("codec") == "qsgd8":
                lengths.add(int(spec["length"]))
                if not np.array_equal(x.cpu().numpy(), arrays[i]):
                    raise AssertionError(f"check (ii): dequantize kernel at {spec['length']} "
                                         "is not numpy's decode")
            acc.fold_leaf(i, n, x)
        host.append((n, arrays))
        total_w += n
        w_delta += n if is_delta else 0.0
    sums_np, out_np = _host_fold(host, [b.cpu().numpy() for b in base], total_w, w_delta)
    out = acc.finalize(base, w_delta, total_w)
    for i, (s, s_np) in enumerate(zip(acc.sums(), sums_np)):
        if not np.array_equal(s.cpu().numpy(), s_np):
            raise AssertionError(f"check (ii): leaf {i}'s device sum is not the host fold's")
    for i, (o, o_np) in enumerate(zip(out, out_np)):
        if not np.array_equal(o.cpu().numpy(), o_np):
            raise AssertionError(f"check (ii): leaf {i}'s finalized leaf (the division) is not "
                                 "numpy's")
    run_final = wire.flatten_with_skeleton(weights.tensors_to_flax(final))[1]
    if not all(torch.equal(a, b) for a, b in zip(out, run_final)):
        raise AssertionError("check (ii): the run's round-1 global is not the fold of its frames")
    print(f"wire check (ii): round 1's {SILOS} frames folded on the card bitwise the numpy host "
          f"fold (sums, division, {len(out)} leaves) and the run's global; dequantize kernel "
          f"bitwise numpy's decode at lengths {sorted(lengths)}")
    return counts_by_form

def _check_lane_sites(fb, delta, steps, what):
    """Each fused site launched once a batched step, in its lanes variant."""
    for k, lk in zip(fb.KERNELS, fb.LANE_KERNELS):
        if delta[lk.name] != SITES[k.name] * steps:
            raise AssertionError(f"{what}: {lk.name} launched {delta[lk.name]} times, expected "
                                 f"{SITES[k.name]} sites x {steps} batched steps")


def _eval_batches(sim):
    """Batches of one global test evaluation (single-lane forwards)."""
    return sim._test[0].shape[0] // min(256, max(32, sim.cfg.test_batch_size))


def phase_fedopt(mods):
    """The FedOpt recipe as shipped (64 clients, 16 a round, batch 64, bf16,
    server Adam) with fused blocks on MESH: each fused site once a batched
    step in its lanes variant, the single-lane kernels only in the test
    evaluation's forward; then one profiled round (device busy share), then
    one sp round.  Returns the dataset."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fedml_tpu_torch.obs.profile_round import busy_us

    fb = mods[0]
    t0 = time.perf_counter()
    runner = _recipe(FEDOPT, comm_round=ROUNDS, frequency_of_the_test=1)
    sim, cfg = runner.runner, runner.cfg
    print(f"fedopt path: set-up {time.perf_counter() - t0:.1f} s (data {sim.dataset.train_num}/"
          f"{sim.dataset.test_num}, {sim.dataset.n_clients} clients, capacity {sim.capacity}, "
          f"{cfg.client_num_per_round}/round, batch {cfg.batch_size}, {cfg.compute_dtype}, "
          f"backend {sim.backend}, {cfg.federated_optimizer} with server {cfg.server_optimizer} "
          f"lr {cfg.server_lr}, fused)")
    if sim.backend != "MESH" or sim.algorithm.name != "FedOpt":
        raise AssertionError(f"the FedOpt recipe ran {sim.algorithm.name} on {sim.backend}")
    probe = _RoundProbe(sim.logger, lambda: _all_counts(mods))
    sim.logger = probe
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(mods)
    history = runner.run()
    torch.cuda.synchronize()
    counts = _all_counts(mods)
    evals, prev = _eval_batches(sim), {k: 0 for k in counts}
    for metrics, cum, mem in probe.rows:
        r = metrics["round"]
        own = _own_steps(sim, r)
        steps = int(own.max())
        delta = {k: cum[k] - prev[k] for k in cum}
        prev = cum
        print(f"fedopt round {r}: {metrics['round_time_s']:.3f} s, "
              f"{int(own.sum()) * cfg.batch_size / metrics['round_time_s']:.0f} trained samples/s, "
              f"{steps} batched steps of up to {len(own)} lanes ({int(own.sum())} lane-steps), "
              f"train_loss {metrics['train_loss']:.4f}, test_loss {metrics['test_loss']:.4f}, "
              f"test_acc {metrics['test_acc']:.4f}, {_mem(mem)}, "
              f"launches {delta}")
        _check_lane_sites(fb, delta, steps, f"fedopt round {r}")
        for k in (fb.BWD, fb.BWD_RES):
            if delta[k.name]:
                raise AssertionError(f"fedopt round {r}: {k.name} launched: a client trained alone")
        for k in (fb.FWD, fb.FWD_RES):
            if delta[k.name] != SITES[k.name] * evals:
                raise AssertionError(f"fedopt round {r}: {k.name} launched {delta[k.name]} times, "
                                     f"the evaluation's {evals} batches need "
                                     f"{SITES[k.name] * evals}")
    if len(history) != ROUNDS:
        raise AssertionError(f"expected {ROUNDS} rounds, got {len(history)}")
    _check_finite(sim, history, ("train_loss", "test_loss", "test_acc"))

    r = sim.round_idx
    steps = int(_own_steps(sim, r).max())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = busy_us(events) / 1e6
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    print(f"fedopt profiled round {r}: wall {wall:.3f} s (profiler on), {steps} batched steps, "
          f"device busy {busy:.3f} s = {100 * busy / wall:.1f}%, idle "
          f"{100 * (1 - busy / wall):.1f}%, "
          f"{launches / steps:.0f} cudaLaunchKernel a batched step")

    sp = _recipe(FEDOPT, runner.dataset, backend_sim="sp", comm_round=1, frequency_of_the_test=0,
                 metrics_jsonl_path="")
    own = _own_steps(sp.runner, 0)
    _reset_counts(mods)
    t0 = time.perf_counter()
    history = sp.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    sp_counts = _all_counts(mods)
    print(f"fedopt sp (the sequential twin): 1 round in {dt:.3f} s, "
          f"{int(own.sum()) * cfg.batch_size / dt:.0f} trained samples/s, train_loss "
          f"{history[-1]['train_loss']:.4f}, launches {sp_counts}")
    for k, lk in zip(fb.KERNELS, fb.LANE_KERNELS):
        if sp_counts[k.name] != SITES[k.name] * int(own.sum()) or sp_counts[lk.name]:
            raise AssertionError(f"fedopt sp: {k.name} {sp_counts[k.name]} / {lk.name} "
                                 f"{sp_counts[lk.name]} launches, expected "
                                 f"{SITES[k.name] * int(own.sum())} / 0")
    _check_finite(sp.runner, history, ("train_loss",))
    return runner.dataset


def phase_family(mods, dataset):
    """FedProx, FedNova, SCAFFOLD, FedDyn and Mime, each FAMILY_ROUNDS MESH
    rounds of the FedOpt recipe with ``federated_optimizer`` swapped: finite
    losses, each fused site once a batched step (Mime also once a batch of
    its full gradient at the global point), and for SCAFFOLD and FedDyn the
    client-state rows of the clients not sampled bitwise their initial
    zeros, the sampled rows moved."""
    import torch

    from fedml_tpu_torch.core import pytree as pt

    fb = mods[0]
    for algo in FAMILY:
        runner = _recipe(FEDOPT, dataset, federated_optimizer=algo, comm_round=FAMILY_ROUNDS,
                         frequency_of_the_test=0, metrics_jsonl_path="")
        sim, cfg = runner.runner, runner.cfg
        if sim.backend != "MESH" or sim.algorithm.name != algo:
            raise AssertionError(f"{algo}: ran {sim.algorithm.name} on {sim.backend}")
        before = (None if sim.client_states is None
                  else pt.tree_map(torch.clone, sim.client_states))
        steps = sum(int(_own_steps(sim, r).max()) for r in range(FAMILY_ROUNDS))
        if algo == "Mime":  # the full gradient: every batch of the shards, batched over the lanes
            steps += FAMILY_ROUNDS * (sim.capacity // cfg.batch_size)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts(mods)
        t0 = time.perf_counter()
        history = runner.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _all_counts(mods)
        _check_lane_sites(fb, counts, steps, algo)
        single = {k.name: counts[k.name] for k in fb.KERNELS if counts[k.name]}
        if single:
            raise AssertionError(f"{algo}: single-lane kernels launched on MESH: {single}")
        _check_finite(sim, history, ("train_loss",))
        state = ""
        if before is not None:
            sampled = {int(c) for r in range(FAMILY_ROUNDS) for c in sim.sampler.sample(r)}
            for ci in range(sim.dataset.n_clients):
                rows = [(a[ci], b[ci]) for a, b in zip(pt.tree_leaves(sim.client_states),
                                                        pt.tree_leaves(before))]
                same = all(torch.equal(a, b) for a, b in rows)
                if same == (ci in sampled):
                    raise AssertionError(f"{algo}: client {ci} (sampled: {ci in sampled}) state "
                                         f"{'unchanged' if same else 'changed'}")
                if not all(bool(torch.isfinite(a).all()) for a, _ in rows):
                    raise AssertionError(f"{algo}: client {ci} state not finite")
            state = (f", client state: {len(sampled)} sampled rows moved, "
                     f"{sim.dataset.n_clients - len(sampled)} others bitwise unchanged")
        print(f"family {algo}: {FAMILY_ROUNDS} MESH rounds in {dt:.3f} s, train_loss "
              f"{[round(m['train_loss'], 4) for m in history]}, {steps} batched fwd+bwd, "
              f"{_mem()}, "
              f"lane launches {[counts[k.name] for k in fb.LANE_KERNELS]}{state}")
        del runner, sim, before


def _excess(a, b, scale=1.0):
    """(largest |a - b|, largest excess over ``scale`` times the MESH-vs-sp
    tolerance) over the leaves."""
    from fedml_tpu_torch.core import pytree as pt

    worst, excess = 0.0, -math.inf
    for x, y in zip(pt.tree_leaves(a), pt.tree_leaves(b)):
        diff = (x - y).abs()
        worst = max(worst, float(diff.max()))
        excess = max(excess, float((diff - scale * (MESH_SP_ATOL + MESH_SP_RTOL * y.abs())).max()))
    return worst, excess


def phase_scaffold_step(dataset):
    """SCAFFOLD in f32 (TF32 off) on the FedOpt recipe with
    SCAFFOLD_CHECK_LANES clients, each lane its own random ``c_i``, the
    lanes' batched local train against each lane trained alone.  First one
    local step: the variables within the reference's MESH-vs-SP tolerance,
    the new ``c_i`` within it times ``1 / (K lr)``, as phase 3 holds
    FedAvg's step.  Then budgets of 1 and 2 steps alternating, so that the
    lanes run in another order than the clients' (a ``c_i`` left in client
    order would give a lane another client's control variate): a second
    step of f32 grouped convolutions can leave that tolerance (the f32
    trajectory amplifies rounding, phase 3), so each lane is held to it or
    to ROUND_SPREADS times the difference of the lane alone from initial
    weights one ulp apart, never more than SCAFFOLD_SPREAD_CAP, and the
    difference a neighbour's ``c_i`` makes must be at least ten times
    larger than what is allowed.  Each lane's excess over the tolerance is
    printed."""
    import dataclasses

    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms.scaffold import Scaffold
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.fl.local_sgd import step_budgets

    runner = _recipe(FEDOPT, dataset, federated_optimizer="SCAFFOLD", compute_dtype="float32",
                     client_num_per_round=SCAFFOLD_CHECK_LANES, metrics_jsonl_path="")
    sim = runner.runner
    sampled = np.asarray(sim.sampler.sample(0))
    clients = torch.as_tensor(sampled, device=sim.device)
    gen = torch.Generator(device=sim.device)
    gen.manual_seed(11)

    def draw(t, *lead):
        return 0.1 * torch.randn(lead + t.shape, generator=gen, device=t.device)

    c = pt.tree_map(draw, sim.global_vars["params"])
    c_lanes = pt.tree_map(lambda t: draw(t, len(sampled)), sim.global_vars["params"])
    ulp_apart = pt.tree_map(lambda t: t * (1 + 2.0 ** -23 * (2 * torch.randint(
        0, 2, t.shape, generator=gen, device=t.device) - 1)), sim.global_vars)

    def lane(tree, i):
        return pt.tree_map(lambda t: t[i], tree)

    for spe in (1, 2):
        hp = dataclasses.replace(sim.hp, steps_per_epoch=spe)
        algo = Scaffold(hp, sim.cfg).build(sim.model)
        # every client holds more than two batches, so the budgets are these
        want = 1 + np.arange(len(sampled)) % spe
        counts = np.minimum(sim.counts[sampled], want * hp.batch_size)
        budgets = step_budgets(hp, counts)
        perms = torch.stack([sim.sampler.perms(0, int(ci), hp.epochs, sim.capacity)
                             for ci in sampled]).to(sim.device)
        out = algo.client_update_lanes(sim.global_vars, c_lanes, c, *sim._data, clients, counts,
                                       perms=perms)

        def alone(i, variables=sim.global_vars, c_i=None):
            ci = int(sampled[i])
            res = algo.client_update(variables, lane(c_lanes, i) if c_i is None else c_i, c,
                                     sim._data[0][ci], sim._data[1][ci], int(counts[i]), None,
                                     perms=perms[i])
            return res.contribution["variables"], res.client_state

        worst = {"variables": 0.0, "c_i": 0.0, "spread": 0.0, "swap": math.inf}
        excesses = []  # each lane's (variables, c_i / scale) excess over the tolerance
        for i in range(len(sampled)):
            own_vars, own_ci = alone(i)
            scale = 1.0 / (int(budgets[i]) * hp.learning_rate)
            diff, excess = _excess(lane(out.contribution["variables"], i), own_vars)
            ci_diff, ci_excess = _excess(lane(out.client_state, i), own_ci, scale)
            worst["variables"] = max(worst["variables"], diff)
            worst["c_i"] = max(worst["c_i"], ci_diff)
            excesses.append((excess, ci_excess / scale))
            if spe == 1:
                if excess > 0 or ci_excess > 0:
                    raise AssertionError(f"SCAFFOLD one step, lane {i}: variables differ by "
                                         f"{diff:.3g}, c_i by {ci_diff:.3g}, beyond rtol "
                                         f"{MESH_SP_RTOL} / atol {MESH_SP_ATOL} (c_i: x "
                                         f"{scale:.3g})")
                continue
            spread, _ = _excess(alone(i, ulp_apart)[0], own_vars)
            swap, _ = _excess(alone(i, c_i=lane(c_lanes, (i + 1) % len(sampled)))[0], own_vars)
            limit = min(ROUND_SPREADS * spread, SCAFFOLD_SPREAD_CAP)
            allowed = max(limit, MESH_SP_ATOL)
            worst["spread"] = max(worst["spread"], spread)
            worst["swap"] = min(worst["swap"], swap)
            if (excess > 0 and diff > limit) or (ci_excess > 0 and ci_diff > scale * limit):
                raise AssertionError(f"SCAFFOLD lane {i} ({budgets[i]} steps): variables differ by "
                                     f"{diff:.3g}, c_i by {ci_diff:.3g}, beyond rtol "
                                     f"{MESH_SP_RTOL} / atol {MESH_SP_ATOL} and {ROUND_SPREADS} x "
                                     f"the one-ulp spread {spread:.3g} capped at "
                                     f"{SCAFFOLD_SPREAD_CAP} (c_i: x {scale:.3g})")
            if swap < 10 * allowed:
                raise AssertionError(f"SCAFFOLD lane {i}: a neighbour's c_i moves the lane by "
                                     f"{swap:.3g}, not ten times the {allowed:.3g} allowed")
        line = (f"scaffold check: f32 batched local train of {len(sampled)} lanes (budgets "
                f"{budgets.tolist()} steps, each lane its own c_i) against each lane alone: "
                f"largest difference {worst['variables']:.3g} in the variables, "
                f"{worst['c_i']:.3g} in c_i; each lane's largest excess over rtol "
                f"{MESH_SP_RTOL} / atol {MESH_SP_ATOL} (variables, c_i / scale): "
                f"{[(float(f'{a:.3g}'), float(f'{b:.3g}')) for a, b in excesses]}")
        if spe == 1:
            print(f"{line} (rtol {MESH_SP_RTOL}, atol {MESH_SP_ATOL}; c_i: x 1 / (K lr) = "
                  f"{1 / hp.learning_rate:.3g}): within")
        else:
            print(f"{line}; a lane alone from weights an ulp apart: up to {worst['spread']:.3g} "
                  f"(allowance {ROUND_SPREADS} x that, at most {SCAFFOLD_SPREAD_CAP}); a "
                  f"neighbour's c_i moves a lane by at least {worst['swap']:.3g}")


def phase_client_adam(mods, dataset):
    """One MESH round of the FedOpt recipe as FedAvg with the client Adam
    (optax ``adamw``, a per-lane count in the batched step)."""
    import torch

    fb = mods[0]
    runner = _recipe(FEDOPT, dataset, federated_optimizer="FedAvg", client_optimizer="adam",
                     comm_round=1, frequency_of_the_test=1, metrics_jsonl_path="")
    sim = runner.runner
    steps = int(_own_steps(sim, 0).max())
    _reset_counts(mods)
    t0 = time.perf_counter()
    history = runner.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _all_counts(mods)
    _check_lane_sites(fb, counts, steps, "client adam")
    _check_finite(sim, history, ("train_loss", "test_loss", "test_acc"))
    print(f"client adam: 1 MESH round of {sim.cfg.client_num_per_round} lanes in {dt:.3f} s "
          f"(evaluation included), train_loss {history[-1]['train_loss']:.4f}, test_acc "
          f"{history[-1]['test_acc']:.4f}, {steps} batched steps")


def _zero_counts(counts, what):
    """The paths of this slice run none of the seven kernels: every count
    read after the run must still be 0."""
    if any(counts.values()):
        raise AssertionError(f"{what}: kernels launched on a path that has none: {counts}")


def _trained_lane_steps(sim) -> int:
    """The lane-steps of one hierarchical round: each sub-round's clients
    take their own budgets (every client trains in every sub-round when all
    take part)."""
    import numpy as np

    from fedml_tpu_torch.fl.local_sgd import step_budgets

    own = np.minimum(step_budgets(sim.hp, sim.counts), sim.hp.epochs * sim.hp.steps_per_epoch)
    return int(own.sum()) * sim.group_comm_round


def phase_hierarchical(mods):
    """``sim_hierarchical_cifar10`` as shipped but for its depth (3 rounds):
    16 clients in 4 balanced groups, 2 sub-rounds, the FedAvg CNN with
    dropout on the bf16 input; each round's time, samples/s, peak memory and
    finite losses, a profiled round's device busy share; then, in f32 with
    the sampler's dropout draws, one batched sub-round step of 8 lanes
    against each lane alone."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.fl.local_sgd import (lane_dropout_table, make_batched_local_train_fn,
                                              make_local_train_fn, to_device)
    from fedml_tpu_torch.obs.profile_round import busy_us

    t0 = time.perf_counter()
    runner = _recipe(HIERARCHICAL, comm_round=ROUNDS, fused_blocks=False,
                     synthetic_train_size=HIER_TRAIN)
    sim, cfg = runner.runner, runner.cfg
    lane_steps = _trained_lane_steps(sim)
    print(f"hierarchical path: set-up {time.perf_counter() - t0:.1f} s (data "
          f"{sim.dataset.train_num}/{sim.dataset.test_num}, {sim.dataset.n_clients} clients in "
          f"{sim.group_num} {cfg.extra.get('group_assignment', 'balanced')} groups of sample "
          f"mass {np.bincount(sim.group_of, weights=sim.counts).astype(int).tolist()}, "
          f"{sim.group_comm_round} sub-rounds, capacity {sim.capacity}, batch {cfg.batch_size}, "
          f"{cfg.compute_dtype} input, model {type(sim.model).__name__} with dropout "
          f"{1 - sim.model.keep_prob}; {lane_steps} lane-steps a round)")
    probe = _RoundProbe(sim.logger, lambda: _all_counts(mods))
    sim.logger = probe
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(mods)
    history = runner.run()
    torch.cuda.synchronize()
    counts = _all_counts(mods)
    _zero_counts(counts, "hierarchical path")
    for metrics, _, mem in probe.rows:
        print(f"hierarchical round {metrics['round']}: {metrics['round_time_s']:.3f} s, "
              f"{lane_steps * cfg.batch_size / metrics['round_time_s']:.0f} trained samples/s, "
              f"train_loss {metrics['train_loss']:.4f}, test_loss "
              f"{metrics.get('test_loss', float('nan')):.4f}, test_acc "
              f"{metrics.get('test_acc', float('nan')):.4f}, "
              f"{_mem(mem)}")
    if len(history) != ROUNDS:
        raise AssertionError(f"expected {ROUNDS} rounds, got {len(history)}")
    _check_finite(sim, history, ("train_loss",))
    _check_finite(sim, history[-1:], ("test_loss", "test_acc"))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = busy_us([e for e in prof.events() if e.device_type.name == "CUDA"]) / 1e6
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    print(f"hierarchical profiled round: wall {wall:.3f} s (profiler on), device busy "
          f"{busy:.3f} s = {100 * busy / wall:.1f}%, idle {100 * (1 - busy / wall):.1f}%, "
          f"{launches} cudaLaunchKernel")

    f32 = _recipe(HIERARCHICAL, runner.dataset, comm_round=1, compute_dtype="float32",
                  fused_blocks=False, metrics_jsonl_path="").runner
    f32.global_vars = pt.tree_map(torch.clone, sim.global_vars)
    lanes = np.arange(HIER_CHECK_LANES)
    shape = f32.model.dropout_shape(cfg.batch_size)
    tables = [f32.sampler.dropout(0, 0, int(c), 1, shape, f32.model.keep_prob, f32.device)
              for c in lanes]
    perms = torch.stack([f32.sampler.perms(0, 0, int(c), f32.hp.epochs, f32.capacity)
                         for c in lanes])
    ones = np.full(len(lanes), cfg.batch_size)  # a budget of one step each
    groups = to_device(f32.group_of[lanes], f32.device, torch.long)
    start = pt.tree_take(pt.tree_map(
        lambda t: t.unsqueeze(0).repeat((f32.group_num,) + (1,) * t.ndim), f32.global_vars),
        groups)
    x, y = f32._data
    batched, _ = make_batched_local_train_fn(f32.model, f32.hp)(
        start, x, y, to_device(lanes, f32.device, torch.long), ones, perms, None,
        lane_dropout_table(tables))
    single = make_local_train_fn(f32.model, f32.hp)
    worst = 0.0
    for i, c in enumerate(lanes):
        alone, _ = single(pt.tree_map(lambda t: t[i], start), x[c], y[c], cfg.batch_size, (0,),
                          perms=perms[i], dropout=tables[i])
        for a, b in zip(pt.tree_leaves(pt.tree_map(lambda t: t[i], batched)),
                        pt.tree_leaves(alone)):
            err = float(((a - b).abs() - MESH_SP_RTOL * b.abs()).max())
            worst = max(worst, float((a - b).abs().max()))
            if err > MESH_SP_ATOL:
                raise AssertionError(f"hierarchical lane {i}: batched step vs alone off by "
                                     f"{float((a - b).abs().max()):.3g}")
    print(f"hierarchical f32 check: one batched sub-round step of {len(lanes)} lanes (each from "
          f"its group's model, the sampler's dropout draws) vs each lane alone: largest "
          f"difference {worst:.3g} (rtol {MESH_SP_RTOL}, atol {MESH_SP_ATOL})")
    return counts, runner.dataset


def _myavg_run(mods, what, **overrides):
    """The MyAvg recipe (or it with ``overrides``) on the card: history,
    simulator, seconds, counts."""
    import torch

    from fedml_tpu_torch.fl.local_sgd import step_budgets

    t0 = time.perf_counter()
    runner = _recipe(MYAVG, fused_blocks=False, **overrides)
    sim = runner.runner
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(mods)
    t1 = time.perf_counter()
    history = runner.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    counts = _all_counts(mods)
    _zero_counts(counts, what)
    if len(history) != runner.cfg.comm_round:
        raise AssertionError(f"{what}: {len(history)} rounds of {runner.cfg.comm_round}")
    _check_finite(sim, history, ("train_loss",))
    # every client takes part in every round of this recipe
    samples = int(step_budgets(sim.hp, sim.counts).sum()) * sim.hp.batch_size * len(history)
    print(f"{what}: {len(history)} rounds in {dt:.3f} s ({1e3 * dt / len(history):.2f} ms a "
          f"round incl. evaluation, {samples / dt:.0f} trained samples/s; set-up "
          f"{t1 - t0:.1f} s), {_mem()}, final train_loss "
          f"{history[-1]['train_loss']:.4f}, test_acc {history[-1]['test_acc']:.4f}")
    return history, sim, counts


def phase_myavg(mods):
    """``myavg_condshift_mlp`` as shipped (40 rounds: its gate never runs
    CKA), again with ``agg_mod_list: [2]`` (CKA on ``Dense_1`` every even
    round), and the same recipe under FedAvg, held to what the reference's
    ``test_condshift_personalization_beats_fedavg`` asserts."""
    history, sim, counts = _myavg_run(mods, "myavg (shipped gate)")
    pers = sim.evaluate_personalized()
    if sim.cka_rounds != 0:
        raise AssertionError(f"the shipped gate ran CKA in {sim.cka_rounds} rounds")
    var_hist, var, _ = _myavg_run(mods, "myavg (agg_mod_list [2])", agg_mod_list=(2,),
                                  agg_mod_dict={2: {}})
    var_pers = var.evaluate_personalized()
    if var.cka_rounds <= 0:
        raise AssertionError("agg_mod_list [2] never ran CKA")
    fed_hist, _, _ = _myavg_run(mods, "myavg recipe under FedAvg", federated_optimizer="FedAvg")
    fed_acc = fed_hist[-1]["test_acc"]
    print(f"myavg: CKA rounds {sim.cka_rounds} (shipped) / {var.cka_rounds} (variant) of "
          f"{len(history)}; personalized mean / min {pers['personalized_test_acc_mean']:.4f} / "
          f"{pers['personalized_test_acc_min']:.4f} (shipped), "
          f"{var_pers['personalized_test_acc_mean']:.4f} / "
          f"{var_pers['personalized_test_acc_min']:.4f} (variant); global test_acc "
          f"{history[-1]['test_acc']:.4f} / {var_hist[-1]['test_acc']:.4f}; FedAvg test_acc "
          f"{fed_acc:.4f}")
    if not (fed_acc < 0.55 and pers["personalized_test_acc_mean"] > fed_acc + 0.2
            and pers["personalized_test_acc_min"] > 0.55):
        raise AssertionError(f"myavg: FedAvg {fed_acc:.4f} (< 0.55), personalized "
                             f"{pers} (mean > FedAvg + 0.2, min > 0.55)")
    return counts


def phase_lightsecagg(mods):
    """``cross_silo_lightsecagg_lr`` as shipped but for ``LSA_ROUNDS`` (4 silos, T = 2,
    U = 3, straggler timeout 10 s): each round's time, decode time and
    upload bytes, the final accuracy; then one round in which silo 4 sends
    its mask shares and drops out: the global must be bitwise the uniform
    mean of the three survivors' field-quantized models."""
    import numpy as np
    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.cross_silo import run_group
    from fedml_tpu_torch.cross_silo.lightsecagg import build_lightsecagg_process_group
    from fedml_tpu_torch.runner import FedMLRunner
    from fedml_tpu_torch.trust.secagg.field import dequantize_from_field

    cfg = fedml_tpu_torch.init(argv=["--cf", LIGHTSECAGG])
    cfg.comm_round = LSA_ROUNDS
    runner = FedMLRunner(cfg)
    runner.runner.setup()
    clients = runner.runner.clients
    samples = sum(c.trainer.trained_samples for c in clients)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(mods)
    t0 = time.perf_counter()
    history = runner.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _all_counts(mods)
    _zero_counts(counts, "lightsecagg path")
    agg = runner.runner.server.aggregator
    print(f"lightsecagg path: {len(history)} rounds in {dt:.2f} s, T={agg.protocol.t} "
          f"U={agg.protocol.u} over {agg.model_dim} elements (padded {agg.d_pad}), "
          f"{len(clients)} silos of {[c.trainer.count for c in clients]} samples, "
          f"{_mem()}")
    for m in history:
        print(f"lightsecagg round {m['round']}: {m['round_time_s']:.4f} s, "
              f"{samples / m['round_time_s']:.0f} trained samples/s, decode (finalize) "
              f"{1e3 * m['finalize_time_s']:.2f} ms, uploads {m['upload_bytes']} bytes"
              + (f", test_acc {m['test_acc']:.4f}" if "test_acc" in m else ""))
    last = history[-1]
    if len(history) != cfg.comm_round or not math.isfinite(last["test_loss"]):
        raise AssertionError(f"lightsecagg: {len(history)} rounds, last {last}")

    cfg1 = fedml_tpu_torch.init(argv=["--cf", LIGHTSECAGG])
    cfg1.comm_round = 1
    server, clients = build_lightsecagg_process_group(cfg1, runner.dataset, runner.model,
                                                      runner.device, drop_ranks=frozenset({4}))
    t0 = time.perf_counter()
    drop_hist = run_group(server, clients, timeout=120.0)
    dt = time.perf_counter() - t0
    agg = server.aggregator
    total = np.zeros(agg.model_dim, np.int64)
    for c in clients[:3]:
        total = (total + c.last_field_vec) % agg.protocol.p
    want = (dequantize_from_field(total, 3, bits=agg.q_bits) / 3).astype(np.float32)
    got = weights.flatten_reference(agg.global_vars)[0].cpu().numpy()
    if server.active_first != [1, 2, 3] or clients[3].last_field_vec is not None:
        raise AssertionError(f"straggler round: survivors {server.active_first}")
    if not np.array_equal(got, want):
        raise AssertionError("straggler round: the global is not the survivors' uniform mean")
    print(f"lightsecagg straggler round: silo 4 dropped after its mask shares; decoded from "
          f"survivors {server.active_first} in {dt:.2f} s (timeout "
          f"{server.straggler_timeout} s), decode {1e3 * drop_hist[0]['finalize_time_s']:.2f} ms, "
          f"global bitwise the uniform mean of their field-quantized models")
    return counts


def phase_lr_recipes():
    """The logistic-regression recipes as shipped but for the depth of
    ``LR_RECIPE_ROUNDS``: FedProx on MESH (30 rounds) and cross-silo FedAvg
    over the in-process fabric (10 of its 20 rounds)."""
    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner

    for path in LR_RECIPES:
        t0 = time.perf_counter()
        cfg = fedml_tpu_torch.init(argv=["--cf", path])
        cfg.comm_round = LR_RECIPE_ROUNDS.get(path, cfg.comm_round)
        runner = FedMLRunner(cfg)
        history = runner.run()
        torch.cuda.synchronize()
        last = history[-1]
        if len(history) != cfg.comm_round or not all(
                math.isfinite(last[k]) for k in ("test_loss", "test_acc")):
            raise AssertionError(f"{path}: {len(history)} rounds, last {last}")
        print(f"{path.split('/')[1]}: {cfg.federated_optimizer} {cfg.training_type} "
              f"{len(history)} rounds in {time.perf_counter() - t0:.2f} s (set-up included), "
              f"final test_acc {last['test_acc']:.4f}, test_loss {last['test_loss']:.4f}")


def _lora_gap(got, want, start):
    """Two adapter trees as updates from ``start``: (relative L2 of their
    difference over the update's norm, its largest element)."""
    diff = upd = largest = 0.0
    for path, ab in want.items():
        for k, w in ab.items():
            g, w, s0 = got[path][k].double().cpu(), w.double().cpu(), start[path][k].double().cpu()
            diff += float(((g - w) ** 2).sum())
            upd += float(((w - s0) ** 2).sum())
            largest = max(largest, float((g - w).abs().max()))
    return math.sqrt(diff / upd), largest


def phase_fedllm(mods):
    """8a: the FedLLM recipe as shipped (10 rounds) through ``init`` and
    ``FedMLRunner(cfg).run()``: each round's time, trained tokens/s,
    train_loss and peak memory, the test loss and perplexity at rounds 5
    and 10; then a profiled round (busy share, ``cudaLaunchKernel`` a
    step) and one f32 client update on the card against the CPU."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import fedml_tpu_torch
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.llm.fedllm import FedLLMSimulator
    from fedml_tpu_torch.llm.lora import lora_size
    from fedml_tpu_torch.obs.profile_round import busy_us
    from fedml_tpu_torch.runner import FedMLRunner

    t0 = time.perf_counter()
    cfg = fedml_tpu_torch.init(argv=["--cf", FEDLLM])
    runner = FedMLRunner(cfg)
    sim = runner.runner
    if not isinstance(sim, FedLLMSimulator) or sim.device.type != "cuda":
        raise AssertionError(f"the FedLLM recipe built {type(sim).__name__} on {sim.device}")
    m = min(cfg.client_num_per_round, sim.dataset.n_clients)
    tokens = sim.trained_tokens(m)
    tc = sim.tcfg
    print(f"fedllm path: set-up {time.perf_counter() - t0:.1f} s (data {sim.dataset.train_num}/"
          f"{sim.dataset.test_num} sequences of {sim._x.shape[-1]} tokens, vocab {tc.vocab_size}, "
          f"{sim.dataset.n_clients} clients, {m} a round, {sim.steps} steps each of batch "
          f"{cfg.batch_size}: {tokens} trained tokens a round; transformer d_model {tc.d_model}, "
          f"{tc.n_layers} layers, {tc.n_heads} heads, d_ff {tc.d_ff}, {tc.dtype}, "
          f"{sum(t.numel() for t in pt.tree_leaves(sim.base_params))} base parameters; LoRA "
          f"r {sim.rank} on {len(sim.global_lora)} kernels, {lora_size(sim.global_lora)} "
          f"adapter parameters)")
    probe = _RoundProbe(sim.logger, lambda: _all_counts(mods))
    sim.logger = probe
    _reset_counts(mods)
    history = runner.run()
    torch.cuda.synchronize()
    counts = _all_counts(mods)
    _zero_counts(counts, "fedllm path")
    for metrics, _, mem in probe.rows:
        evals = (f", test_loss {metrics['test_loss']:.4f}, test_ppl {metrics['test_ppl']:.3f}"
                 if "test_loss" in metrics else "")
        print(f"fedllm round {metrics['round']}: {metrics['round_time_s']:.3f} s, "
              f"{tokens / metrics['round_time_s']:.0f} trained tokens/s, train_loss "
              f"{metrics['train_loss']:.4f}{evals}, {_mem(mem)}")
    if len(history) != cfg.comm_round:
        raise AssertionError(f"fedllm: {len(history)} rounds of {cfg.comm_round}")
    for metrics in history:
        if not math.isfinite(metrics["train_loss"]):
            raise AssertionError(f"fedllm round {metrics['round']}: train_loss not finite")
    evaluated = [h["round"] for h in history if "test_loss" in h]
    if evaluated != [4, 9] or not all(math.isfinite(h[k]) for h in history if "test_loss" in h
                                      for k in ("test_loss", "test_ppl")):
        raise AssertionError(f"fedllm: evaluated rounds {evaluated}, expected 4 and 9, finite")
    if not history[-1]["train_loss"] < history[0]["train_loss"]:
        raise AssertionError("fedllm: the last round's train_loss is not below the first's")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = busy_us([e for e in prof.events() if e.device_type.name == "CUDA"]) / 1e6
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    print(f"fedllm profiled round: wall {wall:.3f} s (profiler on), device busy {busy:.3f} s = "
          f"{100 * busy / wall:.1f}%, idle {100 * (1 - busy / wall):.1f}%, {launches} "
          f"cudaLaunchKernel ({launches / (m * sim.steps):.0f} a step)")

    # one f32 client update of the recipe, on the card and on the CPU
    f32 = dataclasses.replace(tc, dtype=torch.float32, logits_dtype=torch.float32)
    card = FedLLMSimulator(cfg, sim.dataset, tcfg=f32)
    host = FedLLMSimulator(cfg, sim.dataset, tcfg=f32, device="cpu")
    with torch.no_grad():
        pt.tree_map(lambda h, c: h.copy_(c.cpu()), host.base_params, card.base_params)
    start = pt.tree_map(lambda t: t + 0.01, card.global_lora)
    ci = int(card.sampler.sample(0)[0])
    table = card.sampler.batches(0, ci, card.steps, cfg.batch_size, int(card.counts[ci]),
                                 card.device)
    got, got_losses = card.client_update(start, card._x[ci], card._y[ci], table)
    want, want_losses = host.client_update(pt.tree_map(lambda t: t.cpu(), start), host._x[ci],
                                           host._y[ci], table.cpu())
    rel, largest = _lora_gap(got, want, start)
    loss_gap = float((got_losses.cpu() - want_losses).abs().max())
    print(f"fedllm f32 client update ({card.steps} steps, TF32 off), card against CPU: adapters "
          f"relative L2 {rel:.3g} (bound {FEDLLM_CHECK_REL}), largest element {largest:.3g} "
          f"(bound {FEDLLM_CHECK_ATOL}), step losses within {loss_gap:.3g}")
    if rel > FEDLLM_CHECK_REL or largest > FEDLLM_CHECK_ATOL or not np.isfinite(loss_gap) \
            or loss_gap > 1e-4:
        raise AssertionError("fedllm f32 client update: the card and the CPU disagree")
    return counts


def phase_fedllm_full(mods):
    """8b: one FedLLM round of 2 clients at Llama-2-7B's widths, the depth
    cut from 32 layers to 4 (``dataclasses.replace(llama_7b(),
    n_layers=4)``), bf16, on the recipe's data: each client's step time,
    trained tokens/s, 6 x tokens x parameters a step over the step time,
    peak memory, finite losses that fall."""
    import dataclasses

    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.llm.fedllm import FedLLMSimulator
    from fedml_tpu_torch.llm.lora import lora_size
    from fedml_tpu_torch.models.transformer import TransformerConfig

    t0 = time.perf_counter()
    cfg = fedml_tpu_torch.init(argv=["--cf", FEDLLM])
    cfg.comm_round, cfg.frequency_of_the_test = 1, 1
    tcfg = dataclasses.replace(TransformerConfig.llama_7b(), n_layers=FULL_WIDTH_LAYERS)
    sim = FedLLMSimulator(cfg, loader.load(cfg), tcfg=tcfg)
    params = sum(t.numel() for t in pt.tree_leaves(sim.base_params))
    torch.cuda.synchronize()
    step_tokens = cfg.batch_size * int(sim._x.shape[-1])
    print(f"fedllm full width: set-up {time.perf_counter() - t0:.1f} s (d_model {tcfg.d_model}, "
          f"{tcfg.n_heads} heads, d_ff {tcfg.d_ff}, vocab {tcfg.vocab_size}, {tcfg.n_layers} "
          f"layers of Llama-2-7B's 32, {tcfg.dtype}, remat {'on' if tcfg.remat else 'off'}: {params} f32 "
          f"base parameters, {lora_size(sim.global_lora)} adapter parameters; "
          f"{cfg.client_num_per_round} clients x {sim.steps} steps x {step_tokens} tokens), "
          f"{_mem()}")
    timed = []
    update = sim.client_update

    def timed_update(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = update(*args)
        torch.cuda.synchronize()
        timed.append((time.perf_counter() - t, out[1].cpu()))
        return out

    sim.client_update = timed_update
    _reset_counts(mods)
    metrics = sim.run_round()
    metrics.update(sim.evaluate())
    torch.cuda.synchronize()
    flops = 6 * step_tokens * params
    for i, (dt, losses) in enumerate(timed):
        step = dt / len(losses)
        print(f"fedllm full width client {i}: {sim.steps} steps in {dt:.3f} s, {step * 1e3:.2f} ms "
              f"a step{' (the first includes the warm-up)' if i == 0 else ''}, "
              f"{step_tokens / step:.0f} trained tokens/s, {flops / step / 1e12:.1f} TFLOP/s "
              f"(6 x {step_tokens} tokens x {params} parameters a step), step losses "
              f"{float(losses[0]):.4f} -> {float(losses[-1]):.4f}")
        quarter = max(1, len(losses) // 4)
        if not bool(torch.isfinite(losses).all()) or not (
                losses[-quarter:].mean() < losses[:quarter].mean()):
            raise AssertionError(f"fedllm full width client {i}: losses not finite and falling")
    print(f"fedllm full width round: train_loss {metrics['train_loss']:.4f}, test_loss "
          f"{metrics['test_loss']:.4f}, test_ppl {metrics['test_ppl']:.3f}, {_mem()}")
    if not all(math.isfinite(metrics[k]) for k in ("train_loss", "test_loss", "test_ppl")):
        raise AssertionError(f"fedllm full width: {metrics}")
    counts = _all_counts(mods)
    _zero_counts(counts, "fedllm full width")
    return counts


def phase_resume(mods, flagship):
    """8c: FedLLM 2 rounds + a checkpoint + a fresh simulator resumed for 2
    more against 4 straight rounds, the adapters bitwise; the flagship on
    MESH with fused blocks 1 + 1 rounds against 2 (cuDNN deterministic),
    the global variables bitwise or the largest difference printed.
    Returns the kernels' launches over the three FedLLM runs."""
    import tempfile

    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.runner import FedMLRunner

    def fedllm(**kw):
        cfg = fedml_tpu_torch.init(argv=["--cf", FEDLLM])
        cfg.frequency_of_the_test = 0
        for k, v in kw.items():
            setattr(cfg, k, v)
        return FedMLRunner(cfg).runner

    with tempfile.TemporaryDirectory() as tmp:
        straight = fedllm(comm_round=4)
        _reset_counts(mods)
        straight.run()
        fedllm(comm_round=2, checkpoint_dir=f"{tmp}/llm", checkpoint_every_rounds=1).run()
        resumed = fedllm(comm_round=4, checkpoint_dir=f"{tmp}/llm", resume=True)
        hist = resumed.run()
        torch.cuda.synchronize()
        fedllm_counts = _all_counts(mods)
        _zero_counts(fedllm_counts, "fedllm resume")
        same = all(torch.equal(a, b) for a, b in zip(pt.tree_leaves(straight.global_lora),
                                                      pt.tree_leaves(resumed.global_lora)))
        print(f"fedllm resume: 2 rounds + checkpoint + 2 resumed (rounds "
              f"{[h['round'] for h in hist]}) against 4 straight: adapters "
              f"{'bitwise' if same else 'DIFFER'}")
        if not same or [h["round"] for h in hist] != [2, 3]:
            raise AssertionError("fedllm resume is not bitwise the straight run")

        torch.backends.cudnn.deterministic = True
        try:
            _reset_counts(mods)
            runs = {}
            for name, kw in (("straight", dict(comm_round=2)),
                             ("first", dict(comm_round=1, checkpoint_dir=f"{tmp}/mesh",
                                            checkpoint_every_rounds=1)),
                             ("resumed", dict(comm_round=2, checkpoint_dir=f"{tmp}/mesh",
                                              resume=True))):
                runner = _flagship(flagship, frequency_of_the_test=0, **kw)
                runner.run()
                runs[name] = runner.runner
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = False
        a, b = runs["straight"], runs["resumed"]
        pairs = list(zip(pt.tree_leaves(a.global_vars), pt.tree_leaves(b.global_vars)))
        worst = max(float((x.float() - y.float()).abs().max()) for x, y in pairs)
        launched = {k: v for k, v in _all_counts(mods).items() if v}
        print(f"flagship MESH resume (fused, cuDNN deterministic): 1 round + checkpoint + 1 "
              f"resumed against 2 straight: global variables "
              f"{'bitwise' if worst == 0 else f'differ by up to {worst:.3g}'}; launches {launched}")
        if worst != 0 or b.round_idx != 2:
            raise AssertionError("flagship MESH resume is not bitwise the straight run")
    return fedllm_counts


# -- phase 10: trust in the simulator ------------------------------------------

# every tenth client id attacks (13 of the flagship's 128); the defenses are
# told of 7 per round (64 sampled: 6.5 expected attackers)
ATTACKERS = tuple(range(0, 128, 10))
TRUST_ATTACK = dict(enable_attack=True, attack_type="byzantine_random",
                    poisoned_client_list=ATTACKERS, byzantine_client_num=7)
TRUST_DEFENSE = dict(enable_defense=True, defense_type="multikrum", krum_param_m=32)
LDP = dict(enable_dp=True, dp_solution_type="ldp", mechanism_type="gaussian", epsilon=50.0,
           delta=1e-5, sensitivity=0.01)
TRUST_ROUNDS = 2
# form (f): GTG-Shapley evaluates up to 20 x m coalitions (cut from 8 to 4
# clients, then to 3, to keep the script within its budget)
CONTRIBUTION_CLIENTS = 3
# form (d): selections (0/1 weights) bitwise card against CPU; every other
# result within this times the CPU result's largest magnitude (sums of up to
# 271,098 f32 terms, or of 64 rows, in another order)
TRUST_REL = 1e-5
# FoolsGold's and the residual reweighting's weights: cosine / norm sums in
# another order, then a log or a division (relative, plus absolute 1e-6)
TRUST_WEIGHT_REL = 1e-4
SELECTING = ("krum", "multikrum", "three_sigma", "three_sigma_geomedian", "three_sigma_krum",
             "cross_round")
# outlier_detection replaces an element whose |u - mean| sits within rounding
# of k * std (64-term sums) by the median: such elements may differ, counted
OUTLIER_FLIPS_MAX = 16


class _NoiseLengths:
    """Records the length of every noise-kernel call on the card (the
    wrapper is the module's own, so the kernel still counts its launch)."""

    def __init__(self, nz):
        self.nz, self.orig, self.lengths = nz, nz.apply_gaussian_noise, []

    def __enter__(self):
        def wrapped(vec, noise, sigma):
            self.lengths.append(int(vec.numel()))
            return self.orig(vec, noise, sigma)

        self.nz.apply_gaussian_noise = wrapped
        return self

    def __exit__(self, *exc):
        self.nz.apply_gaussian_noise = self.orig


def _trust_run(mods, nz, what, dataset, rounds=TRUST_ROUNDS, **flags):
    """The flagship on MESH with ``flags``, ``rounds`` rounds: each round's
    time, test accuracy, launches of kernels 1-4 (lanes) and 7 and the noise
    lengths; returns (runner, history, counts, noise lengths)."""
    import torch

    t0 = time.perf_counter()
    # a test evaluation every round: each round its own chunk, timed alone
    runner = _flagship(dataset, comm_round=rounds, frequency_of_the_test=1, **flags)
    sim = runner.runner
    setup = time.perf_counter() - t0
    probe = _RoundProbe(sim.logger, lambda: _all_counts(mods + (nz,)))
    sim.logger = probe
    _reset_counts(mods + (nz,))
    with _NoiseLengths(nz) as lengths:
        history = runner.run()
        torch.cuda.synchronize()
    counts = _all_counts(mods + (nz,))
    prev = {k: 0 for k in counts}
    for metrics, cum, mem in probe.rows:
        delta = {k: cum[k] - prev[k] for k in cum if cum[k] - prev[k]}
        prev = cum
        print(f"trust {what} round {metrics['round']}: {metrics['round_time_s']:.3f} s, "
              f"train_loss {metrics['train_loss']:.4f}, test_acc "
              f"{metrics.get('test_acc', float('nan')):.4f}, {_mem(mem)}, launches {delta}")
    print(f"trust {what}: set-up {setup:.1f} s, noise kernel lengths {lengths.lengths}")
    if len(history) != rounds or sim.backend != "MESH":
        raise AssertionError(f"trust {what}: {len(history)} rounds on {sim.backend}")
    _check_finite(sim, history, ("train_loss",))
    return runner, history, counts, lengths.lengths


def _noise_launches(counts, nz, lengths, want, what):
    ran = counts[nz.NOISE.name]
    if ran != len(want) or sorted(lengths) != sorted(want):
        raise AssertionError(f"trust {what}: the noise kernel ran {ran} times at {lengths}, "
                             f"expected {want}")


def _profiled_round(sim, what):
    """One more round under torch.profiler: wall, device busy share and
    ``cudaLaunchKernel`` a batched step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fedml_tpu_torch.obs.profile_round import busy_us

    steps = int(_own_steps(sim, sim.round_idx).max())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = busy_us([e for e in prof.events() if e.device_type.name == "CUDA"]) / 1e6
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    print(f"trust profiled round ({what}): wall {wall:.3f} s (profiler on), {steps} batched "
          f"steps, device busy {busy:.3f} s = {100 * busy / wall:.1f}%, "
          f"{launches / steps:.0f} cudaLaunchKernel a batched step ({launches} in the round)")
    return launches / steps


def _capture_aggregation(sim):
    """Wraps the pipeline's second hook: keeps the last round's matrix,
    weights and global as they enter it, and the weights it returns."""
    from fedml_tpu_torch import weights as wl
    from fedml_tpu_torch.core import pytree as pt

    inner, seen = sim.trust.on_aggregation, {}

    def hook(contribs, weights, global_vars, round_idx, prev_delta=None):
        seen["matrix"] = pt.stacked_tree_to_matrix(contribs)
        seen["weights"], seen["global"] = weights.clone(), wl.flatten_reference(global_vars)[0]
        out = inner(contribs, weights, global_vars, round_idx, prev_delta=prev_delta)
        seen["kept"] = out[1].clone()
        return out

    sim.trust.on_aggregation = hook
    return seen


def _defense_on(name, cfg, device, mat, w, g, prev, draws):
    """``name``'s three hooks on ``device``: (updates, weights, aggregate,
    after, seconds)."""
    import dataclasses

    import torch

    from fedml_tpu_torch.trust.defense import create
    from fedml_tpu_torch.trust.defense.base import DrawingDefense

    cfg = dataclasses.replace(cfg, defense_type=name)
    dfn = create(cfg)
    if isinstance(dfn, DrawingDefense):
        dfn.set_draw(lambda kind, shape: draws[kind].reshape(-1)[:math.prod(shape)].view(
            shape).to(device))
    if hasattr(dfn, "set_history"):
        dfn.set_history(prev.to(device))
    mat, w, g = mat.to(device), w.to(device), g.to(device)
    new_g = g + 0.01 * prev.to(device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    u2, w2 = dfn.before(mat, w, g)
    agg = dfn.on_agg(u2, w2, g)
    after = dfn.after(new_g, g)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return u2, w2, agg, after, time.perf_counter() - t0


def _all_defenses(nz, cfg, seen):
    """Form (d): the captured round through every registered defense on the
    card and on the CPU."""
    import torch

    from fedml_tpu_torch.trust.defense import names
    from fedml_tpu_torch.trust.defense.robust_agg import krum_scores
    from fedml_tpu_torch.trust.dp.dp import laplace_from_uniform

    mat, w, g = seen["matrix"], seen["weights"], seen["global"]
    dev = mat.device
    m, d = mat.shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(1013)
    prev = torch.randn(d, generator=gen, device=dev) * 1e-3
    draws = {"gaussian": torch.randn(m * d, generator=gen, device=dev)}
    draws["laplace"] = laplace_from_uniform(torch.rand(m * d, generator=gen, device=dev))
    cpu_draws = {k: v.cpu() for k, v in draws.items()}
    cpu = torch.device("cpu")
    print(f"trust (d): the captured round's matrix ({m}, {d}) = {m * d} elements through the "
          f"{len(names())} registered defenses, card against CPU")
    for name in names():
        _reset_counts((nz,))
        card = _defense_on(name, cfg, dev, mat, w, g, prev, draws)
        launched = nz.launch_counts()[nz.NOISE.name]
        host = _defense_on(name, cfg, cpu, mat.cpu(), w.cpu(), g.cpu(), prev.cpu(), cpu_draws)
        notes, worst = [], 0.0
        if name in SELECTING:
            same = torch.equal(card[1].cpu(), host[1])
            if not same:
                sc, sh = krum_scores(mat, cfg.byzantine_client_num).cpu(), krum_scores(
                    mat.cpu(), cfg.byzantine_client_num)
                print(f"  {name}: selection differs; card {card[1].cpu().tolist()} CPU "
                      f"{host[1].tolist()}; Krum score gap card-CPU "
                      f"{float((sc - sh).abs().max()):.3g}")
                raise AssertionError(f"trust (d) {name}: the selection differs card vs CPU")
            notes.append(f"weights bitwise, kept {int((host[1] > 0).sum())} of {m}")
        else:
            a, b = card[1].cpu(), host[1]
            gap = float(((a - b).abs() - TRUST_WEIGHT_REL * b.abs()).max())
            if gap > 1e-6:
                raise AssertionError(f"trust (d) {name}: weights beyond the tolerance: {a} {b}")
            notes.append(f"weights within {TRUST_WEIGHT_REL:g} rel")
        for what, a, b in (("updates", card[0], host[0]), ("aggregate", card[2], host[2]),
                           ("after", card[3], host[3])):
            if b is None:
                continue
            a = a.cpu()
            scale = max(1.0, float(b.abs().max()))
            diff = (a - b).abs()
            bad = int((diff > TRUST_REL * scale).sum())
            worst = max(worst, float(diff.max()) / scale)
            if bad and not (name == "outlier_detection" and what == "updates"
                            and bad <= OUTLIER_FLIPS_MAX):
                raise AssertionError(f"trust (d) {name}: {bad} {what} elements beyond "
                                     f"{TRUST_REL:g} of {scale:.3g}")
            if bad:
                notes.append(f"{bad} {what} elements at a mask boundary")
        want = 1 if name in ("weak_dp", "crfl") else 0
        if launched != want:
            raise AssertionError(f"trust (d) {name}: the noise kernel ran {launched} times, "
                                 f"expected {want}")
        print(f"  {name}: card {card[4] * 1e3:.2f} ms, CPU {host[4] * 1e3:.1f} ms; "
              f"{', '.join(notes)}; largest difference {worst:.3g} of the result's scale; "
              f"noise kernel {launched}")


def phase_trust(mods, nz, flagship):
    """Phase 10: trust in the simulator on the flagship (module docstring).
    Returns each kernel's launches over forms (a)-(c)."""
    import numpy as np
    import torch

    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.data.dataset import stack_clients
    from fedml_tpu_torch.weights import flatten_reference

    t_phase = time.perf_counter()
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    # (a) byzantine_random, defended by multikrum, against undefended
    runner, hist, counts, lengths = _trust_run(
        mods, nz, "(a) byzantine_random + multikrum", flagship, **TRUST_ATTACK, **TRUST_DEFENSE)
    add(counts)
    _noise_launches(counts, nz, lengths, [], "(a)")
    sim = runner.runner
    seen = _capture_aggregation(sim)
    per_step_defended = _profiled_round(sim, "(a) attack + multikrum")
    sampled = np.asarray(sim.sampler.sample(sim.round_idx - 1))
    kept = seen["kept"].cpu().numpy()
    attackers = [int(c) for c in sampled if int(c) in ATTACKERS]
    kept_attackers = [int(c) for c, k in zip(sampled, kept) if int(c) in ATTACKERS and k > 0]
    print(f"trust (a): round {sim.round_idx - 1} sampled attackers {attackers}; kept with a "
          f"non-zero weight: {kept_attackers}; {int((kept > 0).sum())} of {len(kept)} kept")
    defended_acc = sim.evaluate()["test_acc"]
    plain, phist, _, _ = _trust_run(mods, nz, "(a') byzantine_random undefended", flagship,
                                    **TRUST_ATTACK)
    clean = _flagship(flagship, comm_round=2, frequency_of_the_test=0)
    clean.runner.run_round()  # warm, as (a)'s profiled round is
    per_step_plain = _profiled_round(clean.runner, "no trust flag")
    print(f"trust (a): test_acc defended {defended_acc:.4f} against undefended "
          f"{phist[-1]['test_acc']:.4f}; cudaLaunchKernel a batched step with the defense "
          f"{per_step_defended:.0f}, with no trust flag {per_step_plain:.0f}")
    del plain, clean

    # (b) local DP: one launch of kernel 7 a round over the 64 updates
    _, _, counts, lengths = _trust_run(mods, nz, "(b) LDP Gaussian", flagship, **LDP)
    add(counts)
    _noise_launches(counts, nz, lengths, [LDP_LENGTH] * TRUST_ROUNDS, "(b)")
    # (c) central DP, then NbAFL (local and central)
    _, _, counts, lengths = _trust_run(mods, nz, "(c) CDP", flagship,
                                       **{**LDP, "dp_solution_type": "cdp"}, clipping_norm=1.0)
    add(counts)
    _noise_launches(counts, nz, lengths, [SECAGG_LENGTH] * TRUST_ROUNDS, "(c) CDP")
    _, _, counts, lengths = _trust_run(mods, nz, "(c) NbAFL", flagship,
                                       **{**LDP, "dp_solution_type": "nbafl"}, clipping_norm=1.0)
    add(counts)
    _noise_launches(counts, nz, lengths, [LDP_LENGTH, SECAGG_LENGTH] * TRUST_ROUNDS,
                    "(c) NbAFL")

    # (d) the captured round through all 24 defenses, card against CPU
    _all_defenses(nz, runner.runner.cfg, seen)
    del runner, sim, seen

    # (e) data attacks: the poisoned shards on the card bitwise the host's
    for attack in ("label_flipping", "backdoor"):
        r, _, counts, _ = _trust_run(mods, nz, f"(e) {attack}", flagship, rounds=1,
                                     enable_attack=True, attack_type=attack,
                                     poisoned_client_list=ATTACKERS)
        sim = r.runner
        host = stack_clients(sim.dataset, multiple_of=sim.cfg.batch_size)
        rows = list(ATTACKERS)
        x_host = torch.from_numpy(host.x[rows]).to(sim._data[0].dtype)
        same = (torch.equal(sim._data[0][rows].cpu(), x_host)
                and torch.equal(sim._data[1][rows].cpu(), torch.from_numpy(host.y[rows]).long()))
        changed = int((sim.dataset.train_y != flagship.train_y).sum()) + int(
            (sim.dataset.train_x != flagship.train_x).any(axis=(1, 2, 3)).sum())
        print(f"trust (e) {attack}: the {len(rows)} attackers' shards on the card "
              f"{'bitwise' if same else 'DIFFER from'} the host's poisoned stack; "
              f"{changed} labels / images changed")
        if not same or not changed:
            raise AssertionError(f"trust (e) {attack}: poisoned shards not bitwise, or nothing "
                                 "poisoned")
        del r, sim, host

    # (f) contribution, 2 clients a round: the replay bitwise under cuDNN
    # deterministic, then leave-one-out and GTG-Shapley
    torch.backends.cudnn.deterministic = True
    try:
        for method in ("leave_one_out", "gtg_shapley"):
            r = _flagship(flagship, comm_round=1, frequency_of_the_test=0,
                          client_num_per_round=CONTRIBUTION_CLIENTS, enable_contribution=True,
                          contribution_method=method)
            sim = r.runner
            assess, box = sim.assess_contribution, {}

            def timed(assess=assess, box=box):
                t0 = time.perf_counter()
                box["scores"] = assess()
                torch.cuda.synchronize()
                box["s"] = time.perf_counter() - t0
                return box["scores"]

            sim.assess_contribution = timed  # the run assesses once, at its end
            r.run()
            stacked, weights, sampled, snap = sim.last_round_contributions()
            agg = sim.algorithm.aggregate(stacked, torch.tensor(weights, device=sim.device))
            replayed, _ = sim.algorithm.server_update(snap["global_vars"], snap["server_state"],
                                                      agg, snap["round"])
            gap = float((flatten_reference(replayed)[0]
                         - flatten_reference(sim.global_vars)[0]).abs().max())
            scores = box["scores"]
            print(f"trust (f) {method}: {len(sampled)} clients {sampled.tolist()}, replay's "
                  f"global {'bitwise' if gap == 0 else f'off by {gap:.3g}'}; scores "
                  f"{np.round(scores, 4).tolist()} in {box['s']:.1f} s")
            if gap != 0 or not np.isfinite(scores).all():
                raise AssertionError(f"trust (f) {method}: replay off by {gap} or scores "
                                     f"{scores}")
            del r, sim, stacked
    finally:
        torch.backends.cudnn.deterministic = False

    # (g) MyAvg with a transforming defense and local DP
    _reset_counts(mods + (nz,))
    t0 = time.perf_counter()
    with _NoiseLengths(nz) as lengths:
        r = _recipe(MYAVG, fused_blocks=False, comm_round=3, enable_defense=True,
                    defense_type="norm_diff_clipping", norm_bound=1.0, **LDP)
        hist = r.run()
        torch.cuda.synchronize()
    pers = r.runner.evaluate_personalized()
    print(f"trust (g) myavg + norm_diff_clipping + LDP: 3 rounds in {time.perf_counter() - t0:.2f}"
          f" s incl. set-up, test_acc {hist[-1]['test_acc']:.4f}, personalized mean / min "
          f"{pers['personalized_test_acc_mean']:.4f} / {pers['personalized_test_acc_min']:.4f}, "
          f"noise kernel lengths {lengths.lengths}")
    if len(lengths.lengths) != 3 or _all_counts(mods + (nz,))[nz.NOISE.name] != 3:
        raise AssertionError("trust (g): local DP must launch the noise kernel once a round")
    _check_finite(r.runner, hist, ("train_loss",))

    # (h) resume with cross_round: 1 + 1 rounds bitwise 2
    import tempfile

    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            runs = {}
            for name, kw in (("straight", dict(comm_round=2)),
                             ("first", dict(comm_round=1, checkpoint_dir=tmp,
                                            checkpoint_every_rounds=1)),
                             ("resumed", dict(comm_round=2, checkpoint_dir=tmp, resume=True))):
                r = _flagship(flagship, frequency_of_the_test=0, enable_defense=True,
                              defense_type="cross_round", **kw)
                r.run()
                runs[name] = r.runner
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    a, b = runs["straight"], runs["resumed"]
    worst = max(float((x.float() - y.float()).abs().max())
                for x, y in zip(pt.tree_leaves(a.global_vars), pt.tree_leaves(b.global_vars)))
    hist_same = torch.equal(a.defense_history, b.defense_history)
    print(f"trust (h) cross_round resume: 1 round + checkpoint + 1 resumed against 2 straight: "
          f"globals {'bitwise' if worst == 0 else f'differ by {worst:.3g}'}, history "
          f"{'bitwise' if hist_same else 'DIFFERS'} (norm "
          f"{float(b.defense_history.norm()):.4g})")
    if worst != 0 or not hist_same or b.round_idx != 2:
        raise AssertionError("trust (h): the resumed run is not bitwise the straight one")
    print(f"trust phase: {time.perf_counter() - t_phase:.1f} s, {_mem()}")
    return totals


# phase 11: the rest of the model zoo, losses and loaders, on
# the synthetic fallbacks at the published widths
ZOO_CLIENTS, ZOO_PER_ROUND, ZOO_BATCH = 32, 8, 64  # the CIFAR-10 zoo's rounds
# the zoo's CIFAR-10 stand-in, cut from 50,000 / 10,000 images for the budget
ZOO_TRAIN, ZOO_TEST = 12800, 2000
ZOO_PROFILED = (("mobilenet", "batch"),)  # a profiled step with its top ops
ZOO_MODELS = (("mobilenet", "batch"), ("mobilenet_v3", "batch"), ("efficientnet", "batch"),
              ("vgg11", "batch"), ("vgg16", "batch"), ("mobilenet", "group"),
              ("resnet18_gn", "batch"))
SHAKESPEARE = dict(dataset="shakespeare", model="rnn", client_num_in_total=100,
                   client_num_per_round=10, batch_size=10, epochs=1, learning_rate=1.0,
                   compute_dtype="float32", synthetic_test_size=4000)
SHAKESPEARE_ROUNDS = 1  # one MESH round before the MESH-against-sp check
SHAKESPEARE_PAIR = 3  # that check's clients, cut from the recipe's 10 (sp runs them in turn)
STACKOVERFLOW = dict(dataset="stackoverflow_nwp", model="word_lstm", client_num_in_total=50,
                     partition_method="homo",
                     client_num_per_round=10, batch_size=16, epochs=1, learning_rate=0.3,
                     compute_dtype="float32", synthetic_train_size=2000,
                     synthetic_test_size=512)
# FedSGD's flat gradient of FEMNIST's FedAvg CNN (62 classes): its parameters
FEMNIST_GRAD_LENGTH = 1690046


def _config_runner(data=None, **kw):
    """``fedml_tpu_torch.init`` of a ``Config`` built from ``kw`` (the
    reference's defaults otherwise), then ``FedMLRunner`` on the card;
    ``data`` reuses an earlier run's dataset."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.runner import FedMLRunner

    return FedMLRunner(fedml_tpu_torch.init(Config(**kw)), dataset=data)


def _profile_once(call, what, top=0):
    """``call()`` once more under torch.profiler after one unprofiled call:
    wall, device busy share and ``cudaLaunchKernel``; with ``top`` the ops
    that take the most device time and the most host (self CPU) time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fedml_tpu_torch.obs.profile_round import busy_us

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = busy_us([e for e in prof.events() if e.device_type.name == "CUDA"]) / 1e6
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    print(f"{what}: wall {1e3 * wall:.1f} ms (profiler on), device busy {1e3 * busy:.1f} ms = "
          f"{100 * busy / wall:.1f}%, {launches} cudaLaunchKernel")
    for side, attr in (("device", "self_device_time_total"), ("host", "self_cpu_time_total")):
        ops = sorted(prof.key_averages(), key=lambda e: -getattr(e, attr))[:top]
        if ops:
            print(f"{what} top {side} ops: " + "; ".join(
                f"{e.key[:48]} {getattr(e, attr) / 1e3:.1f} ms ({e.count})" for e in ops))


def _profiled_step(sim, n_lanes, what, top=0):
    """One batched local step of ``n_lanes`` lanes (a budget of one step
    each) under :func:`_profile_once`.  A step, not a round: the profiler's
    post-processing of a whole LSTM round (124k launches) takes over a
    minute."""
    import numpy as np
    import torch

    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.fl.local_sgd import make_batched_local_train_fn, to_device

    lanes = np.arange(n_lanes)
    perms = torch.stack([sim.sampler.perms(0, int(c), sim.hp.epochs, sim.capacity)
                         for c in lanes])
    start = pt.tree_map(lambda t: t.unsqueeze(0).repeat((n_lanes,) + (1,) * t.ndim),
                        sim.global_vars)
    step = make_batched_local_train_fn(sim.model, sim.hp)
    args = (start, *sim._data, to_device(lanes, sim.device, torch.long),
            np.full(n_lanes, sim.cfg.batch_size), perms)
    _profile_once(lambda: step(*args), f"{what} profiled batched step ({n_lanes} lanes)", top)


def _lane_step_check(sim, n_lanes, what):
    """One batched local step of ``n_lanes`` lanes from the global
    variables (a budget of one step each, the sampler's permutations)
    against each lane trained alone, within rtol 2e-4 / atol 2e-5, in the
    model's dtype; a lane must also be ten times closer to its own step
    than to its neighbour's (the check is not vacuous)."""
    import numpy as np
    import torch

    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.fl.local_sgd import (make_batched_local_train_fn, make_local_train_fn,
                                              to_device)

    lanes = np.arange(n_lanes)
    bsz = sim.cfg.batch_size
    perms = torch.stack([sim.sampler.perms(0, int(c), sim.hp.epochs, sim.capacity)
                         for c in lanes])
    start = pt.tree_map(lambda t: t.unsqueeze(0).repeat((n_lanes,) + (1,) * t.ndim),
                        sim.global_vars)
    x, y = sim._data
    batched, _ = make_batched_local_train_fn(sim.model, sim.hp)(
        start, x, y, to_device(lanes, sim.device, torch.long), np.full(n_lanes, bsz), perms)
    single = make_local_train_fn(sim.model, sim.hp)
    own = [single(sim.global_vars, x[i], y[i], bsz, (0,), perms=perms[i])[0]
           for i in range(n_lanes)]
    worst, nearest = 0.0, math.inf
    for i in range(n_lanes):
        lane = pt.tree_map(lambda t: t[i], batched)
        diff, excess = _excess(lane, own[i])
        neighbour, _ = _excess(lane, own[(i + 1) % n_lanes])
        worst, nearest = max(worst, diff), min(nearest, neighbour)
        if excess > 0:
            raise AssertionError(f"{what}: lane {i}'s batched step is off its step alone by "
                                 f"{diff:.3g}, beyond rtol {MESH_SP_RTOL} / atol {MESH_SP_ATOL}")
        if neighbour < 10 * max(diff, MESH_SP_ATOL):
            raise AssertionError(f"{what}: lane {i} is {neighbour:.3g} from its neighbour's step, "
                                 f"not ten times its {max(diff, MESH_SP_ATOL):.3g}")
    dtype = str(getattr(sim.model, "dtype", torch.float32)).replace("torch.float", "f")
    print(f"{what} {dtype} check: one batched step of {n_lanes} lanes vs each lane alone, largest "
          f"difference {worst:.3g} (rtol {MESH_SP_RTOL}, atol {MESH_SP_ATOL}), a neighbour's step "
          f"at least {nearest:.3g} away")


def _zoo_round_lines(what, sim, probe, unit, note=""):
    for metrics, cum, mem in probe.rows:
        own = _own_steps(sim, metrics["round"])
        print(f"{what} round {metrics['round']}{note}: {metrics['round_time_s']:.3f} s, "
              f"{int(own.sum()) * sim.cfg.batch_size / metrics['round_time_s']:.0f} trained "
              f"{unit}/s ({int(own.max())} batched steps of up to {len(own)} lanes), train_loss "
              f"{metrics['train_loss']:.4f}, test_loss {metrics.get('test_loss', float('nan')):.4f}"
              f", test_acc {metrics.get('test_acc', float('nan')):.4f}, {_mem(mem)}")


def phase_zoo_text(mods, add):
    """11 (a) FedAvg Shakespeare with the character LSTM, (b) StackOverflow
    next-word prediction with the word LSTM."""
    import torch

    t0 = time.perf_counter()
    runner = _config_runner(comm_round=SHAKESPEARE_ROUNDS, frequency_of_the_test=1,
                            **SHAKESPEARE)
    sim, cfg = runner.runner, runner.cfg
    print(f"zoo (a) shakespeare: set-up {time.perf_counter() - t0:.1f} s (data "
          f"{sim.dataset.train_num}/{sim.dataset.test_num} sequences of "
          f"{sim.dataset.train_x.shape[1]}, vocab {sim.dataset.class_num}, "
          f"{sim.dataset.n_clients} clients, {cfg.client_num_per_round}/round, capacity "
          f"{sim.capacity}, batch {cfg.batch_size}, {cfg.compute_dtype}, model "
          f"{type(sim.model).__name__}, backend {sim.backend})")
    if sim.backend != "MESH" or sim._data[0].dtype != torch.int32:
        raise AssertionError(f"shakespeare: backend {sim.backend}, tokens {sim._data[0].dtype}")
    probe = _RoundProbe(sim.logger, lambda: _all_counts(mods))
    sim.logger = probe
    _reset_counts(mods)
    history = runner.run()
    torch.cuda.synchronize()
    add(_all_counts(mods))
    _zoo_round_lines("zoo (a) shakespeare", sim, probe, "sequences")
    _check_finite(sim, history, ("train_loss", "test_loss", "test_acc"))
    _profiled_step(sim, cfg.client_num_per_round, "zoo (a) shakespeare")
    _lane_step_check(sim, cfg.client_num_per_round, "zoo (a) shakespeare")
    pair = {}
    for backend in ("MESH", "sp"):
        r = _config_runner(runner.dataset, comm_round=1, frequency_of_the_test=0,
                           backend_sim=backend,
                           **{**SHAKESPEARE, "client_num_per_round": SHAKESPEARE_PAIR}).runner
        _reset_counts(mods)
        t0 = time.perf_counter()
        r.run_round()
        torch.cuda.synchronize()
        add(_all_counts(mods))
        pair[backend] = (r.global_vars, time.perf_counter() - t0)
    worst, excess = _excess(pair["MESH"][0], pair["sp"][0])
    print(f"zoo (a) MESH vs sp: one round of {SHAKESPEARE_PAIR} clients from the same weights, "
          f"MESH {pair['MESH'][1]:.3f} s, "
          f"sp {pair['sp'][1]:.3f} s, largest global difference {worst:.3g} (rtol "
          f"{MESH_SP_RTOL}, atol {MESH_SP_ATOL})")
    if excess > 0:
        raise AssertionError(f"shakespeare: MESH and sp rounds differ by {worst:.3g}")
    del runner, sim, pair

    t0 = time.perf_counter()
    runner = _config_runner(comm_round=1, frequency_of_the_test=1, **STACKOVERFLOW)
    sim, cfg = runner.runner, runner.cfg
    print(f"zoo (b) stackoverflow_nwp: set-up {time.perf_counter() - t0:.1f} s (data "
          f"{sim.dataset.train_num}/{sim.dataset.test_num} sequences of "
          f"{sim.dataset.train_x.shape[1]}, vocab {sim.dataset.class_num}, "
          f"{sim.dataset.n_clients} clients, {cfg.client_num_per_round}/round, batch "
          f"{cfg.batch_size}, model {type(sim.model).__name__}, backend {sim.backend})")
    probe = _RoundProbe(sim.logger, lambda: _all_counts(mods))
    sim.logger = probe
    _reset_counts(mods)
    torch.cuda.reset_peak_memory_stats()
    history = runner.run()
    torch.cuda.synchronize()
    add(_all_counts(mods))
    _zoo_round_lines("zoo (b) stackoverflow_nwp", sim, probe, "sequences")
    _check_finite(sim, history, ("train_loss", "test_loss", "test_acc"))


def phase_zoo_cifar(mods, add):
    """11 (c): the CIFAR-10 zoo, one MESH round each with a test evaluation
    and a batched step against each lane alone (f32; f64 under BatchNorm);
    ``resnet20`` with GroupNorm and ``fused_blocks`` launches none of
    kernels 1-4."""
    import dataclasses

    import torch

    from fedml_tpu_torch.core import pytree as pt

    fb = mods[0]
    data = None
    base = dict(dataset="cifar10", client_num_in_total=ZOO_CLIENTS,
                client_num_per_round=ZOO_PER_ROUND, batch_size=ZOO_BATCH, comm_round=1,
                frequency_of_the_test=1, synthetic_train_size=ZOO_TRAIN,
                synthetic_test_size=ZOO_TEST)
    for name, norm in ZOO_MODELS + (("resnet20", "group"),):
        extra = {"fused_blocks": True} if name == "resnet20" else {}
        t0 = time.perf_counter()
        runner = _config_runner(data, model=name, norm=norm, compute_dtype="bfloat16",
                                extra=extra, **base)
        data, sim = runner.dataset, runner.runner
        n_params = sum(t.numel() for t in pt.tree_leaves(sim.global_vars["params"]))
        what = f"zoo (c) {name} {norm}"
        probe = _RoundProbe(sim.logger, lambda: _all_counts(mods))
        sim.logger = probe
        _reset_counts(mods)
        torch.cuda.reset_peak_memory_stats()
        history = runner.run()
        torch.cuda.synchronize()
        counts = _all_counts(mods)
        add(counts)
        print(f"{what}: set-up {time.perf_counter() - t0 - history[0]['round_time_s']:.1f} s, "
              f"{type(sim.model).__name__}, {n_params} parameters, bf16, "
              f"{'no batch_stats' if 'batch_stats' not in sim.global_vars else 'batch_stats'}")
        _zoo_round_lines(what, sim, probe, "samples", " (the first: cuDNN's set-up included)")
        _check_finite(sim, history, ("train_loss", "test_loss", "test_acc"))
        if (name, norm) in ZOO_PROFILED:
            _profiled_step(sim, ZOO_PER_ROUND, what, top=6)
        fused = [k.name for k in fb.KERNELS + fb.LANE_KERNELS if counts[k.name]]
        if fused:
            raise AssertionError(f"{what}: kernels 1-4 launched ({fused}); GroupNorm and the "
                                 "zoo have no fused epilogue")
        if name != "resnet20":
            check = _config_runner(data, model=name, norm=norm, compute_dtype="float32",
                                   **base).runner
            check.global_vars = pt.tree_map(torch.clone, sim.global_vars)
            if "batch_stats" in check.global_vars:  # f64 (module docstring, 11 (c))
                check.model = dataclasses.replace(check.model, dtype=torch.float64)
                check.global_vars = pt.tree_map(lambda t: t.double() if t.is_floating_point() else t,
                                                 check.global_vars)
            _lane_step_check(check, ZOO_PER_ROUND, what)
            del check
        del runner, sim


def phase_zoo_fedsgd(mods, qz, add):
    """11 (d): FedSGD ``qsgd_int8`` on ``femnist`` with ``model: cnn`` (the
    dropout in the full-gradient pass): 16 clients, one MESH round (rows 5-6
    once in their lanes variants at 16 x 1,690,046), one sp round (16 each
    single-lane), one Mime round; then rows 5-6 at that length against
    their plain versions, with device time and bound."""
    import torch

    from fedml_tpu_torch import weights as wl

    rows = {}
    for form, overrides in (("MESH", {}), ("sp", {"backend_sim": "sp"}),
                            ("Mime", {"federated_optimizer": "Mime"})):
        t0 = time.perf_counter()
        runner = _zoo_fedsgd(rows.get("dataset"), comm_round=1, frequency_of_the_test=1,
                             compression="qsgd_int8", **overrides)
        sim, cfg = runner.runner, runner.cfg
        rows["dataset"] = runner.dataset
        n = int(wl.flatten_reference(sim.global_vars["params"])[0].numel())
        if n != FEMNIST_GRAD_LENGTH or sim.model.dropout_shape(cfg.batch_size) is None:
            raise AssertionError(f"femnist cnn: {n} parameters, dropout "
                                 f"{sim.model.dropout_shape(cfg.batch_size)}")
        setup = time.perf_counter() - t0
        _reset_counts(mods)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        history = runner.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _all_counts(mods)
        add(counts)
        batches = cfg.client_num_per_round * (sim.capacity // cfg.batch_size)
        print(f"zoo (d) femnist cnn {cfg.federated_optimizer} {sim.backend}: set-up {setup:.1f} s "
              f"({sim.dataset.train_num}/{sim.dataset.test_num} images, {sim.dataset.n_clients} "
              f"clients all a round, capacity {sim.capacity}, batch {cfg.batch_size}, "
              f"{cfg.compute_dtype}, dropout {1 - sim.model.keep_prob} in the full-gradient "
              f"pass), 1 round in {history[0]['round_time_s']:.3f} s ({wall:.3f} s with the "
              f"evaluation), {batches * cfg.batch_size / history[0]['round_time_s']:.0f} gradient "
              f"samples/s, test_loss {history[0]['test_loss']:.4f}, test_acc "
              f"{history[0]['test_acc']:.4f}, {_mem()}, launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        _check_finite(sim, history, ("test_loss", "test_acc"))
        clients = cfg.client_num_per_round
        if form == "MESH":
            want = {k.name: 1 for k in qz.LANE_KERNELS}
            want.update({k.name: 0 for k in qz.KERNELS})
        elif form == "sp":
            want = {k.name: clients for k in qz.KERNELS}
            want.update({k.name: 0 for k in qz.LANE_KERNELS})
        else:  # Mime compresses nothing
            want = {k.name: 0 for k in qz.KERNELS + qz.LANE_KERNELS}
        for k, v in want.items():
            if counts[k] != v:
                raise AssertionError(f"zoo (d) {form}: {k} launched {counts[k]} times, expected "
                                     f"{v}")
        del runner, sim
    return phase_lane_quantize(qz, FEMNIST_GRAD_LENGTH)


def _zoo_fedsgd(dataset=None, **overrides):
    """The FedSGD recipe on ``femnist`` with the FedAvg CNN."""
    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = fedml_tpu_torch.init(argv=["--cf", FEDSGD])
    cfg.dataset, cfg.model = "femnist", "cnn"
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return FedMLRunner(cfg, dataset=dataset)


def phase_zoo(mods, qz):
    """Phase 11 (module docstring).  Returns each kernel's launches over its
    paths and rows 5-6 lanes at the FEMNIST CNN's length."""
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    t0 = time.perf_counter()
    phase_zoo_text(mods, add)
    t1 = time.perf_counter()
    phase_zoo_cifar(mods, add)
    t2 = time.perf_counter()
    femnist_rows = phase_zoo_fedsgd(mods, qz, add)
    t3 = time.perf_counter()
    print(f"zoo: phase 11 {t3 - t0:.1f} s ((a)-(b) {t1 - t0:.1f} s, (c) {t2 - t1:.1f} s, (d) "
          f"{t3 - t2:.1f} s), launches over its paths {totals}")
    return totals, femnist_rows



# phase 12: the hub-model simulators and the population engine
DSGD_CLIENTS = 64  # decentralized: every client a lane, every round
DSGD_ROUNDS = 2
GOSSIP_ROUNDS = {"dsgd": DSGD_ROUNDS, "ring": 1, "pushsum": 1}
ASYNC_ARRIVALS = 16  # cut from 32 in slice 18
TA_ROUNDS = 2
TA_FLAGS = {"ta_group_num": 4, "ta_dropout_prob": 0.1}
TA_SIGMA = 10.0  # the masks' scale (reference turboaggregate.py L91)
# the masked ring's aggregate against the plain weighted mean of the
# survivors, relative L2: the masks of scale 10 cancel to within f32
# rounding of sums of that scale, not of the weights' (measured 1.06e-4 on
# the CPU for 58 rows of ResNet-20's 271,098 elements in 4 groups)
TA_AGG_REL = 5e-4
MIX_REL = 1e-6  # a gossip mix on the card against the same product in f64
PUSHSUM_MASS_REL = 1e-5
POPULATION = {"population_size": 1_000_000, "population_shard_size": 16,
              "population_shards_per_cohort": 4, "population_max_resident_shards": 4}
POP_RTOL, POP_ATOL = 2e-5, 2e-6  # the reference's own (tests/test_population.py)
# phase 3's in-memory flagship round times, for the population rounds
_MAIN_ROUNDS = []


def _slice15(path, dataset, extra=None, **overrides):
    """``_recipe`` with ``extra`` entries added to the config's."""
    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = fedml_tpu_torch.init(argv=["--cf", path])
    cfg.extra["fused_blocks"] = True
    cfg.extra.update(extra or {})
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return FedMLRunner(cfg, dataset=dataset)


def _single_lane_sites(fb, delta, steps, evals, what):
    """Rows 1-4 single-lane: 10 / 9 / 10 / 9 launches a local step, the
    forwards also once a site a test batch; no lane variant."""
    want = {fb.FWD.name: 10 * (steps + evals), fb.FWD_RES.name: 9 * (steps + evals),
            fb.BWD.name: 10 * steps, fb.BWD_RES.name: 9 * steps,
            **{k.name: 0 for k in fb.LANE_KERNELS}}
    for name, n in want.items():
        if delta[name] != n:
            raise AssertionError(f"{what}: {name} launched {delta[name]} times, expected {n}")


def phase_gossip(mods, dataset):
    """12 (a): DSGD on the flagship recipe with 64 clients, every one a lane
    of every round; then the ring and PushSum.  Each mix held against the
    same product in f64 on the CPU."""
    import numpy as np
    import torch

    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.parallel import topology as topo

    fb = mods[0]
    counts_all = {}
    for mode, rounds in GOSSIP_ROUNDS.items():
        t0 = time.perf_counter()
        runner = _slice15(FLAGSHIP, dataset, {"decentralized_mode": mode},
                          federated_optimizer="decentralized_fl", client_num_in_total=DSGD_CLIENTS,
                          client_num_per_round=DSGD_CLIENTS, comm_round=rounds,
                          frequency_of_the_test=1)
        sim, cfg = runner.runner, runner.cfg
        own = np.minimum(sim.hp.epochs * -(-sim.counts // cfg.batch_size), sim.hp.local_steps)
        steps = int(own.max())
        mixes = []
        mix = sim.mix

        def kept_mix(tree, mix=mix, mixes=mixes):
            # copies on the card (each a few tens of microseconds); they
            # cross to the host after the run, outside the rounds' times
            out = mix(tree)
            mixes.append((pt.stacked_tree_to_matrix(tree), pt.stacked_tree_to_matrix(out)))
            return out

        sim.mix = kept_mix
        probe = _RoundProbe(sim.logger, lambda: _all_counts(mods))
        sim.logger = probe
        print(f"gossip (a) {mode}: set-up {time.perf_counter() - t0:.1f} s ({sim.n} clients all "
              f"a round, capacity {sim.capacity}, batch {cfg.batch_size}, {cfg.compute_dtype}, "
              f"{steps} batched steps a round, {int(own.sum())} lane-steps; W "
              f"{'never built' if mode == 'ring' else f'{int((sim.W_host > 0).sum())} non-zeros'})")
        _reset_counts(mods)
        torch.cuda.reset_peak_memory_stats()
        history = runner.run()
        torch.cuda.synchronize()
        prev = {k: 0 for k in _all_counts(mods)}
        for metrics, cum, mem in probe.rows:
            delta = {k: cum[k] - prev[k] for k in cum}
            prev = cum
            print(f"gossip (a) {mode} round {metrics['round']}: {metrics['round_time_s']:.3f} s, "
                  f"{int(own.sum()) * cfg.batch_size / metrics['round_time_s']:.0f} trained "
                  f"samples/s, {steps} batched steps of {sim.n} lanes, train_loss "
                  f"{metrics['train_loss']:.4f}, consensus_dist {metrics['consensus_dist']:.6g}, "
                  f"test_acc {metrics['test_acc']:.4f}, {_mem(mem)}, launches "
                  f"{ {k: v for k, v in delta.items() if v} }")
            _check_lane_sites(fb, delta, steps, f"gossip (a) {mode} round {metrics['round']}")
            for k in (fb.BWD, fb.BWD_RES):
                if delta[k.name]:
                    raise AssertionError(f"gossip (a) {mode}: {k.name} launched: a client "
                                         "trained alone")
        _check_finite(types.SimpleNamespace(global_vars=sim.client_vars), history,
                      ("train_loss", "test_loss", "test_acc", "consensus_dist"))
        W = topo.ring_topology(sim.n) if mode == "ring" else sim.W_host
        worst = 0.0
        for before, after in mixes:
            before, after = before.cpu(), after.cpu()
            want = torch.from_numpy(W.astype(np.float64)) @ before.double()
            worst = max(worst, float((after.double() - want).norm() / want.norm()))
        print(f"gossip (a) {mode}: {len(mixes)} mixes of {tuple(mixes[0][0].shape)} on the card "
              f"against {'ring_topology(n) @ P' if mode == 'ring' else 'W @ P'} in f64 on the "
              f"CPU: largest relative L2 {worst:.3g} (limit {MIX_REL})")
        if worst > MIX_REL:
            raise AssertionError(f"gossip (a) {mode}: a mix is {worst:.3g} from f64")
        if mode == "pushsum":
            mass = float(sim.push_weights.double().sum())
            print(f"gossip (a) pushsum: push weights sum {mass:.9g} over {sim.n} clients, "
                  f"range [{float(sim.push_weights.min()):.6g}, "
                  f"{float(sim.push_weights.max()):.6g}]")
            if abs(mass - sim.n) > PUSHSUM_MASS_REL * sim.n:
                raise AssertionError(f"gossip (a) pushsum: weights sum to {mass}")
        counts_all = {k: counts_all.get(k, 0) + v for k, v in _all_counts(mods).items()}
        del runner, sim, mixes
    return counts_all


def phase_async(mods, flagship):
    """12 (b): asynchronous FedAvg on the flagship recipe, 16 arrivals: each
    a client trained alone from a stale global (rows 1-4 single-lane)."""
    import torch

    fb = mods[0]
    t0 = time.perf_counter()
    runner = _slice15(FLAGSHIP, flagship, federated_optimizer="Async_FedAvg",
                      comm_round=ASYNC_ARRIVALS, frequency_of_the_test=ASYNC_ARRIVALS)
    sim, cfg = runner.runner, runner.cfg
    probe = _RoundProbe(sim.logger, lambda: _all_counts(mods))
    sim.logger = probe
    print(f"async (b): set-up {time.perf_counter() - t0:.1f} s ({sim.dataset.n_clients} clients, "
          f"{ASYNC_ARRIVALS} arrivals, staleness {cfg.async_staleness_func} alpha "
          f"{cfg.async_staleness_alpha}, batch {cfg.batch_size}, {cfg.compute_dtype})")
    _reset_counts(mods)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    history = runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prev = {k: 0 for k in _all_counts(mods)}
    steps_all, stale, samples = 0, [], 0
    for metrics, cum, mem in probe.rows:
        delta = {k: cum[k] - prev[k] for k in cum}
        prev = cum
        steps = int(metrics["num_steps"])
        evals = _eval_batches(sim) if "test_acc" in metrics else 0
        _single_lane_sites(fb, delta, steps, evals, f"async (b) step {metrics['round']}")
        steps_all += steps
        samples += steps * cfg.batch_size
        stale.append(int(metrics["staleness"]))
    times = [m["round_time_s"] for m, _, _ in probe.rows]
    print(f"async (b): {len(history)} arrivals in {wall:.3f} s (evaluation included), a step "
          f"{1e3 * min(times):.1f}-{1e3 * max(times):.1f} ms (median "
          f"{1e3 * statistics.median(times):.1f}), {steps_all} local steps, "
          f"{samples / sum(times):.0f} trained samples/s; clients "
          f"{[int(m['client']) for m, _, _ in probe.rows]}, staleness "
          f"{stale}; test_acc {history[-1]['test_acc']:.4f}, {_mem()}")
    _check_finite(sim, history, ("train_loss",))
    _check_finite(sim, history[-1:], ("test_loss", "test_acc"))
    if len(set(stale)) < 2:
        raise AssertionError(f"async (b): staleness drawn {stale}")
    return _all_counts(mods)


class _TAProbe(_RoundProbe):
    """At each logged Turbo-Aggregate round: row 7's launches and lengths,
    each group's masked rows (the audit's host copies) against the plain
    version, the aggregate against the survivors' weighted mean, the audit.
    The round's trained lanes and mask draws are kept by reference as the
    round makes them; the checks run after the round's time is taken."""

    def __init__(self, inner, counts, sim, nz):
        super().__init__(inner, counts)
        self.sim, self.nz, self.checks = sim, nz, []
        self.trained, self.noise = None, {}
        train, masks = sim._train, sim.sampler.ta_masks

        def kept_train(*args):
            out = train(*args)
            self.trained = out[0]
            return out

        def kept_masks(r, g, shape, device):
            self.noise[g] = masks(r, g, shape, device)
            return self.noise[g]

        sim._train, sim.sampler.ta_masks = kept_train, kept_masks

    def log(self, metrics, step=None):
        import numpy as np
        import torch

        from fedml_tpu_torch.core import pytree as pt
        from fedml_tpu_torch.weights import flatten_reference

        sim, last = self.sim, self.sim.last_round
        matrix, w = pt.stacked_tree_to_matrix(self.trained), last["weights"]
        sigma = matrix.new_full((), TA_SIGMA)
        bitwise = True
        for g, members in enumerate(last["groups"]):
            if not len(members):
                continue
            rows = torch.from_numpy(np.asarray(members, np.int64)).to(matrix.device)
            x = matrix.index_select(0, rows) * w.index_select(0, rows)[:, None]
            plain = (x.reshape(-1) + self.noise[g].reshape(-1) * sigma).cpu()
            seen = torch.from_numpy(np.stack(sim.observed_by_group[g][:-1]))
            bitwise = bitwise and torch.equal(seen.reshape(-1), plain)
        wd = w.double()
        mean = (matrix.double() * wd[:, None]).sum(0) / wd.sum()
        agg = flatten_reference(sim.global_vars)[0].double()
        rel = float((agg - mean).norm() / mean.norm())
        norms = [float(np.linalg.norm(row)) for seen in sim.observed_by_group
                 for row in seen[:-1]]
        self.checks.append({"bitwise": bitwise, "rel": rel, "alive": int(last["alive"].sum()),
                            "groups": [len(g) for g in last["groups"]],
                            "lengths": list(last["lengths"]), "min_norm": min(norms)})
        self.trained, self.noise = None, {}
        super().log(metrics, step)


def phase_turboaggregate(mods, nz, flagship):
    """12 (c): Turbo-Aggregate on the flagship recipe (64 of 128 clients a
    round as lanes), 4 groups, dropout 0.1: row 7 once a non-empty group."""
    import torch

    fb = mods[0]
    t0 = time.perf_counter()
    runner = _slice15(FLAGSHIP, flagship, TA_FLAGS, federated_optimizer="TA",
                      comm_round=TA_ROUNDS, frequency_of_the_test=1)
    sim, cfg = runner.runner, runner.cfg
    probe = _TAProbe(sim.logger, lambda: _all_counts(mods + (nz,)), sim, nz)
    sim.logger = probe
    print(f"turboaggregate (c): set-up {time.perf_counter() - t0:.1f} s "
          f"({cfg.client_num_per_round} of {sim.dataset.n_clients} clients a round as lanes, "
          f"{sim.n_groups} groups, dropout {sim.dropout_prob}, masks sigma {TA_SIGMA})")
    _reset_counts(mods + (nz,))
    torch.cuda.reset_peak_memory_stats()
    history = runner.run()
    torch.cuda.synchronize()
    prev = {k: 0 for k in _all_counts(mods + (nz,))}
    lengths = []
    for (metrics, cum, mem), check in zip(probe.rows, probe.checks):
        delta = {k: cum[k] - prev[k] for k in cum}
        prev = cum
        r = metrics["round"]
        own = _own_steps(sim, r)
        lengths.extend(check["lengths"])
        print(f"turboaggregate (c) round {r}: {metrics['round_time_s']:.3f} s, "
              f"{int(own.sum()) * cfg.batch_size / metrics['round_time_s']:.0f} trained samples/s, "
              f"{int(own.max())} batched steps, {check['alive']} of {len(own)} alive in groups "
              f"{check['groups']}, row 7 lengths {check['lengths']}, masked rows "
              f"{'bitwise' if check['bitwise'] else 'NOT bitwise'} the plain x + noise * 10, "
              f"aggregate against the survivors' weighted mean {check['rel']:.3g} relative L2 "
              f"(limit {TA_AGG_REL}), smallest masked row norm {check['min_norm']:.1f}, "
              f"test_acc {metrics['test_acc']:.4f}, {_mem(mem)}, launches "
              f"{ {k: v for k, v in delta.items() if v} }")
        _check_lane_sites(fb, delta, int(own.max()), f"turboaggregate (c) round {r}")
        if delta[nz.NOISE.name] != len(check["lengths"]) or not check["bitwise"]:
            raise AssertionError(f"turboaggregate (c) round {r}: {delta[nz.NOISE.name]} noise "
                                 f"launches for {len(check['lengths'])} groups, bitwise "
                                 f"{check['bitwise']}")
        if check["rel"] > TA_AGG_REL or check["min_norm"] <= TA_SIGMA:
            raise AssertionError(f"turboaggregate (c) round {r}: aggregate {check['rel']:.3g} "
                                 f"from the mean, a masked row of norm {check['min_norm']}")
    _check_finite(sim, history, ("train_loss", "test_loss", "test_acc"))
    return _all_counts(mods + (nz,)), max(lengths)


def phase_centralized(mods, flagship):
    """12 (d): the flagship's data as one client, one epoch (391 single-lane
    steps) and an evaluation."""
    import torch

    fb = mods[0]
    t0 = time.perf_counter()
    runner = _slice15(FLAGSHIP, flagship, training_type="centralized", comm_round=1)
    sim, cfg = runner.runner, runner.cfg
    print(f"centralized (d): set-up {time.perf_counter() - t0:.1f} s ({sim.n_real} images as "
          f"one client, tiled to {sim.capacity}, batch {cfg.batch_size}, {cfg.compute_dtype})")
    _reset_counts(mods)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    history = runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _all_counts(mods)
    m = history[0]
    steps = int(m["num_steps"])
    print(f"centralized (d): {steps} steps in {m['round_time_s']:.3f} s "
          f"({steps * cfg.batch_size / m['round_time_s']:.0f} trained samples/s; {wall:.3f} s "
          f"with the evaluation), train_loss {m['train_loss']:.4f}, test_loss "
          f"{m['test_loss']:.4f}, test_acc {m['test_acc']:.4f}, {_mem()}, launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if steps != sim.hp.steps_per_epoch:
        raise AssertionError(f"centralized (d): {steps} steps, expected {sim.hp.steps_per_epoch}")
    _single_lane_sites(fb, counts, steps, _eval_batches(sim), "centralized (d)")
    _check_finite(types.SimpleNamespace(global_vars=sim.variables), history,
                  ("train_loss", "test_loss", "test_acc"))
    return counts


def _population_run(path, dataset, root, extra, mods, **overrides):
    """A population-store run through the runner; its history, simulator
    and the round lines' launches."""
    import torch

    runner = _slice15(path, dataset, {"population_store": root, **extra}, **overrides)
    sim = runner.runner
    probe = _RoundProbe(sim.logger, lambda: _all_counts(mods))
    sim.logger = probe
    _reset_counts(mods)
    history = runner.run()
    torch.cuda.synchronize()
    return history, sim, probe


def phase_population(mods, flagship, fedopt_data):
    """12 (e): the flagship recipe over a million-id population store (2
    FedAvg rounds, 1 SCAFFOLD round: client state through the store); then
    the FedOpt recipe's full cohort from a store of its own 64 clients
    against the in-memory round."""
    import tempfile

    import torch

    from fedml_tpu_torch.core import pytree as pt

    fb = mods[0]
    counts_all = {}
    with tempfile.TemporaryDirectory(prefix="fedml_pop_") as tmp:
        for name, rounds, opt in (("FedAvg", 2, "FedAvg"), ("SCAFFOLD", 1, "SCAFFOLD")):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            history, sim, probe = _population_run(
                FLAGSHIP, flagship, f"{tmp}/{name}", POPULATION, mods, comm_round=rounds,
                frequency_of_the_test=1, federated_optimizer=opt)
            wall = time.perf_counter() - t0
            pop = sim._population
            store = pop.store
            prev = {k: 0 for k in _all_counts(mods)}
            for metrics, cum, mem in probe.rows:
                delta = {k: cum[k] - prev[k] for k in cum}
                prev = cum
                print(f"population (e) {name} round {metrics['round']}: "
                      f"{metrics['round_time_s']:.3f} s (phase 3's in-memory rounds "
                      f"{', '.join(f'{t:.3f}' for t in _MAIN_ROUNDS)} s), train_loss "
                      f"{metrics['train_loss']:.4f}, test_acc "
                      f"{metrics.get('test_acc', float('nan')):.4f}, {_mem(mem)}, launches "
                      f"{ {k: v for k, v in delta.items() if v} }")
                if not all(delta[k.name] for k in fb.LANE_KERNELS):
                    raise AssertionError(f"population (e) {name}: a lane kernel never launched")
            print(f"population (e) {name}: {rounds} rounds in {wall:.1f} s with set-up, "
                  f"{store.spec.n_clients} ids in {store.spec.n_shards} shards of "
                  f"{store.spec.shard_size}, cohort {pop.m}; {store.disk_bytes()} bytes on disk "
                  f"in {len(list(store.root.glob('shard_*.npz')))} shard files, lookups "
                  f"{store.hits} hits / {store.misses} misses, resident {store.resident}, "
                  f"gather {store.gather_s:.3f} s, scatter {store.scatter_s:.3f} s, prefetch "
                  f"overlap mean {pop.pipeline.overlap_mean():.3f} (last "
                  f"{pop.pipeline.last_overlap:.3f})")
            _check_finite(sim, history, ("train_loss", "test_loss", "test_acc"))
            if name == "SCAFFOLD" and store.scatter_s <= 0:
                raise AssertionError("population (e): SCAFFOLD scattered no client state")
            counts_all = {k: counts_all.get(k, 0) + v for k, v in _all_counts(mods).items()}
            pop.pipeline.close()
            del sim, history, probe
        # the check: the FedOpt recipe's 64 clients, all a round, store-backed
        # against in-memory from the same weights, cuDNN deterministic
        torch.backends.cudnn.deterministic = True
        try:
            over = dict(comm_round=1, frequency_of_the_test=0, client_num_per_round=64)
            t0 = time.perf_counter()
            mem = _slice15(FEDOPT, fedopt_data, **over)
            mem.run()
            mem_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            _, sim, _ = _population_run(FEDOPT, fedopt_data, f"{tmp}/check",
                                        {"population_shard_size": 16,
                                         "population_max_resident_shards": 4}, mods, **over)
            pop_s = time.perf_counter() - t0
            worst, excess = 0.0, 0.0
            for a, b in zip(pt.tree_leaves(sim.global_vars),
                            pt.tree_leaves(mem.runner.global_vars)):
                diff = (a.double() - b.double()).abs()
                worst = max(worst, float(diff.max()))
                excess = max(excess, float((diff - POP_ATOL - POP_RTOL * b.double().abs()).max()))
            print(f"population (e) check: the FedOpt recipe's {sim.dataset.n_clients} clients all "
                  f"a round, store-backed ({sim._population.store.spec.n_shards} shards, "
                  f"{pop_s:.1f} s) against in-memory ({mem_s:.1f} s), one round: largest global "
                  f"difference {worst:.3g} (rtol {POP_RTOL}, atol {POP_ATOL}: "
                  f"{'within' if excess <= 0 else 'BEYOND'})")
            if excess > 0:
                raise AssertionError(f"population (e): store-backed global {worst:.3g} from the "
                                     "in-memory one")
            sim._population.pipeline.close()
        finally:
            torch.backends.cudnn.deterministic = False
    return counts_all


def phase_slice15(mods, nz, flagship, fedopt_data):
    """Phase 12 (module docstring).  Returns each kernel's launches over its
    forms and row 7's largest Turbo-Aggregate length."""
    import torch

    totals, walls, peaks = {}, {}, {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    for form, fn in (("a", lambda: phase_gossip(mods, fedopt_data)),
                     ("b", lambda: phase_async(mods, flagship)),
                     ("c", lambda: phase_turboaggregate(mods, nz, flagship)),
                     ("d", lambda: phase_centralized(mods, flagship)),
                     ("e", lambda: phase_population(mods, flagship, fedopt_data))):
        _phase_start()
        t0 = time.perf_counter()
        out = fn()
        if form == "c":
            out, ta_length = out
        add(out)
        walls[form] = time.perf_counter() - t0
        peaks[form] = torch.cuda.max_memory_allocated() - _PHASE_BASE["bytes"]
    print(f"slice 15: phase 12 {sum(walls.values()):.1f} s ("
          + ", ".join(f"({k}) {v:.1f} s" for k, v in walls.items())
          + f"), its own peak {max(peaks.values()) / 2**30:.3f} GiB ("
          + ", ".join(f"({k}) {v / 2**30:.3f}" for k, v in peaks.items())
          + f" GiB), launches over its forms {totals}")
    return totals, ta_length

# phase 13 (slice 16): the simulators that build their own networks.  None
# of the seven kernels runs there (the split halves are unfused, the GAN,
# DARTS, UNet and VFL nets plain); every form is f32 with TF32 off.
# cut from 12,800 in slice 18
OWN_CIFAR = dict(dataset="cifar10", synthetic_train_size=6400, synthetic_test_size=2000)
SPLIT_CLIENTS = 8
# SplitNN's and FedGKT's rate: plain SGD at which the GroupNorm ResNet-56
# halves' losses stay finite (the reference's FedGKT at 0.1 reached 847.1;
# the port's FedGKT at 0.1 diverged on the CPU, at 0.01 its first round's
# loss was near 20 before it settled)
SPLIT_LR = 0.003
SPLIT_BATCH = 128
VFL_SIZE = dict(dataset="lending_club", synthetic_train_size=50000, synthetic_test_size=10000)
GAN_SIZE = dict(dataset="mnist", synthetic_train_size=60000, synthetic_test_size=10000,
                client_num_in_total=100, client_num_per_round=10, batch_size=64)
NAS_SIZE = dict(client_num_in_total=16, client_num_per_round=8, batch_size=64)
SEG_SIZE = dict(dataset="fets2021", synthetic_train_size=2000, synthetic_test_size=400,
                client_num_in_total=8, client_num_per_round=4, batch_size=16)
# FedSeg's rate and local epochs (64 steps a round): with 16 or 32 steps a
# round the UNet may still predict background on every test pixel after 2
# rounds, as it did on an NVIDIA H100 80GB HBM3 at 700 W
SEG_LR, SEG_EPOCHS = 0.1, 4
# the share of the foreground test pixels that FedSeg's model must predict
# as some foreground class after its 2 rounds
SEG_FG_RECALL = 0.5
# card against CPU after two relay steps of the ResNet-56 halves (cuDNN and
# CPU convolutions, f32, TF32 off): the relative L2 of the difference over
# the CPU's movement from the shared start, about ten times the 2.1e-4 read
# on an NVIDIA H100 80GB HBM3 at 700 W (the card's first step alone read
# 0.785 there)
SPLIT_CARD_CPU_REL = 2e-3
# FedGAN's lane check: Adam's first step moves an element by about lr
# whatever the rounding of a gradient near zero, so a lane is held to its
# run alone by the relative L2 of the difference over its movement
GAN_MOVE_REL = 1e-3


def _own_net(opt, data=None, extra=None, **overrides):
    """A simulator of its own through ``fedml_tpu_torch.init`` and
    ``FedMLRunner`` (``data``: an earlier form's dataset): 2 rounds, a test
    evaluation every round, ``homo`` shards, f32."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.runner import FedMLRunner

    base = dict(federated_optimizer=opt, partition_method="homo", comm_round=2,
                frequency_of_the_test=1, compute_dtype="float32", random_seed=0)
    base.update(overrides)
    cfg = fedml_tpu_torch.init(Config(**base, extra=dict(extra or {})))
    return FedMLRunner(cfg, dataset=data)


def _own_rounds(what, sim, probe, samples, unit="trained samples/s"):
    """Each round's line: its time, ``samples`` a round over it, its
    metrics and peak memory; fails on a non-finite metric."""
    for metrics, _, mem in (row for row in probe.rows if "round" in row[0]):
        shown = {k: v for k, v in metrics.items() if k not in ("round", "round_time_s")}
        for k, v in shown.items():
            if not math.isfinite(v):
                raise AssertionError(f"{what} round {metrics['round']}: {k} = {v}")
        print(f"{what} round {metrics['round']}: {metrics['round_time_s']:.3f} s, "
              f"{samples / metrics['round_time_s']:.0f} {unit}, "
              + ", ".join(f"{k} {v:.4f}" for k, v in shown.items()) + f", {_mem(mem)}")


def _move_rel(got, want, start):
    """The relative L2 of ``got - want`` over ``want``'s movement from
    ``start`` (f64 sums over the leaves of the three trees)."""
    from fedml_tpu_torch.core import pytree as pt

    d = sum(float((a - b).double().square().sum())
            for a, b in zip(pt.tree_leaves(got), pt.tree_leaves(want)))
    m = sum(float((b - c).double().square().sum())
            for b, c in zip(pt.tree_leaves(want), pt.tree_leaves(start)))
    return math.sqrt(d / max(m, 1e-300))


def _lanes_vs_alone(what, batched, alone, lanes, start=None):
    """Each lane of ``batched`` (a tuple of lane-stacked trees) against
    ``alone(lane)`` (the same trees of that lane run as a one-lane batch):
    within rtol 2e-4 / atol 2e-5, or, given the lanes' ``start``, within
    ``GAN_MOVE_REL`` relative L2 of the lane's movement."""
    from fedml_tpu_torch.core import pytree as pt

    worst = 0.0
    for lane in range(lanes):
        for k, (got, want) in enumerate(zip(batched, alone(lane))):
            got = pt.tree_map(lambda t: t[lane], got)
            want = pt.tree_map(lambda t: t[0], want)
            if start is None:
                diff, excess = _excess(got, want)
                worst = max(worst, diff)
                if excess > 0:
                    raise AssertionError(f"{what}: lane {lane} is {diff:.3g} off its step alone, "
                                         f"beyond rtol {MESH_SP_RTOL} / atol {MESH_SP_ATOL}")
                continue
            rel = _move_rel(got, want, pt.tree_map(lambda t: t[lane], start[k]))
            worst = max(worst, rel)
            if rel > GAN_MOVE_REL:
                raise AssertionError(f"{what}: lane {lane} is {rel:.3g} of its movement off its "
                                     f"step alone (limit {GAN_MOVE_REL})")
    limit = (f"rtol {MESH_SP_RTOL} / atol {MESH_SP_ATOL}" if start is None
             else f"relative L2 over the movement, limit {GAN_MOVE_REL}")
    print(f"{what} check: one lane-batched step of {lanes} lanes vs each lane alone, largest "
          f"difference {worst:.3g} ({limit})")


def _probe(sim, mods):
    probe = _RoundProbe(sim.logger, lambda: _all_counts(mods))
    sim.logger = probe
    return probe


def phase_splitnn(mods):
    """13 (a): SplitNN, the relay through 8 clients' GroupNorm ResNet-56
    bottoms and the shared top; card against CPU on client 0's first two
    relay steps; the ``norm: batch`` refusal.  Returns the data, which (b)
    reuses."""
    import torch

    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.sim.split_learning import create_split_model

    t0 = time.perf_counter()
    runner = _own_net("split_nn", None, norm="group", client_num_in_total=SPLIT_CLIENTS,
                      client_num_per_round=SPLIT_CLIENTS, batch_size=SPLIT_BATCH,
                      learning_rate=SPLIT_LR, comm_round=1, **OWN_CIFAR)
    sim, cfg = runner.runner, runner.cfg
    steps, bs = sim.hp.local_steps, cfg.batch_size
    print(f"splitnn (a): set-up {time.perf_counter() - t0:.1f} s ({sim.n} clients in relay, "
          f"capacity {sim.capacity}, batch {bs}, {steps} single-lane steps a client, "
          f"{sim.n * steps} a round, lr {cfg.learning_rate})")
    b0 = pt.tree_map(lambda t: t[0].clone(), sim.client_bottoms)
    t0v = pt.tree_map(torch.clone, sim.top_vars)
    perms = sim.sampler.relay_perms(0, 0, 2, sim.capacity)[:, :bs]
    host = lambda tree: pt.tree_map(lambda t: t.cpu(), tree)  # noqa: E731
    card = sim.client_pass(b0, t0v, sim._x[0], sim._y[0], perms.to(sim.device))
    cpu = sim.client_pass(host(b0), host(t0v), sim._x[0].cpu(), sim._y[0].cpu(), perms)
    # what the check reads when the card's second step is missing
    one = sim.client_pass(b0, t0v, sim._x[0], sim._y[0], perms[:1].to(sim.device))
    start = {"bottom": host(b0), "top": host(t0v)}
    want = {"bottom": cpu[0], "top": cpu[1]}
    rel = _move_rel(host({"bottom": card[0], "top": card[1]}), want, start)
    rel_one = _move_rel(host({"bottom": one[0], "top": one[1]}), want, start)
    print(f"splitnn (a) check: client 0's first 2 relay steps on the card vs the CPU from the "
          f"same start and draws, relative L2 over the movement {rel:.3g} (limit "
          f"{SPLIT_CARD_CPU_REL}; the card's first step alone reads {rel_one:.3g}), losses "
          f"{float(card[2]):.5f} / {float(cpu[2]):.5f}")
    if not rel <= SPLIT_CARD_CPU_REL:
        raise AssertionError(f"splitnn (a): card and CPU relay steps differ by {rel:.3g} of "
                             f"their movement (limit {SPLIT_CARD_CPU_REL})")
    if not rel_one > SPLIT_CARD_CPU_REL:
        raise AssertionError(f"splitnn (a): one relay step reads {rel_one:.3g}, within the "
                             f"limit {SPLIT_CARD_CPU_REL} that two steps are held to")
    _profile_once(lambda: sim.client_pass(b0, t0v, sim._x[0], sim._y[0],
                                          perms[:1].to(sim.device)),
                  "splitnn (a) profiled relay step (single lane)", top=3)
    try:
        create_split_model(Config(dataset="cifar10", norm="batch"), 10, (32, 32, 3))
    except ValueError as e:
        print(f"splitnn (a) check: norm: batch refused: {e}")
    else:
        raise AssertionError("splitnn (a): the BatchNorm ResNet-56 halves were not refused")
    probe = _probe(sim, mods)
    torch.cuda.reset_peak_memory_stats()
    runner.run()
    _own_rounds("splitnn (a)", sim, probe, sim.n * steps * bs)
    return runner.dataset


def phase_fedgkt(mods, dataset):
    """13 (b): FedGKT, 8 clients as 8 lanes through the GroupNorm
    ResNet-56 bottoms and heads, the server top on the pooled probe
    features; one lane-batched client step against each lane alone."""
    import torch

    from fedml_tpu_torch.core import pytree as pt

    t0 = time.perf_counter()
    runner = _own_net("FedGKT", dataset, norm="group", client_num_in_total=SPLIT_CLIENTS,
                      client_num_per_round=SPLIT_CLIENTS, batch_size=SPLIT_BATCH,
                      learning_rate=SPLIT_LR, **OWN_CIFAR)
    sim, cfg = runner.runner, runner.cfg
    steps, bs = sim.hp.local_steps, cfg.batch_size
    server_steps = max(1, sim.n * sim.probe // bs)
    phases = []

    def timed_phase(fn, name):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            phases.append((name, time.perf_counter() - t))
            return out
        return wrapped

    client_phase = sim.client_phase
    sim.client_phase = timed_phase(client_phase, "client")
    sim.server_phase = timed_phase(sim.server_phase, "server")
    probe = _probe(sim, mods)
    print(f"fedgkt (b): set-up {time.perf_counter() - t0:.1f} s ({sim.n} clients as {sim.n} "
          f"lanes, capacity {sim.capacity}, batch {bs}, {steps} batched client steps a round, "
          f"probe {sim.probe} rows a client, {server_steps} server steps a round, lr "
          f"{cfg.learning_rate})")
    torch.cuda.reset_peak_memory_stats()
    runner.run()
    _own_rounds("fedgkt (b)", sim, probe, sim.n * steps * bs + server_steps * bs)
    feats, _ = sim.probe_outputs()
    for r in range(len(phases) // 2):
        (_, tc), (_, ts) = phases[2 * r], phases[2 * r + 1]
        print(f"fedgkt (b) round {r}: client phase {tc:.3f} s ({sim.n * steps * bs / tc:.0f} "
              f"trained samples/s), server phase {ts:.3f} s ({server_steps} steps, "
              f"{server_steps * bs / ts:.0f} samples/s), probe features {tuple(feats.shape)} "
              f"= {feats.numel() * feats.element_size() / 2**20:.1f} MiB")
    params = {"bottom": sim.client_bottoms["params"], "head": sim.client_heads["params"]}
    perms = torch.stack([sim.sampler.client_perms(0, c, 1, sim.capacity)[:, :bs]
                         for c in range(sim.n)]).to(sim.device)
    teacher = sim.server_logits
    _profile_once(lambda: client_phase(params, sim._lanes, perms, teacher),
                  f"fedgkt (b) profiled client step ({sim.n} lanes)", top=3)
    got, _ = client_phase(params, sim._lanes, perms, teacher)
    _lanes_vs_alone("fedgkt (b)", (got,), lambda lane: (client_phase(
        pt.tree_map(lambda t: t[lane:lane + 1], params), sim._lanes[lane:lane + 1],
        perms[lane:lane + 1], teacher[lane:lane + 1])[0],), sim.n)


def phase_vfl(mods):
    """13 (c): vertical FL on the full lending-club stand-in, 2 rounds of 2
    parties and 1 of 4; the parties' ``bmm`` against each party alone."""
    import torch

    from fedml_tpu_torch.core import pytree as pt

    dataset = None
    for parties, rounds in ((2, 2), (4, 1)):
        t0 = time.perf_counter()
        runner = _own_net("vertical_fl", dataset, {"vfl_party_num": parties}, batch_size=128,
                          learning_rate=0.05, comm_round=rounds, **VFL_SIZE)
        sim, cfg = runner.runner, runner.cfg
        dataset = runner.dataset
        steps = sim.hp.local_steps
        print(f"vfl (c) {parties} parties: set-up {time.perf_counter() - t0:.1f} s "
              f"({sim.n_rows} rows of {parties} x {sim.slice_w} features, batch "
              f"{cfg.batch_size}, {steps} joint steps a round)")
        probe = _probe(sim, mods)
        torch.cuda.reset_peak_memory_stats()
        runner.run()
        _own_rounds(f"vfl (c) {parties} parties", sim, probe, steps * cfg.batch_size)
        with torch.no_grad():
            xb = sim.test_x[:, :1024]
            together, _ = sim.bottom.apply(sim.party_vars, xb)
            alone = [sim.bottom.apply(pt.tree_map(lambda t: t[p], sim.party_vars), xb[p])[0]
                     for p in range(parties)]
        worst, excess = _excess(together, torch.stack(alone))
        print(f"vfl (c) {parties} parties check: the parties' bmm vs each party's bottom alone "
              f"on 1,024 test rows, largest difference {worst:.3g} (rtol {MESH_SP_RTOL}, atol "
              f"{MESH_SP_ATOL})")
        if excess > 0:
            raise AssertionError(f"vfl (c): the party bmm is {worst:.3g} off the parties alone")


def phase_fedgan(mods):
    """13 (d): FedGAN on the full MNIST stand-in, 10 of 100 clients a round
    as lanes; a lane step against the client alone; ``sample(16)``."""
    import numpy as np
    import torch

    from fedml_tpu_torch.sim.own_nets import lane_copies

    t0 = time.perf_counter()
    runner = _own_net("FedGan", None, {"gan_z_dim": 64}, learning_rate=2e-4, **GAN_SIZE)
    sim, cfg = runner.runner, runner.cfg
    lanes = cfg.client_num_per_round
    print(f"fedgan (d): set-up {time.perf_counter() - t0:.1f} s ({lanes} of "
          f"{sim.dataset.n_clients} clients a round as lanes, capacity {sim.capacity}, batch "
          f"{cfg.batch_size}, {sim.steps} batched steps a round, z_dim {sim.z_dim})")
    probe = _probe(sim, mods)
    torch.cuda.reset_peak_memory_stats()
    runner.run()
    _own_rounds("fedgan (d)", sim, probe, lanes * sim.steps * cfg.batch_size)
    sampled = np.array(sim.sampler.sample(0))
    idx, z1, z2 = (torch.stack(t).to(sim.device) for t in zip(*[
        sim.sampler.gan_draws(0, int(c), 1, sim.capacity, cfg.batch_size, sim.z_dim)
        for c in sampled]))
    start = (lane_copies(sim.g_vars, lanes), lane_copies(sim.d_vars, lanes))
    got = sim.local_train(sampled, idx, z1, z2)[:2]
    _lanes_vs_alone("fedgan (d)", got, lambda lane: sim.local_train(
        sampled[lane:lane + 1], idx[lane:lane + 1], z1[lane:lane + 1], z2[lane:lane + 1])[:2],
        lanes, start)
    images = sim.sample(16)
    lo, hi = float(images.min()), float(images.max())
    print(f"fedgan (d) check: sample(16) {tuple(images.shape)} in [{lo:.4f}, {hi:.4f}]")
    if tuple(images.shape) != (16, 28, 28, 1) or lo < -1.0 or hi > 1.0:
        raise AssertionError(f"fedgan (d): sample(16) is {tuple(images.shape)} in [{lo}, {hi}]")


def phase_fednas(mods):
    """13 (e): FedNAS, 8 of 16 clients a round as lanes; the genotype; the
    weights and alphas moved off their start; a lane step against the
    client alone.  Its losses stay near ln 10 over these 12 steps: the
    stand-in's classes are white-noise templates, which a conv net that
    ends in a spatial mean sees only through small fluctuations."""
    import numpy as np
    import torch

    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.models.darts import split_arch_params

    t0 = time.perf_counter()
    runner = _own_net("FedNAS", None, {"nas_cells": 2, "nas_features": 16},
                      learning_rate=0.05, **NAS_SIZE, **OWN_CIFAR)
    sim, cfg = runner.runner, runner.cfg
    lanes = cfg.client_num_per_round
    print(f"fednas (e): set-up {time.perf_counter() - t0:.1f} s ({lanes} of "
          f"{sim.dataset.n_clients} clients a round as lanes, capacity {sim.capacity} (train "
          f"half {sim.half}), batch {cfg.batch_size}, {sim.steps} batched weight + alpha steps "
          f"a round)")
    w0, a0 = split_arch_params(pt.tree_map(torch.clone, sim.variables["params"]))
    probe = _probe(sim, mods)
    torch.cuda.reset_peak_memory_stats()
    runner.run()
    _own_rounds("fednas (e)", sim, probe, 2 * lanes * sim.steps * cfg.batch_size)
    weights, alphas = split_arch_params(sim.variables["params"])
    w_move = math.sqrt(sum(float((a - b).double().square().sum()) for a, b in
                           zip(pt.tree_leaves(weights), pt.tree_leaves(w0)))
                       / sum(float(b.double().square().sum()) for b in pt.tree_leaves(w0)))
    a_move = float((alphas - a0).abs().max())
    print(f"fednas (e): genotype {sim.genotype()}, largest |alpha| "
          f"{float(alphas.abs().max()):.5f}; over 2 rounds the weights moved {w_move:.4g} of "
          f"their norm, the alphas at most {a_move:.4g} off their start")
    if not (w_move > 0 and a_move > 0):
        raise AssertionError(f"fednas (e): the weights moved {w_move}, the alphas {a_move}")
    sampled = np.array(sim.sampler.sample(0))
    iw, ia = (torch.stack(t).to(sim.device) for t in zip(*[
        sim.sampler.nas_indices(0, int(c), 1, sim.half, sim.capacity, cfg.batch_size)
        for c in sampled]))
    got = sim.local_search(sampled, iw, ia)[:2]
    _lanes_vs_alone("fednas (e)", got, lambda lane: sim.local_search(
        sampled[lane:lane + 1], iw[lane:lane + 1], ia[lane:lane + 1])[:2], lanes)


def phase_fedseg(mods):
    """13 (f): FedSeg on the full FeTS2021 stand-in, 4 of 8 clients a round
    as lanes; its training loss falls and its model predicts foreground;
    the confusion matrix against numpy's on its predictions and on draws
    that span every class."""
    import numpy as np
    import torch

    from fedml_tpu_torch.models.segmentation import confusion_matrix

    t0 = time.perf_counter()
    runner = _own_net("FedSeg", None, {"seg_base": 8}, learning_rate=SEG_LR, momentum=0.9,
                      epochs=SEG_EPOCHS, **SEG_SIZE)
    sim, cfg = runner.runner, runner.cfg
    lanes = cfg.client_num_per_round
    print(f"fedseg (f): set-up {time.perf_counter() - t0:.1f} s ({lanes} of "
          f"{sim.dataset.n_clients} clients a round as lanes, {tuple(sim._x.shape[2:])} images, "
          f"{sim.num_classes} classes, capacity {sim.capacity}, batch {cfg.batch_size}, "
          f"{sim.steps} batched steps a round)")
    probe = _probe(sim, mods)
    torch.cuda.reset_peak_memory_stats()
    history = runner.run()
    _own_rounds("fedseg (f)", sim, probe, lanes * sim.steps * cfg.batch_size)
    losses = [h["train_loss"] for h in history]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"fedseg (f): the training loss did not fall: {losses}")
    tx, tm = sim._test
    with torch.no_grad():
        preds = sim.model.apply(sim.variables, tx, train=False)[0].argmax(-1)
    k = sim.num_classes
    fg = tm != 0
    recall = float((preds[fg] != 0).double().mean())
    print(f"fedseg (f) check: training loss {' -> '.join(f'{v:.4f}' for v in losses)}; "
          f"predicted pixels per class {torch.bincount(preds.ravel(), minlength=k).tolist()} "
          f"(true {torch.bincount(tm.ravel(), minlength=k).tolist()}); {recall:.4f} of the "
          f"foreground pixels predicted as foreground (at least {SEG_FG_RECALL})")
    if not recall >= SEG_FG_RECALL:
        raise AssertionError(f"fedseg (f): {recall:.4f} of the foreground predicted as such")
    gen = torch.Generator(device=sim.device).manual_seed(0)
    spread = torch.randint(0, k, tm.shape, generator=gen, device=sim.device)
    for name, p in (("the model's predictions", preds), ("uniform draws of every class", spread)):
        conf = confusion_matrix(p, tm, k).cpu().numpy()
        want = np.zeros((k, k), np.float32)
        np.add.at(want, (tm.cpu().numpy().ravel(), p.cpu().numpy().ravel()), 1.0)
        same = np.array_equal(conf, want)
        print(f"fedseg (f) check: the confusion matrix of {int(want.sum())} test pixels on the "
              f"card against {name} ({int((want.sum(0) > 0).sum())} of {k} classes predicted) "
              f"{'equals' if same else 'differs from'} numpy's")
        if not same:
            raise AssertionError(f"fedseg (f): the confusion matrix on {name} differs from numpy's")


def phase_slice16(mods):
    """Phase 13 (module docstring).  Returns each kernel's launches over
    its forms (all zero)."""
    import torch

    walls, peaks, cifar = {}, {}, {}
    _reset_counts(mods)

    def splitnn():
        cifar["data"] = phase_splitnn(mods)

    for form, fn in (("a", splitnn), ("b", lambda: phase_fedgkt(mods, cifar.pop("data"))),
                     ("c", lambda: phase_vfl(mods)), ("d", lambda: phase_fedgan(mods)),
                     ("e", lambda: phase_fednas(mods)), ("f", lambda: phase_fedseg(mods))):
        _phase_start()
        t0 = time.perf_counter()
        fn()
        walls[form] = time.perf_counter() - t0
        peaks[form] = torch.cuda.max_memory_allocated() - _PHASE_BASE["bytes"]
    counts = _all_counts(mods)
    print(f"slice 16: phase 13 {sum(walls.values()):.1f} s ("
          + ", ".join(f"({k}) {v:.1f} s" for k, v in walls.items())
          + f"), its own peak {max(peaks.values()) / 2**30:.3f} GiB ("
          + ", ".join(f"({k}) {v / 2**30:.3f}" for k, v in peaks.items())
          + f" GiB); launches on slice 16's paths (none of the seven kernels runs there): "
          f"{counts}")
    _zero_counts(counts, "phase 13")
    return counts


# -- phase 14: cross-silo trust and fault tolerance (slice 17) -------------------

SLICE17_TRAIN = 1600  # the stand-in's training images, cut from 50,000, then 3,200 (slice 21)
SLICE17_ROUNDS = 3
SLICE17_CRASH_ROUNDS = 2  # (d): the kills land on round 1
SLICE17_CHUNK = 65536  # transport chunk frames: a ~1.08 MB f32 upload in ~17
# a fixed chaos schedule (its seed and probabilities), a pure function of
# (seed, sender, receiver, message ordinal): in round 1 silo 3's upload is
# dropped and silo 2's held back behind its round-2 upload (then ignored as
# stale), so round 1 closes on the straggler timer with silos 1 and 4;
# uploads duplicated in rounds 0, 1 and 2; delays on every kind of frame.
# The server's own sends get delays only: a dropped FINISH would leave its
# silo waiting (ROADMAP Queue 3); a dropped dispatch is driven on the CPU
# (tests/test_torch_transport.py)
SLICE17_CHAOS = dict(chaos_seed=2870, chaos_drop_prob=0.05, chaos_duplicate_prob=0.1,
                     chaos_reorder_prob=0.05, chaos_delay_prob=0.3, chaos_delay_max_s=0.02)
# a round that lost an upload closes on its quorum (2 of 4) after this; a
# whole round takes ~3 s on the card, 7.7-10.3 s cold
SLICE17_STRAGGLER_S = 15.0
# the last round's global against the plain refold of its uploads: the
# fold's f32 sums against numpy's f64, through the same clip and noise
REFOLD_ATOL = 1e-5
# the qsgd8 upload's compressed leaves: ResNet-20's 18 conv kernels
QSGD8_LEAVES = 18
# phase 14 (a)'s (round time, uploads folded) by round, for phase 15
_SLICE17_ROUNDS: list = []
DLG_STEPS, DLG_LR = 400, 0.05  # the inversion as tests/test_obs.py runs it
SOTERIA_PERCENTILE = 10.0


def _card():
    import torch

    return torch.device("cuda")


def _slice17_cfg(root, tag, **extra):
    """The flagship recipe as a cross-silo run over loopback TCP: 4 silos,
    all in every round, fused blocks, central DP, 1,600 images, ports the
    system picks, chunk frames of 64 KiB, both journals under ``root``
    (none without it)."""
    import fedml_tpu_torch

    cfg = fedml_tpu_torch.init(argv=["--cf", FLAGSHIP])
    cfg.training_type, cfg.role, cfg.backend = "cross_silo", "server", "TCP"
    cfg.client_num_in_total = cfg.client_num_per_round = SILOS
    cfg.synthetic_train_size = SLICE17_TRAIN
    cfg.comm_round = SLICE17_ROUNDS
    cfg.frequency_of_the_test = 1
    cfg.run_id = f"slice17_{tag}"
    for k, v in DP.items():
        setattr(cfg, k, v)
    cfg.extra.update(fused_blocks=True, tcp_base_port=0, comm_chunk_bytes=SLICE17_CHUNK, **extra)
    if root:
        cfg.extra.update(server_journal_dir=f"{root}/{tag}/server",
                         client_journal_dir=f"{root}/{tag}/clients")
    return cfg


def _upload_key_round(key: str) -> int:
    return int(key.split(":")[1])  # "rank:round:epoch:attempt"


def _tap_chaos(clients, server) -> tuple:
    """Record, as the run goes, each silo's injected faults with the
    message's type and round, and the upload keys the server deduped."""
    from fedml_tpu_torch.cross_silo import message_define as md

    faults, deduped = [], []
    for c in clients:
        def note(fault, rid, nonce, msg, inner=c.com_manager._note, rank=c.rank):
            faults.append((fault, rank, msg.get_type(), msg.get_control(md.MSG_ARG_KEY_ROUND_INDEX),
                           msg.get_control(md.MSG_ARG_KEY_UPLOAD_KEY)))
            inner(fault, rid, nonce, msg)

        c.com_manager._note = note
    is_dup = server._is_duplicate_upload

    def check(sender, key):
        hit = is_dup(sender, key)
        if hit:
            deduped.append(key)
        return hit

    server._is_duplicate_upload = check
    return faults, deduped


class _FoldTap:
    """Wraps the aggregator's ``fold`` and ``aggregate``: keeps each round's
    folded senders, and the last round's uploads (undecoded messages,
    weights and ``stamp(msg)``) with the global, server state and
    flax-layout base they were folded onto."""

    def __init__(self, agg, stamp=None):
        self.agg, self.rounds, self._folds = agg, [], []
        self.last = None
        fold, aggregate = agg.fold, agg.aggregate

        def clone(tree):
            from fedml_tpu_torch.core import pytree as pt

            return pt.tree_map(lambda t: t.clone(), tree)

        def tapped_fold(client_idx, msg, sample_num, is_delta, scale=1.0):
            done = fold(client_idx, msg, sample_num, is_delta, scale)
            if done:
                self._folds.append((client_idx, msg, float(sample_num) * float(scale),
                                    bool(is_delta), float(sample_num),
                                    stamp(msg) if stamp is not None else None))
            return done

        def tapped_aggregate(round_idx):
            tmpl, skel = agg._stream_template()
            self.last = dict(round=round_idx, folds=self._folds, skel=skel,
                             base=[t.float().cpu().numpy() for t in tmpl],
                             old=clone(agg.global_vars), state=agg.server_state)
            self.rounds.append(sorted(c for c, *_ in self._folds))
            self._folds = []
            return aggregate(round_idx)

        agg.fold, agg.aggregate = tapped_fold, tapped_aggregate

    def refold(self, leave_out=None, weight=None):
        """The last round's global from its uploads by numpy's decode (the
        plain dequantize) and an f64 weighted sum, then the server step and
        central DP on the card (the round's draw again), flattened in the
        reference's order; ``leave_out`` drops one sender's upload,
        ``weight(fold record)`` replaces the weight the server folded with."""
        import numpy as np
        import torch

        from fedml_tpu_torch import weights
        from fedml_tpu_torch.comm import wire
        from fedml_tpu_torch.cross_silo import message_define as md

        last, agg = self.last, self.agg
        folds = [(f[1], f[3], f[2] if weight is None else weight(f))
                 for f in last["folds"] if f[0] != leave_out]
        total = sum(w for _, _, w in folds)
        w_delta = sum(w for _, d, w in folds if d)
        acc = [w_delta * b.astype(np.float64) for b in last["base"]]
        for msg, _, w in folds:
            for i, _, arr in msg.tensor_frame()[1]:
                acc[i] += w * np.asarray(arr, np.float64)
        dev = _card()
        out = [torch.from_numpy((a / total).astype(np.float32)).to(dev) for a in acc]
        plain = weights.tensors_from_flax(
            wire.restore_skeleton(last["skel"], out)[md.MSG_ARG_KEY_MODEL_PARAMS])
        new, _ = agg.algorithm.server_update(last["old"], last["state"], plain, last["round"])
        new = agg.trust.on_after_aggregation(new, last["old"], last["round"])
        return weights.flatten_reference(new)[0]


def phase_slice17_main(mods, nz, root):
    """(a) + (b): qsgd8 uploads folded as they land, central DP at the
    finalize, TCP, chunk frames, chaos and both journals, through
    ``FedMLRunner(cfg).run()``."""
    import torch

    from fedml_tpu_torch import weights
    from fedml_tpu_torch.comm.tcp_backend import TCPCommManager
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.cross_silo import message_define as md
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = _slice17_cfg(root, "main", comm_compression="qsgd8", streaming_aggregation=True,
                       straggler_timeout_s=SLICE17_STRAGGLER_S, **SLICE17_CHAOS)
    t0 = time.perf_counter()
    runner = FedMLRunner(cfg)
    group = runner.runner
    group.setup()
    server, clients = group.server, group.clients
    if not isinstance(server.com_manager.inner, TCPCommManager):
        raise AssertionError(f"phase 14: server transport {type(server.com_manager.inner)}")
    steps = sum(c.trainer.trained_samples for c in clients) // cfg.batch_size
    print(f"phase 14 (a): set-up {time.perf_counter() - t0:.1f} s (data {runner.dataset.train_num}"
          f"/{runner.dataset.test_num}, {steps} local steps a round over {SILOS} silos, batch "
          f"{cfg.batch_size}, {cfg.compute_dtype}; TCP ports {server.com_manager.port_map}, "
          f"chunks of {SLICE17_CHUNK} bytes, chaos {SLICE17_CHAOS}, straggler timer "
          f"{SLICE17_STRAGGLER_S} s)")
    all_mods = mods + (nz,)
    probe = _RoundProbe(server.logger, lambda: _all_counts(all_mods))
    server.logger = probe
    faults, deduped = _tap_chaos(clients, server)
    agg = server.aggregator
    tap = _FoldTap(agg)
    _reset_counts(all_mods)
    history = runner.run()
    torch.cuda.synchronize()
    counts = _all_counts(all_mods)
    prev = {k: 0 for k in counts}
    samples = sum(c.trainer.trained_samples for c in clients)
    for (metrics, cum, mem), folded in zip(probe.rows, tap.rounds):
        delta = {k: cum[k] - prev[k] for k in cum if cum[k] - prev[k]}
        prev = cum
        _SLICE17_ROUNDS.append((metrics["round_time_s"], len(folded)))
        print(f"phase 14 (a) round {metrics['round']}: {metrics['round_time_s']:.3f} s, "
              f"{samples / metrics['round_time_s']:.0f} trained samples/s, silos folded "
              f"{folded}, fold {1e3 * metrics['fold_time_s']:.1f} ms, finalize (divide + clip "
              f"+ noise) {1e3 * metrics['finalize_time_s']:.1f} ms, uploads "
              f"{metrics['upload_bytes']} bytes, test_acc {metrics['test_acc']:.4f}, "
              f"{_mem(mem)}, launches {delta}")
        if delta.get(nz.NOISE.name) != 1:
            raise AssertionError(f"phase 14 round {metrics['round']}: noise launches "
                                 f"{delta.get(nz.NOISE.name)}, expected 1")
    uploads = SLICE17_ROUNDS * SILOS
    up = md.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER
    lost = sorted((r, rank, f) for f, rank, t, r, _ in faults
                  if t == up and f in ("drop", "reorder"))
    want_rounds = [sorted(set(range(1, SILOS + 1)) - {k for r, k, _ in lost if r == i})
                   for i in range(SLICE17_ROUNDS)]
    folded = sum(len(r) for r in tap.rounds)
    print(f"phase 14 (a): uploads lost to chaos inside their round (round, silo, fault): {lost}; "
          f"silos folded by round {tap.rounds}")
    if not lost or tap.rounds != want_rounds:
        raise AssertionError(f"phase 14 (a): folded {tap.rounds}, want {want_rounds} (uploads "
                             f"lost inside a round: {lost})")
    want = {k.name: None for k in mods[0].KERNELS}
    bad = [k for k in want if counts[k] == 0]
    q, dq = counts[mods[1].QUANTIZE.name], counts[mods[1].DEQUANTIZE.name]
    if bad or q < QSGD8_LEAVES * uploads or q % QSGD8_LEAVES:
        raise AssertionError(f"phase 14: fused kernels not launched {bad} or quantize {q}")
    if dq != QSGD8_LEAVES * folded or counts[nz.NOISE.name] != SLICE17_ROUNDS:
        raise AssertionError(f"phase 14: dequantize {dq} (want {QSGD8_LEAVES * folded}), "
                             f"noise {counts[nz.NOISE.name]} (want {SLICE17_ROUNDS})")
    if not agg.stream_mode or agg.peak_buffered_updates > 2 or len(history) != SLICE17_ROUNDS:
        raise AssertionError(f"phase 14: stream {agg.stream_mode}, peak buffered "
                             f"{agg.peak_buffered_updates}, rounds {len(history)}")
    for metrics in history:
        for key in ("test_loss", "test_acc"):
            if not math.isfinite(metrics[key]):
                raise AssertionError(f"phase 14 round {metrics['round']}: {key} {metrics[key]}")
    if not all(bool(torch.isfinite(t).all()) for t in pt.tree_leaves(agg.global_vars)):
        raise AssertionError("phase 14: non-finite global")
    if not history[-1]["test_loss"] < history[0]["test_loss"]:
        raise AssertionError(f"phase 14: the test loss did not fall: "
                             f"{[m['test_loss'] for m in history]}")
    # the last round against the plain fold of what the server took (these
    # noise launches come after the path's counts were read)
    got = weights.flatten_reference(agg.global_vars)[0]
    old = weights.flatten_reference(tap.last["old"])[0]
    err = float((got - tap.refold()).abs().max())
    step = float((got - old).norm())
    without = {c: float((got - tap.refold(leave_out=c)).abs().max())
               for c, *_ in tap.last["folds"]}
    print(f"phase 14 (a): round {tap.last['round']}'s global against the plain refold of its "
          f"{len(tap.last['folds'])} uploads: max abs {err:.3g} (limit {REFOLD_ATOL:g}); the "
          f"round moved the global by an L2 of {step:.4f} (clip {DP['clipping_norm']} plus the "
          f"noise); leaving one silo's upload out of the refold: max abs "
          + ", ".join(f"silo {c} {v:.3g}" for c, v in sorted(without.items())))
    if not (err <= REFOLD_ATOL and min(without.values()) > 10 * REFOLD_ATOL):
        raise AssertionError(f"phase 14 (a): the global is {err:.3g} from the plain refold "
                             f"(limit {REFOLD_ATOL:g}); without one upload {without}")
    dup_keys = [k for f, _, t, _, k in faults if f == "duplicate" and t == up]
    taken = {k for dq_ in server._folded_keys.values() for k in dq_}
    must = {k for k in dup_keys if k in taken and _upload_key_round(k) < SLICE17_ROUNDS - 1}
    may = {k for k in dup_keys if k in taken}
    chaos = {"server": server.com_manager.injected,
             **{f"silo {c.rank}": c.com_manager.injected for c in clients}}
    frames = server.com_manager.chunk_frames
    print(f"phase 14 (b): chaos injected {chaos}; upload duplicates {sorted(dup_keys)}, the "
          f"server deduped {sorted(deduped)} ({server.deduped_uploads}), stale "
          f"{server.rejected_stale}; chunk frames received by the server {frames} "
          f"({server.com_manager.dropped or 'none'} dropped); journal snapshots "
          f"{server.journal.snapshots}")
    if not (must <= set(deduped) <= may and len(deduped) == len(set(deduped))
            == server.deduped_uploads and must):
        raise AssertionError(f"phase 14 (b): deduped {sorted(deduped)}, must {sorted(must)}, "
                             f"may {sorted(may)}")
    if frames < folded * 2:
        raise AssertionError(f"phase 14: chunk frames {frames} for {folded} uploads")
    return counts, runner.dataset, runner.model


def phase_slice17_stream_cdp(dataset, model):
    """(c): two raw uploads of weight 64 (the round's global plus seeded
    normal noise), folded on the card on the streaming path and buffered
    on the exact path, both with central DP: the same global, bitwise."""
    import numpy as np
    import torch

    from fedml_tpu_torch import weights
    from fedml_tpu_torch.comm.message import Message
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.cross_silo import build_aggregator

    out = {}
    for stream in (True, False):
        cfg = _slice17_cfg("", "c", streaming_aggregation=stream)
        agg = build_aggregator(cfg, dataset, model, _card())
        if agg.stream_mode != stream:
            raise AssertionError(f"phase 14 (c): stream_mode {agg.stream_mode}")
        base = agg.host_global_flax()
        for cid in (1, 2):
            rs = np.random.RandomState(cid)
            params = pt.tree_map(lambda x: np.asarray(x, np.float32)
                                 + rs.randn(*np.shape(x)).astype(np.float32), base)
            if stream:
                m = Message(3, cid, 0)
                m.add_params("model_params", params)
                if not agg.ingest_streaming(cid, Message.decode(m.encode()), 64.0, False):
                    raise AssertionError("phase 14 (c): the fold refused a raw upload")
            else:
                agg.add_local_trained_result(cid, params, 64.0)
        out[stream] = weights.to_numpy(agg.aggregate(0))
    a, b = pt.tree_leaves(out[True]), pt.tree_leaves(out[False])
    same = all(np.array_equal(x, y) for x, y in zip(a, b))
    print(f"phase 14 (c): streaming CDP global bitwise the buffer-all one: {same} "
          f"({sum(x.size for x in a)} elements)")
    if not same:
        raise AssertionError("phase 14 (c): streaming and buffer-all CDP globals differ")


class _BusyWindow:
    """A server logger that profiles one whole round: the profiler starts at
    round 0's log (before round 1's broadcast) and stops at round 1's log
    (after its evaluation), both on the server's thread; ``busy`` and
    ``wall`` are that round's device busy and wall seconds."""

    def __init__(self, inner):
        self.inner, self.prof, self.t0 = inner, None, 0.0
        self.busy = self.wall = None

    def log(self, metrics, step=None):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from fedml_tpu_torch.obs.profile_round import busy_us

        if metrics["round"] == 0:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        elif metrics["round"] == 1:
            torch.cuda.synchronize()
            self.wall = time.perf_counter() - self.t0
            self.prof.__exit__(None, None, None)
            self.busy = busy_us([e for e in self.prof.events()
                                 if e.device_type.name == "CUDA"]) / 1e6
        self.inner.log(metrics, step)


def phase_slice17_crash(root, dataset, model):
    """(d): the uninterrupted run (round 1 profiled for the device busy
    share) against one whose server is hard-killed at round 1's first
    dispatch and rebuilt over its journal, and whose silo 2 is killed
    before the rebuilt server's round-1 dispatch reaches it and rebuilt
    over its journal; buffer-all with central DP, TCP, chunk frames,
    ``SLICE17_CRASH_ROUNDS`` rounds, cuDNN deterministic."""
    import torch

    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.cross_silo.crash_drill import run_with_crashes
    from fedml_tpu_torch.obs.metrics import MetricsLogger

    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    window = _BusyWindow(MetricsLogger(None))
    try:
        runs, walls = {}, {}
        for tag, kw in (("plain", dict(logger=window)),
                        ("crash", dict(kill_server_before_round=1, kill_client=(2, 1)))):
            cfg = _slice17_cfg(root, tag)
            cfg.comm_round = SLICE17_CRASH_ROUNDS
            t0 = time.perf_counter()
            runs[tag] = run_with_crashes(cfg, dataset, model, _card(), backend="TCP",
                                         timeout=300.0, **kw)
            torch.cuda.synchronize()
            walls[tag] = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    plain, crash = runs["plain"], runs["crash"]
    print(f"phase 14 (d): uninterrupted {walls['plain']:.1f} s with its set-up, rounds "
          + ", ".join(f"{h['round_time_s']:.3f}" for h in plain["history"])
          + f" s; round 1 profiled: {window.wall:.3f} s, device busy {window.busy:.3f} s = "
          f"{100 * window.busy / window.wall:.1f}%; with the crashes {walls['crash']:.1f} s: "
          f"server kills {crash['server_kills']}, client kills {crash['client_kills']}, "
          f"recovered step {crash['server'].recovered_step}, session epoch "
          f"{crash['server'].session_epoch}, silos resumed from their journal "
          f"{[c.resumed_from_journal for c in crash['clients']]}, rounds "
          f"{[h['round'] for h in crash['history']]}")
    if (crash["server_kills"], crash["client_kills"]) != (1, 1) or \
            [h["round"] for h in crash["history"]] != list(range(SLICE17_CRASH_ROUNDS)):
        raise AssertionError(f"phase 14 (d): the drill did not run as set: {crash}")
    a = pt.tree_leaves(plain["server"].aggregator.global_vars)
    b = pt.tree_leaves(crash["server"].aggregator.global_vars)
    diff = max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    print(f"phase 14 (d): final global after the crashes bitwise the uninterrupted one: {same} "
          f"(largest difference {diff:.3g})")
    if not same:
        raise AssertionError(f"phase 14 (d): the resumed global differs by up to {diff:.3g}")
    return window.busy / window.wall


def phase_slice17_attacks(fb):
    """(e): the inversion on the LR model at 60 features on the card beats
    its random start by the reference's 0.6 factor; through a fused
    ResNet-20 at batch 1 the second-order pass raises; Soteria's mask on
    the card prunes exactly its percentile."""
    import numpy as np
    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.models import model_hub
    from fedml_tpu_torch.trust.attack.dlg import invert_gradient_attack
    from fedml_tpu_torch.trust.defense import soteria_mask

    dev = _card()

    def grads(model, variables, create_graph=True):
        def grad_fn(x, y_onehot):
            p = pt.tree_map(lambda t: t.detach().requires_grad_(True), variables["params"])
            logits, _ = model.apply({**variables, "params": p}, x, train=False)
            loss = -torch.mean(torch.sum(torch.log_softmax(logits, -1) * y_onehot, dim=-1))
            return list(torch.autograd.grad(loss, pt.tree_leaves(p), create_graph=create_graph))

        return grad_fn

    lr_cfg = fedml_tpu_torch.init(Config(model="lr", dataset="synthetic",
                                         compute_dtype="float32"))
    lr = model_hub.create(lr_cfg, 10, input_shape=(60,))
    variables = lr.init(rng.generator(rng.root_key(1)), dev)
    g = torch.Generator(device=dev).manual_seed(0)
    x_true = torch.randn((2, 60), generator=g, device=dev)
    y = torch.tensor([3, 7], device=dev)
    onehot = torch.nn.functional.one_hot(y, 10).float()
    victim = [t.detach() for t in grads(lr, variables)(x_true, onehot)]
    x0 = torch.randn((2, 60), generator=g, device=dev) * 0.1
    t0 = time.perf_counter()
    x_hat, final = invert_gradient_attack(grads(lr, variables), victim, (2, 60), y, x0=x0,
                                          steps=DLG_STEPS, lr=DLG_LR)
    torch.cuda.synchronize()
    err = float((x_hat - x_true).abs().mean())
    base = float((x0 - x_true).abs().mean())
    print(f"phase 14 (e): inversion on the LR ({DLG_STEPS} steps, {time.perf_counter() - t0:.2f} "
          f"s): mean error {err:.4f} against the start's {base:.4f} (ratio {err / base:.3f}, "
          f"final loss {float(final):.4g})")
    if not (math.isfinite(float(final)) and err < 0.6 * base):
        raise AssertionError(f"phase 14 (e): the inversion did not beat its start ({err}, {base})")

    rcfg = fedml_tpu_torch.init(Config(model="resnet20", dataset="cifar10",
                                       compute_dtype="float32", extra={"fused_blocks": True}))
    resnet = model_hub.create(rcfg, 10)
    rvars = resnet.init(rng.generator(rng.root_key(2)), dev)
    x1 = torch.randn((1, 32, 32, 3), generator=g, device=dev)
    y1 = torch.nn.functional.one_hot(torch.tensor([3], device=dev), 10).float()
    before = fb.launch_counts()
    rvictim = grads(resnet, rvars, create_graph=False)(x1, y1)
    launched = {k: v - before[k] for k, v in fb.launch_counts().items() if v != before[k]}
    try:
        invert_gradient_attack(grads(resnet, rvars), rvictim, (1, 32, 32, 3),
                               torch.tensor([3], device=dev), steps=1)
    except RuntimeError as e:
        if str(e) != fb.SECOND_ORDER_REFUSAL:
            raise
        print(f"phase 14 (e): fused ResNet-20 at batch 1: the victim's gradient through the "
              f"kernels ({launched}), the inversion's second order refused: {str(e)[:80]}...")
    else:
        raise AssertionError("phase 14 (e): second order through the fused blocks did not raise")

    scfg = fedml_tpu_torch.init(Config(model="lr", dataset="synthetic", compute_dtype="float32"))
    wide = model_hub.create(scfg, 100, input_shape=(60,))
    svars = wide.init(rng.generator(rng.root_key(3)), dev)
    mask, sens = soteria_mask(wide, svars, x_true[0], SOTERIA_PERCENTILE)
    s = sens.detach().cpu().numpy()
    pruned = int((mask == 0).sum())
    want = int((s < np.percentile(s, SOTERIA_PERCENTILE)).sum())
    print(f"phase 14 (e): Soteria on the card over {s.size} features at its "
          f"{SOTERIA_PERCENTILE:g}th percentile: {pruned} pruned (numpy's percentile: {want})")
    if pruned != want or pruned == 0:
        raise AssertionError(f"phase 14 (e): Soteria pruned {pruned}, not {want}")


def phase_slice17(mods, nz):
    """Phase 14 (module docstring).  Returns each kernel's launches on (a)."""
    import tempfile

    walls = {}
    with tempfile.TemporaryDirectory(prefix="fedml_slice17_") as root:
        t0 = time.perf_counter()
        counts, dataset, model = phase_slice17_main(mods, nz, root)
        walls["a-b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_slice17_stream_cdp(dataset, model)
        walls["c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        busy = phase_slice17_crash(root, dataset, model)
        walls["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_slice17_attacks(mods[0])
    walls["e"] = time.perf_counter() - t0
    print(f"slice 17: phase 14 {sum(walls.values()):.1f} s ("
          + ", ".join(f"({k}) {v:.1f} s" for k, v in walls.items())
          + f"); device busy {100 * busy:.1f}% of (d)'s profiled round; launches on (a): "
          f"{counts}")
    return counts


# -- phase 15: silos as processes of their own, the buffered-async server (slice 18) --

SLICE18_SILOS = 4
SLICE18_VERSIONS = 6
SLICE18_BUFFER_K = 2
SLICE18_EXPONENT = 0.5
# silo 2 is addressed by another loopback address than the others (Linux
# routes all of 127/8 to the loopback; every listener binds 0.0.0.0)
SLICE18_REMOTE = {"2": "127.0.0.2"}
SLICE18_TIMEOUT_S = 300.0  # each process's wall-clock bound
# where the silo processes run (None: the card); a rehearsal on the CPU
# sets "cpu"
SLICE18_CHILD_DEVICE = None
# (b): the flagship ResNet-20 on 3 silos of 256 images (2 local steps of
# 128 an upload), K = 3 of 3 in flight, the default chaos on every worker;
# silos 1 and 2 are killed at versions 10 and 11 and the server at 12, so
# the three restarts (an interpreter, torch and CUDA each) overlap and all
# land with 20 versions still to run; the journal every 2 versions
SLICE18_SOAK_TRAIN = 768
SLICE18_SOAK = dict(n_clients=3, versions=32, buffer_k=3, concurrency=3, kill_server_at=12,
                    client_kills=((1, 10), (2, 11)), journal_every_rounds=2,
                    redispatch_timeout_s=5.0, timeout_s=SLICE18_TIMEOUT_S)


class _UtilSampler:
    """``nvidia-smi``'s ``utilization.gpu`` (the share of each sample period
    in which a kernel of any process ran) every 100 ms, until ``stop``."""

    def __init__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
             "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> list:
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=10)
        return [float(v) for v in out.split() if v.replace(".", "", 1).isdigit()]


def _child_cfg_json(cfg) -> dict:
    import dataclasses

    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def phase_slice18_async(mods, nz, root):
    """(a): the async server in this process, its 4 silos processes of their
    own (``soak_worker``, ``init`` + ``FedMLRunner``), over TCP on fixed
    ports."""
    import json
    import os

    import numpy as np
    import torch

    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.cross_silo import message_define as md
    from fedml_tpu_torch.cross_silo.async_soak import (_free_port_block, _tail,
                                                       spawn_soak_worker)
    from fedml_tpu_torch.obs.metrics import MetricsLogger
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = _slice17_cfg(root, "slice18", comm_compression="qsgd8", streaming_aggregation=True,
                       async_aggregation=True, async_buffer_k=SLICE18_BUFFER_K,
                       async_concurrency=SLICE18_SILOS,
                       async_staleness_exponent=SLICE18_EXPONENT)
    cfg.comm_round = SLICE18_VERSIONS
    cfg.run_id = "slice18_async"
    base_port = _free_port_block(SLICE18_SILOS + 1)
    cfg.extra.update(tcp_base_port=base_port, tcp_ip_config=dict(SLICE18_REMOTE))
    workdir = os.path.join(root, "slice18_procs")
    os.makedirs(workdir)
    cfg_path = os.path.join(workdir, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(_child_cfg_json(cfg), f)
    t0 = time.perf_counter()
    procs = [spawn_soak_worker(cfg_path, "client", r, workdir,
                               os.path.join(workdir, f"client_{r}.log"),
                               device=SLICE18_CHILD_DEVICE)
             for r in range(1, SLICE18_SILOS + 1)]
    sampler = None
    try:
        runner = FedMLRunner(cfg)
        group = runner.runner
        group.timeout = SLICE18_TIMEOUT_S
        group.setup()
        server = group.server
        print(f"phase 15 (a): set-up {time.perf_counter() - t0:.1f} s (server: data "
              f"{runner.dataset.train_num}/{runner.dataset.test_num}; {SLICE18_SILOS} silo "
              f"processes started, ports {base_port}..{base_port + SLICE18_SILOS}, silo 2 at "
              f"{SLICE18_REMOTE['2']}; K {SLICE18_BUFFER_K}, concurrency {SLICE18_SILOS}, "
              f"exponent {SLICE18_EXPONENT}, {SLICE18_VERSIONS} virtual rounds, qsgd8, central "
              f"DP, chunks of {SLICE17_CHUNK} bytes, both journals)")
        all_mods = mods + (nz,)
        window = _BusyWindow(_RoundProbe(MetricsLogger(None), lambda: _all_counts(all_mods)))
        server.logger = window
        tap = _FoldTap(server.aggregator, stamp=lambda msg: (
            int(msg.get_control(md.MSG_ARG_KEY_ROUND_INDEX)), int(server.server_version)))
        _reset_counts(all_mods)
        sampler = _UtilSampler()
        t_run = time.perf_counter()
        history = runner.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        util = sampler.stop()
        sampler = None
        counts = _all_counts(all_mods)
        for p in procs:
            if p.wait(timeout=60) != 0:
                raise AssertionError(f"phase 15 (a): a silo process exited {p.returncode}")
    except BaseException:
        for r in range(1, SLICE18_SILOS + 1):
            print(f"--- silo {r} ---\n{_tail(os.path.join(workdir, f'client_{r}.log'))}")
        raise
    finally:
        if sampler is not None:
            sampler.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    reports = []
    for name in sorted(os.listdir(workdir)):
        if name.startswith("report_r"):
            with open(os.path.join(workdir, name)) as f:
                reports.append(json.load(f))
    probe = window.inner
    prev = {k: 0 for k in counts}
    for metrics, cum, mem in probe.rows:
        delta = {k: cum[k] - prev[k] for k in cum if cum[k] - prev[k]}
        prev = cum
        print(f"phase 15 (a) virtual round {metrics['round']}: {metrics['round_time_s']:.3f} s, "
              f"{metrics['arrivals']} arrivals, staleness mean {metrics['staleness_mean']} max "
              f"{metrics['staleness_max']}, fold {1e3 * metrics['fold_time_s']:.1f} ms, "
              f"finalize {1e3 * metrics['finalize_time_s']:.1f} ms, uploads "
              f"{metrics['upload_bytes']} bytes, test_acc {metrics['test_acc']:.4f}, "
              f"{_mem(mem)}, server launches {delta}")
    times = [m["round_time_s"] for m in history]
    sync = [t for t, _ in _SLICE17_ROUNDS]
    sync_up = sum(n for _, n in _SLICE17_ROUNDS) / max(sum(sync), 1e-9)
    busy_pct = 100 * window.busy / window.wall
    summary = server.async_summary()
    print(f"phase 15 (a): {summary['server_version']} virtual rounds in {wall:.3f} s, "
          f"{summary['versions_per_sec']} versions/s, arrivals {summary['arrivals']} "
          f"({server.arrivals_by_path}), staleness mean {summary['staleness_mean']} max "
          f"{summary['staleness_max']} (histogram {server.staleness_hist.counts}); a virtual "
          f"round median {statistics.median(times):.3f} s ({SLICE18_BUFFER_K} uploads, "
          f"{summary['arrivals'] / wall:.2f} uploads/s) beside phase 14's threaded sync "
          f"rounds {', '.join(f'{t:.3f}' for t in sync)} s ({sync_up:.2f} uploads/s); "
          f"virtual round 1 profiled in the server process: {window.wall:.3f} s, its device "
          f"busy {window.busy:.3f} s = {busy_pct:.1f}%; the card's utilization.gpu (all "
          f"processes) over the run: mean {np.mean(util) if util else float('nan'):.1f}% of "
          f"{len(util)} samples")
    if (len(history) != SLICE18_VERSIONS or summary["staleness_max"] < 1
            or server.aggregator.peak_buffered_updates > 2):
        raise AssertionError(f"phase 15 (a): rounds {len(history)}, {summary}, peak "
                             f"{server.aggregator.peak_buffered_updates}")
    for metrics in history:
        for key in ("test_loss", "test_acc"):
            if not math.isfinite(metrics[key]):
                raise AssertionError(f"phase 15 (a) round {metrics['round']}: {key} "
                                     f"{metrics[key]}")
    if not all(bool(torch.isfinite(t).all()) for t in pt.tree_leaves(server.aggregator.global_vars)):
        raise AssertionError("phase 15 (a): non-finite global")
    # the last virtual round against the plain refold of the uploads the
    # server took, in its order, weighted n * (1 + tau) ** -0.5 here
    def decayed(f):
        n, (client_version, server_version) = f[4], f[5]
        return n * (1.0 + float(server_version - client_version)) ** -SLICE18_EXPONENT

    for f in tap.last["folds"]:
        if not math.isclose(f[2], decayed(f), rel_tol=1e-12):
            raise AssertionError(f"phase 15 (a): upload of silo {f[0]} folded with weight "
                                 f"{f[2]}, want {decayed(f)}")
    got = weights.flatten_reference(server.aggregator.global_vars)[0]
    err = float((got - tap.refold(weight=decayed)).abs().max())
    without = {c: float((got - tap.refold(leave_out=c, weight=decayed)).abs().max())
               for c, *_ in tap.last["folds"]}
    print(f"phase 15 (a): virtual round {tap.last['round']}'s global against the plain refold "
          f"of its {len(tap.last['folds'])} uploads (silo, version, server version) "
          f"{[(f[0], *f[5]) for f in tap.last['folds']]}: max abs {err:.3g} (limit "
          f"{REFOLD_ATOL:g}); leaving one upload out: "
          + ", ".join(f"silo {c} {v:.3g}" for c, v in sorted(without.items())))
    if not (err <= REFOLD_ATOL and min(without.values()) > 10 * REFOLD_ATOL):
        raise AssertionError(f"phase 15 (a): the global is {err:.3g} from the plain refold "
                             f"(limit {REFOLD_ATOL:g}); without one upload {without}")
    # launches: the silos' in their processes, the server's here
    silos = [r for r in reports if r["role"] == "client"]
    trained = sum(r["rounds_trained"] for r in silos)
    kname = {k.name: k for k in mods[0].KERNELS}
    q, dq, noise = mods[1].QUANTIZE.name, mods[1].DEQUANTIZE.name, nz.NOISE.name
    child_sum = {k: sum(r["launches"].get(k, 0) for r in silos) for k in counts}
    for r in sorted(silos, key=lambda r: r["rank"]):
        print(f"phase 15 (a) silo {r['rank']} (pid {r['pid']}, {r['device_name']}, jax "
              f"imported: {r['jax_loaded']}): {r['rounds_trained']} uploads trained, launches "
              f"{ {k: v for k, v in r['launches'].items() if v} }")
    folded = server.arrivals_by_path["folded"]
    print(f"phase 15 (a): launches summed over the {len(silos)} silo processes {child_sum}; "
          f"in the server {counts}; uploads trained {trained}, folded {folded}")
    if len(silos) != SLICE18_SILOS or any(
            r["jax_loaded"] or r["fedml_tpu_loaded"]
            or r["device_name"] != torch.cuda.get_device_name(0) for r in silos):
        raise AssertionError(f"phase 15 (a): silo reports {silos}")
    bad = [(r["rank"], k) for r in silos for k in kname if r["launches"].get(k, 0) == 0]
    if bad or child_sum[q] != QSGD8_LEAVES * trained or any(child_sum[k] for k in (dq, noise)):
        raise AssertionError(f"phase 15 (a): silo launches: rows 1-4 missing {bad}, quantize "
                             f"{child_sum[q]} for {trained} uploads, {child_sum}")
    if (counts[dq] != QSGD8_LEAVES * folded or counts[noise] != SLICE18_VERSIONS
            or counts[q] or folded != summary["arrivals"]):
        raise AssertionError(f"phase 15 (a): server launches {counts} for {folded} folded "
                             f"uploads and {SLICE18_VERSIONS} virtual rounds")
    return {k: counts[k] + child_sum[k] for k in counts}


def phase_slice18_soak():
    """(b): ``run_multiproc_kill_soak`` on the card, the flagship ResNet-20
    in every worker, real SIGKILLs of the server and two silos under chaos."""
    import fedml_tpu_torch
    from fedml_tpu_torch.cross_silo.async_soak import DEFAULT_CHAOS_FLAGS, run_multiproc_kill_soak

    fl = fedml_tpu_torch.init(argv=["--cf", FLAGSHIP])
    overrides = dict(dataset=fl.dataset, model=fl.model, batch_size=fl.batch_size,
                     learning_rate=fl.learning_rate, compute_dtype=fl.compute_dtype,
                     synthetic_train_size=SLICE18_SOAK_TRAIN, synthetic_test_size=256,
                     random_seed=fl.random_seed)
    t0 = time.perf_counter()
    res = run_multiproc_kill_soak(**SLICE18_SOAK, chaos=dict(DEFAULT_CHAOS_FLAGS),
                                  device=SLICE18_CHILD_DEVICE, cfg_overrides=overrides,
                                  extra_overrides={"fused_blocks": True})
    reports = res.pop("reports")
    print(f"phase 15 (b): {time.perf_counter() - t0:.1f} s: {res}")
    print(f"phase 15 (b): clean exits {[(r['role'], r['rank'], r['device_name']) for r in reports]}")
    want = dict(completed=True, monotone=True, server_kills=1, client_kills=2, unaccounted=0,
                versions=SLICE18_SOAK["versions"])
    if any(res[k] != v for k, v in want.items()) or res["session_epoch"] < 1 or (
            res["resumed_from_journal"] + res["cold_rejoins"] != res["client_kills"]) or not (
            res["chaos"] and sum(res["chaos"]["injected"].values()) > 0):
        raise AssertionError(f"phase 15 (b): {res}")
    if any(r["jax_loaded"] or r["fedml_tpu_loaded"] for r in reports):
        raise AssertionError(f"phase 15 (b): a worker imported jax: {reports}")
    return res


def phase_slice18(mods, nz):
    """Phase 15 (module docstring).  Returns each kernel's launches on (a),
    summed over its processes."""
    import tempfile

    walls = {}
    with tempfile.TemporaryDirectory(prefix="fedml_slice18_") as root:
        t0 = time.perf_counter()
        counts = phase_slice18_async(mods, nz, root)
        walls["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_slice18_soak()
    walls["b"] = time.perf_counter() - t0
    print(f"slice 18: phase 15 {sum(walls.values()):.1f} s ("
          + ", ".join(f"({k}) {v:.1f} s" for k, v in walls.items())
          + f"); launches on (a) summed over its processes: {counts}")
    return counts


# -- phase 16: the edge tree, the secure protocols over TCP, FHE (slice 19) -------

SLICE19_SILOS = 8
SLICE19_FANOUT = 4  # 2 edges of 4 silos
SLICE19_ROUNDS = 2
# the root's ingress a round against the 8 compressed uploads a flat root
# would take: at least this ratio
SLICE19_INGRESS_RATIO = 3.0
# (b): the soak on ResNet-20's tree (f32, 4 uploads of a scaled global a
# round, qsgd8 on the client hop), an edge killed after its first child
SLICE19_SOAK = dict(n_clients=4, fanout=2, rounds=2, seed=3, codec="qsgd8", model="resnet20",
                    cfg_overrides={"dataset": "cifar10", "synthetic_test_size": 256})
HORIZONTAL_LR = "examples/cross_silo_horizontal_lr/fedml_config.yaml"
SLICE19_CRASHES = {"round boundary": dict(kill_server_before_round=1),
                   "inside round 1": dict(kill_server_after_uploads=(1, 2))}
FHE_ACC_GAP = 0.05


def _float_leaves(tree, floor):
    """The float leaves of a flax-layout tree of at least ``floor`` elements:
    the leaves ``compress_pytree`` encodes at that floor."""
    import numpy as np

    from fedml_tpu_torch.comm import wire

    _, leaves = wire.flatten_with_skeleton(tree)
    return sum(1 for a in leaves if np.asarray(a).dtype.kind == "f" and np.size(a) >= floor)


class _PartialTap:
    """Wraps the root aggregator's ``fold_partial`` and ``aggregate``: each
    round's folded partials (undecoded messages, sources, ``w_delta``) and
    the base and global they were folded onto."""

    def __init__(self, agg):
        self.agg, self.rounds, self._parts, self.last = agg, [], [], None
        fold_partial, aggregate = agg.fold_partial, agg.aggregate

        def tapped_fold_partial(msg, sources, w_delta):
            done = fold_partial(msg, sources, w_delta)
            if done:
                self._parts.append((msg, {int(k): float(v) for k, v in sources.items()},
                                    float(w_delta)))
            return done

        def tapped_aggregate(round_idx):
            from fedml_tpu_torch.core import pytree as pt

            tmpl, skel = agg._stream_template()
            self.last = dict(round=round_idx, parts=self._parts, skel=skel,
                             base=[t.float().cpu().numpy() for t in tmpl],
                             old=pt.tree_map(lambda t: t.clone(), agg.global_vars),
                             state=agg.server_state)
            self.rounds.append(sorted(s for _, src, _ in self._parts for s in src))
            self._parts = []
            return aggregate(round_idx)

        agg.fold_partial, agg.aggregate = tapped_fold_partial, tapped_aggregate

    def refold(self, leave_out=None):
        """The last round's global from the partials by numpy's decode (the
        plain dequantize) and an f64 sum, the base added back for the delta
        mass, then the server step, flattened in the reference's order;
        ``leave_out`` drops one partial (by its index)."""
        import numpy as np
        import torch

        from fedml_tpu_torch import weights
        from fedml_tpu_torch.comm import wire
        from fedml_tpu_torch.cross_silo import message_define as md

        last = self.last
        parts = [p for i, p in enumerate(last["parts"]) if i != leave_out]
        total = sum(sum(src.values()) for _, src, _ in parts)
        w_delta = sum(wd for _, _, wd in parts)
        acc = [w_delta * b.astype(np.float64) for b in last["base"]]
        for msg, _, _ in parts:
            for i, _, arr in msg.tensor_frame()[1]:
                acc[i] += np.asarray(arr, np.float64)
        dev = _card()
        out = [torch.from_numpy((a / total).astype(np.float32)).to(dev) for a in acc]
        plain = weights.tensors_from_flax(
            wire.restore_skeleton(last["skel"], out)[md.MSG_ARG_KEY_MODEL_PARAMS])
        new, _ = self.agg.algorithm.server_update(last["old"], last["state"], plain,
                                                  last["round"])
        return weights.flatten_reference(new)[0]


class _EdgeFoldTap:
    """Wraps ``EdgePartialFold.fold_child`` (on the class, until
    :meth:`close`) and each edge's ``_ship_locked``: the child uploads
    (undecoded messages and weights) behind each partial an edge ships, by
    (edge rank, round)."""

    def __init__(self, edges):
        from fedml_tpu_torch.cross_silo.edge import EdgePartialFold

        self._cls, self._orig = EdgePartialFold, EdgePartialFold.fold_child
        self._taken, self.shipped = {}, {}
        orig = self._orig

        def tapped_fold_child(fold, child_rank, msg, sample_num, is_delta):
            done = orig(fold, child_rank, msg, sample_num, is_delta)
            if done:
                self._taken.setdefault(fold, []).append((int(child_rank), msg,
                                                         float(sample_num)))
            return done

        EdgePartialFold.fold_child = tapped_fold_child
        for e in edges:
            def tapped_ship(resend=False, e=e, ship=e._ship_locked):
                if e._fold is not None:
                    self.shipped[(e.rank, e._round_idx)] = list(self._taken.get(e._fold, ()))
                return ship(resend)

            e._ship_locked = tapped_ship

    def close(self):
        self._cls.fold_child = self._orig

    def check(self, last):
        """Each partial the root took in ``last`` (``_PartialTap.last``)
        against its edge's child uploads refolded by numpy (the plain decode,
        an f64 weighted sum).  The children and their weights must be the
        partial's tagged sources.  Per element the bound is the hop's qsgd8
        step (the block's largest magnitude over 127: stochastic rounding
        moves a value by less than one step; 0 on a raw leaf) plus the f32
        sum's rounding ((children + 1) x eps x the sum of |w x|).  Returns
        ``(worst |error| / bound, per edge the least of that ratio with one
        child's upload left out)``."""
        import numpy as np

        from fedml_tpu_torch.ops import quantize as qz

        eps = float(np.finfo(np.float32).eps)
        worst, without = 0.0, []
        for msg, sources, _ in last["parts"]:
            edge = int(msg.get_sender_id())
            kids = self.shipped[(edge, last["round"])]
            if {r: w for r, _, w in kids} != sources:
                raise AssertionError(f"phase 16 (a): edge {edge} folded "
                                     f"{[(r, w) for r, _, w in kids]}, tagged {sources}")
            terms = [[w * np.asarray(a, np.float64) for _, _, a in m.tensor_frame()[1]]
                     for _, m, w in kids]
            ratios = [[] for _ in kids]
            for i, spec, arr in msg.tensor_frame()[1]:
                leaf = [t[i].ravel() for t in terms]
                ref, mag = sum(leaf), sum(np.abs(x) for x in leaf)
                step = np.zeros_like(ref)
                if spec.get("codec", "raw") == "qsgd8":
                    pad = np.pad(np.abs(ref), (0, (-ref.size) % qz.BLOCK))
                    amax = pad.reshape(-1, qz.BLOCK).max(axis=1) / 127.0
                    step = np.repeat(amax, qz.BLOCK)[:ref.size]
                bound = np.maximum(step * (1 + 1e-5) + (len(kids) + 1) * eps * mag, 1e-30)
                got = np.asarray(arr, np.float64).ravel()
                worst = max(worst, float((np.abs(got - ref) / bound).max()))
                for k, x in enumerate(leaf):
                    ratios[k].append(float((np.abs(got - (ref - x)) / bound).max()))
            without.append(min(max(r) for r in ratios))
        return worst, without


class _EdgeProbe:
    """Wraps the root's metrics logger: at each logged round the edges'
    cumulative child-upload bytes and folds, and the launch counts."""

    def __init__(self, inner, edges, counts):
        self.inner, self.edges, self.counts, self.rows = inner, edges, counts, []

    def log(self, metrics, step=None):
        import torch

        torch.cuda.synchronize()
        self.rows.append((dict(metrics), sum(e.upload_ingress_bytes for e in self.edges),
                          self.counts()))
        self.inner.log(metrics, step)


def phase_slice19_tree(mods, nz):
    """(a): the flagship ResNet-20 as 8 silo threads over loopback TCP under
    a tree of 2 edges, qsgd8 uploads folded at the edges, qsgd8 partials
    re-encoded on the hop and folded at the root."""
    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.comm import codecs
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.runner import FedMLRunner

    fb, qz = mods
    cfg = fedml_tpu_torch.init(argv=["--cf", FLAGSHIP])
    cfg.training_type, cfg.role, cfg.backend = "cross_silo", "server", "TCP"
    cfg.client_num_in_total = cfg.client_num_per_round = SLICE19_SILOS
    cfg.synthetic_train_size = SLICE17_TRAIN
    cfg.comm_round = SLICE19_ROUNDS
    cfg.frequency_of_the_test = 1
    cfg.run_id = "slice19_tree"
    cfg.extra.update(fused_blocks=True, tcp_base_port=0, comm_compression="qsgd8",
                     streaming_aggregation=True, hier_fanout=SLICE19_FANOUT,
                     hier_hop_codec="qsgd8")
    t0 = time.perf_counter()
    runner = FedMLRunner(cfg)
    group = runner.runner
    group.setup()
    server, clients, edges = group.server, group.clients, group.server.edges
    host = server.aggregator.host_global_flax()
    n_up = _float_leaves(host, codecs.DEFAULT_MIN_COMPRESS_ELEMS)
    n_hop = _float_leaves(host, codecs.LOW_RANK_MIN_COMPRESS_ELEMS)
    all_mods = mods + (nz,)
    probe = _EdgeProbe(server.logger, edges, lambda: _all_counts(all_mods))
    server.logger = probe
    tap = _PartialTap(server.aggregator)
    edge_tap = _EdgeFoldTap(edges)
    steps = sum(c.trainer.trained_samples for c in clients) // cfg.batch_size
    print(f"phase 16 (a): set-up {time.perf_counter() - t0:.1f} s (data "
          f"{runner.dataset.train_num}/{runner.dataset.test_num}, {steps} local steps a round "
          f"over {SLICE19_SILOS} silos, batch {cfg.batch_size}, {cfg.compute_dtype}; edges "
          f"{[e.rank for e in edges]} over {[server.topology.children_of[e.rank] for e in edges]}"
          f"; TCP ports {server.com_manager.port_map}; qsgd8 leaves {n_up} an upload, "
          f"{n_hop} a partial)")
    _reset_counts(all_mods)
    try:
        history = runner.run()
    finally:
        edge_tap.close()
    torch.cuda.synchronize()
    counts = _all_counts(all_mods)
    prev_bytes, prev = 0, {k: 0 for k in counts}
    ratios = []
    for metrics, child_bytes, cum in probe.rows:
        delta = {k: cum[k] - prev[k] for k in cum if cum[k] - prev[k]}
        up_bytes = child_bytes - prev_bytes
        prev, prev_bytes = cum, child_bytes
        ratios.append(up_bytes / metrics["upload_bytes"])
        print(f"phase 16 (a) round {metrics['round']}: {metrics['round_time_s']:.3f} s, root "
              f"ingress {metrics['upload_bytes']} bytes (2 partials) against the {SLICE19_SILOS} "
              f"compressed uploads a flat root would take, {up_bytes} bytes: "
              f"{ratios[-1]:.3f}x; fold {1e3 * metrics['fold_time_s']:.1f} ms, finalize "
              f"{1e3 * metrics['finalize_time_s']:.1f} ms, test_acc {metrics['test_acc']:.4f}, "
              f"{_mem()}, launches {delta}")
    folded = [len(r) for r in tap.rounds]
    want_q = SLICE19_ROUNDS * (SLICE19_SILOS * n_up + len(edges) * n_hop)
    q, dq = counts[qz.QUANTIZE.name], counts[qz.DEQUANTIZE.name]
    per_edge = [(e.rank, e.folds, e.relays, e.partials_sent, e.upload_ingress_bytes)
                for e in edges]
    print(f"phase 16 (a): sources folded by round {tap.rounds}; edges {per_edge} "
          f"(rank, folds, relays, partials, child bytes); quantize {q} and dequantize {dq} "
          f"launches, predicted {want_q} each ({SLICE19_ROUNDS} rounds x ({SLICE19_SILOS} "
          f"uploads x {n_up} + {len(edges)} partials x {n_hop}))")
    if folded != [SLICE19_SILOS] * SLICE19_ROUNDS or len(history) != SLICE19_ROUNDS:
        raise AssertionError(f"phase 16 (a): sources folded {tap.rounds}, rounds {len(history)}")
    if min(ratios) < SLICE19_INGRESS_RATIO:
        raise AssertionError(f"phase 16 (a): root ingress ratios {ratios}")
    if q != want_q or dq != want_q:
        raise AssertionError(f"phase 16 (a): quantize {q}, dequantize {dq}, want {want_q}")
    bad = [k.name for k in fb.KERNELS if counts[k.name] == 0]
    if bad or any(e.relays for e in edges) or server.aggregator.peak_buffered_updates > 2:
        raise AssertionError(f"phase 16 (a): fused kernels not launched {bad}, relays, or peak "
                             f"{server.aggregator.peak_buffered_updates}")
    for metrics in history:
        for key in ("test_loss", "test_acc"):
            if not math.isfinite(metrics[key]):
                raise AssertionError(f"phase 16 (a) round {metrics['round']}: {key}")
    glob = server.aggregator.global_vars
    if not all(bool(torch.isfinite(t).all()) for t in pt.tree_leaves(glob)):
        raise AssertionError("phase 16 (a): non-finite global")
    from fedml_tpu_torch import weights

    got = weights.flatten_reference(server.aggregator.global_vars)[0]
    err = float((got - tap.refold()).abs().max())
    without = [float((got - tap.refold(leave_out=i)).abs().max())
               for i in range(len(tap.last["parts"]))]
    print(f"phase 16 (a): round {tap.last['round']}'s global against the numpy refold of the "
          f"{len(tap.last['parts'])} partials the root took: max abs {err:.3g} (limit "
          f"{REFOLD_ATOL:g}); leaving one partial out: max abs "
          + ", ".join(f"{v:.3g}" for v in without))
    if not (err <= REFOLD_ATOL and min(without) > 10 * REFOLD_ATOL):
        raise AssertionError(f"phase 16 (a): refold {err:.3g}, without one {without}")
    worst, without = edge_tap.check(tap.last)
    print(f"phase 16 (a): each edge's partial as the root decoded it against the numpy refold "
          f"of that edge's {SLICE19_FANOUT} child uploads (f64, the tagged weights): worst "
          f"|error| / bound {worst:.3g} (limit 1; the bound is the hop's qsgd8 step plus the "
          f"f32 sum's rounding); leaving one child's upload out, by edge: "
          + ", ".join(f"{v:.3g}" for v in without) + " (must exceed 10)")
    if not (worst <= 1.0 and len(without) == len(edges) and min(without) > 10):
        raise AssertionError(f"phase 16 (a): edge refold {worst:.3g}, without one {without}")
    return counts


def phase_slice19_soak():
    """(b): ``run_edge_kill_soak`` on the card: the kill leg bitwise the
    clean leg, nothing unaccounted."""
    import numpy as np

    from fedml_tpu_torch.cross_silo.async_soak import run_edge_kill_soak

    legs = {}
    for leg, kill in (("clean", None), ("kill", (0, 0, 1))):
        t0 = time.perf_counter()
        legs[leg] = run_edge_kill_soak(kill=kill, **SLICE19_SOAK)
        legs[leg]["wall"] = time.perf_counter() - t0
    clean, kill = legs["clean"], legs["kill"]
    same = all(np.array_equal(a, b) for a, b in zip(clean["global_leaves"],
                                                    kill["global_leaves"]))
    keys = ("edge_kills", "uploads_sent", "edge_folds", "edge_dedups", "unaccounted",
            "partials_sent", "root_ingress_bytes", "peak_buffered_root", "peak_buffered_edge")
    print(f"phase 16 (b): the edge kill soak on the card ({clean['wall']:.1f} s clean, "
          f"{kill['wall']:.1f} s with the kill): " + ", ".join(f"{k} {kill[k]}" for k in keys)
          + f"; final global bitwise the clean leg's: {same}")
    if not (same and kill["unaccounted"] == 0 and clean["unaccounted"] == 0
            and kill["edge_kills"] == 1 and kill["edge_dedups"] >= 1
            and max(kill["peak_buffered_root"], kill["peak_buffered_edge"]) <= 2):
        raise AssertionError(f"phase 16 (b): {({k: kill[k] for k in keys})}, bitwise {same}")


def _horizontal_lr(run_id, **extra):
    import fedml_tpu_torch

    cfg = fedml_tpu_torch.init(argv=["--cf", HORIZONTAL_LR])
    cfg.comm_round = SLICE19_ROUNDS
    cfg.frequency_of_the_test = 1
    cfg.run_id = run_id
    cfg.extra.update(extra)
    return cfg


def phase_slice19_shamir(nz, root):
    """(c): Shamir SecAgg with central DP over loopback TCP with the server
    journal, the LR recipe, 2 rounds: kernel 7 once a round; the server
    killed at round 1's boundary and inside round 1, each rebuilt over its
    journal, bitwise the uninterrupted run."""
    import torch

    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.cross_silo.crash_drill import run_with_crashes
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub

    runs = {}
    for tag, kw in (("uninterrupted", {}), *SLICE19_CRASHES.items()):
        cfg = _horizontal_lr(f"slice19_shamir_{tag.replace(' ', '_')}", secagg_method="shamir",
                             secagg_stream=True, tcp_base_port=0,
                             server_journal_dir=f"{root}/{tag.replace(' ', '_')}")
        cfg.backend, cfg.enable_secagg = "TCP", True
        for k, v in DP.items():
            setattr(cfg, k, v)
        ds = loader.load(cfg)
        model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
        before = nz.launch_counts()[nz.NOISE.name]
        t0 = time.perf_counter()
        runs[tag] = run_with_crashes(cfg, ds, model, _card(), backend="TCP", timeout=120.0, **kw)
        torch.cuda.synchronize()
        runs[tag]["wall"] = time.perf_counter() - t0
        runs[tag]["noise"] = nz.launch_counts()[nz.NOISE.name] - before
    base = pt.tree_leaves(runs["uninterrupted"]["server"].aggregator.global_vars)
    for tag, out in runs.items():
        same = all(torch.equal(a, b) for a, b in zip(
            base, pt.tree_leaves(out["server"].aggregator.global_vars)))
        rounds = [h["round"] for h in out["history"]]
        print(f"phase 16 (c) {tag}: {out['wall']:.1f} s, rounds {rounds}, server kills "
              f"{out['server_kills']}, recovered step {out['server'].recovered_step}, session "
              f"epoch {out['server'].session_epoch}, noise launches {out['noise']}, finalize "
              + ", ".join(f"{1e3 * h['finalize_time_s']:.1f}" for h in out["history"])
              + f" ms, final global bitwise the uninterrupted run's: {same}")
        if rounds != list(range(SLICE19_ROUNDS)) or not same:
            raise AssertionError(f"phase 16 (c) {tag}: rounds {rounds}, bitwise {same}")
        if tag != "uninterrupted" and (out["server_kills"], out["server"].session_epoch) != (1, 1):
            raise AssertionError(f"phase 16 (c) {tag}: the drill did not run as set")
    if runs["uninterrupted"]["noise"] != SLICE19_ROUNDS:
        raise AssertionError(f"phase 16 (c): noise launches {runs['uninterrupted']['noise']}, "
                             f"want {SLICE19_ROUNDS} (once a round)")


def phase_slice19_fhe():
    """(d): FHE on the LR recipe, 4 silos, 2 rounds: the decrypted mean
    against the plaintext mean of the same uploads, and accuracy against
    the plain run."""
    import numpy as np
    import torch

    from fedml_tpu_torch import weights
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = _horizontal_lr("slice19_fhe")
    cfg.enable_fhe = True
    t0 = time.perf_counter()
    runner = FedMLRunner(cfg)
    group = runner.runner
    group.setup()
    flats, plain_means, fhe_means = {}, [], []
    for c in group.clients:
        def keep(*a, _c=c, _train=c.trainer.train, **k):
            out = _train(*a, **k)
            flats[_c.rank] = weights.flatten_reference(out[0])[0].cpu().numpy()
            return out

        c.trainer.train = keep
    agg = group.server.aggregator
    aggregate = agg.aggregate

    def tapped(round_idx):
        plain_means.append(np.mean([flats[r].astype(np.float64) for r in sorted(flats)], 0))
        t1 = time.perf_counter()
        out = aggregate(round_idx)
        tapped.secs.append(time.perf_counter() - t1)
        fhe_means.append(weights.flatten_reference(agg.global_vars)[0].cpu().numpy())
        return out

    tapped.secs = []
    agg.aggregate = tapped
    history = runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = cfg.client_num_in_total
    step = 2.0 ** -int(agg.cipher.params.frac_bits)
    errs = [float(np.max(np.abs(f - p))) for f, p in zip(fhe_means, plain_means)]
    blocks = -(-agg.model_dim // agg.cipher.params.n)
    plain_cfg = _horizontal_lr("slice19_fhe_plain")
    plain = FedMLRunner(plain_cfg).run()
    gap = abs(history[-1]["test_acc"] - plain[-1]["test_acc"])
    print(f"phase 16 (d): FHE {len(history)} rounds in {wall:.1f} s with its set-up ({n} silos, "
          f"{agg.model_dim} parameters in {blocks} blocks of {agg.cipher.params.n}; "
          f"aggregate + decrypt " + ", ".join(f"{s:.3f}" for s in tapped.secs) + " s a round, "
          f"round times " + ", ".join(f"{h['round_time_s']:.3f}" for h in history) + " s); the "
          f"decrypted mean against the plaintext mean of the same uploads: max abs "
          + ", ".join(f"{e:.3g}" for e in errs) + f" (bound n x 2^-16 = {n * step:.3g}); "
          f"test_acc {history[-1]['test_acc']:.4f} against the plain run's "
          f"{plain[-1]['test_acc']:.4f} (gap {gap:.4f}, limit {FHE_ACC_GAP})")
    if len(errs) != SLICE19_ROUNDS or max(errs) > n * step or gap > FHE_ACC_GAP:
        raise AssertionError(f"phase 16 (d): errors {errs}, accuracy gap {gap}")


def phase_slice19(mods, nz):
    """Phase 16 (module docstring).  Returns each kernel's launches over the
    phase."""
    import tempfile

    all_mods = mods + (nz,)
    walls = {}
    _reset_counts(all_mods)
    t0 = time.perf_counter()
    tree_counts = phase_slice19_tree(mods, nz)
    walls["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_slice19_soak()
    walls["b"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="fedml_slice19_") as root:
        t0 = time.perf_counter()
        phase_slice19_shamir(nz, root)
        walls["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_slice19_fhe()
    walls["d"] = time.perf_counter() - t0
    counts = _all_counts(all_mods)
    print(f"slice 19: phase 16 {sum(walls.values()):.1f} s ("
          + ", ".join(f"({k}) {v:.1f} s" for k, v in walls.items())
          + f"); launches on (a) {tree_counts}; over the phase {counts}")
    return counts


# -- phase 17 (slice 20): the transports between processes -------------------------
# gRPC is not driven on the card: its machine has no grpcio.  The CPU tests
# hold it against the reference (tests/test_torch_grpc.py); its device work
# is TCP's, phase 14's.
SLICE20_KICKED = 2  # (a): the silo whose broker session is kicked
SLICE20_KICK_ROUND = 1  # as this round closes
SLICE20_STRAGGLER_S = 60.0  # only a lost message would wait this long (a failure)
SLICE20_PROC_SILOS = 2  # (b)
SLICE20_PROC_ROUNDS = 2
SLICE20_TIMEOUT_S = 300.0  # (b): each process's wall-clock bound


def _mqtt_fabric():
    """The port's MQTT broker and HTTP object store on loopback, started:
    ``(broker, store, the extra flags that point a run at them)``."""
    from fedml_tpu_torch.comm.mqtt_wire import MiniMqttBroker
    from fedml_tpu_torch.comm.object_store_http import MiniObjectStoreServer

    broker, store = MiniMqttBroker(), MiniObjectStoreServer()
    broker.start()
    store.start()
    return broker, store, {"mqtt_host": "127.0.0.1", "mqtt_port": broker.port,
                           "object_store_url": store.url}


def _slice20_cfg(tag, fabric):
    """Phase 14's recipe over MQTT_S3 (no chunk frames: the MQTT backend
    takes none, as the reference's), qsgd8 folded as it lands, no journal."""
    cfg = _slice17_cfg(None, tag, comm_compression="qsgd8", streaming_aggregation=True,
                       straggler_timeout_s=SLICE20_STRAGGLER_S, **fabric)
    cfg.backend = "MQTT_S3"
    for k in ("tcp_base_port", "comm_chunk_bytes"):
        cfg.extra.pop(k)
    return cfg


def _refold_check(what, agg, tap):
    """The last round's global against the numpy refold of its uploads,
    and one upload left out."""
    from fedml_tpu_torch import weights

    got = weights.flatten_reference(agg.global_vars)[0]
    err = float((got - tap.refold()).abs().max())
    without = {c: float((got - tap.refold(leave_out=c)).abs().max())
               for c, *_ in tap.last["folds"]}
    print(f"{what}: round {tap.last['round']}'s global against the plain refold of its "
          f"{len(tap.last['folds'])} uploads: max abs {err:.3g} (limit {REFOLD_ATOL:g}); one "
          "upload left out: " + ", ".join(f"silo {c} {v:.3g}" for c, v in sorted(without.items())))
    if not (err <= REFOLD_ATOL and min(without.values()) > 10 * REFOLD_ATOL):
        raise AssertionError(f"{what}: the global is {err:.3g} from the plain refold (limit "
                             f"{REFOLD_ATOL:g}); without one upload {without}")


def _check_history(what, history, rounds, global_vars):
    import torch

    from fedml_tpu_torch.core import pytree as pt

    if len(history) != rounds:
        raise AssertionError(f"{what}: {len(history)} rounds, want {rounds}")
    for metrics in history:
        for key in ("test_loss", "test_acc"):
            if not math.isfinite(metrics[key]):
                raise AssertionError(f"{what} round {metrics['round']}: {key} {metrics[key]}")
    if not all(bool(torch.isfinite(t).all()) for t in pt.tree_leaves(global_vars)):
        raise AssertionError(f"{what}: non-finite global")


def phase_slice20_threads(mods, nz):
    """(a): phase 14's recipe as 4 silo threads over MQTT_S3, silo 2's
    session kicked as round 1 closes."""
    import torch

    from fedml_tpu_torch.comm.mqtt_s3 import MqttS3CommManager
    from fedml_tpu_torch.cross_silo import build_process_group
    from fedml_tpu_torch.runner import FedMLRunner

    broker, store, fabric = _mqtt_fabric()
    try:
        cfg = _slice20_cfg("slice20_mqtt", fabric)
        t0 = time.perf_counter()
        runner = FedMLRunner(cfg)
        group = runner.runner
        group.server, group.clients = build_process_group(cfg, runner.dataset, runner.model,
                                                          runner.device, cfg.backend)
        server, clients = group.server, group.clients
        if not isinstance(server.com_manager, MqttS3CommManager):
            raise AssertionError(f"phase 17 (a): server transport {type(server.com_manager)}")
        print(f"phase 17 (a): set-up {time.perf_counter() - t0:.1f} s (data "
              f"{runner.dataset.train_num}/{runner.dataset.test_num}, {SILOS} silo threads, batch "
              f"{cfg.batch_size}, {cfg.compute_dtype}; MQTT broker 127.0.0.1:{broker.port}, HTTP "
              f"store {store.url}; payloads over 8 KiB through the store)")
        all_mods = mods + (nz,)
        probe = _RoundProbe(server.logger, lambda: _all_counts(all_mods))
        server.logger = probe
        agg = server.aggregator
        tap = _FoldTap(agg)
        kicked = clients[SLICE20_KICKED - 1]
        wire = kicked.com_manager.broker._client
        kick = {}
        aggregate = agg.aggregate

        def kick_at_close(round_idx):
            # every upload of the round is in and no dispatch is in flight:
            # the kicked silo's dead window loses nothing, and the next
            # dispatch waits for its re-SUBSCRIBE
            if round_idx == SLICE20_KICK_ROUND and not kick:
                t_kick = time.perf_counter()
                broker.kick(kicked.com_manager.client_id)
                deadline = time.monotonic() + 30.0
                while wire.reconnects < 1:
                    if time.monotonic() > deadline:
                        raise AssertionError("phase 17 (a): the kicked silo did not reconnect")
                    time.sleep(0.01)
                topic = kicked.com_manager._my_topic()
                while not any(sess.client_id == kicked.com_manager.client_id and sess.alive
                              and topic in {f for f, _ in sess.subs}
                              for sess in list(broker._sessions)):
                    if time.monotonic() > deadline:
                        raise AssertionError("phase 17 (a): the kicked silo did not re-subscribe")
                    time.sleep(0.01)
                kick["reconnect_s"] = time.perf_counter() - t_kick
            return aggregate(round_idx)

        agg.aggregate = kick_at_close
        _reset_counts(all_mods)
        history = runner.run()
        torch.cuda.synchronize()
        counts = _all_counts(all_mods)
    finally:
        broker.stop()
        store.stop()
    parties = [server, *clients]
    topic_bytes = sum(p.com_manager.payload_bytes for p in parties)
    store_put = sum(p.com_manager.store_bytes for p in parties)
    held = sum(len(b) for b in store._blobs.values())
    prev = {k: 0 for k in counts}
    samples = sum(c.trainer.trained_samples for c in clients)
    for (metrics, cum, mem), folded in zip(probe.rows, tap.rounds):
        delta = {k: cum[k] - prev[k] for k in cum if cum[k] - prev[k]}
        prev = cum
        print(f"phase 17 (a) round {metrics['round']}: {metrics['round_time_s']:.3f} s, "
              f"{samples / metrics['round_time_s']:.0f} trained samples/s, silos folded "
              f"{folded}, fold {1e3 * metrics['fold_time_s']:.1f} ms, finalize "
              f"{1e3 * metrics['finalize_time_s']:.1f} ms, uploads {metrics['upload_bytes']} "
              f"bytes, test_acc {metrics['test_acc']:.4f}, {_mem(mem)}, launches {delta}")
    sync = ", ".join(f"{t:.3f}" for t, _ in _SLICE17_ROUNDS)
    print(f"phase 17 (a): {len(store._blobs)} payloads through the store, {store_put} bytes put "
          f"({held} held), {topic_bytes} bytes through the topics; silo {SLICE20_KICKED} kicked "
          f"as round {SLICE20_KICK_ROUND} closed, back in {kick.get('reconnect_s', 0):.3f} s "
          f"({wire.reconnects} reconnect); phase 14's TCP rounds {sync} s")
    uploads = SLICE17_ROUNDS * SILOS
    q, dq = counts[mods[1].QUANTIZE.name], counts[mods[1].DEQUANTIZE.name]
    bad = [k.name for k in mods[0].KERNELS if counts[k.name] == 0]
    if tap.rounds != [list(range(1, SILOS + 1))] * SLICE17_ROUNDS or wire.reconnects < 1:
        raise AssertionError(f"phase 17 (a): silos folded {tap.rounds}, reconnects "
                             f"{wire.reconnects}")
    if kicked.rounds_trained != SLICE17_ROUNDS or store_put != held or not held:
        raise AssertionError(f"phase 17 (a): the kicked silo trained {kicked.rounds_trained}; "
                             f"store {store_put} put, {held} held")
    if (bad or q != QSGD8_LEAVES * uploads or dq != QSGD8_LEAVES * uploads
            or counts[nz.NOISE.name] != SLICE17_ROUNDS):
        raise AssertionError(f"phase 17 (a): fused kernels not launched {bad}, quantize {q}, "
                             f"dequantize {dq} (want {QSGD8_LEAVES * uploads} each), noise "
                             f"{counts[nz.NOISE.name]} (want {SLICE17_ROUNDS})")
    if not agg.stream_mode or agg.peak_buffered_updates > 2:
        raise AssertionError(f"phase 17 (a): stream {agg.stream_mode}, peak buffered "
                             f"{agg.peak_buffered_updates}")
    _check_history("phase 17 (a)", history, SLICE17_ROUNDS, agg.global_vars)
    _refold_check("phase 17 (a)", agg, tap)
    return counts


def phase_slice20_procs(mods, nz, root):
    """(b): the server alone in this process, its silos processes of their
    own, over MQTT_S3."""
    import json
    import os

    import torch

    from fedml_tpu_torch.cross_silo.async_soak import _tail, spawn_soak_worker
    from fedml_tpu_torch.runner import FedMLRunner

    broker, store, fabric = _mqtt_fabric()
    workdir = os.path.join(root, "slice20_procs")
    os.makedirs(workdir)
    procs = []
    try:
        cfg = _slice20_cfg("slice20_procs", fabric)
        cfg.client_num_in_total = cfg.client_num_per_round = SLICE20_PROC_SILOS
        cfg.comm_round = SLICE20_PROC_ROUNDS
        cfg_path = os.path.join(workdir, "cfg.json")
        with open(cfg_path, "w") as f:
            json.dump(_child_cfg_json(cfg), f)
        t0 = time.perf_counter()
        procs = [spawn_soak_worker(cfg_path, "client", r, workdir,
                                   os.path.join(workdir, f"client_{r}.log"),
                                   device=SLICE18_CHILD_DEVICE)
                 for r in range(1, SLICE20_PROC_SILOS + 1)]
        runner = FedMLRunner(cfg)
        group = runner.runner
        group.timeout = SLICE20_TIMEOUT_S
        group.setup()
        server = group.server
        if group.clients:
            raise AssertionError("phase 17 (b): the server's process built silos")
        all_mods = mods + (nz,)
        tap = _FoldTap(server.aggregator)
        _reset_counts(all_mods)
        t_run = time.perf_counter()
        history = runner.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        counts = _all_counts(all_mods)
        for p in procs:
            if p.wait(timeout=60) != 0:
                raise AssertionError(f"phase 17 (b): a silo process exited {p.returncode}")
    except BaseException:
        for r in range(1, SLICE20_PROC_SILOS + 1):
            print(f"--- silo {r} ---\n{_tail(os.path.join(workdir, f'client_{r}.log'))}")
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
        broker.stop()
        store.stop()
    reports = []
    for name in sorted(os.listdir(workdir)):
        if name.startswith("report_r"):
            with open(os.path.join(workdir, name)) as f:
                reports.append(json.load(f))
    silos = [r for r in reports if r["role"] == "client"]
    child_sum = {k: sum(r["launches"].get(k, 0) for r in silos) for k in counts}
    trained = sum(r["rounds_trained"] for r in silos)
    times = ", ".join(f"{m['round_time_s']:.3f}" for m in history)
    print(f"phase 17 (b): {len(history)} rounds in {wall:.3f} s after {t_run - t0:.1f} s of "
          f"set-up (round times {times} s); silos folded {tap.rounds}; "
          f"{len(store._blobs)} payloads through the store; server launches {counts}; summed "
          f"over the {len(silos)} silo processes {child_sum}")
    for r in sorted(silos, key=lambda r: r["rank"]):
        print(f"phase 17 (b) silo {r['rank']} (pid {r['pid']}, {r['device_name']}, jax imported: "
              f"{r['jax_loaded']}): {r['rounds_trained']} uploads trained")
    if len(silos) != SLICE20_PROC_SILOS or any(
            r["jax_loaded"] or r["fedml_tpu_loaded"]
            or r["device_name"] != torch.cuda.get_device_name(0) for r in silos):
        raise AssertionError(f"phase 17 (b): silo reports {silos}")
    q, dq, noise = mods[1].QUANTIZE.name, mods[1].DEQUANTIZE.name, nz.NOISE.name
    bad = [(r["rank"], k.name) for r in silos for k in mods[0].KERNELS
           if r["launches"].get(k.name, 0) == 0]
    folded = sum(len(r) for r in tap.rounds)
    if (tap.rounds != [list(range(1, SLICE20_PROC_SILOS + 1))] * SLICE20_PROC_ROUNDS
            or trained != folded or bad or child_sum[q] != QSGD8_LEAVES * trained
            or counts[dq] != QSGD8_LEAVES * folded or counts[noise] != SLICE20_PROC_ROUNDS
            or counts[q] or child_sum[dq] or child_sum[noise]):
        raise AssertionError(f"phase 17 (b): folded {tap.rounds}, trained {trained}, rows 1-4 "
                             f"missing {bad}, server {counts}, silos {child_sum}")
    _check_history("phase 17 (b)", history, SLICE20_PROC_ROUNDS, server.aggregator.global_vars)
    _refold_check("phase 17 (b)", server.aggregator, tap)
    return {k: counts[k] + child_sum[k] for k in counts}


def phase_slice20_web3():
    """(c): the LR recipe's group over WEB3 against the INPROC group."""
    import torch

    from fedml_tpu_torch.comm.blockchain import BlockchainCommManager, InMemoryLedger
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.cross_silo import build_process_group, run_group
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub

    runs = {}
    for backend in ("WEB3", "INPROC"):
        cfg = _horizontal_lr(f"slice20_{backend.lower()}")
        ds = loader.load(cfg)
        model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
        t0 = time.perf_counter()
        server, clients = build_process_group(cfg, ds, model, _card(), backend)
        history = run_group(server, clients, timeout=120.0)
        torch.cuda.synchronize()
        blocks = len(InMemoryLedger.get(cfg.run_id).read_since(0))
        runs[backend] = (history, pt.tree_leaves(server.aggregator.global_vars),
                         time.perf_counter() - t0, blocks, server)
    (h_w, g_w, s_w, blocks, server), (h_i, g_i, s_i, _, _) = runs["WEB3"], runs["INPROC"]
    drop = ("round_time_s", "aggregate_time_s")
    same_hist = [{k: v for k, v in h.items() if k not in drop} for h in h_w] == \
        [{k: v for k, v in h.items() if k not in drop} for h in h_i]
    same = all(torch.equal(a, b) for a, b in zip(g_w, g_i))
    print(f"phase 17 (c): WEB3 {len(h_w)} rounds in {s_w:.2f} s ({blocks} blocks on the ledger; "
          f"round times {', '.join(f'{h['round_time_s']:.3f}' for h in h_w)} s) against INPROC "
          f"{s_i:.2f} s; history bitwise {same_hist}, global bitwise {same}")
    if not (isinstance(server.com_manager, BlockchainCommManager) and same and same_hist
            and blocks and len(h_w) == SLICE19_ROUNDS):
        raise AssertionError(f"phase 17 (c): history {same_hist}, global {same}, blocks {blocks}")


def phase_slice20(mods, nz):
    """Phase 17 (module docstring).  Returns each kernel's launches over the
    phase, summed over its processes."""
    import tempfile

    walls = {}
    t0 = time.perf_counter()
    threads = phase_slice20_threads(mods, nz)
    walls["a"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="fedml_slice20_") as root:
        t0 = time.perf_counter()
        procs = phase_slice20_procs(mods, nz, root)
        walls["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_slice20_web3()
    walls["c"] = time.perf_counter() - t0
    counts = {k: threads[k] + procs[k] for k in threads}
    print(f"slice 20: phase 17 {sum(walls.values()):.1f} s ("
          + ", ".join(f"({k}) {v:.1f} s" for k, v in walls.items())
          + f"); launches on (a) {threads}, (b) {procs}; over the phase {counts}")
    return counts


SLICE21_RANKS = 2  # one pair of rank processes for the whole phase
SLICE21_ROUNDS = 2  # (a) and (b)
SLICE21_TIMEOUT_S = 420.0  # each rank's wall-clock bound
# (b): 240 images over 2 silos (116 and 124), so each silo takes one local
# step of 128 a round and the trajectory stays where one ulp moves little
SLICE21_SILO_TRAIN = 240
SLICE21_SILOS = 2
# (a) and (b) hold the 2-process run to phase 3's f32 MESH-against-sp
# tolerance: rtol MESH_SP_RTOL / atol MESH_SP_ATOL, or ROUND_SPREADS times
# the one-process run's own move when one weight of its init moves by one
# ulp.  (a)'s first calls read 7.18e-05-7.59e-05 max abs, the rtol / atol
# form exceeded by up to 4.27e-05 on a small weight (the lane blocks of 32
# sum in another order; deterministic cuDNN changed nothing)
SLICE21_LLM_STEPS = 3  # (c) data:2 and the one-process trainer
SLICE21_LLM_BATCH, SLICE21_LLM_SEQ = 8, 80  # the FedLLM recipe's batch and sequence
SLICE21_LOSS_REL = 1e-4  # (c) data:2's f32 losses against the one-process trainer's
SLICE21_RING_TOL = 2e-5  # (c) ring attention against dense (the reference's tolerance)
SLICE21_STEP_REL = 1e-4  # (c) seq:2's logits and gradient against the dense step, of max |.|


def _slice21_flagship_cfg(rank, port):
    """(a): the flagship recipe under MULTIPROCESS, f32, fused, 2 rounds, the
    test at the last; ``rank`` None: the same in one process on MESH."""
    import fedml_tpu_torch

    cfg = fedml_tpu_torch.init(argv=["--cf", FLAGSHIP])
    cfg.compute_dtype, cfg.comm_round = "float32", SLICE21_ROUNDS
    cfg.frequency_of_the_test = SLICE21_ROUNDS
    cfg.extra["fused_blocks"] = True
    if rank is not None:
        cfg.backend_sim = "MULTIPROCESS"
        cfg.extra.update(coordinator_address=f"localhost:{port}",
                         num_processes=SLICE21_RANKS, process_id=rank)
    return fedml_tpu_torch.init(cfg)


def _slice21_silo_cfg(role, rank, tcp_base=0, run_id="slice21_silo", **extra):
    """(b): the flagship recipe as 2 silos over TCP, f32, fused, 240
    images, 2 rounds."""
    import fedml_tpu_torch

    cfg = fedml_tpu_torch.init(argv=["--cf", FLAGSHIP])
    cfg.training_type, cfg.role, cfg.rank = "cross_silo", role, rank
    cfg.backend = "TCP" if tcp_base else "INPROC"
    cfg.client_num_in_total = cfg.client_num_per_round = SLICE21_SILOS
    cfg.synthetic_train_size, cfg.comm_round = SLICE21_SILO_TRAIN, SLICE21_ROUNDS
    cfg.compute_dtype, cfg.frequency_of_the_test, cfg.run_id = "float32", 1, run_id
    cfg.extra.update(fused_blocks=True, tcp_base_port=tcp_base, **extra)
    return cfg


class _GatherTap:
    """Counts the bytes and host seconds of ``multihost.all_gather``."""

    def __init__(self):
        from fedml_tpu_torch.parallel import multihost

        self.module, self.inner = multihost, multihost.all_gather
        self.bytes, self.seconds = 0, 0.0

        def tapped(t, group=None):
            t0 = time.perf_counter()
            out = self.inner(t, group)
            self.seconds += time.perf_counter() - t0
            self.bytes += sum(o.numel() * o.element_size() for o in out)
            return out

        multihost.all_gather = tapped

    def close(self):
        self.module.all_gather = self.inner


def _slice21_rank_flagship(rank, port, mods):
    """A rank's (a): the 2-process flagship; rank 0 then runs the same from
    the same initial global in one process on MESH."""
    import copy
    import hashlib

    import numpy as np
    import torch

    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.parallel import multihost
    from fedml_tpu_torch.runner import FedMLRunner
    from fedml_tpu_torch.sim.engine import MeshSimulator

    t0 = time.perf_counter()
    cfg = _slice21_flagship_cfg(rank, port)
    runner = FedMLRunner(cfg)
    sim = runner.runner
    init = pt.tree_map(torch.clone, sim.global_vars)
    setup = time.perf_counter() - t0
    tap = _GatherTap()
    multihost.sync_global_devices("slice21 a")
    _reset_counts(mods)
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    history = runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    counts = _all_counts(mods)
    tap.close()
    flat = weights.flatten_reference(sim.global_vars)[0].cpu().numpy()
    rounds = []
    for m in history:
        own = _own_steps(sim, m["round"])
        rounds.append({"round_time_s": m["round_time_s"], "lane_steps": int(own.sum()),
                       "samples_per_s": int(own.sum()) * cfg.batch_size / m["round_time_s"],
                       "train_loss": m["train_loss"]})
    out = {"setup_s": setup, "wall_s": wall, "rounds": rounds,
           "test_acc": history[-1].get("test_acc"), "counts": counts,
           "gather_bytes": tap.bytes, "gather_s": tap.seconds,
           "lanes": int(len(sim.sampler.sample(0))), "batch": cfg.batch_size,
           "digest": hashlib.sha256(flat.tobytes()).hexdigest(),
           "finite": bool(np.isfinite(flat).all()), "peak_bytes": torch.cuda.max_memory_allocated()}
    if rank == 0:
        one_cfg = copy.copy(cfg)
        one_cfg.backend_sim = "MESH"

        def one_process(start):
            one = MeshSimulator(one_cfg, sim.dataset, sim.model)
            one.global_vars = start
            one.server_state = one.algorithm.init_server_state(start)
            one.run()
            torch.cuda.synchronize()
            return one.global_vars

        t1 = time.perf_counter()
        one = one_process(pt.tree_map(torch.clone, init))
        out["one_process_s"] = time.perf_counter() - t1
        worst, excess = _largest_difference(sim.global_vars, one)
        out["one_process_max_abs"], out["one_process_excess"] = worst, excess
        # the one-process run's own move when one weight of its init moves
        # by one ulp: the scale f32 ResNet-20 carries an ulp to
        k = init["params"]["Conv_0"]["kernel"].view(-1)
        k[0] = torch.nextafter(k[0], k[0] + 1)
        out["one_process_spread"] = _largest_difference(one_process(init), one)[0]
    multihost.sync_global_devices("slice21 a end")
    return out


def _slice21_rank_silo(rank, workdir, tcp_base, mods, planted=False):
    """A rank's (b): silo 1 spanning the pair (rank 0 the master over TCP,
    rank 1 its follower).  ``planted``: the control run, each rank's
    BatchNorm moments over its own half of the batch (the fault that the
    check must catch), on the next block of ports."""
    import contextlib
    import os

    import torch

    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.parallel import multihost
    from fedml_tpu_torch.runner import FedMLRunner

    tag = "planted" if planted else "silo"
    cfg = _slice21_silo_cfg("client", 1, tcp_base, run_id=f"slice21_{tag}")
    runner = FedMLRunner(cfg)
    group = runner.runner
    group.timeout = SLICE21_TIMEOUT_S
    global_stats = resnet.global_batch_stats
    if planted:  # each trainer (the follower's is built in run()) takes it
        resnet.global_batch_stats = lambda reduce_sum, world: contextlib.nullcontext()
    try:
        group.setup()
        multihost.sync_global_devices(f"slice21 b {tag}")
        if rank == 0:  # its listener is bound: the server may start
            with open(os.path.join(workdir, f"{tag}_ready"), "w") as f:
                f.write("1")
        _reset_counts(mods)
        t0 = time.perf_counter()
        runner.run()
        torch.cuda.synchronize()
    finally:
        resnet.global_batch_stats = global_stats
    return {"wall_s": time.perf_counter() - t0, "counts": _all_counts(mods),
            "follower": group.follower,
            "rounds": None if group.follower else group.clients[0].rounds_trained}


def _slice21_llm_cfg():
    import dataclasses

    import torch

    from fedml_tpu_torch.models.transformer import TransformerConfig

    return dataclasses.replace(TransformerConfig.llama_7b(), n_layers=FULL_WIDTH_LAYERS,
                               dtype=torch.float32, logits_dtype=torch.float32)


def _slice21_batches(vocab, n):
    import numpy as np

    rs = np.random.RandomState(21)
    out = []
    for _ in range(n):
        seq = rs.randint(0, vocab, (SLICE21_LLM_BATCH, SLICE21_LLM_SEQ + 1))
        out.append((seq[:, :-1], seq[:, 1:]))
    return out


def _rel_gap(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _slice21_rank_llm(rank):
    """A rank's (c): ``LLMTrainer`` at Llama-2-7B's widths (4 of 32 layers,
    f32) on ``data:2`` (3 steps; rank 0 then the one-process trainer on the
    same batches) and on ``seq:2`` (ring attention at the step's shapes
    against dense, then one step against the dense step)."""
    import gc

    import torch

    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.llm.train import LLMTrainArgs, LLMTrainer, _lm_loss_sum
    from fedml_tpu_torch.models.transformer import Transformer
    from fedml_tpu_torch.ops.attention import dense_attention
    from fedml_tpu_torch.ops.ring_attention import Ring, ring_attention
    from fedml_tpu_torch.parallel import mesh as meshlib
    from fedml_tpu_torch.parallel import multihost

    tcfg = _slice21_llm_cfg()
    args = LLMTrainArgs(learning_rate=1e-4, warmup_steps=1, total_steps=4,
                        batch_size=SLICE21_LLM_BATCH, seq_len=SLICE21_LLM_SEQ, seed=0)
    batches = _slice21_batches(tcfg.vocab_size, SLICE21_LLM_STEPS)
    tokens = SLICE21_LLM_BATCH * SLICE21_LLM_SEQ
    out = {}

    def steps(trainer):
        times, losses = [], []
        for t, y in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(trainer.step(t, y)["loss"])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return {"losses": losses, "step_s": times, "tokens_per_s": [tokens / s for s in times],
                "peak_bytes": torch.cuda.max_memory_allocated()}

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    fresh()
    trainer = LLMTrainer(tcfg, args, mesh=meshlib.make_mesh(("data",), (SLICE21_RANKS,)))
    out["data2"] = steps(trainer)
    out["data2"]["stored"] = sum(t.numel() for t in pt.tree_leaves(trainer.params))
    out["params"] = trainer.n_params()
    del trainer
    multihost.sync_global_devices("slice21 c data2")
    if rank == 0:
        fresh()
        single = LLMTrainer(tcfg, args, mesh=meshlib.make_mesh(("data",), (1,), devices=[0]))
        out["single"] = steps(single)
        del single
    multihost.sync_global_devices("slice21 c single")

    # ring attention at the step's attention shapes, forward and backward
    fresh()
    b, s, h, d = SLICE21_LLM_BATCH, SLICE21_LLM_SEQ, tcfg.n_heads, tcfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, go = (torch.randn((b, s, h, d), generator=g, device="cuda") for _ in range(4))
    half = slice(rank * s // 2, (rank + 1) * s // 2)
    ql, kl, vl = (x[:, half].clone().requires_grad_(True) for x in (q, k, v))
    ring = Ring(range(SLICE21_RANKS), rank)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o = ring_attention(ql, kl, vl, ring)
    o.backward(go[:, half])
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t0
    got = [multihost.all_gather(x.contiguous()) for x in (o.detach(), ql.grad, kl.grad, vl.grad)]
    if rank == 0:
        qd, kd, vd = (x.clone().requires_grad_(True) for x in (q, k, v))
        od = dense_attention(qd, kd, vd)
        od.backward(go)
        want = (od.detach(), qd.grad, kd.grad, vd.grad)
        out["ring_attention"] = {
            "s": ring_s,
            "max_abs": max(float((torch.cat(gs, 1) - w).abs().max()) for gs, w in zip(got, want)),
            "excess": max(float(((torch.cat(gs, 1) - w).abs()
                                 - SLICE21_RING_TOL * (1 + w.abs())).max())
                          for gs, w in zip(got, want))}
    del q, k, v, go, ql, kl, vl, o, got

    # one f32 step on seq:2, its logits and gradient against the dense step
    fresh()
    trainer = LLMTrainer(tcfg, args, mesh=meshlib.make_mesh(("seq",), (SLICE21_RANKS,)),
                         seq_axis="seq")
    t, y = batches[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads, logits = trainer.forward_backward(t, y)
    torch.cuda.synchronize()
    fb_s = time.perf_counter() - t0
    parts = multihost.all_gather(logits)
    seq2 = {"loss": float(loss)}
    if rank == 0:
        whole = trainer.whole_params()
        leaves = [p.detach().requires_grad_(True) for p in pt.tree_leaves(whole)]
        dense_logits = Transformer(tcfg, device="meta")(
            torch.as_tensor(t).cuda(), pt.tree_unflatten_like(whole, leaves))
        dense_loss = _lm_loss_sum(dense_logits, torch.as_tensor(y).cuda()) / tokens
        dense_grads = torch.autograd.grad(dense_loss, leaves)
        seq2.update(dense_loss=float(dense_loss.detach()),
                    logits_rel=_rel_gap(torch.cat(parts, 1), dense_logits.detach()),
                    grad_rel=max(_rel_gap(a, b) for a, b in zip(grads, dense_grads)))
        del whole, leaves, dense_logits, dense_grads
    del parts, logits
    multihost.sync_global_devices("slice21 c dense")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trainer._apply(grads)
    torch.cuda.synchronize()
    seq2["step_s"] = fb_s + time.perf_counter() - t1
    seq2["tokens_per_s"] = tokens / seq2["step_s"]
    seq2["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["seq2"] = seq2
    del trainer, grads
    multihost.sync_global_devices("slice21 c end")
    return out


def slice21_rank_main(rank, port, workdir, tcp_base) -> int:
    """One rank of phase 18 (started by ``phase_slice21`` as ``chip_smoke.py
    --slice21-rank``): (a), then its part of (b) and of (b)'s planted
    control, then (c); its results to
    ``rank_<rank>.json`` in ``workdir``."""
    import os

    import torch

    from fedml_tpu_torch.ops import fused_block as fb
    from fedml_tpu_torch.ops import quantize as qz
    from fedml_tpu_torch.parallel import multihost

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mods = (fb, qz)
    out = {"rank": rank, "pid": os.getpid(), "device_name": torch.cuda.get_device_name(0)}
    parts = (("a", lambda: _slice21_rank_flagship(rank, port, mods)),
             ("b", lambda: _slice21_rank_silo(rank, workdir, tcp_base, mods)),
             ("b_planted", lambda: _slice21_rank_silo(rank, workdir, tcp_base + SLICE21_SILOS
                                                      + 1, mods, planted=True)),
             ("c", lambda: _slice21_rank_llm(rank)))
    try:
        for name, run in parts:
            out[name] = run()
            print(f"slice21 rank {rank} ({name}): {json.dumps(out[name])}", flush=True)
    finally:
        multihost.shutdown()
    out["jax_loaded"] = "jax" in sys.modules
    out["fedml_tpu_loaded"] = any(m == "fedml_tpu" or m.startswith("fedml_tpu.")
                                  for m in sys.modules)
    path = os.path.join(workdir, f"rank_{rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)
    return 0


def _slice21_flat(cfg, dataset, model, init):
    """(b)'s flat run: the server and both silos as plain threads of this
    process over INPROC, from ``init``; the final global, flat."""
    import torch

    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.cross_silo import build_process_group, run_group

    server, clients = build_process_group(cfg, dataset, model, "cuda", "INPROC",
                                          global_vars=pt.tree_map(torch.clone, init))
    history = run_group(server, clients, SLICE21_TIMEOUT_S)
    return weights.flatten_reference(server.aggregator.global_vars)[0], history


def _slice21_spanning(workdir, tcp_base, procs, dataset, model, init, all_mods, tag="silo"):
    """(b)'s spanning run, this process's side: once the ranks' silo is up,
    the server and the plain silo 2 over TCP; the final global, flat."""
    import os

    import torch

    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.cross_silo import build_client, build_server, run_group

    deadline = time.perf_counter() + SLICE21_TIMEOUT_S
    while not os.path.exists(os.path.join(workdir, f"{tag}_ready")):
        if time.perf_counter() > deadline or any(p.poll() is not None for p in procs):
            raise AssertionError(f"phase 18 (b): the spanning silo ({tag}) never came up")
        time.sleep(0.2)
    run_id = f"slice21_{tag}"
    server = build_server(_slice21_silo_cfg("server", 0, tcp_base, run_id), dataset, model,
                          "cuda", backend="TCP", global_vars=pt.tree_map(torch.clone, init))
    silo2 = build_client(_slice21_silo_cfg("client", 2, tcp_base, run_id), dataset, model, 2,
                         "cuda", backend="TCP")
    _reset_counts(all_mods)
    t0 = time.perf_counter()
    history = run_group(server, [silo2], SLICE21_TIMEOUT_S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (weights.flatten_reference(server.aggregator.global_vars)[0], history, wall,
            _all_counts(all_mods))


def _slice21_unitedllm(all_mods):
    """(d): UnitedLLM under ``training_type: cross_cloud``, the server and 2
    LLM silos over loopback TCP, 2 rounds (the reference test's
    configuration)."""
    import math

    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.comm.message import Message
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.cross_silo import message_define as md
    from fedml_tpu_torch.models.transformer import Transformer, TransformerConfig
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = fedml_tpu_torch.init(Config(
        training_type="cross_cloud", role="server", backend="TCP", dataset="shakespeare",
        model="transformer", client_num_in_total=2, client_num_per_round=2, comm_round=2,
        epochs=1, batch_size=4, learning_rate=0.01, synthetic_train_size=128,
        synthetic_test_size=32, frequency_of_the_test=1, run_id="slice21_united",
        extra={"unitedllm": True, "lora_r": 2, "tcp_base_port": 0}))
    sizes, encode = [], Message.encode

    def spy(msg):
        blob = encode(msg)
        if msg.get(md.MSG_ARG_KEY_MODEL_PARAMS) is not None:
            sizes.append(len(blob))
        return blob

    Message.encode = spy
    try:
        t0 = time.perf_counter()
        runner = FedMLRunner(cfg)
        _reset_counts(all_mods)
        history = runner.run()
        wall = time.perf_counter() - t0
    finally:
        Message.encode = encode
    base = Transformer(TransformerConfig.tiny(vocab_size=runner.dataset.class_num),
                       device="meta")
    base_bytes = sum(t.numel() * 4 for t in pt.tree_leaves(base.variables()))
    losses = [h["test_loss"] for h in history]
    print(f"phase 18 (d): UnitedLLM, training_type {cfg.training_type!r} over loopback TCP, "
          f"{len(history)} rounds in {wall:.1f} s (set-up included); test losses {losses}; "
          f"{len(sizes)} model payloads of {min(sizes)}-{max(sizes)} bytes against the base's "
          f"{base_bytes} bytes (limit: half); launches {_all_counts(all_mods)}")
    if (len(history) != 2 or not all(math.isfinite(v) for v in losses)
            or losses[-1] > losses[0] + 1e-6 or len(sizes) < 8
            or max(sizes) >= base_bytes / 2):
        raise AssertionError(f"phase 18 (d): losses {losses}, payloads {sizes}, base "
                             f"{base_bytes}")
    return wall


def phase_slice21(mods, nz):
    """Phase 18: (b)'s flat runs here, then one pair of rank processes for
    (a)-(c) (this process serving (b)'s server and plain silo), then (d)."""
    import os
    import tempfile

    import torch

    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.cross_silo.async_soak import _free_port_block, _tail, soak_worker_env
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub

    all_mods = mods + (nz,)
    fb = mods[0]
    t_phase = time.perf_counter()
    # (b)'s flat runs first, with the card to themselves
    cfg = _slice21_silo_cfg("server", 0)
    dataset = loader.load(cfg)
    model = model_hub.create(cfg, dataset.class_num, input_shape=dataset.train_x.shape[1:])
    init = model.init(rng.generator(rng.init_key(rng.root_key(cfg.random_seed))), "cuda")
    t0 = time.perf_counter()
    flat, flat_hist = _slice21_flat(cfg, dataset, model, init)
    flat_s = time.perf_counter() - t0
    bumped = pt.tree_map(torch.clone, init)
    k = bumped["params"]["Conv_0"]["kernel"].view(-1)
    k[0] = torch.nextafter(k[0], k[0] + 1)
    spread = float((flat - _slice21_flat(cfg, dataset, model, bumped)[0]).abs().max())

    with tempfile.TemporaryDirectory(prefix="fedml_slice21_") as workdir:
        # (b) and its planted control, a block of ports each
        port, tcp_base = _free_port_block(1), _free_port_block(2 * (SLICE21_SILOS + 1))
        logs = [os.path.join(workdir, f"rank_{r}.log") for r in range(SLICE21_RANKS)]
        procs = []
        try:
            t_spawn = time.perf_counter()
            for r in range(SLICE21_RANKS):
                with open(logs[r], "wb") as lf:
                    procs.append(subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__), "--slice21-rank", str(r),
                         "--slice21-port", str(port), "--slice21-dir", workdir,
                         "--slice21-tcp-base", str(tcp_base)],
                        stdout=lf, stderr=subprocess.STDOUT, env=soak_worker_env(),
                        cwd=os.path.dirname(os.path.abspath(__file__))))
            span, span_hist, span_wall, server_counts = _slice21_spanning(
                workdir, tcp_base, procs, dataset, model, init, all_mods)
            planted = _slice21_spanning(workdir, tcp_base + SLICE21_SILOS + 1, procs, dataset,
                                        model, init, all_mods, tag="planted")[0]
            for p in procs:
                if p.wait(timeout=max(1.0, SLICE21_TIMEOUT_S - (time.perf_counter() - t_spawn))):
                    raise AssertionError(f"phase 18: a rank exited {p.returncode}")
            ranks_s = time.perf_counter() - t_spawn
            ranks = []
            for r in range(SLICE21_RANKS):
                with open(os.path.join(workdir, f"rank_{r}.json")) as f:
                    ranks.append(json.load(f))
        except BaseException:
            for r, log in enumerate(logs):
                print(f"--- rank {r} ---\n{_tail(log, 6000)}")
            raise
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10)
    del init, bumped

    # (a)
    a = [r["a"] for r in ranks]
    lane_names = [k.name for k in fb.LANE_KERNELS]
    for r in ranks:
        ra = r["a"]
        times = ", ".join(f"{x['round_time_s']:.3f} s ({x['samples_per_s']:.0f} trained "
                          f"samples/s)" for x in ra["rounds"])
        print(f"phase 18 (a) rank {r['rank']} (pid {r['pid']}, {r['device_name']}, jax imported: "
              f"{r['jax_loaded']}): {ra['lanes'] // SLICE21_RANKS} of {ra['lanes']} lanes, "
              f"set-up {ra['setup_s']:.1f} s, rounds {times}; all-gather {ra['gather_bytes']} "
              f"bytes in {ra['gather_s']:.3f} s; test_acc {ra['test_acc']:.4f}; peak "
              f"{ra['peak_bytes'] / 2**30:.3f} GiB; launches {ra['counts']}")
    one = a[0]
    same = "bitwise equal" if a[0]["digest"] == a[1]["digest"] else "DIFFERENT"
    print(f"phase 18 (a): both ranks' globals {same}; against the one-process MESH run of "
          f"the same {one['lanes']} lanes ({one['one_process_s']:.3f} s for {SLICE21_ROUNDS} "
          f"rounds): max abs {one['one_process_max_abs']:.3g} (rtol {MESH_SP_RTOL:g} / atol "
          f"{MESH_SP_ATOL:g}: excess {one['one_process_excess']:.3g}; the one-process run's "
          f"own one-ulp spread {one['one_process_spread']:.3g}, limit {ROUND_SPREADS} x)")
    bad = [(r["rank"], n) for r in ranks for n in lane_names if r["a"]["counts"].get(n, 0) == 0]
    if (a[0]["digest"] != a[1]["digest"] or not all(x["finite"] for x in a)
            or (one["one_process_excess"] > 0
                and not one["one_process_max_abs"] <= ROUND_SPREADS * one["one_process_spread"])
            or bad or any(r["jax_loaded"] or r["fedml_tpu_loaded"] for r in ranks)):
        raise AssertionError(f"phase 18 (a): digests {[x['digest'] for x in a]}, max abs "
                             f"{one['one_process_max_abs']} beyond phase 3's tolerance, lane "
                             f"kernels missing {bad}")

    # (b): phase 3's rule, which the planted per-rank moments must break
    def beyond(got):
        gap = float((got - flat).abs().max())
        excess = float(((got - flat).abs() - MESH_SP_ATOL - MESH_SP_RTOL * flat.abs()).max())
        return gap, excess, excess > 0 and gap > ROUND_SPREADS * spread

    gap, gap_excess, failed = beyond(span)
    planted_gap, planted_excess, caught = beyond(planted)
    b = [r["b"] for r in ranks]
    round_times = ", ".join(f"{h['round_time_s']:.3f}" for h in span_hist)
    print(f"phase 18 (b): silo 1 spanning 2 ranks (rank 0 trained {b[0]['rounds']} rounds, "
          f"rank 1 a follower: {b[1]['follower']}) beside plain silo 2, {SLICE21_ROUNDS} rounds "
          f"of one local step in {span_wall:.3f} s (round times {round_times} s); flat run "
          f"{flat_s:.1f} s; final global against the flat run: max abs {gap:.3g} (rtol "
          f"{MESH_SP_RTOL:g} / atol {MESH_SP_ATOL:g}: excess {gap_excess:.3g}; the flat run's "
          f"own one-ulp spread {spread:.3g}, limit {ROUND_SPREADS} x); planted per-rank "
          f"BatchNorm moments: max abs {planted_gap:.3g} (excess {planted_excess:.3g}), "
          f"caught: {caught}; test_acc {span_hist[-1]['test_acc']:.4f} against "
          f"{flat_hist[-1]['test_acc']:.4f}; launches: server and silo 2 {server_counts}, "
          f"ranks {[x['counts'] for x in b]}")
    bad = [(r["rank"], k.name) for r in ranks for k in fb.KERNELS
           if r["b"]["counts"].get(k.name, 0) == 0]
    if (b[0]["rounds"] != SLICE21_ROUNDS or not b[1]["follower"] or bad
            or not math.isfinite(gap) or failed or not caught):
        raise AssertionError(f"phase 18 (b): rounds {b[0]['rounds']}, kernels missing {bad}, "
                             f"gap {gap} against spread {spread}, planted fault caught: "
                             f"{caught} (gap {planted_gap})")

    # (c)
    c0, c1 = ranks[0]["c"], ranks[1]["c"]
    single = c0["single"]
    for name, res in (("data:2 rank 0", c0["data2"]), ("data:2 rank 1", c1["data2"]),
                      ("one process", single)):
        print(f"phase 18 (c) {name}: steps "
              f"{', '.join(f'{t * 1e3:.1f}' for t in res['step_s'])} ms, "
              f"{', '.join(f'{x:.0f}' for x in res['tokens_per_s'])} tokens/s, losses "
              f"{res['losses']}, peak {res['peak_bytes'] / 2**30:.3f} GiB"
              + (f", {res['stored']} of {c0['params']} f32 parameters stored" if "stored" in res
                 else ""))
    ra = c0["ring_attention"]
    print(f"phase 18 (c) ring attention over 2 ranks at ({SLICE21_LLM_BATCH}, {SLICE21_LLM_SEQ}, "
          f"32, 128) f32, forward and backward in {ra['s'] * 1e3:.1f} ms: max abs against dense "
          f"{ra['max_abs']:.3g} (tolerance {SLICE21_RING_TOL:g}); seq:2 one f32 step "
          f"{c0['seq2']['step_s'] * 1e3:.1f} ms ({c0['seq2']['tokens_per_s']:.0f} tokens/s), "
          f"loss {c0['seq2']['loss']:.6f} against dense {c0['seq2']['dense_loss']:.6f}, logits "
          f"{c0['seq2']['logits_rel']:.3g} and gradient {c0['seq2']['grad_rel']:.3g} of max "
          f"|.| from the dense step (limit {SLICE21_STEP_REL:g}), peak "
          f"{c0['seq2']['peak_bytes'] / 2**30:.3f} GiB")
    loss_gap = max(abs(x - y) / abs(y) for r in (c0, c1)
                   for x, y in zip(r["data2"]["losses"], single["losses"]))
    if (loss_gap > SLICE21_LOSS_REL or ra["excess"] > 0
            or c0["seq2"]["logits_rel"] > SLICE21_STEP_REL
            or c0["seq2"]["grad_rel"] > SLICE21_STEP_REL
            or abs(c0["seq2"]["loss"] - c0["seq2"]["dense_loss"]) > SLICE21_LOSS_REL * abs(
                c0["seq2"]["dense_loss"])
            or not all(math.isfinite(x) for x in single["losses"])):
        raise AssertionError(f"phase 18 (c): loss gap {loss_gap}, ring {ra}, seq2 {c0['seq2']}")

    # (d)
    united_s = _slice21_unitedllm(all_mods)
    counts = {k: server_counts[k] + sum(r["a"]["counts"].get(k, 0) + r["b"]["counts"].get(k, 0)
                                         for r in ranks)
              for k in server_counts}
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s (the ranks {ranks_s:.1f} s, (d) "
          f"{united_s:.1f} s); launches summed over the processes of (a)-(b) {counts}")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after building and checking the kernels (phases 1-2)")
    ap.add_argument("--slice21-only", action="store_true",
                    help="build the kernels, run phase 18 alone and stop (prints neither "
                         "the kernels line nor the last line)")
    # phase 18's rank processes (started by the script itself)
    ap.add_argument("--slice21-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--slice21-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--slice21-dir", help=argparse.SUPPRESS)
    ap.add_argument("--slice21-tcp-base", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.slice21_rank is not None:
        return slice21_rank_main(args.slice21_rank, args.slice21_port, args.slice21_dir,
                                 args.slice21_tcp_base)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from fedml_tpu_torch.ops import build
    from fedml_tpu_torch.ops import fused_block as fb
    from fedml_tpu_torch.ops import noise as nz
    from fedml_tpu_torch.ops import quantize as qz

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    report = build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {sorted(report) or 'nothing (cached)'}")
    for name, rec in report.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {name}: {line.strip()}")

    mods = (fb, qz)
    walls = {}
    if args.slice21_only:
        phase_slice21(mods, nz)
        return 0

    def timed(name, fn, *a):
        """Run a phase from a freed allocator; keep its wall time."""
        _phase_start()
        t0 = time.perf_counter()
        out = fn(*a)
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
        return out

    kernel_rows = {**phase_kernels(fb), **phase_lane_kernels(fb), **phase_quantize(qz),
                   **phase_lane_quantize(qz), **phase_noise(nz)}
    phase_fedopt_shapes(fb)
    phase_model_check(fb)
    phase_fedsgd_check()
    walls["1-2"] = time.perf_counter() - t_start
    if args.kernels_only:
        return 0
    fedavg_counts, flagship = timed("3", phase_main_path, mods)
    timed("3", phase_fused_ab, flagship)
    timed("3", phase_mesh_vs_sp, flagship)
    fedsgd_counts, fedsgd_sp_counts = timed("4", phase_fedsgd, mods, qz)
    silo_counts, silo_data = timed("5", phase_cross_silo, mods, nz)
    wire_counts = timed("9", phase_wire, mods, qz, nz, silo_data)
    del silo_data
    fedopt_data = timed("6", phase_fedopt, mods)
    timed("6", phase_family, mods, fedopt_data)
    timed("6", phase_scaffold_step, fedopt_data)
    timed("6", phase_client_adam, mods, fedopt_data)
    timed("6", phase_lr_recipes)
    hier_counts, dataset = timed("7", phase_hierarchical, mods)
    del dataset
    myavg_counts = timed("7", phase_myavg, mods)
    lsa_counts = timed("7", phase_lightsecagg, mods + (nz,))
    print(f"launches on slice 10's paths (none of the seven kernels runs there): "
          f"hierarchical {hier_counts}, myavg {myavg_counts}, lightsecagg {lsa_counts}")
    fedllm_counts = timed("8", phase_fedllm, mods + (nz,))
    full_counts = timed("8", phase_fedllm_full, mods + (nz,))
    resume_counts = timed("8", phase_resume, mods + (nz,), flagship)
    trust_counts = timed("10", phase_trust, mods, nz, flagship)
    slice15_counts, ta_length = timed("12", phase_slice15, mods, nz, flagship, fedopt_data)
    del flagship, fedopt_data
    slice16_counts = timed("13", phase_slice16, mods + (nz,))
    slice17_counts = timed("14", phase_slice17, mods, nz)
    slice18_counts = timed("15", phase_slice18, mods, nz)
    slice19_counts = timed("16", phase_slice19, mods, nz)
    slice20_counts = timed("17", phase_slice20, mods, nz)
    slice21_counts = timed("18", phase_slice21, mods, nz)
    zoo_counts, femnist_rows = timed("11", phase_zoo, mods + (nz,), qz)
    print(f"launches on the FedLLM paths (none of the seven kernels runs there): recipe "
          f"{fedllm_counts}, full width {full_counts}, resume {resume_counts}")
    # each kernel's launches on its own path: the lane-batched kernels on
    # the MESH rounds, the single-lane fused kernels on the cross-silo
    # silos, the single-lane quantize kernels on the FedSGD sp round
    counts = {**{k.name: fedavg_counts[k.name] for k in fb.LANE_KERNELS},
              **{k.name: silo_counts[k.name] for k in fb.KERNELS},
              **{k.name: fedsgd_counts[k.name] for k in qz.LANE_KERNELS},
              **{k.name: fedsgd_sp_counts[k.name] for k in qz.KERNELS},
              **{k.name: silo_counts[k.name] for k in nz.KERNELS}}

    # and each kernel's launches on phase 9's compressed uploads: (a) qsgd8
    # (rows 5-6 and the fused silo kernels), (c) SecAgg qsgd8 (row 7)
    wire = {k: wire_counts["a"][k] + (wire_counts["c"][k] if k == nz.NOISE.name else 0)
            for k in wire_counts["a"]}
    print("chip_smoke phases: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall, kernels' build included")
    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": m.SOURCE, "replaces": k.replaces,
         "launches": counts[k.name], "wire_launches": wire[k.name],
         "trust_launches": trust_counts.get(k.name, 0),
         "zoo_launches": zoo_counts.get(k.name, 0),
         "slice15_launches": slice15_counts.get(k.name, 0),
         "slice16_launches": slice16_counts.get(k.name, 0),
         "slice17_launches": slice17_counts.get(k.name, 0),
         "slice18_launches": slice18_counts.get(k.name, 0),
         "slice19_launches": slice19_counts.get(k.name, 0),
         "slice20_launches": slice20_counts.get(k.name, 0),
         "slice21_launches": slice21_counts.get(k.name, 0),
         "max_abs_err": kernel_rows[k.name]["max_abs_err"],
         "ms": kernel_rows[k.name]["ms"], "plain_ms": kernel_rows[k.name]["plain_ms"],
         "bound_ms": kernel_rows[k.name]["bound_ms"], "bound_by": kernel_rows[k.name]["bound_by"],
         "library_ms": kernel_rows[k.name].get("library_ms"),
         **({"stream_ms": kernel_rows[k.name]["stream_ms"]}
            if "stream_ms" in kernel_rows[k.name] else {}),
         **({"ldp_length": kernel_rows[k.name]["ldp_length"]}
            if "ldp_length" in kernel_rows[k.name] else {}),
         **({"ta_length": {**kernel_rows[k.name]["ta_length"], "path_max": ta_length}}
            if "ta_length" in kernel_rows[k.name] else {}),
         **({"zoo_length": FEMNIST_GRAD_LENGTH,
             **{f"zoo_{key}": femnist_rows[k.name][key]
                for key in ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")}}
            if k.name in femnist_rows else {})}
        for m in (fb, qz, nz) for k in m.KERNELS + getattr(m, "LANE_KERNELS", ())]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
