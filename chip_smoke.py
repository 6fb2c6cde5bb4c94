#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`horovod_tpu_torch`): the quickest
proof that the port builds, is right, serves and trains on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the result line):

1. toolchain — the card's name and power limit (``nvidia-smi``), torch,
   CUDA, ``nvcc`` versions and whether Triton imports;
2. build — every CUDA kernel of the serving and training paths from
   ``horovod_tpu_torch/ops/csrc`` with ``nvcc`` for ``sm_90a`` (one ``nvcc``
   per source, all started together), with each kernel's registers, shared
   memory and spills (``ptxas -v``);
3. kernels against their plain PyTorch versions on the card: B1 (forward)
   and B2/B3 (backward) in every mask case, GQA, head dims 40-256, f32,
   bf16 and fp16, with an lse cotangent, the model's strided V view, a
   head dim of stride 2 (made contiguous), a ragged T and the serving
   shape; D = 320 takes the dense plain path. Each case names the route
   B1, B2 and B3 took: ``tc`` (the tensor-core kernels, bf16 with D a
   multiple of 8 up to 128) or ``simt`` (the CUDA-core kernels, f32, fp16
   or D > 128). B1's times at the serving shapes, and B1/B2/B3's at the
   training shape on both routes, beside their plain versions', SDPA's (a
   yardstick the port never calls) and the card's bound. The dropout
   kernel at the MNIST CNN's two sites in f32, bf16 and fp16, forward and
   backward, bit for bit against its plain version, and its time;
4. serving main path — a `TransformerLM` at the bench LM's full width
   (vocab 8192, d_model 512, 8 heads, 8 layers, bf16 compute, seeded
   weights) is exported as a streaming bundle (batch 8, prompt_len 128, 64
   new tokens, chunk 16, greedy) and served by ``make_server(...,
   continuous=True)`` → continuous-batching engine; 12 concurrent ragged
   requests (some streaming) must each get 64 tokens equal to the bundle
   run on that prompt alone, and the flash launch count must equal
   n_layers × prefill dispatches, every one on the tensor-core route;
5. serving against the plain path — one f32 prefill at 8 × 128 on the card
   (kernel) and on the CPU (plain version), logits compared;
6. training main path — ``Trainer.fit`` of the same LM with the fused-CE
   head (8 chunks) and ``DistributedOptimizer(adamw(scale_lr(3e-4)))`` for
   30 steps of 8 × 1024 ``copy_task`` rows (``fit(dataset=)``: one eager
   step, one capture, 29 graph replays): every loss finite, the last
   below the first, B1/B2/B3 each launched n_layers × (eager steps +
   captures) times by their wrappers, every time on the tensor-core
   route; a ``train`` line (tokens/s, step ms, peak memory) and a
   ``breakdown_train`` line (replayed steps and one eager step under
   `torch.profiler`);
7. training against the plain path — one f32 AdamW step at 2 × 256 on the
   card (kernels) and on the CPU (plain versions): loss, gradients and
   updated parameters compared, all on the CUDA-core route; the card's
   step again with remat (B1 launched twice per layer, the same loss and
   gradients, bit for bit); AdamW's capturable form against its float-lr
   form on the card's gradients, within one f32 ulp;
8. ``mnist_tf2`` — the twin of the TF2 MNIST script
   (``horovod_tpu_torch.examples.tf2_style_mnist``: Adam(0.001 × size),
   warmup, rank-0 checkpoints and scalar log) under ``python -m
   horovod_tpu_torch.launch run --nprocs 1``: a world of one NCCL rank, so
   the gradient averaging is a real NCCL all-reduce; 500 steps × 24 epochs
   at 128 unless cut. The loss must fall and every epoch's checkpoint be
   intact; images/s, warmup scales and peak memory are printed;
9. ``mnist_tf1`` — the twin of the TF1 MNIST script (Adadelta(1.0 × size),
   per-epoch validation, final evaluate, save/reload, serving export) at
   ``--nprocs 1``, 12 epochs on 60k/10k unless cut (``MNIST_TF1_CUT``: 2).
   It fails unless the mean of the
   ``loss`` records in ``metrics.jsonl`` lies in [0, 0.3] (the CI gate); a
   resume from the newest checkpoint restores the script's final training
   state bit for bit (its state digest) and evaluates to the script's test
   loss within 1e-6; and the exported bundle holds those parameters bit for
   bit and computes ``Trainer.predict``'s probabilities within 1e-6
   absolute and 1e-5 relative (every entry above 1e-30) on test images and
   on blends of two, where the trained model is not saturated.
   val_accuracy per epoch and the epoch and seconds at which it first
   reaches 98 % are printed;
10. ``mnist_2rank`` — the TF2 twin at ``--nprocs 2`` (run beside 12b-d:
   all four are checks), both ranks on the one
   card over gloo, named with ``HVT_BACKEND=gloo`` (an H100 cannot host two
   NCCL ranks, so without it ``init`` refuses): a correctness
   check, not a speed. It fails unless the two ranks' parameters and
   optimizer state are bit-identical after ``fit`` (an allgathered
   digest), only rank 0 wrote checkpoints, ``events.jsonl`` and
   ``metrics.jsonl``, and the loss falls; then a ``breakdown_mnist`` line:
   where a phase-8 step's time goes (loader; the fit's replayed steps and
   eager steps: host ms, device busy share, launches, top kernels),
   measured in this process at one NCCL rank;
11. ``mnist_ci_cached`` — the reference CI job's configuration
   (``launch/jobs/mnist-ci.yaml``): the tf1 twin under the launcher at one
   NCCL rank with ``HVT_DEVICE_CACHE=1`` (``fit(cache="device")``: the
   data staged on the card, each step a replay of one captured CUDA
   graph), uncut at 12 epochs × 468 steps. It fails unless the CI mean
   loss lies in [0, 0.3], 98 % val_accuracy is reached (the epoch is
   printed), the last epoch's cached validation equals the script's
   uncached evaluate, and, in this process from the run's newest
   checkpoint, ``evaluate(cache="device")`` equals ``evaluate()``; then
   the same 20 cached steps run once as graph replays and once as eager
   steps from the same state — fresh weights, and resumed from that
   checkpoint — and must end bit-identical (parameters and optimizer
   state); a ``breakdown_mnist_cached`` line (host ms a step, device busy
   ms and share, launches and graph replays a step, the dropout kernel's
   ms a step, peak memory); and ``steps_per_execution``: tf2's configuration for one cut
   epoch at K = 4 and K = 1, on its ``dataset=`` feed and on ``x=``/``y=``,
   whose losses at every chunk end must be equal bit for bit;
12. the CIFAR-10 path (BASELINE.json config 4), no Pallas kernel on it:
   a. ``cifar_resnet`` — the twin of ``examples/cifar10_resnet.py``
      (``horovod_tpu_torch.examples.cifar10_resnet``: bf16 ResNet-20 with
      global-batch BatchNorm, Adam(0.001 × size), warmup, rank-0
      checkpoints) at one NCCL rank, 390 steps × 24 epochs at 128 unless
      cut (``CIFAR_CUT``: 6 epochs). The loss must fall, the checkpoints be intact and
      test accuracy reach 0.45 (the synthetic set's ceiling is ~0.5:
      classes c and c + 5 are one distribution); images/s (median, min,
      max), step ms, peak memory, the epoch losses and test accuracy; then
      a ``breakdown_cifar`` line from one profiled window of replays in a
      launched process (host ms a step, device busy share, kernels and
      graph launches a step, the NCCL kernels' share);
   b. ``cifar_graph_vs_eager`` — in a launched process, 10 steps of
      ``fit`` (one eager step, one capture, replays) against 10
      ``Trainer.train_step`` calls from the same state: parameters,
      optimizer state and BN running statistics bit-identical (with
      ``--ranks N`` also at N NCCL ranks, where the captured step holds
      the BN all-reduces);
   c. ``sync_bn`` — two gloo ranks sharing the card at 4 rows each
      against one rank at 8, an f32 depth-8 ResNet for 4 SGD steps (the
      configuration of ``tests/test_torch_sync_bn.py``): parameters and
      running statistics within its 2e-6; the ranks' runners step eagerly
      (counted), since a gloo BN all-reduce cannot sit inside a graph;
   d. ``cifar_vit`` — ``ARCH=vit`` (patch 4, d 256, 8 heads, 6 layers,
      bf16), 2 × 100 steps: images/s and the loss falling;
   (b and c, checks with no timing read, share the card at once);
13. the decode family of ``examples/lm_generate.py`` at the bench LM's
   width (bf16, seeded random weights, batch 8 × prompt 128):
   a. greedy and sampled ``make_generate_fn``, 64 new tokens: the captured
      steps (one CUDA graph replayed a token) equal the same steps run
      eagerly bit for bit; tokens/s, host launches, device kernels and
      graph replays a token, and the device's busy share, eager and
      captured (``decode_generate`` lines);
   b. speculative greedy (γ 8, prompt lookup): tokens equal plain greedy's
      bit for bit, full and ragged; rounds and tokens a round;
   c. beam search (width 4, length penalty 0.6): captured against eager,
      tokens and scores bit for bit; the best beams' scores;
   d. int8: ``int8_dot_general`` (``torch._int_mm``) on the prefill's
      activations of every Dense and the LM head, the weights' lattice and
      dequantization, and the int8 cache's write and attention, each
      against its plain version on the CPU on the same int8 inputs
      (``INT8_BF16_RTOL``, ``INT8_CACHE_ATOL``); top-1 agreement of the
      quantized, int8-cache and int8-compute generators with bf16
      (information: the weights are random); the stored bytes;
   e. the ring cache (window 64 + 4 sinks, 256 new tokens): constant
      bytes, and every step's logits against the full cache under the same
      mask (f32, ``RING_LOGITS_ATOL``);
   f. a bundle with a byte-BPE tokenizer trained to 8192 ids and the int8
      cache served by ``make_server`` (continuous): text in, text and
      tokens out, equal
      to the bundle run alone; its speculative variant equals the plain
      int8-cache bundle;
   g. the twin ``horovod_tpu_torch.examples.lm_generate`` at its defaults
      (``STREAM=1``), which asserts speculative == greedy itself;
   and B1 at the ring's windowed prefill with sinks against its plain
   version, SDPA with the same boolean mask and the bound;
14. the serving tier at the bench LM's width (phase 4's shape, bf16,
   seeded weights), ``make_server``'s default coalescing mode unless
   named:
   a. 24 concurrent single-row ragged requests to a greedy one-shot
      bundle: each equal to the bundle run on its prompt alone, bit for
      bit; device calls well under 24; B1 launched n_layers × prefill
      dispatches, all on tc;
   b. a speculative bundle (γ 8) over HTTP: the 24 prompts in one request
      equal greedy's tokens;
   c. a predict bundle (a seeded f32 ``MnistCNN`` at batch 16): 64
      concurrent single-row clients, coalesced and serialized, each prob
      equal to the program on its row padded to the batch alone, bit for
      bit; requests/s and device calls of both;
   d. ``bench.py``'s A/B at equal open-loop offered load: 48 streaming
      requests at twice the coalescing path's solo rate, coalescing and
      continuous: TTFT and TPOT p50/p95, device calls (information);
   e. (a)'s ``/metrics``, parsed with ``obs.prom.parse_text``: the 200s
      and the TTFT count equal the requests sent, device calls equal
      ``app.stats``, no 500s;
   f. ``/admin/reload`` from the seed-0 bundle to the seed-1 bundle under
      four clients' traffic, coalescing and continuous: every reply 200
      and one bundle's solo tokens, every reply sent after the swap the
      new bundle's; the swap's seconds;
   g. the router (``serving.router``, in this process) over two launched
      replica processes (``python -m horovod_tpu_torch.launch.serve``) on
      the one card: requests spread, tokens equal solo, a drained replica
      gets none, ``code="500"`` reads 0;
   h. SIGTERM to each replica with requests in flight: every one ends 200
      with its solo tokens and the process exits 0;
   then a ``serve_tier`` line (each replica's log is under
   ``build/chip_smoke/``);
15. the sharded and quantized reduction (no new kernel: the quantization
   and sums are plain torch ops on the card), one launch of two gloo ranks
   sharing the card for (a) and (b):
   a. ``quantized_group_sum`` (int8, fp8) on CUDA tensors against the same
      call on the CPU within one f32 ulp of the sum, the error-mass
      identity on the card's tensors, and ``reduce_gradients(scatter=2)``
      against the dense reduction cut locally, bit for bit, on the f32 and
      bf16 wires (``phase15a``);
   b. the bench LM at full width (phase 6's data, 4 × 1024 rows a rank,
      K = 2, ``fit(dataset=)`` with graph replays, 8 steps) from one
      seed: (i) f32 replicated, (ii) int8 replicated, (iii) int8 ZeRO-1
      with the overlap on and off, (iv) fp8 ZeRO-1. (iii) must equal (ii)
      bit for bit (parameters, gathered optimizer state, residual rows),
      every quantized loss stay within ``REDUCTION_LOSS_RTOL`` of (i)'s,
      every loss be finite and the last below the first, the ranks end
      equal, and B1/B2/B3 launch n_layers × K × (eager steps + captures)
      times, all on tc; a ``phase15b`` line a run: step ms, wire bytes a
      step, optimizer-state and residual bytes a rank, peak memory, the
      card;
   c. the tf2 twin with ``HVT_COMPRESSION=int8`` at one NCCL rank and at
      two gloo ranks (``TWIN_INT8_CUT``): the loss falls, every checkpoint
      is intact and holds a residual row per rank, and a relaunch resumed
      from the next-to-last checkpoint retrains the last epoch with the
      same loss at every step, bit for bit, and ends in the same state
      (``phase15c``);
16. the launch layer (no kernel of its own; the training it launches runs
   on the card), each part a ``phase16`` line with its wall seconds and
   the card:
   a. phase 11's CI job went through ``python -m horovod_tpu_torch.launch
      job`` on a copy of the port's ``launch/jobs/mnist-ci.yaml`` (paths
      under ``build/chip_smoke/``): its exit code 0 is the loss gate, and
      ``gate --check loss=0.0..0.0001`` on the same metrics must exit 1;
   b. the tf2 twin at phase 10's cut under ``run --nprocs 1 --max-restarts
      2 --backoff 0.5 --status-port 0`` with ``HVT_FAULT=0:1:exit1`` and a
      stamp: ``/healthz``, ``/status`` and ``/metrics`` scraped once while
      it runs; exactly one ``crash`` restart with progress in the journal
      (``gate --check restarts=1..1 --aggregate count`` exits 0); the
      relaunch resumes from epoch 1's checkpoint and ends in a clean run's
      state bit for bit; ``metrics.prom`` reads ``hvt_restarts_total 1``;
      the fault-to-relaunch seconds;
   c. (b) with ``HVT_FAULT=0:1:hang`` and ``--heartbeat-timeout 15``: a
      ``hang`` restart, the same resume and state, the detection latency;
   d. ``pod --hosts 127.0.0.1,localhost`` through a PATH-shimmed ``ssh``
      (``tests/test_launch.py``'s shim), ``HVT_BACKEND=gloo``: a world of
      two ranks sharing the card, their states equal (run beside the
      clean reference run of b and c);
17. MoE and expert parallelism (no new kernel: the JAX MoE layer runs
   none), each part a ``phase17*`` line with the card:
   a. the bench LM in bench.py's MoE mode (``MOE_MODEL``: ``moe_every=2``,
      8 experts, top-2, capacity 1.25, bf16) trains 30 steps at 8 × 1024:
      the loss falls, ``moe_drop_rate`` in every epoch log in [0, 1), B1-B3
      launch n_layers × (eager steps + captures) times on tc; step ms,
      tokens/s, peak memory, the replayed step's device time, one MoE
      layer's forward and backward as graph replays and its share; then 5
      steps with ``moe_router="expert_choice"`` (``moe_uncovered_rate``);
   b. one f32 step of a 2-layer MoE LM on the card against the CPU: loss,
      aux loss, drop rate and every gradient;
   c. (a)'s weights at capacity 4.0 in f32: 64 greedy tokens for 8
      prompts of 128 through the captured decode step, equal to the
      no-cache recompute but at counted near-ties;
   d. ``MeshSpec(data=1, expert=2)`` at two gloo ranks on the card against
      one rank (``MOE_CHILD``), f32, SGD: losses, expert shards,
      replicated parameters bit-equal, eager steps;
18. sequence parallelism and packed pretraining (no new kernel: the ring,
   Ulysses and packing are collectives and plain ops around B1-B3), each
   part a ``phase18*`` line with the card:
   a. the ring's hops at the twin's full-width shard [8, 1024, 4, 128]
      bf16 (tc): B1 on the causal diagonal, on a past block non-causal and
      at ``q_offset`` = 1024 under a window of 1536; B2/B3 with the lse
      cotangent the merge of two hops produces; each against its plain
      version at phase 3's tolerances, and timed beside its bound and SDPA
      with the same mask;
   b. the twin of ``examples/lm_packed_pretraining.py`` at the bench LM's
      width (vocab 8192, d_model 512, 8 layers, 4 heads of 128, seq 2048,
      bf16) on ``HVT_MESH="data=1,seq=2"``, two gloo ranks sharing the
      card, 3 epochs of 4 steps: the masked loss falls (``LEARNING``),
      the ranks' parameters are equal, B1-B3 launch n_layers × the hops
      a rank runs a step, all on tc; step ms, tokens/s, the ring's bytes a
      step, peak memory;
   c. a 2-layer f32 model at seq = 2 (two gloo ranks) against one rank on
      the card: logits, loss and every gradient for the flash ring,
      Ulysses and the ring with window + sinks, at phase 7's tolerances;
19. the encoder-decoder family and LoRA (no new kernel: the seq2seq
   sites are B1-B3 under new masks, LoRA's merge a plain product), each
   part a ``phase19*`` line with the card:
   a. the seq2seq masks in phases 3 and 4's case lists, forward and
      backward (with and without an lse cotangent), on both routes: the
      encoder's (non-causal, q = kv = padding ids with tails of several
      lengths), the cross site's (q ids 1, padded kv ids, Tq ≠ Tk) and
      tiles shorter than one 64-row tile (Tq 10 / Tk 12, bf16 D 64 and
      f32 D 24); B1, B2 and B3 at the bench's encoder and cross sites
      timed beside their plain versions, the bound for the pairs the ids
      keep, and SDPA with the boolean mask;
   b. bench.py's seq2seq (vocab 8192, d 512, 8 heads, 6 + 6 layers, 8 ×
      (1024 + 1024), bf16 compute and logits, AdamW) trained 30 steps by
      ``Trainer.fit`` on dict batches with the steps captured: the loss
      falls, each step that runs the wrappers launches B1, B2 and B3 18
      times (6 encoder, 6 decoder self, 6 cross sites), all on tc; step
      ms, target tokens/s, peak memory, the busy share of five profiled
      replays; a 2 + 2-layer f32 model against the CPU at phase 7's
      tolerances;
   c. greedy generation from (b)'s weights, 8 sources of 1024, 64 new
      tokens: 6 tc B1 launches (the encode), every step a replay, the
      tokens equal to the teacher-forced argmax on the card but at counted
      bf16 near-ties; tokens/s;
   d. the twin of ``examples/seq2seq_translation.py`` at its default knobs
      on the card (launched beside phase 16, a check): ``REVERSAL
      LEARNED`` and its accuracy;
   e. (in 18c's child) a 2 + 2-layer f32 seq2seq at seq = 2 against one
      rank: logits, loss and every gradient at phase 7's tolerances;
   f. ``LoRAModel`` (rank 8, alpha 16) around the bench LM with
      ``freeze_base(adamw)``, 30 captured steps at 8 × 1024: the base
      bit-equal at the end, every adapter moved, the loss falls, B1-B3 on
      tc; the merged model's logits against the wrapped forward's; the
      optimizer's state bytes against a full AdamW's; step ms beside phase
      6's;
20. tensor parallelism and FSDP (no new kernel: Megatron's f and g, the
   logits' and weights' gathers and FSDP's reduce-scatters are collectives
   and cuBLAS products around B1-B3), each part a ``phase20*`` line with
   the card:
   a. B1, B2 and B3 at a ``model=2`` rank's attention ([8, 1024, 4, 64]
      bf16 causal, tc) against their plain versions at phases 3/4's
      tolerances, timed beside the bound and SDPA; then a 2-layer f32
      model at the bench width with ``model=2`` emulated in this process
      (two models holding one rank's cut each, the row-parallel partial
      products summed here) against the unsharded model;
   b. the bench LM (bf16, fused-CE head, AdamW) at ``model=2``, two gloo
      ranks sharing the card, 4 eager steps of 8 × 1024: the losses within
      one bf16 ulp of one rank's from the same weights and batches, each
      parameter within a quarter of the one-rank update's norm, B1-B3
      launched 8 layers × 4 steps a rank, all tc, at 4 heads; the step ms
      (gloo staging, not speed);
   c. (b) at ``fsdp=2`` (4 rows a rank), beside (b): the same checks at 8
      heads, and the parameter and Adam bytes a rank against one rank's
      (about half);
   (b and c, checks with no timing read, are launched beside 12b-d and
   joined here);
21. the pipeline (no new kernel: the handoffs are point-to-point sends
   and the output and input-cotangent broadcasts collectives around
   B1-B3), each part a ``phase21*`` line with the card:
   a. B1, B2 and B3 at a microbatch's attention ([2, 1024, 8, 64] bf16
      causal, tc) against their plain versions at phases 3/4's
      tolerances, timed beside the bound and SDPA,
      and, 21a+, with packed segment ids (two to four documents a row)
      and under a window of 256, and the ring's hops at a ``seq=2``
      microbatch's [2, 512, 8, 64] (the diagonal, a past block, a past
      block under the window), all tc, each against its plain version and
      timed beside its bound and SDPA with the boolean mask;
   b. the bench LM as a bf16 ``PipelinedLM`` at ``data=1,pipe=2``, two
      gloo ranks sharing the card (launched beside 12b-d, joined here),
      GPipe, 1F1B and the interleaved schedule in one launch, 4 eager
      steps of 8 × 1024 in 4 microbatches each: the first batch's
      gradient before any step within a tenth of the one-rank gradient's
      norm, leaf by leaf, the losses within one bf16 ulp of one rank's on
      the same batches and weights, each parameter within 0.06 of the
      one-rank update's norm, (L/S) × n_micro launches of each kernel a
      step a rank (1F1B: B1 twice that), all tc, the tick counts, each
      rank's peak memory by schedule;
   d. pp × sp: the same model with a window of 256 on packed rows
      (``data/packing.py``, ids carried in the input) at
      ``data=1,pipe=2,seq=2``, four gloo ranks sharing the card (launched
      beside 12b-d), 1F1B and GPipe, 3 eager steps each: (b)'s gates, B1-B3
      launched a layer a microbatch once on seq rank 0 and twice on rank
      1 (the ring's hops), all tc;
   e. the MoE pipeline at bench.py's MoE width (8 experts, top-2, capacity
      1.25, groups of 1024), every block MoE: at ``data=1,pipe=2`` under
      the three schedules in (b)'s launch, and at ``data=1,pipe=2,
      expert=2`` under 1F1B in (d)'s (in f32, on the CUDA-core route), 3
      eager steps each, against one rank running the same microbatches:
      (b)'s gates, and the first batch's load-balance loss and every drop
      rate within 1e-3 of one rank's;
22. the ``model`` and ``fsdp`` axes in MoE, int8, seq2seq and LoRA
   (``phase22*`` lines; the phase's comment block says what each holds);
23. MoE dispatch groups across data and sequence shards (no new kernel:
   the routing decisions gathered and the shares summed over the gradient
   group, around B1-B3), each part a ``phase23*`` line with the card, two
   gloo ranks sharing the card (launched beside 15a-b, joined here), each
   against one rank's steps:
   a. the bench MoE LM (bf16, fused-CE head, AdamW) at ``data=1,seq=2`` on
      the flash ring, 2 eager steps of 8 × 1024 (every dispatch group, a
      row, across both ranks): the losses within one bf16 ulp, the drop
      rates within 1e-3, B1-B3 launched 8 layers × hops × steps a rank,
      all tc, the parameters bit-equal, the routing bytes and collectives;
   b. the same model in f32 at ``data=2`` with ``[2, 768]`` a rank (JAX's
      middle group of 1 024 across the shards): 21e's gates on the first
      gradient, the aux loss, the drop rate, the losses and the updates;
      then one expert-choice step, its ``moe_uncovered_rate`` included;
24. the ``kernels`` JSON line (before it ``phase_seconds``,
   ``phase_cpu_seconds``, ``launch_cost``: each launch's wall and the CPU
   seconds of its processes, and ``host_cpu_seconds``), then the last
   line ``{"ok": true, "device": {...}}``.

Phase 9 reads the script's feed and fails unless ``fit(x=, y=)`` ran on
the native batch engine, as the JAX tf1 script does where g++ builds it.

The order on one card: phases 1-7 alone; 8's launch and 11's CI job
beside 9; 12b-d beside the launches of 20b-c, 21b, 21d and 22b-e; 13
and 14 alone; then the launched checks whose figures no gate times (16,
15c, 17d, 18b, 13g, 19d's twin and 23a-b) beside 15a-b and 17-23
(``checks_lane``). A figure taken beside others is that of a shared card
and host.

``python3 chip_smoke.py --ranks N`` (N cards) runs only phases 8, 9,
11's launch (the CI job at N ranks), 12a with its breakdown and 12b, 16d
as ``pod --hosts 127.0.0.1 --nprocs-per-host N`` on NCCL, and 15b's runs
(ii) and (iii), at N NCCL ranks, one card each, with the reference
budgets for N ranks: the multi-rank NCCL
path that one card cannot host (in phase 11 a captured cross-rank
all-reduce; in 12a and 12b the BN all-reduces too,
captured in each rank's step; in 15b the quantized wire's all-to-all and
all-gathers, ZeRO-1's parameter all-gather, one graph a step). At four
ranks 15b also runs the two-hop reduction (``HVT_DCN_FACTOR=2``) with the
int8 ici wire. The ranks must end bit-identical, running statistics
included, and 12b's replays equal to eager steps on every rank. 17e runs
``MeshSpec(data=2, expert=2)`` at four NCCL ranks (``--ranks 4``; alone
with ``--moe-only``): the bench MoE LM, captured steps, replicated
parameters bit-equal and each expert shard equal across its batch group,
tokens/s a card beside the dense LM's at four data ranks, and the
checkpoint written there restored at one rank with the full experts.
18d runs the twin at ``data=2,seq=2`` on four NCCL ranks (``--ranks 4``,
after 17e, whose dense LM at four data ranks it stands beside): each
step after the first a replay of one captured graph holding the ring's
sends and receives, the parameters bit-equal on every rank, tokens/s a
card. 20d (``--ranks 4`` last; alone with ``--tp-only``) trains the bench
LM at ``fsdp=2,model=2`` on four NCCL ranks, 30 steps, each after the
first a replay of one captured graph holding f, g, the weight gathers and
reduce-scatters: ms a step, tokens/s a card and the busy share of 5
profiled replays beside the dense LM on one card; the replicated
parameters bit-equal on every rank; then the twin of
``examples/lm_long_context.py`` at its defaults on ``HVT_MESH=
"seq=2,model=2"``, its recall report and greedy exact match printed.
21c (``--ranks 4`` after 20d; alone with ``--pp-only``) trains the
bench-width ``PipelinedLM`` at ``data=1,pipe=4`` on NCCL under each
schedule, 8 microbatches, eager steps (rank 0 says so in one line): ms
a step, tokens/s a card, and
each stage's busy share (its kernels but NCCL's, which spin while they
wait for the peer) and idle share over 5 profiled steps beside the tick
model's bubble (S − 1)/(v·T + S − 1); then the MoE pipeline at
``data=1,pipe=2,expert=2`` under 1F1B (ms a step, tokens/s a card, the
drop rates); then the twin at ``HVT_MESH="data=1,pipe=2,model=2"`` and at
``"data=1,pipe=2,seq=2"``, both with ``SCHEDULE=1f1b``, each printing its
recall report.
23c (``--ranks 4`` last; alone with ``--moe-grouping-only``) trains the
bench MoE LM at ``data=1,seq=2,expert=2`` on NCCL, captured steps, and
the twin with ``MOE_EVERY=2 N_EXPERTS=4`` at ``data=2,seq=2``, which must
print ``LEARNED``: ms a step, tokens/s a card, the busy share of 5
profiled replays, the routing bytes and collectives a step, and the MoE
layers' share of the device time.

Without CUDA, or without the package beside it, it exits non-zero and
prints no result. Everything it writes goes under ``build/chip_smoke/``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
WORK = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM data sheet (dense, without sparsity) — the bound's denominators.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Tolerances, kernel against its plain version on the same inputs. bf16:
# the two compute P·V in different orders and round P and O to 8 bits, so
# O may differ by about two bf16 ulps of its value; lse is f32 math on the
# same bf16 inputs. f32: summation order only.
TOL = {
    "bfloat16": {"o_atol": 2e-2, "o_rtol": 1e-2, "lse": 1e-3},
    "float32": {"o_atol": 1e-4, "o_rtol": 0.0, "lse": 1e-4},
}
# fp16 (the CUDA-core kernels) carries 3 more mantissa bits than bf16: the
# same two-ulp reasoning at 1/8 of bf16's limits.
TOL["float16"] = {"o_atol": 2.5e-3, "o_rtol": 1.25e-3, "lse": 1e-3}
# B2/B3 gradients against their plain versions: both sum the same f32
# products in different orders, and bf16 outputs are rounded once at the
# end, so a bf16 gradient may differ by one bf16 ulp (2^-8 of its value).
# atol is a share of the tensor's largest magnitude (near-zero entries).
GRAD_TOL = {
    "bfloat16": {"rtol": 1e-2, "atol_of_max": 1e-3},
    "float32": {"rtol": 0.0, "atol_of_max": 1e-5},
    "float16": {"rtol": 1.25e-3, "atol_of_max": 1.25e-4},  # bf16's / 8
}
# The training shape of the bench LM's attention: [B, T, H, D].
TRAIN_ATTN_SHAPE = (8, 1024, 8, 64)
# Phase 6: the bench's training shape (bench.py: batch 8 × seq 1024).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 30
# Phase 7: one f32 step, card vs CPU. cuBLAS and the CPU sum the same f32
# products in other orders: loss to 1e-5 abs (of ~9.5), each gradient to
# 2e-5 of its tensor's largest, each updated parameter to 1e-7 abs and one
# f32 ulp of its value (the card's AdamW is the capturable form) beyond
# what that gradient difference can move Adam's step (see train_vs_plain).
TRAIN_LOSS_ATOL, TRAIN_GRAD_REL, TRAIN_PARAM_ATOL = 1e-5, 2e-5, 1e-7
ADAM_EPS = 1e-8  # adamw()'s eps: the update's sensitivity near g = 0
# Phase 5: f32 logits of the whole 8-layer model, kernel vs plain path;
# matmul summation orders differ between cuBLAS and the CPU.
LOGITS_ATOL = 2e-3

MODEL = dict(vocab_size=8192, d_model=512, n_heads=8, n_layers=8,
             dropout=0.0)
BATCH, PROMPT_LEN, NEW_TOKENS, CHUNK = 8, 128, 64, 16
N_REQUESTS = 12
# Phases 8-10: the reference budgets (tf2: steps_per_epoch = 500 // size,
# 24 epochs at 128; tf1: ceil(12 / size) epochs over 60k at 128), each cut
# through the scripts' DRIVE_* knobs only where set here.
MNIST_BATCH = 128
# The full tf2 budget took 122 s on the H100 (24 epochs at ~3.2 s and
# ~45 s of process start, data synthesis and checkpoints), tf1's 80 s
# (val_accuracy 1.0 from its first epoch on the synthetic set). Cut to 2
# epochs each (tf1 from 3 since phase 23 joined), so that the
# whole smoke stays inside its time limit.
MNIST_TF2_CUT = {"DRIVE_EPOCHS": "2"}
MNIST_TF1_CUT = {"DRIVE_EPOCHS": "2"}
MNIST_2RANK_CUT = {"DRIVE_STEPS": "20", "DRIVE_EPOCHS": "3"}
CI_LOSS_GATE = (0.0, 0.3)  # launch/jobs/mnist-ci.yaml's loss range
# Phase 11 runs the port's CI job spec through `launch job` (16a).
CI_JOB_SPEC = "horovod_tpu_torch/launch/jobs/mnist-ci.yaml"
SERVE_ATOL = RESUME_ATOL = 1e-6
# The bundle against predict, entry by entry: the same f32 ops on the same
# card in the same batches, so any difference is rounding. The relative
# limit reaches the entries far below the top class, which an absolute one
# cannot see once the model is saturated (probabilities under 1e-30 are
# compared absolutely).
SERVE_RTOL, SERVE_REL_FLOOR = 1e-5, 1e-30
MNIST_TIMEOUT_S = 400
# Phase 11: cached against uncached evaluation of one state on the card.
# Both sum the same per-example f32 losses in f64; only the last batch
# differs (128 rows, 112 of them masked padding, against 16), which may
# round a row's logits differently in cuDNN/cuBLAS: held to 1e-6 abs on
# the mean loss, accuracy equal.
CACHED_EVAL_ATOL = 1e-6
# Phase 11's graph-against-eager run and steps_per_execution runs: cut.
GRAPH_VS_EAGER_STEPS, SPE_STEPS, SPE_K = 20, 100, 4
MNIST_STEPS_PER_EPOCH = 60000 // MNIST_BATCH
# Phase 12: BASELINE.json config 4, the CIFAR-10 twin — the reference
# budget (shard_steps(390) steps × 24 epochs at 128 a rank) unless cut here.
CIFAR_BATCH = 128
# Cut to 6 of 24 epochs for the smoke's time limit: the training accuracy
# is ~0.5 (the ceiling) from the first epoch, later epochs overfit.
CIFAR_CUT = {"DRIVE_EPOCHS": "6"}
CIFAR_TIMEOUT_S = 900
# The synthetic CIFAR stand-in makes class c and c + 5 one distribution
# (the reference's data, copied as it is): test accuracy tops out near 0.5,
# chance is 0.1. The gate sits just under the ceiling.
CIFAR_ACC_GATE = 0.45
# 12a's profiled window: steps 60-80 of one fit, in a launched process.
CIFAR_WINDOW_START, CIFAR_WINDOW = 60, 20
# 12b: replayed steps of fit against train_step, from one state.
CIFAR_GRAPH_VS_EAGER_STEPS = 10
# 12c: sync-BN on the card in tests/test_torch_sync_bn.py's configuration
# and tolerance — two gloo ranks at SYNC_BN_BATCH each against one rank at
# twice that, an f32 depth-8 ResNet on SYNC_BN_SIDE² images drawn from seed
# 0, SGD(0.1), SYNC_BN_STEPS steps, 2e-6 abs (TF32 off). (At 64 rows a rank
# of the CIFAR data, f32 summation order alone moves the parameters 6e-5
# apart in 4 steps of lr 0.1 on the CPU: a comparison of training chaos,
# not of the identity.)
SYNC_BN_BATCH, SYNC_BN_STEPS, SYNC_BN_SIDE, SYNC_BN_ATOL = 4, 4, 16, 2e-6
# 12d: the ViT branch (ARCH=vit) at the example's width, cut.
VIT_CUT = {"ARCH": "vit", "DRIVE_STEPS": "100", "DRIVE_EPOCHS": "2"}
# Phase 15: the sharded and quantized reduction. 15b trains the bench LM
# (MODEL, bf16, fused-CE head) at REDUCTION_RANKS gloo ranks sharing the
# card, REDUCTION_ROWS × TRAIN_SEQ rows a microbatch, REDUCTION_K
# microbatches a step, REDUCTION_STEPS steps (one eager, one capture,
# replays); step ms is the median of steps 3 .. REDUCTION_STEPS.
REDUCTION_RANKS, REDUCTION_ROWS, REDUCTION_K, REDUCTION_STEPS = 2, 4, 2, 8
# The quantized runs' losses against the f32 control's at every step,
# stated before the first run on the card: 1 % of the control's loss. The
# CPU tests' int8 and fp8 trajectories of a 2-layer LM stay within 0.04 %
# of f32 (tests/test_torch_zero1.py holds an MLP's within 2e-3 absolute);
# the bench LM's first steps move the loss ~10× more a step.
REDUCTION_LOSS_RTOL = 0.01
# 15a: the quantized sum on the card against the same call on the CPU,
# within one f32 ulp of the sum; the error-mass identity to 1e-6 of the
# inputs' largest magnitude.
REDUCTION_MASS_RTOL = 1e-6
# 15a: the optimizer's int8 reduction on the card against the CPU's, two
# steps of ~0.2 M delivered and residual elements: equal to four f32 ulps
# of the largest sum but for at most this many rounding flips, each
# within one quantum.
REDUCTION_EF_MAX_FLIPS = 16
# 15c: the tf2 twin on the int8 wire, cut: DRIVE_STEPS × DRIVE_EPOCHS, then
# the same launch resumed from epoch DRIVE_EPOCHS - 1's checkpoint.
TWIN_INT8_CUT = {"DRIVE_STEPS": "20", "DRIVE_EPOCHS": "3",
                 "HVT_COMPRESSION": "int8"}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


_LOG_LOCK = threading.Lock()


def log(*parts):
    """One whole line on stdout: threads that run checks beside the
    foreground log too, and their lines must not interleave."""
    line = " ".join(map(str, parts)) + "\n"
    with _LOG_LOCK:
        sys.stdout.write(line)
        sys.stdout.flush()


# -- phase 1 -----------------------------------------------------------------

def toolchain(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    from horovod_tpu_torch.ops import _build

    nvcc = _build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, timeout=60)
    check(ver.returncode == 0, f"{nvcc} --version failed: {ver.stderr}")
    try:
        import triton  # noqa: F401

        triton_ver = triton.__version__
    except ImportError:
        triton_ver = None
    info = {
        "card": card, "python": sys.version.split()[0],
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc": ver.stdout.strip().splitlines()[-1], "triton": triton_ver,
        "device_count": torch.cuda.device_count(),
    }
    log("toolchain", json.dumps(info))
    return card


# -- phase 2 -----------------------------------------------------------------

def build_kernels():
    """One nvcc per kernel source, all started together."""
    from horovod_tpu_torch.ops import _build

    names = ["flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90",
             "flash_fwd", "flash_bwd", "dropout"]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for name, fut in [(n, pool.submit(_build.library, n)) for n in names]:
            fut.result()
            log(f"build {name}: {_build.build_seconds[name]:.2f} s")
            kernel = None
            for line in _build.build_logs.get(name, "").splitlines():
                if "Compiling entry function" in line:
                    kernel = line.split("'")[1]
                elif "Used" in line or "spill" in line:
                    log(f"  ptxas {kernel}: {line.split(':', 1)[-1].strip()}")
    log(f"build all: {time.perf_counter() - t0:.2f} s")


# -- phase 3 -----------------------------------------------------------------

def device_ms(torch, fn, iters=50):
    """Device time of one ``fn()`` call: ``iters`` calls captured in a
    CUDA graph, replayed between CUDA events, so host launch overhead is
    not what is measured. Inputs stay warm in L2, as the model's prefill
    finds them right after its qkv projection."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):  # warm-up on the capture stream (autograd too)
            fn()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(iters):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(5):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


# Per kernel: (q-shaped tensors moved, kv-shaped tensors moved, f32 per-row
# statistics moved, matrix products over the kept (row, col) pairs).
# B1 reads q, k, v and writes O and lse: S = QKᵀ and O = PV. B2 reads q, dO,
# k, v, lse, delta and writes dQ: S, dP = dO Vᵀ, dQ = dS K. B3 reads q, dO,
# k, v, lse, delta and writes dK, dV: S, dP, dV = Pᵀ dO, dK = dSᵀ Q.
WORK_OF = {"flash_fwd": (2, 2, 1, 2), "flash_bwd_dq": (3, 2, 2, 3),
           "flash_bwd_dkv": (2, 4, 2, 4)}


def attention_bound_ms(b, tq, tk, h, hkv, d, dtype_name, *, causal,
                       q_offset=None, kernel="flash_fwd", window=None,
                       kept=None):
    """Least time for ``kernel``'s work on this card: the larger of (each
    input read once + each output written once) over HBM bandwidth and the
    products the masks keep over the peak rate of the dtype. ``kept``: the
    (row, key) pairs segment ids keep, summed over batch and heads (this
    run's data), in place of the causal/full count; the ids are read
    too."""
    n_q, n_kv, n_stat, n_prod = WORK_OF[kernel]
    item = 4 if dtype_name == "float32" else 2
    nbytes = (n_q * b * tq * h * d + n_kv * b * tk * hkv * d) * item \
        + n_stat * b * tq * h * 4
    if kept is not None:
        nbytes += 4 * b * (tq + tk)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_flops = 2.0 * n_prod * d * kept / PEAK_FLOPS[dtype_name] * 1e3
        return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                       else "operations")
    if causal:
        off = tk - tq if q_offset is None else q_offset
        lo = (lambda r: 0) if window is None else (
            lambda r: max(0, r + off - window + 1))
        visible = sum(max(0, min(tk, r + off + 1) - lo(r)) for r in range(tq))
    else:
        visible = tq * tk
    flops = 2.0 * n_prod * b * h * d * visible
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


def _segment_ids(torch, gen, b, tq):
    """Packed documents with random boundaries ``(q_ids, kv_ids)``; q rows
    of one extra id that no key carries are fully masked."""
    cuts = torch.sort(torch.randint(
        1, tq, (b, 6), generator=gen, device="cuda")).values
    ids = (torch.arange(tq, device="cuda")[None, :, None]
           >= cuts[:, None, :]).sum(-1).to(torch.int32)
    return (torch.where(torch.arange(tq, device="cuda") >= tq - 16, 99, ids),
            ids)


# Phase 19a: the seq2seq family's masks. Row i of a source keeps its
# first t − tail real (id 1) and pads the rest (id 0), the tail scaled from
# these lengths at T = 1024.
S2S_MASK_TAILS = (0, 100, 257, 511, 700, 1000, 1023, 64)


def _mask_ids(torch, kind, b, tq, tk):
    """``(q_ids, kv_ids)`` of a seq2seq site: ``"pad"`` the encoder's (q =
    kv = the source's padding ids; pad rows see each other, as in JAX),
    ``"cross"`` the cross-attention's (q ids the constant 1, kv ids the
    memory's padding)."""
    def valid(t):
        ids = torch.ones((b, t), dtype=torch.int32, device="cuda")
        for i in range(b):
            tail = min(S2S_MASK_TAILS[i % len(S2S_MASK_TAILS)] * t // 1024,
                       t - 1)
            if tail:
                ids[i, t - tail:] = 0
        return ids

    if kind == "pad":
        ids = valid(tq)
        return ids, ids
    return torch.ones((b, tq), dtype=torch.int32, device="cuda"), valid(tk)


def _qkv_inputs(torch, rand, b, tq, tk, h, hkv, d, dtype, layout):
    """q, k, v [B,T,H,D]: separate tensors, or (layout "qkv") the strided
    views of one fused projection [B, T, 3·H·D], as `TransformerLM` makes
    them (row stride 3·H·D), or (layout "strided") views whose head dim
    has stride 2, which the wrapper makes contiguous."""
    if layout == "strided":
        return (rand(b, tq, h, 2 * d, dtype=dtype)[..., ::2],
                rand(b, tk, hkv, 2 * d, dtype=dtype)[..., ::2],
                rand(b, tk, hkv, 2 * d, dtype=dtype)[..., ::2])
    if layout == "qkv":
        fused = rand(b, tq, 3 * h * d, dtype=dtype)
        return [x.view(b, tq, h, d) for x in fused.split(h * d, -1)]
    return (rand(b, tq, h, d, dtype=dtype), rand(b, tk, hkv, d, dtype=dtype),
            rand(b, tk, hkv, d, dtype=dtype))


def kernel_cases(torch):
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    # (name, B, Tq, Tk, H, Hkv, D, dtype, kwargs, segments)
    cases = [
        ("serving_prefill", 8, 128, 128, 8, 8, 64, bf16, {}, False),
        ("training_shape", 8, 1024, 1024, 8, 8, 64, bf16, {}, False),
        ("long_prompt", 1, 2048, 2048, 8, 8, 64, bf16, {}, False),
        ("window256_sinks4", 2, 1024, 1024, 8, 8, 64, bf16,
         {"window": 256, "sinks": 4}, False),
        ("packed_segments", 2, 512, 512, 8, 8, 64, bf16, {}, True),
        ("cross_length_q_offset", 2, 200, 700, 8, 8, 64, bf16,
         {"q_offset": 300}, False),
        ("fully_masked_rows", 2, 256, 256, 8, 8, 64, bf16,
         {"q_offset": -40}, False),
        ("gqa_noncausal", 2, 192, 320, 8, 2, 128, bf16,
         {"causal": False}, False),
        ("f32_window", 2, 384, 384, 8, 8, 64, f32, {"window": 100}, False),
        ("head_dim_256", 1, 100, 300, 4, 2, 256, bf16,
         {"window": 64, "sinks": 3}, False),
        ("head_dim_40_f32", 2, 77, 77, 4, 4, 40, f32, {}, False),
        ("strided_v_qkv_views", 2, 256, 256, 8, 8, 64, bf16, {}, "qkv"),
        ("ragged_t1000", 2, 1000, 1000, 8, 8, 64, bf16, {}, False),
        ("head_dim_40_bf16", 2, 77, 77, 4, 4, 40, bf16, {}, False),
        ("fp16_gqa", 2, 256, 256, 8, 2, 64, f16, {}, False),
        ("fp16_window_d128", 2, 300, 300, 4, 4, 128, f16, {"window": 64},
         False),
        ("strided_head_dim", 2, 256, 256, 8, 8, 64, bf16, {}, "strided"),
        # Phase 19a: the seq2seq sites' masks (non-causal, padding ids).
        ("encoder_padded", 8, 1024, 1024, 8, 8, 64, bf16,
         {"causal": False}, "pad"),
        ("encoder_padded_f32", 2, 300, 300, 4, 4, 64, f32,
         {"causal": False}, "pad"),
        ("cross_padded_q700_k1024", 2, 700, 1024, 8, 8, 64, bf16,
         {"causal": False}, "cross"),
        ("cross_padded_q1024_k700", 2, 1024, 700, 8, 8, 64, bf16,
         {"causal": False}, "cross"),
        ("cross_padded_f32", 2, 200, 300, 4, 4, 64, f32,
         {"causal": False}, "cross"),
        ("tiny_tiles_bf16_d64", 8, 10, 12, 4, 4, 64, bf16,
         {"causal": False}, "cross"),
        ("tiny_tiles_f32_d24", 8, 10, 12, 4, 4, 24, f32,
         {"causal": False}, "cross"),
        ("tiny_tiles_causal_f32_d24", 8, 10, 10, 4, 4, 24, f32, {}, False),
    ]
    results = {}
    with torch.inference_mode():
        for name, b, tq, tk, h, hkv, d, dt, kw, extra in cases:
            kw = {"causal": True, **kw}
            q, k, v = _qkv_inputs(torch, rand, b, tq, tk, h, hkv, d, dt,
                                  extra)
            if extra is True:
                kw["q_segment_ids"], kw["kv_segment_ids"] = _segment_ids(
                    torch, gen, b, tq)
            elif extra in ("pad", "cross"):
                kw["q_segment_ids"], kw["kv_segment_ids"] = _mask_ids(
                    torch, extra, b, tq, tk)
            route = fa._route(dt, d)
            tc0, n0, dense0 = fa.launches_tc, fa.launches, fa.launches_dense
            out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
            torch.cuda.synchronize()
            check(fa.launches_tc - tc0 == (route == "tc")
                  and fa.launches - n0 == 1 and fa.launches_dense == dense0,
                  f"{name}: B1 did not take the {route} route")
            ref_o, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
            tol = TOL[str(dt).removeprefix("torch.")]
            o_err = (out.float() - ref_o.float()).abs()
            o_ok = bool((o_err <= tol["o_atol"]
                         + tol["o_rtol"] * ref_o.float().abs()).all())
            lse_err = float((lse - ref_lse).abs().max())
            check(torch.isfinite(out.float()).all(), f"{name}: non-finite O")
            empty = ref_lse <= -1e29
            if bool(empty.any()):
                check(bool((out.float()[empty] == 0).all()),
                    f"{name}: a fully masked row has non-zero O")
                check(bool((lse[empty] == -1e30).all()),
                      f"{name}: a fully masked row has lse != -1e30")
            check(o_ok, f"{name}: O differs from the plain version "
                  f"(max abs {float(o_err.max()):.3g})")
            check(lse_err <= tol["lse"],
                  f"{name}: lse differs from the plain version ({lse_err:.3g})")
            results[name] = {"route": route,
                             "o_max_abs_err": float(o_err.max()),
                             "lse_max_abs_err": lse_err,
                             "empty_rows": int(empty.sum())}
            log(f"kernel flash_fwd {name} [{route}]: O err "
                f"{float(o_err.max()):.3g}, lse err {lse_err:.3g}, fully "
                f"masked rows {int(empty.sum())} — ok")

        # D > 256: the reference's tiling fails for every block, and the
        # port runs its dense plain path (no kernel launch).
        q, k, v = (rand(1, 64, 2, 320, dtype=bf16) for _ in range(3))
        n0, dense0 = fa.launches, fa.launches_dense
        out, lse = fa.flash_attention_with_lse(q, k, v)
        ref_o, ref_lse = fa.flash_attention_reference(q, k, v)
        check(fa.launches == n0 and fa.launches_dense == dense0 + 1
              and torch.equal(out, ref_o) and torch.equal(lse, ref_lse),
              "head dim 320 did not take the dense plain path")
        log("kernel flash_fwd head_dim_320 [dense]: the plain path, no "
            "launch — ok")

        timings = {}
        for name, b, t, h, d in (("serving_prefill", 8, 128, 8, 64),
                                 ("long_prompt", 1, 2048, 8, 64)):
            q, k, v = (rand(b, t, h, d, dtype=bf16) for _ in range(3))
            qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            ms = device_ms(torch, lambda: fa.flash_attention_with_lse(q, k, v))
            plain = device_ms(
                torch, lambda: fa.flash_attention_reference(q, k, v), 10)
            lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True))
            bound, by = attention_bound_ms(b, t, t, h, h, d, "bfloat16",
                                           causal=True)
            timings[name] = {"shape": [b, t, h, d], "route": "tc", "ms": ms,
                             "plain_ms": plain, "library_ms": lib,
                             "bound_ms": bound, "bound_by": by}
            log(f"time flash_fwd {name} B{b} T{t} H{h} D{d} causal bf16 "
                f"[tc]: kernel_ms {ms:.5f} plain_ms {plain:.5f} library_ms "
                f"(sdpa) {lib:.5f} bound_ms {bound:.5f} ({by})")
    return results, timings


def backward_cases(torch):
    """B2 and B3 against their plain versions on the same inputs (q, k, v,
    dO, the kernel forward's lse, delta = rowsum(dO·O) − dlse), in every
    mask case of phase 3, GQA, D 40/64/128/256, f32 and bf16, with and
    without an lse cotangent. Returns {case: errors}."""
    from horovod_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    # (name, B, Tq, Tk, H, Hkv, D, dtype, kwargs, segments, lse cotangent)
    cases = [
        ("training_shape", 8, 1024, 1024, 8, 8, 64, bf16, {}, False, False),
        ("window256_sinks4", 2, 1024, 1024, 8, 8, 64, bf16,
         {"window": 256, "sinks": 4}, False, False),
        ("packed_segments", 2, 512, 512, 8, 8, 64, bf16, {}, True, False),
        ("cross_length_q_offset", 2, 200, 700, 8, 8, 64, bf16,
         {"q_offset": 300}, False, False),
        ("fully_masked_rows", 2, 256, 256, 8, 8, 64, bf16,
         {"q_offset": -40}, False, False),
        ("gqa_noncausal_d128", 2, 192, 320, 8, 2, 128, bf16,
         {"causal": False}, False, False),
        ("f32_window_lse_cotangent", 2, 384, 384, 8, 8, 64, f32,
         {"window": 100}, False, True),
        ("head_dim_256_gqa_sinks", 1, 100, 300, 4, 2, 256, bf16,
         {"window": 64, "sinks": 3}, False, False),
        ("head_dim_256_f32_lse_cotangent", 1, 96, 96, 2, 2, 256, f32, {},
         False, True),
        ("head_dim_40_f32", 2, 77, 77, 4, 4, 40, f32, {}, False, False),
        ("head_dim_128_f32_gqa_lse_cotangent", 2, 130, 130, 8, 4, 128, f32,
         {}, False, True),
        ("bf16_segments_gqa_lse_cotangent", 2, 256, 256, 8, 2, 64, bf16, {},
         True, True),
        ("strided_v_qkv_views", 2, 256, 256, 8, 8, 64, bf16, {}, "qkv",
         False),
        ("ragged_t1000", 2, 1000, 1000, 8, 8, 64, bf16, {}, False, False),
        ("head_dim_40_bf16_lse_cotangent", 2, 77, 77, 4, 4, 40, bf16, {},
         False, True),
        ("fp16_gqa_lse_cotangent", 2, 256, 256, 8, 2, 64, f16, {}, False,
         True),
        ("fp16_window_d128", 2, 300, 300, 4, 4, 128, f16, {"window": 64},
         False, False),
        # Phase 19a: the seq2seq sites' masks, with and without an lse
        # cotangent.
        ("encoder_padded", 8, 1024, 1024, 8, 8, 64, bf16, {"causal": False},
         "pad", False),
        ("encoder_padded_f32_lse_cotangent", 2, 300, 300, 4, 4, 64, f32,
         {"causal": False}, "pad", True),
        ("cross_padded_q700_k1024", 2, 700, 1024, 8, 8, 64, bf16,
         {"causal": False}, "cross", False),
        ("cross_padded_q1024_k700_lse_cotangent", 2, 1024, 700, 8, 8, 64,
         bf16, {"causal": False}, "cross", True),
        ("cross_padded_f32", 2, 200, 300, 4, 4, 64, f32, {"causal": False},
         "cross", False),
        ("tiny_tiles_bf16_d64_lse_cotangent", 8, 10, 12, 4, 4, 64, bf16,
         {"causal": False}, "cross", True),
        ("tiny_tiles_f32_d24", 8, 10, 12, 4, 4, 24, f32, {"causal": False},
         "cross", False),
        ("tiny_tiles_causal_bf16_d64", 8, 10, 10, 4, 4, 64, bf16, {}, False,
         False),
    ]
    results = {}
    with torch.inference_mode():
        for name, b, tq, tk, h, hkv, d, dt, kw, extra, with_dlse in cases:
            kw = {"causal": True, **kw}
            q, k, v = _qkv_inputs(torch, rand, b, tq, tk, h, hkv, d, dt,
                                  extra)
            if extra is True:
                kw["q_segment_ids"], kw["kv_segment_ids"] = _segment_ids(
                    torch, gen, b, tq)
            elif extra in ("pad", "cross"):
                kw["q_segment_ids"], kw["kv_segment_ids"] = _mask_ids(
                    torch, extra, b, tq, tk)
            out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
            dout = rand(b, tq, h, d, dtype=dt)
            delta = (dout.float() * out.float()).sum(-1)
            if with_dlse:
                delta = delta - torch.randn(b, tq, h, generator=gen,
                                            device="cuda")
            route = fa._route(dt, d)
            tc0 = (fa.launches_bwd_dq_tc, fa.launches_bwd_dkv_tc)
            dq = fa.flash_bwd_dq(q, k, v, dout, lse, delta, **kw)
            dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, **kw)
            torch.cuda.synchronize()
            check(fa.launches_bwd_dq_tc - tc0[0] == (route == "tc"),
                  f"{name}: B2 did not take the {route} route")
            check(fa.launches_bwd_dkv_tc - tc0[1] == (route == "tc"),
                  f"{name}: B3 did not take the {route} route")
            ref = (fa.flash_bwd_dq_reference(q, k, v, dout, lse, delta, **kw),
                   *fa.flash_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                               **kw))
            tol = GRAD_TOL[str(dt).removeprefix("torch.")]
            errs = {}
            for gname, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                        ref):
                check(got.dtype == want.dtype and got.shape == want.shape,
                      f"{name}: {gname} {got.dtype} {tuple(got.shape)}")
                check(torch.isfinite(got.float()).all(),
                      f"{name}: non-finite {gname}")
                w = want.float()
                err = (got.float() - w).abs()
                atol = tol["atol_of_max"] * float(w.abs().max())
                check(bool((err <= atol + tol["rtol"] * w.abs()).all()),
                      f"{name}: {gname} differs from the plain version (max "
                      f"abs {float(err.max()):.3g}, atol {atol:.3g})")
                errs[gname] = float(err.max())
                errs[gname + "_max_abs"] = float(w.abs().max())
            empty = lse <= -1e29
            if bool(empty.any()):
                check(bool((dq.float()[empty] == 0).all()),
                      f"{name}: a fully masked row has a non-zero dq")
            errs["empty_rows"] = int(empty.sum())
            errs["route"] = route
            results[name] = errs
            log(f"kernel flash_bwd {name} [B2 {route}, B3 {route}]: dq err "
                f"{errs['dq']:.3g} (max "
                f"{errs['dq_max_abs']:.3g}), dk err {errs['dk']:.3g} (max "
                f"{errs['dk_max_abs']:.3g}), dv err {errs['dv']:.3g} (max "
                f"{errs['dv_max_abs']:.3g}), fully masked rows "
                f"{errs['empty_rows']} — ok")
    return results


def training_shape_timings(torch):
    """B1, B2 and B3 at the training shape (B8·H8·T1024·D64 causal bf16):
    kernel, plain version and the card's bound; each on both routes (the
    tensor-core kernels the main path takes, and the CUDA-core ones run on
    the same bf16 inputs, for the comparison); SDPA's forward and
    backward on the same shape as a yardstick (the port never calls it).
    Keys: the kernel's library name."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import flash_attention as fa

    b, t, h, d = TRAIN_ATTN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, dout = (torch.randn(b, t, h, d, generator=gen, device="cuda")
                     .to(torch.bfloat16) for _ in range(4))
    with torch.inference_mode():
        out, lse = fa.flash_attention_with_lse(q, k, v)
        delta = (dout.float() * out.float()).sum(-1)
    masks = dict(causal=True, window=None, sinks=0, q_offset=None)

    def fwd(route):
        return lambda: fa._launch(q, k, v, None, None, route=route, **masks)

    def dq(route):
        return lambda: fa._launch_dq(q, k, v, dout, lse, delta, None, None,
                                     masks, route=route)

    def dkv(route):
        return lambda: fa._launch_dkv(q, k, v, dout, lse, delta, None, None,
                                      masks, route=route)

    plain_fwd = lambda: fa.flash_attention_reference(q, k, v)  # noqa: E731
    plain_dq = lambda: fa.flash_bwd_dq_reference(  # noqa: E731
        q, k, v, dout, lse, delta)
    plain_dkv = lambda: fa.flash_bwd_dkv_reference(  # noqa: E731
        q, k, v, dout, lse, delta)
    # name: (B-number, route, kernel call, plain call)
    calls = {
        "flash_fwd_sm90": ("flash_fwd", "tc", fwd("tc"), plain_fwd),
        "flash_fwd": ("flash_fwd", "simt", fwd("simt"), plain_fwd),
        "flash_bwd_dq_sm90": ("flash_bwd_dq", "tc", dq("tc"), plain_dq),
        "flash_bwd_dq": ("flash_bwd_dq", "simt", dq("simt"), plain_dq),
        "flash_bwd_dkv_sm90": ("flash_bwd_dkv", "tc", dkv("tc"), plain_dkv),
        "flash_bwd_dkv": ("flash_bwd_dkv", "simt", dkv("simt"), plain_dkv),
    }
    out_t, plain_ms = {}, {}
    with torch.inference_mode():
        for name, (work, route, kernel, plain) in calls.items():
            bound, by = attention_bound_ms(b, t, t, h, h, d, "bfloat16",
                                           causal=True, kernel=work)
            if plain not in plain_ms:
                plain_ms[plain] = device_ms(torch, plain, 3)
            out_t[name] = {"route": route, "ms": device_ms(torch, kernel, 20),
                           "plain_ms": plain_ms[plain], "bound_ms": bound,
                           "bound_by": by}
    # SDPA ([B,H,T,D]): forward alone, then forward + backward; the
    # backward's time is their difference.
    qh, kh, vh, gh = (x.transpose(1, 2).contiguous() for x in (q, k, v, dout))
    with torch.inference_mode():
        sdpa_fwd = device_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), 20)
    qg, kg, vg = (x.clone().requires_grad_() for x in (qh, kh, vh))

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(o, (qg, kg, vg), gh)

    sdpa_bwd = device_ms(torch, fwd_bwd, 20) - sdpa_fwd
    for name, r in out_t.items():
        r["library_ms"] = sdpa_fwd if name.startswith("flash_fwd") \
            else sdpa_bwd
        log(f"time {name} B{b} T{t} H{h} D{d} causal bf16 [{r['route']}]: "
            f"kernel_ms {r['ms']:.5f} plain_ms {r['plain_ms']:.5f} "
            f"library_ms {r['library_ms']:.5f} bound_ms {r['bound_ms']:.5f} "
            f"({r['bound_by']})")
    return out_t


# The MNIST CNN's two dropout sites at batch 128: the pooled activations
# [128, 64, 12, 12] at rate 0.25 (site 0) and the dense ones [128, 128] at
# 0.5 (site 1); tf1 computes in f32, tf2 in bf16.
DROPOUT_SITES = (((128, 64, 12, 12), 0.25, 0), ((128, 128), 0.5, 1))


def dropout_cases(torch):
    """The dropout kernel against its plain version on the card, at the
    MNIST CNN's sites in f32 and bf16 (and fp16), with a seed tensor and
    the same seed as an int, forward and backward: bit for bit (the same
    integer hash, one f32 product, one rounding). Then its time at the
    larger site in f32 (the cached tf1 step's) beside the plain version's
    and the bound: bytes (x read once, out written once) over HBM's rate;
    the hash's integer operations have no rate in the data sheet's table.
    No PyTorch call computes this mask (``F.dropout`` draws from the
    generator): ``library_ms`` null. Launches made here are reset before
    the main path."""
    from horovod_tpu_torch.ops import dropout as do

    gen = torch.Generator(device="cuda").manual_seed(5)
    seed = torch.tensor(2**62 + 77, device="cuda")
    worst = 0.0
    for shape, rate, site in DROPOUT_SITES:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            x = torch.randn(*shape, generator=gen, device="cuda").to(dt)
            x.requires_grad_()
            g = torch.randn(*shape, generator=gen, device="cuda").to(dt)
            n0 = do.launches
            y = do.dropout(x, rate, seed, site)
            y.backward(g)
            torch.cuda.synchronize()
            check(do.launches - n0 == 2,
                  f"dropout {shape} {dt}: {do.launches - n0} launches, want 2")
            want = do.dropout_reference(x.detach(), rate, seed, site)
            want_g = do.dropout_reference(g, rate, seed, site)
            by_int = do.dropout(x.detach(), rate, 2**62 + 77, site)
            y = y.detach()
            err = max(float((y.float() - want.float()).abs().max()),
                      float((x.grad.float() - want_g.float()).abs().max()),
                      float((by_int.float() - want.float()).abs().max()))
            keep = float((want != 0).float().mean())
            check(err == 0.0 and abs(keep - (1 - rate)) < 0.01,
                  f"dropout {shape} {dt}: kernel differs from the plain "
                  f"version by {err} (kept share {keep})")
            worst = max(worst, err)
            log(f"kernel dropout {list(shape)} rate {rate} "
                f"{str(dt).removeprefix('torch.')}: forward, backward and "
                f"int seed equal the plain version bit for bit, kept "
                f"{keep:.4f} — ok")
    shape, rate, site = DROPOUT_SITES[0]
    x = torch.randn(*shape, generator=gen, device="cuda")
    with torch.inference_mode():
        ms = device_ms(torch, lambda: do._launch(x, rate, seed, site))
        plain = device_ms(
            torch, lambda: do.dropout_reference(x, rate, seed, site), 10)
    nbytes = 2 * x.numel() * x.element_size()
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    out = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
           "bound_by": "bytes", "library_ms": None, "max_abs_err": worst,
           "shape": f"{list(shape)} f32 rate {rate}"}
    log("time dropout", json.dumps(out))
    return out


# -- phase 4 -----------------------------------------------------------------

def _post(url, payload, timeout=300):
    """POST JSON; returns (lines, t_first_line, t_done) on the host clock."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        check(resp.status == 200, f"HTTP {resp.status}")
        first = None
        lines = []
        for raw in resp:
            if first is None:
                first = time.perf_counter()
            lines.append(json.loads(raw))
        return lines, first, time.perf_counter()


def main_path(torch):
    from horovod_tpu_torch.launch.serve import make_server
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.serving import export_generate

    import numpy as np

    model = TransformerLM(**MODEL, compute_dtype=torch.bfloat16,
                          device=DEVICE, seed=0)
    bundle_dir = export_generate(
        os.path.join(WORK, "bundles"), model, batch_size=BATCH,
        prompt_len=PROMPT_LEN, max_new_tokens=NEW_TOKENS,
        streaming_chunk=CHUNK, timestamp="smoke",
    )
    del model
    server = make_server(bundle_dir, port=0, device=DEVICE, continuous=True)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    engine = server.app.engine
    bundle = server.app.bundle
    try:
        health = json.loads(urllib.request.urlopen(f"{url}/healthz",
                                                   timeout=60).read())
        check(health["status"] == "ok", f"healthz: {health}")
        # Warm-up request (first cuBLAS/allocator use), outside the count.
        _post(f"{url}/v1/generate", {"prompt": [[1, 2, 3]]})

        rng = np.random.RandomState(0)
        lengths = [1, PROMPT_LEN] + list(rng.randint(1, PROMPT_LEN + 1,
                                                     N_REQUESTS - 2))
        prompts = [rng.randint(0, MODEL["vocab_size"], n).tolist()
                   for n in lengths]
        stream = [i % 2 == 0 for i in range(N_REQUESTS)]
        prefills0 = engine.stats()["prefill_calls_total"]
        calls0 = engine.stats()["device_calls_total"]
        fa.launches = fa.launches_tc = 0
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(N_REQUESTS) as pool:
            futs = [pool.submit(_post, f"{url}/v1/generate",
                                {"prompt": [p], "stream": s})
                    for p, s in zip(prompts, stream)]
            replies = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        launches, launches_tc = fa.launches, fa.launches_tc
        stats = engine.stats()
        prefills = stats["prefill_calls_total"] - prefills0
        device_calls = stats["device_calls_total"] - calls0
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=30)

    tokens, ttft = [], []
    for (lines, first, done), s in zip(replies, stream):
        check(lines and lines[-1].get("done") if s else len(lines) == 1,
              f"malformed reply {lines[-1:]}")
        toks = lines[-1]["tokens"][0]
        if s:
            pieces = [x for ln in lines[:-1] for x in ln["tokens"][0]]
            check(pieces == toks, "streamed chunks differ from the done line")
            ttft.append(first - t0)
        tokens.append(toks)
    for i, toks in enumerate(tokens):
        check(len(toks) == NEW_TOKENS,
              f"request {i} got {len(toks)} tokens, want {NEW_TOKENS}")
        check(all(0 <= x < MODEL["vocab_size"] for x in toks),
              f"request {i}: token ids out of range")
    # The ragged contract: each request's tokens equal the bundle run on
    # that prompt alone (same device, same batch shape, row 0).
    for i, p in enumerate(prompts):
        alone = bundle.generate_batch([p])[0]
        check(alone == tokens[i],
              f"request {i} (len {len(p)}) differs from its solo run")
    # Informational: batch-1 generate at the prompt's own length runs other
    # matmul shapes, so bf16 rounding may flip a near-tie. Where it differs,
    # record the top-1/top-2 logit margin at the first differing step.
    from horovod_tpu_torch.models.decoding import generate

    same_b1, margins = 0, []
    for i, p in enumerate(prompts):
        b1 = generate(bundle.model, torch.tensor([p]), NEW_TOKENS,
                      include_prompt=False)[0].tolist()
        if b1 == tokens[i]:
            same_b1 += 1
            continue
        j = next(n for n, (x, y) in enumerate(zip(b1, tokens[i])) if x != y)
        with torch.inference_mode():
            logits = bundle.model(torch.tensor([p + b1[:j]], device=DEVICE))
        top2 = logits[0, -1].float().topk(2).values
        margins.append({"request": i, "step": j,
                        "margin": float(top2[0] - top2[1])})
    check(launches == MODEL["n_layers"] * prefills,
          f"flash launches {launches} != n_layers × prefills "
          f"({MODEL['n_layers']} × {prefills})")
    check(launches > 0, "the main path never launched the flash kernel")
    check(launches_tc == launches,
          f"only {launches_tc} of {launches} B1 launches took the "
          "tensor-core route")
    ttft.sort()
    serve = {
        "requests": N_REQUESTS, "prompt_lengths": [len(p) for p in prompts],
        "wall_s": wall,
        "ttft_p50_s": ttft[len(ttft) // 2],
        "ttft_p95_s": ttft[min(len(ttft) - 1, int(0.95 * len(ttft)))],
        "decode_tokens_per_s": N_REQUESTS * NEW_TOKENS / wall,
        "device_calls_total": device_calls, "prefill_dispatches": prefills,
        "flash_launches": launches, "flash_launches_tc": launches_tc,
        "equal_to_batch1_generate": f"{same_b1}/{N_REQUESTS}",
        "batch1_first_difference": margins,
    }
    log("serve", json.dumps(serve))
    log("breakdown", json.dumps(breakdown(torch, bundle)))
    return launches


def profile_events(torch, prof):
    """(name, device type, µs, user annotation?) of each event a
    `torch.profiler` run recorded, read from its raw kineto results: the
    events ``prof.events()`` lists, without the tree of function events it
    builds first (tens of seconds for the ~300 000 events of an eager
    decode)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        out.append((e.name(), e.device_type(), e.duration_ns() / 1e3,
                    e.is_user_annotation()))
    return out


def host_calls(torch, prof):
    """The names of the host-side events of a `torch.profiler` run."""
    cpu = torch.autograd.DeviceType.CPU
    return [name for name, dev, _, _ in profile_events(torch, prof)
            if dev == cpu]


def device_kernels(torch, prof):
    """The kernels a `torch.profiler` run saw on the card, and their device
    ms summed by name. User annotations (``Optimizer.step#...`` ranges on
    the device timeline) are spans over kernels, not kernels: left out so
    that busy time is not counted twice."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in profile_events(torch, prof)
               if e[1] == cuda and not e[3]]
    by_name = {}
    for name, _, us, _ in kernels:
        name = name.replace("(anonymous namespace)::", "")
        by_name[name] = by_name.get(name, 0.0) + us / 1e3
    return kernels, by_name


def breakdown(torch, bundle):
    """Where a serving tick's time goes at the full batch (8 × 128): host
    wall time of the prefill forward alone, of ``start`` (prefill + first
    chunk) and of ``cont`` (one chunk), each with the device's busy time
    and share and its top kernels from `torch.profiler`. Measured after
    the main path's counts were read; not a check."""
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch.models.decoding import make_rng

    vocab = MODEL["vocab_size"]
    prompts = [[(7 * i + 3 * j) % vocab for j in range(PROMPT_LEN)]
               for i in range(BATCH)]
    padded, lengths = bundle._pad(prompts)
    prompt_t = torch.as_tensor(padded, device=DEVICE)
    state = {}

    def prefill():
        with torch.inference_mode():
            bundle.model.decode(prompt_t,
                                max_decode_len=PROMPT_LEN + NEW_TOKENS)

    def start():
        state["s"] = bundle._start(padded, make_rng(0, DEVICE), lengths)[1]

    def cont():
        bundle._cont(state["s"])

    out = {}
    for name, fn in (("prefill", prefill), ("start", start), ("cont", cont)):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels, by_name = device_kernels(torch, prof)
        busy_ms = sum(by_name.values())
        out[name] = {
            "wall_ms": wall_ms,
            "kernel_launches": len(kernels),
            "device_busy_ms": busy_ms if kernels else "not measured",
            "device_busy_share": busy_ms / wall_ms if kernels
            else "not measured",
            "top_kernels_ms": [
                [n[:70], ms] for n, ms in
                sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            ],
        }
    return out


# -- phase 5 -----------------------------------------------------------------

def main_vs_plain(torch):
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, MODEL["vocab_size"], (BATCH, PROMPT_LEN),
                           generator=gen)
    gpu = TransformerLM(**MODEL, compute_dtype=torch.float32, device=DEVICE,
                        seed=0)
    cpu = TransformerLM(**MODEL, compute_dtype=torch.float32, device="cpu",
                        seed=0)
    with torch.inference_mode():
        before, before_tc = fa.launches, fa.launches_tc
        logits_gpu, _ = gpu.decode(prompt.to(DEVICE),
                                   max_decode_len=PROMPT_LEN + NEW_TOKENS)
        check(fa.launches - before == MODEL["n_layers"],
              "the f32 prefill did not run the flash kernel per layer")
        check(fa.launches_tc == before_tc,
              "the f32 prefill took the tensor-core route")
        logits_gpu = logits_gpu.cpu()
        logits_cpu, _ = cpu.decode(prompt,
                                   max_decode_len=PROMPT_LEN + NEW_TOKENS)
    check(torch.isfinite(logits_gpu).all(), "non-finite logits on the card")
    check(logits_gpu.shape == (BATCH, PROMPT_LEN, MODEL["vocab_size"]),
          f"logits shape {tuple(logits_gpu.shape)}")
    err = float((logits_gpu - logits_cpu).abs().max())
    log(f"prefill f32 card (kernel) vs cpu (plain): max abs logits err "
        f"{err:.3g} (tolerance {LOGITS_ATOL})")
    check(err <= LOGITS_ATOL, "card prefill logits differ from the plain path")


# -- phase 6 -----------------------------------------------------------------

def _draw(x, y, rng):
    """bench.py's training feed: batches of random rows, with
    replacement, from one seeded RandomState."""
    while True:
        idx = rng.randint(0, len(x), size=TRAIN_BATCH)
        yield x[idx], y[idx]


def train_path(torch):
    """The training main path: `Trainer.fit` of the bench LM (bf16
    compute, fused-CE head in 8 chunks, AdamW(scale_lr(3e-4)) with optax's
    defaults) for TRAIN_STEPS steps of 8 × 1024 copy_task rows. Returns the
    per-kernel launch counts of that run."""
    import numpy as np

    from horovod_tpu_torch import DistributedOptimizer, Trainer, adamw, scale_lr
    from horovod_tpu_torch.data.datasets import copy_task
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.ops import flash_attention as fa

    x, y = copy_task(4096, TRAIN_SEQ, MODEL["vocab_size"])
    feed = _draw(x, y, np.random.RandomState(0))
    model = TransformerLM(**MODEL, compute_dtype=torch.bfloat16,
                          fused_head_chunks=8, device=DEVICE, seed=0)
    trainer = Trainer(model, DistributedOptimizer(adamw(scale_lr(3e-4))),
                      loss="module", seed=0, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    fa.launches_tc = fa.launches_bwd_dq_tc = fa.launches_bwd_dkv_tc = 0
    t0 = time.perf_counter()
    hist = trainer.fit(dataset=feed, epochs=TRAIN_STEPS, steps_per_epoch=1,
                       verbose=0)
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.launches_bwd_dq,
                "flash_bwd_dkv": fa.launches_bwd_dkv,
                "flash_fwd_tc": fa.launches_tc,
                "flash_bwd_dq_tc": fa.launches_bwd_dq_tc,
                "flash_bwd_dkv_tc": fa.launches_bwd_dkv_tc}
    peak = torch.cuda.max_memory_allocated()
    losses = [e["loss"] for e in hist]
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0],
          f"loss did not fall: first {losses[0]:.4f}, last {losses[-1]:.4f}")
    # The fit steps once eagerly, captures the step once and replays it:
    # the wrappers launch at the eager step and record at the capture;
    # each replay relaunches what was recorded.
    runner = trainer._runner
    replays = runner.replays
    check(runner.captures == 1 and replays == TRAIN_STEPS - 1,
          f"the fit captured {runner.captures} times and replayed {replays} "
          f"steps, want 1 and {TRAIN_STEPS - 1}")
    want = MODEL["n_layers"] * (TRAIN_STEPS - replays + runner.captures)
    for name, n in launches.items():
        check(n == want, f"{name} launched {n} times in training, want "
              f"n_layers × (eager steps + captures) = {want} (all on the "
              f"tensor-core route)")
    # Steps after the first two (cuBLAS/allocator warm-up); each step's
    # host time ends with the fetch of its loss.
    steady = sorted(e["epoch_time_s"] * 1e3 for e in hist[2:])
    median = steady[len(steady) // 2]
    train = {
        "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "wall_s": wall, "loss_first": losses[0], "loss_last": losses[-1],
        "losses": losses,
        "step_ms_median": median, "step_ms_min": steady[0],
        "step_ms_max": steady[-1],
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (median / 1e3),
        "peak_memory_gib": peak / 2**30, "launches": launches,
        "graph_replays": replays,
    }
    log("train", json.dumps(train))
    log("breakdown_train", json.dumps(train_breakdown(torch, trainer, feed)))
    return dict(launches, graph_replays=replays, step_ms_median=median)


def profiled_fit(torch, fit, start, window):
    """Run ``fit(callbacks)``, whose ``on_batch_end`` fires once a step,
    with `torch.profiler` on over steps ``start`` .. ``start + window``:
    returns the profiler and the window's host ms a step (the card
    synchronised at the window's two ends only)."""
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch import callbacks

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    clock = {}

    class Window(callbacks.Callback):
        calls = 0

        def on_batch_end(self, batch, logs=None):
            self.calls += 1
            if self.calls == start:
                torch.cuda.synchronize()
                prof.start()
                clock["t0"] = time.perf_counter()
            elif self.calls == start + window:
                torch.cuda.synchronize()
                clock["t1"] = time.perf_counter()
                prof.stop()

    fit([Window()])
    return prof, (clock["t1"] - clock["t0"]) * 1e3 / window


def _per_step(torch, prof, window, host_ms):
    """Device busy time, launches and top kernels a step of a profiled
    window of ``window`` steps."""
    kernels, by_name = device_kernels(torch, prof)
    calls = host_calls(torch, prof)
    busy = sum(by_name.values()) / window
    return {
        "device_busy_ms_per_step": busy if kernels else "not measured",
        "device_busy_share": busy / host_ms if kernels else "not measured",
        "device_kernels_per_step": len(kernels) / window,
        "graph_launches_per_step": calls.count("cudaGraphLaunch") / window,
        "kernel_launches_per_step": calls.count("cudaLaunchKernel") / window,
        "top_kernels_ms_per_step": [
            [k[:80], ms / window] for k, ms in
            sorted(by_name.items(), key=lambda kv: -kv[1])[:8]],
    }, by_name


def train_breakdown(torch, trainer, feed):
    """Where a training step's time goes, after the main path's counts
    were read; not a check. The fit as the main path runs it (graph
    replays: 10 steps, the last 5 profiled) and one eager `train_step`
    (host wall ms, then profiled)."""
    from torch.profiler import ProfilerActivity, profile

    window = 5
    prof, host_ms = profiled_fit(torch, lambda cbs: trainer.fit(
        dataset=feed, epochs=2 * window, steps_per_epoch=1, callbacks=cbs,
        verbose=0), window, window)
    replay, by_name = _per_step(torch, prof, window, host_ms)
    flash_ms = {k: sum(ms for n, ms in by_name.items() if k in n) / window
                for k in ("flash_fwd_sm90_kernel", "flash_bwd_dq_sm90_kernel",
                          "flash_bwd_dkv_sm90_kernel")}
    x, y = next(feed)

    def step():
        trainer.train_step(x, y)["loss"].item()

    step()
    t = time.perf_counter()
    step()
    wall_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as eager_prof:
        step()
        torch.cuda.synchronize()
    eager, _ = _per_step(torch, eager_prof, 1, wall_ms)
    return {"replayed_host_ms_per_step": host_ms, "replayed": replay,
            "flash_kernels_ms_per_step": flash_ms,
            "eager_wall_ms": wall_ms,
            "eager": {k: v for k, v in eager.items()
                      if k != "top_kernels_ms_per_step"}}


# -- phase 7 -----------------------------------------------------------------

def train_vs_plain(torch):
    """One f32 AdamW step of the full-width, full-depth bench LM at
    2 × 256 on the card (the kernels) and on the CPU (the plain versions),
    from the same seeded weights: loss, every gradient and every updated
    parameter compared. The card also runs the step with remat, which must
    launch B1 twice per layer (forward and recompute) and give the same
    loss and gradients."""
    from horovod_tpu_torch import DistributedOptimizer, Trainer, adamw
    from horovod_tpu_torch.data.datasets import copy_task
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls
    x, y = (a[:2] for a in copy_task(2, 256, MODEL["vocab_size"], seed=1))
    lr = 3e-4
    n = MODEL["n_layers"]
    runs = {}
    for dev, remat, want in ((DEVICE, False, (n, n, n)),
                             (DEVICE, True, (2 * n, n, n)),
                             ("cpu", False, (0, 0, 0))):
        model = TransformerLM(**MODEL, compute_dtype=torch.float32,
                              fused_head_chunks=8, remat=remat, device=dev,
                              seed=0)
        trainer = Trainer(model, DistributedOptimizer(adamw(lr)),
                          loss="module", seed=0, device=dev)
        before = (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)
        before_tc = (fa.launches_tc, fa.launches_bwd_dq_tc,
                     fa.launches_bwd_dkv_tc)
        loss = float(trainer.train_step(x, y)["loss"])
        after = (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)
        check((fa.launches_tc, fa.launches_bwd_dq_tc,
               fa.launches_bwd_dkv_tc) == before_tc,
              f"a {dev} f32 training step took the tensor-core route")
        runs[dev, remat] = (loss, {n: (p.detach().cpu(), p.grad.cpu())
                                   for n, p in model.named_parameters()})
        got = tuple(b - a for a, b in zip(before, after))
        if dev == DEVICE and not remat:
            f32_launches = dict(zip(("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv"), got))
        check(got == want, f"a {dev} training step (remat={remat}) launched "
              f"B1/B2/B3 {got} times, want {want}")
    # Remat recomputes the same kernels on the same inputs: expected bit
    # for bit, held to 1e-6 of each gradient's largest.
    (lg, pg), (lr_, pr) = runs[DEVICE, False], runs[DEVICE, True]
    remat_err = max(float((pr[k][1] - g).abs().max())
                    / max(float(g.abs().max()), 1e-30)
                    for k, (_, g) in pg.items())
    check(abs(lr_ - lg) <= 1e-6 and remat_err <= 1e-6,
          f"remat changed the card's loss ({lr_} vs {lg}) or gradients "
          f"({remat_err:.3g} of max)")
    runs[DEVICE] = runs[DEVICE, False]
    runs["cpu"] = runs["cpu", False]
    (lg, pg), (lc, pc) = runs[DEVICE], runs["cpu"]
    check(math.isfinite(lg), "non-finite loss on the card")
    loss_err = abs(lg - lc)
    grad_err, param_err, n_amplified, n_total = 0.0, 0.0, 0, 0
    for name, (p_cpu, g_cpu) in pc.items():
        p_gpu, g_gpu = pg[name]
        g_max = float(g_cpu.abs().max())
        g_err = float((g_gpu - g_cpu).abs().max())
        grad_err = max(grad_err, g_err / max(g_max, 1e-30))
        check(g_err <= TRAIN_GRAD_REL * g_max,
              f"{name}: gradient differs, card vs cpu ({g_err:.3g} of max "
              f"{g_max:.3g})")
        # Adam's first step is p·(1 − lr·wd) − lr·g/(|g| + eps). Both sides
        # start from the same p, so the step differs by at most lr times
        # the change of g/(|g| + eps) over |Δg| ≤ g_err: eps·g_err /
        # (|g| − g_err + eps)², at most 2 — large only where |g| is near
        # 0 — plus f32 rounding. The card's AdamW is the capturable form (a
        # device learning rate, as the CUDA-graph step needs it): it forms
        # the decay factor and the step in f32 tensors, in another order
        # than the CPU's float-lr form, so an updated parameter may also
        # round one f32 ulp of its value apart.
        near = (g_cpu.abs() - g_err).clamp_min(0.0) + ADAM_EPS
        bound = lr * torch.clamp(ADAM_EPS * g_err / near**2, max=2.0)
        ulp = torch.finfo(torch.float32).eps * p_cpu.abs()
        err = (p_gpu - p_cpu).abs()
        check(bool((err <= bound + TRAIN_PARAM_ATOL + ulp).all()),
              f"{name}: updated parameter differs, card vs cpu (max "
              f"{float(err.max()):.3g})")
        param_err = max(param_err, float(err.max()))
        amplified = bound > TRAIN_PARAM_ATOL
        n_amplified += int(amplified.sum())
        n_total += err.numel()
    check(loss_err <= TRAIN_LOSS_ATOL,
          f"loss differs, card vs cpu: {lg} vs {lc}")
    forms_gap = adamw_forms_gap(torch, {k: g for k, (_, g) in pg.items()},
                                lr)
    check(forms_gap["within_phase7_allowance"],
          f"AdamW's capturable and float-lr forms differ beyond what phase "
          f"7 allows for it: {forms_gap}")
    result = {"loss_card": lg, "loss_cpu": lc, "loss_abs_err": loss_err,
              "adamw_capturable_vs_float_lr": forms_gap,
              "remat_loss_abs_err": abs(lr_ - lg),
              "remat_grad_max_err_of_max": remat_err,
              "grad_max_err_of_max": grad_err,
              "param_max_abs_err": param_err,
              "params_with_adam_bound_above_atol": n_amplified,
              "params": n_total, "launches": f32_launches}
    log("train f32 step card (kernels) vs cpu (plain):", json.dumps(result))
    return result


def adamw_forms_gap(torch, grads, lr):
    """Why phase 7 allows one f32 ulp of each updated parameter: one AdamW
    step (`adamw`'s settings) of the LM's seeded f32 weights on the card,
    from the card's gradients, in the capturable form (a device learning
    rate, as the port runs it on CUDA) and in the float-lr form (as the
    CPU runs it); torch's capturable form refuses CPU tensors, so the two
    forms meet only here. Returns the largest difference in f32 ulps of
    the step's operands (eps × the largest of |p|, |p'| and lr), the
    largest absolute difference, and whether every element lies within
    what phase 7 allows beyond the gradients' effect (1e-7 abs plus one
    ulp of the value)."""
    from horovod_tpu_torch.models.transformer import TransformerLM

    model = TransformerLM(**MODEL, compute_dtype=torch.float32,
                          fused_head_chunks=8, device=DEVICE, seed=0)
    p0 = dict(model.named_parameters())
    after = {}
    for cap in (True, False):
        ps = [torch.nn.Parameter(p0[n].detach().clone()) for n in grads]
        for p, n in zip(ps, grads):
            p.grad = grads[n].to(DEVICE)
        opt = torch.optim.AdamW(
            ps, lr=torch.tensor(lr, device=DEVICE) if cap else lr,
            betas=(0.9, 0.999), eps=ADAM_EPS, weight_decay=1e-4,
            capturable=cap)
        opt.step()
        after[cap] = [p.detach() for p in ps]
    eps = torch.finfo(torch.float32).eps
    ulps, abs_err, within = 0.0, 0.0, True
    for n, a, b in zip(grads, after[True], after[False]):
        d = (a - b).abs()
        scale = torch.maximum(p0[n].detach().abs(),
                              torch.maximum(a.abs(), b.abs())).clamp_min(lr)
        ulps = max(ulps, float((d / (eps * scale)).max()))
        abs_err = max(abs_err, float(d.max()))
        within &= bool((d <= TRAIN_PARAM_ATOL + eps * b.abs()).all())
    return {"max_ulps_of_operands": ulps, "max_abs": abs_err,
            "within_phase7_allowance": within}


# -- phases 8-10 ----------------------------------------------------------------

def _launch(name, nprocs, script, knobs, timeout=MNIST_TIMEOUT_S,
            code=None, launch=None, on_line=None):
    """Run ``horovod_tpu_torch.examples.<script>`` (or, with ``code``, that
    python source) under the port's launcher with ``nprocs`` ranks and the
    env ``knobs``, its artifacts under WORK/<name> and the dataset cache
    under WORK/data. ``launch``: the launcher's arguments instead of ``run
    --nprocs N --`` (the child command is appended after ``--`` unless
    they name a job); ``on_line`` sees each output line as it arrives.
    Returns (output lines, wall seconds,
    launch wall-clock time, model path); the whole output is kept in
    WORK/<name>.log."""
    model_path = os.path.join(WORK, name)
    env = dict(os.environ, PS_MODEL_PATH=model_path,
               HVT_DATA_DIR=os.path.join(WORK, "data"),
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p),
               **knobs)
    child = (["-c", code] if code is not None
             else ["-m", f"horovod_tpu_torch.examples.{script}"])
    if launch is None:
        launch = ["run", "--nprocs", str(nprocs)]
    if launch[0] != "job":
        launch = [*launch, "--", sys.executable, *child]
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", *launch]
    started = time.time()
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    lines: list[str] = []

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if on_line is not None:
                on_line(lines[-1])

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    usage = _wait_usage(proc, timeout)
    reader.join(timeout=30)
    wall = time.perf_counter() - t0
    with _LOG_LOCK:
        LAUNCH_COST[name] = {"wall_s": round(wall, 1), "cpu_s": usage}
    with open(os.path.join(WORK, f"{name}.log"), "w") as f:
        f.write("\n".join(lines) + "\n")
    check(proc.returncode == 0,
          f"{name}: the launch exited {proc.returncode}; last lines:\n"
          + "\n".join(lines[-15:]))
    return lines, wall, started, model_path


# Each launch's wall seconds and the host CPU seconds of its process tree
# (user + system, the launcher and the ranks it waited for), printed as the
# ``launch_cost`` line: what a host with fewer free cores pays for.
LAUNCH_COST: dict = {}


def _wait_usage(proc, timeout):
    """Wait for ``proc`` (killing its process group after ``timeout`` s)
    and return the CPU seconds it and the children it reaped used."""
    deadline = time.perf_counter() + timeout
    while True:
        pid, status, ru = os.wait4(proc.pid, os.WNOHANG)
        if pid:
            proc.returncode = os.waitstatus_to_exitcode(status)
            return round(ru.ru_utime + ru.ru_stime, 1)
        if time.perf_counter() > deadline:
            os.killpg(proc.pid, signal.SIGKILL)
            deadline = math.inf
        time.sleep(0.05)


def _rank_line(lines, prefix, rank=0):
    """The rest of ``rank``'s first output line starting with ``prefix``."""
    tag = f"[rank {rank}] {prefix}"
    for line in lines:
        if line.startswith(tag):
            return line[len(tag):].strip()
    raise SmokeFailure(f"no rank-{rank} line {prefix!r} in the output")


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _checkpoints(model_dir):
    """The epoch checkpoint files in ``model_dir``; each must be intact."""
    from horovod_tpu_torch import checkpoint

    names = sorted((n for n in os.listdir(model_dir)
                    if checkpoint.CHECKPOINT_RE.search(n)),
                   key=lambda n: int(checkpoint.CHECKPOINT_RE.search(n)[1]))
    for n in names:
        check(checkpoint.checkpoint_intact(os.path.join(model_dir, n)),
              f"checkpoint {n} fails its digest")
    return names


def _world(lines, nprocs, backend):
    world = _rank_line(lines, "World:")
    check(f"process_count={nprocs}," in world
          and f"backend='{backend}'" in world,
          f"want {nprocs} rank(s) on {backend}, got {world}")
    return world


def _tf2_summary(lines, model_path, steps_per_epoch, nprocs):
    """Per-epoch figures of a tf2 twin run from its rank-0 event log."""
    model_dir = os.path.join(model_path, "horovod-mnist")
    records = _jsonl(os.path.join(model_dir, "events.jsonl"))
    epochs = [r for r in records if "epoch/loss" in r]
    losses = [r["epoch/loss"] for r in epochs]
    check(losses and all(map(math.isfinite, losses)),
          f"non-finite MNIST loss: {losses}")
    check(losses[-1] < losses[0],
          f"MNIST loss did not fall: {losses[0]:.4f} → {losses[-1]:.4f}")
    ips = sorted(steps_per_epoch * MNIST_BATCH * nprocs
                 / r["epoch/epoch_time_s"] for r in epochs)
    digests = _rank_line(lines, "State digests:").split()
    check(len(digests) == nprocs and len(set(digests)) == 1,
          f"ranks' training states differ after fit: {digests}")
    return {
        "epochs": len(epochs), "steps": steps_per_epoch * len(epochs),
        "images_per_s_median": ips[len(ips) // 2],
        "images_per_s_min": ips[0], "images_per_s_max": ips[-1],
        "loss_first": losses[0], "loss_last": losses[-1],
        "checkpoints": _checkpoints(model_dir),
        "state_digest": digests[0][:16],
    }, records


def mnist_tf2(torch, nprocs=1, cut=MNIST_TF2_CUT):
    """Phase 8: the tf2 twin at ``nprocs`` NCCL ranks (one card each), the
    reference budget (500 // nprocs steps × 24 epochs) unless cut."""
    lines, wall, _, model_path = _launch("mnist_tf2", nprocs,
                                         "tf2_style_mnist", cut)
    world = _world(lines, nprocs, "nccl")
    steps = int(cut.get("DRIVE_STEPS", 500 // nprocs))
    result, _ = _tf2_summary(lines, model_path, steps, nprocs)
    check(result["epochs"] == int(cut.get("DRIVE_EPOCHS", 24)),
          f"{result['epochs']} epoch records")
    check(len(result["checkpoints"]) == result["epochs"],
          f"checkpoints {result['checkpoints']}")
    warmup = [float(line.split()[-1]) for line in lines
              if "LearningRateWarmup:" in line]
    result.update({
        "world": world, "backend": "nccl", "cut": cut or None,
        "warmup_scales": warmup, "wall_s": wall,
        "peak_memory_bytes": int(_rank_line(lines,
                                        "Peak device memory (bytes):")),
    })
    log("mnist_tf2", json.dumps(result))
    return result


def _serving_probe(x):
    """The first 128 test images and 128 halfway blends of two neighbouring
    ones: on a blend the trained model puts weight on two classes, so its
    small probabilities are far from 0 and the comparison sees them."""
    import numpy as np

    return np.concatenate([x[:128], 0.5 * (x[:128] + x[128:256])])


def check_serving(trainer, bundle, x, device):
    """The bundle against ``trainer``: its parameters bit for bit, and its
    probabilities against ``Trainer.predict`` on ``x`` in the same batches.
    Returns the figures; raises SmokeFailure on a difference."""
    import numpy as np
    import torch

    from horovod_tpu_torch import checkpoint

    held = torch.export.load(
        os.path.join(bundle, checkpoint.PROGRAM_FILE)).state_dict
    params = dict(trainer.module.named_parameters())
    check(sorted(held) == sorted(f"module.{k}" for k in params)
          and all(torch.equal(held[f"module.{k}"].cpu(), p.detach().cpu())
                  for k, p in params.items()),
          "the bundle's parameters are not the trained state's")
    serve = checkpoint.load_serving(bundle, device=device)
    served = np.concatenate([serve(x[i:i + MNIST_BATCH])
                             for i in range(0, len(x), MNIST_BATCH)])
    predicted = trainer.predict(x, batch_size=MNIST_BATCH)
    diff = np.abs(served - predicted)
    top = np.maximum(served, predicted)
    seen = top >= SERVE_REL_FLOOR
    result = {
        "serve_max_abs_err": float(diff.max()),
        "serve_max_rel_err": float((diff[seen] / top[seen]).max()),
        "serve_entries_compared_rel": int(seen.sum()),
        "serve_rows_unsaturated": int((predicted.max(-1) < 0.999).sum()),
    }
    check(served.shape == predicted.shape == (len(x), 10)
          and result["serve_max_abs_err"] <= SERVE_ATOL
          and result["serve_max_rel_err"] <= SERVE_RTOL
          and result["serve_entries_compared_rel"] > len(x),
          f"serving bundle vs predict: {served.shape}, {result}")
    return result


def mnist_tf1(torch, nprocs=1, cut=MNIST_TF1_CUT):
    """Phase 9: the tf1 twin at ``nprocs`` NCCL ranks, the reference budget
    (ceil(12 / nprocs) epochs) unless ``cut``; its CI loss gate, a resume
    from its newest checkpoint and its serving export, checked here, in one
    process, from the script's artifacts."""
    import numpy as np

    from horovod_tpu_torch import (DistributedOptimizer, Trainer, adadelta,
                                   checkpoint)
    from horovod_tpu_torch.data import datasets
    from horovod_tpu_torch.models.cnn import MnistCNN

    lines, wall, started, model_path = _launch("mnist_tf1", nprocs,
                                               "tf1_style_mnist", cut)
    world = _world(lines, nprocs, "nccl")
    feed = json.loads(_rank_line(lines, "Feed:"))
    check(feed["path"] == "streamed" and feed["engine"] == "native",
          f"tf1 did not train on the native batch engine: {feed}")
    model_dir = os.path.join(model_path, "horovod-mnist")
    epochs = [r for r in _jsonl(os.path.join(model_dir, "eval",
                                             "events.jsonl"))
              if "epoch/val_accuracy" in r]
    val_acc = [r["epoch/val_accuracy"] for r in epochs]
    first98 = next((i for i, a in enumerate(val_acc) if a >= 0.98), None)
    test_loss = float(_rank_line(lines, "Test loss:"))
    test_acc = float(_rank_line(lines, "Test accuracy:"))
    final_digest = _rank_line(lines, "State digests:").split()[0]
    gate = [r["value"] for r in _jsonl(os.path.join(model_path,
                                                    "metrics.jsonl"))
            if r["name"] == "loss"]
    gate_mean = sum(gate) / len(gate)
    check(CI_LOSS_GATE[0] <= gate_mean <= CI_LOSS_GATE[1],
          f"CI gate: mean loss {gate_mean} outside {CI_LOSS_GATE}")
    # The script's artifacts, read back in this process.
    (_, _), (x_test, y_test) = datasets.mnist(
        cache_dir=os.path.join(WORK, "data"))
    x_test = (x_test.astype(np.float32) / 255.0)[..., None]
    y_test = np.eye(10, dtype=np.float32)[y_test]
    trainer = Trainer(MnistCNN(device=DEVICE),
                      DistributedOptimizer(adadelta(1.0)),
                      loss="categorical_crossentropy", device=DEVICE)
    trainer.build()
    _, resumed_epoch = checkpoint.restore_latest_and_broadcast(
        model_dir, trainer.state)
    check(resumed_epoch == len(epochs),
          f"resumed epoch {resumed_epoch}, trained {len(epochs)}")
    check(checkpoint.state_digest(trainer.state) == final_digest,
          "resume: the newest checkpoint is not the script's final state")
    resumed_loss = trainer.evaluate(x_test, y_test, batch_size=MNIST_BATCH)[
        "loss"]
    check(abs(resumed_loss - test_loss) <= RESUME_ATOL,
          f"resume: loss {resumed_loss} vs the script's {test_loss}")
    serving = check_serving(trainer,
                            _rank_line(lines, "Exported serving bundle:"),
                            _serving_probe(x_test), DEVICE)
    per_epoch = 60000 // nprocs // MNIST_BATCH * MNIST_BATCH * nprocs
    result = {
        "world": world, "backend": "nccl", "engine": feed["engine"],
        "epochs": len(epochs), "val_accuracy": val_acc,
        "first_epoch_98": None if first98 is None else first98 + 1,
        "train_s_to_98": None if first98 is None else sum(
            r["epoch/epoch_time_s"] for r in epochs[:first98 + 1]),
        "wall_s_to_98": None if first98 is None
        else epochs[first98]["wall_time"] - started,
        "images_per_s_median": sorted(
            per_epoch / r["epoch/epoch_time_s"]
            for r in epochs)[len(epochs) // 2],
        "test_loss": test_loss, "test_accuracy": test_acc,
        "ci_gate_mean_loss": gate_mean, "ci_gate_records": len(gate),
        "resume_state_bit_identical": True,
        "resume_loss_abs_err": abs(resumed_loss - test_loss),
        "bundle_params_bit_identical": True, **serving,
        "wall_s": wall,
        "peak_memory_bytes": int(_rank_line(lines,
                                        "Peak device memory (bytes):")),
    }
    log("mnist_tf1", json.dumps(result))
    return result


def mnist_2rank(torch):
    """Phase 10: the tf2 twin at two gloo ranks on the one card, a few
    epochs of a few steps: the ranks end bit-identical and only rank 0
    writes."""
    lines, wall, _, model_path = _launch(
        "mnist_2rank", 2, "tf2_style_mnist",
        dict(MNIST_2RANK_CUT, HVT_BACKEND="gloo"))
    world = _world(lines, 2, "gloo")
    steps = int(MNIST_2RANK_CUT["DRIVE_STEPS"])
    n_epochs = int(MNIST_2RANK_CUT["DRIVE_EPOCHS"])
    result, records = _tf2_summary(lines, model_path, steps, 2)
    model_dir = os.path.join(model_path, "horovod-mnist")
    # One writer: a second would double every record of the shared files.
    n_batch = sum(1 for r in records if "batch/loss" in r)
    n_gate = sum(1 for r in _jsonl(os.path.join(model_path, "metrics.jsonl"))
                 if r["name"] == "loss")
    n_tb = sum(1 for n in os.listdir(model_dir)
               if n.startswith("events.out.tfevents."))
    check((result["epochs"], n_batch, n_gate, n_tb)
          == (n_epochs, n_epochs * steps, n_epochs, 1),
          f"artifacts from more than rank 0: {result['epochs']} epoch, "
          f"{n_batch} batch, {n_gate} metrics.jsonl loss records, "
          f"{n_tb} TensorBoard files")
    check(len(result["checkpoints"]) == n_epochs,
          f"checkpoints {result['checkpoints']}")
    result.update({"world": world, "backend": "gloo",
                   "ranks_bit_identical": True, "rank0_only_artifacts": True,
                   "wall_s": wall, "note": "correctness check, not a speed"})
    log("mnist_2rank", json.dumps(result))
    return result


def mnist_breakdown(torch):
    """Where a tf2 step's time goes (phase 8's configuration: bf16
    `MnistCNN`, Adam, batch 128, a world of one NCCL rank), measured in
    this process after the phases' checks; not a check. The host time of
    the python loader alone; ``fit(dataset=)`` as phase 8 runs it (graph
    replays), its steps 200-220 profiled; and 100 eager `train_step` calls
    on preloaded batches, then 20 profiled (the step without a graph)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch import (DistributedOptimizer, Trainer, adam,
                                   runtime)
    from horovod_tpu_torch.data import datasets
    from horovod_tpu_torch.data.loader import ArrayDataset
    from horovod_tpu_torch.launch.launcher import pick_free_port
    from horovod_tpu_torch.models.cnn import MnistCNN

    (x, y), _ = datasets.mnist(path="mnist-0.npz",
                               cache_dir=os.path.join(WORK, "data"))
    x = (x.astype(np.float32) / 255.0)[..., None]

    def stream():
        return (ArrayDataset((x, y.astype(np.int64))).repeat()
                .shuffle(10000, seed=0).batch(MNIST_BATCH))

    def trainer():
        return Trainer(MnistCNN(compute_dtype=torch.bfloat16, device=DEVICE),
                       DistributedOptimizer(adam(1e-3)), device=DEVICE)

    runtime.init(f"127.0.0.1:{pick_free_port()}", 1, 0, device=DEVICE)
    try:
        it = iter(stream())
        n, window = 200, 20
        t = time.perf_counter()
        batches = [next(it) for _ in range(n)]
        load_ms = (time.perf_counter() - t) * 1e3 / n
        prof, fit_ms = profiled_fit(torch, lambda cbs: trainer().fit(
            stream(), steps_per_epoch=n + window, callbacks=cbs, verbose=0),
            n, window)
        replayed, _ = _per_step(torch, prof, window, fit_ms)
        eager_trainer = trainer()
        for b in batches[:20]:
            eager_trainer.train_step(*b)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for b in batches[:100]:
            eager_trainer.train_step(*b)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t) * 1e3 / 100
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as eager_prof:
            for b in batches[100:100 + window]:
                eager_trainer.train_step(*b)
            torch.cuda.synchronize()
        eager, _ = _per_step(torch, eager_prof, window, eager_ms)
        backend = runtime.backend()
    finally:
        runtime.shutdown()
    return {
        "backend": backend, "batch": MNIST_BATCH,
        "loader_ms_per_batch": load_ms,
        "fit_host_ms_per_step": fit_ms,
        "fit_images_per_s": MNIST_BATCH / (fit_ms / 1e3),
        "fit": replayed,
        "eager_step_ms_preloaded": eager_ms,
        "eager": {k: v for k, v in eager.items()
                  if k != "top_kernels_ms_per_step"},
    }


# -- phase 11 -------------------------------------------------------------------

def _mnist_arrays():
    """The tf1 script's arrays: f32 NHWC images / 255 and one-hot labels
    (train and test), from the dataset cache of the earlier phases."""
    import numpy as np

    from horovod_tpu_torch.data import datasets

    (x, y), (xt, yt) = datasets.mnist(cache_dir=os.path.join(WORK, "data"))
    eye = np.eye(10, dtype=np.float32)
    return ((x.astype(np.float32) / 255.0)[..., None], eye[y], y,
            (xt.astype(np.float32) / 255.0)[..., None], eye[yt])


def _gate(metrics, check_, aggregate="mean"):
    """``python -m horovod_tpu_torch.launch gate`` on ``metrics`` with one
    ``NAME=LO..HI`` check, called in this process (its exit code)."""
    from horovod_tpu_torch.launch import launcher

    return launcher.main(["gate", "--metrics", metrics, "--check", check_,
                          "--aggregate", aggregate])


def _ci_job_spec(name, nprocs):
    """A copy of the port's ``launch/jobs/mnist-ci.yaml`` with its paths
    under WORK/<name>, ``nprocs`` ranks and this interpreter; returns the
    spec's path and its metrics path."""
    model_path = os.path.join(WORK, name)
    with open(os.path.join(ROOT, CI_JOB_SPEC)) as f:
        text = f.read()
    for old, new in (
            ("/tmp/hvt-ci-models", model_path),
            ("nprocs: 1", f"nprocs: {nprocs}"),
            ("command: python -m horovod_tpu_torch.examples.tf1_style_mnist",
             f'command: ["{sys.executable}", "-m", '
             '"horovod_tpu_torch.examples.tf1_style_mnist"]')):
        check(old in text, f"{CI_JOB_SPEC} has no {old!r}")
        text = text.replace(old, new)
    spec = os.path.join(WORK, f"{name}.yaml")
    with open(spec, "w") as f:
        f.write(text)
    return spec, os.path.join(model_path, "metrics.jsonl")


def mnist_ci_cached(torch, nprocs=1):
    """Phase 11 (and 16a): the CI job — the port's ``mnist-ci.yaml`` (the
    tf1 twin with ``HVT_DEVICE_CACHE=1``) through ``python -m
    horovod_tpu_torch.launch job`` at ``nprocs`` NCCL ranks, the reference
    budget (ceil(12 / nprocs) epochs); the job's exit code 0 is its loss
    gate. Then the same metrics against an impossible range must fail the
    ``gate`` subcommand. Returns the figures and the model path."""
    spec, metrics_path = _ci_job_spec("mnist_ci_cached", nprocs)
    lines, wall, started, model_path = _launch(
        "mnist_ci_cached", nprocs, None, {}, launch=["job", spec])
    gate_line = next((ln for ln in lines if ln.startswith("check loss:")),
                     None)
    check(gate_line is not None and gate_line.endswith("PASS"),
          f"16a: the job's loss gate line: {gate_line}")
    dead = _gate(metrics_path, "loss=0.0..0.0001")
    check(dead == 1, f"16a: an impossible gate exited {dead}")
    ci_job = {"part": "a_ci_job", "job_exit": 0, "gate": gate_line,
              "impossible_gate_exit": dead, "wall_s": wall,
              "nprocs": nprocs}
    world = _world(lines, nprocs, "nccl")
    feed = json.loads(_rank_line(lines, "Feed:"))
    check(feed["path"] == "device",
          f"HVT_DEVICE_CACHE=1 did not take the cached fit: {feed}")
    model_dir = os.path.join(model_path, "horovod-mnist")
    epochs = [r for r in _jsonl(os.path.join(model_dir, "eval",
                                             "events.jsonl"))
              if "epoch/val_accuracy" in r]
    check(len(epochs) == -(-12 // nprocs), f"{len(epochs)} epoch records")
    val_acc = [r["epoch/val_accuracy"] for r in epochs]
    first98 = next((i for i, a in enumerate(val_acc) if a >= 0.98), None)
    check(first98 is not None, f"98 % val_accuracy never reached: {val_acc}")
    gate = [r["value"] for r in _jsonl(os.path.join(model_path,
                                                    "metrics.jsonl"))
            if r["name"] == "loss"]
    gate_mean = sum(gate) / len(gate)
    check(CI_LOSS_GATE[0] <= gate_mean <= CI_LOSS_GATE[1],
          f"CI gate: mean loss {gate_mean} outside {CI_LOSS_GATE}")
    digests = _rank_line(lines, "State digests:").split()
    check(len(digests) == nprocs and len(set(digests)) == 1,
          f"ranks' training states differ after the cached fit: {digests}")
    test_loss = float(_rank_line(lines, "Test loss:"))
    test_acc = float(_rank_line(lines, "Test accuracy:"))
    # The last epoch's validation (cached) and the script's final evaluate
    # (uncached) see the same state.
    val_err = abs(epochs[-1]["epoch/val_loss"] - test_loss)
    check(val_err <= CACHED_EVAL_ATOL
          and epochs[-1]["epoch/val_accuracy"] == test_acc,
          f"cached validation {epochs[-1]['epoch/val_loss']} / "
          f"{epochs[-1]['epoch/val_accuracy']} vs uncached evaluate "
          f"{test_loss} / {test_acc}")
    steps = 60000 // nprocs // MNIST_BATCH
    ips = sorted(steps * MNIST_BATCH * nprocs / r["epoch/epoch_time_s"]
                 for r in epochs)
    result = {
        "world": world, "backend": "nccl", "feed": feed["path"],
        "epochs": len(epochs), "steps_per_epoch": steps,
        "val_accuracy": val_acc, "first_epoch_98": first98 + 1,
        "train_s_to_98": sum(r["epoch/epoch_time_s"]
                             for r in epochs[:first98 + 1]),
        "wall_s_to_98": epochs[first98]["wall_time"] - started,
        "images_per_s_median": ips[len(ips) // 2],
        "images_per_s_min": ips[0], "images_per_s_max": ips[-1],
        "epoch_time_s": [r["epoch/epoch_time_s"] for r in epochs],
        "test_loss": test_loss, "test_accuracy": test_acc,
        "cached_val_vs_uncached_eval_abs_err": val_err,
        "ci_gate_mean_loss": gate_mean, "ci_gate_records": len(gate),
        "ranks_bit_identical": True, "wall_s": wall,
        "peak_memory_bytes": int(_rank_line(lines,
                                        "Peak device memory (bytes):")),
        "ci_job": ci_job,
    }
    log("mnist_ci_cached", json.dumps(result))
    return result, model_path


def _tf1_trainer(torch, **kw):
    from horovod_tpu_torch import DistributedOptimizer, Trainer, adadelta
    from horovod_tpu_torch.models.cnn import MnistCNN

    return Trainer(MnistCNN(device=DEVICE), DistributedOptimizer(adadelta(1.0)),
                   loss="categorical_crossentropy", device=DEVICE, **kw)


def cached_in_process(torch, model_path):
    """Phase 11's checks in this process, at one NCCL rank: cached against
    uncached evaluate of the CI run's newest checkpoint; graph replays
    against eager steps, from fresh weights and resumed from that
    checkpoint; the cached step's breakdown (the dropout kernel's launches
    on this path and its device time a step); steps_per_execution.
    Returns the figures."""
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch import callbacks, checkpoint, runtime
    from horovod_tpu_torch.launch.launcher import pick_free_port
    from horovod_tpu_torch.ops import dropout as do

    x, y_oh, y, xt, yt_oh = _mnist_arrays()
    runtime.init(f"127.0.0.1:{pick_free_port()}", 1, 0, device=DEVICE)
    try:
        out = {}
        # Cached against uncached evaluate, one state.
        trainer = _tf1_trainer(torch)
        trainer.build()
        _, epoch = checkpoint.restore_latest_and_broadcast(
            os.path.join(model_path, "horovod-mnist"), trainer.state)
        check(epoch == 12, f"the CI run's newest checkpoint is epoch {epoch}")
        cached = trainer.evaluate(xt, yt_oh, batch_size=MNIST_BATCH,
                                  cache="device")
        plain = trainer.evaluate(xt, yt_oh, batch_size=MNIST_BATCH)
        err = abs(cached["loss"] - plain["loss"])
        check(err <= CACHED_EVAL_ATOL
              and cached["accuracy"] == plain["accuracy"],
              f"evaluate cached {cached} vs uncached {plain}")
        out["evaluate"] = {"cached": cached, "uncached": plain,
                           "loss_abs_err": err, "tolerance": CACHED_EVAL_ATOL}

        # Graph replays against eager steps, from the same state (the
        # seeded initial weights, no optimizer state).
        runs = {}
        for eager in (False, True):
            t = _tf1_trainer(torch)
            t.fit(x=x, y=y_oh, batch_size=MNIST_BATCH,
                  steps_per_epoch=GRAPH_VS_EAGER_STEPS, cache="device",
                  verbose=0, _eager=eager)
            torch.cuda.synchronize()
            runs[eager] = t
        g, e = runs[False], runs[True]
        check((g._runner.captures, g._runner.replays)
              == (1, GRAPH_VS_EAGER_STEPS - 1)
              and e._runner.replays == 0,
              "the graph run did not replay one capture for every step "
              "after the first")
        with torch.no_grad():
            param_err = max(float((p - q).abs().max()) for p, q in zip(
                g.module.parameters(), e.module.parameters()))
        same = checkpoint.state_digest(g.state) == checkpoint.state_digest(
            e.state)
        out["graph_vs_eager"] = {
            "steps": GRAPH_VS_EAGER_STEPS, "captures": 1,
            "replays": GRAPH_VS_EAGER_STEPS - 1,
            "bit_identical": same, "param_max_abs_err": param_err}
        log("graph_vs_eager", json.dumps(out["graph_vs_eager"]))
        check(same, "graph replays and eager steps differ after "
              f"{GRAPH_VS_EAGER_STEPS} steps (max param err {param_err})")

        # The same, resumed from the CI run's newest checkpoint (optimizer
        # state restored): the runner steps once eagerly before it
        # captures, then replays.
        digests, counts = [], None
        for eager in (False, True):
            t = _tf1_trainer(torch)
            t.build()
            checkpoint.restore_latest_and_broadcast(
                os.path.join(model_path, "horovod-mnist"), t.state)
            t.fit(x=x, y=y_oh, batch_size=MNIST_BATCH, epochs=13,
                  initial_epoch=12, steps_per_epoch=GRAPH_VS_EAGER_STEPS,
                  cache="device", verbose=0, _eager=eager)
            torch.cuda.synchronize()
            digests.append(checkpoint.state_digest(t.state))
            if not eager:
                counts = (t._runner.captures, t._runner.replays)
        out["resumed_graph_vs_eager"] = {
            "from_epoch": 12, "steps": GRAPH_VS_EAGER_STEPS,
            "captures": counts[0], "replays": counts[1],
            "bit_identical": digests[0] == digests[1]}
        log("resumed_graph_vs_eager", json.dumps(
            out["resumed_graph_vs_eager"]))
        check(counts == (1, GRAPH_VS_EAGER_STEPS - 1),
              f"the resumed fit captured/replayed {counts}")
        check(digests[0] == digests[1], "a resumed fit's graph replays and "
              "eager steps differ")

        # The cached step's breakdown: a warm epoch on the host clock, then
        # a profiled window of replays (steps 20-39 of a fit chunked every
        # 20 steps, after the chunk that captured the graph).
        t = _tf1_trainer(torch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        do.launches = 0
        hist = t.fit(x=x, y=y_oh, batch_size=MNIST_BATCH, epochs=2,
                     cache="device", verbose=0)
        out["dropout_launches"] = do.launches
        out["dropout_graph_replays"] = t._runner.replays
        check(do.launches > 0, "the cached fit never launched the dropout "
              "kernel")
        peak = torch.cuda.max_memory_allocated()
        host_ms = hist[-1]["epoch_time_s"] * 1e3 / MNIST_STEPS_PER_EPOCH
        window = min(20, MNIST_STEPS_PER_EPOCH // 2)
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        clock = {}

        class Window(callbacks.Callback):
            def on_batch_end(self, batch, logs=None):
                torch.cuda.synchronize()
                if batch == window - 1:
                    prof.start()
                    clock["t0"] = time.perf_counter()
                elif batch == 2 * window - 1:
                    clock["t1"] = time.perf_counter()
                    prof.stop()

        os.environ["HVT_EPOCH_CHUNK_STEPS"] = str(window)
        try:
            t.fit(x=x, y=y_oh, batch_size=MNIST_BATCH, epochs=1,
                  steps_per_epoch=2 * window, cache="device", verbose=0,
                  callbacks=[Window()])
        finally:
            del os.environ["HVT_EPOCH_CHUNK_STEPS"]
        window_ms = (clock["t1"] - clock["t0"]) * 1e3 / window
        # The busy share against the warm epoch's host ms a step.
        per_step, by_name = _per_step(torch, prof, window, host_ms)
        out["breakdown_mnist_cached"] = {
            "config": "tf1 (f32 MnistCNN, Adadelta(1.0), batch 128), "
                      "fit(cache='device'), 1 NCCL rank",
            "host_ms_per_step": host_ms,
            "images_per_s": MNIST_BATCH / (host_ms / 1e3),
            "window_host_ms_per_step": window_ms,
            **per_step,
            "dropout_kernel_ms_per_step": sum(
                ms for k, ms in by_name.items() if "dropout_kernel" in k)
            / window if by_name else "not measured",
            "peak_memory_bytes_in_process": peak,
        }

        # steps_per_execution: tf2's configuration, one cut epoch.
        out["steps_per_execution"] = spe_runs(torch, x, y)
    finally:
        runtime.shutdown()
    return out


def spe_runs(torch, x, y):
    """tf2's configuration (bf16 `MnistCNN`, Adam(0.001), sparse CE,
    batch 128) for one epoch of SPE_STEPS steps at K = SPE_K and K = 1, on
    tf2's ``dataset=`` feed and on ``x=``/``y=`` (graph replays, both): at every chunk end, K's loss must equal K = 1's at that
    step, bit for bit (the same steps in both; K moves the callbacks)."""
    from horovod_tpu_torch import (DistributedOptimizer, Trainer, adam,
                                   callbacks)
    from horovod_tpu_torch.data.loader import ArrayDataset
    from horovod_tpu_torch.models.cnn import MnistCNN

    class Record(callbacks.Callback):
        def __init__(self):
            self.seen = {}

        def on_batch_end(self, batch, logs=None):
            self.seen[batch] = float(logs["loss"])

    out = {}
    for feed in ("dataset", "xy"):
        seen = {}
        for k in (SPE_K, 1):
            trainer = Trainer(
                MnistCNN(compute_dtype=torch.bfloat16, device=DEVICE),
                DistributedOptimizer(adam(1e-3)), device=DEVICE,
                steps_per_execution=k)
            rec = Record()
            kw = dict(steps_per_epoch=SPE_STEPS, callbacks=[rec], verbose=0)
            if feed == "dataset":
                ds = (ArrayDataset((x, y)).shard(0, 1).repeat()
                      .shuffle(10000, seed=0).batch(MNIST_BATCH))
                trainer.fit(ds, **kw)
            else:
                trainer.fit(x=x, y=y, batch_size=MNIST_BATCH, **kw)
            seen[k] = rec.seen
        ends = sorted(seen[SPE_K])
        check(ends == list(range(SPE_K - 1, SPE_STEPS, SPE_K)),
              f"{feed}: K={SPE_K} callbacks at steps {ends}")
        diff = max(abs(seen[SPE_K][s] - seen[1][s]) for s in ends)
        check(diff == 0.0, f"{feed}: K={SPE_K} losses differ from K=1's at "
              f"the chunk ends (max {diff})")
        out[feed] = {"K": SPE_K, "steps": SPE_STEPS,
                     "chunk_end_steps": len(ends),
                     "loss_first_chunk": seen[SPE_K][ends[0]],
                     "loss_last_chunk": seen[SPE_K][ends[-1]],
                     "max_abs_diff_vs_K1": diff}
    log("steps_per_execution", json.dumps(out))
    return out


# -- phase 12 -------------------------------------------------------------------

def _cifar_arrays():
    """The twin's training arrays (f32 NHWC / 255, int64 labels) from the
    dataset cache of this run."""
    import numpy as np

    from horovod_tpu_torch.data import datasets

    (x, y), _ = datasets.cifar10(path="cifar10-0.npz",
                                 cache_dir=os.path.join(WORK, "data"))
    return x.astype(np.float32) / 255.0, y.astype(np.int64)


def _cifar_summary(name, lines, model_path, nprocs, steps):
    """Per-epoch figures of a CIFAR twin run from its rank-0 event log,
    with the checks every such run must pass: finite losses that fall, one
    intact checkpoint an epoch, bit-identical ranks."""
    model_dir = os.path.join(model_path, "horovod-cifar")
    epochs = [r for r in _jsonl(os.path.join(model_dir, "events.jsonl"))
              if "epoch/loss" in r]
    losses = [r["epoch/loss"] for r in epochs]
    check(losses and all(map(math.isfinite, losses)),
          f"{name}: non-finite loss: {losses}")
    check(losses[-1] < losses[0],
          f"{name}: loss did not fall: {losses[0]:.4f} → {losses[-1]:.4f}")
    times = [r["epoch/epoch_time_s"] for r in epochs]
    ips = sorted(steps * CIFAR_BATCH * nprocs / t for t in times)
    step_ms = sorted(t * 1e3 / steps for t in times)
    digests = _rank_line(lines, "State digests:").split()
    check(len(digests) == nprocs and len(set(digests)) == 1,
          f"{name}: ranks' states (parameters, running statistics, "
          f"optimizer) differ after fit: {digests}")
    ckpts = _checkpoints(model_dir)
    check(len(ckpts) == len(epochs), f"{name}: checkpoints {ckpts}")
    return {
        "epochs": len(epochs), "steps_per_epoch": steps,
        "images_per_s_median": ips[len(ips) // 2],
        "images_per_s_min": ips[0], "images_per_s_max": ips[-1],
        "step_ms_median": step_ms[len(step_ms) // 2],
        "epoch_losses": losses, "epoch_accuracy": [r["epoch/accuracy"]
                                                   for r in epochs],
        "test_loss": float(_rank_line(lines, "Test loss:")),
        "test_accuracy": float(_rank_line(lines, "Test accuracy:")),
        "ranks_bit_identical": True, "state_digest": digests[0][:16],
        "peak_memory_bytes": int(_rank_line(lines,
                                        "Peak device memory (bytes):")),
    }


def cifar_data_start():
    """Write the CIFAR-10 stand-in the 12a twin's rank 0 reads (WORK/data,
    the launches' dataset cache) in a process of its own while phases 8-11
    run: its synthesis and compression are host work 12a's launch would
    otherwise wait for. The twin reads the same bytes either way (the
    synthesis is seeded). `cifar_data_join` waits for it."""
    code = ("from horovod_tpu_torch.data import datasets; "
            "datasets.cifar10(path='cifar10-0.npz', cache_dir="
            f"{os.path.join(WORK, 'data')!r})")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)


def cifar_data_join(proc):
    _, err = proc.communicate(timeout=600)
    check(proc.returncode == 0,
          f"the CIFAR-10 stand-in's synthesis exited {proc.returncode}: "
          f"{err[-2000:]}")


def cifar_resnet(torch, nprocs=1, cut=None):
    """12a: the ResNet-20 twin at ``nprocs`` NCCL ranks (one card each), the
    reference budget (390 // nprocs steps × 24 epochs at 128 a rank) unless
    cut; the loss must fall and test accuracy reach CIFAR_ACC_GATE."""
    cut = CIFAR_CUT if cut is None else cut
    lines, wall, _, model_path = _launch("cifar_resnet", nprocs,
                                         "cifar10_resnet", cut,
                                         timeout=CIFAR_TIMEOUT_S)
    world = _world(lines, nprocs, "nccl")
    steps = int(cut.get("DRIVE_STEPS", 390 // nprocs))
    result = _cifar_summary("cifar_resnet", lines, model_path, nprocs, steps)
    check(result["epochs"] == int(cut.get("DRIVE_EPOCHS", 24)),
          f"{result['epochs']} epoch records")
    check(result["test_accuracy"] >= CIFAR_ACC_GATE,
          f"test accuracy {result['test_accuracy']} under "
          f"{CIFAR_ACC_GATE} (ceiling ~0.5: classes c and c + 5 are one "
          "distribution in the synthetic set)")
    result.update({"world": world, "backend": "nccl", "cut": cut or None,
                   "accuracy_gate": CIFAR_ACC_GATE, "wall_s": wall})
    log("cifar_resnet", json.dumps(result))
    return result


# Launched by cifar_breakdown at N ranks: the twin's configuration (bf16
# ResNet-20, Adam(0.001 × size), its shard → shuffle → batch feed), one fit
# with torch.profiler on over a window of replayed steps; rank 0 prints the
# figures as JSON.
BREAKDOWN_CHILD = r"""
import json, os, sys
import numpy as np
import torch
import chip_smoke as cs
import horovod_tpu_torch as hvt
from horovod_tpu_torch.data.loader import ArrayDataset
from horovod_tpu_torch.models.resnet import ResNetCIFAR

hvt.init()
x, y = cs._cifar_arrays()
ds = (ArrayDataset((x, y)).shard(hvt.rank(), hvt.size()).repeat()
      .shuffle(10000, seed=hvt.rank()).batch(cs.CIFAR_BATCH))
trainer = hvt.Trainer(ResNetCIFAR(depth=20, compute_dtype=torch.bfloat16),
                      hvt.DistributedOptimizer(hvt.adam(hvt.scale_lr(1e-3))))
start, window = cs.CIFAR_WINDOW_START, cs.CIFAR_WINDOW
prof, host_ms = cs.profiled_fit(torch, lambda cbs: trainer.fit(
    ds, steps_per_epoch=start + window, callbacks=cbs, verbose=0),
    start, window)
per_step, by_name = cs._per_step(torch, prof, window, host_ms)
nccl_ms = sum(ms for k, ms in by_name.items() if "nccl" in k.lower()) / window
if hvt.rank() == 0:
    print("BREAKDOWN " + json.dumps(dict(
        per_step, host_ms_per_step=host_ms, ranks=hvt.size(),
        images_per_s=cs.CIFAR_BATCH * hvt.size() / (host_ms / 1e3),
        nccl_ms_per_step=nccl_ms if by_name else "not measured",
        nccl_share_of_busy=(nccl_ms / per_step["device_busy_ms_per_step"]
                            if by_name else "not measured"),
        eager_steps=trainer._runner.eager_steps,
        captures=trainer._runner.captures,
        replays=trainer._runner.replays)), flush=True)
hvt.shutdown()
"""


def cifar_breakdown(torch, nprocs=1):
    """Where a ResNet-20 step's time goes at ``nprocs`` NCCL ranks (12a's
    configuration): host ms a step, device busy share, device kernels and
    graph launches a step, the NCCL kernels' share (the gradient all-reduce
    and, past one rank, the BN all-reduces) — one profiled window, measured
    in a launched process; not a check."""
    lines, _, _, _ = _launch(f"cifar_breakdown_{nprocs}", nprocs, None, {},
                             timeout=CIFAR_TIMEOUT_S, code=BREAKDOWN_CHILD)
    out = json.loads(_rank_line(lines, "BREAKDOWN"))
    check(out["eager_steps"] == 1 and out["captures"] == 1,
          f"the profiled fit did not run one eager step and one capture: "
          f"{out}")
    return out


# Launched by cifar_graph_vs_eager at N NCCL ranks: on each rank, k steps
# of fit (one eager step, one capture, replays) and k train_step calls from
# the same seeded state on the rank's own batches; each rank prints its
# figures as JSON.
GRAPH_VS_EAGER_CHILD = r"""
import json
import torch
import chip_smoke as cs
import horovod_tpu_torch as hvt
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.models.resnet import ResNetCIFAR

topology = hvt.init(device=cs.DEVICE)
if hvt.rank() == 0:
    print("World:", topology, flush=True)
r, n = hvt.rank(), hvt.size()
k, b = cs.CIFAR_GRAPH_VS_EAGER_STEPS, cs.CIFAR_BATCH
x, y = cs._cifar_arrays()
batches = [(x[(i * n + r) * b:(i * n + r + 1) * b],
            y[(i * n + r) * b:(i * n + r + 1) * b]) for i in range(k)]


def trainer():
    return hvt.Trainer(ResNetCIFAR(depth=20, compute_dtype=torch.bfloat16,
                                   device=cs.DEVICE),
                       hvt.DistributedOptimizer(hvt.adam(1e-3)),
                       device=cs.DEVICE)


g = trainer()
g.fit(dataset=batches, steps_per_epoch=k, verbose=0)
e = trainer()
for xb, yb in batches:
    e.train_step(xb, yb)
with torch.no_grad():
    stat_err = max(float((a - c).abs().max()) for (name, a), c in zip(
        g.module.named_buffers(), e.module.buffers()) if "running" in name)
    param_err = max(float((a - c).abs().max()) for a, c in zip(
        g.module.parameters(), e.module.parameters()))
digest = checkpoint.state_digest(g.state)
print("GRAPH_VS_EAGER " + json.dumps(dict(
    eager_steps=g._runner.eager_steps, captures=g._runner.captures,
    replays=g._runner.replays,
    bit_identical=digest == checkpoint.state_digest(e.state),
    digest=digest, param_max_abs_err=param_err,
    running_stat_max_abs_err=stat_err)), flush=True)
hvt.shutdown()
"""


def cifar_graph_vs_eager(torch, nprocs=1):
    """12b: on each of ``nprocs`` NCCL ranks, CIFAR_GRAPH_VS_EAGER_STEPS
    steps of ``fit`` (one eager step, one capture, replays) against as
    many ``Trainer.train_step`` calls from the same seeded state on the
    same batches: the parameters, the optimizer state and the BN running
    statistics must end bit-identical. Past one rank the captured step
    holds the BN all-reduces, forward and backward, and the eager steps
    make the same calls; the ranks must also agree with each other."""
    k = CIFAR_GRAPH_VS_EAGER_STEPS
    lines, _, _, _ = _launch(f"cifar_graph_vs_eager_{nprocs}", nprocs,
                             None, {}, timeout=CIFAR_TIMEOUT_S,
                             code=GRAPH_VS_EAGER_CHILD)
    world = _world(lines, nprocs, "nccl")
    ranks = [json.loads(_rank_line(lines, "GRAPH_VS_EAGER", r))
             for r in range(nprocs)]
    out = {"ranks": nprocs, "steps": k,
           "eager_steps": [o["eager_steps"] for o in ranks],
           "captures": [o["captures"] for o in ranks],
           "replays": [o["replays"] for o in ranks],
           "bit_identical": [o["bit_identical"] for o in ranks],
           "ranks_bit_identical": len({o["digest"] for o in ranks}) == 1,
           "param_max_abs_err": max(o["param_max_abs_err"] for o in ranks),
           "running_stat_max_abs_err": max(o["running_stat_max_abs_err"]
                                           for o in ranks),
           "world": world}
    log("cifar_graph_vs_eager", json.dumps(out))
    check(all((o["eager_steps"], o["captures"], o["replays"]) == (1, 1, k - 1)
              for o in ranks),
          f"fit ran {out} (eager steps, captures, replays), want one eager "
          "step and one capture on every rank")
    check(all(out["bit_identical"]),
          f"graph replays and train_step differ after {k} steps: {out}")
    check(out["ranks_bit_identical"], f"the ranks' states differ: {out}")
    return out


SYNC_BN_CHILD = r"""
import functools, os
import numpy as np
import torch
import chip_smoke as cs
import horovod_tpu_torch as hvt
from horovod_tpu_torch.models.resnet import ResNetCIFAR

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
hvt.init()
r, b = hvt.rank(), cs.SYNC_BN_BATCH
batches = [(bx[r * b:(r + 1) * b], by[r * b:(r + 1) * b])
           for bx, by in cs._sync_bn_batches()]
model = ResNetCIFAR(depth=8, seed=2)
trainer = hvt.Trainer(model, hvt.DistributedOptimizer(
    functools.partial(torch.optim.SGD, lr=0.1)))
trainer.fit(dataset=batches, epochs=len(batches), steps_per_epoch=1,
            verbose=0)
np.savez(os.path.join(cs.WORK, f"sync_bn_rank{r}.npz"),
         eager_steps=trainer._runner.eager_steps,
         captures=trainer._runner.captures,
         **{k: t.cpu().numpy() for k, t in model.state_dict().items()})
hvt.shutdown()
"""


def _sync_bn_batches():
    """SYNC_BN_STEPS batches of 2 × SYNC_BN_BATCH images (the CPU test's
    draws: uniform pixels and labels from seed 0)."""
    import numpy as np

    rng = np.random.RandomState(0)
    x = rng.rand(SYNC_BN_STEPS, 2 * SYNC_BN_BATCH, SYNC_BN_SIDE,
                 SYNC_BN_SIDE, 3).astype(np.float32)
    y = rng.randint(0, 10, (SYNC_BN_STEPS, 2 * SYNC_BN_BATCH)).astype(
        np.int64)
    return list(zip(x, y))


def sync_bn_on_card(torch):
    """12c: two gloo ranks sharing the card at SYNC_BN_BATCH each against
    one rank at twice that, in this process: parameters and running
    statistics within SYNC_BN_ATOL after SYNC_BN_STEPS SGD steps of an f32
    depth-8 ResNet (TF32 off on both sides). Under gloo the BN all-reduces
    go through the host, so the ranks' runners step eagerly (counted)."""
    import functools

    import numpy as np

    from horovod_tpu_torch import DistributedOptimizer, Trainer
    from horovod_tpu_torch.models.resnet import ResNetCIFAR

    _launch("sync_bn", 2, None, {"HVT_BACKEND": "gloo"},
            code=SYNC_BN_CHILD)
    ranks = [np.load(os.path.join(WORK, f"sync_bn_rank{r}.npz"))
             for r in range(2)]
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = ResNetCIFAR(depth=8, seed=2, device=DEVICE)
        trainer = Trainer(model, DistributedOptimizer(functools.partial(
            torch.optim.SGD, lr=0.1)), device=DEVICE)
        trainer.fit(dataset=_sync_bn_batches(), epochs=SYNC_BN_STEPS,
                    steps_per_epoch=1, verbose=0)
        want = {k: t.cpu().numpy() for k, t in model.state_dict().items()}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    same = all(np.array_equal(ranks[0][k], ranks[1][k]) for k in want)
    err = {kind: max(float(np.abs(ranks[0][k] - want[k]).max())
                     for k in want if ("running" in k) == (kind == "stats"))
           for kind in ("params", "stats")}
    out = {"ranks": 2, "backend": "gloo", "batch_per_rank": SYNC_BN_BATCH,
           "steps": SYNC_BN_STEPS, "ranks_bit_identical": same,
           "param_max_abs_err": err["params"],
           "running_stat_max_abs_err": err["stats"],
           "tolerance": SYNC_BN_ATOL,
           "eager_steps": [int(r["eager_steps"]) for r in ranks],
           "captures": [int(r["captures"]) for r in ranks]}
    log("sync_bn", json.dumps(out))
    check(same, "the two ranks' states differ")
    check(max(err.values()) <= SYNC_BN_ATOL,
          f"two ranks at {SYNC_BN_BATCH} differ from one at "
          f"{2 * SYNC_BN_BATCH}: {err}")
    check(out["eager_steps"] == [SYNC_BN_STEPS] * 2
          and out["captures"] == [0, 0],
          f"under gloo the runner must step eagerly: {out}")
    return out


def cifar_vit(torch):
    """12d: the ViT branch of the twin (``ARCH=vit``: patch 4, d 256, 8
    heads, 6 layers, bf16) at one NCCL rank, cut (VIT_CUT); the loss must
    fall."""
    lines, wall, _, model_path = _launch("cifar_vit", 1, "cifar10_resnet",
                                         VIT_CUT, timeout=CIFAR_TIMEOUT_S)
    world = _world(lines, 1, "nccl")
    result = _cifar_summary("cifar_vit", lines, model_path, 1,
                            int(VIT_CUT["DRIVE_STEPS"]))
    result.update({"world": world, "cut": VIT_CUT, "wall_s": wall})
    log("cifar_vit", json.dumps(result))
    return result


# -- phase 13 ---------------------------------------------------------------

# The decode family at the bench LM's width (phase 4's batch and prompt).
DECODE_NEW = 64
SAMPLING = dict(temperature=0.8, top_k=0, top_p=0.9)
SPEC_GAMMA = 8
BEAM_WIDTH, BEAM_PENALTY = 4, 0.6
RING_WINDOW, RING_SINKS, RING_NEW = 64, 4, 256
# int8 paths on the card against their plain versions on the CPU, on the
# same int8 inputs: the int32 products are exact on both, so the outputs
# differ only by the f32 rescale's rounding (one f32 ulp of the f32 value,
# then the bf16 cast: at most one bf16 ulp, relative 2^-8).
INT8_BF16_RTOL = 2.0 ** -8
# The int8 cache's attention in f32 on both devices: the scaled q·k and
# p·v sums run in other orders.
INT8_CACHE_ATOL = 1e-5
# The ring against the full cache under the same window + sinks mask, in
# f32 (the same weights through `clone(compute_dtype=float32)`): the same
# keys in another slot order, summed in other orders.
RING_LOGITS_ATOL = 1e-3
TOKENIZER_SEED = 5


def _decode_profile(torch, fn):
    """One call of ``fn`` under `torch.profiler`: host launches
    (``cudaLaunchKernel``/``cuLaunchKernel`` calls and graph launches),
    device kernels and their busy ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, by_name = device_kernels(torch, prof)
    names = host_calls(torch, prof)
    launches = sum(1 for n in names if n in ("cudaLaunchKernel",
                                             "cudaLaunchKernelExC",
                                             "cuLaunchKernel",
                                             "cuLaunchKernelEx"))
    graphs = sum(1 for n in names if n in ("cudaGraphLaunch",
                                           "cuGraphLaunch"))
    return {"host_kernel_launches": launches, "graph_launches": graphs,
            "device_kernels": len(kernels),
            "device_busy_ms": sum(by_name.values()) if kernels
            else "not measured"}


def _timed(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _prompt_batch(torch, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(1, MODEL["vocab_size"], (BATCH, PROMPT_LEN),
                         generator=gen, dtype=torch.int32)


def decode_generate(torch, model, prompt):
    """13a: greedy and sampled `make_generate_fn`, 64 new tokens: the
    captured steps against the same steps run eagerly, bit for bit; tokens/s,
    launches and graph replays a token and the device's busy share, eager
    and captured."""
    from horovod_tpu_torch.models.decoding import make_generate_fn, make_rng
    from horovod_tpu_torch.ops import flash_attention as fa

    out, tokens = {}, {}
    for mode, knobs in (("greedy", {}), ("sampled", SAMPLING)):
        fn = make_generate_fn(model, max_new_tokens=DECODE_NEW,
                              include_prompt=False, **knobs)
        steps = fn.steps

        def call():
            return fn(prompt, make_rng(7, DEVICE))

        fa.launches = fa.launches_tc = 0
        steps.graphs = False
        eager, _ = _timed(torch, call)  # warm-up: cuBLAS plans
        eager, eager_ms = _timed(torch, call)
        eager_prof = _decode_profile(torch, call)
        steps.graphs = True
        first = steps.counts()
        captured, capture_ms = _timed(torch, call)  # warm step + capture
        captured2, replay_ms = _timed(torch, call)
        replay_prof = _decode_profile(torch, call)
        counts = {k: v - first[k] for k, v in steps.counts().items()}
        check(torch.equal(captured, eager) and torch.equal(captured2, eager),
              f"13a {mode}: graph replays differ from the eager steps")
        check(counts["captures"] == 1
              and counts["replays"] == 3 * (DECODE_NEW - 1) - 1,
              f"13a {mode}: captures/replays {counts}")
        n_tok = BATCH * DECODE_NEW
        tokens[mode] = captured
        out[mode] = {
            "b1_launches": fa.launches, "b1_launches_tc": fa.launches_tc,
            "eager": {"ms": eager_ms, "tokens_per_s": n_tok / eager_ms * 1e3,
                      **eager_prof},
            "captured": {"first_call_ms": capture_ms, "ms": replay_ms,
                         "tokens_per_s": n_tok / replay_ms * 1e3,
                         **replay_prof},
            "graph_replays_per_token": replay_prof["graph_launches"]
            / (DECODE_NEW - 1),
            "steps": counts,
        }
        for key, prof in (("eager", eager_prof), ("captured", replay_prof)):
            o = out[mode][key]
            wall = o["ms"]
            o["host_launches_per_token"] = (
                prof["host_kernel_launches"] + prof["graph_launches"]) \
                / DECODE_NEW
            o["device_kernels_per_token"] = prof["device_kernels"] / DECODE_NEW
            o["device_busy_share"] = (prof["device_busy_ms"] / wall
                                      if isinstance(prof["device_busy_ms"],
                                                    float) else "not measured")
        check(fa.launches == 6 * MODEL["n_layers"]
              and fa.launches_tc == fa.launches,
              f"13a {mode}: B1 launched {fa.launches} times "
              f"({fa.launches_tc} tc), want 6 prefills × n_layers on tc")
        log(f"decode_generate {mode}", json.dumps(out[mode]))
    return out, tokens


def decode_speculative(torch, model, prompt, greedy):
    """13b: speculative greedy, γ 8, prompt lookup: tokens equal to plain
    greedy's bit for bit, full and ragged; rounds and tokens a round."""
    from horovod_tpu_torch.models.decoding import make_generate_fn
    from horovod_tpu_torch.models.speculative import make_speculative_fn
    from horovod_tpu_torch.ops import flash_attention as fa

    spec = make_speculative_fn(model, max_new_tokens=DECODE_NEW,
                               gamma=SPEC_GAMMA, include_prompt=False,
                               return_stats=True)
    fa.launches = 0
    (out, stats), first_ms = _timed(torch, lambda: spec(prompt))
    (out2, stats2), ms = _timed(torch, lambda: spec(prompt))
    prof = _decode_profile(torch, lambda: spec(prompt))
    check(torch.equal(out, out2), "13b: a second speculative call differs")
    diff = (out != greedy).any(dim=1)
    first_diff = None
    if bool(diff.any()):
        row = int(diff.nonzero()[0])
        step = int((out[row] != greedy[row]).nonzero()[0])
        first_diff = {"row": row, "step": step}
    check(first_diff is None,
          f"13b: speculative tokens differ from plain greedy at {first_diff}")
    gen = torch.Generator().manual_seed(11)
    lengths = torch.randint(1, PROMPT_LEN + 1, (BATCH,), generator=gen,
                            dtype=torch.int32)
    lengths[0] = PROMPT_LEN
    ragged, rstats = spec(prompt, None, lengths)
    plain = make_generate_fn(model, max_new_tokens=DECODE_NEW,
                             include_prompt=False)(prompt, None, lengths)
    check(torch.equal(ragged, plain),
          "13b: ragged speculative tokens differ from ragged plain greedy")
    rounds, n_tok = int(stats["rounds"]), int(stats["tokens"])
    res = {
        "gamma": SPEC_GAMMA, "rounds": rounds, "tokens": n_tok,
        "tokens_per_round_per_row": n_tok / (rounds * BATCH),
        "ragged_rounds": int(rstats["rounds"]),
        "ragged_tokens_per_round_per_row": int(rstats["tokens"])
        / (int(rstats["rounds"]) * BATCH),
        "first_call_ms": first_ms, "ms": ms,
        "tokens_per_s": BATCH * DECODE_NEW / ms * 1e3,
        "steps": spec.steps.counts(), "b1_launches": fa.launches, **prof,
    }
    log("decode_speculative", json.dumps(res))
    return res


def decode_beam(torch, model, prompt):
    """13c: beam search, width 4, length penalty 0.6: the captured steps
    against the same search run eagerly (tokens and scores bit for bit)."""
    from horovod_tpu_torch.models.beam import make_beam_search_fn
    from horovod_tpu_torch.ops import flash_attention as fa

    beam = make_beam_search_fn(model, max_new_tokens=DECODE_NEW,
                               beam_size=BEAM_WIDTH,
                               length_penalty=BEAM_PENALTY,
                               include_prompt=False, return_scores=True)
    fa.launches = 0
    beam.steps.graphs = False
    (e_tok, e_score), eager_ms = _timed(torch, lambda: beam(prompt))
    beam.steps.graphs = True
    beam(prompt)  # warm step + capture
    (c_tok, c_score), ms = _timed(torch, lambda: beam(prompt))
    check(torch.equal(c_tok, e_tok) and torch.equal(c_score, e_score),
          "13c: captured beam search differs from the eager one")
    check(bool(torch.isfinite(c_score).all()), "13c: non-finite scores")
    res = {"beam": BEAM_WIDTH, "length_penalty": BEAM_PENALTY,
           "best_scores": c_score.tolist(), "eager_ms": eager_ms, "ms": ms,
           "steps": beam.steps.counts(), "b1_launches": fa.launches}
    log("decode_beam", json.dumps(res))
    return res


def decode_int8(torch, model, prompt, greedy):
    """13d: int8 weights (`quantized`), the int8 cache and int8 compute on
    the prefill: each kernel-level piece against its plain version on the
    CPU on the same int8 inputs; top-1 agreement with the bf16 path as
    information (random weights); the stored bytes."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import quant
    from horovod_tpu_torch.models.decoding import make_generate_fn
    from horovod_tpu_torch.ops import flash_attention as fa

    res = {}
    # int8_dot_general on the prefill's activations, every Dense of block 0
    # and the LM head: _int_mm on the card, int32 matmul on the CPU.
    blk = model.blocks[0]
    with torch.inference_mode():
        x = model._embed(prompt.to(DEVICE))
        h = blk.ln_attn(x)
        errs = {}
        for name, layer, inp in (
                ("qkv", blk.qkv, h), ("attn_out", blk.attn_out, h),
                ("mlp_up", blk.mlp_up, h),
                ("mlp_down", blk.mlp_down,
                 F.gelu(blk._dense(blk.mlp_up, h), approximate="tanh")),
                ("lm_head", model.lm_head, h)):
            card = quant.int8_linear(layer, inp, torch.bfloat16).float()
            cpu = quant.int8_dot_general(
                inp.cpu(), layer.weight.detach().cpu().to(torch.bfloat16),
                out_dtype=torch.bfloat16).float()
            rel = ((card.cpu() - cpu).abs()
                   / cpu.abs().clamp_min(1e-30)).max().item()
            errs[name] = rel
            check(rel <= INT8_BF16_RTOL,
                  f"13d int8_dot_general {name}: card vs CPU rel {rel}")
    res["int8_dot_general_max_rel_err"] = errs
    # The stored weights: dequantized on the card and on the CPU.
    qparams = quant.quantize_params(model)
    qcpu = quant.quantize_params(model.to("cpu"))
    model.to(DEVICE)
    for name, leaf in qparams.items():
        if quant.is_qleaf(leaf):
            check(torch.equal(leaf["int8_q"].cpu(), qcpu[name]["int8_q"])
                  and torch.equal(leaf["scale"].cpu(), qcpu[name]["scale"]),
                  f"13d: {name} quantizes differently on the card")
    deq = quant.dequantize_params(qparams)
    deq_cpu = quant.dequantize_params(qcpu)
    check(all(torch.equal(deq[n].cpu(), deq_cpu[n]) for n in deq),
          "13d: dequantized weights differ between card and CPU")
    bf16_bytes = sum(p.numel() * 2 for p in model.parameters())
    res["quantized_bytes"] = quant.quantized_bytes(qparams)
    res["bf16_bytes"] = bf16_bytes
    # The int8 cache: the write's quantization and one step's attention, in
    # f32, card against CPU on the same int8 cache.
    qmodel = model.clone(quantized_cache=True, compute_dtype=torch.float32)
    with torch.inference_mode():
        _, cache = qmodel.decode(prompt.to(DEVICE),
                                 max_decode_len=PROMPT_LEN + 8)
        c0 = cache["Block_0"]
        gen = torch.Generator().manual_seed(3)
        hd = MODEL["d_model"] // MODEL["n_heads"]
        q, k, v = (torch.randn(BATCH, 1, MODEL["n_heads"], hd, generator=gen)
                   for _ in range(3))
        card_cache = {n: t.clone() for n, t in c0.items()}
        cpu_cache = {n: t.cpu().clone() for n, t in c0.items()}
        idx = torch.tensor(PROMPT_LEN, dtype=torch.int32)
        o_card = qmodel.blocks[0]._decode_attention(
            q.to(DEVICE), k.to(DEVICE), v.to(DEVICE), card_cache,
            idx.to(DEVICE), False)
        blk_cpu = qmodel.blocks[0]
        o_cpu = blk_cpu._decode_attention(q, k, v, cpu_cache, idx, False)
        for n in card_cache:
            check(torch.equal(card_cache[n].cpu(), cpu_cache[n]),
                  f"13d int8 cache: {n} written differently on the card")
        err = (o_card.cpu() - o_cpu).abs().max().item()
        check(err <= INT8_CACHE_ATOL,
              f"13d int8 cache attention: card vs CPU {err}")
    res["int8_cache_attention_max_abs_err"] = err
    # The generators with each knob (captured), top-1 agreement with bf16.
    agree, b1 = {}, {}
    for name, kw, params in (
            ("quantized", {"quantized": True}, qparams),
            ("quantized_cache", {"quantized_cache": True}, None),
            ("int8_compute", {"int8_compute": True}, None)):
        fa.launches = 0
        fn = make_generate_fn(model, max_new_tokens=DECODE_NEW,
                              include_prompt=False, **kw)
        toks = fn(prompt, params=params)
        again = fn(prompt, params=params)
        check(torch.equal(toks, again), f"13d {name}: replays differ")
        agree[name] = (toks == greedy).float().mean().item()
        b1[name] = fa.launches
    res["top1_agreement_with_bf16"] = agree
    res["b1_launches"] = b1
    log("decode_int8", json.dumps(res))
    return res


def decode_ring(torch, model, prompt):
    """13e: the ring cache, window 64 + 4 sinks, over 256 new tokens: its
    bytes stay constant, and every step's logits equal the full cache's
    under the same window + sinks mask (f32: the same weights through
    ``clone(compute_dtype=float32)``, teacher-forced on the ring's own
    greedy tokens)."""
    from horovod_tpu_torch.models.decoding import make_generate_fn
    from horovod_tpu_torch.ops import flash_attention as fa

    knobs = dict(window=RING_WINDOW, attention_sinks=RING_SINKS,
                 compute_dtype=torch.float32)
    full = model.clone(**knobs)
    ring = model.clone(sliding_cache=True, **knobs)
    fa.launches = 0
    fn = make_generate_fn(ring, max_new_tokens=RING_NEW,
                          include_prompt=False)
    toks, ms = _timed(torch, lambda: fn(prompt))
    toks, ms = _timed(torch, lambda: fn(prompt))
    prompt_d = prompt.to(DEVICE)

    def nbytes(cache):
        return sum(t.numel() * t.element_size() for k, v in cache.items()
                   if k != "index" for t in v.values())

    worst = 0.0
    with torch.inference_mode():
        fl, fc = full.decode(prompt_d, max_decode_len=PROMPT_LEN + RING_NEW)
        rl, rc = ring.decode(prompt_d, max_decode_len=PROMPT_LEN + RING_NEW)
        size0 = nbytes(rc)
        worst = (fl[:, -1] - rl[:, -1]).abs().max().item()
        for j in range(RING_NEW - 1):
            fl, fc = full.decode(toks[:, j:j + 1], fc)
            rl, rc = ring.decode(toks[:, j:j + 1], rc)
            worst = max(worst, (fl[:, -1] - rl[:, -1]).abs().max().item())
        check(nbytes(rc) == size0, "13e: the ring cache grew")
    check(worst <= RING_LOGITS_ATOL,
          f"13e: ring vs full-cache logits differ by {worst}")
    slots = RING_SINKS + RING_WINDOW
    res = {"window": RING_WINDOW, "sinks": RING_SINKS, "new": RING_NEW,
           "slots": slots, "cache_bytes": size0,
           "full_cache_bytes": nbytes(fc),
           "max_abs_logit_diff": worst, "ms": ms,
           "tokens_per_s": BATCH * RING_NEW / ms * 1e3,
           "steps": fn.steps.counts(), "b1_launches": fa.launches}
    log("decode_ring", json.dumps(res))
    return res


def _corpus(n_words=150000, lexicon=12000, seed=TOKENIZER_SEED):
    """Text for the tokenizer: Zipf-distributed draws from a seeded lexicon
    of random lower-case words."""
    import numpy as np

    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = ["".join(rng.choice(letters, rng.randint(2, 11)))
             for _ in range(lexicon)]
    ranks = np.minimum(rng.zipf(1.2, n_words), lexicon) - 1
    return [" ".join(words[r] for r in ranks[i:i + 200])
            for i in range(0, n_words, 200)]


def decode_bundle(torch, model):
    """13f: a bundle with a tokenizer (byte BPE trained to the model's 8192
    ids) and the int8 cache, streaming, served by ``make_server`` on the
    card: text in, text and tokens out, each equal to the bundle run on the
    prompt alone; and its speculative variant (γ 8) loaded and run on the
    same texts."""
    from horovod_tpu_torch.data.tokenizer import ByteBPETokenizer
    from horovod_tpu_torch.launch.serve import make_server
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.serving import export_generate, load_generate

    t0 = time.perf_counter()
    tok = ByteBPETokenizer.train(_corpus(), MODEL["vocab_size"],
                                 specials=("<eos>",))
    train_s = time.perf_counter() - t0
    check(tok.vocab_size == MODEL["vocab_size"],
          f"13f: tokenizer vocab {tok.vocab_size}")
    root = os.path.join(WORK, "decode_bundles")
    kw = dict(batch_size=BATCH, prompt_len=PROMPT_LEN,
              max_new_tokens=DECODE_NEW, tokenizer=tok, quantized_cache=True)
    served = export_generate(root, model, streaming_chunk=CHUNK,
                             timestamp="served", **kw)
    spec_dir = export_generate(root, model, speculative_gamma=SPEC_GAMMA,
                               timestamp="speculative", **kw)
    texts = [" ".join(_corpus(200, seed=s)[0].split()[:12]) for s in range(4)]
    server = make_server(served, port=0, device=DEVICE, continuous=True)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/v1/generate"
    fa.launches = 0
    try:
        lines, _, _ = _post(url, {"text": texts})
        stream, _, _ = _post(url, {"text": texts[:1], "stream": True})
    finally:
        server.shutdown()
        server.server_close()
        server.app.engine.stop()
        thread.join(timeout=30)
    b1_served = fa.launches
    reply = lines[-1]
    bundle = server.app.bundle
    for i, text in enumerate(texts):
        alone = bundle.generate_tokens([tok.encode(text)])[0]
        check(reply["tokens"][i] == alone,
              f"13f: served text {i} differs from the bundle run alone")
        check(reply["text"][i] == tok.decode(alone),
              f"13f: served text {i} is not the detokenized tokens")
    check(stream[-1].get("done") and stream[-1]["text"] == reply["text"][:1],
          "13f: the stream's final line lacks the text")
    spec = load_generate(spec_dir, device=DEVICE)
    spec_tokens = spec.generate_tokens([tok.encode(t) for t in texts])
    plain = load_generate(export_generate(root, model, timestamp="plain",
                                          **kw), device=DEVICE)
    plain_tokens = plain.generate_tokens([tok.encode(t) for t in texts])
    check(spec_tokens == plain_tokens,
          "13f: the speculative bundle differs from the plain int8-cache one")
    res = {"tokenizer_vocab": tok.vocab_size, "tokenizer_train_s": train_s,
           "prompt_tokens": [len(tok.encode(t)) for t in texts],
           "served_text_0": reply["text"][0][:80],
           "speculative_equals_plain": True, "b1_launches_served": b1_served}
    log("decode_bundle", json.dumps(res))
    return res


def decode_twin(torch):
    """13g: the twin of ``examples/lm_generate.py`` at its defaults (copy
    task, 4 × 48 steps, greedy, streamed, sampled, speculative); it asserts
    speculative == greedy itself."""
    env = dict(os.environ, PS_MODEL_PATH=os.path.join(WORK, "lm_generate"),
               STREAM="1")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.examples.lm_generate"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    with open(os.path.join(WORK, "lm_generate.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    check(proc.returncode == 0,
          f"13g: the twin failed: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    pick = {k: next((ln for ln in lines if ln.startswith(k)), None)
            for k in ("final train loss", "greedy recall", "streamed",
                      "speculative")}
    check(all(pick.values()), f"13g: missing lines {pick}")
    check("outputs identical: True" in pick["speculative"],
          "13g: the twin's speculative output differs from greedy")
    res = {"wall_s": wall, **pick}
    log("decode_twin", json.dumps(res))
    return res


def decode_phase(torch):
    """Phase 13: the decode family at the bench LM's width (bf16, random
    weights from seed 0, batch 8 × prompt 128); 13g, a launched check, runs
    in the checks' lane (`checks_lane`)."""
    from horovod_tpu_torch.models.transformer import TransformerLM

    t0 = time.perf_counter()
    model = TransformerLM(**MODEL, compute_dtype=torch.bfloat16,
                          device=DEVICE, seed=0)
    prompt = _prompt_batch(torch, 0)
    res, parts, last = {}, {}, [time.perf_counter()]

    def part(name, value):
        now = time.perf_counter()
        parts[name] = round(now - last[0], 1)
        last[0] = now
        return value

    res["generate"], toks = part("13a", decode_generate(torch, model, prompt))
    res["speculative"] = part("13b", decode_speculative(
        torch, model, prompt, toks["greedy"]))
    res["beam"] = part("13c", decode_beam(torch, model, prompt))
    res["int8"] = part("13d", decode_int8(torch, model, prompt,
                                          toks["greedy"]))
    res["ring"] = part("13e", decode_ring(torch, model, prompt))
    res["bundle"] = part("13f", decode_bundle(torch, model))
    res["window_sinks_prefill"] = part("time", window_sinks_timing(torch))
    log(f"decode phase seconds: {time.perf_counter() - t0:.1f}",
        json.dumps(parts))
    return res


def window_sinks_timing(torch):
    """B1 at the ring's windowed prefill shape (B8·T128·H8·D64, window 64,
    4 sinks, bf16, tc): kernel, plain version, SDPA with the same mask as
    an explicit boolean mask, and the card's bound over the kept pairs."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import flash_attention as fa

    b, t, h, d = BATCH, PROMPT_LEN, MODEL["n_heads"], \
        MODEL["d_model"] // MODEL["n_heads"]
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    masks = dict(causal=True, window=RING_WINDOW, sinks=RING_SINKS)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    r = torch.arange(t, device="cuda")
    keep = (r[None, :] <= r[:, None]) & (
        (r[None, :] > r[:, None] - RING_WINDOW) | (r[None, :] < RING_SINKS))
    with torch.inference_mode():
        ms = device_ms(torch, lambda: fa.flash_attention_with_lse(
            q, k, v, **masks))
        plain = device_ms(torch, lambda: fa.flash_attention_reference(
            q, k, v, **masks), 10)
        lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=keep))
        o = fa.flash_attention(q, k, v, **masks).float()
        ref = F.scaled_dot_product_attention(
            qh.float(), kh.float(), vh.float(), attn_mask=keep
        ).transpose(1, 2)
    err = (o - ref).abs().max().item()
    check(err <= TOL["bfloat16"]["o_atol"],
          f"B1 window+sinks against f32 SDPA: {err}")
    visible = int(keep.sum())
    nbytes = (2 * b * t * h * d + 2 * b * t * h * d) * 2 + b * t * h * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2.0 * 2 * b * h * d * visible / PEAK_FLOPS["bfloat16"] * 1e3
    res = {"shape": [b, t, h, d], "window": RING_WINDOW, "sinks": RING_SINKS,
           "route": fa._route(torch.bfloat16, d), "ms": ms,
           "plain_ms": plain, "library_ms": lib,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "max_abs_err_vs_sdpa_f32": err}
    log(f"time flash_fwd window_sinks B{b} T{t} H{h} D{d} window "
        f"{RING_WINDOW} sinks {RING_SINKS} bf16 [{res['route']}]: kernel_ms "
        f"{ms:.5f} plain_ms {plain:.5f} library_ms (sdpa, bool mask) "
        f"{lib:.5f} bound_ms {res['bound_ms']:.5f} ({res['bound_by']})")
    return res


# -- phase 14 ---------------------------------------------------------------

# The serving tier at the bench LM's width: phase 4's batch 8 × prompt 128,
# 64 new tokens (chunk 16 where streaming), bf16, seeded random weights.
TIER_REQUESTS = 24  # (a): concurrent single-row ragged requests
# (c): a seeded f32 MnistCNN exported at batch 16. The tf1 twin exports at
# the reference's input_shape (1, 28, 28, 1): a batch of one, where rows
# cannot coalesce.
PREDICT_BATCH, PREDICT_CLIENTS = 16, 64
AB_REQUESTS = 48  # (d): streaming requests a mode, bench.py's count
RELOAD_CLIENTS, RELOAD_PROMPTS = 4, 8  # (f)
ROUTER_REQUESTS, DRAIN_REQUESTS = 16, 16  # (g), (h)
REPLICA_START_S = 180


@contextlib.contextmanager
def _served(bundle_dir, **kw):
    """``make_server`` on the card, serving from a thread; on exit the
    server and its device worker (or scheduler) are stopped, so no other
    thread touches the card afterwards."""
    from horovod_tpu_torch.launch.serve import make_server

    server = make_server(bundle_dir, port=0, device=DEVICE, **kw)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server, f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        server.app.close()
        thread.join(timeout=30)


def _request(url, payload, timeout=300):
    """POST JSON; ``(code, body)`` for any status, the body parsed (NDJSON
    as a list of lines)."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            code, raw = resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        code, raw = e.code, e.read().decode()
    lines = [json.loads(ln) for ln in raw.splitlines() if ln.strip()]
    return code, lines[0] if len(lines) == 1 else lines


def _get_json(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def _scrape(url):
    from horovod_tpu_torch.obs import prom

    with urllib.request.urlopen(f"{url}/metrics", timeout=60) as resp:
        return prom.parse_text(resp.read().decode())


def _tier_prompts(n, seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    lengths = [1, PROMPT_LEN] + list(rng.randint(1, PROMPT_LEN + 1, n - 2))
    return [rng.randint(0, MODEL["vocab_size"], k).tolist()
            for k in lengths[:n]]


def _in_parallel(fn, args):
    with concurrent.futures.ThreadPoolExecutor(len(args)) as pool:
        return list(pool.map(fn, args))


def _pct(values, q):
    values = sorted(values)
    return values[min(len(values) - 1, int(q * len(values)))]


def _solo(torch, bundle_dir, prompts):
    """Each prompt's tokens from the bundle run on it alone, on this
    thread (no server runs meanwhile)."""
    from horovod_tpu_torch.serving import load_generate

    bundle = load_generate(bundle_dir, device=DEVICE)
    out = [bundle.generate_batch([p])[0] for p in prompts]
    bundle.release_graphs()
    return out


def tier_coalesced(torch, dirs, prompts):
    """14a + 14e: 24 concurrent single-row ragged requests to the default
    (coalescing) server over a greedy one-shot bundle; then its /metrics."""
    from horovod_tpu_torch.ops import flash_attention as fa

    with _served(dirs["greedy"]) as (server, url):
        app = server.app
        check(_request(f"{url}/v1/generate", {"prompt": [[1, 2, 3]]})[0]
              == 200, "14a: warm-up request failed")
        calls0 = app.stats["device_calls"]
        fa.launches = fa.launches_tc = 0
        t0 = time.perf_counter()
        replies = _in_parallel(
            lambda p: _request(f"{url}/v1/generate", {"prompt": [p]}),
            prompts)
        wall = time.perf_counter() - t0
        launches, launches_tc = fa.launches, fa.launches_tc
        calls = app.stats["device_calls"] - calls0
        stats = dict(app.stats)
        metrics = _scrape(url)
    solo = _solo(torch, dirs["greedy"], prompts)
    for i, (code, body) in enumerate(replies):
        check(code == 200, f"14a: request {i}: HTTP {code} {body}")
        check(body["tokens"] == [solo[i]],
              f"14a: request {i} (len {len(prompts[i])}) differs from the "
              "bundle run on it alone")
    check(calls <= len(prompts) // 2,
          f"14a: {calls} device calls for {len(prompts)} requests")
    check(launches == MODEL["n_layers"] * calls and launches > 0,
          f"14a: B1 launches {launches} != n_layers × prefill dispatches "
          f"({MODEL['n_layers']} × {calls})")
    check(launches_tc == launches,
          f"14a: {launches_tc} of {launches} B1 launches on tc")
    sent = len(prompts) + 1  # and the warm-up
    ok = 'hvt_serve_requests_total{route="/v1/generate",code="200"}'
    check(metrics.get(ok) == sent, f"14e: {ok} = {metrics.get(ok)}, "
          f"sent {sent}")
    check(metrics.get("hvt_serve_ttft_seconds_count") == sent,
          f"14e: TTFT count {metrics.get('hvt_serve_ttft_seconds_count')}")
    check(metrics.get("hvt_serve_device_calls_total")
          == stats["device_calls"],
          f"14e: device calls {metrics.get('hvt_serve_device_calls_total')}"
          f" vs app.stats {stats['device_calls']}")
    check(not any('code="500"' in k and v for k, v in metrics.items()),
          "14e: 500s in /metrics")
    return solo, {
        "requests": len(prompts), "device_calls": calls, "wall_s": wall,
        "requests_per_s": len(prompts) / wall,
        "tokens_per_s": len(prompts) * NEW_TOKENS / wall,
        "b1_launches": launches, "b1_launches_tc": launches_tc,
        "metrics_requests_200": metrics[ok],
        "metrics_ttft_count": metrics["hvt_serve_ttft_seconds_count"],
        "metrics_ttft_sum_s": metrics["hvt_serve_ttft_seconds_sum"],
    }


def tier_speculative(torch, dirs, prompts, solo):
    """14b: a speculative bundle (γ 8, prompt lookup) over HTTP: the 24
    prompts in one request (three batches) equal greedy's tokens."""
    from horovod_tpu_torch.ops import flash_attention as fa

    with _served(dirs["speculative"]) as (server, url):
        fa.launches = 0
        t0 = time.perf_counter()
        code, body = _request(f"{url}/v1/generate", {"prompt": prompts})
        wall = time.perf_counter() - t0
        launches = fa.launches
        calls = server.app.stats["device_calls"]
    check(code == 200, f"14b: HTTP {code} {body}")
    check(body["tokens"] == solo, "14b: the speculative bundle's tokens "
          "differ from the greedy bundle's")
    return {"rows": len(prompts), "device_calls": calls, "wall_s": wall,
            "b1_launches": launches}


def tier_predict(torch, dirs):
    """14c: 64 concurrent single-row clients on a predict bundle, coalesced
    and serialized; each prob equals the program on that row padded to the
    batch alone, bit for bit."""
    import numpy as np

    from horovod_tpu_torch import checkpoint

    x = np.random.RandomState(4).rand(PREDICT_CLIENTS, 28, 28, 1).astype(
        np.float32)
    res = {}
    for mode, coalesce in (("coalesced", True), ("serialized", False)):
        with _served(dirs["predict"], coalesce=coalesce) as (server, url):
            check(_request(f"{url}/v1/predict",
                           {"input": x[:1].tolist()})[0] == 200,
                  "14c: warm-up request failed")
            calls0 = server.app.stats["device_calls"]
            t0 = time.perf_counter()
            replies = _in_parallel(
                lambda i: _request(f"{url}/v1/predict",
                                   {"input": x[i:i + 1].tolist()}),
                range(PREDICT_CLIENTS))
            wall = time.perf_counter() - t0
            calls = server.app.stats["device_calls"] - calls0
        for i, (code, body) in enumerate(replies):
            check(code == 200, f"14c {mode}: client {i}: HTTP {code} {body}")
        res[mode] = {"requests_per_s": PREDICT_CLIENTS / wall,
                     "wall_s": wall, "device_calls": calls,
                     "device_calls_per_request": calls / PREDICT_CLIENTS,
                     "probs": np.asarray([b["prob"][0] for _, b in replies],
                                         np.float32)}
    fn = checkpoint.load_serving(dirs["predict"], device=DEVICE)
    alone = np.stack([fn(np.repeat(x[i:i + 1], PREDICT_BATCH, 0))[0]
                      for i in range(PREDICT_CLIENTS)])
    for mode in res:
        probs = res[mode].pop("probs")
        err = float(np.abs(probs - alone).max())
        res[mode]["max_abs_err_vs_alone"] = err
        check(err == 0.0, f"14c {mode}: prob differs from the row padded "
              f"alone by {err}")
    check(res["serialized"]["device_calls"] == PREDICT_CLIENTS,
          f"14c: serialized made {res['serialized']['device_calls']} calls")
    check(res["coalesced"]["device_calls"] < PREDICT_CLIENTS,
          f"14c: coalesced made {res['coalesced']['device_calls']} calls")
    res["batch"] = PREDICT_BATCH
    return res


def _one_stream(url, prompt):
    """One streaming request: (TTFT s, TPOT s, tokens) on the client's
    clock — TPOT is the decode tail past the first chunk, per token."""
    req = urllib.request.Request(
        f"{url}/v1/generate",
        data=json.dumps({"prompt": [prompt], "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    t_start = time.perf_counter()
    ttft, lines = None, []
    with urllib.request.urlopen(req, timeout=300) as resp:
        check(resp.status == 200, f"14d: HTTP {resp.status}")
        for raw in resp:
            if ttft is None:
                ttft = time.perf_counter() - t_start
            lines.append(json.loads(raw))
    total = time.perf_counter() - t_start
    check(lines and lines[-1].get("done"), f"14d: stream died: {lines[-1:]}")
    tokens = lines[-1]["tokens"][0]
    return ttft, (total - ttft) / max(1, len(tokens) - CHUNK), tokens


def tier_ab(torch, dirs):
    """14d: bench.py's serving A/B at the bench LM's width — 48 streaming
    requests on one open-loop schedule at twice the coalescing path's solo
    rate, through both modes. Information, not a gate."""
    from horovod_tpu_torch.ops import flash_attention as fa

    prompts = _tier_prompts(AB_REQUESTS, 2)
    with _served(dirs["stream"]) as (_, url):
        _one_stream(url, prompts[0])
        t0 = time.perf_counter()
        for p in prompts[:4]:
            _one_stream(url, p)
        solo_s = (time.perf_counter() - t0) / 4
    gap = solo_s / 2.0
    res = {"requests": AB_REQUESTS, "solo_request_s": solo_s,
           "offered_requests_per_s": 1.0 / gap}
    for mode, continuous in (("coalescing", False), ("continuous", True)):
        with _served(dirs["stream"], continuous=continuous) as (server, url):
            for p in prompts[:2]:
                _one_stream(url, p)
            app = server.app

            def calls():
                return (app.engine.stats()["device_calls_total"]
                        if continuous else app.stats["device_calls"])

            calls0 = calls()
            fa.launches = 0
            results = [None] * AB_REQUESTS
            t_begin = time.perf_counter() + 0.05

            def client(i):
                # Open loop: fire at the scheduled time, late or not.
                delay = t_begin + i * gap - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                results[i] = _one_stream(url, prompts[i])

            t0 = time.perf_counter()
            _in_parallel(client, range(AB_REQUESTS))
            elapsed = time.perf_counter() - t0
            n_calls, launches = calls() - calls0, fa.launches
        ttft = [r[0] for r in results]
        tpot = [r[1] for r in results]
        check(all(len(r[2]) == NEW_TOKENS for r in results),
              f"14d {mode}: a stream ended short")
        res[mode] = {
            "ttft_p50_s": _pct(ttft, 0.5), "ttft_p95_s": _pct(ttft, 0.95),
            "tpot_p50_s": _pct(tpot, 0.5), "tpot_p95_s": _pct(tpot, 0.95),
            "device_calls": n_calls, "elapsed_s": elapsed,
            "tokens_per_s": AB_REQUESTS * NEW_TOKENS / elapsed,
            "b1_launches": launches,
        }
        res[f"{mode}_tokens"] = [r[2] for r in results]
    same = sum(a == b for a, b in zip(res.pop("coalescing_tokens"),
                                      res.pop("continuous_tokens")))
    res["same_tokens_both_modes"] = f"{same}/{AB_REQUESTS}"
    return res


def tier_reload(torch, dirs):
    """14f: /admin/reload from the seed-0 bundle to the seed-1 bundle under
    four clients' traffic, in both modes: every reply 200 and one bundle's
    solo tokens for its prompt, every reply sent after the swap returned
    the new bundle's."""
    prompts = _tier_prompts(RELOAD_PROMPTS, 3)
    res = {}
    for mode, a, b in (("coalescing", "greedy", "greedy_b"),
                       ("continuous", "stream", "stream_b")):
        solo_a = _solo(torch, dirs[a], prompts)
        solo_b = _solo(torch, dirs[b], prompts)
        check(solo_a != solo_b, f"14f: the {a} and {b} bundles agree")
        replies, stop, swapped = [], threading.Event(), threading.Event()
        with _served(dirs[a], continuous=mode == "continuous",
                     allow_reload=True) as (server, url):

            def client(k):
                i = k
                while not stop.is_set():
                    i = (i + 1) % len(prompts)
                    after = swapped.is_set()
                    code, body = _request(f"{url}/v1/generate",
                                          {"prompt": [prompts[i]]})
                    replies.append((after, i, code, body))

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(RELOAD_CLIENTS)]
            for t in threads:
                t.start()
            time.sleep(1.0)
            t0 = time.perf_counter()
            code, body = _request(f"{url}/admin/reload",
                                  {"bundle_dir": dirs[b]})
            swap_s = time.perf_counter() - t0
            swapped.set()
            time.sleep(1.0)
            stop.set()
            for t in threads:
                t.join(timeout=120)
            check(not any(t.is_alive() for t in threads),
                  "14f: a client is stuck")
        check(code == 200, f"14f {mode}: reload HTTP {code} {body}")
        before = sum(1 for r in replies if not r[0])
        for after, i, rcode, rbody in replies:
            check(rcode == 200, f"14f {mode}: HTTP {rcode} {rbody}")
            got = rbody["tokens"][0]
            check(got == solo_b[i] if after else got in (solo_a[i],
                                                         solo_b[i]),
                  f"14f {mode}: a reply {'after' if after else 'around'} "
                  "the swap is neither bundle's solo tokens")
        check(before and len(replies) > before,
              f"14f {mode}: no traffic on one side of the swap")
        res[mode] = {"swap_s": swap_s, "replies": len(replies),
                     "replies_sent_after_swap": len(replies) - before}
    return res


def _launch_replica(bundle_dir, name):
    """``python -m horovod_tpu_torch.launch.serve`` on the card, started;
    `_replica_url` waits for its address."""
    with open(os.path.join(WORK, f"{name}.log"), "w") as log_f:
        return subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.launch.serve",
             bundle_dir, "--port", "0", "--host", "127.0.0.1"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=log_f, text=True)


def _replica_url(proc, name):
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        line = pool.submit(proc.stdout.readline).result(
            timeout=REPLICA_START_S)
    check("serving" in line, f"14g: replica {name} did not start: {line!r}")
    return line.split(" on ")[1].split()[0]


def tier_router(torch, dirs, prompts, solo):
    """14g + 14h: the router (this process, no device work) in front of two
    launched replica processes sharing the card; then SIGTERM to each
    replica mid-traffic."""
    from horovod_tpu_torch.serving.router import ReplicaSet, make_router

    procs, res = [], {}
    try:
        # Both start together (each takes seconds to reach the card).
        for k in range(2):
            procs.append(_launch_replica(dirs["greedy"], f"replica{k}"))
        urls = [_replica_url(p, f"replica{k}") for k, p in enumerate(procs)]
        for u in urls:  # warm-up: the first request captures the graphs
            check(_request(f"{u}/v1/generate", {"prompt": [[1, 2]]})[0]
                  == 200, "14g: replica warm-up failed")
        rs = ReplicaSet()
        for k, u in enumerate(urls):
            rs.add(f"r{k}", u)
        router = make_router(port=0, replicas=rs)
        thread = threading.Thread(target=router.serve_forever, daemon=True)
        thread.start()
        rurl = f"http://127.0.0.1:{router.server_address[1]}"

        def rows():
            return [_get_json(f"{u}/healthz")["stats"]["rows"] for u in urls]

        try:
            rows0 = rows()
            idx = list(range(ROUTER_REQUESTS))
            replies = _in_parallel(
                lambda i: _request(f"{rurl}/v1/generate",
                                   {"prompt": [prompts[i]]}), idx)
            rows1 = rows()
            rs.drain("r0")
            drained = [_request(f"{rurl}/v1/generate",
                                {"prompt": [prompts[i]]}) for i in range(4)]
            rows2 = rows()
            metrics = _scrape(rurl)
        finally:
            router.shutdown()
            router.server_close()
            thread.join(timeout=30)
        for i, (code, body) in zip(idx + list(range(4)), replies + drained):
            check(code == 200, f"14g: HTTP {code} {body}")
            check(body["tokens"] == [solo[i]],
                  f"14g: request {i} through the router differs from solo")
        spread = [b - a for a, b in zip(rows0, rows1)]
        check(all(s > 0 for s in spread), f"14g: no spread: {spread}")
        check(rows2[0] == rows1[0] and rows2[1] == rows1[1] + 4,
              f"14g: the drained replica got traffic: {rows1} -> {rows2}")
        bad = 'hvt_serve_requests_total{route="/v1/generate",code="500"}'
        check(metrics.get(bad) == 0, f"14g: {bad} = {metrics.get(bad)}")
        res["router"] = {"requests": ROUTER_REQUESTS, "spread": spread,
                         "drained_rows_unchanged": True,
                         "code_500": metrics[bad]}
        # 14h: SIGTERM each replica with requests in flight.
        for k, (proc, u) in enumerate(zip(procs, urls)):
            pool = concurrent.futures.ThreadPoolExecutor(DRAIN_REQUESTS)
            futs = [pool.submit(_request, f"{u}/v1/generate",
                                {"prompt": [prompts[i]]})
                    for i in range(DRAIN_REQUESTS)]
            deadline = time.monotonic() + 60
            seen = 0
            while seen < 4 and time.monotonic() < deadline:
                seen = _get_json(f"{u}/healthz")["inflight"]
            check(seen >= 4, f"14h: replica {k}: inflight {seen}")
            proc.send_signal(signal.SIGTERM)
            t0 = time.perf_counter()
            done = [f.result(timeout=120) for f in futs]
            pool.shutdown()
            code = proc.wait(timeout=120)
            res[f"sigterm_replica{k}"] = {
                "inflight_at_signal": seen, "exit_code": code,
                "drain_to_exit_s": time.perf_counter() - t0}
            check(code == 0, f"14h: replica {k} exited {code}")
            for i, (rcode, body) in enumerate(done):
                check(rcode == 200 and body["tokens"] == [solo[i]],
                      f"14h: replica {k}: request {i} HTTP {rcode}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
            proc.stdout.close()
    return res


def serve_tier(torch, card):
    """Phase 14: the serving tier at the bench LM's width."""
    from horovod_tpu_torch import checkpoint
    from horovod_tpu_torch.models.cnn import MnistCNN
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.serving import export_generate

    t_start = time.perf_counter()
    root = os.path.join(WORK, "serve_tier")
    kw = dict(batch_size=BATCH, prompt_len=PROMPT_LEN,
              max_new_tokens=NEW_TOKENS)
    dirs = {}
    for seed, suffix in ((0, ""), (1, "_b")):
        model = TransformerLM(**MODEL, compute_dtype=torch.bfloat16,
                              device=DEVICE, seed=seed)
        dirs["greedy" + suffix] = export_generate(
            root, model, timestamp="greedy" + suffix, **kw)
        dirs["stream" + suffix] = export_generate(
            root, model, streaming_chunk=CHUNK, timestamp="stream" + suffix,
            **kw)
        if seed == 0:
            dirs["speculative"] = export_generate(
                root, model, speculative_gamma=SPEC_GAMMA,
                timestamp="speculative", **kw)
        del model
    dirs["predict"] = checkpoint.export_serving(
        os.path.join(root, "predict"), MnistCNN(device=DEVICE, seed=0),
        input_shape=(PREDICT_BATCH, 28, 28, 1), timestamp="predict")
    prompts = _tier_prompts(TIER_REQUESTS, 1)
    res = {"card": card}
    steps = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        steps[name] = time.perf_counter() - t0
        return out

    solo, res["coalesced"] = timed("a_e", tier_coalesced, torch, dirs,
                                   prompts)
    res["speculative"] = timed("b", tier_speculative, torch, dirs, prompts,
                               solo)
    res["predict"] = timed("c", tier_predict, torch, dirs)
    res["ab"] = timed("d", tier_ab, torch, dirs)
    res["reload"] = timed("f", tier_reload, torch, dirs)
    res.update(timed("g_h", tier_router, torch, dirs, prompts, solo))
    res["step_seconds"] = steps
    res["seconds"] = time.perf_counter() - t_start
    log("serve_tier", json.dumps(res))
    log(f"serve tier phase seconds: {res['seconds']:.1f}")
    return res


# -- phase 15 -------------------------------------------------------------------

# Launched at N ranks by reduction_phase: 15a (the collectives on the card,
# SMOKE_15A set) and 15b (the bench LM's runs named in SMOKE_RUNS). Each
# rank prints its JSON lines; rank 0's carry the figures.
REDUCTION_CHILD = r"""
import gc, json, os, statistics, time
import numpy as np
import torch
import chip_smoke as cs
import horovod_tpu_torch as ht
from horovod_tpu_torch import callbacks, checkpoint, runtime
from horovod_tpu_torch.data.datasets import copy_task
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import collectives as c

# SMOKE_DEVICE / SMOKE_MODEL / SMOKE_SEQ rehearse this child on the CPU at a
# tiny size; the smoke itself runs it on the card at the bench LM's width.
ht.init(device=os.environ.get("SMOKE_DEVICE") or "cuda")
r, n = ht.rank(), ht.size()
dev = runtime.device()
cuda = dev.type == "cuda"
MODEL = json.loads(os.environ.get("SMOKE_MODEL") or "null") or cs.MODEL
SEQ = int(os.environ.get("SMOKE_SEQ") or cs.TRAIN_SEQ)


def sync():
    if cuda:
        torch.cuda.synchronize()


def emit(name, obj):
    print(name, json.dumps(obj), flush=True)


def ulp(t):
    return float(np.spacing(np.float32(t.abs().max().item())))


if os.environ.get("SMOKE_15A"):
    out = {}
    for w, wd in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        g = torch.Generator().manual_seed(100 + r)
        v = torch.randn(1 << 20, generator=g) * (1 + r)
        tot_d, err_d = c.quantized_group_sum(v.to(dev), wd)
        tot_h, err_h = c.quantized_group_sum(v, wd)
        diff = (tot_d.cpu() - tot_h).abs().max().item()
        vs = c.all_gather_tensor(v.to(dev)).double().sum(0)
        errs = c.all_gather_tensor(err_d).double().sum(0)
        mass = (errs - (vs - tot_d.double())).abs().max().item()
        out[w] = {"card_vs_cpu_max_abs": diff, "ulp_of_sum": ulp(tot_h),
                  "err_card_vs_cpu_max_abs":
                      (err_d.cpu() - err_h).abs().max().item(),
                  "mass_identity_max_abs": mass,
                  "mass_bound": cs.REDUCTION_MASS_RTOL
                  * c.all_gather_tensor(v.abs().max()).max().item()}
    g = torch.Generator().manual_seed(200 + r)
    tree = {"w": torch.randn(1024, 96, generator=g),
            "b": torch.randn(95, generator=g),
            "k": torch.randn(8, 3, 64, generator=g)}
    tree = {k: t.to(dev) for k, t in tree.items()}
    for name, wire in (("f32", None), ("bf16", torch.bfloat16)):
        dense = c.reduce_gradients(tree, wire_dtype=wire, bucket_bytes=1 << 16,
                                   reverse=True)
        scat = c.reduce_gradients(tree, wire_dtype=wire, bucket_bytes=1 << 16,
                                  reverse=True, scatter=n)
        cut = c.slice_zero1_local(dense, n)
        out[f"scatter_{name}_equal"] = all(
            torch.equal(scat[k], cut[k]) for k in tree)
    # The optimizer's int8 reduction (what 15b trains through) on the card
    # against the same on the CPU, whose arithmetic the CPU tests hold to
    # the JAX package's: two steps from a nonzero residual, several
    # buckets; the delivered gradients and the residual.
    got = {}
    for where in (dev, torch.device("cpu")):
        g = torch.Generator().manual_seed(300 + r)
        params = [torch.nn.Parameter(torch.zeros(s, device=where))
                  for s in ((1024, 96), (95,), (8, 3, 64))]
        opt = ht.DistributedOptimizer(torch.optim.SGD(params, lr=1.0),
                                      compression="int8")
        opt.bucket_bytes = 1 << 16
        for v in opt.residual:
            v.copy_(torch.randn(v.shape, generator=g) * 0.02)
        outs = []
        for t in range(2):
            for p in params:
                p.grad = torch.randn(p.shape, generator=g).to(where)
            opt.reduce_gradients()
            # Copies: on the CPU `.cpu()` would alias the live residual.
            outs += [p.grad.to("cpu", copy=True) for p in params]
            outs += [v.to("cpu", copy=True) for v in opt.residual]
        got[where.type] = torch.cat([o.reshape(-1) for o in outs])
    mag = 6.0  # |N(0, 1)| draws of this size stay below 6
    gap = (got[dev.type].double() - got["cpu"].double()).abs()
    off = gap > 4 * float(np.spacing(np.float32(mag * n)))
    out["ef_card_vs_cpu"] = {
        "elements": gap.numel(), "flips": int(off.sum()),
        "flip_max_abs": float(gap[off].max()) if off.any() else 0.0,
        "quantum": mag * n / 127.0}
    emit("phase15a", out)


class Clock(callbacks.Callback):
    def on_train_begin(self, logs=None):
        self.t, self.losses, self.first_step_bytes = [], [], None
        sync()
        self.t.append(time.perf_counter())

    def on_batch_end(self, batch, logs=None):
        self.losses.append(float(logs["loss"]))
        sync()
        self.t.append(time.perf_counter())
        if self.first_step_bytes is None:
            self.first_step_bytes = dict(c.traffic)


def draw(x, y, rng):
    while True:
        idx = rng.randint(0, len(x), size=cs.REDUCTION_ROWS)
        yield x[idx], y[idx]


RUNS = {
    "i_f32": dict(compression="none"),
    "i_f32_overlap": dict(compression="none", overlap_reduction=True),
    "ii_int8": dict(compression="int8"),
    "iii_int8_zero1_overlap": dict(compression="int8", shard_update=True,
                                   overlap_reduction=True),
    "iii_int8_zero1": dict(compression="int8", shard_update=True,
                           overlap_reduction=False),
    "iv_fp8_zero1": dict(compression="fp8", shard_update=True),
    "v_int8_ici_int8_zero1": dict(compression="int8", compression_ici="int8",
                                  shard_update=True),
}
def state_leaves(trainer):
    # The model's and the optimizer's state as CPU leaves, in order.
    leaves, _ = c.tree_flatten([dict(trainer.module.state_dict()),
                                trainer.tx.state_dict()])
    return [l.detach().cpu().clone() if isinstance(l, torch.Tensor) else l
            for l in leaves]


def leaf_diffs(a, b, limit=6):
    # Where two state_leaves lists differ: (index, what) pairs.
    if len(a) != len(b):
        return [("count", len(a), len(b))]
    out = []
    for i, (u, v) in enumerate(zip(a, b)):
        if isinstance(u, torch.Tensor) and isinstance(v, torch.Tensor):
            if u.shape != v.shape or u.dtype != v.dtype:
                out.append((i, str(tuple(u.shape)), str(tuple(v.shape))))
            elif not torch.equal(u, v):
                out.append((i, str(tuple(u.shape)),
                            (u.double() - v.double()).abs().max().item()))
        elif repr(u) != repr(v):
            out.append((i, repr(u)[:60], repr(v)[:60]))
        if len(out) >= limit:
            break
    return out


x, y = copy_task(4096, SEQ, MODEL["vocab_size"])
names = [k for k in os.environ.get("SMOKE_RUNS", "").split(",") if k]
n_params = None
reference = None
for name in names:
    cfg = dict(RUNS[name])
    shard = cfg.pop("shard_update", False)
    overlap = cfg.pop("overlap_reduction", False)
    model = TransformerLM(**MODEL, compute_dtype=torch.bfloat16,
                          fused_head_chunks=8, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    tx = ht.DistributedOptimizer(ht.adamw(ht.scale_lr(3e-4)),
                                 backward_passes_per_step=cs.REDUCTION_K,
                                 **cfg)
    trainer = ht.Trainer(model, tx, loss="module", seed=0, device=dev,
                         shard_update=shard, overlap_reduction=overlap)
    clock = Clock()
    feed = draw(x, y, np.random.RandomState(r))
    sync()
    # Earlier runs leave memory allocated (caches the kernels' wrappers
    # keep): a run's own peak is its peak above what it started with.
    base_bytes = torch.cuda.memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    fa.launches_tc = fa.launches_bwd_dq_tc = fa.launches_bwd_dkv_tc = 0
    c.traffic.update(bytes=0, calls=0)
    trainer.fit(dataset=feed, epochs=1, steps_per_epoch=cs.REDUCTION_STEPS,
                callbacks=[clock], verbose=0)
    launches = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.launches_bwd_dq,
                "flash_bwd_dkv": fa.launches_bwd_dkv,
                "flash_fwd_tc": fa.launches_tc,
                "flash_bwd_dq_tc": fa.launches_bwd_dq_tc,
                "flash_bwd_dkv_tc": fa.launches_bwd_dkv_tc}
    runner = trainer._runner
    steps_ms = [(b - a) * 1e3 for a, b in zip(clock.t, clock.t[1:])]
    res = {
        "run": name, "ranks": n, "backend": runtime.backend(),
        "compression": cfg.get("compression"),
        "compression_ici": cfg.get("compression_ici", "none"),
        "shard_update": shard, "overlap_reduction": overlap,
        "dcn": tx.dcn, "losses": clock.losses,
        "step_ms_median": statistics.median(steps_ms[2:]),
        "step_ms_min": min(steps_ms[2:]), "step_ms_max": max(steps_ms[2:]),
        "wire_bytes_per_step": clock.first_step_bytes["bytes"],
        "collectives_per_step": clock.first_step_bytes["calls"],
        "params": n_params,
        "wire_bytes_per_param": clock.first_step_bytes["bytes"] / n_params,
        "optimizer_state_bytes": tx.state_bytes(),
        "residual_bytes": tx.residual_bytes(),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated() - base_bytes
                              if cuda else "not measured"),
        "allocated_before_bytes": base_bytes,
        "launches": launches, "eager_steps": runner.eager_steps,
        "captures": runner.captures, "replays": runner.replays,
        "digest": checkpoint.state_digest(trainer.state),
    }
    if name == "ii_int8":
        reference = state_leaves(trainer)
    elif name.startswith("iii_") and reference is not None:
        res["differs_from_ii"] = leaf_diffs(reference,
                                            state_leaves(trainer))
    emit("phase15b", res)
    del trainer, model, tx, runner
    gc.collect()  # the optimizer's grad hooks make a cycle with the model
    if cuda:
        torch.cuda.empty_cache()
ht.shutdown()
"""


def _phase15_lines(lines, prefix, nprocs):
    out = {}
    for rank in range(nprocs):
        tag = f"[rank {rank}] {prefix} "
        out[rank] = [json.loads(line[len(tag):]) for line in lines
                     if line.startswith(tag)]
    return out


def reduction_runs(torch, card, nprocs, runs, backend, with_15a=False,
                   dcn=None):
    """15a (``with_15a``) and 15b's ``runs`` in one launch at ``nprocs``
    ranks on ``backend``; checks the gates and returns rank 0's figures."""
    knobs = {"SMOKE_RUNS": ",".join(runs)}
    if backend == "gloo":
        knobs["HVT_BACKEND"] = "gloo"
    if with_15a:
        knobs["SMOKE_15A"] = "1"
    if dcn:
        knobs["HVT_DCN_FACTOR"] = str(dcn)
    lines, wall, _, _ = _launch(f"reduction_{nprocs}_{backend}", nprocs,
                                None, knobs, code=REDUCTION_CHILD,
                                timeout=900)
    res = {"wall_s": wall, "card": card}
    if with_15a:
        a = _phase15_lines(lines, "phase15a", nprocs)[0][0]
        for w in ("int8", "fp8"):
            f = a[w]
            check(f["card_vs_cpu_max_abs"] <= f["ulp_of_sum"],
                  f"15a: {w} quantized sum on the card differs from the "
                  f"CPU's by {f['card_vs_cpu_max_abs']} > {f['ulp_of_sum']}")
            check(f["mass_identity_max_abs"] <= f["mass_bound"],
                  f"15a: {w} error mass off by {f['mass_identity_max_abs']}")
        for w in ("f32", "bf16"):
            check(a[f"scatter_{w}_equal"],
                  f"15a: the {w} scatter reduction differs from the dense "
                  "one cut locally")
        ef = a["ef_card_vs_cpu"]
        check(ef["flips"] <= REDUCTION_EF_MAX_FLIPS
              and ef["flip_max_abs"] <= ef["quantum"],
              f"15a: the optimizer's int8 reduction on the card differs "
              f"from the CPU's beyond four ulps at {ef['flips']} of "
              f"{ef['elements']} elements (at most {REDUCTION_EF_MAX_FLIPS},"
              f" each within a quantum {ef['quantum']}; largest "
              f"{ef['flip_max_abs']})")
        res["15a"] = a
        log("phase15a", json.dumps(dict(a, card=card)))
    b = _phase15_lines(lines, "phase15b", nprocs)
    check(all(len(b[k]) == len(runs) for k in b),
          f"15b: {[len(v) for v in b.values()]} run records, want "
          f"{len(runs)} a rank")
    by = {rec["run"]: rec for rec in b[0]}
    ref = by.get("i_f32")
    for i, name in enumerate(runs):
        rec = by[name]
        if ref is not None and name != "i_f32":
            gap = max(abs(a - b) / b
                      for a, b in zip(rec["losses"], ref["losses"]))
            rec["loss_gap_rel_to_f32"] = gap
            check(gap <= REDUCTION_LOSS_RTOL,
                  f"15b {name}: loss {gap:.4g} of the f32 control's away, "
                  f"bound {REDUCTION_LOSS_RTOL}")
        digests = {b[k][i]["digest"] for k in b}
        check(len(digests) == 1, f"15b {name}: the ranks' states differ")
        losses = rec["losses"]
        check(len(losses) == REDUCTION_STEPS
              and all(map(math.isfinite, losses)),
              f"15b {name}: losses {losses}")
        check(losses[-1] < losses[0],
              f"15b {name}: loss did not fall: {losses[0]} → {losses[-1]}")
        want = MODEL["n_layers"] * REDUCTION_K * (rec["eager_steps"]
                                                  + rec["captures"])
        for kname, count in rec["launches"].items():
            check(count == want, f"15b {name}: {kname} launched {count} "
                  f"times, want n_layers × K × (eager steps + captures) = "
                  f"{want}, all on the tensor-core route")
        check(rec["replays"] == REDUCTION_STEPS - 1,
              f"15b {name}: {rec['replays']} replays")
        log("phase15b", json.dumps(dict(
            {k: v for k, v in rec.items() if k != "digest"},
            digest=rec["digest"][:16], card=card)))
    if "i_f32_overlap" in by:
        check(by["i_f32_overlap"]["digest"] == by["i_f32"]["digest"],
              "15b i_f32_overlap: the overlapped f32 reduction's state "
              "differs from the serialized one's")
    for name in runs:
        if name.startswith("iii_"):
            check(by[name]["digest"] == by["ii_int8"]["digest"],
                  f"15b {name}: ZeRO-1 state differs from the replicated "
                  "int8 run's (parameters, gathered optimizer state, "
                  "residual rows): "
                  f"{by[name].get('differs_from_ii')}")
    res["runs"] = by
    return res


def _twin_events(model_path):
    records = _jsonl(os.path.join(model_path, "horovod-mnist",
                                  "events.jsonl"))
    return ({r["step"]: r["batch/loss"] for r in records
             if "batch/loss" in r},
            [r["epoch/loss"] for r in records if "epoch/loss" in r])


def reduction_twin(torch, nprocs):
    """15c: the tf2 twin on the int8 wire at ``nprocs`` ranks (NCCL at 1,
    gloo at 2): the loss falls, every checkpoint is intact and holds a
    residual row per rank, and a resume from the next-to-last checkpoint
    retrains the last epoch bit for bit (every step's loss, and the final
    state digest)."""
    from horovod_tpu_torch import checkpoint

    backend = "nccl" if nprocs == 1 else "gloo"
    knobs = dict(TWIN_INT8_CUT)
    if backend == "gloo":
        knobs["HVT_BACKEND"] = "gloo"
    name = f"twin_int8_{nprocs}"
    lines, wall, _, model_path = _launch(name, nprocs, "tf2_style_mnist",
                                         knobs)
    _world(lines, nprocs, backend)
    steps, epochs = int(knobs["DRIVE_STEPS"]), int(knobs["DRIVE_EPOCHS"])
    result, _ = _tf2_summary(lines, model_path, steps, nprocs)
    model_dir = os.path.join(model_path, "horovod-mnist")
    names = result["checkpoints"]
    check(len(names) == epochs, f"15c: checkpoints {names}")
    rows = []
    for cname in names:
        payload = torch.load(os.path.join(model_dir, cname),
                             map_location="cpu", weights_only=True)
        res = payload["optimizer"].get("ef_residual")
        check(res is not None and all(t.shape[0] == nprocs for t in res),
              f"15c: {cname} holds no residual row per rank")
        rows.append(float(sum(t.abs().sum() for t in res)))
    check(rows[-1] > 0, "15c: the residual is all zero")
    # Resume: a copy of the run without its last checkpoint retrains the
    # last epoch from the one before.
    batch, _ = _twin_events(model_path)
    resumed = model_path + "_resumed"
    shutil.rmtree(resumed, ignore_errors=True)
    shutil.copytree(model_path, resumed)
    rdir = os.path.join(resumed, "horovod-mnist")
    last = os.path.join(rdir, names[-1])
    for suffix in ("", checkpoint.DIGEST_SUFFIX, checkpoint.META_SUFFIX):
        os.remove(last + suffix)
    os.remove(os.path.join(rdir, "events.jsonl"))
    env_path = dict(knobs)
    lines2, wall2, _, _ = _launch(name + "_resumed", nprocs,
                                  "tf2_style_mnist", env_path)
    check(any(f"Resuming from checkpoint epoch {epochs - 1}" in line
              for line in lines2), "15c: the relaunch did not resume")
    batch2, _ = _twin_events(os.path.join(WORK, name + "_resumed"))
    first = (epochs - 1) * steps + 1
    want = [batch[s] for s in range(first, epochs * steps + 1)]
    got = [batch2.get(s) for s in range(first, epochs * steps + 1)]
    check(got == want, f"15c: the resumed epoch's losses {got[:3]}... "
          f"differ from the uninterrupted run's {want[:3]}...")
    d1 = _rank_line(lines, "State digests:").split()
    d2 = _rank_line(lines2, "State digests:").split()
    check(d1 == d2, "15c: the resumed run ends in another state")
    result.update({"backend": backend, "cut": knobs, "wall_s": wall + wall2,
                   "residual_abs_sum_per_checkpoint": rows,
                   "resumed_epoch_losses_bit_equal": True,
                   "resumed_first_step_loss": got[0]})
    log("phase15c", json.dumps(result))
    return result


def reduction_phase(torch, card):
    """Phase 15: the sharded and quantized reduction on the card (15a-b;
    15c is `reduction_twins`)."""
    t0 = time.perf_counter()
    res = reduction_runs(torch, card, REDUCTION_RANKS,
                         ["i_f32", "ii_int8", "iii_int8_zero1_overlap",
                          "iii_int8_zero1", "iv_fp8_zero1"], "gloo",
                         with_15a=True)
    res["seconds"] = time.perf_counter() - t0
    log(f"reduction phase seconds: {res['seconds']:.1f}")
    return res


def reduction_twins(torch):
    """15c, in the checks' lane: the two twins are checks of the int8 wire
    and its resume; they share the card at once (their images/s are not
    those of a twin alone)."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        twins = [pool.submit(reduction_twin, torch, n) for n in (1, 2)]
        return {f"twin_{n}": t.result() for n, t in zip((1, 2), twins)}


# -- phase 16 ---------------------------------------------------------------

# The tf2 twin's cut for the supervised runs and the pod (phase 10's cut);
# the supervisor's restart knobs and the hang run's heartbeat timeout.
LAUNCH_CUT = MNIST_2RANK_CUT
SUP_BACKOFF_S, HANG_TIMEOUT_S = 0.5, 15
SSH_SHIM = """#!/bin/bash
while [[ "$1" == -* ]]; do
  if [[ "$1" == "-o" ]]; then shift 2; else shift; fi
done
host="$1"; shift
exec sh -c "$*"
"""


def _digests(lines):
    """Every rank's state digest from the one "State digests:" line."""
    line = next((ln for ln in lines if "State digests:" in ln), None)
    check(line is not None, "no 'State digests:' line in the output")
    return line.split("State digests:")[1].split()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


def _supervised_twin(name, fault, extra, clean):
    """16b/16c: the tf2 twin at LAUNCH_CUT under ``run --nprocs 1
    --max-restarts 2 --backoff 0.5 --status-port 0`` with ``HVT_FAULT=
    fault`` and a stamp; the status routes are scraped once while it runs.
    One ``restarts`` record of the fault's kind, progressed; the relaunch
    resumes from epoch 1's checkpoint and ends in the clean run's state
    bit for bit; the journal gates through ``gate``; ``metrics.prom``
    reads one restart. Times from the stamp's mtime (the fault, touched
    just before it fires) to the journal's record (the kill) and to the
    arrival of the relaunched rank's "Resuming from checkpoint" line
    (training goes on: the backoff, the new rank's interpreter and CUDA
    start and the checkpoint's load included; the rank runs unbuffered so
    the line arrives as it is printed)."""
    from horovod_tpu_torch.obs import prom

    model_path = os.path.join(WORK, name)
    stamp = os.path.join(model_path, "fault-stamp")
    scraped: dict = {}
    resumed: list[float] = []

    def scrape(line):
        if "Resuming from checkpoint" in line and not resumed:
            resumed.append(time.time())
        if "supervisor: status on " in line and not scraped:
            url = line.split("supervisor: status on ", 1)[1].strip()
            try:
                scraped["healthz"] = json.loads(_get(url + "/healthz"))
                scraped["status"] = json.loads(_get(url + "/status"))
                scraped["metrics"] = prom.parse_text(_get(url + "/metrics"))
            except (OSError, ValueError) as e:
                scraped["error"] = repr(e)

    knobs = dict(LAUNCH_CUT, HVT_FAULT=fault, HVT_FAULT_STAMP=stamp,
                 PYTHONUNBUFFERED="1")
    launch = ["run", "--nprocs", "1", "--max-restarts", "2", "--backoff",
              str(SUP_BACKOFF_S), "--status-port", "0", *extra]
    lines, wall, _, _ = _launch(name, 1, "tf2_style_mnist", knobs,
                                launch=launch, on_line=scrape)
    check("error" not in scraped and scraped.get("healthz", {}).get(
        "status") == "ok", f"16: the status scrape failed: {scraped}")
    check(scraped["status"]["coordinator"] is None
          and "hvt_restart_budget_remaining" in scraped["metrics"],
          f"16: /status or /metrics incomplete: {scraped}")
    journal = os.path.join(model_path, "restarts.jsonl")
    records = [r for r in _jsonl(journal) if r["name"] == "restarts"]
    kind = "hang" if fault.endswith(":hang") else "crash"
    check(len(records) == 1 and records[0]["kind"] == kind
          and records[0]["progressed"] is True,
          f"16: want one progressed {kind} restart, journal {records}")
    check(_gate(journal, "restarts=1..1", "count") == 0,
          "16: the journal gate `restarts=1..1 --aggregate count` failed")
    check(any("Resuming from checkpoint epoch 1" in ln for ln in lines),
          "16: the relaunch did not resume from epoch 1")
    digest = _digests(lines)
    check(digest == clean, f"16: the restarted run ends in {digest}, the "
          f"clean run in {clean}")
    with open(os.path.join(model_path, "metrics.prom")) as f:
        dump = prom.parse_text(f.read())
    check(dump.get("hvt_restarts_total") == 1,
          f"16: metrics.prom hvt_restarts_total {dump}")
    fault_at = os.stat(stamp).st_mtime
    return {"fault": fault, "kind": kind, "wall_s": wall,
            "detection_s": records[0]["wall_time"] - fault_at,
            "fault_to_relaunch_s": resumed[0] - fault_at,
            "state_bit_equal_to_clean": True, "journal_gate_exit": 0,
            "metrics_prom": {k: dump[k] for k in (
                "hvt_restarts_total", "hvt_committed_epoch",
                "hvt_committed_step", "hvt_restart_budget_remaining")},
            "scraped_during_run": sorted(scraped)}


def pod_twin(hosts, per_host, backend):
    """16d: the tf2 twin at LAUNCH_CUT through ``pod`` over a PATH-shimmed
    ``ssh`` that runs the remote command here (the shim of
    ``tests/test_launch.py``), the knobs passed as ``--env`` exports: the
    world is ``len(hosts) × per_host`` ranks on ``backend`` and every rank
    ends in one state."""
    shim = os.path.join(WORK, "fakebin")
    os.makedirs(shim, exist_ok=True)
    with open(os.path.join(shim, "ssh"), "w") as f:
        f.write(SSH_SHIM)
    os.chmod(os.path.join(shim, "ssh"), 0o755)
    name = f"pod_{len(hosts)}x{per_host}_{backend}"
    model_path = os.path.join(WORK, name)
    exports = dict(LAUNCH_CUT, PS_MODEL_PATH=model_path,
                   HVT_DATA_DIR=os.path.join(WORK, "data"), PYTHONPATH=ROOT)
    if backend == "gloo":
        exports["HVT_BACKEND"] = "gloo"
    from horovod_tpu_torch.launch.launcher import pick_free_port

    launch = ["pod", "--hosts", ",".join(hosts), "--nprocs-per-host",
              str(per_host), "--port", str(pick_free_port()), "--workdir",
              ROOT]
    for k, v in exports.items():
        launch += ["--env", f"{k}={v}"]
    world_n = len(hosts) * per_host
    lines, wall, _, _ = _launch(
        name, world_n, "tf2_style_mnist",
        {"PATH": shim + os.pathsep + os.environ.get("PATH", "")},
        launch=launch)
    world = next((ln for ln in lines if "World:" in ln), "")
    check(f"process_count={world_n}," in world
          and f"backend='{backend}'" in world,
          f"16d: want {world_n} ranks on {backend}, got {world}")
    digests = _digests(lines)
    check(len(digests) == world_n and len(set(digests)) == 1,
          f"16d: the pod's ranks end in different states: {digests}")
    return {"part": "d_pod", "hosts": hosts, "nprocs_per_host": per_host,
            "world": world_n, "backend": backend, "wall_s": wall,
            "ranks_bit_identical": True}


def launch_phase(torch, card, ci_job):
    """Phase 16: the launch layer on the card. (a) phase 11's CI job went
    through ``launch job`` (its figures are ``ci_job``); (b) a supervised
    crash and restart, (c) a hang detected and restarted, both ending in
    the clean run's state bit for bit; (d) ``pod`` over the ssh shim at
    two gloo ranks sharing the card."""
    t0 = time.perf_counter()
    log("phase16", json.dumps(dict(ci_job, card=card)))
    # The clean reference run and (d) share the card at once, then (b) and
    # (c): checks, whose fault timings are read beside the other launched
    # checks of the lane (`checks_lane`), not on an idle host.
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        clean_run = pool.submit(_launch, "launch_clean", 1,
                                "tf2_style_mnist", LAUNCH_CUT)
        pod = pool.submit(pod_twin, ["127.0.0.1", "localhost"], 1, "gloo")
        lines, wall, _, _ = clean_run.result()
        pod = pod.result()
        clean = _digests(lines)
        crash = pool.submit(_supervised_twin, "launch_crash", "0:1:exit1",
                            [], clean)
        hang = pool.submit(_supervised_twin, "launch_hang", "0:1:hang",
                           ["--heartbeat-timeout", str(HANG_TIMEOUT_S)],
                           clean)
        res = {"clean_wall_s": wall}
        res["b"] = dict(crash.result(), part="b_crash", card=card)
        res["c"] = dict(hang.result(), part="c_hang",
                        heartbeat_timeout_s=HANG_TIMEOUT_S, card=card)
    log("phase16", json.dumps(res["b"]))
    log("phase16", json.dumps(res["c"]))
    res["d"] = dict(pod, card=card)
    log("phase16", json.dumps(res["d"]))
    res["seconds"] = time.perf_counter() - t0
    log(f"launch phase seconds: {res['seconds']:.1f}")
    return res


# -- phase 17 -------------------------------------------------------------------

# The bench LM in bench.py's MoE mode (bench.py:112-150 with moe=True):
# every second block's MLP routed over 8 experts, top-2, capacity 1.25.
MOE_MODEL = dict(MODEL, moe_every=2, n_experts=8, moe_k=2,
                 capacity_factor=1.25)
MOE_EC_STEPS = 5  # 17a: steps with moe_router="expert_choice"
# 17b: one f32 step of a 2-layer MoE LM at the bench width on the card and
# on the CPU, from the same weights and batch (2 × 512 tokens: one dispatch
# group). The router's f32 logits differ by rounding only; the loss, the
# aux loss and each gradient are held as phase 7 holds the dense step (loss
# 1e-5 abs, each gradient 2e-5 of its tensor's largest), the aux loss to
# 1e-6 abs.
MOE_PLAIN_ROWS, MOE_PLAIN_SEQ, MOE_AUX_ATOL = 2, 512, 1e-6
# 17c: phase 17a's weights at capacity_factor 4.0 (no token dropped, so a
# decode step routes as the recompute does), f32 compute; greedy decode
# equals the no-cache recompute token for token, except past a near-tie
# (top-2 logits of the recompute within this margin), which is counted.
MOE_DECODE_MARGIN = 1e-3
# 17d: two gloo ranks sharing the card, MeshSpec(data=1, expert=2), the
# bench width at 2 layers (one MoE block), f32, MOE_EP_STEPS SGD steps of
# 8 × 1024 against one rank: losses to 1e-5 relative, rank j's experts to
# 1e-5 abs of the one-rank experts [4j, 4j + 4) — the expert group sums the
# combine in another order — replicated parameters bit-equal on the ranks.
MOE_EP_STEPS, MOE_EP_LR, MOE_EP_RTOL, MOE_EP_ATOL = 3, 0.1, 1e-5, 1e-5
# 17e (--ranks 4): MeshSpec(data=2, expert=2) on NCCL, the bench MoE LM in
# bf16 at full depth, MOE_4_STEPS steps (one eager, one capture, replays)
# at 8 × 1024 a rank, and the dense LM at four data ranks beside it.
MOE_4_STEPS = 10

MOE_CHILD = r"""
import functools, json, os, time
import numpy as np
import torch
import chip_smoke as cs
import horovod_tpu_torch as ht
from horovod_tpu_torch import callbacks, runtime
from horovod_tpu_torch.data.datasets import copy_task
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.parallel import mesh as tmesh

ht.init(device=os.environ.get("SMOKE_DEVICE") or "cuda")
r = ht.rank()
dev = runtime.device()
cfg = json.loads(os.environ["SMOKE_MODEL"])
steps = int(os.environ["SMOKE_STEPS"])
rows = int(os.environ.get("SMOKE_ROWS") or cs.TRAIN_BATCH)
seq = int(os.environ.get("SMOKE_SEQ") or cs.TRAIN_SEQ)
out = os.environ["SMOKE_OUT"]
mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(os.environ["SMOKE_MESH"]))
moe = bool(cfg.get("moe_every"))
model = ttr.TransformerLM(**cfg, sharding=ttr.ShardingConfig(mesh=mesh),
                          device=dev, seed=0)
if os.environ.get("SMOKE_OPT") == "sgd":
    opt = functools.partial(torch.optim.SGD, lr=float(os.environ["SMOKE_LR"]))
else:
    opt = ht.adamw(ht.scale_lr(3e-4, 1))
trainer = ht.Trainer(model, ht.DistributedOptimizer(opt), loss="module",
                     seed=0, mesh=mesh,
                     param_specs=ttr.param_specs if moe else None,
                     device=dev)
# Each batch shard draws its own rows; the ranks of an expert group alike.
x, y = copy_task(4096, seq, cfg["vocab_size"])
rng = np.random.RandomState(100 + mesh.data_index)
batches = []
for _ in range(steps):
    idx = rng.randint(0, len(x), size=rows)
    batches.append((x[idx], y[idx]))


class Clock(callbacks.Callback):
    # Each step's wall and metrics (one epoch of all the steps: the
    # checkpoint, if any, is written once, after the last).
    def on_train_begin(self, logs=None):
        self.t, self.logs = [time.perf_counter()], []

    def on_batch_end(self, batch, logs=None):
        self.logs.append({k: float(v) for k, v in logs.items()})
        self.t.append(time.perf_counter())


clock = Clock()
cbs = [clock, callbacks.MetricAverageCallback()]
ckpt = os.environ.get("SMOKE_CKPT")
if ckpt and r == 0:
    cbs.append(callbacks.ModelCheckpoint(
        os.path.join(ckpt, "checkpoint-{epoch}.pt")))
trainer.build(*batches[0])
trainer.fit(dataset=batches, epochs=1, steps_per_epoch=steps, callbacks=cbs,
            verbose=0)
step_ms = sorted(1e3 * (b - a) for a, b in zip(clock.t[2:], clock.t[3:]))
runner = trainer._runner
res = {"rank": r, "coords": mesh.coords,
       "losses": [e["loss"] for e in clock.logs],
       "metrics": {k: [e[k] for e in clock.logs]
                   for k in trainer.metric_names},
       "eager_steps": runner.eager_steps, "captures": runner.captures,
       "replays": runner.replays,
       "step_ms_median": step_ms[len(step_ms) // 2] if step_ms else None,
       "tokens_per_s_per_card": (rows * seq / (step_ms[len(step_ms) // 2]
                                               / 1e3)) if step_ms else None,
       "peak_memory_gib": (torch.cuda.max_memory_allocated() / 2**30
                           if dev.type == "cuda" else None)}
local = {n: p.detach().cpu().numpy() for n, p in model.named_parameters()}
np.savez(os.path.join(out, f"local{r}.npz"), **local)
full = trainer.state.full_model_state()
if r == 0:
    np.savez(os.path.join(out, "full.npz"),
             **{n: t.detach().cpu().numpy() for n, t in full.items()})
print("moe_child", json.dumps(res), flush=True)
"""


def _moe_lines(lines, nprocs):
    recs = []
    for r in range(nprocs):
        text = _rank_line(lines, "moe_child ", r)
        check(text is not None, f"17: rank {r} printed no result")
        recs.append(json.loads(text))
    return recs


def moe_child_run(torch, name, nprocs, mesh, model, steps, backend,
                  opt="adamw", ckpt=False):
    """One launch of MOE_CHILD: ``nprocs`` ranks, the mesh, the model
    config, ``steps`` fit steps. Returns (per-rank records, per-rank local
    parameters, rank 0's whole parameters, the checkpoint dir or None)."""
    import numpy as np

    out = os.path.join(WORK, name + "_out")
    os.makedirs(out, exist_ok=True)
    ck = os.path.join(out, "ckpt") if ckpt else ""
    knobs = {"SMOKE_MODEL": json.dumps(model), "SMOKE_STEPS": str(steps),
             "SMOKE_MESH": mesh, "SMOKE_OUT": out, "SMOKE_OPT": opt,
             "SMOKE_LR": str(MOE_EP_LR), "SMOKE_CKPT": ck,
             "HVT_BACKEND": backend, "PYTHONUNBUFFERED": "1"}
    lines, wall, _, _ = _launch(name, nprocs, None, knobs, code=MOE_CHILD,
                                timeout=600)
    recs = _moe_lines(lines, nprocs)
    local = [dict(np.load(os.path.join(out, f"local{r}.npz")))
             for r in range(nprocs)]
    full = dict(np.load(os.path.join(out, "full.npz")))
    return recs, local, full, (ck or None), wall


def _replicated_and_shards_equal(local, shape):
    """Replicated parameters bit-equal on every rank; each expert shard
    bit-equal across its batch group. Returns the differing names."""
    import numpy as np

    from horovod_tpu_torch.parallel import mesh as tmesh

    bad = []
    for n in local[0]:
        if ".moe.moe_" in n:
            for g in tmesh.axis_rank_lists(shape, ("data", "fsdp")):
                bad += [n for r in g[1:]
                        if not np.array_equal(local[r][n], local[g[0]][n])]
        else:
            bad += [n for loc in local[1:]
                    if not np.array_equal(loc[n], local[0][n])]
    return sorted(set(bad))


def moe_train(torch, card):
    """17a: the bench MoE LM trains at full width and depth; the launch
    counts of B1-B3 on the tensor-core route; a profiled breakdown of the
    MoE layers' device time; then expert-choice steps."""
    import numpy as np

    from horovod_tpu_torch import DistributedOptimizer, Trainer, adamw, scale_lr
    from horovod_tpu_torch.data.datasets import copy_task
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.ops import flash_attention as fa

    x, y = copy_task(4096, TRAIN_SEQ, MODEL["vocab_size"])
    feed = _draw(x, y, np.random.RandomState(0))
    model = TransformerLM(**MOE_MODEL, compute_dtype=torch.bfloat16,
                          fused_head_chunks=8, device=DEVICE, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    trainer = Trainer(model, DistributedOptimizer(adamw(scale_lr(3e-4))),
                      loss="module", seed=0, device=DEVICE)
    # Build with a sample: the eval-mode forward that names the sown
    # metrics runs before the counts are zeroed.
    trainer.build(*next(feed))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    fa.launches_tc = fa.launches_bwd_dq_tc = fa.launches_bwd_dkv_tc = 0
    t0 = time.perf_counter()
    hist = trainer.fit(dataset=feed, epochs=TRAIN_STEPS, steps_per_epoch=1,
                       verbose=0)
    wall = time.perf_counter() - t0
    launches = {"flash_fwd_tc": fa.launches_tc,
                "flash_bwd_dq_tc": fa.launches_bwd_dq_tc,
                "flash_bwd_dkv_tc": fa.launches_bwd_dkv_tc,
                "flash_fwd": fa.launches, "flash_bwd_dq": fa.launches_bwd_dq,
                "flash_bwd_dkv": fa.launches_bwd_dkv}
    peak = torch.cuda.max_memory_allocated()
    losses = [e["loss"] for e in hist]
    drops = [e.get("moe_drop_rate") for e in hist]
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"17a: the MoE LM's loss is not finite or did not fall: {losses}")
    check(all(d is not None and 0.0 <= d < 1.0 for d in drops),
          f"17a: moe_drop_rate missing from an epoch log or outside [0, 1): "
          f"{drops}")
    runner = trainer._runner
    check(runner.captures == 1 and runner.replays == TRAIN_STEPS - 1,
          f"17a: {runner.captures} captures, {runner.replays} replays")
    want = MODEL["n_layers"] * (TRAIN_STEPS - runner.replays
                                + runner.captures)
    for name, n in launches.items():
        check(n == want, f"17a: {name} launched {n} times, want n_layers × "
              f"(eager steps + captures) = {want}, all on the tensor-core "
              "route")
    steady = sorted(e["epoch_time_s"] * 1e3 for e in hist[2:])
    median = steady[len(steady) // 2]
    # Where the time goes: the replayed step's device time, and one MoE
    # layer's forward and backward at the same shape, eagerly, by kind.
    window = 5
    prof, host_ms = profiled_fit(torch, lambda cbs: trainer.fit(
        dataset=feed, epochs=2 * window, steps_per_epoch=1, callbacks=cbs,
        verbose=0), window, window)
    replay, _ = _per_step(torch, prof, window, host_ms)
    # One MoE layer's forward and backward at the step's shape, timed on
    # the device as CUDA-graph replays (a profiler session over the eager
    # layer saw only part of its kernels in some runs).
    layer = model.blocks[1].moe
    xin = torch.randn(TRAIN_BATCH, TRAIN_SEQ, MODEL["d_model"],
                      device=DEVICE, generator=torch.Generator(
                          device=DEVICE).manual_seed(1)).to(
        torch.bfloat16).requires_grad_()

    def layer_step():
        out = layer(xin, train=True)
        loss = out.float().square().mean() + layer.sown["losses"][
            "moe_load_balance"]
        loss.backward()

    layer_ms = device_ms(torch, layer_step, iters=5)
    model.zero_grad(set_to_none=True)
    n_moe = sum(1 for b in model.blocks if b.use_moe)
    busy = replay["device_busy_ms_per_step"]
    train = {
        "model": dict(MOE_MODEL, compute_dtype="bfloat16",
                      fused_head_chunks=8),
        "parameters": n_params, "steps": TRAIN_STEPS, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "wall_s": wall, "losses": losses,
        "moe_drop_rate": drops, "step_ms_median": median,
        "step_ms_min": steady[0], "step_ms_max": steady[-1],
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (median / 1e3),
        "peak_memory_gib": peak / 2**30, "launches": launches,
        "graph_replays": runner.replays, "replayed": replay,
        "moe_layer_fwd_bwd_ms": layer_ms, "moe_layers": n_moe,
        "moe_share_of_device_time": (n_moe * layer_ms / busy
                                     if isinstance(busy, float)
                                     else "not measured"),
        "card": card,
    }
    log("phase17a", json.dumps(train))
    # Expert choice: the same model, drop-free routing, its coverage metric.
    ec_model = TransformerLM(**dict(MOE_MODEL, moe_router="expert_choice"),
                             compute_dtype=torch.bfloat16,
                             fused_head_chunks=8, device=DEVICE, seed=0)
    ec = Trainer(ec_model, DistributedOptimizer(adamw(scale_lr(3e-4))),
                 loss="module", seed=0, device=DEVICE)
    ec_hist = ec.fit(dataset=feed, epochs=MOE_EC_STEPS, steps_per_epoch=1,
                     verbose=0)
    unc = [e.get("moe_uncovered_rate") for e in ec_hist]
    check(all(u is not None and 0.0 <= u < 1.0 for u in unc)
          and all(math.isfinite(e["loss"]) for e in ec_hist),
          f"17a: expert choice: moe_uncovered_rate {unc}")
    log("phase17a_expert_choice", json.dumps({
        "steps": MOE_EC_STEPS, "losses": [e["loss"] for e in ec_hist],
        "moe_uncovered_rate": unc, "card": card}))
    return model, dict(train, launches=launches)


def moe_vs_plain(torch, card):
    """17b: one f32 step of a 2-layer MoE LM at the bench width on the card
    and on the CPU, from the same weights and batch: the loss, the aux
    loss and every gradient (the card's topk/cumsum/einsum path against
    the CPU's)."""
    import numpy as np

    from horovod_tpu_torch.data.datasets import copy_task
    from horovod_tpu_torch.models.transformer import TransformerLM

    cfg = dict(MOE_MODEL, n_layers=2)
    x, y = copy_task(MOE_PLAIN_ROWS, MOE_PLAIN_SEQ, MODEL["vocab_size"],
                     seed=3)
    got = {}
    for dev in (DEVICE, "cpu"):
        m = TransformerLM(**cfg, device=dev, seed=2)
        loss, _ = m(torch.from_numpy(x).to(dev), train=True, dropout_seed=0,
                    labels=torch.from_numpy(y).to(dev))
        aux = m.sown_losses()[0]
        (loss.mean() + aux).backward()
        got[dev] = (float(loss.detach().mean()), float(aux.detach()),
                    {n: p.grad.detach().cpu() for n, p in m.named_parameters()},
                    float(m.sown_metrics()["moe_drop_rate"]))
    (lg, ag, gg, dg), (lc, ac, gc, dc) = got[DEVICE], got["cpu"]
    worst = max((float((gg[n] - gc[n]).abs().max())
                 / max(float(gc[n].abs().max()), 1e-30), n) for n in gc)
    res = {"loss_card": lg, "loss_cpu": lc, "aux_card": ag, "aux_cpu": ac,
           "drop_rate_card": dg, "drop_rate_cpu": dc,
           "grad_worst_share_of_max": worst[0], "grad_worst": worst[1],
           "card": card}
    log("phase17b", json.dumps(res))
    check(abs(lg - lc) <= TRAIN_LOSS_ATOL and abs(ag - ac) <= MOE_AUX_ATOL
          and dg == dc and worst[0] <= TRAIN_GRAD_REL,
          f"17b: the MoE step on the card differs from the CPU: {res}")
    return res


def moe_decode(torch, card, model):
    """17c: phase 17a's weights at capacity_factor 4.0 in f32: 64 greedy
    tokens for 8 prompts of 128 through the captured decode step, against
    the no-cache greedy recompute."""
    from horovod_tpu_torch.models.decoding import make_generate_fn
    from horovod_tpu_torch.ops import flash_attention as fa

    dmodel = model.clone(capacity_factor=4.0, compute_dtype=torch.float32)
    prompt = _prompt_batch(torch, 17).to(DEVICE)
    fn = make_generate_fn(dmodel, max_new_tokens=DECODE_NEW,
                          include_prompt=False)
    first = fn.steps.counts()
    fn(prompt)  # warm step + capture
    fa.launches = 0
    out, ms = _timed(torch, lambda: fn(prompt))
    b1 = fa.launches
    counts = {k: v - first[k] for k, v in fn.steps.counts().items()}
    tokens = prompt.long()
    near_ties, first_diff = 0, None
    with torch.no_grad():
        for i in range(DECODE_NEW):
            logits = dmodel(tokens)[:, -1].float()
            top2 = torch.topk(logits, 2, dim=-1).values
            nxt = logits.argmax(-1)
            differ = nxt != out[:, i].long()
            if bool(differ.any()):
                margin = float((top2[:, 0] - top2[:, 1])[differ].max())
                check(margin <= MOE_DECODE_MARGIN,
                      f"17c: decode token {i} differs from the recompute "
                      f"without a near-tie (top-2 margin {margin})")
                near_ties += int(differ.sum())
                first_diff = i if first_diff is None else first_diff
                nxt = torch.where(differ, out[:, i].long(), nxt)
            tokens = torch.cat([tokens, nxt[:, None]], dim=1)
    res = {"rows": BATCH, "prompt": PROMPT_LEN, "new_tokens": DECODE_NEW,
           "ms": ms, "tokens_per_s": BATCH * DECODE_NEW / ms * 1e3,
           "steps": counts, "b1_launches": b1,
           "near_tie_differences": near_ties, "first_difference": first_diff,
           "equal_to_recompute": near_ties == 0, "card": card}
    log("phase17c", json.dumps(res))
    return res


def moe_ep_two_ranks(torch, card):
    """17d: MeshSpec(data=1, expert=2) at two gloo ranks sharing the card
    against one rank, f32, SGD, the same weights and batches."""
    cfg = dict(MOE_MODEL, n_layers=2)
    # The two launches share the card at once (a check, not a timing).
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ep = pool.submit(moe_child_run, torch, "moe_ep2", 2,
                         "data=1,expert=2", cfg, MOE_EP_STEPS, "gloo",
                         opt="sgd")
        ref = pool.submit(moe_child_run, torch, "moe_ep1", 1, "data=1",
                          cfg, MOE_EP_STEPS, "gloo", opt="sgd")
        recs, local, full, _, wall = ep.result()
        one, one_local, _, _, _ = ref.result()
    ref = one_local[0]
    per = cfg["n_experts"] // 2
    worst_expert = 0.0
    for j in range(2):
        for n in ("blocks.1.moe.moe_up", "blocks.1.moe.moe_down"):
            want = ref[n][per * j:per * (j + 1)]
            worst_expert = max(worst_expert,
                               float(abs(local[j][n] - want).max()))
    worst_full = max(float(abs(full[n] - ref[n]).max()) for n in ref)
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(recs[0]["losses"], one[0]["losses"]))
    bad = _replicated_and_shards_equal(local, {"data": 1, "fsdp": 1,
                                               "pipe": 1, "seq": 1,
                                               "model": 1, "expert": 2})
    res = {"losses_ep": recs[0]["losses"], "losses_one": one[0]["losses"],
           "loss_worst_rel": loss_rel, "expert_worst_abs": worst_expert,
           "params_worst_abs": worst_full,
           "replicated_unequal": bad,
           "eager_steps": [r["eager_steps"] for r in recs],
           "step_ms_median_ep": recs[0]["step_ms_median"],
           "step_ms_median_one": one[0]["step_ms_median"],
           "launch_wall_s": wall, "card": card}
    log("phase17d", json.dumps(res))
    check(loss_rel <= MOE_EP_RTOL and worst_expert <= MOE_EP_ATOL
          and worst_full <= MOE_EP_ATOL and not bad
          and all(r["eager_steps"] == MOE_EP_STEPS for r in recs),
          f"17d: two-rank EP differs from one rank: {res}")
    return res


def moe_phase(torch, card):
    """Phase 17: MoE and expert parallelism on the card (17a-c; 17d, a
    launched check, is `moe_ep_two_ranks` in the checks' lane)."""
    t0 = time.perf_counter()
    model, train = moe_train(torch, card)
    res = {"a": train, "b": moe_vs_plain(torch, card),
           "c": moe_decode(torch, card, model)}
    del model
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    log(f"phase17 seconds: {res['seconds']:.1f}")
    return res


def moe_multi_card(torch, card, ranks):
    """17e: MeshSpec(data=2, expert=2) at four NCCL ranks, the bench MoE LM
    in bf16, captured steps; replicated parameters bit-equal on every rank
    and each expert shard across its batch group; tokens/s a card beside
    the dense LM at four data ranks; the checkpoint written there restores
    at one rank with the full experts."""
    from horovod_tpu_torch import checkpoint
    from horovod_tpu_torch.models.transformer import TransformerLM

    check(ranks == 4, "17e runs at --ranks 4")
    t0 = time.perf_counter()
    cfg = dict(MOE_MODEL, compute_dtype="bfloat16", fused_head_chunks=8)
    recs, local, full, ck, wall = moe_child_run(
        torch, "moe_ep4", 4, "data=2,expert=2", cfg, MOE_4_STEPS, "nccl",
        ckpt=True)
    dense, _, _, _, _ = moe_child_run(
        torch, "dense_dp4", 4, "data=4",
        dict(MODEL, compute_dtype="bfloat16", fused_head_chunks=8),
        MOE_4_STEPS, "nccl")
    bad = _replicated_and_shards_equal(local, {"data": 2, "fsdp": 1,
                                               "pipe": 1, "seq": 1,
                                               "model": 1, "expert": 2})
    path = checkpoint.latest_checkpoint(ck)
    check(path is not None, "17e: no checkpoint was written")
    one = TransformerLM(**cfg, device=DEVICE, seed=7)
    from horovod_tpu_torch import DistributedOptimizer, Trainer, adamw

    state = Trainer(one, DistributedOptimizer(adamw(3e-4)), loss="module",
                    device=DEVICE).build()
    checkpoint.restore(path, state)
    experts = tuple(one.blocks[1].moe.moe_up.shape)
    same = all(bool((t.detach().cpu() == torch.from_numpy(full[n])).all())
               for n, t in one.state_dict().items())
    res = {"ranks": ranks, "losses": recs[0]["losses"],
           "moe_drop_rate": recs[0]["metrics"].get("moe_drop_rate"),
           "captures": [r["captures"] for r in recs],
           "replays": [r["replays"] for r in recs],
           "step_ms_median": [r["step_ms_median"] for r in recs],
           "tokens_per_s_per_card": recs[0]["tokens_per_s_per_card"],
           "dense_tokens_per_s_per_card": dense[0]["tokens_per_s_per_card"],
           "dense_step_ms_median": dense[0]["step_ms_median"],
           "peak_memory_gib": [r["peak_memory_gib"] for r in recs],
           "replicated_or_shards_unequal": bad,
           "restored_at_one_rank": {"moe_up": experts, "equal": same},
           "seconds": time.perf_counter() - t0, "card": card}
    log("phase17e", json.dumps(res))
    check(not bad and same and experts[0] == MOE_MODEL["n_experts"]
          and all(math.isfinite(v) for v in recs[0]["losses"])
          and all(r["captures"] == 1 for r in recs),
          f"17e: {res}")
    return res


# Phase 18: sequence parallelism and packed pretraining (no new kernel: the
# ring, Ulysses and packing are collectives and plain ops around B1-B3).
# 18a: the ring's hops at the twin's full-width shard [B, T/n, H, D] — 8 rows
# of 2048 tokens over seq = 2, d_model 512 in 4 heads — bf16 (the tc route):
# the causal diagonal, a past block non-causal, and a past block at
# q_offset = T/n under a window of SEQ_HOP_WINDOW; B2/B3 with the lse
# cotangent the merge of two hops produces. Phase 3's tolerances.
SEQ_HOP_SHAPE, SEQ_HOP_WINDOW = (8, 1024, 4, 128), 1536
# 18b: the twin of examples/lm_packed_pretraining.py at the bench LM's width
# (vocab 8192, d_model 512, 8 layers; the twin's 4 heads, so D = 128), two
# gloo ranks sharing the card on HVT_MESH "data=1,seq=2": 8 × 1024 tokens a
# rank a step, attention the flash ring. DRIVE_EPOCHS × DRIVE_STEPS steps;
# step ms is the median of the epochs after the first, a step.
SEQ_TWIN = {"VOCAB": "8192", "DMODEL": "512", "NLAYERS": "8",
            "SEQ_LEN": "2048", "HVT_MESH": "data=1,seq=2",
            "DRIVE_EPOCHS": "3", "DRIVE_STEPS": "4"}
# 18c: a 2-layer f32 model at the bench width (8 heads) at seq = 2 against
# one rank on the card, SEQ_PLAIN_ROWS × SEQ_PLAIN_T tokens: logits, loss
# and every gradient, held to phase 7's TRAIN_LOSS_ATOL and TRAIN_GRAD_REL
# (logits to LOGITS_ATOL). The window variant's past hop runs at q_offset
# = T/n = 512 and its sink block on the hop that holds block 0.
SEQ_PLAIN_ROWS, SEQ_PLAIN_T = 2, 1024
SEQ_PLAIN_VARIANTS = {"ring": ({}, "ring"), "ulysses": ({}, "ulysses"),
                      "ring_window_sinks": (dict(window=700,
                                                 attention_sinks=4), "ring")}

SEQ_TWIN_CHILD = r"""
import hashlib, json, os
import torch
import horovod_tpu_torch as hvt
from horovod_tpu_torch import runtime
from horovod_tpu_torch.examples import lm_packed_pretraining as twin
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import collectives

trainers = []
fit = hvt.Trainer.fit


def recorded_fit(self, *args, **kwargs):
    trainers.append(self)
    return fit(self, *args, **kwargs)


hvt.Trainer.fit = recorded_fit
history = twin.main()
runner = trainers[0]._runner
digest = hashlib.sha256()
for p in trainers[0].module.parameters():
    digest.update(p.detach().cpu().numpy().tobytes())
steps = len(history) * int(os.environ["DRIVE_STEPS"])
# The shifts are counted where the step's Python runs (eager steps and the
# capture); a replay repeats the captured step's shifts.
ran = runner.eager_steps + runner.captures
per_step = sorted(e["epoch_time_s"] * 1e3 / int(os.environ["DRIVE_STEPS"])
                  for e in history[1:])
res = {"rank": runtime.rank(), "steps": steps,
       "losses": [e["loss"] for e in history],
       "step_ms_median": per_step[len(per_step) // 2],
       "launches": {"flash_fwd": fa.launches, "flash_fwd_tc": fa.launches_tc,
                    "flash_bwd_dq": fa.launches_bwd_dq,
                    "flash_bwd_dq_tc": fa.launches_bwd_dq_tc,
                    "flash_bwd_dkv": fa.launches_bwd_dkv,
                    "flash_bwd_dkv_tc": fa.launches_bwd_dkv_tc},
       "eager_steps": runner.eager_steps, "captures": runner.captures,
       "replays": runner.replays, "params_sha256": digest.hexdigest(),
       "ring_bytes_per_step": collectives.shift_traffic["bytes"] / ran,
       "ring_shifts_per_step": collectives.shift_traffic["calls"] / ran,
       "peak_memory_gib": (torch.cuda.max_memory_allocated() / 2**30
                           if runtime.device().type == "cuda" else None)}
print("seq_twin", json.dumps(res), flush=True)
"""

SEQ_PLAIN_CHILD = r"""
import json, os
import numpy as np
import torch
import horovod_tpu_torch as ht
from horovod_tpu_torch import runtime
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.parallel import collectives as c
from horovod_tpu_torch.parallel import mesh as tmesh

ht.init(device=os.environ.get("SMOKE_DEVICE") or "cuda")
dev = runtime.device()
cfg = json.loads(os.environ["SMOKE_MODEL"])
variants = json.loads(os.environ["SMOKE_VARIANTS"])
mesh = tmesh.build_mesh(tmesh.MeshSpec(data=1, seq=2))
data = np.load(os.environ["SMOKE_DATA"])
t = data["x"].shape[1] // 2
cols = slice(mesh.seq_index * t, (mesh.seq_index + 1) * t)
x, y = (torch.from_numpy(np.ascontiguousarray(data[k][:, cols])).to(dev)
        for k in ("x", "y"))
res = {}
for name, (kw, attn) in variants.items():
    m = ttr.TransformerLM(**cfg, **kw, seed=4,
                          device=dev, sharding=ttr.ShardingConfig(
                              mesh=mesh, attn=attn))
    with torch.no_grad():
        res[name + ".logits"] = m(x).cpu().numpy()
    loss, _ = m(x, labels=y, train=True, dropout_seed=0)
    c.all_gather_tiled(loss, mesh.group("seq"), 1).mean().backward()
    for pn, p in m.named_parameters():
        res[f"{name}.g.{pn}"] = c.all_reduce_sum(
            p.grad, mesh.grad_group).cpu().numpy()
    res[name + ".loss"] = loss.detach().cpu().numpy()
# 19e: the seq2seq family at seq = 2: its three sites as rings.
s2s = json.loads(os.environ.get("SMOKE_S2S") or "null")
if s2s:
    from horovod_tpu_torch.models import seq2seq as tseq

    sd = np.load(os.environ["SMOKE_S2S_DATA"])

    def mine(a):
        t = a.shape[1] // 2
        return torch.from_numpy(np.ascontiguousarray(
            a[:, mesh.seq_index * t:(mesh.seq_index + 1) * t])).to(dev)

    m = tseq.Seq2SeqTransformer(**s2s, seed=3, device=dev,
                                sharding=ttr.ShardingConfig(mesh=mesh))
    logits = m({"src": mine(sd["src"]), "tgt": mine(sd["tgt"])})
    res["s2s.logits"] = logits.detach().cpu().numpy()
    loss = torch.nn.functional.cross_entropy(
        logits.float().flatten(0, 1), mine(sd["y"]).long().flatten(),
        reduction="none").view(logits.shape[:2])
    c.all_gather_tiled(loss, mesh.group("seq"), 1).mean().backward()
    for pn, p in m.named_parameters():
        res["s2s.g." + pn] = c.all_reduce_sum(
            p.grad, mesh.grad_group).cpu().numpy()
    res["s2s.loss"] = loss.detach().cpu().numpy()
np.savez(os.path.join(os.environ["SMOKE_OUT"], f"rank{runtime.rank()}.npz"),
         **res)
print("seq_plain", json.dumps({"rank": runtime.rank()}), flush=True)
"""


def _ring_merge_cotangents(torch, hops, dout):
    """The cotangents the ring's merge hands each hop: the hops' ``(out,
    lse)`` merged by `ops.attention._merge_lse` as the ring merges them,
    the result's backward taken with ``dout``. Returns per hop ``(dO,
    dlse)``."""
    from horovod_tpu_torch.ops import attention as att

    # Clones: the hops' outputs may be inference tensors.
    outs = [o.clone().requires_grad_() for o, _ in hops]
    lses = [lse.clone().requires_grad_() for _, lse in hops]
    with torch.enable_grad():
        o, m, l = att._ring_init(outs[0])
        for o_j, lse_j in zip(outs, lses):
            o, m, l = att._merge_lse(o, m, l, o_j, lse_j)
        torch.autograd.backward((o / l[..., None]).to(dout.dtype), dout)
    return [(a.grad, b.grad) for a, b in zip(outs, lses)]


def ring_hops(torch, card, shape=None, window=None, phase="18a", seed=18):
    """18a: B1 at the ring's hops and B2/B3 with the merge's lse cotangent,
    each against its plain version on the same inputs, at the twin's
    full-width shard (or ``shape``, the past hop's ``window``); the
    q_offset and non-causal hops timed beside their bound and SDPA with
    the same mask."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import flash_attention as fa

    b, t, h, d = shape or SEQ_HOP_SHAPE
    window = window or SEQ_HOP_WINDOW
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k0, v0, k1, v1, dout = (rand(b, t, h, d) for _ in range(6))
    none = dict(window=None, sinks=0, q_offset=None)
    # name: (k, v, masks); "diagonal" is hop 0 (its own block), the others
    # hop 1 (the block born one rank back, keys T/n before the queries).
    hops = {"diagonal": (k0, v0, dict(none, causal=True)),
            "past_full": (k1, v1, dict(none, causal=False)),
            "past_window": (k1, v1, dict(none, causal=True,
                                         window=window, q_offset=t))}
    tol, gtol = TOL["bfloat16"], GRAD_TOL["bfloat16"]
    res, outs = {}, {}
    with torch.inference_mode():
        for name, (k, v, masks) in hops.items():
            tc0 = fa.launches_tc
            out, lse = fa._launch(q, k, v, None, None, **masks)
            torch.cuda.synchronize()
            check(fa.launches_tc == tc0 + 1, f"{phase} {name}: B1 not on tc")
            ref_o, ref_lse = fa.flash_attention_reference(q, k, v, **masks)
            o_err = (out.float() - ref_o.float()).abs()
            check(bool((o_err <= tol["o_atol"] + tol["o_rtol"]
                        * ref_o.float().abs()).all()),
                  f"{phase} {name}: O differs from the plain version (max abs "
                  f"{float(o_err.max()):.3g})")
            lse_err = float((lse - ref_lse).abs().max())
            check(lse_err <= tol["lse"],
                  f"{phase} {name}: lse err {lse_err:.3g}")
            outs[name] = (out, lse)
            res[name] = {"o_max_abs_err": float(o_err.max()),
                         "lse_max_abs_err": lse_err}
    # The merges of the ring without and with the window: (diagonal, past).
    merge_cot = {}
    for ring, past in (("full", "past_full"), ("window", "past_window")):
        cots = _ring_merge_cotangents(
            torch, [outs["diagonal"], outs[past]], dout)
        merge_cot[past] = cots[1]
        for hop, (do, dlse) in zip(("diagonal", past), cots):
            check(float(dlse.abs().max()) > 0,
                  f"{phase} {ring}/{hop}: the merge gave no lse cotangent")
            k, v, masks = hops[hop]
            out, lse = outs[hop]
            with torch.inference_mode():
                delta = fa._delta(out, do, dlse)
                tc0 = (fa.launches_bwd_dq_tc, fa.launches_bwd_dkv_tc)
                got = (fa._launch_dq(q, k, v, do, lse, delta, None, None,
                                     masks),
                       *fa._launch_dkv(q, k, v, do, lse, delta, None, None,
                                       masks))
                torch.cuda.synchronize()
                check((fa.launches_bwd_dq_tc, fa.launches_bwd_dkv_tc)
                      == (tc0[0] + 1, tc0[1] + 1),
                      f"{phase} {ring}/{hop}: B2/B3 not on tc")
                want = (fa.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                                  **masks),
                        *fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                    **masks))
            errs = {}
            for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                w = w.float()
                err = (g.float() - w).abs()
                atol = gtol["atol_of_max"] * float(w.abs().max())
                check(bool((err <= atol + gtol["rtol"] * w.abs()).all()),
                      f"{phase} {ring}/{hop}: {gname} differs from the plain "
                      f"version (max abs {float(err.max()):.3g})")
                errs[gname] = float(err.max())
            errs["dlse_max_abs"] = float(dlse.abs().max())
            res[f"bwd_{ring}_{hop}"] = errs
    # Times: B1 at each hop, B2/B3 at the past hops with their merge's
    # cotangents (the q_offset + dlse cases); SDPA with the same mask.
    qh = q.transpose(1, 2).contiguous()
    timings = {}
    for name, (k, v, masks) in hops.items():
        kh, vh = (x.transpose(1, 2).contiguous() for x in (k, v))
        mask = None
        if masks["window"] is not None:
            rows = torch.arange(t, device="cuda")[:, None] + masks["q_offset"]
            cols = torch.arange(t, device="cuda")[None, :]
            mask = (cols <= rows) & (cols > rows - masks["window"])
        sdpa = dict(attn_mask=mask, is_causal=name == "diagonal")
        out, lse = outs[name]
        with torch.inference_mode():
            entry = {"shape": [b, t, h, d], "masks": {
                k_: v_ for k_, v_ in masks.items() if v_}}
            bound, by = attention_bound_ms(
                b, t, t, h, h, d, "bfloat16", causal=masks["causal"],
                q_offset=masks["q_offset"], window=masks["window"])
            entry["flash_fwd_sm90"] = {
                "ms": device_ms(torch, lambda: fa._launch(
                    q, k, v, None, None, **masks), 20),
                "plain_ms": device_ms(
                    torch, lambda: fa.flash_attention_reference(
                        q, k, v, **masks), 3),
                "library_ms": device_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, **sdpa), 20),
                "bound_ms": bound, "bound_by": by}
        if name != "diagonal":
            do, dlse = merge_cot[name]
            with torch.inference_mode():
                delta = fa._delta(out, do, dlse)
            qg, kg, vg = (x.clone().requires_grad_() for x in (qh, kh, vh))
            gh = do.transpose(1, 2).contiguous()

            def fwd_bwd():
                o = F.scaled_dot_product_attention(qg, kg, vg, **sdpa)
                torch.autograd.grad(o, (qg, kg, vg), gh)

            lib_bwd = (device_ms(torch, fwd_bwd, 10)
                       - entry["flash_fwd_sm90"]["library_ms"])
            with torch.inference_mode():
                for kname, launch, plain, work in (
                        ("flash_bwd_dq_sm90", fa._launch_dq,
                         fa.flash_bwd_dq_reference, "flash_bwd_dq"),
                        ("flash_bwd_dkv_sm90", fa._launch_dkv,
                         fa.flash_bwd_dkv_reference, "flash_bwd_dkv")):
                    bound, by = attention_bound_ms(
                        b, t, t, h, h, d, "bfloat16", causal=masks["causal"],
                        q_offset=masks["q_offset"], window=masks["window"],
                        kernel=work)
                    entry[kname] = {
                        "ms": device_ms(torch, lambda: launch(
                            q, k, v, do, lse, delta, None, None, masks), 20),
                        "plain_ms": device_ms(torch, lambda: plain(
                            q, k, v, do, lse, delta, **masks), 3),
                        "library_ms": lib_bwd, "bound_ms": bound,
                        "bound_by": by}
        timings[name] = entry
        log(f"time ring hop ({phase}) {name} B{b} T{t} H{h} D{d} bf16 [tc]: "
            + ", ".join(f"{k_} {v_['ms']:.5f} ms (plain {v_['plain_ms']:.5f}, "
                        f"sdpa {v_['library_ms']:.5f}, bound "
                        f"{v_['bound_ms']:.5f} {v_['bound_by']})"
                        for k_, v_ in entry.items() if isinstance(v_, dict)
                        and "ms" in v_))
    log(f"phase{phase}", json.dumps({"checks": res, "card": card}))
    return {"checks": res, "timings": timings}


def seq_twin(torch, card, nprocs=2, mesh="data=1,seq=2", backend="gloo",
             name="seq_twin", timeout=600):
    """18b (and 18d): the twin at the bench LM's width on ``mesh``: the
    masked loss falls (LEARNING), every rank ends with the same parameters
    bit for bit, and B1, B2 and B3 launch n_layers × (the ring's hops the
    rank runs) a step that runs its wrappers (eager steps and captures),
    all on the tensor-core route (the causal ring's rank at seq coordinate
    c runs hops 0..c; a future block is skipped)."""
    from horovod_tpu_torch.parallel import mesh as tmesh

    knobs = dict(SEQ_TWIN, HVT_MESH=mesh, HVT_BACKEND=backend,
                 PYTHONUNBUFFERED="1")
    lines, wall, _, _ = _launch(name, nprocs, None, knobs,
                                code=SEQ_TWIN_CHILD, timeout=timeout)
    recs = [json.loads(_rank_line(lines, "seq_twin ", r))
            for r in range(nprocs)]
    check(any("[rank 0] packed pretraining: LEARNING" in ln for ln in lines),
          f"{name}: the twin did not print LEARNING: "
          + str([ln for ln in lines if "masked loss" in ln]))
    check(len({r["params_sha256"] for r in recs}) == 1,
          f"{name}: the ranks' parameters differ after the fit")
    spec = tmesh.MeshSpec.from_string(mesh)
    layers = int(SEQ_TWIN["NLAYERS"])
    for rec in recs:
        hops = tmesh.build_mesh(spec, n_ranks=nprocs,
                                rank=rec["rank"]).coords["seq"] + 1
        want = (rec["eager_steps"] + rec["captures"]) * layers * hops
        for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            got, tc = rec["launches"][kname], rec["launches"][kname + "_tc"]
            check(got == tc == want,
                  f"{name} rank {rec['rank']}: {kname} launched {got} times "
                  f"({tc} on tc), want (eager steps + captures) × n_layers "
                  f"× hops = {want}")
    step = max(r["step_ms_median"] for r in recs)
    tokens = 8 * spec.resolve(nprocs)["data"] * int(SEQ_TWIN["SEQ_LEN"])
    res = {"mesh": mesh, "backend": backend, "losses": recs[0]["losses"],
           "steps": recs[0]["steps"],
           "step_ms_median": [r["step_ms_median"] for r in recs],
           "tokens_per_s": tokens / (step / 1e3),
           "tokens_per_s_per_card": (tokens / (step / 1e3)
                                     / (nprocs if backend == "nccl" else 1)),
           "ring_bytes_per_step": [r["ring_bytes_per_step"] for r in recs],
           "ring_shifts_per_step": [r["ring_shifts_per_step"] for r in recs],
           "peak_memory_gib": [r["peak_memory_gib"] for r in recs],
           "eager_steps": [r["eager_steps"] for r in recs],
           "captures": [r["captures"] for r in recs],
           "replays": [r["replays"] for r in recs],
           "launches": [r["launches"] for r in recs],
           "launch_wall_s": wall, "card": card}
    log("phase18b" if name == "seq_twin" else "phase18d", json.dumps(res))
    return res


def seq_vs_one_rank(torch, card):
    """18c: a 2-layer f32 model at seq = 2 (two gloo ranks on the card)
    against one rank on the card — logits, loss, every gradient — for the
    flash ring, Ulysses, and the ring with window + sinks."""
    import numpy as np

    from horovod_tpu_torch.data.datasets import copy_task
    from horovod_tpu_torch.models import transformer as ttr

    out = os.path.join(WORK, "seq_plain_out")
    os.makedirs(out, exist_ok=True)
    x, y = copy_task(SEQ_PLAIN_ROWS, SEQ_PLAIN_T, MODEL["vocab_size"], seed=5)
    np.savez(os.path.join(out, "data.npz"), x=x, y=y)
    cfg = dict(MODEL, n_layers=2)
    sx, sy = _s2s_copy_task(SEQ_PLAIN_ROWS, S2S_E_T, S2S_E_T, seed=5)
    np.savez(os.path.join(out, "s2s.npz"), y=sy, **sx)
    knobs = {"SMOKE_DATA": os.path.join(out, "data.npz"), "SMOKE_OUT": out,
             "SMOKE_MODEL": json.dumps(cfg),
             "SMOKE_VARIANTS": json.dumps(SEQ_PLAIN_VARIANTS),
             "SMOKE_S2S": json.dumps(S2S_SMALL),
             "SMOKE_S2S_DATA": os.path.join(out, "s2s.npz"),
             "HVT_BACKEND": "gloo", "PYTHONUNBUFFERED": "1"}
    _, wall, _, _ = _launch("seq_plain", 2, None, knobs,
                            code=SEQ_PLAIN_CHILD, timeout=600)
    ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
             for r in range(2)]
    t = SEQ_PLAIN_T // 2
    res = {}
    for name, (kw, _) in SEQ_PLAIN_VARIANTS.items():
        m = ttr.TransformerLM(**cfg, **kw, seed=4, device=DEVICE)
        xt, yt = (torch.from_numpy(a).to(DEVICE) for a in (x, y))
        with torch.no_grad():
            logits = m(xt).cpu().numpy()
        loss, _ = m(xt, labels=yt, train=True, dropout_seed=0)
        loss.mean().backward()
        loss = loss.detach().cpu().numpy()
        worst = {"logits": 0.0, "loss": 0.0, "grad_share_of_max": 0.0}
        for r, got in enumerate(ranks):
            cols = slice(r * t, (r + 1) * t)
            worst["logits"] = max(worst["logits"], float(np.abs(
                got[name + ".logits"] - logits[:, cols]).max()))
            worst["loss"] = max(worst["loss"], float(np.abs(
                got[name + ".loss"] - loss[:, cols]).max()))
            for pn, p in m.named_parameters():
                g = p.grad.cpu().numpy()
                worst["grad_share_of_max"] = max(
                    worst["grad_share_of_max"],
                    float(np.abs(got[f"{name}.g.{pn}"] - g).max())
                    / max(float(np.abs(g).max()), 1e-30))
        res[name] = worst
        check(worst["logits"] <= LOGITS_ATOL
              and worst["loss"] <= TRAIN_LOSS_ATOL
              and worst["grad_share_of_max"] <= TRAIN_GRAD_REL,
              f"18c {name}: seq = 2 differs from one rank: {worst}")
    log("phase18c", json.dumps(dict(res, launch_wall_s=wall, card=card)))
    log("phase19e", json.dumps(dict(
        seq2seq_vs_one_rank(torch, ranks, sx, sy), card=card)))
    return res


def seq2seq_vs_one_rank(torch, ranks, x, y):
    """19e: the f32 seq2seq of `S2S_SMALL` at seq = 2 (18c's two gloo
    ranks; a padded source block rotates in the cross ring) against one
    rank on the card: logits, per-token loss and every gradient of the
    mean loss, at phase 7's tolerances."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models.seq2seq import Seq2SeqTransformer

    m = Seq2SeqTransformer(**S2S_SMALL, seed=3, device=DEVICE)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in x.items()}
    logits = m(batch)
    loss = F.cross_entropy(logits.float().flatten(0, 1),
                           torch.from_numpy(y).to(DEVICE).long().flatten(),
                           reduction="none").view(logits.shape[:2])
    loss.mean().backward()
    logits, loss = logits.detach().cpu().numpy(), loss.detach().cpu().numpy()
    t = S2S_E_T // 2
    worst = {"logits": 0.0, "loss": 0.0, "grad_share_of_max": 0.0}
    for r, got in enumerate(ranks):
        cols = slice(r * t, (r + 1) * t)
        worst["logits"] = max(worst["logits"], float(abs(
            got["s2s.logits"] - logits[:, cols]).max()))
        worst["loss"] = max(worst["loss"], float(abs(
            got["s2s.loss"] - loss[:, cols]).max()))
        for pn, p in m.named_parameters():
            g = p.grad.cpu().numpy()
            worst["grad_share_of_max"] = max(
                worst["grad_share_of_max"],
                float(abs(got["s2s.g." + pn] - g).max())
                / max(float(abs(g).max()), 1e-30))
    check(worst["logits"] <= LOGITS_ATOL and worst["loss"] <= TRAIN_LOSS_ATOL
          and worst["grad_share_of_max"] <= TRAIN_GRAD_REL,
          f"19e: seq2seq at seq = 2 differs from one rank: {worst}")
    return dict(worst, rows=SEQ_PLAIN_ROWS, src=S2S_E_T, tgt=S2S_E_T)


def seq_multi_card(torch, card, ranks, dense):
    """18d (``--ranks 4``): the twin at ``data=2,seq=2`` on four NCCL ranks,
    each step after the first a replay of one captured graph (the ring's
    sends and receives, the loss's gather and the gradient all-reduce in
    it); every rank's parameters bit-equal; tokens/s a card beside the
    dense LM at four data ranks (17e's run, ``dense``)."""
    check(ranks == 4, "18d runs at --ranks 4")
    res = seq_twin(torch, card, nprocs=ranks, mesh="data=2,seq=2",
                   backend="nccl", name="seq_4card", timeout=300)
    check(all(c == 1 for c in res["captures"])
          and all(e == 1 for e in res["eager_steps"]),
          f"18d: want one eager step and one capture a rank: {res}")
    log("phase18d_dense", json.dumps({
        "seq_tokens_per_s_per_card": res["tokens_per_s_per_card"],
        "dense_tokens_per_s_per_card": dense, "card": card}))
    return dict(res, dense_tokens_per_s_per_card=dense)


def seq_phase(torch, card):
    """Phase 18: sequence parallelism and packed pretraining (18a and 18c;
    18b, a launched check, is `seq_twin` in the checks' lane)."""
    t0 = time.perf_counter()
    res = {"a": ring_hops(torch, card)}
    torch.cuda.empty_cache()
    res["c"] = seq_vs_one_rank(torch, card)
    res["seconds"] = time.perf_counter() - t0
    log(f"phase18 seconds: {res['seconds']:.1f}")
    return res


# -- phase 19 ----------------------------------------------------------------

# 19b: bench.py's seq2seq mode (bench.py:243-285): vocab 8192, d 512, 8
# heads, 6 + 6 layers, source and target 1024, batch 8, bf16 compute and
# logits, AdamW(scale_lr(3e-4)), dropout 0; its copy task (labels = the
# source, the decoder input BOS + the source shifted) with pad tails of
# [0, S2S_PAD_MAX) tokens on the source, so the encoder's and the cross
# sites' padding masks are live.
S2S_MODEL = dict(vocab_size=8192, d_model=512, n_heads=8, n_enc_layers=6,
                 n_dec_layers=6, dropout=0.0)
S2S_ROWS, S2S_PAD_MAX, S2S_BOS = 512, 256, 1
# Attention sites a step: 6 encoder + 6 decoder self + 6 cross.
S2S_SITES = 6 + 6 + 6
# 19b's f32 check: 2 + 2 layers at the bench width, 2 rows of 256 + 256.
S2S_SMALL = dict(S2S_MODEL, n_enc_layers=2, n_dec_layers=2)
S2S_SMALL_ROWS, S2S_SMALL_T = 2, 256
# 19e: S2S_SMALL in f32 at seq = 2, SEQ_PLAIN_ROWS rows of 512 + 512.
S2S_E_T = 512
# 19c: 64 greedy tokens for 8 sources of 1024. The cached steps and the
# teacher-forced recompute round bf16 logits differently: a token may
# differ only where the recompute's top two logits lie within two bf16
# ulps of the top one (counted).
S2S_NEW = 64
# 19f: LoRA on the bench LM (rank 8, alpha 16, the default targets).
LORA_RANK, LORA_ALPHA = 8, 16.0

S2S_TWIN_CHILD = r"""
import json
from horovod_tpu_torch.examples import seq2seq_translation as twin
from horovod_tpu_torch.ops import flash_attention as fa

history, acc = twin.main()
print("s2s_twin", json.dumps({
    "losses": [e["loss"] for e in history], "accuracy": acc,
    "epoch_s": [e["epoch_time_s"] for e in history],
    "launches": {"flash_fwd": fa.launches, "flash_fwd_tc": fa.launches_tc,
                 "flash_bwd_dq": fa.launches_bwd_dq,
                 "flash_bwd_dkv": fa.launches_bwd_dkv}}), flush=True)
"""


def _s2s_copy_task(rows, s, t, seed):
    """bench.py's seq2seq copy task with pad tails on the source: ``(x =
    {"src", "tgt"}, y)``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    src = rng.randint(3, S2S_MODEL["vocab_size"], (rows, s)).astype(np.int32)
    for i, tail in enumerate(rng.randint(0, S2S_PAD_MAX * s // 1024, rows)):
        if tail:
            src[i, s - tail:] = 0
    y = src[:, :t].copy()
    tgt = np.concatenate([np.full((rows, 1), S2S_BOS, np.int32),
                          y[:, :-1]], axis=1)
    return {"src": src, "tgt": tgt}, y


def _fa_counts(fa):
    return {"flash_fwd": fa.launches, "flash_fwd_tc": fa.launches_tc,
            "flash_bwd_dq": fa.launches_bwd_dq,
            "flash_bwd_dq_tc": fa.launches_bwd_dq_tc,
            "flash_bwd_dkv": fa.launches_bwd_dkv,
            "flash_bwd_dkv_tc": fa.launches_bwd_dkv_tc}


def _fa_zero(fa):
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    fa.launches_tc = fa.launches_bwd_dq_tc = fa.launches_bwd_dkv_tc = 0


def _held(torch, name, got, want, forward):
    """The largest absolute difference of a kernel's outputs from its
    plain version's on the same inputs, checked to phase 3's tolerances
    (B1: O and lse) or phase 4's (B2, B3: each gradient) at bf16."""
    got = (got,) if torch.is_tensor(got) else tuple(got)
    want = (want,) if torch.is_tensor(want) else tuple(want)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite output {i}")
        err = (g - w).abs()
        if forward and i == 1:  # lse
            ok = float(err.max()) <= TOL["bfloat16"]["lse"]
        elif forward:
            ok = bool((err <= TOL["bfloat16"]["o_atol"]
                       + TOL["bfloat16"]["o_rtol"] * w.abs()).all())
        else:
            tol = GRAD_TOL["bfloat16"]
            ok = bool((err <= tol["atol_of_max"] * float(w.abs().max())
                       + tol["rtol"] * w.abs()).all())
        check(ok, f"{name}: output {i} differs from the plain version "
              f"(max abs {float(err.max()):.3g})")
        if not (forward and i == 1):
            worst = max(worst, float(err.max()))
    return worst


def seq2seq_mask_timings(torch, card, shape=TRAIN_ATTN_SHAPE, phase="19a",
                         seed=19):
    """19a's times: B1, B2 and B3 at the bench seq2seq's encoder site
    (``shape`` [8, 1024, 8, 64] bf16, non-causal, q = kv = the source's
    padding ids) and cross site (target 1024 against source 1024, q ids
    1, kv ids the padding): kernel (held against its plain version,
    `_held`), plain version, the bound for the pairs these ids keep, and
    SDPA with the same boolean mask (forward; forward + backward less
    forward). 22a: the same at a ``model=2`` rank's 4 heads."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import flash_attention as fa

    b, t, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, dout = (torch.randn(b, t, h, d, generator=gen, device="cuda")
                     .to(torch.bfloat16) for _ in range(4))
    masks = dict(causal=False, window=None, sinks=0, q_offset=None)
    qh, kh, vh, gh = (x.transpose(1, 2).contiguous() for x in (q, k, v, dout))
    out_t = {}
    for site, kind in (("encoder_padded", "pad"), ("cross_padded", "cross")):
        qi, ki = _mask_ids(torch, kind, b, t, t)
        keep = qi[:, :, None] == ki[:, None, :]
        kept = int(keep.sum()) * h
        seg = dict(q_segment_ids=qi, kv_segment_ids=ki)
        with torch.inference_mode():
            out, lse = fa._launch(q, k, v, qi, ki, **masks)
            delta = (dout.float() * out.float()).sum(-1)
        entry = {"shape": [b, t, h, d], "kept_pairs": kept}
        sdpa_mask = keep[:, None]
        with torch.inference_mode():
            lib_fwd = device_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=sdpa_mask), 20)
        qg, kg, vg = (x.clone().requires_grad_() for x in (qh, kh, vh))

        def fwd_bwd():
            o = F.scaled_dot_product_attention(qg, kg, vg,
                                               attn_mask=sdpa_mask)
            torch.autograd.grad(o, (qg, kg, vg), gh)

        lib_bwd = device_ms(torch, fwd_bwd, 10) - lib_fwd
        calls = {
            "flash_fwd_sm90": (
                "flash_fwd", lambda: fa._launch(q, k, v, qi, ki, **masks),
                lambda: fa.flash_attention_reference(q, k, v, causal=False,
                                                     **seg), lib_fwd),
            "flash_bwd_dq_sm90": (
                "flash_bwd_dq", lambda: fa._launch_dq(
                    q, k, v, dout, lse, delta, qi, ki, masks),
                lambda: fa.flash_bwd_dq_reference(
                    q, k, v, dout, lse, delta, causal=False, **seg),
                lib_bwd),
            "flash_bwd_dkv_sm90": (
                "flash_bwd_dkv", lambda: fa._launch_dkv(
                    q, k, v, dout, lse, delta, qi, ki, masks),
                lambda: fa.flash_bwd_dkv_reference(
                    q, k, v, dout, lse, delta, causal=False, **seg),
                lib_bwd),
        }
        with torch.inference_mode():
            for name, (work, kernel, plain, lib) in calls.items():
                bound, by = attention_bound_ms(b, t, t, h, h, d, "bfloat16",
                                               causal=False, kernel=work,
                                               kept=kept)
                err = _held(torch, f"{phase} {site} {name}", kernel(),
                            plain(), work == "flash_fwd")
                entry[name] = {"max_abs_err": err,
                               "ms": device_ms(torch, kernel, 20),
                               "plain_ms": device_ms(torch, plain, 3),
                               "library_ms": lib, "bound_ms": bound,
                               "bound_by": by}
        out_t[site] = entry
        log(f"time {phase} seq2seq {site} B{b} T{t} H{h} D{d} bf16 [tc]: "
            + ", ".join(f"{k_} {v_['ms']:.5f} ms (err {v_['max_abs_err']:.3g}, "
                        f"plain {v_['plain_ms']:.5f}, "
                        f"sdpa with the mask {v_['library_ms']:.5f}, bound "
                        f"{v_['bound_ms']:.5f} {v_['bound_by']})"
                        for k_, v_ in entry.items() if isinstance(v_, dict)))
    log(f"phase{phase}", json.dumps({"timings": out_t, "card": card}))
    return out_t


def seq2seq_train(torch, card):
    """19b: the bench seq2seq trained S2S steps at 8 × (1024 + 1024)
    through `Trainer.fit` with dict batches, the steps captured: the loss
    falls; every step that runs the wrappers (the eager warm-up and the
    capture) launches B1, B2 and B3 once a site, 18 each, all on tc, and
    the replays relaunch them; steps 20-24 profiled for the device's busy
    share. Returns the fit's counts and the trained model."""
    import numpy as np

    from horovod_tpu_torch import (
        DistributedOptimizer, Trainer, adamw, scale_lr,
    )
    from horovod_tpu_torch.models.seq2seq import Seq2SeqTransformer
    from horovod_tpu_torch.ops import flash_attention as fa

    x, y = _s2s_copy_task(S2S_ROWS, TRAIN_SEQ, TRAIN_SEQ, seed=0)
    model = Seq2SeqTransformer(**S2S_MODEL, compute_dtype=torch.bfloat16,
                               logits_dtype=torch.bfloat16, device=DEVICE,
                               seed=0)
    trainer = Trainer(model, DistributedOptimizer(adamw(scale_lr(3e-4))),
                      loss="sparse_categorical_crossentropy", seed=0,
                      device=DEVICE)
    trainer.build()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _fa_zero(fa)
    window = 5
    t0 = time.perf_counter()
    prof, host_ms = profiled_fit(torch, lambda cbs: trainer.fit(
        x=x, y=y, batch_size=TRAIN_BATCH, epochs=TRAIN_STEPS,
        steps_per_epoch=1, callbacks=cbs, verbose=0), 20, window)
    wall = time.perf_counter() - t0
    launches = _fa_counts(fa)
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    losses = [e["loss"] for e in hist]
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"19b: non-finite seq2seq loss: {losses}")
    check(losses[-1] < losses[0],
          f"19b: the seq2seq loss did not fall: {losses[0]} -> {losses[-1]}")
    runner = trainer._runner
    check(runner.captures == 1 and runner.replays == TRAIN_STEPS - 1,
          f"19b: {runner.captures} captures and {runner.replays} replays, "
          f"want 1 and {TRAIN_STEPS - 1}")
    want = S2S_SITES * (runner.eager_steps + runner.captures)
    for name, n in launches.items():
        check(n == want, f"19b: {name} launched {n} times, want 18 sites × "
              f"(eager steps + captures) = {want} (all on tc)")
    per_step, _ = _per_step(torch, prof, window, host_ms)
    steady = sorted(e["epoch_time_s"] * 1e3 for i, e in enumerate(hist)
                    if i >= 2 and not 20 <= i < 20 + window)
    median = steady[len(steady) // 2]
    res = {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "src": TRAIN_SEQ,
           "tgt": TRAIN_SEQ, "pad_tokens_share": float((x["src"] == 0).mean()),
           "wall_s": wall, "loss_first": losses[0], "loss_last": losses[-1],
           "step_ms_median": median, "step_ms_min": steady[0],
           "step_ms_max": steady[-1],
           "target_tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (median / 1e3),
           "peak_memory_gib": peak / 2**30, "launches": launches,
           "eager_steps": runner.eager_steps, "captures": runner.captures,
           "graph_replays": runner.replays,
           "profiled_steps_20_24": {k: v for k, v in per_step.items()
                                    if k != "top_kernels_ms_per_step"},
           "top_kernels_ms_per_step": per_step["top_kernels_ms_per_step"][:5],
           "card": card}
    log("phase19b", json.dumps(res))
    return res, model, x


def seq2seq_vs_plain(torch, card):
    """19b's f32 check: one forward and backward of a 2 + 2-layer f32
    seq2seq at the bench width, 2 rows of 256 + 256 with pad tails, on the
    card (the CUDA-core kernels) and on the CPU (the plain versions), from
    the same seeded weights: the loss and every gradient to phase 7's
    tolerances."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models.seq2seq import Seq2SeqTransformer
    from horovod_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = _s2s_copy_task(S2S_SMALL_ROWS, S2S_SMALL_T, S2S_SMALL_T, seed=1)
    runs = {}
    for dev in (DEVICE, "cpu"):
        model = Seq2SeqTransformer(**S2S_SMALL, device=dev, seed=3)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in x.items()}
        _fa_zero(fa)
        logits = model(batch)
        loss = F.cross_entropy(logits.float().flatten(0, 1),
                               torch.from_numpy(y).to(dev).long().flatten())
        loss.backward()
        runs[dev] = (float(loss), {n: p.grad.cpu() for n, p in
                                   model.named_parameters()},
                     _fa_counts(fa))
    (lg, gg, counts), (lc, gc, _) = runs[DEVICE], runs["cpu"]
    sites = S2S_SMALL["n_enc_layers"] + 2 * S2S_SMALL["n_dec_layers"]
    check(counts["flash_fwd"] == counts["flash_bwd_dq"]
          == counts["flash_bwd_dkv"] == sites
          and counts["flash_fwd_tc"] == 0,
          f"19b f32: want {sites} CUDA-core launches of each kernel: {counts}")
    grad_err = max(float((gg[n] - g).abs().max()) / max(float(g.abs().max()),
                                                         1e-30)
                   for n, g in gc.items())
    res = {"loss_card": lg, "loss_cpu": lc, "loss_abs_err": abs(lg - lc),
           "grad_max_err_of_max": grad_err, "launches": counts, "card": card}
    check(abs(lg - lc) <= TRAIN_LOSS_ATOL and grad_err <= TRAIN_GRAD_REL,
          f"19b f32: card vs cpu differ beyond phase 7's limits: {res}")
    log("phase19b_f32", json.dumps(res))
    return res


def seq2seq_generate(torch, card, model, x):
    """19c: greedy generation from 19b's trained weights, 8 sources of
    1024, 64 new tokens: the encoder's 6 B1 launches (tc) a call, then the
    BOS prefill and 63 steps, replays of one captured step; the tokens
    against the teacher-forced argmax on the card, with counted near-ties
    (`S2S_NEW`'s note); tokens/s of a second call."""
    from horovod_tpu_torch.models.seq2seq import make_seq2seq_generate_fn
    from horovod_tpu_torch.ops import flash_attention as fa

    src = torch.from_numpy(x["src"][:TRAIN_BATCH]).to(DEVICE)
    fn = make_seq2seq_generate_fn(model, max_new_tokens=S2S_NEW,
                                  bos_id=S2S_BOS)
    fn(src)  # the warm-up step and the capture
    first = fn.steps.counts()
    _fa_zero(fa)
    out, ms = _timed(torch, lambda: fn(src))
    b1 = _fa_counts(fa)
    counts = {k: v - first[k] for k, v in fn.steps.counts().items()}
    check(b1["flash_fwd"] == b1["flash_fwd_tc"] == S2S_MODEL["n_enc_layers"],
          f"19c: the encode launched B1 {b1}, want "
          f"{S2S_MODEL['n_enc_layers']} on tc")
    check(counts == {"eager_steps": 0, "captures": 0,
                     "replays": S2S_NEW - 1},
          f"19c: the steps were not all replays: {counts}")
    tf_in = torch.cat([torch.full((TRAIN_BATCH, 1), S2S_BOS,
                                  dtype=torch.int32, device=DEVICE),
                       out[:, :-1]], dim=1)
    with torch.no_grad():
        logits = model({"src": src, "tgt": tf_in}).float()
    top2 = torch.topk(logits, 2, dim=-1).values
    differ = logits.argmax(-1) != out.long()
    limit = 2 * torch.finfo(torch.bfloat16).eps * top2[..., 0].abs()
    near = (top2[..., 0] - top2[..., 1]) <= limit
    check(bool((~differ | near).all()),
          "19c: a generated token differs from the teacher-forced argmax "
          "without a near-tie")
    res = {"rows": TRAIN_BATCH, "source": TRAIN_SEQ, "new_tokens": S2S_NEW,
           "ms": ms, "tokens_per_s": TRAIN_BATCH * S2S_NEW / ms * 1e3,
           "steps": counts, "b1_launches": b1,
           "near_tie_differences": int(differ.sum()),
           "equal_to_teacher_forced": not bool(differ.any()), "card": card}
    log("phase19c", json.dumps(res))
    return res


def seq2seq_twin_start():
    """19d: the twin of ``examples/seq2seq_translation.py`` at its default
    knobs on the card, launched in a thread (it runs beside the checks'
    lane and phases 15-18); `seq2seq_twin_check` joins it."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(_launch, "s2s_twin", 1, None,
                      {"PYTHONUNBUFFERED": "1"}, timeout=600,
                      code=S2S_TWIN_CHILD)
    pool.shutdown(wait=False)
    return fut


def seq2seq_twin_check(fut, card):
    lines, wall, _, _ = fut.result()
    rec = json.loads(_rank_line(lines, "s2s_twin "))
    check(any(ln == "[rank 0] REVERSAL LEARNED" for ln in lines),
          "19d: the twin did not print REVERSAL LEARNED: "
          + str([ln for ln in lines if "accuracy" in ln or "REVERSAL" in ln]))
    res = {"accuracy": rec["accuracy"], "losses": rec["losses"],
           "epoch_s": rec["epoch_s"], "launches": rec["launches"],
           "lines": [ln for ln in lines if ln.startswith(tuple(
               "[rank 0] " + k for k in ("byte-BPE", "src:", "out:",
                                         "held-out", "REVERSAL",
                                         "dropped")))],
           "launch_wall_s": wall, "card": card}
    log("phase19d", json.dumps(res))
    return res


def lora_train(torch, card, dense_step_ms):
    """19f: `LoRAModel` (rank 8, alpha 16, the default targets) around the
    bench LM, `freeze_base(adamw)`, the fused-CE head, 30 captured steps at
    8 × 1024 of phase 6's feed: the base bit-equal at the end, every
    adapter's B moved, the loss falls, B1-B3 on tc (n_layers × (eager steps
    + captures) each); the merged model's logits against the wrapped
    forward's within bf16's two ulps; the optimizer's state bytes against
    a full AdamW's; the step against phase 6's dense LM step."""
    import numpy as np

    from horovod_tpu_torch import (
        DistributedOptimizer, Trainer, adamw, scale_lr,
    )
    from horovod_tpu_torch.data.datasets import copy_task
    from horovod_tpu_torch.models import lora
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.ops import flash_attention as fa

    x, y = copy_task(4096, TRAIN_SEQ, MODEL["vocab_size"])
    feed = _draw(x, y, np.random.RandomState(0))
    inner = TransformerLM(**MODEL, compute_dtype=torch.bfloat16,
                          fused_head_chunks=8, device=DEVICE, seed=0)
    model = lora.LoRAModel(inner, rank=LORA_RANK, alpha=LORA_ALPHA)
    base0 = {k: v.clone() for k, v in inner.state_dict().items()}
    trainer = Trainer(model, DistributedOptimizer(
        lora.freeze_base(adamw(scale_lr(3e-4)))), loss="module", seed=0,
        device=DEVICE)
    trainer.build()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _fa_zero(fa)
    hist = trainer.fit(dataset=feed, epochs=TRAIN_STEPS, steps_per_epoch=1,
                       verbose=0)
    launches = _fa_counts(fa)
    runner = trainer._runner
    want = MODEL["n_layers"] * (runner.eager_steps + runner.captures)
    for name, n in launches.items():
        check(n == want, f"19f: {name} launched {n} times, want n_layers × "
              f"(eager steps + captures) = {want} (all on tc)")
    check(runner.replays == TRAIN_STEPS - runner.eager_steps,
          f"19f: {runner.replays} replays of {TRAIN_STEPS} steps")
    losses = [e["loss"] for e in hist]
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"19f: the LoRA loss did not fall: {losses[0]} -> {losses[-1]}")
    for k, v in inner.state_dict().items():
        check(torch.equal(v, base0[k]), f"19f: the frozen base moved: {k}")
    moved = sum(float(ab["b"].abs().max()) > 0
                for ab in model.adapters().values())
    check(moved == len(model.adapted),
          f"19f: {moved} of {len(model.adapted)} adapters moved")
    xb = torch.from_numpy(x[:TRAIN_BATCH]).to(DEVICE)
    plain = TransformerLM(**MODEL, compute_dtype=torch.bfloat16,
                          device=DEVICE, seed=0)
    plain.load_state_dict(lora.merge_params(model))
    with torch.no_grad():
        wrapped, merged = model(xb).float(), plain(xb).float()
    tol = TOL["bfloat16"]
    err = (merged - wrapped).abs()
    check(bool((err <= tol["o_atol"] + tol["o_rtol"] * wrapped.abs()).all()),
          f"19f: the merged forward differs from the wrapped forward "
          f"(max abs {float(err.max()):.3g})")
    n_params = sum(p.numel() for p in inner.parameters())
    steady = sorted(e["epoch_time_s"] * 1e3 for e in hist[2:])
    median = steady[len(steady) // 2]
    res = {"rank": LORA_RANK, "alpha": LORA_ALPHA,
           "adapted": len(model.adapted),
           "adapter_params": sum(p.numel() for p in model.lora.parameters()),
           "base_params": n_params,
           "optimizer_state_bytes": trainer.tx.state_bytes(),
           "full_adamw_state_bytes": 2 * 4 * n_params,
           "losses_first_last": [losses[0], losses[-1]],
           "step_ms_median": median, "step_ms_min": steady[0],
           "dense_lm_step_ms_phase6": dense_step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (median / 1e3),
           "merged_vs_wrapped_max_abs": float(err.max()),
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches, "eager_steps": runner.eager_steps,
           "captures": runner.captures, "graph_replays": runner.replays,
           "card": card}
    log("phase19f", json.dumps(res))
    return res


def seq2seq_phase(torch, card, twin, dense_step_ms):
    """Phase 19: the encoder-decoder family and LoRA (19a's mask cases ran
    in phases 3-4; 19e ran in 18c's child; 19d's twin was started beside
    phase 16)."""
    t0 = time.perf_counter()
    res = {"a": seq2seq_mask_timings(torch, card)}
    res["b"], model, x = seq2seq_train(torch, card)
    res["b_f32"] = seq2seq_vs_plain(torch, card)
    res["c"] = seq2seq_generate(torch, card, model, x)
    del model
    torch.cuda.empty_cache()
    res["f"] = lora_train(torch, card, dense_step_ms)
    res["d"] = seq2seq_twin_check(twin, card)
    res["seconds"] = time.perf_counter() - t0
    log(f"phase19 seconds: {res['seconds']:.1f}")
    return res


# -- phase 20 ----------------------------------------------------------------

# Phase 20: tensor parallelism and FSDP (no new kernel: Megatron's f and g,
# the logits' and head weight's gathers and FSDP's weight gathers and
# reduce-scatters are collectives and cuBLAS products around B1-B3).
# 20a: B1-B3 at the bench LM's attention on one rank of model = 2, 4 of its
# 8 heads, bf16 causal (tc), against their plain versions at phases 3/4's
# tolerances and timed; then a 2-layer f32 model at the bench width with
# model = 2 emulated in this process (two models, each holding one rank's
# cut, their row-parallel partial products summed here) against the
# unsharded model on the card, TP_SMALL_ROWS × TP_SMALL_T tokens, logits to
# phase 5's LOGITS_ATOL: a wrong qkv cut pairs q, k and v heads of other
# heads and moves the logits by O(1).
TP_ATTN_SHAPE = (8, 1024, 4, 64)
TP_SMALL_ROWS, TP_SMALL_T = 2, 512
# 20b/20c: the bench LM (bf16, fused-CE head in 8 chunks, AdamW(3e-4)) at
# model = 2 and at fsdp = 2, two gloo ranks sharing the card each, TP_STEPS
# eager steps of 8 × 1024 copy_task rows (`tp_batches`; the fsdp ranks 4
# rows each) from the seed-0 weights, against one rank on the same batches.
# The losses within one bf16 ulp (2^-8) of the one-rank loss: the Megatron
# sums round two bf16 partial products where one rank rounds one. The
# parameters: Adam moves an element by about lr a step whatever its
# gradient, so an element whose gradient sits within bf16 rounding of zero
# may step either way; each parameter's distance from the one-rank one
# within TP_UPDATE_RTOL of the one-rank update's norm (a 2-layer bf16 LM
# on the CPU: 0.085 at model = 2, 0.048 at fsdp = 2, after 4 steps); a
# wrong cut or reduction leaves the updates uncorrelated (about √2).
TP_STEPS, TP_LOSS_RTOL, TP_UPDATE_RTOL = 4, 2.0 ** -8, 0.25
# 20d (--ranks 4): fsdp = 2, model = 2 at four NCCL ranks, TP_4_STEPS
# captured steps of 8 × 1024 (each fsdp rank 4 rows); busy share over
# TP_4_WINDOW replays; then the twin of examples/lm_long_context.py at its
# defaults on HVT_MESH="seq=2,model=2".
TP_4_STEPS, TP_4_WINDOW = 30, 5

TP_CHILD = r"""
import hashlib, json, os, time
import numpy as np
import torch
import chip_smoke as cs
import horovod_tpu_torch as ht
from horovod_tpu_torch import callbacks, runtime
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import sharding

ht.init(device="cuda")
r = ht.rank()
dev = runtime.device()
steps = int(os.environ["SMOKE_STEPS"])
out = os.environ["SMOKE_OUT"]
mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(os.environ["SMOKE_MESH"]))
model = ttr.TransformerLM(**cs.TP_MODEL, sharding=ttr.ShardingConfig(
    mesh=mesh), device=dev, seed=0)
trainer = ht.Trainer(model, ht.DistributedOptimizer(ht.adamw(3e-4)),
                     loss="module", seed=0, mesh=mesh,
                     param_specs=ttr.param_specs, device=dev)
batches = [sharding.shard_batch(b, mesh) for b in cs.tp_batches(steps)]
heads = set()
launch = fa._launch


def recorded(q, *args, **kwargs):
    heads.add(int(q.shape[2]))
    return launch(q, *args, **kwargs)


fa._launch = recorded


class Clock(callbacks.Callback):
    def on_train_begin(self, logs=None):
        self.t, self.logs = [time.perf_counter()], []

    def on_batch_end(self, batch, logs=None):
        self.logs.append({k: float(v) for k, v in logs.items()})
        self.t.append(time.perf_counter())


clock = Clock()
trainer.build(*batches[0])
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
fa.launches_tc = fa.launches_bwd_dq_tc = fa.launches_bwd_dkv_tc = 0
trainer.fit(dataset=batches, epochs=1, steps_per_epoch=steps,
            callbacks=[clock, callbacks.MetricAverageCallback()], verbose=0)
launches = {"flash_fwd": fa.launches, "flash_fwd_tc": fa.launches_tc,
            "flash_bwd_dq": fa.launches_bwd_dq,
            "flash_bwd_dq_tc": fa.launches_bwd_dq_tc,
            "flash_bwd_dkv": fa.launches_bwd_dkv,
            "flash_bwd_dkv_tc": fa.launches_bwd_dkv_tc}
runner = trainer._runner
step_ms = sorted(1e3 * (b - a) for a, b in zip(clock.t[2:], clock.t[3:]))
median = step_ms[len(step_ms) // 2] if step_ms else None
res = {"rank": r, "coords": mesh.coords, "losses": [e["loss"] for e in
                                                   clock.logs],
       "launches": launches, "heads": sorted(heads),
       "eager_steps": runner.eager_steps, "captures": runner.captures,
       "replays": runner.replays, "step_ms_median": median,
       "tokens_per_s": (cs.TRAIN_BATCH * cs.TRAIN_SEQ / (median / 1e3)
                        if median else None),
       "param_bytes": sum(p.numel() * p.element_size()
                          for p in model.parameters()),
       "adam_bytes": trainer.tx.state_bytes(),
       "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
replicated = hashlib.sha256()
for n, p in model.named_parameters():
    if n not in trainer.placements:
        replicated.update(p.detach().cpu().numpy().tobytes())
res["replicated_sha256"] = replicated.hexdigest()
local = hashlib.sha256()
for p in model.parameters():
    local.update(p.detach().cpu().numpy().tobytes())
res["local_sha256"] = local.hexdigest()
if os.environ.get("SMOKE_PROFILE"):
    # A fit of 2 × window steps (one eager, one capture, replays); rank 0
    # profiles the last window.
    window = cs.TP_4_WINDOW

    def fit(cbs):
        trainer.fit(dataset=batches[:2 * window], epochs=1,
                    steps_per_epoch=2 * window, callbacks=cbs, verbose=0)

    if r == 0:
        prof, host_ms = cs.profiled_fit(torch, fit, window, window)
        per, _ = cs._per_step(torch, prof, window, host_ms)
        res["profile"] = dict(per, host_ms_per_step=host_ms)
    else:
        fit([])
full = trainer.state.full_model_state()
if r == 0:
    np.savez(os.path.join(out, "full.npz"),
             **{n: t.detach().float().cpu().numpy() for n, t in full.items()})
print("tp_child", json.dumps(res), flush=True)
"""

# The bench LM as 20b-d train it.
TP_MODEL = dict(MODEL, compute_dtype="bfloat16", fused_head_chunks=8)


def tp_batches(steps, seq=None, vocab=None):
    """20b-d's and 21's global batches: TRAIN_BATCH rows of
    copy_task(4096, TRAIN_SEQ) drawn with replacement from RandomState(20)
    a step (``seq``/``vocab`` other than the bench's rehearse on the
    CPU)."""
    import numpy as np

    from horovod_tpu_torch.data.datasets import copy_task

    x, y = copy_task(4096, seq or TRAIN_SEQ, vocab or MODEL["vocab_size"])
    rng = np.random.RandomState(20)
    out = []
    for _ in range(steps):
        idx = rng.randint(0, len(x), size=TRAIN_BATCH)
        out.append((x[idx], y[idx]))
    return out


def tp_kernels(torch, card):
    """20a: B1, B2 and B3 at TP_ATTN_SHAPE (a model = 2 rank's local
    heads), `shape_kernels`."""
    return shape_kernels(torch, TP_ATTN_SHAPE, "20a", "model=2 local heads",
                         20)


def _packed_ids(torch, gen, b, t):
    """``[b, t]`` int32 ids of two to four documents a row, the boundaries
    drawn from ``gen``."""
    n_docs = torch.randint(2, 5, (b,), generator=gen, device="cuda")
    ids = torch.zeros((b, t), dtype=torch.int32, device="cuda")
    for i in range(b):
        cuts = torch.sort(torch.randperm(t - 1, generator=gen,
                                         device="cuda")[:int(n_docs[i]) - 1]
                          + 1).values
        ids[i] = (torch.arange(t, device="cuda")[:, None]
                  >= cuts[None, :]).sum(-1).to(torch.int32)
    return ids


def shape_kernels(torch, shape, phase, note, seed, packed=False,
                  window=None):
    """B1, B2 and B3 at ``shape`` bf16 causal on the tensor-core route —
    with ``packed`` segment ids of two to four documents a row
    (`_packed_ids`), with a ``window`` — each against its plain version on
    the same inputs (phases 3/4's tolerances) and timed beside its plain
    version, its bound (the pairs the masks keep) and SDPA (with the
    boolean mask where the mask is not plain causal)."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import flash_attention as fa

    b, t, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, dout = (torch.randn(b, t, h, d, generator=gen, device="cuda")
                     .to(torch.bfloat16) for _ in range(4))
    ids = _packed_ids(torch, gen, b, t) if packed else None
    masks = dict(causal=True, window=window, sinks=0, q_offset=None)
    seg = dict(q_segment_ids=ids, kv_segment_ids=ids) if packed else {}
    ref_masks = dict(masks, **seg)
    tol, gtol = TOL["bfloat16"], GRAD_TOL["bfloat16"]
    checks = {}
    with torch.inference_mode():
        tc0 = (fa.launches_tc, fa.launches_bwd_dq_tc, fa.launches_bwd_dkv_tc)
        out, lse = fa._launch(q, k, v, ids, ids, **masks)
        delta = fa._delta(out, dout, None)
        got = (fa._launch_dq(q, k, v, dout, lse, delta, ids, ids, masks),
               *fa._launch_dkv(q, k, v, dout, lse, delta, ids, ids, masks))
        torch.cuda.synchronize()
        check((fa.launches_tc, fa.launches_bwd_dq_tc, fa.launches_bwd_dkv_tc)
              == tuple(n + 1 for n in tc0), f"{phase}: B1-B3 not on tc")
        ref_o, ref_lse = fa.flash_attention_reference(q, k, v, **ref_masks)
        o_err = (out.float() - ref_o.float()).abs()
        check(bool((o_err <= tol["o_atol"] + tol["o_rtol"]
                    * ref_o.float().abs()).all()),
              f"{phase}: O differs from the plain version (max abs "
              f"{float(o_err.max()):.3g})")
        lse_err = float((lse - ref_lse).abs().max())
        check(lse_err <= tol["lse"], f"{phase}: lse err {lse_err:.3g}")
        checks["flash_fwd_sm90"] = {"o_max_abs_err": float(o_err.max()),
                                    "lse_max_abs_err": lse_err}
        want = (fa.flash_bwd_dq_reference(q, k, v, dout, lse, delta,
                                          **ref_masks),
                *fa.flash_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                            **ref_masks))
        for gname, g, w in zip(("dq", "dk", "dv"), got, want):
            w = w.float()
            err = (g.float() - w).abs()
            atol = gtol["atol_of_max"] * float(w.abs().max())
            check(bool((err <= atol + gtol["rtol"] * w.abs()).all()),
                  f"{phase}: {gname} differs from the plain version (max abs "
                  f"{float(err.max()):.3g})")
            key = ("flash_bwd_dq_sm90" if gname == "dq"
                   else "flash_bwd_dkv_sm90")
            checks.setdefault(key, {})[gname] = float(err.max())
    calls = {
        "flash_fwd_sm90": ("flash_fwd", lambda: fa._launch(
            q, k, v, ids, ids, **masks),
            lambda: fa.flash_attention_reference(q, k, v, **ref_masks)),
        "flash_bwd_dq_sm90": ("flash_bwd_dq", lambda: fa._launch_dq(
            q, k, v, dout, lse, delta, ids, ids, masks),
            lambda: fa.flash_bwd_dq_reference(q, k, v, dout, lse, delta,
                                              **ref_masks)),
        "flash_bwd_dkv_sm90": ("flash_bwd_dkv", lambda: fa._launch_dkv(
            q, k, v, dout, lse, delta, ids, ids, masks),
            lambda: fa.flash_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                               **ref_masks)),
    }
    # The boolean mask SDPA takes where the masks are more than causal, and
    # the pairs they keep (this run's ids) for the bound.
    rows = torch.arange(t, device="cuda")[:, None]
    cols = torch.arange(t, device="cuda")[None, :]
    keep = cols <= rows
    if window is not None:
        keep = keep & (cols > rows - window)
    keep = keep[None, None].expand(b, 1, t, t)
    if packed:
        keep = keep & (ids[:, None, :, None] == ids[:, None, None, :])
    plain_causal = not packed and window is None
    sdpa = (dict(is_causal=True) if plain_causal
            else dict(attn_mask=keep))
    kept = None if plain_causal else int(keep.sum()) * h
    qh, kh, vh, gh = (x.transpose(1, 2).contiguous() for x in (q, k, v, dout))
    with torch.inference_mode():
        sdpa_fwd = device_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, **sdpa), 20)
    qg, kg, vg = (x.clone().requires_grad_() for x in (qh, kh, vh))

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, **sdpa)
        torch.autograd.grad(o, (qg, kg, vg), gh)

    sdpa_bwd = device_ms(torch, fwd_bwd, 20) - sdpa_fwd
    timings = {}
    what = "causal" + (" packed" if packed else "") + (
        f" window {window}" if window is not None else "")
    with torch.inference_mode():
        for name, (work, kernel, plain) in calls.items():
            bound, by = attention_bound_ms(b, t, t, h, h, d, "bfloat16",
                                           causal=True, kernel=work,
                                           window=window, kept=kept)
            timings[name] = {
                "shape": f"B{b} T{t} H{h} D{d} {what} bf16 ({note})",
                "ms": device_ms(torch, kernel, 20),
                "plain_ms": device_ms(torch, plain, 3),
                "library_ms": sdpa_fwd if work == "flash_fwd" else sdpa_bwd,
                "bound_ms": bound, "bound_by": by,
                "max_abs_err": max(checks[name].values())}
            r = timings[name]
            log(f"time {name} B{b} T{t} H{h} D{d} {what} bf16 [tc, {note}]: "
                f"kernel_ms {r['ms']:.5f} plain_ms "
                f"{r['plain_ms']:.5f} library_ms {r['library_ms']:.5f} "
                f"bound_ms {r['bound_ms']:.5f} ({by})")
    return {"checks": checks, "timings": timings}


def tp_emulated(torch, card):
    """20a's f32 check: a 2-layer model at the bench width, model = 2
    emulated in this process — two models, each built on a one-rank view
    of a model = 2 mesh whose `model` group is this rank alone (so f and g
    are the identity and each holds one rank's cut of the same seeded
    weights), run layer by layer with the two ranks' row-parallel partial
    products summed here and the LM head's logits joined — against the
    unsharded model on the card."""
    import numpy as np

    from horovod_tpu_torch.data.datasets import copy_task
    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import collectives, mesh as tmesh

    cfg = dict(MODEL, n_layers=2)
    shape = tmesh.MeshSpec(data=1, model=2).resolve(2)
    ranks = [ttr.TransformerLM(**cfg, device=DEVICE, seed=6,
                               sharding=ttr.ShardingConfig(mesh=tmesh.Mesh(
                                   shape, i, {"model": collectives.SELF})))
             for i in range(2)]
    plain = ttr.TransformerLM(**cfg, device=DEVICE, seed=6)
    x, _ = copy_task(TP_SMALL_ROWS, TP_SMALL_T, cfg["vocab_size"], seed=6)
    tokens = torch.from_numpy(np.asarray(x)).to(DEVICE)
    b, t = tokens.shape
    tc0, n0 = fa.launches_tc, fa.launches
    with torch.no_grad():
        want = plain(tokens)
        m0 = ranks[0]
        positions = m0._positions(tokens, None)
        h = m0._embed(tokens)
        for layer in range(cfg["n_layers"]):
            blks = [m.blocks[layer] for m in ranks]
            a = blks[0].ln_attn(h)
            parts = []
            for blk in blks:
                q, k, v = blk._qkv(a)
                q, k = ttr.rope(q, positions), ttr.rope(k, positions)
                o = fa.flash_attention(q, k, v, causal=True)
                parts.append(blk._row(blk.attn_out, o.reshape(b, t, -1)))
            h = h + parts[0] + parts[1]
            m = blks[0].ln_mlp(h)
            h = h + sum(blk._mlp(m, train=False, decode=False)
                        for blk in blks)
        got = torch.cat([m.lm_head(m0.ln_f(h)) for m in ranks], dim=-1)
    err = float((got - want).abs().max())
    res = {"rows": b, "seq": t, "layers": cfg["n_layers"],
           "heads_a_rank": ranks[0].blocks[0].heads,
           "logits_max_abs_err": err,
           "b1_launches": fa.launches - n0, "b1_launches_tc": fa.launches_tc
           - tc0, "card": card}
    log("phase20a_f32", json.dumps(res))
    check(err <= LOGITS_ATOL,
          f"20a: model = 2 emulated differs from the unsharded model: {res}")
    return res


def tp_child_run(name, nprocs, mesh, steps, backend, profile=False):
    """One launch of TP_CHILD; returns (per-rank records, rank 0's whole
    parameters, wall seconds)."""
    import numpy as np

    out = os.path.join(WORK, name + "_out")
    os.makedirs(out, exist_ok=True)
    knobs = {"SMOKE_STEPS": str(steps), "SMOKE_MESH": mesh,
             "SMOKE_OUT": out, "HVT_BACKEND": backend,
             "SMOKE_PROFILE": "1" if profile else "",
             "PYTHONUNBUFFERED": "1"}
    lines, wall, _, _ = _launch(name, nprocs, None, knobs, code=TP_CHILD,
                                timeout=900)
    recs = [json.loads(_rank_line(lines, "tp_child ", r))
            for r in range(nprocs)]
    return recs, dict(np.load(os.path.join(out, "full.npz"))), wall


def tp_start():
    """20b and 20c, launched in threads (two gloo ranks each, all four
    sharing the card); `tp_phase` joins them."""
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futs = {"b": pool.submit(tp_child_run, "tp_model2", 2, "data=1,model=2",
                             TP_STEPS, "gloo"),
            "c": pool.submit(tp_child_run, "tp_fsdp2", 2, "data=1,fsdp=2",
                             TP_STEPS, "gloo")}
    pool.shutdown(wait=False)
    return futs


def tp_one_rank(torch):
    """The one-rank run 20b and 20c are held against: TP_STEPS eager steps
    of the same batches from the same weights. Returns (losses, the seed-0
    weights, the trained weights, parameter and Adam bytes)."""
    from horovod_tpu_torch import DistributedOptimizer, Trainer, adamw
    from horovod_tpu_torch.models.transformer import TransformerLM

    model = TransformerLM(**TP_MODEL, device=DEVICE, seed=0)
    start = {n: p.detach().float().cpu().numpy().copy()
             for n, p in model.named_parameters()}
    trainer = Trainer(model, DistributedOptimizer(adamw(3e-4)),
                      loss="module", seed=0, device=DEVICE)
    hist = trainer.fit(dataset=tp_batches(TP_STEPS), epochs=TP_STEPS,
                       steps_per_epoch=1, verbose=0, _eager=True)
    end = {n: p.detach().float().cpu().numpy()
           for n, p in model.named_parameters()}
    nbytes = (sum(p.numel() * p.element_size() for p in model.parameters()),
              trainer.tx.state_bytes())
    return [e["loss"] for e in hist], start, end, nbytes


def _tp_held(name, recs, full, one, nprocs, heads):
    """20b/20c against the one-rank run: losses, parameters, launches."""
    import numpy as np

    losses, start, end, nbytes = one
    # The global batch's loss: the mean of the batch shards' (equal rows);
    # the ranks of a model group hold equal ones.
    glob = [float(np.mean([r["losses"][i] for r in recs]))
            for i in range(TP_STEPS)]
    worst_loss = max(abs(a - b) / abs(b) for a, b in zip(glob, losses))
    ratios = {}
    for n, p in end.items():
        moved = float(np.linalg.norm(p - start[n]))
        ratios[n] = float(np.linalg.norm(full[n] - p)) / max(moved, 1e-30)
    want = MODEL["n_layers"] * TP_STEPS
    launches_ok = all(
        r["launches"][k] == r["launches"][k + "_tc"] == want
        for r in recs for k in ("flash_fwd", "flash_bwd_dq",
                                "flash_bwd_dkv"))
    res = {"ranks": nprocs, "losses": glob,
           "one_rank_losses": losses, "loss_max_rel_err": worst_loss,
           "update_rel_err_max": max(ratios.values()),
           "update_rel_err_median": sorted(ratios.values())[len(ratios) // 2],
           "worst_parameter": max(ratios, key=ratios.get),
           "launches": [r["launches"] for r in recs],
           "heads_a_launch": [r["heads"] for r in recs],
           "eager_steps": [r["eager_steps"] for r in recs],
           "step_ms_median_gloo_staging_not_speed": [
               r["step_ms_median"] for r in recs],
           "param_bytes_per_rank": [r["param_bytes"] for r in recs],
           "adam_bytes_per_rank": [r["adam_bytes"] for r in recs],
           "one_rank_param_bytes": nbytes[0],
           "one_rank_adam_bytes": nbytes[1],
           "peak_memory_gib": [r["peak_memory_gib"] for r in recs]}
    check(worst_loss <= TP_LOSS_RTOL,
          f"{name}: the losses differ from one rank's: {res}")
    check(res["update_rel_err_max"] <= TP_UPDATE_RTOL,
          f"{name}: the parameters differ from one rank's: {res}")
    check(launches_ok, f"{name}: B1-B3 launched other than n_layers × steps "
          f"= {want} on tc a rank: {res['launches']}")
    check(all(r["heads"] == [heads] for r in recs),
          f"{name}: B1 ran at {res['heads_a_launch']} heads, want {heads}")
    check(all(r["eager_steps"] == TP_STEPS for r in recs),
          f"{name}: want {TP_STEPS} eager steps a rank (gloo)")
    return res


def tp_phase(torch, card, futs=None):
    """Phase 20: tensor parallelism and FSDP. 20a's kernels are timed
    alone; 20b and 20c run in launched processes (``futs``, from an
    earlier `tp_start`, or started here), held against their one-rank
    reference, which runs here with 20a's f32 check."""
    t0 = time.perf_counter()
    res = {"a": tp_kernels(torch, card)}
    futs = futs or tp_start()
    res["a_f32"] = tp_emulated(torch, card)
    torch.cuda.empty_cache()
    one = tp_one_rank(torch)
    torch.cuda.empty_cache()
    heads = {"b": MODEL["n_heads"] // 2, "c": MODEL["n_heads"]}
    for part, fut in futs.items():
        recs, full, wall = fut.result()
        res[part] = dict(_tp_held(f"20{part}", recs, full, one, 2,
                                  heads[part]), launch_wall_s=wall,
                         card=card)
        log(f"phase20{part}", json.dumps(res[part]))
    c = res["c"]
    share = [p / c["one_rank_param_bytes"] for p in c["param_bytes_per_rank"]]
    log("phase20c_bytes", json.dumps({
        "param_plus_adam_bytes_per_rank": [
            p + a for p, a in zip(c["param_bytes_per_rank"],
                                  c["adam_bytes_per_rank"])],
        "one_rank_param_plus_adam_bytes": c["one_rank_param_bytes"]
        + c["one_rank_adam_bytes"], "param_share_per_rank": share,
        "card": card}))
    check(all(s < 0.55 for s in share),
          f"20c: a rank holds {share} of the one-rank parameters, want about "
          "half (the LayerNorm scales stay whole)")
    res["seconds"] = time.perf_counter() - t0
    log(f"phase20 seconds: {res['seconds']:.1f}")
    return res


def tp_multi_card(torch, card, ranks):
    """20d (``--ranks 4``): fsdp = 2, model = 2 at four NCCL ranks, each
    step after the first a replay of one captured graph holding f, g, the
    weight gathers and reduce-scatters; the replicated parameters (the
    LayerNorm scales, on every rank) bit-equal; step ms, tokens/s a card
    and the busy share of TP_4_WINDOW replays; the dense LM on one card
    from the same call; then the twin at ``seq=2,model=2``."""
    check(ranks == 4, "20d runs at --ranks 4")
    t0 = time.perf_counter()
    recs, _, wall = tp_child_run("tp_4card", 4, "data=1,fsdp=2,model=2",
                                 TP_4_STEPS, "nccl", profile=True)
    dense, _, _, _, _ = moe_child_run(torch, "dense_1card", 1, "data=1",
                                      TP_MODEL, TP_4_STEPS, "nccl")
    res = {"mesh": "data=1,fsdp=2,model=2", "losses": recs[0]["losses"],
           "eager_steps": [r["eager_steps"] for r in recs],
           "captures": [r["captures"] for r in recs],
           "replays": [r["replays"] for r in recs],
           "step_ms_median": [r["step_ms_median"] for r in recs],
           "tokens_per_s_per_card": min(r["tokens_per_s"]
                                        for r in recs) / ranks,
           "profile": recs[0].get("profile"),
           "launches": recs[0]["launches"], "heads_a_launch": recs[0]["heads"],
           "param_bytes_per_rank": [r["param_bytes"] for r in recs],
           "adam_bytes_per_rank": [r["adam_bytes"] for r in recs],
           "peak_memory_gib": [r["peak_memory_gib"] for r in recs],
           "dense_1card_tokens_per_s": dense[0]["tokens_per_s_per_card"],
           "dense_1card_step_ms_median": dense[0]["step_ms_median"],
           "launch_wall_s": wall, "card": card}
    losses = [sum(r["losses"][i] for r in recs) / ranks
              for i in range(TP_4_STEPS)]
    res["losses"] = losses
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"20d: the loss did not fall: {losses}")
    check(len({r["replicated_sha256"] for r in recs}) == 1,
          "20d: the replicated parameters differ between the ranks")
    check(all(r["captures"] == 1 and r["eager_steps"] == 1 for r in recs),
          f"20d: want one eager step and one capture a rank: {res}")
    log("phase20d", json.dumps(res))
    twin_lines, twin_wall, _, _ = _launch(
        "tp_twin", 4, "lm_long_context",
        {"HVT_MESH": "seq=2,model=2", "HVT_BACKEND": "nccl",
         "PYTHONUNBUFFERED": "1"}, timeout=900)
    report = [ln for ln in twin_lines if ln.startswith("[rank 0] ") and any(
        k in ln for k in ("first-half", "recall-half", "long-range recall",
                          "greedy-decode"))]
    check(len(report) == 4, f"20d: the twin printed no full report: {report}")
    res["twin"] = {"mesh": "seq=2,model=2", "report": report,
                   "epochs": [ln for ln in twin_lines
                              if ln.startswith("[rank 0] Epoch")],
                   "launch_wall_s": twin_wall, "card": card}
    log("phase20d_twin", json.dumps(res["twin"]))
    res["seconds"] = time.perf_counter() - t0
    return res


# -- phase 21 ----------------------------------------------------------------

# Phase 21: the pipeline (no new kernel: the handoffs are point-to-point
# sends and the output and input-cotangent broadcasts collectives; every
# stage runs B1 forward and B2/B3 backward a layer and a microbatch, and
# 1F1B's recompute runs B1 a second time).
# 21a: B1-B3 at a microbatch's attention ([2, 1024, 8, 64]: the 8 × 1024
# rows of a step in PP_MICRO microbatches) bf16 causal (tc), against their
# plain versions at phases 3/4's tolerances and timed beside the bound and
# SDPA.
PP_ATTN_SHAPE = (2, 1024, 8, 64)
# 21a+: B1-B3 there with packed segment ids (two to four documents a row,
# drawn from a seed) and under the window PP_WINDOW, and the ring's hops at
# a seq = 2 microbatch's block [2, 512, 8, 64] (`ring_hops`: the diagonal,
# a past block, a past block at q_offset 512 under the window), each
# against its plain version at phases 3/4's tolerances, timed beside the
# bound (the pairs the masks keep) and SDPA with the boolean mask.
PP_HOP_SHAPE = (2, 512, 8, 64)
# 21b: the bench LM as a bf16 `PipelinedLM` (the JAX model: f32 logits
# head, sparse cross-entropy; AdamW 3e-4) at data=1,pipe=2, two gloo ranks
# sharing the card, under GPipe, 1F1B and the interleaved schedule
# (n_virtual 2) in one launch, PP_STEPS eager steps of 8 × 1024
# (`tp_batches`) in PP_MICRO microbatches, against one rank on the same
# batches from the same seed-0 weights (in logical order for the
# interleaved placement): the first batch's gradient before any step
# within PP_GRAD_RTOL of the one-rank gradient's norm, leaf by leaf (AdamW's
# m/√v takes out any per-leaf scale, so a gradient S× or 1/S too large
# shows here and nowhere after: a relative error of 1 or 1/2); the losses
# within one bf16 ulp (2^-8) of the one-rank loss (a microbatch's GEMMs
# round as the whole batch's may not); each parameter within PP_UPDATE_RTOL
# of the one-rank update's norm (a wrong stage order or handoff leaves the
# updates uncorrelated, about √2; sound runs read 0.0152-0.0154 on the
# card, so the limit is four times that); each kernel launched (L/S) ×
# PP_MICRO times a step a rank (1F1B: B1 twice that), all tc; each rank's
# peak memory under each schedule. The gloo step ms are host staging, not
# speed.
PP_MODEL = dict(vocab_size=MODEL["vocab_size"], d_model=MODEL["d_model"],
                n_heads=MODEL["n_heads"], n_layers=MODEL["n_layers"],
                compute_dtype="bfloat16")
PP_SCHEDULES = ("gpipe", "1f1b", "interleaved")
PP_VIRTUAL = 2  # the PipelinedLM default
PP_STEPS, PP_MICRO = 4, 4
PP_LOSS_RTOL, PP_UPDATE_RTOL, PP_GRAD_RTOL = 2.0 ** -8, 0.06, 0.1
# 21c (--ranks 4; alone with --pp-only): the same model at data=1,pipe=4
# on NCCL under each schedule, PP_4_MICRO microbatches, PP_4_STEPS eager
# steps (the pipelined step is not captured), then PP_4_WINDOW more
# profiled on every rank: step ms, tokens/s a card, and each stage's busy
# and idle share beside the tick model's bubble (S − 1)/(v·T + S − 1); the
# stages' losses equal, 1F1B's within PP_LOSS_RTOL of GPipe's (ten steps
# at 3e-4 move the loss by less than the batches do: no "falls" gate);
# then the twin of examples/lm_long_context.py at HVT_MESH="data=1,pipe=2,
# model=2" SCHEDULE=1f1b.
PP_4_MICRO, PP_4_STEPS, PP_4_WINDOW = 8, 10, 5

# 21d: pp × sp at the bench width, packed and windowed: data=1,pipe=2,seq=2,
# four gloo ranks sharing the card (launched beside 12b-d, as 21b is), the
# bench LM as a bf16 PipelinedLM with window PP_WINDOW on packed rows
# (`pp_packed_batches`: data/packing.py's pack_documents of seeded
# documents of PP_DOC_LEN tokens, 2-4 a row, the ids carried in the input
# as the packed twin carries them) under 1F1B and GPipe, PP_SP_STEPS eager
# steps, against one rank on the same rows: 21b's gates. Each rank holds a
# [rows, 512] column block; its ring runs one hop on seq rank 0 (the other
# block is in its future) and two on seq rank 1 (the past block's newest
# key is inside the window), so B1-B3 launch (L/S) × n_micro × hops a step
# (1F1B: B1 twice that), all tc.
PP_WINDOW = 256
PP_DOC_LEN = (200, 520)
PP_SP_STEPS = 3
# 21e: the MoE pipeline at bench.py's MoE width (8 experts, top-2,
# capacity 1.25, groups of 1024 tokens; every block MoE, as JAX's
# pipelined MoE requires): at data=1,pipe=2 under the three schedules in
# 21b's launch, and at data=1,pipe=2,expert=2 under 1F1B in 21d's. A
# microbatch's rank holds 2 rows of 1024 tokens, so its dispatch groups are
# one row each, as the one-rank model's are. The one rank runs the same
# microbatches (`_microbatched`: the schedule on a one-stage ring): bf16
# GEMMs of the whole batch's shape round a few activations otherwise, which
# flips near-ties of the router's top-2, re-routes those tokens and
# re-slots every later token of their group, and the whole row after them
# through attention — against the whole-batch run the updates read 0.12-
# 0.15 of the one-rank update's norm on the card (P1, PR 17) where the
# dense model reads 0.015. Gates: 21b's, plus the first batch's load-
# balance loss within PP_MOE_AUX_RTOL of one rank's and its drop rate (and
# every logged step's) within PP_MOE_DROP_ATOL. A sowing model's fit runs
# one more forward, the metrics' discovery (`Trainer.discover_metrics`).
# The expert=2 run computes in f32 (B1-B3 on the CUDA-core route), as
# 17d does: its expert sum adds two bf16-rounded halves of the combine
# where one rank rounds the whole once, and in bf16 that alone flips
# near-ties.
PP_MOE = dict(mlp="moe", n_experts=8, moe_k=2, capacity_factor=1.25,
              moe_group_size=1024)
PP_MOE_AUX_RTOL, PP_MOE_DROP_ATOL = 1e-3, 1e-3

PP_CHILD = r"""
import hashlib, json, os, time
import numpy as np
import torch
import chip_smoke as cs
import horovod_tpu_torch as ht
from horovod_tpu_torch import callbacks, runtime
from horovod_tpu_torch.models import pipelined_lm as tpl
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import collectives, pipeline as tpipe
from horovod_tpu_torch.parallel import mesh as tmesh, sharding

# SMOKE_DEVICE / SMOKE_MODEL / SMOKE_SEQ rehearse this child on the CPU at a
# tiny size; the smoke itself runs it on the card at the bench LM's width.
ht.init(device=os.environ.get("SMOKE_DEVICE") or "cuda")
r = ht.rank()
dev = runtime.device()
cuda = dev.type == "cuda"
seq = int(os.environ.get("SMOKE_SEQ") or 0) or cs.TRAIN_SEQ
out = os.environ["SMOKE_OUT"]
COUNTS = {"flash_fwd": "launches", "flash_fwd_tc": "launches_tc",
          "flash_bwd_dq": "launches_bwd_dq",
          "flash_bwd_dq_tc": "launches_bwd_dq_tc",
          "flash_bwd_dkv": "launches_bwd_dkv",
          "flash_bwd_dkv_tc": "launches_bwd_dkv_tc"}
meshes = {}


class Clock(callbacks.Callback):
    def on_train_begin(self, logs=None):
        self.t, self.logs = [time.perf_counter()], []

    def on_batch_end(self, batch, logs=None):
        self.logs.append({k: float(v) for k, v in logs.items()})
        self.t.append(time.perf_counter())


res = {"rank": r}
for run in json.loads(os.environ["SMOKE_RUNS"]):
    key, steps, n_micro = run["key"], run["steps"], run["micro"]
    if run["mesh"] not in meshes:  # every rank builds them in one order
        meshes[run["mesh"]] = tmesh.build_mesh(
            tmesh.MeshSpec.from_string(run["mesh"]))
    mesh = meshes[run["mesh"]]
    model = cs.pp_model(torch, cs.pp_config(run), run["packed"],
                        n_micro=n_micro, mesh=mesh,
                        schedule=run["schedule"], device=dev, seed=0)
    spec = tmesh.P(("data", "fsdp"), "seq") if mesh.seq_shards > 1 else None
    trainer = ht.Trainer(model, ht.DistributedOptimizer(ht.adamw(3e-4)),
                         seed=0, mesh=mesh, param_specs=tpl.param_specs,
                         batch_specs=None if spec is None else (spec, spec),
                         device=dev)
    trainer.build()
    batches = [sharding.shard_batch(b, mesh) for b in cs.pp_batches(
        run["packed"], steps, seq, cs.pp_config(run)["vocab_size"])]
    rec = {"stage": mesh.stage, "coords": mesh.coords}
    if run.get("grads"):
        grads, rec["first"] = cs.pp_first_grads(torch, trainer, batches[0])
        if r == 0:
            np.savez(os.path.join(out, f"grads_{key}.npz"),
                     **{n: t.numpy() for n, t in grads.items()})
        del grads
    clock = Clock()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for attr in COUNTS.values():
        setattr(fa, attr, 0)
    sent = collectives.pipe_traffic["bytes"]
    trainer.fit(dataset=batches, epochs=1, steps_per_epoch=steps,
                callbacks=[clock, callbacks.MetricAverageCallback()],
                verbose=0)
    step_ms = sorted(1e3 * (b - a) for a, b in zip(clock.t[2:], clock.t[3:]))
    median = step_ms[len(step_ms) // 2] if step_ms else None
    rec.update({
        "losses": [e["loss"] for e in clock.logs],
        "drop_rates": [e.get("moe_drop_rate") for e in clock.logs],
        "launches": {k: getattr(fa, a) for k, a in COUNTS.items()},
        "eager_steps": trainer._runner.eager_steps,
        "captures": trainer._runner.captures,
        "step_ms_median": median,
        "tokens_per_s": (cs.TRAIN_BATCH * cs.TRAIN_SEQ / (median / 1e3)
                         if median else None),
        "peak_memory_gib": (torch.cuda.max_memory_allocated() / 2**30
                            if cuda else None),
        "ticks": tpipe.stats["ticks"],
        "backward_ticks": tpipe.stats["backward_ticks"],
        "passes_a_step": [len(tpipe.stats["forward"]),
                          len(tpipe.stats["backward"])],
        "handoff_bytes_per_step":
            (collectives.pipe_traffic["bytes"] - sent) / steps})
    if run.get("profile"):
        window = cs.PP_4_WINDOW

        def fit(cbs):
            trainer.fit(dataset=batches[:2 * window], epochs=1,
                        steps_per_epoch=2 * window, callbacks=cbs, verbose=0)

        prof, host_ms = cs.profiled_fit(torch, fit, window, window)
        per, by_name = cs._per_step(torch, prof, window, host_ms)
        # NCCL's kernels spin while they wait for the peer stage: their
        # time is the stage's wait, not its work.
        nccl = sum(ms for k, ms in by_name.items() if "nccl" in k) / window
        rec["profile"] = dict(per, host_ms_per_step=host_ms,
                              nccl_ms_per_step=nccl)
    # The replicated leaves (embedding, ln_f, head, router) take their
    # whole gradient on every rank: they must stay bit-equal.
    rec["replicated_sha256"] = hashlib.sha256(b"".join(
        p.detach().float().cpu().numpy().tobytes()
        for n, p in model.named_parameters()
        if n not in trainer.placements)).hexdigest()
    full = trainer.state.full_model_state()
    if r == 0:
        np.savez(os.path.join(out, f"full_{key}.npz"),
                 **{n: t.detach().float().cpu().numpy()
                    for n, t in full.items()})
    res[key] = rec
    del model, trainer, full
    if cuda:
        torch.cuda.empty_cache()
print("pp_child", json.dumps(res), flush=True)
"""


def pp_config(run):
    """The `PipelinedLM` fields of ``run``: PP_MODEL's, the run's, and a
    CPU rehearsal's ``SMOKE_MODEL`` over both."""
    return {**PP_MODEL, **run["model"],
            **json.loads(os.environ.get("SMOKE_MODEL") or "{}")}


def pp_model(torch, cfg, packed, **kw):
    """A `PipelinedLM` of ``cfg``; with ``packed`` inside a module that
    takes ``[B, T, 2]`` rows of tokens ⊕ segment ids (the packed twin's
    input, `examples.lm_packed_pretraining.PackedLM`)."""
    from horovod_tpu_torch.models import pipelined_lm as tpl

    inner = tpl.PipelinedLM(**cfg, **kw)
    if not packed:
        return inner

    class Packed(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = inner

        def forward(self, xs, *, train=False, dropout_seed=None):
            return self.inner(xs[..., 0], train=train,
                              segment_ids=xs[..., 1])

    return Packed()


def pp_packed_batches(steps, seq=None, vocab=None):
    """21d's global batches: TRAIN_BATCH packed rows a step
    (`data.packing.pack_documents` of documents of PP_DOC_LEN tokens drawn
    from RandomState(21), at most four a row), ``[rows, T, 2]`` tokens ⊕
    segment ids, the targets the tokens shifted left within the row (the
    last one 0)."""
    import numpy as np

    from horovod_tpu_torch.data.packing import pack_documents

    seq = seq or TRAIN_SEQ
    vocab = vocab or MODEL["vocab_size"]
    lo, hi = (max(1, n * seq // 1024) for n in PP_DOC_LEN)  # at T = 1024
    rng = np.random.RandomState(21)
    out = []
    for _ in range(steps):
        docs = [rng.randint(1, vocab, rng.randint(lo, hi)).astype(np.int32)
                for _ in range(4 * TRAIN_BATCH)]
        tokens, seg, _ = pack_documents(docs, seq, max_docs_per_row=4)
        tokens, seg = tokens[:TRAIN_BATCH], seg[:TRAIN_BATCH]
        y = np.zeros_like(tokens)
        y[:, :-1] = tokens[:, 1:]
        out.append((np.stack([tokens, seg], -1), y))
    return out


def pp_batches(packed, steps, seq=None, vocab=None):
    return (pp_packed_batches if packed else tp_batches)(steps, seq, vocab)


def pp_runs(names):
    """The child runs of `PP_RUNS` named ``names``, in that order."""
    return [dict(PP_RUNS[n], key=n) for n in names]


def pp_child_run(name, nprocs, runs, backend):
    """One launch of PP_CHILD over ``runs`` (`pp_runs`); returns (per-rank
    records, by run rank 0's whole ``params`` after the fit and, where the
    run takes them, the first batch's whole ``grads`` before it, wall
    seconds, the eager-step log lines)."""
    import numpy as np

    out = os.path.join(WORK, name + "_out")
    os.makedirs(out, exist_ok=True)
    knobs = {"SMOKE_RUNS": json.dumps(runs), "SMOKE_OUT": out,
             "HVT_BACKEND": backend, "PYTHONUNBUFFERED": "1"}
    lines, wall, _, _ = _launch(name, nprocs, None, knobs, code=PP_CHILD,
                                timeout=900)
    recs = [json.loads(_rank_line(lines, "pp_child ", r))
            for r in range(nprocs)]
    fulls = {run["key"]: {
        what: dict(np.load(os.path.join(out, f"{f}_{run['key']}.npz")))
        for what, f in (("params", "full"), ("grads", "grads"))
        if what == "params" or run.get("grads")} for run in runs}
    eager = [ln for ln in lines if "pipelined step runs eagerly" in ln]
    return recs, fulls, wall, eager


# Every run of phase 21's launches: its mesh, schedule, model overrides,
# whether its rows are packed, steps and microbatches, and whether the
# first batch's gradient is kept (21b/21d/21e) or the steps profiled (21c).
PP_RUNS = {
    **{s: dict(mesh="data=1,pipe=2", schedule=s, model={}, packed=False,
               steps=PP_STEPS, micro=PP_MICRO, grads=True)
       for s in PP_SCHEDULES},
    **{f"moe_{s}": dict(mesh="data=1,pipe=2", schedule=s, model=PP_MOE,
                        packed=False, steps=PP_SP_STEPS, micro=PP_MICRO,
                        grads=True)
       for s in PP_SCHEDULES},
    **{f"sp_{s}": dict(mesh="data=1,pipe=2,seq=2", schedule=s,
                       model={"window": PP_WINDOW}, packed=True,
                       steps=PP_SP_STEPS, micro=PP_MICRO, grads=True)
       for s in ("1f1b", "gpipe")},
    "ep_1f1b": dict(mesh="data=1,pipe=2,expert=2", schedule="1f1b",
                    model=dict(PP_MOE, compute_dtype="float32"),
                    packed=False, steps=PP_SP_STEPS, micro=PP_MICRO,
                    grads=True),
    **{f"4card_{s}": dict(mesh="data=1,pipe=4", schedule=s, model={},
                          packed=False, steps=PP_4_STEPS, micro=PP_4_MICRO,
                          profile=True)
       for s in PP_SCHEDULES},
    "4card_moe_ep": dict(mesh="data=1,pipe=2,expert=2", schedule="1f1b",
                         model=PP_MOE, packed=False, steps=PP_4_STEPS,
                         micro=PP_4_MICRO),
}
PP_2RANK = list(PP_SCHEDULES) + [f"moe_{s}" for s in PP_SCHEDULES]
PP_4RANK = ["sp_1f1b", "sp_gpipe", "ep_1f1b"]


def pp_start(torch):
    """21b/21e (two gloo ranks) and 21d/21e (four), launched in threads
    sharing the card, and their one-rank references (`pp_refs`) in a
    third; `pp_phase` joins them (the smoke joins the references before
    the phases that count launches)."""
    pool = concurrent.futures.ThreadPoolExecutor(3)
    futs = {"two": pool.submit(pp_child_run, "pp_pipe2", 2,
                               pp_runs(PP_2RANK), "gloo"),
            "four": pool.submit(pp_child_run, "pp_pipe2_seq2", 4,
                                pp_runs(PP_4RANK), "gloo"),
            "refs": pool.submit(pp_refs, torch)}
    pool.shutdown(wait=False)
    return futs


def pp_refs(torch):
    """The one-rank run each run of 21b/21d/21e is held against
    (`pp_one_rank`), one for each model, rows, steps and layer order."""
    ones, refs = {}, {}
    for key in PP_2RANK + PP_4RANK:
        run = PP_RUNS[key]
        order = "logical" if run["schedule"] == "interleaved" else "stored"
        same = (json.dumps(run["model"], sort_keys=True), run["packed"],
                run["steps"], order)
        if same not in ones:
            ones[same] = pp_one_rank(torch, key, order)
        refs[key] = ones[same]
    return refs


def pp_first_grads(torch, trainer, batch):
    """The gradient of ``trainer``'s objective (the mean loss plus the
    sown losses) on ``batch`` (this rank's rows) before any step, by
    parameter name as f32 CPU tensors, as the optimizer sums it: over the
    gradient group (the ``seq`` ranks' token blocks), divided by the data
    shards, the placed stacks gathered (a collective); and the first
    batch's MoE load-balance loss and drop rate (None for a dense model).
    The module's gradients are cleared before and after."""
    from horovod_tpu_torch.models.convert import gather_state_dict
    from horovod_tpu_torch.parallel import collectives
    from horovod_tpu_torch.training import train_state

    model, mesh = trainer.module, trainer.mesh
    x, y = (trainer._tensor(trainer.cut(a, i)) for i, a in enumerate(batch))
    model.zero_grad(set_to_none=True)
    loss_vec, _ = trainer._loss_and_correct(x, y, train=True)
    sown = train_state.sown_losses(model)
    (loss_vec.mean() + sum(v.float() for v in sown)).backward()
    grads = {n: p.grad.detach() for n, p in model.named_parameters()}
    if mesh is not None:
        grads = {n: collectives.all_reduce_sum(g, mesh.grad_group)
                 / mesh.data_shards for n, g in grads.items()}
        grads = gather_state_dict(grads, mesh, trainer.placements)
    drop = train_state.sown_metrics(model).get("moe_drop_rate")
    first = {"aux": float(sown[0].detach()) if sown else None,
             "drop": None if drop is None else float(drop)}
    model.zero_grad(set_to_none=True)
    return {n: g.float().cpu() for n, g in grads.items()}, first


def _microbatched(model):
    """``model`` (a one-rank `PipelinedLM`) made to run its schedule on a
    one-stage ring: the mesh of this process alone, whose ``pipe`` group is
    the rank itself, and ``pipe`` above 1, which sends the forward through
    `PipelinedLM._pipelined` — the microbatches, passes and GEMM shapes of
    a pipelined rank."""
    from horovod_tpu_torch.parallel import mesh as tmesh

    model.mesh, model.pipe = tmesh.build_mesh(), 2
    return model


def pp_one_rank(torch, key, order):
    """The one-rank run of ``PP_RUNS[key]``'s model, rows and steps that
    21b/21d/21e are held against: the first batch's gradient and MoE
    terms, then the steps eagerly from the seed-0 weights, as stored or in
    logical ``order`` (the interleaved placement at pipe = 2). Returns
    ``(losses, start, end, grads, first, drop_rates)``, parameters and
    gradients in the stored order."""
    from horovod_tpu_torch import DistributedOptimizer, Trainer, adamw
    from horovod_tpu_torch.models import pipelined_lm as tpl

    run = PP_RUNS[key]
    cfg = pp_config(run)
    L, steps = cfg["n_layers"], run["steps"]
    model = pp_model(torch, cfg, run["packed"], n_micro=run["micro"],
                     device="cpu", seed=0)
    if run["model"].get("mlp") == "moe":  # PP_MOE's comment says why
        _microbatched(model)
    stored = {n: t.clone() for n, t in model.state_dict().items()}
    if order == "logical":
        model.load_state_dict(tpl.to_logical_order(stored, L, 2, PP_VIRTUAL))
    model.to(DEVICE)
    batches = pp_batches(run["packed"], steps, vocab=cfg["vocab_size"])
    trainer = Trainer(model, DistributedOptimizer(adamw(3e-4)), seed=0,
                      device=DEVICE)
    grads, first = pp_first_grads(torch, trainer, batches[0])
    hist = trainer.fit(dataset=batches, epochs=steps, steps_per_epoch=1,
                       verbose=0, _eager=True)
    end = {n: p.detach().float().cpu() for n, p in model.named_parameters()}
    if order == "logical":
        end = tpl.to_interleaved_order(end, L, 2, PP_VIRTUAL)
        grads = tpl.to_interleaved_order(grads, L, 2, PP_VIRTUAL)
    out = ([e["loss"] for e in hist],
           {n: t.numpy() for n, t in stored.items()},
           {n: t.numpy() for n, t in end.items()},
           {n: t.numpy() for n, t in grads.items()}, first,
           [e.get("moe_drop_rate") for e in hist])
    del model, trainer
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def _hops(rec, key):
    """The ring hops whose kernels a rank of ``PP_RUNS[key]`` runs a
    layer: 1 without a live ``seq`` axis; on seq = 2 one on seq rank 0
    (the other block is its future) and two on rank 1 (the past block's
    newest key lies inside the window)."""
    if "seq=2" not in PP_RUNS[key]["mesh"]:
        return 1
    return 1 + rec["coords"]["seq"]


def _pp_held(key, recs, full, one, stages, phase):
    """Run ``key`` against its one-rank run: the first gradients (and MoE
    terms), losses, parameters, launches, ticks. ``full``: rank 0's whole
    ``params`` and ``grads`` (`pp_child_run`)."""
    import numpy as np

    run = PP_RUNS[key]
    sched, steps, n_micro = run["schedule"], run["steps"], run["micro"]
    losses, start, end, grads, first, drops = one
    runs = [r[key] for r in recs]
    g_err, g_ratio = {}, {}
    for n, g in grads.items():
        norm = max(float(np.linalg.norm(g)), 1e-30)
        g_err[n] = float(np.linalg.norm(full["grads"][n] - g)) / norm
        g_ratio[n] = float(np.linalg.norm(full["grads"][n])) / norm
    glob = [float(np.mean([r["losses"][i] for r in runs]))
            for i in range(steps)]
    worst_loss = max(abs(a - b) / abs(b) for a, b in zip(glob, losses))
    ratios = {}
    for n, p in end.items():
        moved = float(np.linalg.norm(p - start[n]))
        ratios[n] = (float(np.linalg.norm(full["params"][n] - p))
                     / max(moved, 1e-30))
    per_step = pp_config(run)["n_layers"] // stages * n_micro
    moe = run["model"].get("mlp") == "moe"
    # Forwards a fit runs: a step's (1F1B recomputes it) and a sowing
    # model's metric discovery.
    fwd = steps * (2 if sched == "1f1b" else 1) + (1 if moe else 0)
    wants = [{k: per_step * _hops(r, key) * (fwd if k == "flash_fwd"
                                             else steps)
              for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
             for r in runs]
    v = PP_VIRTUAL if sched == "interleaved" else 1
    res = {"run": key, "mesh": run["mesh"], "schedule": sched,
           "model": run["model"], "packed": run["packed"],
           "ranks": len(recs), "losses": glob, "one_rank_losses": losses,
           "loss_max_rel_err": worst_loss,
           "grad_rel_err_max": max(g_err.values()),
           "grad_rel_err_median": sorted(g_err.values())[len(g_err) // 2],
           "grad_worst_parameter": max(g_err, key=g_err.get),
           "grad_norm_ratio_range": [min(g_ratio.values()),
                                     max(g_ratio.values())],
           "update_rel_err_max": max(ratios.values()),
           "update_rel_err_median": sorted(ratios.values())[len(ratios) // 2],
           "worst_parameter": max(ratios, key=ratios.get),
           "launches": [r["launches"] for r in runs],
           "launches_want_by_rank": wants,
           "ticks": [r["ticks"] for r in runs],
           "passes_a_step": [r["passes_a_step"] for r in runs],
           "handoff_bytes_per_step": [r["handoff_bytes_per_step"]
                                      for r in runs],
           "eager_steps": [r["eager_steps"] for r in runs],
           "step_ms_median_gloo_staging_not_speed": [
               r["step_ms_median"] for r in runs],
           "peak_memory_gib": [r["peak_memory_gib"] for r in runs]}
    check(res["grad_rel_err_max"] <= PP_GRAD_RTOL,
          f"{phase} {key}: the first gradients differ from one rank's: {res}")
    check(worst_loss <= PP_LOSS_RTOL,
          f"{phase} {key}: the losses differ from one rank's: {res}")
    check(res["update_rel_err_max"] <= PP_UPDATE_RTOL,
          f"{phase} {key}: the parameters differ from one rank's: {res}")
    tc = pp_config(run)["compute_dtype"] == "bfloat16"
    check(all(r["launches"][k] == n and r["launches"][k + "_tc"]
              == (n if tc else 0)
              for r, want in zip(runs, wants) for k, n in want.items()),
          f"{phase} {key}: B1-B3 launched other than {wants} on "
          f"{'tc' if tc else 'simt'}: {res['launches']}")
    check(all(t == v * n_micro + stages - 1 for t in res["ticks"]),
          f"{phase} {key}: ticks {res['ticks']}, want v·T + S − 1")
    check(all(n == steps for n in res["eager_steps"]),
          f"{phase} {key}: want {steps} eager steps a rank")
    check(len({r["replicated_sha256"] for r in runs}) == 1,
          f"{phase} {key}: the replicated parameters differ between ranks")
    if moe:
        got = [r["first"] for r in runs]
        res["first_aux"] = [g["aux"] for g in got]
        res["first_drop_rate"] = [g["drop"] for g in got]
        res["one_rank_first"] = first
        res["drop_rates"] = [r["drop_rates"] for r in runs]
        res["one_rank_drop_rates"] = drops
        check(all(abs(g["aux"] - first["aux"]) <= PP_MOE_AUX_RTOL
                  * abs(first["aux"]) for g in got),
              f"{phase} {key}: the load-balance loss differs from one "
              f"rank's: {res['first_aux']} vs {first}")
        check(all(abs(g["drop"] - first["drop"]) <= PP_MOE_DROP_ATOL
                  for g in got)
              and all(abs(a - b) <= PP_MOE_DROP_ATOL
                      for r in runs for a, b in zip(r["drop_rates"], drops)),
              f"{phase} {key}: the drop rates differ from one rank's: "
              f"{res['first_drop_rate']}, {res['drop_rates']} vs {first}, "
              f"{drops}")
    return res


def pp_kernels(torch, card):
    """21a: B1-B3 at a microbatch's attention, causal, with packed segment
    ids and with the window (`shape_kernels`); 21a+: the ring's hops at a
    seq = 2 microbatch's block (`ring_hops`)."""
    res = {"causal": shape_kernels(torch, PP_ATTN_SHAPE, "21a",
                                   "a pipeline microbatch", 21),
           "packed": shape_kernels(torch, PP_ATTN_SHAPE, "21a",
                                   "a packed microbatch", 211, packed=True),
           "window": shape_kernels(torch, PP_ATTN_SHAPE, "21a",
                                   "a windowed microbatch", 212,
                                   window=PP_WINDOW)}
    for part in ("causal", "packed", "window"):
        log(f"phase21a {part}", json.dumps(dict(res[part], card=card)))
    res["ring"] = ring_hops(torch, card, shape=PP_HOP_SHAPE,
                            window=PP_WINDOW, phase="21a_ring", seed=213)
    return res


def pp_phase(torch, card, futs=None):
    """Phase 21: the pipeline. 21a's kernels are timed alone; 21b/21e and
    21d/21e run in launched processes and their one-rank references in a
    thread (``futs``, from an earlier `pp_start`, or started here)."""
    t0 = time.perf_counter()
    res = {"a": pp_kernels(torch, card)}
    futs = futs or pp_start(torch)
    refs = futs["refs"].result()
    for part, fut, keys in (("b", futs["two"], PP_2RANK),
                            ("d", futs["four"], PP_4RANK)):
        recs, fulls, wall, _ = fut.result()
        for key in keys:
            phase = "21e" if "moe" in key or key.startswith("ep") else \
                f"21{part}"
            held = dict(_pp_held(key, recs, fulls[key], refs[key], 2, phase),
                        launch_wall_s=wall, card=card)
            res.setdefault(phase, {})[key] = held
            log(f"phase{phase} {key}", json.dumps(held))
    log("phase21b_memory", json.dumps({
        key: res["21b"][key]["peak_memory_gib"] for key in PP_SCHEDULES}
        | {"card": card}))
    res["b"] = res["21b"]
    res["seconds"] = time.perf_counter() - t0
    log(f"phase21 seconds: {res['seconds']:.1f}")
    return res


def _twin_report(lines):
    return [ln for ln in lines if ln.startswith("[rank 0] ") and any(
        k in ln for k in ("first-half", "recall-half", "long-range recall"))]


def pp_multi_card(torch, card, ranks):
    """21c (``--ranks 4``): the bench-width PipelinedLM at data=1,pipe=4
    on NCCL under each schedule — step ms, tokens/s a card, each stage's
    busy and idle share beside the tick model's bubble — and its MoE form
    at data=1,pipe=2,expert=2 under 1F1B; then the twin at
    ``data=1,pipe=2,model=2`` and at ``data=1,pipe=2,seq=2``, both with
    ``SCHEDULE=1f1b``."""
    check(ranks == 4, "21c runs at --ranks 4")
    t0 = time.perf_counter()
    keys = [f"4card_{s}" for s in PP_SCHEDULES] + ["4card_moe_ep"]
    recs, _, wall, eager = pp_child_run("pp_4card", 4, pp_runs(keys), "nccl")
    # Under NCCL a step would be captured: the pipelined step runs eagerly
    # and rank 0 says so once (under gloo every such step is eager).
    check(len(eager) == 1, f"21c: want one eager-step log line, got {eager}")
    res = {"mesh": "data=1,pipe=4", "n_micro": PP_4_MICRO,
           "eager_line": eager[0], "launch_wall_s": wall, "card": card}
    for sched in PP_SCHEDULES:
        v = PP_VIRTUAL if sched == "interleaved" else 1
        runs = [r[f"4card_{sched}"]
                for r in sorted(recs, key=lambda r: r[keys[0]]["stage"])]
        losses = runs[0]["losses"]
        prof = [r["profile"] for r in runs]
        work = [(p["device_busy_ms_per_step"] - p["nccl_ms_per_step"])
                / p["host_ms_per_step"] for p in prof]
        step = max(r["step_ms_median"] for r in runs)
        res[sched] = {
            "losses": losses, "step_ms_median": step,
            "tokens_per_s_per_card": TRAIN_BATCH * TRAIN_SEQ / (step / 1e3)
            / ranks,
            "host_ms_per_step_profiled": [p["host_ms_per_step"]
                                          for p in prof],
            "device_busy_share_nccl_waits_included_by_stage": [
                p["device_busy_share"] for p in prof],
            "nccl_ms_per_step_by_stage": [p["nccl_ms_per_step"]
                                          for p in prof],
            "busy_share_by_stage": work,
            "idle_share_by_stage": [1.0 - w for w in work],
            "tick_model_bubble": (ranks - 1) / (v * PP_4_MICRO + ranks - 1),
            "peak_memory_gib_by_stage": [r["peak_memory_gib"] for r in runs],
            "handoff_bytes_per_step_by_stage": [
                r["handoff_bytes_per_step"] for r in runs],
            "top_kernels_stage0": prof[0]["top_kernels_ms_per_step"],
            "eager_steps": [r["eager_steps"] for r in runs]}
        check(all(map(math.isfinite, losses))
              and all(r["losses"] == losses for r in runs),
              f"21c {sched}: the stages' losses differ or are not finite: "
              f"{[r['losses'] for r in runs]}")
        check(len({r["replicated_sha256"] for r in runs}) == 1,
              f"21c {sched}: the replicated parameters differ between "
              "stages")
        log(f"phase21c {sched}", json.dumps(dict(res[sched], card=card)))
    # GPipe and 1F1B compute one function from one start: a step apart by
    # rounding only (the interleaved stacks are another layer order).
    worst = max(abs(a - b) / abs(b) for a, b in zip(
        res["1f1b"]["losses"], res["gpipe"]["losses"]))
    check(worst <= PP_LOSS_RTOL,
          f"21c: 1F1B's losses are {worst:.3g} from GPipe's")
    # The MoE pipeline at pipe = 2 x expert = 2: every rank logs one loss
    # and drop rate a step (the aux is averaged over the mesh).
    moe = [r["4card_moe_ep"] for r in recs]
    step = max(r["step_ms_median"] for r in moe)
    res["moe_ep"] = {
        "mesh": PP_RUNS["4card_moe_ep"]["mesh"], "schedule": "1f1b",
        "moe": PP_MOE, "losses": moe[0]["losses"],
        "drop_rates": moe[0]["drop_rates"], "step_ms_median": step,
        "tokens_per_s_per_card": TRAIN_BATCH * TRAIN_SEQ / (step / 1e3)
        / ranks,
        "peak_memory_gib_by_rank": [r["peak_memory_gib"] for r in moe],
        "launches_by_rank": [r["launches"] for r in moe],
        "eager_steps": [r["eager_steps"] for r in moe], "card": card}
    check(all(map(math.isfinite, moe[0]["losses"]))
          and all(r["losses"] == moe[0]["losses"] for r in moe)
          and all(0.0 <= x < 1.0 for x in moe[0]["drop_rates"]),
          f"21c moe: the ranks' losses differ, or a loss or drop rate is "
          f"out of range: {res['moe_ep']}")
    check(len({r["replicated_sha256"] for r in moe}) == 1,
          "21c moe: the replicated parameters differ between ranks")
    log("phase21c moe_ep", json.dumps(res["moe_ep"]))
    res["twin"] = {}
    for mesh in ("data=1,pipe=2,model=2", "data=1,pipe=2,seq=2"):
        twin_lines, twin_wall, _, _ = _launch(
            "pp_twin_" + mesh.replace(",", "_").replace("=", ""), 4,
            "lm_long_context",
            {"HVT_MESH": mesh, "SCHEDULE": "1f1b", "HVT_BACKEND": "nccl",
             "PYTHONUNBUFFERED": "1"}, timeout=900)
        report = _twin_report(twin_lines)
        check(len(report) == 3,
              f"21c: the twin at {mesh} printed no full report: {report}")
        epochs = [ln for ln in twin_lines if ln.startswith("[rank 0] Epoch")]
        res["twin"][mesh] = {"mesh": mesh, "schedule": "1f1b",
                             "report": report, "epochs": epochs,
                             "launch_wall_s": twin_wall, "card": card}
        log("phase21c_twin", json.dumps(res["twin"][mesh]))
    res["seconds"] = time.perf_counter() - t0
    return res


# -- phase 22 ----------------------------------------------------------------

# Phase 22: the model and fsdp axes in MoE, int8, seq2seq and LoRA (queue A
# item 18; no new kernel: the Megatron sums, the int8 partial products' sum
# and amax maxima, and FSDP's gathers are collectives around B1-B3 and
# cuBLAS products).
# 22a: B1-B3 at the bench seq2seq's padded encoder and cross masks on one
# rank of model = 2 ([8, 1024, 4, 64] bf16, non-causal), held against their
# plain versions at phases 3/4's tolerances and timed beside masked SDPA
# and the bound (`seq2seq_mask_timings`).
ITEM18_ATTN_SHAPE = (8, 1024, 4, 64)
# 22b-e: two gloo ranks sharing the card, checks (their gloo step ms are
# host staging, not speed), started beside 12b-d and 20b-c and joined at
# phase 22. Each part runs ITEM18_STEPS eager AdamW(3e-4) steps of 8 × 1024
# rows (the fsdp ranks 4 rows each) from the seed-0 weights; then both
# ranks run the same steps on the whole batches without a mesh (the world
# averages two equal gradients: one rank's run, exactly). 22b: bench.py's
# seq2seq (S2S_MODEL, bf16) at model = 2; 22c: the bench MoE LM
# (MOE_MODEL, bf16, fused-CE head) at model = 2 and fsdp = 2; 22d: LoRA
# (rank 8, alpha 16) over the bench LM at model = 2 and fsdp = 2. The
# losses within TP_LOSS_RTOL of the one rank's, as 20b/20c hold the dense
# LM; 22b's parameters each within TP_UPDATE_RTOL of the one-rank update's
# norm, 22d's adapters together (the norm of their distance over the norm
# of their update): B starts at zero, so A's first moving step is Adam's
# first, a step of about lr whose sign bf16 rounding flips where A's
# gradient is small against its tensor's (on an NVIDIA H100 80GB HBM3 at
# 700 W: up to 0.42 for a single A tensor, 0.105 for the median tensor).
# The MoE parts hold the losses only: a bf16 near-tie of the top-2
# re-routes a token when the sums round otherwise (PERF.md §6, the MoE
# pipeline's 21e), which moves the router's and experts' updates (there:
# up to 0.43), not the loss.
# 22e: the int8 decode at model = 2 — the int8_compute prefill over the
# quantize_params tree (this rank's parts, dequantized in each step) and
# the int8 cache — greedy, ITEM18_NEW tokens for TRAIN_BATCH prompts of
# PROMPT_LEN, in f32 (B1 on the CUDA-core route): the tokens equal one
# rank's, as tests/test_quant.py:417 holds JAX's sharded decode.
ITEM18_STEPS, ITEM18_NEW = 2, 16
ITEM18_PARTS = ("22b", "22c_model", "22c_fsdp", "22d_model", "22d_fsdp",
                "22e")
# --ranks 4 --tp-only (22f): the seq2seq twin at data=2,model=2 and the MoE
# LM at expert=2,model=2 on NCCL (ITEM18_4_STEPS steps: one eager, one
# capture, replays).
ITEM18_4_STEPS = 10

ITEM18_CHILD = r"""
import json, os, time
import numpy as np
import torch
import chip_smoke as cs
import horovod_tpu_torch as ht
from horovod_tpu_torch import callbacks, runtime
from horovod_tpu_torch.models import lora, quant
from horovod_tpu_torch.models import seq2seq as tseq
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.decoding import make_generate_fn
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import sharding

ht.init(device=os.environ.get("SMOKE_DEVICE") or "cuda")
r = ht.rank()
dev = runtime.device()
steps = int(os.environ["SMOKE_STEPS"])
cd = torch.bfloat16 if dev.type == "cuda" else torch.float32
lm_cfg = json.loads(os.environ.get("SMOKE_MODEL") or "null") or cs.MODEL
s2s_cfg = json.loads(os.environ.get("SMOKE_S2S") or "null") or cs.S2S_MODEL
seq = int(os.environ.get("SMOKE_SEQ") or cs.TRAIN_SEQ)
heads = set()
launch = fa._launch


def recorded(q, *args, **kwargs):
    heads.add(int(q.shape[2]))
    return launch(q, *args, **kwargs)


fa._launch = recorded


def lm(mesh, dtype=cd, **kw):
    return ttr.TransformerLM(**lm_cfg, **kw, compute_dtype=dtype,
                             fused_head_chunks=8, device=dev, seed=0,
                             sharding=ttr.ShardingConfig(mesh=mesh))


def s2s(mesh):
    return tseq.Seq2SeqTransformer(**s2s_cfg, compute_dtype=cd,
                                   logits_dtype=cd, device=dev, seed=0,
                                   sharding=ttr.ShardingConfig(mesh=mesh))


def lora_lm(mesh):
    return lora.LoRAModel(lm(mesh), rank=cs.LORA_RANK, alpha=cs.LORA_ALPHA)


def lm_batches():
    return cs.tp_batches(steps, seq=seq, vocab=lm_cfg["vocab_size"])


def s2s_batches():
    x, y = cs._s2s_copy_task(cs.TRAIN_BATCH * steps, seq, seq, seed=22)
    b = cs.TRAIN_BATCH
    return [({k: v[i * b:(i + 1) * b] for k, v in x.items()},
             y[i * b:(i + 1) * b]) for i in range(steps)]


PARTS = {  # name: (mesh, model, batches, loss, param_specs, optimizer)
    "22b": ("data=1,model=2", s2s, s2s_batches,
            "sparse_categorical_crossentropy", tseq.param_specs, ht.adamw),
    "22c_model": ("data=1,model=2",
                  lambda m: lm(m, moe_every=2, n_experts=8, moe_k=2),
                  lm_batches, "module", ttr.param_specs, ht.adamw),
    "22c_fsdp": ("data=1,fsdp=2",
                 lambda m: lm(m, moe_every=2, n_experts=8, moe_k=2),
                 lm_batches, "module", ttr.param_specs, ht.adamw),
    "22d_model": ("data=1,model=2", lora_lm, lm_batches, "module",
                  ttr.param_specs,
                  lambda lr: lora.freeze_base(ht.adamw(lr))),
    "22d_fsdp": ("data=1,fsdp=2", lora_lm, lm_batches, "module",
                 ttr.param_specs, lambda lr: lora.freeze_base(ht.adamw(lr))),
}


class Clock(callbacks.Callback):
    def on_train_begin(self, logs=None):
        self.t, self.logs = [time.perf_counter()], []

    def on_batch_end(self, batch, logs=None):
        self.logs.append({k: float(v) for k, v in logs.items()})
        self.t.append(time.perf_counter())


def fit(model, mesh, batches, loss, specs, opt):
    trainer = ht.Trainer(model, ht.DistributedOptimizer(opt(3e-4)),
                         loss=loss, seed=0, mesh=mesh, device=dev,
                         param_specs=specs if mesh is not None else None)
    if mesh is not None:
        batches = [sharding.shard_batch(b, mesh) for b in batches]
    trainer.build(*batches[0])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    cs._fa_zero(fa)
    heads.clear()
    clock = Clock()
    trainer.fit(dataset=batches, epochs=1, steps_per_epoch=len(batches),
                callbacks=[clock, callbacks.MetricAverageCallback()],
                verbose=0, _eager=mesh is None)
    step_s = [b - a for a, b in zip(clock.t, clock.t[1:])]
    return trainer, {"losses": [e["loss"] for e in clock.logs],
                     "launches": cs._fa_counts(fa), "heads": sorted(heads),
                     "eager_steps": trainer._runner.eager_steps,
                     "step_s": step_s}


def whole(state):
    return {n: t.detach().float().cpu().numpy().copy()
            for n, t in state.items()}


out = os.environ["SMOKE_OUT"]
res, refs = {}, {}
for name in json.loads(os.environ["SMOKE_PARTS"]):
    if name == "22e":
        continue
    spec, build, batches, loss, specs, opt = PARTS[name]
    mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(spec))
    trainer, rec = fit(build(mesh), mesh, batches(), loss, specs, opt)
    full = whole(trainer.state.full_model_state())
    res[name] = rec
    # The one-rank run (one for a part's two meshes): the same weights and
    # the whole batches on both ranks, whose world-averaged gradients are
    # then each one's, exactly.
    key = name.split("_")[0]
    if key not in refs:
        model = build(None)
        start = whole(model.state_dict())
        _, one = fit(model, None, batches(), loss, specs, opt)
        refs[key] = start, one, whole(model.state_dict())
        del model
    start, one, end = refs[key]
    ratios, apart, moved_all = {}, 0.0, 0.0
    for n, p in end.items():
        moved = float(np.linalg.norm(p - start[n]))
        if moved > 0:
            ratios[n] = float(np.linalg.norm(full[n] - p)) / moved
            apart += float(np.linalg.norm(full[n] - p)) ** 2
            moved_all += moved ** 2
    res[name]["one_rank"] = one
    res[name]["update_rel_err"] = ratios
    res[name]["update_rel_err_all"] = (apart / moved_all) ** 0.5
    del trainer, full
    if dev.type == "cuda":
        torch.cuda.empty_cache()

if "22e" in json.loads(os.environ["SMOKE_PARTS"]):
    mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string("data=1,model=2"))
    x, _ = cs.tp_batches(1, seq=seq, vocab=lm_cfg["vocab_size"])[0]
    prompt = torch.from_numpy(x[:, :cs.PROMPT_LEN]).to(dev)

    def decode(model):
        qtree = quant.quantize_params(model)
        fn = make_generate_fn(model, max_new_tokens=int(os.environ["NEW"]),
                              quantized=True, int8_compute=True,
                              quantized_cache=True, include_prompt=False)
        cs._fa_zero(fa)
        heads.clear()
        tokens = fn(prompt, params=qtree).cpu().numpy()
        return tokens, {"launches": cs._fa_counts(fa),
                        "heads": sorted(heads),
                        "steps": fn.steps.counts(),
                        "int8_leaves": sum(quant.is_qleaf(v)
                                           for v in qtree.values())}

    # f32 compute (TF32 off): in bf16 the Megatron sums round two partial
    # products where one rank rounds one, and greedy tokens part at
    # near-ties (on an NVIDIA H100 at 700 W, 10 of 128 tokens differed).
    torch.backends.cuda.matmul.allow_tf32 = False
    tokens, rec = decode(lm(mesh, torch.float32))
    one, rec1 = decode(lm(None, torch.float32))
    res["22e"] = dict(rec, tokens=tokens.tolist(),
                      one_rank=dict(rec1, tokens=one.tolist()))
print("item18_child", json.dumps(res), flush=True)
"""


def item18_start():
    """22b-e, launched in a thread (two gloo ranks sharing the card beside
    12b-d, 20b-c and 21's launches); `item18_phase` joins it."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(item18_child_run, "item18", 2, ITEM18_PARTS, "gloo")
    pool.shutdown(wait=False)
    return fut


def item18_child_run(name, nprocs, parts, backend):
    """One launch of ITEM18_CHILD: (per-rank records, wall seconds)."""
    out = os.path.join(WORK, name + "_out")
    os.makedirs(out, exist_ok=True)
    knobs = {"SMOKE_STEPS": str(ITEM18_STEPS), "SMOKE_OUT": out,
             "SMOKE_PARTS": json.dumps(list(parts)), "NEW": str(ITEM18_NEW),
             "HVT_BACKEND": backend, "PYTHONUNBUFFERED": "1"}
    lines, wall, _, _ = _launch(name, nprocs, None, knobs, code=ITEM18_CHILD,
                                timeout=900)
    recs = []
    for r in range(nprocs):
        text = _rank_line(lines, "item18_child ", r)
        check(text is not None, f"{name}: rank {r} printed no result")
        recs.append(json.loads(text))
    return recs, wall


def _item18_held(name, recs, layers, sites_per_layer, heads):
    """One training part of 22b-d against rank 0's one-rank run: the
    global batch's losses, the updates (where held), launches and local
    heads."""
    rec0 = recs[0][name]
    one = rec0["one_rank"]
    glob = [sum(r[name]["losses"][i] for r in recs) / len(recs)
            for i in range(ITEM18_STEPS)]
    worst = max(abs(a - b) / abs(b) for a, b in zip(glob, one["losses"]))
    ratios = rec0["update_rel_err"]
    want = layers * sites_per_layer * ITEM18_STEPS
    res = {"losses": glob, "one_rank_losses": one["losses"],
           "loss_max_rel_err": worst,
           "update_rel_err_all": rec0["update_rel_err_all"],
           "update_rel_err_max": max(ratios.values()),
           "update_rel_err_median": sorted(ratios.values())[len(ratios) // 2],
           "worst_parameter": max(ratios, key=ratios.get),
           "launches": [r[name]["launches"] for r in recs],
           "heads_a_launch": [r[name]["heads"] for r in recs],
           "eager_steps": [r[name]["eager_steps"] for r in recs],
           "gloo_step_s_staging_not_speed": [r[name]["step_s"]
                                             for r in recs]}
    check(worst <= TP_LOSS_RTOL,
          f"{name}: the losses differ from one rank's: {res}")
    held = {"22b": "update_rel_err_max", "22d_model": "update_rel_err_all",
            "22d_fsdp": "update_rel_err_all"}.get(name)
    if held:
        check(res[held] <= TP_UPDATE_RTOL,
              f"{name}: the parameters differ from one rank's: {res}")
    for r in recs:
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            n, tc = r[name]["launches"][k], r[name]["launches"][k + "_tc"]
            check(n == tc == want, f"{name}: {k} launched {n} ({tc} on tc) "
                  f"on a rank, want {want} = layers × sites × steps")
        check(r[name]["heads"] == [heads],
              f"{name}: B1 ran at {r[name]['heads']} heads, want {heads}")
        check(r[name]["eager_steps"] == ITEM18_STEPS,
              f"{name}: want {ITEM18_STEPS} eager steps a rank (gloo)")
    return res


def item18_phase(torch, card, fut):
    """Phase 22: the model and fsdp axes in MoE, int8, seq2seq and LoRA.
    22a's kernels are timed here; 22b-e ran in the launch ``fut`` (from
    `item18_start`), joined here."""
    t0 = time.perf_counter()
    res = {"a": seq2seq_mask_timings(torch, card, shape=ITEM18_ATTN_SHAPE,
                                     phase="22a", seed=22)}
    recs, wall = fut.result()
    half = MODEL["n_heads"] // 2
    parts = {"22b": (S2S_MODEL["n_enc_layers"], 3, S2S_MODEL["n_heads"] // 2),
             "22c_model": (MODEL["n_layers"], 1, half),
             "22c_fsdp": (MODEL["n_layers"], 1, MODEL["n_heads"]),
             "22d_model": (MODEL["n_layers"], 1, half),
             "22d_fsdp": (MODEL["n_layers"], 1, MODEL["n_heads"])}
    for name, (layers, sites, heads) in parts.items():
        res[name] = dict(_item18_held(name, recs, layers, sites, heads),
                         card=card)
        log(f"phase{name}", json.dumps(res[name]))
    e = [r["22e"] for r in recs]
    one = e[0]["one_rank"]
    res["22e"] = {"tokens_equal_one_rank": all(r["tokens"] == one["tokens"]
                                                for r in e),
                  "tokens_differing": [
                      int(sum(a != b for ra, rb in zip(r["tokens"],
                                                       one["tokens"])
                              for a, b in zip(ra, rb))) for r in e],
                  "launches": [r["launches"] for r in e],
                  "one_rank_launches": one["launches"],
                  "heads_a_launch": [r["heads"] for r in e],
                  "steps": [r["steps"] for r in e],
                  "int8_leaves": [r["int8_leaves"] for r in e],
                  "new_tokens": ITEM18_NEW, "card": card}
    log("phase22e", json.dumps(res["22e"]))
    check(res["22e"]["tokens_equal_one_rank"],
          f"22e: the int8 decode at model = 2 differs from one rank's: "
          f"{res['22e']}")
    for r in e:
        n = r["launches"]
        check(n["flash_fwd"] == MODEL["n_layers"] and n["flash_fwd_tc"] == 0
              and n["flash_bwd_dq"] == 0,
              f"22e: the int8 prefill launched B1 {n}, want "
              f"{MODEL['n_layers']} on the CUDA-core route (f32)")
        check(r["heads"] == [half], f"22e: B1 ran at {r['heads']} heads")
    res["launch_wall_s"] = wall
    res["seconds"] = time.perf_counter() - t0
    log(f"phase22 seconds: {res['seconds']:.1f} (the launch's wall "
        f"{wall:.1f} s, beside earlier phases)")
    return res


def item18_multi_card(torch, card, ranks):
    """22f (``--ranks 4 --tp-only``): the twin of
    ``examples/seq2seq_translation.py`` at ``data=2,model=2`` and the bench
    MoE LM at ``expert=2,model=2`` on NCCL, each rank's steps after the
    first replays of one captured graph holding the Megatron sums."""
    check(ranks == 4, "22f runs at --ranks 4")
    t0 = time.perf_counter()
    moe_cfg = dict(MOE_MODEL, compute_dtype="bfloat16", fused_head_chunks=8)
    recs, _, _, _, wall = moe_child_run(
        torch, "item18_moe_4card", 4, "data=1,expert=2,model=2", moe_cfg,
        ITEM18_4_STEPS, "nccl")
    losses = recs[0]["losses"]
    res = {"moe": {"mesh": "data=1,expert=2,model=2", "losses": losses,
                   "drop_rate": recs[0]["metrics"].get("moe_drop_rate"),
                   "eager_steps": [r["eager_steps"] for r in recs],
                   "captures": [r["captures"] for r in recs],
                   "replays": [r["replays"] for r in recs],
                   "step_ms_median": [r["step_ms_median"] for r in recs],
                   # One data shard: the four cards share each step's rows.
                   "tokens_per_s_per_card": min(
                       r["tokens_per_s_per_card"] for r in recs) / ranks,
                   "peak_memory_gib": [r["peak_memory_gib"] for r in recs],
                   "launch_wall_s": wall, "card": card}}
    check(all(r["losses"] == losses for r in recs),
          "22f: the MoE ranks' losses differ (one data shard)")
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"22f: the MoE loss did not fall: {losses}")
    check(all(r["captures"] == 1 and r["eager_steps"] == 1 for r in recs),
          f"22f: want one eager step and one capture a rank: {res['moe']}")
    log("phase22f_moe", json.dumps(res["moe"]))
    lines, twin_wall, _, _ = _launch(
        "item18_s2s_twin", 4, "seq2seq_translation",
        {"HVT_MESH": "data=2,model=2", "HVT_BACKEND": "nccl",
         "PYTHONUNBUFFERED": "1"}, timeout=900)
    report = [ln for ln in lines if ln.startswith(tuple(
        "[rank 0] " + k for k in ("byte-BPE", "held-out", "REVERSAL")))]
    epochs = [ln for ln in lines if ln.startswith("[rank 0] Epoch")]
    res["twin"] = {"mesh": "data=2,model=2", "report": report,
                   "epochs": epochs, "launch_wall_s": twin_wall,
                   "card": card}
    check(len(report) == 3 and not any(
        ln.startswith("[rank 1] REVERSAL") for ln in lines),
          f"22f: the twin printed no report on rank 0 alone: {report}")
    log("phase22f_twin", json.dumps(res["twin"]))
    res["seconds"] = time.perf_counter() - t0
    return res


# -- phase 23 ----------------------------------------------------------------

# Phase 23: MoE dispatch groups across data and sequence shards (queue A item
# 12.5; no new kernel: each MoE layer gathers the routing decisions over the
# gradient group and sums the shares of its aux loss and rates there, around
# B1-B3 — the flash ring in every attention layer on `seq` — and cuBLAS
# products).
# 23a: the bench MoE LM (bench.py's MoE mode: MOE_MODEL, bf16, the fused-CE
# head, AdamW 3e-4) at data=1,seq=2 with the flash ring, two gloo ranks
# sharing the card, each a [8, 512] column block of the 8 × 1024 batch
# (`tp_batches`): every dispatch group (a row) spans both ranks. MOEG_STEPS
# eager steps against one rank's run (both ranks run the whole batch
# without a mesh, their layers told the batch is whole; the world averages
# two equal gradients). Gates: each loss within a bf16 ulp of one rank's,
# every drop rate within PP_MOE_DROP_ATOL, B1-B3 launched n_layers × hops ×
# steps a rank (a hop a layer on seq rank 0, two on rank 1), all tc, the
# parameters bit-equal on both ranks.
# 23b: the same model in f32 at data=2, [2, 768] a rank: 3 072 tokens in
# JAX's three groups of 1 024, the middle one across the shards; one step.
# 21e's gates: the first gradient leaf by leaf within PP_GRAD_RTOL, its aux loss
# within PP_MOE_AUX_RTOL and drop rate within PP_MOE_DROP_ATOL of one
# rank's, the losses within PP_LOSS_RTOL, each parameter's update within
# PP_UPDATE_RTOL of one rank's, the parameters bit-equal on both ranks;
# 23b_ec: one expert-choice step, its loss, update and moe_uncovered_rate
# held the same way.
# 23a-b's launch starts with the checks' lane (beside 15a-b) and is joined
# at phase 23.
MOEG_STEPS = 2
# 23c (--ranks 4; alone with --moe-grouping-only): on four NCCL cards,
# captured steps: the bench MoE LM at data=1,seq=2,expert=2, MOEG_4_STEPS
# steps (one eager, one capture, replays), then MOEG_4_WINDOW of another
# fit profiled on rank 0; and the twin of examples/lm_long_context.py at
# data=2,seq=2 with MOE_EVERY=2 N_EXPERTS=4 (its own width, steps and
# epochs), which must print LEARNED, profiled the same way. Each: step ms,
# tokens/s a card, the busy share, the routing bytes gathered a step, the
# routing collectives a MoE layer's forward, and the MoE layers' share of
# the device time (the MoE layers × one layer's forward and backward,
# timed as graph replays on every rank at once, over the busy ms a step).
MOEG_4_STEPS, MOEG_4_WINDOW = 10, 5
# name: (mesh, compute dtype, global rows × tokens, router, steps, the
# first gradient kept, profiled)
MOEG_PARTS = {
    "23a": ("data=1,seq=2", "bfloat16", (8, 1024), "top_k", MOEG_STEPS,
            False, False),
    "23b": ("data=2", "float32", (4, 768), "top_k", 1, True, False),
    "23b_ec": ("data=2", "float32", (4, 768), "expert_choice", 1, False,
               False),
    "23c_lm": ("data=1,seq=2,expert=2", "bfloat16", (8, 1024), "top_k",
               MOEG_4_STEPS, False, True),
}

MOEG_CHILD = r"""
import hashlib, json, os, time
import numpy as np
import torch
import chip_smoke as cs
import horovod_tpu_torch as ht
from horovod_tpu_torch import callbacks, runtime
from horovod_tpu_torch.models import moe as tmoe
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import collectives
from horovod_tpu_torch.parallel import mesh as tmesh, sharding

# SMOKE_DEVICE / SMOKE_MODEL / SMOKE_SEQ rehearse this child on the CPU at
# a tiny size; the smoke runs it on the card at the bench width.
ht.init(device=os.environ.get("SMOKE_DEVICE") or "cuda")
r = ht.rank()
dev = runtime.device()
cuda = dev.type == "cuda"
out = os.environ["SMOKE_OUT"]
cfg = json.loads(os.environ.get("SMOKE_MODEL") or "null") or cs.MOE_MODEL
seq_cut = int(os.environ.get("SMOKE_SEQ") or 0)
meshes = {}


class Clock(callbacks.Callback):
    def on_train_begin(self, logs=None):
        self.t, self.logs = [time.perf_counter()], []

    def on_batch_end(self, batch, logs=None):
        self.logs.append({k: float(v) for k, v in logs.items()})
        self.t.append(time.perf_counter())


def batches_of(rows, seq, steps):
    return [(x[:rows], y[:rows]) for x, y in cs.tp_batches(
        steps, seq=seq_cut or seq, vocab=cfg["vocab_size"])]


def run(name, spec, dtype, rows_seq, router, steps, grads, profile):
    mesh = None
    if spec is not None:
        if spec not in meshes:  # every rank builds them in one order
            meshes[spec] = tmesh.build_mesh(tmesh.MeshSpec.from_string(spec))
        mesh = meshes[spec]
    model = ttr.TransformerLM(**cfg, moe_router=router, compute_dtype=dtype,
                              fused_head_chunks=8, device=dev, seed=0,
                              sharding=ttr.ShardingConfig(mesh=mesh))
    seq_mesh = mesh is not None and mesh.seq_shards > 1
    bs = tmesh.P(("data", "fsdp"), "seq")
    trainer = ht.Trainer(
        model, ht.DistributedOptimizer(ht.adamw(3e-4)), loss="module",
        seed=0, mesh=mesh, device=dev,
        param_specs=ttr.param_specs if mesh is not None else None,
        batch_specs=(bs, bs) if seq_mesh else None)
    trainer.build()
    if mesh is None:
        # One rank's run on every rank: each holds the whole batch, so its
        # dispatch groups are its own (the world averages equal gradients).
        for m in model.modules():
            if isinstance(getattr(m, "token_shards", None),
                          tmoe.TokenShards):
                m.token_shards = tmoe.TokenShards()
    batches = batches_of(*rows_seq, steps)
    if mesh is not None:
        batches = [sharding.shard_batch(b, mesh) for b in batches]
    rec = {"coords": mesh.coords if mesh is not None else None}
    if grads:
        g, rec["first"] = cs.pp_first_grads(torch, trainer, batches[0])
        if r == 0:
            np.savez(os.path.join(out, f"grads_{name}.npz"),
                     **{n: t.numpy() for n, t in g.items()})
        del g
    x0, y0 = batches[0]
    trainer.discover_metrics(trainer.cut(x0, 0), trainer.cut(y0, 1))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    cs._fa_zero(fa)
    routed = dict(tmoe.routing_traffic)
    calls = collectives.traffic["calls"]
    clock = Clock()
    trainer.fit(dataset=batches, epochs=1, steps_per_epoch=steps,
                callbacks=[clock, callbacks.MetricAverageCallback()],
                verbose=0, _eager=mesh is None)
    runner = trainer._runner
    ran = runner.eager_steps + runner.captures  # steps whose Python ran
    # The replays' walls (a captured run), else every step's but the first.
    skip = 2 if runner.captures else 1
    step_ms = sorted(1e3 * (b - a) for a, b in zip(clock.t[skip:],
                                                    clock.t[skip + 1:]))
    median = step_ms[len(step_ms) // 2] if step_ms else None
    n_moe = sum(1 for b in model.blocks if b.use_moe)
    metric = ("moe_uncovered_rate" if router == "expert_choice"
              else "moe_drop_rate")
    rec.update({
        "losses": [e["loss"] for e in clock.logs],
        "rates": [e[metric] for e in clock.logs],
        "launches": cs._fa_counts(fa),
        "eager_steps": runner.eager_steps, "captures": runner.captures,
        "replays": runner.replays, "step_ms_median": median,
        "routing_bytes_per_step":
            (tmoe.routing_traffic["bytes"] - routed["bytes"]) / ran,
        "routing_collectives_per_moe_layer":
            (tmoe.routing_traffic["calls"] - routed["calls"]) / ran / n_moe,
        "collectives_per_step": (collectives.traffic["calls"] - calls) / ran,
        "peak_memory_gib": (torch.cuda.max_memory_allocated() / 2**30
                            if cuda else None),
        "params_sha256": hashlib.sha256(b"".join(
            p.detach().float().cpu().numpy().tobytes()
            for p in model.parameters())).hexdigest()})
    if median:
        rec["tokens_per_s_per_card"] = (rows_seq[0] * rows_seq[1]
                                        / (median / 1e3) / ht.size())
    if profile and cuda:
        window = cs.MOEG_4_WINDOW

        def fit(cbs):
            trainer.fit(dataset=batches[:2 * window], epochs=1,
                        steps_per_epoch=2 * window, callbacks=cbs, verbose=0)

        if r == 0:
            prof, host_ms = cs.profiled_fit(torch, fit, window, window)
            per, _ = cs._per_step(torch, prof, window, host_ms)
            rec["profile"] = dict(per, host_ms_per_step=host_ms)
        else:
            fit([])
        rec["moe_layer_fwd_bwd_ms"] = cs.moe_layer_ms(
            torch, model, x0.shape[0], x0.shape[1] // mesh.seq_shards)
    if dtype == "float32" and r == 0:  # the updates are held in f32
        np.savez(os.path.join(out, f"full_{name}.npz"),
                 **{n: t.detach().float().cpu().numpy()
                    for n, t in trainer.state.full_model_state().items()})
    del model, trainer
    if cuda:
        torch.cuda.empty_cache()
    return rec


res = {"rank": r}
for name in json.loads(os.environ["SMOKE_PARTS"]):
    spec, dtype, rows_seq, router, steps, grads, profile = cs.MOEG_PARTS[name]
    res[name] = run(name, spec, dtype, rows_seq, router, steps, grads,
                    profile)
    if not profile:
        res[name]["one_rank"] = run(name + "_one", None, dtype, rows_seq,
                                    router, steps, grads, False)
print("moeg_child", json.dumps(res), flush=True)
"""

# 23c's twin: examples/lm_long_context.py's main() at data=2,seq=2 with
# MOE_EVERY=2, its fit recorded (routing bytes, steps), then MOEG_4_WINDOW
# steps of another fit profiled on rank 0 and the MoE layer timed.
MOEG_TWIN_CHILD = r"""
import json, os
import torch
import chip_smoke as cs
import horovod_tpu_torch as hvt
from horovod_tpu_torch import runtime
from horovod_tpu_torch.data.datasets import copy_task
from horovod_tpu_torch.examples import lm_long_context as twin
from horovod_tpu_torch.models import moe as tmoe

trainers, routed = [], {}
fit = hvt.Trainer.fit


def recorded_fit(self, *args, **kwargs):
    trainers.append(self)
    before = dict(tmoe.routing_traffic)
    out = fit(self, *args, **kwargs)
    routed.update({k: tmoe.routing_traffic[k] - before[k] for k in before})
    return out


hvt.Trainer.fit = recorded_fit
report = twin.main()
hvt.Trainer.fit = fit
trainer = trainers[0]
runner, model, mesh = trainer._runner, trainer.module, trainer.mesh
steps = int(os.environ.get("DRIVE_STEPS") or 64)
per_step = sorted(e["epoch_time_s"] * 1e3 / steps
                  for e in report["history"][1:])
median = per_step[len(per_step) // 2]
seq_len = int(os.environ.get("SEQ_LEN", 512))
rows = 16 // mesh.data_shards
n_moe = sum(1 for b in model.blocks if b.use_moe)
# Forwards whose Python ran: the eager steps, the capture and the metrics'
# discovery.
forwards = runner.eager_steps + runner.captures + 1
res = {"rank": runtime.rank(), "losses": [e["loss"] for e in
                                          report["history"]],
       "recall_loss": report["recall_loss"],
       "context_loss": report["context_loss"],
       "eager_steps": runner.eager_steps, "captures": runner.captures,
       "replays": runner.replays, "step_ms_median": median,
       "tokens_per_s_per_card": rows * mesh.data_shards * seq_len
       / (median / 1e3) / hvt.size(),
       "routing_bytes_per_step": routed["bytes"] / forwards,
       "routing_collectives_per_moe_layer": routed["calls"] / forwards
       / n_moe, "moe_layers": n_moe}
x, y = copy_task(4096, seq_len, vocab_size=int(os.environ.get("VOCAB", 64)),
                 seed=0)
window = cs.MOEG_4_WINDOW


def refit(cbs):
    trainer.fit(x=x, y=y, batch_size=rows, epochs=1,
                steps_per_epoch=2 * window, callbacks=cbs, verbose=0)


if runtime.rank() == 0:
    prof, host_ms = cs.profiled_fit(torch, refit, window, window)
    per, _ = cs._per_step(torch, prof, window, host_ms)
    res["profile"] = dict(per, host_ms_per_step=host_ms)
else:
    refit([])
res["moe_layer_fwd_bwd_ms"] = cs.moe_layer_ms(
    torch, model, rows, seq_len // mesh.seq_shards)
print("moeg_twin", json.dumps(res), flush=True)
"""


def moe_layer_ms(torch, model, rows, tokens):
    """Device ms of one forward and backward of ``model``'s first MoE
    layer at a rank's ``[rows, tokens]`` shard, its collectives included
    (`device_ms`: graph replays; every rank of the mesh calls it at
    once)."""
    layer = next(b.moe for b in model.blocks if b.use_moe)
    gen = torch.Generator(device=model.embed.weight.device).manual_seed(23)
    xin = torch.randn(rows, tokens, layer.d_model, generator=gen,
                      device=gen.device).to(layer.compute_dtype)
    xin.requires_grad_()

    def step():
        out = layer(xin, train=True)
        (out.float().square().mean()
         + layer.sown["losses"]["moe_load_balance"]).backward()

    ms = device_ms(torch, step, iters=5)
    model.zero_grad(set_to_none=True)
    return ms


def moeg_start():
    """23a-b, launched in a thread (two gloo ranks sharing the card beside
    15a-b, 17-22 and the checks' lane); `moeg_phase` joins it."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(moeg_child_run, "moeg", 2, ["23a", "23b", "23b_ec"],
                      "gloo")
    pool.shutdown(wait=False)
    return fut


def moeg_child_run(name, nprocs, parts, backend):
    """One launch of MOEG_CHILD: (per-rank records, by part rank 0's
    whole parameters after the fit and, where kept, the first gradient,
    each beside its one-rank run's, wall seconds)."""
    import numpy as np

    out = os.path.join(WORK, name + "_out")
    os.makedirs(out, exist_ok=True)
    knobs = {"SMOKE_PARTS": json.dumps(parts), "SMOKE_OUT": out,
             "HVT_BACKEND": backend, "PYTHONUNBUFFERED": "1"}
    lines, wall, _, _ = _launch(name, nprocs, None, knobs, code=MOEG_CHILD,
                                timeout=900)
    recs = []
    for r in range(nprocs):
        text = _rank_line(lines, "moeg_child ", r)
        check(text is not None, f"{name}: rank {r} printed no result")
        recs.append(json.loads(text))

    def load(kind, part):
        path = os.path.join(out, f"{kind}_{part}.npz")
        return dict(np.load(path)) if os.path.exists(path) else None

    fulls = {p: {k: load(kind, p + one) for k, kind, one in (
        ("params", "full", ""), ("grads", "grads", ""),
        ("one_params", "full", "_one"), ("one_grads", "grads", "_one"))}
        for p in parts}
    return recs, fulls, wall


def _moeg_held(name, recs, full, card):
    """Part ``name`` of 23a-b against its one-rank run: losses, rates,
    the first gradient and the updates where held, launches, bit-equal
    parameters."""
    import numpy as np

    spec, dtype, _, router, steps, grads, _ = MOEG_PARTS[name]
    runs = [r[name] for r in recs]
    one = runs[0]["one_rank"]
    want = one["losses"]
    # The global batch's loss: a data shard logs its rows' (a seq rank the
    # whole rows', joined over the group).
    losses = [sum(r["losses"][i] for r in runs) / len(runs)
              for i in range(len(want))]
    bf16 = dtype == "bfloat16"
    # A bf16 ulp of the one-rank loss (its exponent, 7 stored bits).
    tol = [2.0 ** (math.floor(math.log2(abs(b))) - 7) if bf16
           else PP_LOSS_RTOL * abs(b) for b in want]
    res = {"mesh": spec, "dtype": dtype, "router": router, "steps": steps,
           "losses": losses, "one_rank_losses": want,
           "loss_max_abs_err": max(abs(a - b) for a, b in
                                   zip(losses, want)),
           "rates": [r["rates"] for r in runs], "one_rank_rates":
           one["rates"],
           "launches": [r["launches"] for r in runs],
           "eager_steps": [r["eager_steps"] for r in runs],
           "routing_bytes_per_step": [r["routing_bytes_per_step"]
                                      for r in runs],
           "routing_collectives_per_moe_layer": [
               r["routing_collectives_per_moe_layer"] for r in runs],
           "gloo_step_ms_staging_not_speed": [r["step_ms_median"]
                                              for r in runs],
           "peak_memory_gib": [r["peak_memory_gib"] for r in runs]}
    check(all(len(r["losses"]) == steps for r in runs)
          and all(abs(a - b) <= t for a, b, t in zip(losses, want, tol)),
          f"{name}: the losses differ from one rank's: {res}")
    check(all(abs(a - b) <= PP_MOE_DROP_ATOL for r in runs
              for a, b in zip(r["rates"], one["rates"])),
          f"{name}: the {'uncovered' if router != 'top_k' else 'drop'} "
          f"rates differ from one rank's: {res}")
    check(len({r["params_sha256"] for r in runs}) == 1,
          f"{name}: the parameters differ between the ranks")
    check(all(r["eager_steps"] == steps for r in runs),
          f"{name}: want {steps} eager steps a rank (gloo)")
    # A hop a layer, on seq = 2 two on seq rank 1 (rank 0's past block is
    # its future); tc in bf16, the CUDA-core route in f32.
    wants = [MOE_MODEL["n_layers"] * (1 + r["coords"]["seq"]) * steps
             for r in runs]
    res["launches_want_by_rank"] = wants
    check(all(r["launches"][k] == n
              and r["launches"][k + "_tc"] == (n if bf16 else 0)
              for r, n in zip(runs, wants)
              for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
          f"{name}: B1-B3 launched other than {wants} a rank "
          f"({'tc' if bf16 else 'simt'}): {res['launches']}")
    if dtype == "float32":
        ratios = {}
        for n, p in full["one_params"].items():
            moved = float(np.linalg.norm(p - full["start"][n]))
            ratios[n] = (float(np.linalg.norm(full["params"][n] - p))
                         / max(moved, 1e-30))
        res["update_rel_err_max"] = max(ratios.values())
        res["update_rel_err_median"] = sorted(ratios.values())[
            len(ratios) // 2]
        res["worst_parameter"] = max(ratios, key=ratios.get)
        check(res["update_rel_err_max"] <= PP_UPDATE_RTOL,
              f"{name}: the updates differ from one rank's: {res}")
    if grads:
        g_err = {n: float(np.linalg.norm(full["grads"][n] - g))
                 / max(float(np.linalg.norm(g)), 1e-30)
                 for n, g in full["one_grads"].items()}
        first = [r["first"] for r in runs]
        res.update({"grad_rel_err_max": max(g_err.values()),
                    "grad_worst_parameter": max(g_err, key=g_err.get),
                    "first_aux": [f["aux"] for f in first],
                    "first_drop_rate": [f["drop"] for f in first],
                    "one_rank_first": one["first"]})
        check(res["grad_rel_err_max"] <= PP_GRAD_RTOL,
              f"{name}: the first gradient differs from one rank's: {res}")
        check(all(abs(f["aux"] - one["first"]["aux"]) <= PP_MOE_AUX_RTOL
                  * abs(one["first"]["aux"])
                  and abs(f["drop"] - one["first"]["drop"])
                  <= PP_MOE_DROP_ATOL for f in first),
              f"{name}: the first aux loss or drop rate differs from one "
              f"rank's: {res}")
    return dict(res, card=card)


def moeg_phase(torch, card, fut):
    """Phase 23's checks: 23a-b ran in the launch ``fut`` (from
    `moeg_start`), joined here."""
    from horovod_tpu_torch.models.transformer import TransformerLM

    t0 = time.perf_counter()
    recs, fulls, wall = fut.result()
    start = {n: t.float().numpy() for n, t in TransformerLM(
        **MOE_MODEL, device="cpu", seed=0).state_dict().items()}
    res = {}
    for name in ("23a", "23b", "23b_ec"):
        res[name] = dict(_moeg_held(name, recs, dict(fulls[name],
                                                     start=start), card),
                         launch_wall_s=wall)
        log(f"phase{name}", json.dumps(res[name]))
    res["seconds"] = time.perf_counter() - t0
    log(f"phase23 seconds: {res['seconds']:.1f} (the launch's wall "
        f"{wall:.1f} s, beside earlier phases)")
    return res


def moeg_multi_card(torch, card, ranks):
    """23c (``--ranks 4``): the bench MoE LM at data=1,seq=2,expert=2 and
    the long-context twin with MoE at data=2,seq=2 on four NCCL cards,
    captured steps, profiled."""
    check(ranks == 4, "23c runs at --ranks 4")
    t0 = time.perf_counter()
    recs, _, wall = moeg_child_run("moeg_4card", 4, ["23c_lm"], "nccl")
    runs = [r["23c_lm"] for r in recs]
    n_moe = MOE_MODEL["n_layers"] // MOE_MODEL["moe_every"]
    lm = _moeg_measured(runs, n_moe)
    lm.update({"mesh": MOEG_PARTS["23c_lm"][0], "losses": runs[0]["losses"],
               "moe_drop_rate": runs[0]["rates"],
               "captures": [r["captures"] for r in runs],
               "replays": [r["replays"] for r in runs],
               "collectives_per_step": [r["collectives_per_step"]
                                        for r in runs],
               "launches": [r["launches"] for r in runs],
               "peak_memory_gib": [r["peak_memory_gib"] for r in runs],
               "launch_wall_s": wall, "card": card})
    log("phase23c_lm", json.dumps(lm))
    check(all(math.isfinite(v) for v in runs[0]["losses"])
          and all(r["losses"] == runs[0]["losses"] for r in runs),
          f"23c: the MoE LM's losses are not finite or differ by rank: {lm}")
    check(all(r["captures"] == 1 and r["eager_steps"] == 1 for r in runs),
          f"23c: want one eager step and one capture a rank: {lm}")
    lines, twin_wall, _, _ = _launch(
        "moeg_twin", 4, None,
        {"HVT_MESH": "data=2,seq=2", "MOE_EVERY": "2", "N_EXPERTS": "4",
         "HVT_BACKEND": "nccl", "PYTHONUNBUFFERED": "1"},
        code=MOEG_TWIN_CHILD, timeout=900)
    tw = [json.loads(_rank_line(lines, "moeg_twin ", r)) for r in range(4)]
    report = _twin_report(lines)
    twin = _moeg_measured(tw, tw[0]["moe_layers"])
    twin.update({"mesh": "data=2,seq=2", "report": report,
                 "losses": tw[0]["losses"],
                 "captures": [r["captures"] for r in tw],
                 "launch_wall_s": twin_wall, "card": card})
    log("phase23c_twin", json.dumps(twin))
    check(any(ln.endswith("long-range recall: LEARNED") for ln in report),
          f"23c: the twin with MoE at data=2,seq=2 did not learn: {report}")
    return {"lm": lm, "twin": twin, "seconds": time.perf_counter() - t0}


def _moeg_measured(runs, n_moe):
    """23c's measures of one run's ranks: step ms, tokens/s a card, rank
    0's profile and busy share, the routing traffic, and the MoE layers'
    share of the device time a step."""
    prof = runs[0].get("profile") or {}
    busy = prof.get("device_busy_ms_per_step")
    layer_ms = runs[0]["moe_layer_fwd_bwd_ms"]
    return {"step_ms_median": [r["step_ms_median"] for r in runs],
            "tokens_per_s_per_card": min(r["tokens_per_s_per_card"]
                                         for r in runs),
            "device_busy_share": prof.get("device_busy_share",
                                          "not measured"),
            "profile": prof,
            "routing_bytes_per_step": [r["routing_bytes_per_step"]
                                       for r in runs],
            "routing_collectives_per_moe_layer": runs[0].get(
                "routing_collectives_per_moe_layer"),
            "moe_layers": n_moe,
            "moe_layer_fwd_bwd_ms": [r["moe_layer_fwd_bwd_ms"]
                                     for r in runs],
            "moe_share_of_device_time": (
                n_moe * layer_ms / busy if isinstance(busy, float)
                else "not measured")}


# name: (source, TPU kernel it replaces, route, the main path whose
# launches it reports)
KERNELS = {
    "flash_fwd_sm90": ("horovod_tpu_torch/ops/csrc/flash_fwd_sm90.cu",
                       "horovod_tpu/ops/flash_attention.py:149", "tc",
                       "bf16 training (phase 6)"),
    "flash_fwd": ("horovod_tpu_torch/ops/csrc/flash_fwd.cu",
                  "horovod_tpu/ops/flash_attention.py:149", "simt",
                  "f32 training step (phase 7)"),
    "flash_bwd_dq_sm90": ("horovod_tpu_torch/ops/csrc/flash_bwd_dq_sm90.cu",
                          "horovod_tpu/ops/flash_attention.py:233", "tc",
                          "bf16 training (phase 6)"),
    "flash_bwd_dq": ("horovod_tpu_torch/ops/csrc/flash_bwd.cu",
                     "horovod_tpu/ops/flash_attention.py:233", "simt",
                     "f32 training step (phase 7)"),
    "flash_bwd_dkv_sm90": ("horovod_tpu_torch/ops/csrc/flash_bwd_dkv_sm90.cu",
                           "horovod_tpu/ops/flash_attention.py:300", "tc",
                           "bf16 training (phase 6)"),
    "flash_bwd_dkv": ("horovod_tpu_torch/ops/csrc/flash_bwd.cu",
                      "horovod_tpu/ops/flash_attention.py:300", "simt",
                      "f32 training step (phase 7)"),
    # No Pallas kernel: flax's nn.Dropout, whose mask XLA draws.
    "dropout": ("horovod_tpu_torch/ops/csrc/dropout.cu",
                "horovod_tpu/models/cnn.py:41", "simt",
                "tf1 fit(cache='device'), 2 epochs (phase 11)"),
}


def _max_err(cases, keys, route):
    """The largest error over the phase-3 cases of one route."""
    return max((c[k] for c in cases.values() if c["route"] == route
                for k in keys), default=None)


def reduction_multi_card(torch, card, ranks: int):
    """Phase 15b's f32 runs with the overlap off and on, and its replicated
    and ZeRO-1 int8 runs, at ``ranks`` NCCL ranks, each step one captured
    graph with its collectives; at four ranks also the two-hop reduction
    (``HVT_DCN_FACTOR=2``) with the int8 ici wire."""
    res = {"flat": reduction_runs(torch, card, ranks,
                                  ["i_f32", "i_f32_overlap", "ii_int8",
                                   "iii_int8_zero1_overlap"], "nccl")}
    if ranks == 4:
        res["two_hop"] = reduction_runs(
            torch, card, ranks, ["ii_int8", "v_int8_ici_int8_zero1"], "nccl",
            dcn=2)
    return res


def multi_card(torch, ranks: int, reduction_only: bool = False,
               moe_only: bool = False, tp_only: bool = False,
               pp_only: bool = False, moeg_only: bool = False) -> int:
    """``--ranks N``: only the MNIST twins and the CIFAR ResNet-20 twin
    with its breakdown and graph-against-eager check, phase 15b's runs and
    phase 17e, at N NCCL ranks, one card each (the multi-rank NCCL path one
    card cannot host: the gradient all-reduce and, in the ResNet, the BN
    all-reduces inside each rank's captured step; the expert group's sums
    inside the MoE step), then the result line. ``reduction_only``: phase
    15b's runs alone; ``moe_only``: phase 17e alone; ``tp_only``: phases
    20d and 22f alone; ``pp_only``: phase 21c alone; ``moeg_only``: phase
    23c alone."""
    t_start = time.perf_counter()
    try:
        check(torch.cuda.device_count() >= ranks,
              f"--ranks {ranks} needs {ranks} cards, this host has "
              f"{torch.cuda.device_count()}")
        card = toolchain(torch)
        only = moe_only or tp_only or pp_only or moeg_only
        if only:
            build_kernels()
            if moe_only:
                moe_multi_card(torch, card, ranks)
            elif tp_only:
                tp_multi_card(torch, card, ranks)
                item18_multi_card(torch, card, ranks)
            elif moeg_only:
                moeg_multi_card(torch, card, ranks)
            else:
                pp_multi_card(torch, card, ranks)
        elif not reduction_only:
            mnist_tf2(torch, ranks, cut={})
            mnist_tf1(torch, ranks, cut={})
            mnist_ci_cached(torch, ranks)
            cifar_resnet(torch, ranks)
            log("breakdown_cifar", json.dumps(dict(
                cifar_breakdown(torch, ranks), card=card)))
            cifar_graph_vs_eager(torch, ranks)
            log("phase16", json.dumps(dict(
                pod_twin(["127.0.0.1"], ranks, "nccl"), card=card)))
        if not only:
            reduction_multi_card(torch, card, ranks)
        if not (reduction_only or only):
            moe = moe_multi_card(torch, card, ranks)
            if ranks == 4:
                seq_multi_card(torch, card, ranks,
                               moe["dense_tokens_per_s_per_card"])
                tp_multi_card(torch, card, ranks)
                item18_multi_card(torch, card, ranks)
                pp_multi_card(torch, card, ranks)
                moeg_multi_card(torch, card, ranks)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"smoke seconds: {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def checks_lane(torch, card, ci_job):
    """The launched checks whose figures no gate times, started after phase
    14 and run beside phases 15-23's foreground, three at a time: phase 16
    (`launch_phase`), 15c's twins (`reduction_twins`), 17d
    (`moe_ep_two_ranks`), then 18b (`seq_twin`) and 13g (`decode_twin`) as
    the first two finish. Each runs in processes of its own, so the kernel
    counts the foreground reads stay its own; their walls and rates are
    those of a shared card and host. Returns {name: future}."""
    pool = concurrent.futures.ThreadPoolExecutor(3)
    futs = {"launch": pool.submit(launch_phase, torch, card, ci_job),
            "reduction_twins": pool.submit(reduction_twins, torch),
            "moe_ep": pool.submit(moe_ep_two_ranks, torch, card),
            "seq_twin": pool.submit(seq_twin, torch, card),
            "decode_twin": pool.submit(decode_twin, torch)}
    pool.shutdown(wait=False)
    return futs


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="chip_smoke.py")
    parser.add_argument(
        "--ranks", type=int, default=1,
        help="N > 1: run only the MNIST twins (phases 8, 9 and 11's "
             "launch) and the CIFAR ResNet-20 twin (12a) at N NCCL ranks "
             "(N cards)")
    parser.add_argument(
        "--reduction-only", action="store_true",
        help="with --ranks N: only phase 15b's runs at N NCCL ranks")
    parser.add_argument(
        "--moe-only", action="store_true",
        help="with --ranks 4: only phase 17e (expert parallelism on NCCL)")
    parser.add_argument(
        "--tp-only", action="store_true",
        help="with --ranks 4: only phases 20d (tensor parallelism and FSDP "
             "on NCCL, then the long-context twin) and 22f (the seq2seq "
             "twin at data=2,model=2, the MoE LM at expert=2,model=2)")
    parser.add_argument(
        "--pp-only", action="store_true",
        help="with --ranks 4: only phase 21c (the pipeline at pipe = 4 on "
             "NCCL under each schedule, then the long-context twin's pipe "
             "branch)")
    parser.add_argument(
        "--moe-grouping-only", action="store_true",
        help="with --ranks 4: only phase 23c (the MoE LM at "
             "data=1,seq=2,expert=2 and the long-context twin with MoE at "
             "data=2,seq=2 on NCCL)")
    args = parser.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "horovod_tpu_torch")):
        print("chip_smoke: the horovod_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    if args.ranks > 1:
        return multi_card(torch, args.ranks, args.reduction_only,
                          args.moe_only, args.tp_only, args.pp_only,
                          args.moe_grouping_only)
    import resource

    def cpu_s():
        """This process's host CPU seconds so far (every thread)."""
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return ru.ru_utime + ru.ru_stime

    t_start = time.perf_counter()
    laps, cpu, last = {}, {}, [t_start, cpu_s()]

    def lap(name):
        """Seconds (and this process's CPU seconds) since the previous lap,
        kept for the phase_seconds and phase_cpu_seconds lines."""
        now, used = time.perf_counter(), cpu_s()
        laps[name] = round(now - last[0], 1)
        cpu[name] = round(used - last[1], 1)
        last[:] = [now, used]

    try:
        card = toolchain(torch)
        build_kernels()
        lap("1-2 build")
        errs, timings = kernel_cases(torch)
        bwd_errs = backward_cases(torch)
        train_timings = training_shape_timings(torch)
        drop = dropout_cases(torch)
        lap("3-4 kernels")
        serve_launches = main_path(torch)
        main_vs_plain(torch)
        lap("5 serve")
        train_launches = train_path(torch)
        f32_step = train_vs_plain(torch)
        lap("6-7 train")
        # The tf2 twin and phase 11's CI job (launches whose checks read
        # files) share the card with the tf1 twin, whose checks run here.
        cifar_data = cifar_data_start()
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            tf2 = pool.submit(mnist_tf2, torch)
            ci_job = pool.submit(mnist_ci_cached, torch)
            mnist_tf1(torch)
            tf2.result()
            ci, ci_path = ci_job.result()
        lap("8-9 mnist and 11's CI job launched")
        log("breakdown_mnist", json.dumps(mnist_breakdown(torch)))
        cached = cached_in_process(torch, ci_path)
        log("breakdown_mnist_cached", json.dumps(dict(
            cached["breakdown_mnist_cached"], card=card,
            peak_memory_bytes_ci_run=ci["peak_memory_bytes"])))
        lap("8 and 11 in process")
        cifar_data_join(cifar_data)
        cifar_resnet(torch)
        log("breakdown_cifar", json.dumps(dict(cifar_breakdown(torch),
                                               card=card)))
        lap("12a cifar")
        # 12b, 12c, 12d and phase 10 (checks, not timings) share the card
        # at once, beside 20b and 20c's launches (checks; their gloo step
        # ms are host staging, not speed), which phase 20 joins.
        tp_futs = tp_start()
        pp_futs = pp_start(torch)
        item18_fut = item18_start()
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            for fut in [pool.submit(cifar_graph_vs_eager, torch),
                        pool.submit(sync_bn_on_card, torch),
                        pool.submit(cifar_vit, torch),
                        pool.submit(mnist_2rank, torch)]:
                fut.result()
        # 21's one-rank references launch B1-B3 here: done before the
        # phases that count launches.
        pp_futs["refs"].result()
        lap("12b-d cifar, 10 mnist_2rank, 20b-c, 21b, 21d and 22b-e "
            "launched")
        decode = decode_phase(torch)
        lap("13 decode")
        tier = serve_tier(torch, card)
        lap("14 serve tier")
        # The launched checks (16, 15c, 17d, 18b, 13g, 19d's twin and
        # 23a-b) run beside phases 15-23's foreground from here.
        lane = checks_lane(torch, card, ci["ci_job"])
        twin = seq2seq_twin_start()
        moeg_fut = moeg_start()
        reduction = reduction_phase(torch, card)
        lap("15a-b reduction")
        moe = moe_phase(torch, card)
        lap("17a-c moe")
        seq = seq_phase(torch, card)
        lap("18a, 18c seq")
        s2s = seq2seq_phase(torch, card, twin,
                            train_launches["step_ms_median"])
        lap("19 seq2seq")
        tp = tp_phase(torch, card, tp_futs)
        lap("20 tp/fsdp")
        pp = pp_phase(torch, card, pp_futs)
        lap("21 pipeline")
        item18 = item18_phase(torch, card, item18_fut)
        lap("22 item 18")
        moeg = moeg_phase(torch, card, moeg_fut)
        lap("23 moe grouping")
        checked = {name: fut.result() for name, fut in lane.items()}
        lap("16, 15c, 17d, 18b and 13g launched (the rest of their wall)")
        decode["twin"] = checked["decode_twin"]
        reduction.update(checked["reduction_twins"])
        moe["d"], seq["b"] = checked["moe_ep"], checked["seq_twin"]
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    b, t, h, d = TRAIN_ATTN_SHAPE
    launches = {
        "flash_fwd_sm90": train_launches["flash_fwd_tc"],
        "flash_fwd": f32_step["launches"]["flash_fwd"],
        "flash_bwd_dq_sm90": train_launches["flash_bwd_dq_tc"],
        "flash_bwd_dq": f32_step["launches"]["flash_bwd_dq"],
        "flash_bwd_dkv_sm90": train_launches["flash_bwd_dkv_tc"],
        "flash_bwd_dkv": f32_step["launches"]["flash_bwd_dkv"],
    }
    fwd_keys, dq_keys, dkv_keys = ("o_max_abs_err",), ("dq",), ("dk", "dv")
    max_err = {  # (training shape, all phase-3 cases of the route)
        "flash_fwd_sm90": (errs["training_shape"]["o_max_abs_err"],
                           _max_err(errs, fwd_keys, "tc")),
        "flash_fwd": (errs["f32_window"]["o_max_abs_err"],
                      _max_err(errs, fwd_keys, "simt")),
        "flash_bwd_dq_sm90": (bwd_errs["training_shape"]["dq"],
                              _max_err(bwd_errs, dq_keys, "tc")),
        "flash_bwd_dq": (bwd_errs["f32_window_lse_cotangent"]["dq"],
                         _max_err(bwd_errs, dq_keys, "simt")),
        "flash_bwd_dkv_sm90": (
            max(bwd_errs["training_shape"][k] for k in dkv_keys),
            _max_err(bwd_errs, dkv_keys, "tc")),
        "flash_bwd_dkv": (
            max(bwd_errs["f32_window_lse_cotangent"][k] for k in dkv_keys),
            _max_err(bwd_errs, dkv_keys, "simt")),
    }
    train_timings["dropout"] = drop
    launches["dropout"] = cached["dropout_launches"]
    max_err["dropout"] = (drop["max_abs_err"], drop["max_abs_err"])
    replays = {"dropout": cached["dropout_graph_replays"],
               "flash_fwd_sm90": train_launches["graph_replays"],
               "flash_bwd_dq_sm90": train_launches["graph_replays"],
               "flash_bwd_dkv_sm90": train_launches["graph_replays"]}
    lines = []
    for name, (source, replaces, route, path) in KERNELS.items():
        tt = train_timings[name]
        entry = {
            "name": name, "route": "cuda", "kernel_route": route,
            "source": source, "replaces": replaces,
            "launches": launches[name], "launches_on": path,
            "max_abs_err": max_err[name][0],
            "ms": tt["ms"], "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"], "bound_by": tt["bound_by"],
            "library_ms": tt["library_ms"],
            "graph_replays": replays.get(name, 0),
            "shape": tt.get("shape", f"B{b} T{t} H{h} D{d} causal bf16"),
            "max_abs_err_all_cases": max_err[name][1],
            "card": card,
        }
        if name == "flash_fwd_sm90":
            entry["launches_serve"] = serve_launches
            entry["serving_prefill"] = timings["serving_prefill"]
            entry["long_prompt"] = timings["long_prompt"]
            # Phase 13's paths: every prefill of the decode family is a B1
            # launch per layer, on the tensor-core route (bf16).
            entry["launches_decode"] = {
                "generate_greedy": decode["generate"]["greedy"]["b1_launches"],
                "generate_sampled": decode["generate"]["sampled"][
                    "b1_launches"],
                "speculative": decode["speculative"]["b1_launches"],
                "beam": decode["beam"]["b1_launches"],
                **{f"int8_{k}": v
                   for k, v in decode["int8"]["b1_launches"].items()},
                "bundle_served": decode["bundle"]["b1_launches_served"],
            }
            entry["window_sinks_prefill"] = decode["window_sinks_prefill"]
            # Phase 14's paths in this process (the router's replicas are
            # processes of their own): a prefill is 8 B1 launches, all tc.
            entry["launches_serve_tier"] = {
                "coalesced": tier["coalesced"]["b1_launches"],
                "speculative": tier["speculative"]["b1_launches"],
                "ab_coalescing": tier["ab"]["coalescing"]["b1_launches"],
                "ab_continuous": tier["ab"]["continuous"]["b1_launches"],
            }
        if name.endswith("_sm90"):
            # Phase 15b's runs (rank 0 of two gloo ranks): n_layers × K ×
            # (eager steps + captures) each, all on the tensor-core route.
            key = {"flash_fwd_sm90": "flash_fwd_tc",
                   "flash_bwd_dq_sm90": "flash_bwd_dq_tc",
                   "flash_bwd_dkv_sm90": "flash_bwd_dkv_tc"}[name]
            entry["launches_reduction"] = {
                run: rec["launches"][key]
                for run, rec in reduction["runs"].items()}
            # Phase 17a: the bench MoE LM's fit, n_layers × (eager steps +
            # captures), all on the tensor-core route.
            entry["launches_moe"] = moe["a"]["launches"][key]
            # Phase 18b: the twin's flash ring at two seq ranks, n_layers ×
            # (the hops a rank runs) a step, all on the tensor-core route;
            # 18a: this kernel at the ring's hops (the q_offset hop, the
            # merge's lse cotangent).
            entry["launches_ring"] = [r[key] for r in seq["b"]["launches"]]
            # Phase 19b: the bench seq2seq's fit, 18 sites × (eager steps +
            # captures); 19f: LoRA on the bench LM, n_layers × (eager
            # steps + captures); both all on the tensor-core route. 19a:
            # this kernel at the seq2seq sites' masks.
            entry["launches_seq2seq"] = s2s["b"]["launches"][key]
            entry["launches_seq2seq_graph_replays"] = s2s["b"][
                "graph_replays"]
            entry["launches_lora"] = s2s["f"]["launches"][key]
            entry["seq2seq_masks"] = {site: t_[name] for site, t_ in
                                      s2s["a"].items()}
            entry["ring_hops"] = {
                hop: t_[name] for hop, t_ in seq["a"]["timings"].items()
                if name in t_}
            # Phase 20b/20c: the bench LM at model = 2 (4 local heads) and
            # fsdp = 2, two gloo ranks each, n_layers × TP_STEPS a rank,
            # all on the tensor-core route; 20a: this kernel at the model
            # = 2 rank's attention shape.
            entry["launches_tp"] = {
                part: [r[key] for r in tp[part]["launches"]]
                for part in ("b", "c")}
            entry["tp_local_heads"] = tp["a"]["timings"][name]
            # Phase 21b: the bench-width PipelinedLM at pipe = 2, two gloo
            # ranks, PP_STEPS eager steps a schedule: (L/S) × n_micro a
            # step a rank (1F1B's recompute: B1 twice that), all on the
            # tensor-core route; 21a: this kernel at a microbatch's shape.
            entry["launches_pipeline"] = {
                sched: [r[key] for r in pp["b"][sched]["launches"]]
                for sched in PP_SCHEDULES}
            entry["pipeline_microbatch"] = pp["a"]["causal"]["timings"][name]
            # Phase 21d/21e: pp × sp on packed, windowed rows (four gloo
            # ranks; seq rank 1 runs two ring hops a layer, rank 0 one)
            # and the MoE pipeline, PP_SP_STEPS eager steps each, all on
            # the tensor-core route; 21a+: this kernel on a packed and a
            # windowed microbatch and at the ring's hops of a seq = 2 one.
            entry["launches_pipeline_second_half"] = {
                run: [r[key] for r in pp[part][run]["launches"]]
                for part in ("21d", "21e") for run in pp[part]}
            entry["pipeline_microbatch_masks"] = {
                part: pp["a"][part]["timings"][name]
                for part in ("packed", "window")}
            entry["pipeline_ring_hops"] = {
                hop: t_[name] for hop, t_ in pp["a"]["ring"]["timings"].items()
                if name in t_}
            # Phase 22b-d: the bench seq2seq at model = 2 (18 sites × 2
            # steps a rank), the bench MoE LM and LoRA over the bench LM at
            # model = 2 and fsdp = 2 (8 layers × 2 steps a rank), two gloo
            # ranks each, all on the tensor-core route; 22a: this kernel at
            # a model = 2 rank's seq2seq masks.
            entry["launches_item18"] = {
                part: [r[key] for r in item18[part]["launches"]]
                for part in ITEM18_PARTS if part != "22e"}
            entry["seq2seq_masks_model2"] = {
                site: t_[name] for site, t_ in item18["a"].items()}
            # Phase 23a: the bench MoE LM at seq = 2 on the flash ring, two
            # gloo ranks, n_layers × hops × MOEG_STEPS a rank (a hop a
            # layer on seq rank 0, two on rank 1), all on the tensor-core
            # route.
            entry["launches_moe_grouping"] = {
                "23a": [r[key] for r in moeg["23a"]["launches"]]}
        if name == "flash_fwd":
            # The ring's f32 comparison (13e) prefills on the CUDA-core route;
            # so does 22e's f32 int8 decode at model = 2 (8 a gloo rank).
            entry["launches_decode_ring_f32"] = decode["ring"]["b1_launches"]
            entry["launches_item18"] = {"22e": [
                r["flash_fwd"] for r in item18["22e"]["launches"]]}
        if name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            # Phase 23b: the f32 MoE LM at data = 2 (groups across the
            # shards), n_layers × steps a gloo rank on the CUDA-core route.
            entry["launches_moe_grouping"] = {
                part: [r[name] for r in moeg[part]["launches"]]
                for part in ("23b", "23b_ec")}
        lines.append(entry)
    log("phase_seconds", json.dumps(laps))
    log("phase_cpu_seconds", json.dumps(cpu))
    log("launch_cost", json.dumps(LAUNCH_COST))
    children = resource.getrusage(resource.RUSAGE_CHILDREN)
    log("host_cpu_seconds", json.dumps({
        "smoke_process": round(cpu_s(), 1),
        "children": round(children.ru_utime + children.ru_stime, 1)}))
    log(f"smoke seconds: {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
