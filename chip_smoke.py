#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths on ``cuda:0`` — serving as a task farm, and
training in sync and in farm mode, of qwen3-1.7B; serving and sync
training of falcon-mamba-7b; serving and sync training of minicpm3-4b,
phi-3-vision-4.2b and whisper-tiny; serving and sync training of the MoE
family, llama4-maverick and arctic; serving jamba-1.5-large-398b, the
hybrid of Mamba, attention and MoE, and one request of it at long
context; a training step and serving of minicpm3-4b and phi-3-vision-4.2b
in fp32; model programs and training programs batched through
``Service.execute_batch``; the port's two examples — and holds every hand-written kernel of those paths
against its plain PyTorch version.  Phases, in order; any
failure raises and exits non-zero:

1. build the CUDA kernels from this checkout's sources (one ``nvcc`` per
   source, all started together; each library's seconds printed), print
   each kernel's registers, spills and static shared memory, count the
   tensor-core (``HGMMA``) and TMA (``UTMALDG``) instructions in the SASS
   of the six Hopper attention libraries (flash forward, backward dq and
   dk/dv, each in bf16 and in fp32; failing if either is 0) and the
   asynchronous-copy (``LDGSTS``) instructions in the decode and scan
   libraries (failing if 0), hold every shared-memory query of the fp32
   forward and both pairs at every tile to the tuning space's, print the
   register probe (ptxas on every instantiation those five kernels'
   shared-memory bounds admit, their register rules lowered: what the
   rules are written from), decode's and the scan's shared memory, and
   print the card's name and power limit;
2. each attention kernel against its plain version on the card, on the
   same inputs, at every shape its paths give it (``FLASH_SHAPES``,
   ``DECODE_SHAPES``): qwen3's serve shapes (B=4, H=16, K=8, D=128, Sq =
   Skv = 512, a 576-slot cache) in bf16 and fp32 (flash goes to the Hopper
   kernel of its dtype: fp32 products as three tf32 products each); the
   flash forward at (D, Dv) = (96, 64) (minicpm3's MLA prefill: B=4,
   S=512, H=K=40) and (96, 96) (phi-3's, H=K=32, S=512 and 768) in bf16
   and fp32 (phase 20's), and the bf16 one at
   whisper's D=64, H=K=6: non-causal encoder (1500 x 1500) and
   cross-attention (64 x 1500), causal decoder self-attention (64 x 64);
   decode at D=96 on phi-3's 544-slot cache in bf16 and fp32 and at D=64 on
   whisper's 128-slot self-attention cache; the odd GQA groups of phase 17
   in bf16 at D=128: flash at B=4, S=512, H=40, K=8 (llama4, G=5) and H=56,
   K=8 (arctic, G=7), one q-head a block, and decode at both on a 544-slot
   cache (5 or 7 q-heads in a block of 8); phase 19's G = 8 (jamba: H=64,
   K=8): flash two q-heads a block, decode the block of 8 full.  Each runs
   again at a ragged
   size (Sq = 13; a 24-slot cache with ``cache_index`` mid-cache) and
   decode on one request alone.  Then each kernel, its plain version and
   PyTorch's SDPA are timed at each serve shape (decode in bf16, at B=4
   and at B=1 with the number of KV splits it launched) beside the bound;
   SDPA runs with K and V expanded to H heads outside the timed region,
   under each of its flash, memory-efficient and cuDNN backends that
   takes the inputs, and the fastest is kept with its backend's name.  The
   host cost of the bf16 kernel's three TMA descriptors is timed too;
3. serve full-width qwen3-1.7B (bf16, weights from a seeded generator on
   the card) through ``BasicClient`` on 2 in-process services: 16 requests,
   prompt 512, 64 new tokens, 4 requests per task.  The kernels' launch
   counts are zeroed just before and read just after: every prefill layer
   goes through the bf16 flash kernel, none through the fp32 one;
4. one prefill and one decode step at full width through the kernels and
   through the plain versions, with the same weights, on several prompt
   batches;
5. the flash-backward kernels (dq, then dk/dv) against the plain
   backward at every shape a training path gives them (``BWD_SHAPES``):
   qwen3's (B=4, H=16, K=8, D=128, S=512) in bf16 (the Hopper bf16 pair)
   and fp32 (the Hopper fp32 pair: three tf32 products for each
   product); minicpm3's MLA at (D, Dv) = (96, 64) (B=4, S=512, H=K=40)
   and phi-3's (96, 96) (H=K=32, S=512 and 768) in bf16 and fp32 (phase
   20's), in bf16 whisper's D=64,
   H=K=6: non-causal encoder (1500 x 1500) and cross-attention (448 x
   1500), causal decoder self-attention (448 x 448); the MoE family's odd
   GQA groups at D=128 (B=4, S=512, K=8: H=40, G=5, llama4; H=56, G=7,
   arctic; one q-head a dq block, an odd number of dk/dv steps at Sq = 13);
   each also at a ragged size (Sq = 13, and Skv = 13 where Skv = Sq); a
   second launch bit-identical.  Each kernel, the whole backward (dq + dk/dv in one
   call), the plain backward and PyTorch's SDPA backward timed at each
   training shape beside each kernel's bound: SDPA's backward alone (one
   forward with grad-enabled inputs, then ``autograd.grad`` timed), K and
   V expanded, each backend as in phase 2;
6. sync training of full-width qwen3-1.7B with its depth cut from 28 to
   ``TRAIN_LAYERS`` = 8 layers, fresh seeded weights (``Trainer``, 4
   AdamW steps on MarkovDataset batches of 4 x 512, fp32 moments), the
   launch counts zeroed just before and read just after (the bf16
   forward, dq and dk/dv kernels each at least once per layer per step,
   the fp32 ones never), one profiled step, and a checkpoint saved and
   restored into a fresh state;
7. one full-width training step's loss and gradients (phase 6's depth)
   through the kernels and through the plain versions, same weights,
   same batch, in
   bf16 (the trained weights) and in fp32 (fresh fp32 weights; the launch
   counts zeroed just before and read just after: this is the fp32
   forward, dq and dk/dv kernels' path, once per layer, and no bf16
   kernel's);
8. farm-mode training (``LocalSGDTrainer``) at full width with depth cut
   to 8 layers on the 2 services: one round of 4 tasks, then one more with
   a service failing after one task (the bf16 kernels launched, the fp32
   ones not);
9. (qwen3's state freed) the selective-scan kernel against the plain
   chunked scan in fp32 at the serve shapes (b=4, s=512, n=16, d_inner
   8192 for falcon-mamba, 16384 for jamba), at a ragged (2, 13, 96, 16),
   with h0 (two halves chained against one whole scan) and with strided
   x, B and C; kernel (graph-timed and back to back) and plain timed at
   each serve shape beside the bound's bytes, exponential and flop terms;
10. serve full-width, full-depth falcon-mamba-7b (64 layers, bf16, seeded
    weights) through ``BasicClient`` on the 2 services: 8 requests, prompt
    512, 32 new tokens, 4 requests per task, asserting exactly one scan
    launch per layer per task; one task timed alone and profiled;
11. falcon-mamba-7b prefill and decode logits through the kernels and
    through the plain versions, same weights, on several prompt batches;
12. sync training of falcon-mamba-7b at full width, depth cut to 8
    layers (4 AdamW steps on batches of 2 x 512), asserting one scan launch
    per layer per step, and one profiled step;
13. (everything freed) serve phase 3's load — the same 16 prompts, 64 new
    tokens, 4 requests a task — through ``BasicClient`` on a ``NowPool``
    of 2 ``proc://`` worker processes on ``cuda:0``, each a fresh
    interpreter with its own CUDA context.  The program ships by
    reference (``chip_smoke.WorkerGenerate``: arch, seed, ``ServeConfig``)
    and builds the weights at its first call on each worker from phase 3's
    seeded generator.  Round 1 is cold (worker start-up, weight builds),
    round 2 warm, with each worker's launch counts zeroed just before and
    read just after by a second shipped program (``WorkerLaunches``):
    summed over the workers, 28 bf16 flash launches and 1,792 decode
    launches a task, no other kernel's.  In round 3 worker 0 is SIGKILLed
    (``NowPool.kill``) after its first task and the survivor finishes;
    the repository must show a rescheduled task.  Then 8 requests on a
    fresh pool of 2 ``shm://`` workers.  Every round's tokens must equal
    phase 3's bit for bit; start-up to first result, each round's wall
    time and tok/s are printed beside phase 3's;
14. serve phase 3's load again on a ``TcpPool`` of 2 ``tcp://`` workers
    on ``cuda:0`` bound to 127.0.0.1, which register themselves into a
    network ``LookupServer``; the client's lookup is a ``RemoteLookup``.
    Round 1 is cold; round 2 warm, with the workers' launch counts as in
    phase 13 (handles resolved from the client's lookup); round 3 runs
    after ``LookupServer.restart()`` (registry wiped, every connection
    dropped) once both workers have re-registered through their
    keepalive: both must serve tasks, each worker's ``RemoteLookup`` must
    show a reconnect and a replayed registration, and no worker may
    rebuild its weights (read by a shipped ``WorkerState``); in round 4
    worker 0 is SIGKILLed after its first task and a task must be
    rescheduled.  Every round's tokens must equal phase 3's bit for bit;
    each round's wall time and tok/s are printed beside phase 3's and
    phase 13's;
15. (everything freed) one family at a time, with weights from the seeded
    generator on the card, served through ``BasicClient`` on the 2
    in-process services with every launch count zeroed just before and
    read just after: full-width, full-depth minicpm3-4b (MLA; 8 requests,
    prompt 512, 32 new tokens: exactly 62 bf16 flash launches a task at
    (96, 64) and no decode launch, its decode being the absorbed form)
    and phi-3-vision-4.2b (text only, as ``serve_requests`` builds tasks:
    32 flash launches at (96, 96) and 1,024 decode launches at D=96 a
    task), then whisper-tiny (tasks of 4 prompts of 64 tokens with seeded
    1,500 x 384 stub encoder frames through ``make_generate_program``, 64
    new tokens: 12 flash and 256 decode launches a task); no other kernel
    launches.  minicpm3's task is timed alone and profiled.  Each
    family's prefill and decode logits (phi-3's prefill with 256 seeded
    patch embeddings before 512 tokens, then 4 decode steps at cache_index
    768 + i) through the kernels and through the plain versions, same
    weights, on 4 batches;
16. (everything freed) one family at a time, sync training at full width
    and full depth (``Trainer``, 4 AdamW steps, fp32 moments, seeded
    weights) on MarkovDataset batches of 4 sequences (``FamilyBatches``):
    minicpm3-4b on 512 tokens, phi-3-vision-4.2b on 256 seeded patch
    embeddings and 512 tokens, whisper-tiny on 448 tokens beside 1,500
    seeded encoder frames.  Every launch count is zeroed just before and
    read just after: exactly one bf16 flash forward, dq and dk/dv launch an
    attention layer a step (minicpm3 62 at (96, 64), phi-3 32 at (96, 96),
    whisper 12: 4 encoder, 4 self, 4 cross), nothing else.  Step time,
    tok/s, peak memory and one profiled step are printed; the losses must
    be finite and step 0's batch must score lower after training.  Then,
    the moments freed, one step's loss and gradients through the kernels
    and through the plain versions, same weights, same batch, held to
    ``FAMILY_TRAIN_LIMITS``;
17. (everything freed) the MoE family as phase 15 serves its families,
    one config at a time, at full width with the depth cut to whole
    repeats of the pattern that one card holds (``MOE_LAYERS``, printed as
    a ``reduced`` list beside the weights each cut takes):
    llama4-maverick-400b-a17b at 2 layers (a dense and an MoE block,
    128 experts, top-1, a dense residual; H=40, K=8) and arctic-480b at 2
    layers (two MoE blocks, 128 experts, top-2, a dense residual; H=56,
    K=8).  Exactly 2 flash and 64 decode launches a task, nothing else;
    one task timed alone and profiled; each config's prefill and 4 decode
    steps of logits through the kernels and through the plain versions on
    4 batches, with the share of (token, choice) routing decisions that
    differ between the two paths (a one-ulp bf16 difference in attention
    can flip a near-tied router choice);
18. (everything freed) the MoE family trained as phase 16 trains its
    families, one config at a time, at full width on phase 17's depth with
    the expert count cut from 128 to 32 (``MOE_TRAIN_EXPERTS``; the cuts
    printed as a ``reduced`` list with the training state each saves):
    ``Trainer``, 4 AdamW steps with the config's own moments (llama4 bf16,
    arctic int8) and its own ``remat=True`` (each pattern repeat
    checkpointed), seeded weights, batches of 4 x 512.  Exactly 4 bf16
    flash forwards (2 attention layers, each run again by the recompute),
    2 dq and 2 dk/dv launches a step, nothing else; losses finite, step
    0's batch scoring lower after training; step time, tok/s, peak memory
    (below 80 GB, beside the state's reckoning) and one profiled step.
    Then, the moments freed, one step's loss and gradients through the
    kernels and through the plain versions held to
    ``FAMILY_TRAIN_LIMITS``, with the (token, choice) routing decisions
    that differ between the two and a check that each recompute routed as
    its forward did; then the same step with remat off (one flash forward
    a layer), whose loss and gradients must equal remat's, bit for bit or
    within ``REMAT_GRAD_TOL``;
19. (everything freed) jamba-1.5-large-398b served as phase 17 serves the
    MoE family, at full width on one period of its pattern (8 of 72
    layers: attention at position 0, H=64, K=8, G=8; Mamba-1 at 1-7,
    d_inner 16384; MoE MLPs at the odd positions) with the experts cut
    from 16 to 8 (``JAMBA_EXPERTS``; both cuts printed as ``reduced``
    lists beside the weights they save): exactly 1 flash, 7 scan and 32
    decode launches a task, nothing else; one task timed alone and
    profiled; prefill and 4 decode steps of logits through the kernels
    and through the plain versions on 4 batches, held to jamba's
    ``FAMILY_LIMITS`` with the plain versions' top-k choices pinned to the
    kernels' (``RoutingPin``), the comparison with each path routing its
    own inputs printed beside it; the share of top-k choices the plain
    router makes otherwise held to ``ROUTING_LIMITS`` on both, and the
    differing decisions split into first flips and the drops that follow,
    by MoE layer.
    Then long context: ``long_context=True`` on one of those batches
    (inside the 2,048-token window) against the kernels, the same way; one
    request of 4,096 tokens through ``prefill(long_context=True)`` and 4
    decode steps, the counts zeroed just before and read just after (no
    flash or decode launch: the attention layer runs the plain windowed
    path; 7 scan launches), finite logits, the last logits away from those
    of the same plain attention without a window by more than ``BITES``
    times the largest kernels-vs-plain gap; and, the served model
    freed, each decode step within ``CONSISTENCY_TOL`` of a prefill of
    the longer prompt, in fp32 with 2 experts at a capacity that drops
    nothing (``JAMBA_FP32_EXPERTS``);
20. (everything freed) minicpm3-4b (MLA, (D, Dv) = (96, 64)) and
    phi-3-vision-4.2b ((96, 96)) in fp32 at full width, depth cut to
    ``TRAIN_LAYERS`` = 8 as phase 7 cuts qwen3, seeded weights, one family
    at a time: one training step's loss and gradients through the kernels
    and through the plain versions on a ``FamilyBatches`` batch (phi-3's
    256 seeded patches + 512 tokens), held to ``TRAIN_LIMITS[fp32]``;
    then a prefill and 4 decode steps of ``FP32_FAMILY_BATCHES`` batches,
    the same greedy token fed to both, logits held to ``CONSISTENCY_TOL``.
    The counts are zeroed just before each and read just after: one fp32
    flash forward, dq and dk/dv launch a layer in the step; one fp32 flash
    forward a layer a prefill and, for phi-3, one decode launch a layer a
    step; no bf16 kernel.  Peak memory is printed.
21. model programs through ``Service.execute_batch``: N = BATCH_TASKS
    tasks as one ``torch.func.vmap`` call, each kernel entry folded by its
    vmap rule (``repro_torch/kernels/batched.py``) into one launch.  First
    each entry under vmap at every serve shape of FLASH_SHAPES and
    DECODE_SHAPES and the scan at falcon-mamba's and jamba's widths: one
    launch and one rule call, held against N per-task launches of the same
    kernel (flash and the scan bit for bit, decode within
    BATCH_DECODE_TOL, its KV split counts printed).  Then full-size
    qwen3-1.7B's generate program (4 requests a task, PROMPT-token
    prompts, NEW new tokens) on one Service, the same tasks one at a time
    and as one execute_batch, timed: the counts zeroed just before each
    and read just after, the batched call's launches one task's (28 flash,
    1,792 decode), each through one rule call; the batched prefill and
    decode step timed and profiled beside phase 3's one task alone;
    batched against per-task logits (``batched_logits``: a prefill and
    BATCH_STEPS decode steps fed the same tokens, held to
    BATCH_QWEN3_LIMITS); the farm through BasicClient on SERVICES
    services at max_batch 4 and 1 (qwen3 cut to TRAIN_LAYERS layers,
    BATCH_FARM_NEW new tokens; tok/s printed, a reading).  Then each of
    BATCH_MODELS (qwen3 in fp32, falcon-mamba-7b and minicpm3-4b cut to
    TRAIN_LAYERS layers, llama4-maverick to 2 with its top-k choices
    pinned to the per-task run's): launches of a batched call equal one
    task's, logits held to its limits, peak memory printed;
22. the port's examples at their defaults, side by side, each in its own
    process: ``examples/torch_serve_farm.py`` (two weighted tenants on
    one FarmScheduler over qwen3-1.7B, a stream under a window of 8, a
    service joining mid-run) and ``examples/torch_train_lm.py`` (300
    AdamW steps on the Markov stream with a checkpoint restart, the loss
    dropping by more than a nat) and ``examples/torch_autotune.py``
    (``sim://`` sweeps with the scripted cost model, their winners cached
    and dispatched through on the card); their output printed, any one
    failing fails the script;
23. the autotuner (``repro_torch.tune``) on the card, within
    TUNE_PHASE_LIMIT_S: the tuning space against the kernels (every
    instantiation of the bf16 and fp32 forwards and of both backward
    pairs built where the space's rules admit it and refused where not,
    each kernel's shared-memory query equal to the space's
    ``smem_bytes``, no ptxas spill in what tuning adds, the build time);
    every candidate of TUNE_SWEEPS held to its plain version with phase
    2's (phase 5's for the pairs, phase 9's for the scan) element check,
    also at ragged shapes, the untuned call bit-identical to an explicit
    one at the untuned tiles, the pairs' second launch bit-identical, and
    configs the kernels refuse raising by name, from an argument and
    from a cache entry; each sweep of TUNE_SWEEPS through a KernelTuner
    over a farm of one service on the card, its summary printed, its
    winner re-timed against the default in turns and no slower within
    the spread; two same-seed ``sim://`` sweeps byte-identical; a
    cache-hit probe within TUNE_PROBE_SHARE of phase 2's host time of a
    wrapper call; qwen3-1.7B at full width, TUNE_SERVE_LAYERS layers,
    served through ``launch/serve.py --tune-cache`` with the winners:
    cache hits, a task's launches as phase 3's a layer, logits of the
    tuned dispatch held to phase 4's limits against the untuned kernels;
    one qwen3-1.7B training step at full width, TRAIN_LAYERS layers, in
    bf16 and fp32 through the winners' cache and through the runners-up:
    one dq and one dk/dv a layer, gradients held to phase 7's
    TRAIN_LIMITS against the untuned kernels;
24. training programs batched through ``Service.execute_batch``: the scan
    kernel with one ``A`` a batch row (b, d, n) at falcon-mamba's width
    held to the plain scan (phase 9's check, a ragged s too) and, every
    row's A the shared one, bit-identical to the stride-0 launch; then the
    local-SGD round (``make_local_round_program``, FARM_INNER AdamW steps
    a task) of BATCH_TRAIN's configurations, its tasks as one
    ``execute_batch`` (``torch.func.vmap`` of ``torch.func.grad``, each
    task with its own weights, gradients, AdamW state and delta) and the
    same tasks one at a time through ``Service.execute``: the batched call
    launches each kernel exactly as often as one task (the flash forward,
    dq, dk/dv and the scan, each through its vmap rule); each task's round
    loss, and a held-out batch's loss after its batched delta against
    after its per-task one, within its BATCH_TRAIN loss limit, one inner
    step's gradients within its gradient limit, the deltas' difference
    read; wall times and peak memory printed beside the reckoned state;
    qwen3's tasks then through ``BasicClient`` at ``max_batch`` = their
    number on one service: one lease, one call, the direct call's results.
25. the SPMD layer on one card: (a) a one-rank NCCL group on a
    ``HashStore`` and its ("data", "model") = (1, 1) mesh through
    ``make_elastic_mesh(viable_mesh_shape(1, model=1))``; (b) full-width,
    full-depth qwen3-1.7B distributed by its serve specs
    (``distribute_model``), one prefill of SPMD_BATCH x SPMD_PROMPT tokens
    and SPMD_STEPS decode steps under the mesh against the same without
    it at phase 4's limits (bit-identity printed), exactly one bf16 flash
    launch a layer through ``local_map`` and one decode launch a layer a
    step (a one-device "model" axis leaves nothing to merge), the KV
    caches where ``cache_partition_specs`` puts them after prefill and
    after every step; (c) qwen3 at
    TRAIN_LAYERS layers on DTensor parameters (train specs): the loss and
    gradients under the mesh against the mesh-free ones at phase 7's
    limits, one ``make_train_step(axes=...)`` step launching one bf16
    forward, dq and dk/dv a layer and nothing else, its updated weights
    held too; (d) SPMD_HEAD_PLANS split over SPMD_TP head shards as
    ``flash_attention_tp`` lays them out, each shard's forward and
    backward pair launched in turn, held to the unsharded kernels; (e)
    qwen3's decode cache split into 4, 8 and 16 chunks, each chunk's
    decode kernel (with its log-sum-exp; no launch for a chunk wholly past
    cache_index) held to the chunk's plain partials and the chunks merged
    as the all-reduces merge them, held to the unsharded decode kernel at
    the reference's bf16 decode tolerance; (f) jamba's long
    context, the chunked flash's manual backward against autograd through
    ``chunked_attention`` (LONG_GRAD_TOL), each one's peak memory printed;
    (g) the phase's seconds; the group destroyed at the end.
26. the dry run held to the card (``repro_torch.launch.dryrun``, fake
    tensors over a fake process group, in subprocesses): (a) qwen3-1.7B's
    prefill of SPMD_BATCH x SPMD_PROMPT tokens at full depth, a decode
    step on a SPMD_PROMPT + SPMD_STEPS slot cache and one AdamW step at
    TRAIN_LAYERS layers dry-run on a fake (1, 1) ``cuda`` mesh (each kernel
    wrapper through its op's fake impl) while the same steps run for real
    and mesh-free on the card: each kernel op's calls equal to the
    launches; (b) the dry run's non-kernel FLOPs equal to
    ``FlopCounterMode``'s over the real step, exactly, and falcon-mamba's
    prefill at phase 11's shape on fake CUDA tensors with no mesh: its scan
    op calls equal to the real prefill's scan launches, its non-kernel
    FLOPs to ``FlopCounterMode``'s; (c) the predicted peak memory within
    DRY_PEAK_TOL of ``max_memory_allocated`` over the real step, its
    arguments resident; (d) qwen3's ``train_4k``, ``prefill_32k`` and
    ``decode_32k`` on the 16 x 16 mesh and ``train_4k`` on 2 x 16 x 16,
    their records and roofline rows printed (predictions from data-sheet
    constants, not timings), each cell cut at DRY_PROD_LIMIT_S from the
    phase's start and named if cut; (e) the phase's seconds.
27. the Mamba, MoE and hybrid families sharded: (a) a one-rank NCCL
    ("data", "model") = (1, 1) mesh, as phase 25's; (b) falcon-mamba-7b at
    full size and llama4-maverick at 2 layers (128 experts) served under
    it (serve specs) against the same weights without it, SPMD_BATCH x
    SPMD_PROMPT prompt tokens and SPMD_STEPS greedy steps: logits
    bit-identical, one scan launch a Mamba layer's prefill through
    ``local_map`` on the rank's d_inner shard, one flash an attention
    layer's prefill and one decode an attention layer and step; (c)
    falcon-mamba at MAMBA_TRAIN_LAYERS layers and llama4 at 2 layers with 8
    experts trained one ``make_train_step(axes=...)`` step on DTensor
    parameters against the mesh-free step: loss, gradients, the step's
    loss and grad_norm and the updated weights bit-identical (the
    mesh-free ones kept on the host), the step's launches exact; (d) in
    subprocesses started with the phase, the eight dry-run cells of the
    Mamba, MoE and hybrid families (falcon-mamba, jamba, llama4 and arctic,
    ``train_4k`` and ``prefill_32k``, on a fake 16 x 16 CUDA mesh; the
    training cells cut to DRY_CELLS' depths), each ``ok`` with its FLOPs and
    peak a card and its cut printed; (e) qwen3's ``train_4k`` there at full
    depth with the loss vocabulary-parallel and, patched, with the
    whole table a rank: FLOPs a card and MODEL/HLO beside the card's name
    and power limit; (f) the phase's seconds.

The line before the last is a JSON object with each kernel's numbers, one
row each: the bf16 flash forward (``flash_attention_fwd``), the fp32 one
(``flash_attention_fwd_fp32``), decode, the scan, phase 15's shapes of
the bf16 flash forward (``flash_attention_fwd_d96_dv64``,
``flash_attention_fwd_d96``) and of decode (``decode_attention_fwd_d96``),
dq and dk/dv in bf16 and in fp32 (``..._fp32``), and phase 16's shapes of
the bf16 pair (``flash_attention_bwd_{dq,dkv}_d96_dv64``, ``..._d96`` at
S = 768, ``..._whisper`` on the encoder), and phase 17's odd GQA groups of
the bf16 flash forward and decode (``flash_attention_fwd_g5``, ``..._g7``,
``decode_attention_fwd_g5``, ``..._g7``), and phase 18's of the bf16 pair
(``flash_attention_bwd_{dq,dkv}_{g5,g7}``), and phase 19's G = 8 of the
flash forward and decode (``flash_attention_fwd_g8``,
``decode_attention_fwd_g8``) and d_inner = 16384 of the scan
(``mamba_scan_d16384``), and phase 20's fp32 forward
(``flash_attention_fwd_fp32_d96_dv64``, ``..._fp32_d96`` at S = 768) and
pair (``flash_attention_bwd_{dq,dkv}_fp32_{d96_dv64,d96}``), their launches
those of phase 20's runs (the forward's: training step and serving
summed); each row's ``knobs`` are its kernel's tunable launch parameters
and the values the tuning space takes (none for fixed tiles).  The last
line is ``{"ok": true, "device": {...}}``.  Times are CUDA-event times on
this card without flushing the 50 MB L2 cache (the serve and training
paths find their inputs freshly written): for every kernel, its library
call (SDPA) and the plain attention versions, of CUDA-graph replays of
repeated calls (device time: a wrapper's host time exceeds the faster
kernels' own); for the plain scan, of back-to-back calls.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

ARCH = "qwen3_1p7b"
SERVICES, REQUESTS, PROMPT, NEW, PER_TASK = 2, 16, 512, 64, 4
SEED = 0
TIMED_ROUNDS = 3
# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32_FLOP_S = 495e12
# An fp32 attention product passes the fp32 element check (ATOL below) on
# the tensor cores only as three tf32 products, hi hi + hi lo + lo hi
# (tests/test_torch_flash_fp32_sm90.py counts what fewer terms miss): the
# least time the card can take for it is three times its flops at the TF32
# peak, less than its flops at the CUDA cores' 67 TFLOP/s.  The scan's fp32
# work is no matrix product and keeps the CUDA cores' rate.
TF32_TERMS = 3
# Kernel vs plain version on the same inputs, element by element:
# |got - ref| <= ATOL + rtol * |ref|.  Both compute every product, the
# softmax and the sums in fp32 and differ only in summation order, so
# fp32 outputs (and lse, always fp32) agree to ATOL; a bf16 output may
# round the other way, by one bf16 ulp, <= 2^-7 |ref|.  A flip just above
# a power of two reads close to 1 on the printed scale; two ulps fail.
ATOL = 2e-5
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
# Full-width logits, kernels vs plain versions (phase 4): the one-ulp
# differences above pass through 28 layers of bf16 matmuls.  Limits on
# the largest and on the mean |difference| of each batch's logits, from
# this script's readings on an H100 over 8 batches, prefill and decode:
# largest 5.6e-2 to 6.8e-2, mean 9.8e-3 to 1.03e-2 (see PERF.md).
FULL_WIDTH_BATCHES = 8
FULL_WIDTH_MAX_ERR = 0.09
FULL_WIDTH_MEAN_ERR = 0.0125
# Backward kernels vs the plain backward, element by element:
# |got - ref| <= BWD_ATOL + rtol * |ref|, rtol as above.  Each gradient
# element is an fp32 sum of up to S * G = 1024 products whose terms reach
# ~10 (dp = dO.V over D=128 unit-variance pairs), summed in another order
# than the plain version's einsums: a random walk of 1024 roundings of
# 2^-24 * 10 is ~2e-5, so fp32 outputs agree to BWD_ATOL = 1e-4; a bf16
# output may round the other way, one ulp, as for the forward.  The bf16
# pair multiplies bf16 operands on the tensor cores with fp32 sums and
# splits P and dS into two bf16 terms, which a CPU model of its
# arithmetic keeps within this check (tests/test_torch_flash_bwd_sm90.py;
# rounding either once does not).  The fp32 pair issues each product as
# three tf32 products, which a CPU model of its arithmetic keeps within
# BWD_ATOL and within 1.3e-6 of the plain gradients' norm
# (tests/test_torch_flash_bwd_fp32_sm90.py; two terms in any product do
# not).
BWD_ATOL = 1e-4
# Training path (phases 6-8).  Phases 6 and 7 train qwen3 at full width
# cut to TRAIN_LAYERS layers (at the full 28, the checkpoint alone is
# 17.2 GB and takes ~60 s to save and restore), so that the script stays
# within the time its earlier versions took as it grows.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LAYERS = 4, 512, 4, 8
# the attention kernels a training step launches in bf16 and in fp32 (the
# Hopper kernels of each): forward, dq, dk/dv
BF16_TRAIN_KERNELS = ("flash_attention_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90")
FP32_TRAIN_KERNELS = ("flash_attention_sm90_fp32", "flash_bwd_dq_sm90_fp32",
                      "flash_bwd_dkv_sm90_fp32")
FARM_LAYERS, FARM_SHARDS, FARM_INNER, FARM_BATCH = 8, 4, 2, 2
# Full-width training step, kernels vs plain versions (phase 7): |dloss|
# and, per parameter group, ||g_kernels - g_plain|| / ||g_plain||, in
# bf16 (the trained config) and in fp32 (the same config with fp32
# weights and activations, where only summation order differs).  bf16:
# from the first reading on an H100, |dloss| 5.4e-4 and a largest
# relative difference of 2.0e-2 (one-ulp flips of bf16 activations and
# gradients through 28 layers, the depth phase 7 ran then; see PERF.md).  fp32, from the first
# reading: |dloss| 0 and at most 5.3e-6, which shows the bf16 gap is
# rounding, not the kernels.
TRAIN_LIMITS = {torch.bfloat16: (1e-3, 3e-2), torch.float32: (1e-5, 1e-5)}
# Mamba path (phases 9-12): falcon-mamba-7b at full width and depth.
MAMBA_ARCH = "falcon_mamba_7b"
MAMBA_REQUESTS, MAMBA_NEW = 8, 32
MAMBA_TRAIN_LAYERS, MAMBA_TRAIN_BATCH = 8, 2
# Phase 15: the dense families beyond GQA at full width, one at a time.
# minicpm3-4b (MLA: flash at D=96, Dv=64 in prefill, an absorbed decode
# with no kernel) and phi-3-vision-4.2b (MHA at D=96, served text-only, as
# serve_requests builds tasks) serve FAMILY_REQUESTS prompts of PROMPT
# tokens, FAMILY_NEW new tokens; whisper-tiny serves as many prompts of
# WHISPER_PROMPT tokens, each task carrying seeded stub encoder frames
# (1,500 x 384), WHISPER_NEW new tokens.
FAMILIES = ("minicpm3_4b", "phi3_vision_4p2b", "whisper_tiny")
FAMILY_REQUESTS, FAMILY_NEW = 8, 32
WHISPER_PROMPT, WHISPER_NEW = 64, 64
PATCHES = 256  # phi-3's patch embeddings in its kernels-vs-plain prefill
FAMILY_BATCHES = 4
# Full-width logits of each family, kernels vs plain versions (phase 15):
# limits on the largest and the mean |difference| of each prefill's and
# decode step's logits, as phase 4's, from this script's first readings on
# an H100 over 4 batches (see PERF.md): minicpm3 (62 layers, prefill and
# one decode step) largest 8.30e-2 to 9.62e-2, mean 1.490e-2 to 1.529e-2;
# phi-3 (32 layers, prefill of 256 patches + 512 tokens and 4 decode
# steps) largest 8.52e-2 to 1.000e-1, mean 1.573e-2 to 1.693e-2; whisper
# (4 + 4 layers, prefill and one decode step) largest 1.022e-2 to
# 1.318e-2, mean 1.874e-3 to 2.147e-3.  Phase 17's MoE configs (2 layers,
# prefill and 4 decode steps): llama4 largest 3.04e-2 to 2.512e-1, mean
# 5.16e-3 to 1.522e-2; arctic largest 5.41e-2 to 7.84e-2, mean 8.47e-3 to
# 1.091e-2.  There a one-ulp bf16 flip in attention can flip a near-tied
# router choice (47 of 8,256 and 255 of 33,024 (token, choice) decisions
# differed), and llama4's largest gap, 2.512e-1, is a decode step where 1
# of its 4 decisions flipped.  The element checks of phase 2, not these
# limits, decide whether a kernel is right.
# Phase 19's jamba (8 layers: 1 attention, 7 Mamba, 4 MoE of 8 experts,
# top-2; prefill and 4 decode steps): limits set before its first run on
# the card from falcon-mamba's bf16 readings at 64 layers (largest 0.358,
# mean 0.055) and llama4's routing-flip spike (0.251), not fitted to a
# reading (see PERF.md).  The first run broke them with the routing free:
# 4.4-6.1% of a prefill's (token, choice) decisions differed between the
# paths and a decode step's largest gap read 1.265.  A flipped top-k
# choice changes that token's output by an expert's share; the Mamba
# layers carry it to every later token and MoE layer, where more choices
# flip.  The reference shows the same between its XLA and Pallas-interpret
# paths on the reduced jamba in bf16: 4.9-5.2% first flips, from 0.5-1.5%
# at the first MoE layer to 7-10% at the last, none in fp32
# (tests/test_torch_hybrid_routing.py).  So for the configs in PINNED the
# plain versions' top-k choices are pinned to the kernels' (RoutingPin;
# each path computes its own gates, and its own drops from the shared
# choices) and their logits are held to these limits there, while the
# share of (token, choice) pairs whose top-k choice the plain router makes
# otherwise is held to ROUTING_LIMITS over each batch's prefill and decode
# steps: "pinned", on the pinned path's inputs, where no flip compounds;
# "free", on the inputs of the plain path routing itself.  Both set before
# the run that first held them, "free" above the reference witness's 5.2%
# and the card's first 4.4-6.1% (which counted drops too); "pinned" three
# times the largest share llama4's or arctic's shallow stacks gave (1.03%),
# as jamba's pinned logits differ 3-4x more than theirs (largest 0.18-0.27
# against 0.04-0.07).
FAMILY_LIMITS = {"minicpm3_4b": (0.13, 0.019), "phi3_vision_4p2b": (0.14, 0.021),
                 "whisper_tiny": (0.018, 0.0027),
                 "llama4_maverick_400b_a17b": (0.34, 0.021), "arctic_480b": (0.11, 0.015),
                 "jamba_1p5_large_398b": (0.6, 0.06)}
PINNED = ("jamba_1p5_large_398b",)
ROUTING_LIMITS = {"free": 0.10, "pinned": 0.03}
# Phase 17: the MoE family at full width, served as phase 15 serves its
# families (FAMILY_REQUESTS prompts of PROMPT tokens, FAMILY_NEW new
# tokens), its depth cut to the whole pattern repeats one card holds:
# llama4-maverick one dense and one MoE block (128 experts of 3 x 5120 x
# 8192 bf16 weights, 32.2 GB a MoE layer), arctic two MoE blocks (26.8 GB
# each; a third would make 83.5 GB).  The reference's MoE is a dense
# one-hot dispatch: every expert is read on every call.
MOE_FAMILIES = ("llama4_maverick_400b_a17b", "arctic_480b")
MOE_LAYERS = {"llama4_maverick_400b_a17b": 2, "arctic_480b": 2}
# Phase 19: jamba-1.5-large-398b (hybrid) served as phase 17 serves the MoE
# family, at full width on one period of its pattern (8 of 72 layers:
# attention at position 0, Mamba at 1-7, MoE MLPs at the odd positions)
# with the expert count cut from 16 to JAMBA_EXPERTS: 25.91 B params,
# 51.8 GB in bf16 (16 experts: 45.24 B, 90.5 GB).  Every other field as
# published (top-2, capacity 1.25, routing groups of 256, the window).
JAMBA = "jamba_1p5_large_398b"
JAMBA_LAYERS, JAMBA_EXPERTS = 8, 8
# Long context on the card: one request of JAMBA_LONG_PROMPT tokens (twice
# the 2,048-token window) through prefill(long_context=True), then
# JAMBA_LONG_STEPS decode steps with long_context=True: the attention layer
# runs the plain windowed path (no kernel takes a window) and the Mamba
# layers the scan kernel.  Decode against a prefill of the longer prompt is
# held to the reference's serve-consistency limit
# (tests/test_serve_consistency.py, 2e-3) in fp32, where only summation
# order differs: the same period at full width with fp32 weights and
# activations and JAMBA_FP32_EXPERTS experts (45.6 GB; 8 would take 103.6),
# their capacity n_experts / top_k = 1.0 so that no routing group drops a
# token, as the reference test raises its capacity for (a group of 256 in a
# prefill may drop where a decode step's group of 1 never does).  The
# served bf16 model's decode-vs-prefill gap is printed beside it.
JAMBA_LONG_PROMPT, JAMBA_LONG_STEPS = 4096, 4
# The window bites when the long-context logits move away from the same
# attention without a window by more than BITES times the largest gap
# between the kernels and the plain versions held above (rounding).
BITES = 10
JAMBA_FP32_EXPERTS = 2
CONSISTENCY_TOL = 2e-3
# Phase 20: the D = 96 families in fp32, the fp32 flash kernels' path at
# (96, 64) (minicpm3's MLA) and (96, 96) (phi-3), at full width with the
# depth cut to TRAIN_LAYERS as phase 7 cuts qwen3.  One training step's loss
# and gradients, kernels vs plain versions, held to TRAIN_LIMITS[fp32]; a
# prefill and 4 decode steps of each of FP32_FAMILY_BATCHES batches held to
# CONSISTENCY_TOL (the reference's decode-logit tolerance) on the largest
# and the mean |logits difference|: in fp32 only summation order differs.
FP32_FAMILIES = ("minicpm3_4b", "phi3_vision_4p2b")
FP32_FAMILY_BATCHES = 2
# Phase 2's shapes: each path's attention calls as its serve run makes them.
# Flash: label -> (B, Sq, Skv, H, K, D, Dv, causal, dtypes), each also at a
# ragged Sq = 13 (and Skv = 13 where Skv = Sq).  Decode: label -> (B, H, K,
# D, cache slots, cache_index, dtypes), each also on a ragged 24-slot cache
# at cache_index 11, and on one request alone.
FLASH_SHAPES = {
    "qwen3": (PER_TASK, PROMPT, PROMPT, 16, 8, 128, 128, True,
              (torch.bfloat16, torch.float32)),
    # bf16: phases 15-16; fp32: phase 20
    "minicpm3 MLA": (PER_TASK, PROMPT, PROMPT, 40, 40, 96, 64, True,
                     (torch.bfloat16, torch.float32)),
    "phi-3": (PER_TASK, PROMPT, PROMPT, 32, 32, 96, 96, True,
              (torch.bfloat16, torch.float32)),
    "phi-3 with patches": (PER_TASK, PROMPT + PATCHES, PROMPT + PATCHES, 32, 32, 96, 96,
                           True, (torch.bfloat16, torch.float32)),
    "whisper encoder": (PER_TASK, 1500, 1500, 6, 6, 64, 64, False, (torch.bfloat16,)),
    "whisper cross": (PER_TASK, WHISPER_PROMPT, 1500, 6, 6, 64, 64, False,
                      (torch.bfloat16,)),
    "whisper self": (PER_TASK, WHISPER_PROMPT, WHISPER_PROMPT, 6, 6, 64, 64, True,
                     (torch.bfloat16,)),
    # the odd GQA groups of phase 17: one q-head a block (H/K odd)
    "llama4 G=5": (PER_TASK, PROMPT, PROMPT, 40, 8, 128, 128, True, (torch.bfloat16,)),
    "arctic G=7": (PER_TASK, PROMPT, PROMPT, 56, 8, 128, 128, True, (torch.bfloat16,)),
    # phase 19's jamba: G = 8, two q-heads a block
    "jamba G=8": (PER_TASK, PROMPT, PROMPT, 64, 8, 128, 128, True, (torch.bfloat16,)),
}
DECODE_SHAPES = {
    "qwen3": (PER_TASK, 16, 8, 128, PROMPT + NEW, PROMPT + 31,
              (torch.bfloat16, torch.float32)),
    "phi-3": (PER_TASK, 32, 32, 96, PROMPT + FAMILY_NEW, PROMPT + FAMILY_NEW - 1,
              (torch.bfloat16, torch.float32)),
    "whisper self": (PER_TASK, 6, 6, 64, WHISPER_PROMPT + WHISPER_NEW,
                     WHISPER_PROMPT + WHISPER_NEW - 1, (torch.bfloat16,)),
    # a kv-head's 5 or 7 q-heads in one block of 8, the rest masked
    "llama4 G=5": (PER_TASK, 40, 8, 128, PROMPT + FAMILY_NEW, PROMPT + FAMILY_NEW - 1,
                   (torch.bfloat16,)),
    "arctic G=7": (PER_TASK, 56, 8, 128, PROMPT + FAMILY_NEW, PROMPT + FAMILY_NEW - 1,
                   (torch.bfloat16,)),
    # jamba's 8 q-heads a kv-head fill the block of 8
    "jamba G=8": (PER_TASK, 64, 8, 128, PROMPT + FAMILY_NEW, PROMPT + FAMILY_NEW - 1,
                  (torch.bfloat16,)),
}
# the kernels line's phase-2 rows: (kind, label, dtypes), timed in the first
# dtype, the largest |error| over all of them
JSON_ROWS = {
    "flash": ("flash", "qwen3", (torch.bfloat16,)),
    "flash_fp32": ("flash", "qwen3", (torch.float32,)),
    "decode": ("decode", "qwen3", (torch.bfloat16, torch.float32)),
    "d96_dv64": ("flash", "minicpm3 MLA", (torch.bfloat16,)),
    "d96": ("flash", "phi-3", (torch.bfloat16,)),
    "decode_d96": ("decode", "phi-3", (torch.bfloat16, torch.float32)),
    "g5": ("flash", "llama4 G=5", (torch.bfloat16,)),
    "g7": ("flash", "arctic G=7", (torch.bfloat16,)),
    "decode_g5": ("decode", "llama4 G=5", (torch.bfloat16,)),
    "decode_g7": ("decode", "arctic G=7", (torch.bfloat16,)),
    "g8": ("flash", "jamba G=8", (torch.bfloat16,)),
    "decode_g8": ("decode", "jamba G=8", (torch.bfloat16,)),
    # phase 20's fp32 forward: minicpm3's prefill, phi-3's with patches
    "fp32_d96_dv64": ("flash", "minicpm3 MLA", (torch.float32,)),
    "fp32_d96": ("flash", "phi-3 with patches", (torch.float32,)),
}
# Phase 16: sync training of phase 15's families at full width, one at a
# time, FAMILY_TRAIN_BATCH sequences of TRAIN_SEQ tokens (phi-3: after
# PATCHES seeded patch embeddings; whisper: WHISPER_TRAIN_SEQ tokens, its
# published decoder context, beside 1,500 seeded encoder frames).
FAMILY_TRAIN_BATCH, WHISPER_TRAIN_SEQ = 4, 448
# One training step of each family, kernels vs plain versions (phase 16):
# limits on |dloss| and on the largest per-group relative gradient
# difference, as TRAIN_LIMITS for qwen3, from this script's first readings
# on an H100 (see PERF.md): minicpm3 |dloss| 7.25e-5, largest 1.112e-2
# (attn.wq_a); phi-3 5.34e-5, 1.581e-2 (embed.table); whisper 9.5e-7 (an
# fp32 ulp of the loss), 3.081e-2 (decoder.cross_attn.wk, whose gradient
# is small).  One-ulp flips of bf16 activations and gradients, as phase
# 7's; the element checks of phase 5 decide whether a kernel is right.
# Phase 18's MoE configs (2 layers, 32 experts, remat), the same readings
# in two runs: llama4 |dloss| 1.140e-3, largest 1.103e-1 (moe.router; the
# expert stacks 8.1e-2), 6 of 2,048 (token, choice) routing decisions
# flipped; arctic 8.168e-4, 3.321e-2 (moe.experts.wg), 11 of 8,192.  A
# token routed to another expert moves that expert's gradient and the
# router's by far more than rounding, so these limits are looser than the
# dense families'.
FAMILY_TRAIN_LIMITS = {"minicpm3_4b": (2e-4, 2e-2), "phi3_vision_4p2b": (2e-4, 3e-2),
                       "whisper_tiny": (1e-5, 5e-2),
                       "llama4_maverick_400b_a17b": (3e-3, 0.25), "arctic_480b": (2e-3, 0.1)}
# Phase 18: the MoE family trained at full width on phase 17's depth with
# the expert count cut from 128 to MOE_TRAIN_EXPERTS: at 128 one MoE layer's
# weights, gradients and moments alone take 128.8 GB (llama4, bf16 moments)
# and 81.1 GB (arctic, int8 moments).  Every other MoE field is kept
# (top_k, capacity_factor, group_size 256, dense_residual), so a 512-token
# sequence is two routing groups with 10 (top-1) or 20 (top-2) slots an
# expert.  The configs' own remat=True and moment dtypes.  remat=False's
# gradients must equal remat=True's within REMAT_GRAD_TOL of each
# parameter's gradient norm, where they are not bit-identical.
MOE_TRAIN_EXPERTS = 32
REMAT_GRAD_TOL = 1e-6
# Phase 5's shapes: each training path's attention backward as its step
# makes it (phases 6, 16 and 18): label -> (B, Sq, Skv, H, K, D, Dv, causal,
# dtypes), each also at a ragged Sq = 13 (and Skv = 13 where Skv = Sq).
BWD_SHAPES = {
    "qwen3": (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 8, 128, 128, True,
              (torch.bfloat16, torch.float32)),
    # bf16: phase 16; fp32: phase 20
    "minicpm3 MLA": (FAMILY_TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 40, 40, 96, 64, True,
                     (torch.bfloat16, torch.float32)),
    "phi-3": (FAMILY_TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 32, 96, 96, True,
              (torch.bfloat16, torch.float32)),
    "phi-3 with patches": (FAMILY_TRAIN_BATCH, TRAIN_SEQ + PATCHES, TRAIN_SEQ + PATCHES, 32,
                           32, 96, 96, True, (torch.bfloat16, torch.float32)),
    "whisper encoder": (FAMILY_TRAIN_BATCH, 1500, 1500, 6, 6, 64, 64, False,
                        (torch.bfloat16,)),
    "whisper cross": (FAMILY_TRAIN_BATCH, WHISPER_TRAIN_SEQ, 1500, 6, 6, 64, 64, False,
                      (torch.bfloat16,)),
    "whisper self": (FAMILY_TRAIN_BATCH, WHISPER_TRAIN_SEQ, WHISPER_TRAIN_SEQ, 6, 6, 64, 64,
                     True, (torch.bfloat16,)),
    # phase 18's odd GQA groups: one q-head a dq block; at the ragged Sq =
    # 13 an odd number of dk/dv steps (1 query tile x 5 or 7 q-heads)
    "llama4 G=5": (FAMILY_TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 40, 8, 128, 128, True,
                   (torch.bfloat16,)),
    "arctic G=7": (FAMILY_TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 56, 8, 128, 128, True,
                   (torch.bfloat16,)),
}
# Farm over worker processes (phase 13): 2 workers; the kill round's
# victim is worker 0, the shm round serves the first SHM_REQUESTS prompts
WORKERS, SHM_REQUESTS = 2, 8
# Scan kernel vs plain chunked scan, element by element (phase 9):
# |got - ref| <= SCAN_TOL + SCAN_TOL |ref|, the reference suite's own scan
# tolerance (tests/test_kernels_mamba.py).  Both sides compute in fp32; the
# kernel steps through time, the plain version scans log-depth inside
# chunks of 256, so they differ in rounding only.
SCAN_TOL = 1e-4
# Full-width falcon-mamba logits, kernels vs plain versions (phase 11),
# limits on the largest and the mean |difference| of each batch's logits,
# from this script's readings on an H100 (see PERF.md).  bf16 (the served
# weights): largest 0.289 to 0.358, mean 0.0512 to 0.0551 over 4 batches,
# prefill and decode, in three runs.  The scan's fp32 outputs differ from the
# plain version's by ~1e-5, which flips the bf16 rounding of a few elements
# of each layer's output, and 64 layers of random weights amplify the flips
# (on the CPU, a deep bf16 model whose plain scan only changes summation
# order moves its logits far more at 64 layers than at 8).  fp32 (fresh
# fp32 weights, same config), where only summation order differs: largest
# 7.5e-5 to 9.9e-5, mean 1.3e-5 to 1.6e-5, which shows the bf16 gap is
# rounding, not the kernel.
MAMBA_FULL_WIDTH_BATCHES = 4
MAMBA_FULL_WIDTH_LIMITS = {torch.bfloat16: (0.45, 0.07), torch.float32: (2e-4, 3e-5)}
# Phase 21: model programs under Service.execute_batch: BATCH_TASKS tasks of
# PER_TASK requests as one torch.func.vmap call of the program, each kernel
# entry folded by its vmap rule (repro_torch/kernels/batched.py) into the
# kernel's batch axis, so that a batched call launches each kernel as often
# as one task does.  qwen3-1.7B at full size (bf16, 28 layers, PROMPT-token
# prompts, NEW new tokens) through the generate program: one execute_batch
# and the same tasks one at a time on one Service, timed and profiled
# (BATCH_TIMED_NEW decode steps a timed round); then BATCH_FARM_TASKS tasks
# through BasicClient on SERVICES services at max_batch 4 and at 1, with
# BATCH_FARM_NEW new tokens, qwen3 cut to TRAIN_LAYERS layers for that
# reading (its one-at-a-time run, host-bound, is the phase's longest part).  Then each model of BATCH_MODELS, (arch, layers (None: full
# depth), dtype, (largest, mean) |logits difference| limits), per task
# against batched on the same prompts, the same tokens fed to both: a
# prefill and BATCH_STEPS decode steps.  The bf16 limits were set before
# the phase first ran, from the kernels-vs-plain limits of the same configs
# (phases 4, 11, 15, 17) at their full depth: a batched GEMM has M = N B S
# rows against B S, so cuBLAS may choose another algorithm and round
# otherwise, and decode's KV split count changes with the folded batch:
# one-ulp flips amplified by depth, as there; qwen3's a third above phase
# 4's, for the split count.  fp32 (qwen3 cut to TRAIN_LAYERS): the
# reference's decode-logit tolerance, where only summation order differs,
# the witness that the bf16 gaps are rounding.  An MoE model's batched
# top-k choices are pinned to its per-task run's (each path computes its own
# gates and capacity drops), and the share of choices its own router makes
# otherwise is held to ROUTING_LIMITS["pinned"], as phase 19 holds jamba's.
BATCH_TASKS, BATCH_STEPS, BATCH_TIMED_NEW = 4, 4, 16
BATCH_FARM_TASKS, BATCH_FARM_NEW = 16, 16
BATCH_MODELS = (
    ("qwen3_1p7b", TRAIN_LAYERS, torch.float32, (CONSISTENCY_TOL, CONSISTENCY_TOL)),
    ("falcon_mamba_7b", TRAIN_LAYERS, torch.bfloat16,
     MAMBA_FULL_WIDTH_LIMITS[torch.bfloat16]),
    ("minicpm3_4b", TRAIN_LAYERS, torch.bfloat16, FAMILY_LIMITS["minicpm3_4b"]),
    ("llama4_maverick_400b_a17b", MOE_LAYERS["llama4_maverick_400b_a17b"], torch.bfloat16,
     FAMILY_LIMITS["llama4_maverick_400b_a17b"]),
)
BATCH_QWEN3_LIMITS = (0.12, 0.016)
# Phase 21's direct check of each folded launch against BATCH_TASKS per-task
# launches of the same kernel at phase 2's shapes: the flash forward and the
# scan bit-identical (a block's work depends on its own batch row only),
# decode within the reference's decode tolerance, |got - ref| <= tol + tol
# |ref| (folding changes B, so the KV split count and the merge order).
BATCH_DECODE_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# the scan's exponentials run on the multi-function unit: 16 a clock per SM
# (NVIDIA's CUDA C++ programming guide, arithmetic instruction throughput,
# compute capability 9.0); the card has 132 SMs
MUFU_PER_CLOCK_SM, SMS = 16, 132
SCAN_FLOP_PER_ELEMENT = 6  # dt*A, h*dA, dx*B, +, C*h, + per (b, s, d, n)
# Phase 24: the local-SGD round of each configuration, at full width, its
# tasks as one execute_batch and one at a time: (arch, layers, dtype,
# tasks, experts (None: as published), limits on |dloss| and on the
# largest per-group relative gradient difference).  The limits are the
# training ones already held: phase 7's TRAIN_LIMITS in bf16 and fp32
# (folding makes every GEMM a batched GEMM, whose one-ulp flips depth
# carries as in phase 7's kernels-vs-plain step), and llama4's phase 18
# FAMILY_TRAIN_LIMITS, whose routing can flip with those ulps.  The loss
# limit holds each task's round loss and the loss a held-out batch scores
# after its batched delta against after its per-task one; the gradient
# limit holds one inner step's gradients.  The deltas themselves are
# read, not held to the gradient limit: AdamW divides each element by its
# own gradient scale, so an element's last-bit gradient difference
# becomes a difference of its update, and a bf16 weight rounds an update
# of ~2.5 of its ulps, so a last-bit change flips that rounding (this
# script's readings on an H100 for qwen3: 5.0e-2 per group in bf16 where
# the gradients differ by 1.2e-2, 6.3e-5 in fp32, the losses
# bit-identical; see PERF.md).  qwen3-1.7B's 4 tasks are phase 8's round (FARM_LAYERS,
# FARM_SHARDS, FARM_INNER, FARM_BATCH x TRAIN_SEQ): a task holds its
# stacked payload, a working copy, gradients and AdamW moments (3 x 2 +
# 8 = 14 B a parameter in bf16 with fp32 moments, an fp32 delta after
# the moments are freed), 10 GB a task at 0.714 B parameters.  llama4's
# two tasks need its experts cut from phase 18's 32 to
# BATCH_TRAIN_EXPERTS: its untied 202,048 x 5,120 embedding and head are
# 2.07 B parameters before any expert, 10 B a parameter a task (bf16
# moments) beside the client's weights and each task's fp32 loss table and
# its gradient (8.3 GB a task), so 2 experts (2.72 B parameters) reckon
# ~69 GB, where phase 18 read 55.21 GB for one task at 32.
BATCH_TRAIN_EXPERTS = 2
BATCH_TRAIN = (
    ("qwen3_1p7b", FARM_LAYERS, torch.bfloat16, FARM_SHARDS, None, TRAIN_LIMITS[torch.bfloat16]),
    ("qwen3_1p7b", 2, torch.float32, 2, None, TRAIN_LIMITS[torch.float32]),
    ("falcon_mamba_7b", 2, torch.bfloat16, 2, None, TRAIN_LIMITS[torch.bfloat16]),
    ("llama4_maverick_400b_a17b", 2, torch.bfloat16, 2, BATCH_TRAIN_EXPERTS,
     FAMILY_TRAIN_LIMITS["llama4_maverick_400b_a17b"]),
)
# the scan with one A a batch row: falcon-mamba's serve shape and a ragged s
BATCH_SCAN_SHAPES = ((PER_TASK, PROMPT, 8192, 16), (3, 333, 8192, 16))
# Phase 23: the autotuner (repro_torch.tune) on the card.  Its sweeps run
# at the main paths' shapes: the bf16 flash forward's tiles at qwen3's
# prefill (G = 2: two q-heads a block) and llama4's (G = 5: one); decode's
# KV splits at qwen3's (B = 4 and B = 1, a 576-slot cache); the scan's
# lanes a channel and the plain scan's chunk (its forward and backward) at
# falcon-mamba's (b = 4, s = 512, d = 8192, n = 16); the backward pairs'
# four tiles at qwen3's training shape (bf16 and fp32) and minicpm3's MLA
# (bf16: H = K = 40, (D, Dv) = (96, 64)); the fp32 forward's tiles at
# qwen3's and minicpm3's.  label -> (family, backend, dtype, shape).  Each sweep is a KernelTuner over a farm of one
# in-process service on the card: candidates timed at once on one card
# would time each other.  Its winner and the default are then re-timed
# one after the other, TUNE_RETIMES times each in turns, and the winner's
# median must be no slower than the default's plus the larger spread
# (largest minus smallest) of the two: today's tiles were picked by hand
# for this card, so "no slower" is the bar, not a speedup.
TUNE_SWEEPS = {
    "flash qwen3 G=2": ("flash_fwd", "cuda", "bfloat16",
                        {"B": PER_TASK, "Sq": PROMPT, "Skv": PROMPT, "H": 16, "K": 8,
                         "D": 128, "Dv": 128}),
    "flash llama4 G=5": ("flash_fwd", "cuda", "bfloat16",
                         {"B": PER_TASK, "Sq": PROMPT, "Skv": PROMPT, "H": 40, "K": 8,
                          "D": 128, "Dv": 128}),
    "decode qwen3 B=4": ("decode", "cuda", "bfloat16",
                         {"B": PER_TASK, "S": PROMPT + NEW, "H": 16, "K": 8, "D": 128,
                          "Dv": 128}),
    "decode qwen3 B=1": ("decode", "cuda", "bfloat16",
                         {"B": 1, "S": PROMPT + NEW, "H": 16, "K": 8, "D": 128, "Dv": 128}),
    "scan lanes falcon-mamba": ("mamba", "cuda", "float32",
                                {"b": PER_TASK, "s": PROMPT, "d": 8192, "n": 16}),
    "scan chunk falcon-mamba": ("mamba", "torch", "float32",
                                {"b": PER_TASK, "s": PROMPT, "d": 8192, "n": 16}),
    "bf16 pair qwen3": ("flash_bwd", "cuda", "bfloat16",
                        {"B": PER_TASK, "Sq": PROMPT, "Skv": PROMPT, "H": 16, "K": 8,
                         "D": 128, "Dv": 128}),
    "bf16 pair minicpm3": ("flash_bwd", "cuda", "bfloat16",
                           {"B": PER_TASK, "Sq": PROMPT, "Skv": PROMPT, "H": 40, "K": 40,
                            "D": 96, "Dv": 64}),
    "fp32 pair qwen3": ("flash_bwd", "cuda", "float32",
                        {"B": PER_TASK, "Sq": PROMPT, "Skv": PROMPT, "H": 16, "K": 8,
                         "D": 128, "Dv": 128}),
    "fp32 flash qwen3": ("flash_fwd", "cuda", "float32",
                         {"B": PER_TASK, "Sq": PROMPT, "Skv": PROMPT, "H": 16, "K": 8,
                          "D": 128, "Dv": 128}),
    "fp32 flash minicpm3": ("flash_fwd", "cuda", "float32",
                            {"B": PER_TASK, "Sq": PROMPT, "Skv": PROMPT, "H": 40, "K": 40,
                             "D": 96, "Dv": 64}),
}
TUNE_RETIMES = 5
# Ragged shapes every flash candidate also runs at (besides its sweep
# shape): a second row warpgroup whose rows run past Sq, a 128-key tile
# past Skv, non-causal.  (B, Sq, Skv, causal)
TUNE_RAGGED_FLASH = ((2, 13, 13, True), (2, 200, 200, True), (1, 130, 70, False))
# and every backward candidate (rows past Sq, a 128-key block past Skv,
# non-causal with Sq > Skv)
TUNE_RAGGED_BWD = ((2, 13, 13, True), (1, 200, 200, True), (1, 130, 70, False))
# A cache-hit probe of the tuning cache, as a wrapper pays it, may cost at
# most this share of phase 2's host time of a wrapper call (the
# reference's dispatch-overhead gate, benchmarks/autotune.py).
TUNE_PROBE_SHARE = 0.03
# qwen3-1.7B served through ``launch/serve.py --tune-cache`` at full width
# with its depth cut to TUNE_SERVE_LAYERS (the serve's launches and tokens
# do not depend on depth beyond counts; phase 3 served all 28 layers):
# TUNE_SERVE_NEW new tokens for REQUESTS prompts; then prefill and one
# decode step through the tuned dispatch against the untuned kernels,
# |logits difference| held to phase 4's limits on TUNE_LOGIT_BATCHES
# batches.
TUNE_SERVE_LAYERS, TUNE_SERVE_NEW, TUNE_LOGIT_BATCHES = 4, 8, 2
TUNE_PHASE_LIMIT_S = 90
# the kernels line's tunable launch parameters of each kernel, the values
# its tuning space takes (repro_torch/tune/space.py); fixed tiles take none
TUNABLE_KNOBS = {"flash_attention_sm90": {"block_q": [64, 128], "block_k": [64, 128]},
                 "flash_attention_sm90_fp32": {"block_q": [64, 128], "block_k": [16, 32, 64]},
                 "flash_bwd_dq_sm90": {"dq_block_q": [64, 128], "dq_block_k": [64, 128]},
                 "flash_bwd_dkv_sm90": {"dkv_block_k": [64, 128], "dkv_block_q": [16, 32, 64]},
                 "flash_bwd_dq_sm90_fp32": {"dq_block_q": [64], "dq_block_k": [16, 32, 64]},
                 "flash_bwd_dkv_sm90_fp32": {"dkv_block_k": [64], "dkv_block_q": [8, 16, 32]},
                 "decode_attention_sm90": {"splits": [1, 2, 4, 8]},
                 "mamba_scan_sm90": {"lanes": [1, 2, 4]}}
# the (D, Dv) pairs the bf16 and fp32 attention kernels take
HEAD_PAIRS = ((32, 32), (64, 64), (96, 96), (96, 64), (128, 128))


START = time.perf_counter()


def phase(title):
    """A phase's title line, with the seconds since the script started."""
    say(f"{title} [{time.perf_counter() - START:.1f} s into the run]")


def say(*a):
    print(*a, flush=True)


def free(services):
    """Release a finished phase's device memory: the services' cached
    programs (their closures hold weights), then whatever the collector
    finds (a trainer and its programs hold each other), then the
    allocator's cache."""
    for svc in services:
        svc.drop_programs()
    gc.collect()
    torch.cuda.empty_cache()


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=10, reps=5, stream=None) -> float:
    """Device ms of one call of ``fn``: ``iters`` calls captured in a CUDA
    graph on ``stream`` (a new one by default), replayed ``reps`` times
    between CUDA events.  What each call costs the host (Python, checks,
    allocation, the launch) is left out: the kernels' wrappers take ~30 us
    of host time a call, so back-to-back calls of a faster kernel would
    time the host, not the card."""
    stream = stream or torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
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
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


def randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def check(name, got, ref, rtol, atol=ATOL) -> float:
    """Holds ``got`` to ``ref`` element by element; returns the largest
    absolute difference."""
    diff = (got.float() - ref.float()).abs()
    lim = atol + rtol * ref.float().abs()
    err = diff.max().item()
    worst = (diff / lim).max().item()
    say(f"  {name}: max_abs_err {err:.3e}, largest |err| / ({atol:g} + "
        f"{rtol:g} |ref|) {worst:.3f} (limit 1)")
    if not worst <= 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def ptxas_records(log):
    """{short name: (registers, spill store bytes, spill line, static
    shared memory note)} of every kernel instantiation in one ``ptxas -v``
    log, under the short names ``say_registers`` prints."""
    records, name, spill = {}, None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function .*?([a-z][a-z_]*(?:_sm90)?_kernel)I"
                      r"(13__nv_bfloat16|f)((?:Li\d+E)+)", line)
        d = re.search(r"Compiling entry function .*?([a-z_]+(?:_sm90)?(?:_fp32)?_kernel)"
                      r"I((?:Li\d+E)+)", line)
        if m:
            dtype = "bf16" if m.group(2) != "f" else "f32"
            name = f"{m.group(1)}<{', '.join([dtype] + re.findall(r'Li(\d+)E', m.group(3)))}>"
        elif d:
            name = f"{d.group(1)}<{', '.join(re.findall(r'Li(\d+)E', d.group(2)))}>"
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            stores = re.search(r"(\d+) bytes spill stores", spill)
            records[name] = (regs, int(stores.group(1)) if stores else 0, spill,
                             f"; {smem.group(1)} bytes static shared memory" if smem else "")
            name = None
    return records


def say_registers(log):
    """One line per kernel instantiation from ``ptxas -v``: registers,
    spills and static shared memory, under a short name such as
    ``decode_sm90_kernel<bf16, 128, 2>`` (dtype, then the integer template
    arguments) or ``scan_sm90_kernel<1, 16>`` (``ptxas_records``)."""
    for name, (regs, _, spill, smem) in ptxas_records(log).items():
        say(f"  {name}: {regs} registers; {spill}{smem}")


def say_sass(kern, ops=("HGMMA", "UTMALDG")):
    """Counts ``ops`` in the SASS of ``kern``'s library (``cuobjdump``,
    shipped with the toolkit beside ``nvcc``); fails if any is absent."""
    from repro_torch.kernels.build import find_nvcc

    cuobjdump = Path(find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(kern.library_path())],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}
    say(f"  {kern.source.name} SASS: " + ", ".join(f"{n} {op}" for op, n in counts.items()))
    if not all(counts.values()):
        raise AssertionError(f"{kern.source.name}: no {' or '.join(ops)} in its SASS")


def kernel_entry(kern, suffix, nargs):
    """A plain-int entry ``<symbol><suffix>`` of ``kern``'s library."""
    fn = getattr(ctypes.CDLL(str(kern.library_path())), kern.symbol + suffix)
    fn.argtypes, fn.restype = [ctypes.c_int] * nargs, ctypes.c_int
    return fn


def say_async_smem(decode, scan):
    """The dynamic shared memory a block of the decode kernel (its K/V
    ring, by head dim and dtype) and of the scan (its tile ring, by state
    size) takes."""
    ring = kernel_entry(decode.KERNEL, "_smem", 2)
    say(f"  {decode.KERNEL.source.name} K/V ring a block: " + ", ".join(
        f"D={d} {name} {ring(d, code):,} B" for d in (32, 64, 96, 128)
        for name, code in (("f32", 0), ("bf16", 1))))
    tiles = kernel_entry(scan.KERNEL, "_smem", 2)
    say(f"  {scan.KERNEL.source.name} tile ring a block (the untuned lanes): " + ", ".join(
        f"n={n} {tiles(n, 0):,} B" for n in (4, 8, 16, 32)))


# the libraries whose register rules (each source's REG_BASE, mirrored by
# repro_torch/tune/space.py) phase 1's register probe reports on
PROBED_SOURCES = ("flash_attention_sm90_fp32.cu", "flash_bwd_dq_sm90.cu", "flash_bwd_dkv_sm90.cu",
                  "flash_bwd_dq_sm90_fp32.cu", "flash_bwd_dkv_sm90_fp32.cu")


def start_register_probe():
    """Phase 1's register probe: copies the kernels' sources under
    ``build/register_probe/``, lowers REG_BASE in the fp32 forward and both
    pairs so far that each ``admits`` reduces to its shared-memory bound,
    and starts one ``nvcc`` a library (the package's flags), beside the
    real build.  Returns {source: process}."""
    from repro_torch.kernels.build import CSRC, NVCC_FLAGS, find_nvcc

    out = ROOT / "build" / "register_probe"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(CSRC, out)
    procs = {}
    for name in PROBED_SOURCES:
        src = out / name
        text, n = re.subn(r"constexpr int REG_BASE = \d+;", "constexpr int REG_BASE = -1000;",
                          src.read_text())
        if n != 1:
            raise AssertionError(f"{name}: no REG_BASE to lower")
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-I", str(out), "-o", str(src.with_suffix(".so")),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return procs


def say_register_probe(procs, logs):
    """Prints the register probe's ptxas report: registers and spill
    stores of every instantiation the shared-memory bounds admit, each
    marked built (the real libraries' ``logs`` hold it: the register rule
    admits it) or refused by the rule; what the rules are written from.
    Fails if the probe does not compile."""
    built = {}
    for log in logs.values():
        built.update(ptxas_records(log))
    counts = {"built": 0, "refused": 0, "refused, spills": 0}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise AssertionError(f"register probe of {name}: nvcc failed\n{log[-4000:]}")
        for inst, (regs, stores, _, _) in ptxas_records(log).items():
            what = "built" if inst in built else "refused, spills" if stores else "refused"
            counts[what] += 1
            say(f"  register probe {inst}: {regs} registers, {stores} bytes spill stores "
                f"({what})")
    say(f"  register probe: {sum(counts.values())} instantiations within a block's shared "
        f"memory, {counts['built']} built, {counts['refused, spills']} refused that spill, "
        f"{counts['refused']} refused that would not")


def tile_smem_queries(flash):
    """Every shared-memory query of the five kernels whose tiles phase 23
    adds (the fp32 forward, the bf16 and fp32 pairs), at every (D, Dv),
    q-heads a block (the bf16 dq) and tile of their spaces, against the
    space's figure: ``smem_bytes`` (``bwd_smem_bytes``' part) where the
    space's rule builds the instantiation, -1 where it does not.  Prints a
    line a library, its built instantiations' bytes; raises on a
    mismatch."""
    import itertools

    from repro_torch.tune import space

    rows = {}  # library -> [(label, bytes)]
    bad = []

    def held(kern, label, got, want):
        if got != want:
            bad.append(f"{kern.source.name} {label}: the library's {got}, the space's {want}")
        elif got >= 0:
            rows.setdefault(kern.source.name, []).append((label, got))

    fwd = kernel_entry(flash.SM90_FP32_KERNEL, "_smem", 4)
    bf_dq, bf_dkv = kernel_entry(flash.DQ_SM90_KERNEL, "_smem", 5), kernel_entry(
        flash.DKV_SM90_KERNEL, "_smem", 4)
    f_dq, f_dkv = kernel_entry(flash.DQ_SM90_FP32_KERNEL, "_smem", 4), kernel_entry(
        flash.DKV_SM90_FP32_KERNEL, "_smem", 4)
    for D, Dv in HEAD_PAIRS:
        for bq, bk in itertools.product((64, 128), (16, 32, 64)):
            cfg, shape = {"block_q": bq, "block_k": bk}, {"H": 1, "K": 1, "D": D, "Dv": Dv}
            want = (space.smem_bytes("flash_fwd", shape, cfg, "float32")
                    if space.instantiated("flash_fwd", shape, cfg, "float32") else -1)
            held(flash.SM90_FP32_KERNEL, f"({D}, {Dv}) {bq}x{bk}", fwd(D, Dv, bq, bk), want)
        for dt, (dq_fn, dkv_fn) in (("bfloat16", (bf_dq, bf_dkv)), ("float32", (f_dq, f_dkv))):
            tiles, base = space._BWD_TILES[dt], space.default_config("flash_bwd", "cuda", dt)
            kern_dq, kern_dkv = flash.backward_kernels(getattr(torch, dt))
            for heads in ((1, 2) if dt == "bfloat16" else (1,)):
                shape = {"H": heads, "K": 1, "D": D, "Dv": Dv}
                for a, b in itertools.product(tiles["dq_block_q"], tiles["dq_block_k"]):
                    cfg = dict(base, dq_block_q=a, dq_block_k=b)
                    want = (space.bwd_smem_bytes(shape, cfg, dt)["dq"]
                            if space.instantiated("flash_bwd", shape, cfg, dt, "dq") else -1)
                    got = dq_fn(D, Dv, heads, a, b) if dt == "bfloat16" else dq_fn(D, Dv, a, b)
                    held(kern_dq, f"({D}, {Dv}) x{heads} {a}x{b}", got, want)
            shape = {"H": 1, "K": 1, "D": D, "Dv": Dv}
            for a, b in itertools.product(tiles["dkv_block_k"], tiles["dkv_block_q"]):
                cfg = dict(base, dkv_block_k=a, dkv_block_q=b)
                want = (space.bwd_smem_bytes(shape, cfg, dt)["dkv"]
                        if space.instantiated("flash_bwd", shape, cfg, dt, "dkv") else -1)
                held(kern_dkv, f"({D}, {Dv}) {a}x{b}", dkv_fn(D, Dv, a, b), want)
    for lib, built in rows.items():
        say(f"  {lib} shared memory a block, each instantiation built (the space's "
            f"smem_bytes; the others refused by both): " + ", ".join(
                f"{label} {b:,} B" for label, b in built) + " (at most 232,448 B)")
    if bad:
        raise AssertionError("shared-memory queries disagree with the space: " + "; ".join(bad))


def fmt_ms(ms) -> str:
    return "none ran" if ms is None else f"{ms:.4f} ms"


def sdpa_backends():
    from torch.nn.attention import SDPBackend

    return (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
            SDPBackend.CUDNN_ATTENTION)


def sdpa_heads(q, k, v):
    """(B,S,heads,D) -> SDPA's (B,H,S,D) views, K and V expanded to q's H
    heads (copied here, outside any timed region)."""
    G = q.shape[2] // k.shape[2]
    return tuple(t.transpose(1, 2) for t in (q, k.repeat_interleave(G, 2),
                                              v.repeat_interleave(G, 2)))


def sdpa_library_ms(q, k, v, **kw):
    """One SDPA forward on (B,S,heads,D) inputs, graph-timed under each
    backend that takes them: (fastest ms, its backend's name), or (None,
    None)."""
    from torch.nn.attention import sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    qT, kT, vT = sdpa_heads(q, k, v)
    best = (None, None)
    for backend in sdpa_backends():
        with warnings.catch_warnings(), sdpa_kernel(backend):
            warnings.simplefilter("ignore")
            try:
                sdpa(qT, kT, vT, **kw)
            except (RuntimeError, ValueError):  # the backend does not take these inputs
                continue
            ms = graph_ms(lambda: sdpa(qT, kT, vT, **kw))
        say(f"    SDPA {backend.name} {str(q.dtype)[6:]}: {ms:.4f} ms")
        if best[0] is None or ms < best[0]:
            best = (ms, backend.name)
    return best


def sdpa_backward_ms(q, k, v, g, causal=True):
    """SDPA's backward alone on (B,S,heads,D) inputs: one forward with
    grad-enabled inputs under each backend that takes them, then
    ``autograd.grad`` graph-timed (the forward runs on the capture stream,
    where autograd puts its backward); (fastest ms, its backend's name), or
    (None, None)."""
    from torch.nn.attention import sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    leaves = tuple(t.detach().requires_grad_() for t in sdpa_heads(q, k, v))
    gT = g.transpose(1, 2)
    best = (None, None)
    for backend in sdpa_backends():
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with warnings.catch_warnings(), sdpa_kernel(backend):
            warnings.simplefilter("ignore")
            try:
                with torch.cuda.stream(stream):
                    o = sdpa(*leaves, is_causal=causal)
                    torch.autograd.grad(o, leaves, gT, retain_graph=True)
            except (RuntimeError, ValueError):  # the backend does not take these inputs
                continue
            ms = graph_ms(lambda: torch.autograd.grad(o, leaves, gT, retain_graph=True),
                          stream=stream)
        say(f"    SDPA {backend.name} backward: {ms:.4f} ms")
        if best[0] is None or ms < best[0]:
            best = (ms, backend.name)
    return best


def describe_us(flash, q, k, v, reps=2000) -> float:
    """Host microseconds to make the bf16 flash kernel's three TMA
    descriptors for one call (the library's describe entry, no launch)."""
    lib = ctypes.CDLL(str(flash.SM90_KERNEL.library_path()))
    fn = lib.repro_flash_sm90_describe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
    fn.restype = ctypes.c_int
    B, Sq, H, D = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), B, Sq, k.shape[1], H,
            k.shape[2], D, v.shape[3])
    t0 = time.perf_counter()
    err = fn(*args, reps)
    us = (time.perf_counter() - t0) / reps * 1e6
    if err:
        raise AssertionError(f"repro_flash_sm90_describe failed: CUDA error {err}")
    return us


def host_us(fn, calls=50) -> float:
    """Host microseconds per call of ``fn``, enqueued back to back (fewer
    than the launch queue holds), the card not waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def bound(flops, nbytes, dtype):
    """(bound_ms, bound_by) of an attention function whose matrix products
    are ``flops``: the larger of bytes over the memory rate and operations
    over the peak rate for the inputs' type, fp32 as TF32_TERMS tf32
    products at the TF32 peak."""
    if dtype == torch.float32:
        flops, flop_s = TF32_TERMS * flops, PEAK_TF32_FLOP_S
    else:
        flop_s = PEAK_FLOP_S[dtype]
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / flop_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def causal_pairs(B, H, Sq, Skv) -> int:
    """Visible (q, k) pairs under the top-left causal mask."""
    return B * H * sum(min(i + 1, Skv) for i in range(Sq))


def kernel_phase(flash, decode):
    """Phase 2: each kernel against its plain version on the same inputs at
    every shape of FLASH_SHAPES and DECODE_SHAPES (serve and ragged), then
    each timed at its serve shape, graph-replayed, beside its bound and
    SDPA's fastest backend.  Returns {row of JSON_ROWS: its times, bound,
    library time and largest |error| ("err")}."""
    errs, timed = {}, {}
    for label, (B, sq, skv, H, K, D, Dv, causal, dtypes) in FLASH_SHAPES.items():
        for dt in dtypes:
            kern = flash.forward_kernel(dt)
            for size, q_len, kv_len in (("serve", sq, skv),
                                        ("ragged", 13, 13 if skv == sq else skv)):
                q = randn((B, q_len, H, D), dt, 1)
                k = randn((B, kv_len, K, D), dt, 2)
                v = randn((B, kv_len, K, Dv), dt, 3)
                before = kern.launches
                out, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
                if kern.launches != before + 1:
                    raise AssertionError(f"flash {label} {str(dt)[6:]} did not launch "
                                         f"{kern.name}")
                ref, ref_lse = flash.flash_attention_plain(q, k, v, causal=causal)
                tag = f"flash ({kern.name}) {label} {size} {str(dt)[6:]} Sq={q_len} Skv={kv_len}"
                key = ("flash", label, dt)
                errs[key] = max(errs.get(key, 0.0), check(tag + " out", out, ref, RTOL[dt]),
                                check(tag + " lse", lse, ref_lse, 0.0))
                if size == "serve":
                    timed[key] = (q, k, v, causal)
    for label, (B, H, K, D, slots, ci, dtypes) in DECODE_SHAPES.items():
        for dt in dtypes:
            for size, s_cache, c in (("serve", slots, ci), ("ragged", 24, 11)):
                qd = randn((B, 1, H, D), dt, 4)
                kc = randn((B, s_cache, K, D), dt, 5)
                vc = randn((B, s_cache, K, D), dt, 6)
                key = ("decode", label, dt)
                for b in (B, 1) if size == "serve" else (B,):
                    before = decode.KERNEL.launches
                    got = decode.decode_attention_fwd(qd[:b], kc[:b], vc[:b], cache_index=c)
                    if decode.KERNEL.launches != before + 1:
                        raise AssertionError(f"decode {label} did not launch its kernel")
                    ref = decode.decode_attention_plain(qd[:b], kc[:b], vc[:b], cache_index=c)
                    errs[key] = max(errs.get(key, 0.0), check(
                        f"decode {label} {size} {str(dt)[6:]} B={b} H={H} K={K} D={D} "
                        f"S={s_cache} cache_index={c}", got, ref, RTOL[dt]))
                if size == "serve" and dt == torch.bfloat16:
                    timed[key] = (qd, kc, vc, ci)
    torch.cuda.synchronize()

    rows = {}
    for (kind, label, dt), inputs in timed.items():
        if kind == "flash":
            rows[(kind, label, dt)] = flash_times(flash, label, *inputs)
        else:
            rows[(kind, label, dt)] = decode_times(decode, label, *inputs)
    q, k, v, _ = timed[("flash", "qwen3", torch.bfloat16)]
    say(f"  bf16 flash kernel's three TMA descriptors: {describe_us(flash, q, k, v):.2f} "
        "us of host time a call (qwen3's serve shape)")
    out = {}
    for row, (kind, label, dtypes) in JSON_ROWS.items():
        out[row] = dict(rows[(kind, label, dtypes[0])],
                        err=max(errs[(kind, label, dt)] for dt in dtypes))
    return out


def flash_times(flash, label, q, k, v, causal):
    """The flash forward at one serve shape: kernel, plain and SDPA times
    (graph-replayed), back-to-back calls of the wrapper, its host time a
    call, and its bound."""
    B, Sq, H, D = q.shape
    Skv, Dv = k.shape[1], v.shape[3]
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device="cuda")
    lse = torch.empty((B, H, Sq), device="cuda")
    pairs = causal_pairs(B, H, Sq, Skv) if causal else B * H * Sq * Skv
    call = lambda: flash.flash_attention_fwd(q, k, v, causal=causal)  # noqa: E731
    r = dict(ms=graph_ms(call),
             plain_ms=graph_ms(lambda: flash.flash_attention_plain(q, k, v, causal=causal)),
             call_ms=cuda_ms(call), host_us=host_us(call))
    r["library_ms"], r["library"] = sdpa_library_ms(q, k, v, is_causal=causal)
    # QK^T and PV, 2 D + 2 Dv flops a visible pair (the bf16 kernel splits P
    # in two bf16 terms and issues 2 D + 4 Dv; the fp32 one 3 x tf32)
    flops, moved = (2 * D + 2 * Dv) * pairs, nbytes(q, k, v, out, lse)
    r["bound_ms"], r["bound_by"] = bound(flops, moved, q.dtype)
    split = (f", {(2 * D + 4 * Dv) * pairs / 1e9:.2f} issued with P split"
             if q.dtype == torch.bfloat16 else "")
    say(f"  flash {label} {str(q.dtype)[6:]} (B={B}, Sq={Sq}, Skv={Skv}, H={H}, K={k.shape[2]}, "
        f"D={D}, Dv={Dv}, {'causal' if causal else 'non-causal'}; graph-timed): kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {fmt_ms(r['library_ms'])} "
        f"(SDPA {r['library']}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
        f"{moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP{split}); back-to-back calls of "
        f"the wrapper {r['call_ms']:.4f} ms, host {r['host_us']:.1f} us a call")
    return r


def decode_times(decode, label, qd, kc, vc, ci):
    """Decode at one serve shape, on the serve batch and on one request
    alone: kernel, plain and SDPA times (graph-replayed), back-to-back
    calls of the wrapper, the KV splits it launches and its bound.  Returns
    the serve batch's."""
    B, _, H, D = qd.shape
    K, n = kc.shape[2], ci + 1
    mask = (torch.arange(kc.shape[1], device="cuda") <= ci).view(1, 1, 1, -1)
    splits = kernel_entry(decode.KERNEL, "_splits", 4)
    first = None
    for b in (B, 1):
        q1, k1, v1 = qd[:b], kc[:b], vc[:b]
        call = lambda: decode.decode_attention_fwd(q1, k1, v1, cache_index=ci)  # noqa: E731
        r = dict(ms=graph_ms(call),
                 plain_ms=graph_ms(lambda: decode.decode_attention_plain(q1, k1, v1,
                                                                         cache_index=ci)),
                 call_ms=cuda_ms(call))
        r["library_ms"], r["library"] = sdpa_library_ms(q1, k1, v1, attn_mask=mask)
        moved = 2 * b * n * K * D * kc.element_size() + 2 * nbytes(q1)
        r["bound_ms"], r["bound_by"] = bound(4 * D * b * H * n, moved, qd.dtype)
        s = splits(b, H, K, ci)
        say(f"  decode {label} {str(qd.dtype)[6:]} (B={b}, H={H}, K={K}, D={D}, "
            f"{kc.shape[1]} slots, cache_index {ci}; graph-timed): {s} KV splits a "
            f"cluster, {s * b * K} blocks; kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {fmt_ms(r['library_ms'])} (SDPA "
            f"{r['library']}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
            f"{moved / 1e6:.2f} MB); back-to-back calls of the wrapper {r['call_ms']:.4f} ms")
        first = first or r
    return first


def profile_window(label, fn, reps):
    """Where the time goes in ``reps`` calls of ``fn``: kernels launched,
    device busy time and the device's idle share (torch.profiler, CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        say(f"  profile {label}: the profiler recorded no device activity: not measured")
        return None
    by_name: dict = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3 / reps
    busy_ms = sum(by_name.values())
    say(f"  profile {label} (profiler on): wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
        f"{len(kern) / reps:.0f} kernels")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        say(f"    {ms:.4f} ms  {name[:100]}")
    return 1 - busy_ms / wall_ms


def profile_task(api, params, tokens, new):
    """Profile one prefill and one decode step of one task alone; returns
    their idle shares."""
    budget = PROMPT + new
    idle = profile_window("prefill of one task", lambda i: api.prefill(
        params, {"tokens": tokens}, seq_budget=budget), 2)
    _, caches = api.prefill(params, {"tokens": tokens}, seq_budget=budget)
    nxt = tokens[:, -1:].to(torch.int32)
    return idle, profile_window("decode step of one task", lambda i: api.decode(
        params, {"tokens": nxt, "cache_index": PROMPT + i}, caches), 4)


def time_one_task(api, params, tokens, new):
    """Prefill ms and decode ms per step of one task alone on the card,
    CUDA events, median of TIMED_ROUNDS rounds after one untimed round
    (the path is host-bound and the host is shared: one round can read
    several times the others); then one profiled prefill and decode step.
    Returns the medians and the profiled idle shares."""
    times = []
    for r in range(TIMED_ROUNDS + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        logits, caches = api.prefill(params, {"tokens": tokens},
                                     seq_budget=PROMPT + new)
        ev[1].record()
        for i in range(new):
            nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
            logits, caches = api.decode(
                params, {"tokens": nxt, "cache_index": PROMPT + i}, caches)
        ev[2].record()
        torch.cuda.synchronize()
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        if r:
            times.append((ev[0].elapsed_time(ev[1]),
                          ev[1].elapsed_time(ev[2]) / new))
    prefill_ms = [t[0] for t in times]
    decode_ms = [t[1] for t in times]
    say(f"  one task alone on the card, median of {TIMED_ROUNDS} rounds: "
        f"prefill {np.median(prefill_ms):.3f} ms (B={tokens.shape[0]}, "
        f"{tokens.shape[1]} tokens; rounds "
        f"{', '.join(f'{t:.3f}' for t in prefill_ms)}), decode "
        f"{np.median(decode_ms):.3f} ms per step (rounds "
        f"{', '.join(f'{t:.3f}' for t in decode_ms)})")
    idle = profile_task(api, params, tokens, new)
    return {"prefill_ms": float(np.median(prefill_ms)),
            "decode_ms": float(np.median(decode_ms)), "idle": idle}


class RoutingTap:
    """Records the routing decisions of a model's MoE layers as it runs:
    for each (token, choice), the chosen expert and whether it found a
    slot.  A forward pre-hook routes each layer's input (``MoE.route``)
    with its own router, never pinned (``pin``): it sees remat's
    recompute too, which stops once the backward has what it needs,
    before a layer's forward returns.  ``calls`` returns what was
    recorded since its last call, one (choices, kept) a layer call;
    ``take`` the same as one decision a (token, choice), the expert or -1
    where the capacity dropped it; ``forward_and_recompute`` the
    decisions split into each layer's first run and its second (the
    recompute); ``close`` removes the hooks."""

    def __init__(self, model, pin=None):
        self.seen, self.pin = [], pin
        self.hooks = [blk.moe.register_forward_pre_hook(self._record)
                      for blk in model.blocks if blk.spec.mlp == "moe"]

    @torch.no_grad()
    def _record(self, layer, args):
        with contextlib.nullcontext() if self.pin is None else self.pin(None):
            _, _, onehot, keep, _, _ = layer.route(args[0])
        self.seen.append((layer, onehot.argmax(-1).flatten(), keep.sum(-1).flatten() > 0))

    @staticmethod
    def decisions(calls) -> torch.Tensor:
        return torch.cat([torch.where(kept, choice, -1) for choice, kept in calls])

    def calls(self):
        seen, self.seen = [(c, k) for _, c, k in self.seen], []
        return seen

    def take(self) -> torch.Tensor:
        return self.decisions(self.calls())

    def forward_and_recompute(self):
        """(each layer's first decisions, its second or None when no layer
        ran twice), layers in the order of their first run."""
        runs: dict = {}
        for layer, c, k in self.seen:
            runs.setdefault(layer, []).append((c, k))
        self.seen = []
        first = self.decisions([r[0] for r in runs.values()])
        if all(len(r) == 1 for r in runs.values()):
            return first, None
        return first, self.decisions([r[1] for r in runs.values()])

    def close(self):
        for hook in self.hooks:
            hook.remove()


def routing_split(a, b):
    """Two runs' routing (RoutingTap.calls), one MoE layer call each:
    [(first flips: (token, choice) pairs whose top-k choice differs,
    drops: pairs with the same choice that one run kept and the other
    dropped, pairs)]."""
    out = []
    for (ca, ka), (cb, kb) in zip(a, b, strict=True):
        flip = ca != cb
        out.append((flip.sum().item(), (~flip & (ka != kb)).sum().item(), ca.numel()))
    return out


class RoutingPin:
    """Pins the top-k choices of a model's MoE layers to another run's.
    ``repro_torch.models.moe.top_k`` is replaced while the pin lives:
    called with "record", each routing keeps its choices in call order;
    with "replay", each routing takes the recorded choices of the same
    order in place of its own top k, and gathers its gates from its own
    router's probabilities at them.  So each path computes its own gates
    and, from the shared choices, its own capacity drops.  Phase 19 holds
    the plain versions to the kernels' logits with the choices pinned, so
    that the two differ by the arithmetic, not by a near-tied choice one
    ulp flipped and what it moves downstream; the first flips each router
    makes on its own are counted and held beside it (ROUTING_LIMITS)."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.top_k = moe, moe.top_k
        self.kept, self.mode = [], None
        moe.top_k = self._top_k

    def _top_k(self, probs, k):
        if self.mode == "replay":
            idx = self.kept.pop(0)
            if idx.shape != probs.shape[:-1] + (k,):
                raise AssertionError("a pinned routing replayed at another shape")
            return probs.gather(-1, idx), idx
        gate, idx = self.top_k(probs, k)
        if self.mode == "record":
            self.kept.append(idx)
        return gate, idx

    @contextlib.contextmanager
    def __call__(self, mode):
        before, self.mode = self.mode, mode
        try:
            yield
        finally:
            self.mode = before

    def close(self):
        self.moe.top_k = self.top_k


def say_routing(label, split, limit=None, by_layer=False):
    """One line of routing_split's sums (and with ``by_layer`` each layer
    call's share of first flips): the shares of first flips and of the
    drops that follow; with ``limit``, the first flips' share is held to
    it."""
    flips, drops, n = (sum(col) for col in zip(*split))
    layers = ("; first flips by layer " + ", ".join(f"{f / m:.4f}" for f, _, m in split)
              if by_layer else "")
    say(f"    {label}: top-k choices differ on {flips} of {n} (token, choice) pairs "
        f"({flips / n:.4f}{'' if limit is None else f', limit {limit:g}'}), the same "
        f"choice kept in one and dropped in the other on {drops} ({drops / n:.4f}){layers}")
    if limit is not None and not flips / n <= limit:
        raise AssertionError(f"{label}: {flips / n:.4f} of the routers' choices flipped")


def kernels_vs_plain(api, params, plain_ops, batches, budget, steps, limits, tap=None,
                     other=None, pin=None):
    """The full-width logits check of phases 4, 11, 15, 17 and 19: for each
    (batch, first decode position) of ``batches``, a prefill and ``steps``
    decode steps through the kernels and through ``plain_ops``, the same
    greedy token fed to both; the largest and mean |logits difference| of
    each held to ``limits``.  With a RoutingTap, the routing decisions
    that differ between the two paths are printed beside each, split into
    first flips and the drops that follow.  ``other``: the second path's
    keywords in place of ``ops=plain_ops`` (phase 19:
    ``long_context=True``).  With a RoutingPin, the second path runs
    twice: routing its own inputs (logits printed, not held; its first
    flips over the batch held to ROUTING_LIMITS["free"]) and with its
    top-k choices pinned to the kernels' (logits held; the choices its
    own router would have made there held to ROUTING_LIMITS["pinned"]).
    Returns the largest held |logits difference|."""
    max_lim, mean_lim = limits
    other = {"ops": plain_ops} if other is None else other
    worst = 0.0

    def calls():
        return [] if tap is None else tap.calls()

    def pinned(mode):
        return contextlib.nullcontext() if pin is None else pin(mode)

    def report(i, pairs, held):
        nonlocal worst
        for name, a, b, r_a, r_b in pairs:
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                raise AssertionError(f"batch {i} {name}: non-finite logits")
            diff = (a - b).abs()
            err, mean = diff.max().item(), diff.mean().item()
            agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
            tag = ("" if pin is None else
                   " (top-k choices pinned to the kernels')" if held else
                   " (own routing; not held)")
            say(f"  batch {i} {name} logits{tag}: max |diff| {err:.3e} (limit {max_lim:g}), "
                f"mean |diff| {mean:.3e} (limit {mean_lim:g}), max |logit| "
                f"{b.abs().max().item():.3f}, greedy tokens agree on {agree:.2f} of rows")
            if r_a and (pin is None or name == "prefill"):
                say_routing("routing vs the kernels'", routing_split(r_a, r_b),
                            by_layer=name == "prefill")
            if held:
                worst = max(worst, err)
                if not (err <= max_lim and mean <= mean_lim):
                    raise AssertionError(f"batch {i} {name}: full-width logits through the "
                                         "kernels disagree")

    for i, (batch, start) in enumerate(batches):
        with pinned("record"):
            lg_k, c_k = api.prefill(params, batch, seq_budget=budget)
        r_k = calls()
        lg_p, c_p = api.prefill(params, batch, seq_budget=budget, **other)
        pairs = [("prefill", lg_k, lg_p, r_k, calls())]
        if pin is not None:
            with pin("replay"):
                lg_q, c_q = api.prefill(params, batch, seq_budget=budget, **other)
            held = [("prefill", lg_k, lg_q, r_k, calls())]
        for j in range(steps):
            step = {"tokens": torch.argmax(lg_k, -1).to(torch.int32)[:, None],
                    "cache_index": start + j}
            with pinned("record"):
                lg_k, c_k = api.decode(params, step, c_k)
            r_k = calls()
            lg_p, c_p = api.decode(params, step, c_p, **other)
            pairs.append((f"decode at {start + j}", lg_k, lg_p, r_k, calls()))
            if pin is not None:
                with pin("replay"):
                    lg_q, c_q = api.decode(params, step, c_q, **other)
                held.append((f"decode at {start + j}", lg_k, lg_q, r_k, calls()))
        report(i, pairs, pin is None)
        if pin is not None:
            report(i, held, True)
            if pin.kept:
                raise AssertionError("a recorded routing was not replayed")
            for label, runs, limit in (("free", pairs, ROUTING_LIMITS["free"]),
                                       ("pinned", held, ROUTING_LIMITS["pinned"])):
                say_routing(f"batch {i}, prefill and {steps} decode steps, {label}",
                            [s for *_, r_a, r_b in runs for s in routing_split(r_a, r_b)],
                            limit)
            del c_q
        del c_k, c_p
    return worst


def full_width_phase(api, params, cfg, dev, plain_ops, batches=FULL_WIDTH_BATCHES,
                     limits=(FULL_WIDTH_MAX_ERR, FULL_WIDTH_MEAN_ERR)):
    """Phases 4 and 11: one prefill and one decode step of each of
    ``batches`` prompt batches, through the kernels (the serving dispatch)
    and through the plain versions; |logits difference| held to
    ``limits`` (largest, mean)."""
    prompts = [{"tokens": torch.as_tensor(np.random.default_rng(SEED + 1 + i).integers(
        0, cfg.vocab_size, (PER_TASK, PROMPT))).to(dev)} for i in range(batches)]
    kernels_vs_plain(api, params, plain_ops, [(b, PROMPT) for b in prompts],
                     PROMPT + NEW, 1, limits)


def backward_phase(flash):
    """Phase 5: the backward kernels vs the plain backward at every shape
    of BWD_SHAPES (training and ragged), each dtype's Hopper pair, a second
    launch bit-identical; then each timed at its training shape.  Returns
    {(label, dtype): {"dq": row, "dkv": row}}, each row with its times,
    bound, library time and largest |error| ("err")."""
    errs, timed = {}, {}
    for label, (B, sq, skv, H, K, D, Dv, causal, dtypes) in BWD_SHAPES.items():
        for dt in dtypes:
            pair = flash.backward_kernels(dt)
            key = (label, dt)
            errs[key] = {"dq": 0.0, "dkv": 0.0}
            for size, q_len, kv_len in (("train", sq, skv),
                                        ("ragged", 13, 13 if skv == sq else skv)):
                q = randn((B, q_len, H, D), dt, 21)
                k = randn((B, kv_len, K, D), dt, 22)
                v = randn((B, kv_len, K, Dv), dt, 23)
                g = randn((B, q_len, H, Dv), dt, 24)
                out, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
                before = [kern.launches for kern in pair]
                got = flash.flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
                if [kern.launches for kern in pair] != [n + 1 for n in before]:
                    raise AssertionError(f"{label} {str(dt)[6:]} backward did not launch "
                                         f"{pair[0].name} and {pair[1].name}")
                ref = flash.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal)
                tag = (f"{label} {size} {str(dt)[6:]} Sq={q_len} Skv={kv_len} "
                       f"({pair[0].name}, {pair[1].name})")
                for name, a, b in zip(("dq", "dk", "dv"), got, ref):
                    part = "dq" if name == "dq" else "dkv"
                    errs[key][part] = max(errs[key][part], check(
                        f"{name} {tag}", a, b, RTOL[dt], BWD_ATOL))
                again = flash.flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                say(f"  dq, dk, dv {tag}: two launches bit-identical: {same}")
                if not same:
                    raise AssertionError(f"{tag}: the backward is not deterministic")
                if size == "train":
                    timed[key] = (q, k, v, out, lse, g, causal)
    torch.cuda.synchronize()
    rows = {}
    for (label, dt), inputs in timed.items():
        rows[(label, dt)] = backward_times(flash, label, *inputs)
        for part in ("dq", "dkv"):
            rows[(label, dt)][part]["err"] = errs[(label, dt)][part]
    return rows


def backward_times(flash, label, q, k, v, out, lse, g, causal):
    """The backward pair at one training shape, graph-replayed: dq, dk/dv,
    both in one call, the plain backward and SDPA's whole backward, beside
    each kernel's bound.  Returns {"dq": row, "dkv": row}."""
    B, Sq, H, D = q.shape
    Skv, K, Dv = k.shape[1], k.shape[2], v.shape[3]
    dt = q.dtype
    pairs = causal_pairs(B, H, Sq, Skv) if causal else B * H * Sq * Skv
    dq, dvec = flash.bwd_dq_launch(q, k, v, out, lse, g, causal=causal)
    dk, dv = flash.bwd_dkv_launch(q, k, v, g, lse, dvec, causal=causal)
    plain_ms = graph_ms(lambda: flash.flash_attention_bwd_plain(
        q, k, v, out, lse, g, causal=causal))
    both_ms = graph_ms(lambda: flash.flash_attention_bwd(q, k, v, out, lse, g, causal=causal))
    library_ms, library = sdpa_backward_ms(q, k, v, g, causal)
    lib = dict(plain_ms=plain_ms, library_ms=library_ms, library=library)
    rows = {"dq": dict(ms=graph_ms(lambda: flash.bwd_dq_launch(
                q, k, v, out, lse, g, causal=causal)), **lib),
            "dkv": dict(ms=graph_ms(lambda: flash.bwd_dkv_launch(
                q, k, v, g, lse, dvec, causal=causal)), **lib)}
    # the function's products a visible pair: dq S, dP and dS K (4 D + 2 Dv),
    # dk/dv S, dP, P^T dO and dS^T Q (4 D + 4 Dv)
    rows["dq"]["bound_ms"], rows["dq"]["bound_by"] = bound(
        (4 * D + 2 * Dv) * pairs, nbytes(q, k, v, out, g, lse, dq, dvec), dt)
    rows["dkv"]["bound_ms"], rows["dkv"]["bound_by"] = bound(
        (4 * D + 4 * Dv) * pairs, nbytes(q, k, v, g, lse, dvec, dk, dv), dt)
    shape = (f"B={B}, Sq={Sq}, Skv={Skv}, H={H}, K={K}, D={D}, Dv={Dv}, "
             f"{'causal' if causal else 'non-causal'}")
    for name, r in rows.items():
        say(f"  {name} {label} {str(dt)[6:]} ({shape}; graph-timed): kernel {r['ms']:.4f} ms, "
            f"plain backward (dq, dk, dv) {r['plain_ms']:.4f} ms, library backward (SDPA "
            f"{r['library']}, dq, dk, dv together) {fmt_ms(r['library_ms'])}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    ratio = "" if library_ms is None else f" ({both_ms / library_ms:.2f}x)"
    say(f"  {label} {str(dt)[6:]} backward, dq + dk/dv in one call (graph-timed) "
        f"{both_ms:.4f} ms (the two kernels timed alone: "
        f"{rows['dq']['ms'] + rows['dkv']['ms']:.4f} ms) beside SDPA's whole backward (SDPA "
        f"{library}) {fmt_ms(library_ms)}{ratio}")
    return rows


def group_of(name: str) -> str:
    """Parameter group: the name without its layer index (whisper's
    encoder and decoder layers keep their stack's name)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return ".".join(parts[2:])
    if parts[0] in ("encoder", "decoder"):
        return ".".join(parts[:1] + parts[2:])
    return name


def sync_training_phase(api, params, dev, kernels):
    """Phase 6: full-width sync training (depth cut to TRAIN_LAYERS);
    returns (launches, state)."""
    from repro_torch.checkpoint import restore, save
    from repro_torch.data import MarkovDataset
    from repro_torch.runtime.train_loop import (TrainConfig, Trainer,
                                                make_train_state)

    cfg = api.cfg
    tc = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=100, seed=SEED)
    ds = MarkovDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    state = make_train_state(api, tc, params=params)
    trainer = Trainer(api, tc, ds, state=state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.KERNELS:
        kern.launches = 0
    logs = trainer.run(TRAIN_STEPS)
    launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = [m["step_time_s"] for m in logs]
    med = float(np.median(step_s))
    say(f"  {cfg.name}: {cfg.n_layers} layers, {TRAIN_STEPS} AdamW steps "
        f"({cfg.opt_state_dtype} moments) on batches of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens")
    losses = ", ".join(f"{m['loss']:.4f}" for m in logs)
    norms = ", ".join(f"{m['grad_norm']:.3f}" for m in logs)
    say(f"  losses {losses}; grad norms {norms}")
    steps = ", ".join(f"{t * 1e3:.1f}" for t in step_s)
    say(f"  step time median {med * 1e3:.1f} ms (steps {steps}; after the first "
        f"{np.median(step_s[1:]) * 1e3:.1f} ms), {TRAIN_BATCH * TRAIN_SEQ / med:.0f} "
        f"tok/s; peak memory {peak:.2f} GB")
    say(f"  launches on the training path: {launches}")
    if not all(np.isfinite(m["loss"]) for m in logs):
        raise AssertionError("non-finite training loss")
    for name in BF16_TRAIN_KERNELS:
        if launches[name] < cfg.n_layers * TRAIN_STEPS:
            raise AssertionError(f"{name}: {launches[name]} launches, fewer "
                                 "than training needs")
    for name in FP32_TRAIN_KERNELS:
        if launches[name]:
            raise AssertionError(f"the fp32 kernel {name} ran on the bf16 training path")
    batch = {k: torch.as_tensor(v).to(dev) for k, v in ds.batch_at(99).items()}
    profile_window("training step", lambda i: trainer.train_step(state, batch), 1)

    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    save(str(ckpt), TRAIN_STEPS, state)
    t_save = time.perf_counter() - t0
    fresh = make_train_state(api, TrainConfig(seed=SEED + 1), device=dev)
    t0 = time.perf_counter()
    restore(str(ckpt), TRAIN_STEPS, fresh)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file()) / 1e9
    same = all(torch.equal(a, b) for a, b in zip(state["params"].parameters(),
                                                 fresh["params"].parameters()))
    same_opt = all(torch.equal(state["opt"][m][k], fresh["opt"][m][k])
                   for m in ("m", "v") for k in state["opt"][m])
    say(f"  checkpoint: {size:.2f} GB saved in {t_save:.1f} s, restored into a "
        f"fresh state in {t_restore:.1f} s; parameters bit-identical: {same}, "
        f"moments bit-identical: {same_opt}")
    shutil.rmtree(ckpt, ignore_errors=True)
    if not (same and same_opt):
        raise AssertionError("checkpoint restore is not bit-identical")
    del fresh
    return launches, state


def markov_batch(cfg, dev, seed=SEED + 7):
    """Phase 7's batch: TRAIN_BATCH x TRAIN_SEQ MarkovDataset tokens."""
    from repro_torch.data import MarkovDataset

    ds = MarkovDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed)
    return {k: torch.as_tensor(v).to(dev) for k, v in ds.batch_at(0).items()}


def train_step_agreement(api, model, batch, plain_ops, limits, tap=None):
    """One training step's loss and gradients on ``batch``, kernels vs
    plain versions: |dloss| and the largest per-group relative gradient
    difference held to ``limits``.  With a RoutingTap, the routing
    decisions that differ between the two are printed, and each path's
    recompute (remat) must route as its forward did.  Returns the kernels'
    (loss, grads)."""
    from repro_torch.runtime.train_loop import loss_and_grads

    loss_lim, grad_lim = limits
    loss_k, _, g_k = loss_and_grads(api, model, batch)
    routes = [tap.forward_and_recompute()] if tap is not None else []
    loss_p, _, g_p = loss_and_grads(api, model, batch, ops=plain_ops)
    if tap is not None:
        routes.append(tap.forward_and_recompute())
        for name, (fwd, again) in zip(("kernels", "plain versions"), routes):
            if again is None:
                continue
            same = torch.equal(fwd, again)
            say(f"  routing through the {name}: the recompute's {again.numel()} (token, "
                f"choice) decisions equal the forward's: {same}")
            if not same:
                raise AssertionError(f"{name}: remat's recompute routed otherwise")
        (fwd_k, _), (fwd_p, _) = routes
        flips = (fwd_k != fwd_p).sum().item()
        say(f"  routing decisions differ between the kernels and the plain versions on "
            f"{flips} of {fwd_k.numel()} (token, choice) pairs ({flips / fwd_k.numel():.4f})")
    dloss = abs(loss_k.item() - loss_p.item())
    say(f"  {api.cfg.compute_dtype}: loss through the kernels "
        f"{loss_k.item():.6f}, through the plain versions {loss_p.item():.6f}: "
        f"|dloss| {dloss:.3e} (limit {loss_lim:g})")
    worst = compare_grads(g_k, g_p, "g_kernels - g_plain", "g_plain")
    say(f"  largest relative gradient difference {worst:.3e} (limit "
        f"{grad_lim:g})")
    if not (dloss <= loss_lim and worst <= grad_lim):
        raise AssertionError("training step through the kernels disagrees "
                             "with the plain versions")
    return loss_k, g_k


def farm_phase(cfg, dev, lookup, services, kernels):
    """Phase 8: farm-mode training, depth cut to FARM_LAYERS."""
    from repro_torch.models import build
    from repro_torch.runtime.local_sgd import LocalSGDConfig, LocalSGDTrainer
    from repro_torch.runtime.train_loop import TrainConfig

    cut = cfg.replace(n_layers=FARM_LAYERS)
    say(f"  depth cut: {cfg.n_layers} -> {FARM_LAYERS} layers at full width "
        f"(at {cfg.n_layers} layers each in-flight task holds ~35 GB: a weight "
        "copy, its AdamW moments, grads, activations and an fp32 delta; two "
        "do not fit beside the client's weights, velocity and deltas)")
    api = build(cut)
    tc = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=100, seed=SEED)
    ls = LocalSGDConfig(inner_steps=FARM_INNER, n_shards=FARM_SHARDS,
                        batch_per_shard=FARM_BATCH, seq_len=TRAIN_SEQ)
    tr = LocalSGDTrainer(api, tc, ls, lookup=lookup, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.KERNELS:
        kern.launches = 0
    for r in range(2):
        if r == 1:
            services[0].fail_after(1)
        t0 = time.perf_counter()
        loss = tr.run_round(timeout=600.0)
        wall = time.perf_counter() - t0
        st = tr.farm_stats[-1]
        say(f"  round {r}{' (one service fails after one task)' if r else ''}: "
            f"loss {loss:.4f}, {st['done']} of {FARM_SHARDS} tasks done, "
            f"{st['reschedules']} reschedules, per service {st['per_service']}, "
            f"{wall:.2f} s")
        if not (np.isfinite(loss) and st["done"] == FARM_SHARDS):
            raise AssertionError(f"farm round {r} did not complete")
    launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    say(f"  launches in the farm rounds: {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    for name in BF16_TRAIN_KERNELS:
        if launches[name] < 2 * FARM_SHARDS * FARM_INNER * FARM_LAYERS:
            raise AssertionError(f"farm training launched {name} fewer times "
                                 "than it needs")
    for name in FP32_TRAIN_KERNELS:
        if launches[name]:
            raise AssertionError(f"the fp32 kernel {name} ran on the bf16 farm path")


def sm_clock_hz() -> float:
    """The card's maximum SM clock, read from ``nvidia-smi``."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return float(out.split()[0]) * 1e6


def scan_inputs(b, s, d, n, seed):
    x = randn((b, s, d), torch.float32, seed)
    dt = torch.nn.functional.softplus(randn((b, s, d), torch.float32, seed + 1))
    A = -torch.exp(randn((d, n), torch.float32, seed + 2) * 0.5)
    B = randn((b, s, n), torch.float32, seed + 3)
    C = randn((b, s, n), torch.float32, seed + 4)
    return x, dt, A, B, C


def scan_phase(scan, b, s, d, n):
    """Phase 9: the scan kernel vs the plain chunked scan at the serve
    shape (b, s, d, n), a ragged one, with h0 (two halves chained against
    one whole scan) and with strided views; then kernel and plain timed at
    the serve shape beside the bound's three terms."""
    err = 0.0

    def both(tag, *args):
        nonlocal err
        got = scan.mamba_scan_fwd(*args)
        ref = scan.mamba_scan_plain(*args)
        for name, a, r in zip(("y", "h_final"), got, ref):
            err = max(err, check(f"{tag} {name}", a, r, SCAN_TOL, SCAN_TOL))
        return got

    serve = scan_inputs(b, s, d, n, 31)
    y, h = both(f"scan serve ({b}, {s}, {d}, {n})", *serve)
    both("scan ragged (2, 13, 96, 16)", *scan_inputs(2, 13, 96, 16, 41))
    x, dt, A, B, C = serve
    half = s // 2
    y1, h1 = both("scan first half", x[:, :half], dt[:, :half], A, B[:, :half],
                  C[:, :half])
    y2, h2 = both("scan second half from h0", x[:, half:], dt[:, half:], A,
                  B[:, half:], C[:, half:], h1)
    err = max(err, check("scan halves chained vs whole: y", torch.cat([y1, y2], 1),
                         y, SCAN_TOL, SCAN_TOL),
              check("scan halves chained vs whole: h_final", h2, h, SCAN_TOL,
                    SCAN_TOL))
    xz = torch.cat([x, torch.zeros_like(x)], -1)
    proj = torch.cat([B.new_zeros(b, s, 3), B, C], -1)
    xv, Bv, Cv = xz[..., :d], proj[..., 3:3 + n], proj[..., 3 + n:]
    assert not (xv.is_contiguous() or Bv.is_contiguous() or Cv.is_contiguous())
    both("scan strided x, B, C", xv, dt, A, Bv, Cv)
    torch.cuda.synchronize()

    row = dict(ms=graph_ms(lambda: scan.mamba_scan_fwd(*serve)),
               call_ms=cuda_ms(lambda: scan.mamba_scan_fwd(*serve)),
               plain_ms=cuda_ms(lambda: scan.mamba_scan_plain(*serve), iters=5),
               library_ms=None)
    elements = b * s * d * n
    t_bytes = nbytes(*serve, y, h) / PEAK_BYTES_S * 1e3
    t_exp = elements / (MUFU_PER_CLOCK_SM * SMS * sm_clock_hz()) * 1e3
    t_flop = SCAN_FLOP_PER_ELEMENT * elements / PEAK_FLOP_S[torch.float32] * 1e3
    row["bound_ms"] = max(t_bytes, t_exp, t_flop)
    row["bound_by"] = "bytes" if t_bytes >= max(t_exp, t_flop) else "operations"
    say(f"  scan at the serve shape ({b}, {s}, {d}, {n}): kernel {row['ms']:.4f} ms "
        f"graph-timed ({row['call_ms']:.4f} ms back to back), plain "
        f"{row['plain_ms']:.4f} ms, no library call; bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}): bytes "
        f"{nbytes(*serve, y, h) / 1e6:.1f} MB in {t_bytes:.4f} ms, "
        f"{elements / 1e6:.1f} M exponentials in {t_exp:.4f} ms, "
        f"{SCAN_FLOP_PER_ELEMENT * elements / 1e9:.2f} GFLOP fp32 in {t_flop:.4f} ms")
    return err, row


def mamba_serve_phase(cfg, dev, lookup, kernels):
    """Phase 10: serve full-width, full-depth falcon-mamba-7b; returns
    (api, params, launches)."""
    from repro_torch.kernels.mamba_scan import KERNEL as SCAN
    from repro_torch.models import build
    from repro_torch.runtime.serve_loop import ServeConfig, serve_requests

    api = build(cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    say(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_inner "
        f"{cfg.d_inner}, {sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
        f"params in {cfg.param_dtype} on {dev}, initialised in "
        f"{time.perf_counter() - t0:.2f} s; fp32 unembedding copy "
        f"{params.head().table_f32().numel() * 4 / 1e9:.3f} GB")
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                   (MAMBA_REQUESTS, PROMPT))
    sc = ServeConfig(max_new_tokens=MAMBA_NEW, prompt_len=PROMPT,
                     batch_per_task=PER_TASK)
    serve_requests(api, params, prompts[:PER_TASK],
                   ServeConfig(max_new_tokens=2, prompt_len=PROMPT,
                               batch_per_task=PER_TASK), lookup=lookup)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 1e9
    for kern in kernels.KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    gen, stats = serve_requests(api, params, prompts, sc, lookup=lookup)
    wall = time.perf_counter() - t0
    launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    n_tasks = MAMBA_REQUESTS // PER_TASK
    say(f"  allocated before the run: {resident:.2f} GB")
    say(f"  served {tuple(gen.shape)} tokens in {wall:.3f} s: "
        f"{gen.numel() / wall:.1f} tok/s across {SERVICES} services; "
        f"{stats['done']} tasks, {stats['reschedules']} reschedules; peak "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    say(f"  launches on the main path: {launches}")
    if tuple(gen.shape) != (MAMBA_REQUESTS, MAMBA_NEW):
        raise AssertionError(f"generated shape {tuple(gen.shape)}")
    if not (int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size):
        raise AssertionError("generated token ids out of range")
    # one scan per layer per task, in prefill; decode has no kernel
    if launches[SCAN.name] != n_tasks * cfg.n_layers:
        raise AssertionError(f"scan kernel launched {launches[SCAN.name]} "
                             f"times, not {n_tasks} tasks x {cfg.n_layers} layers")
    time_one_task(api, params, torch.as_tensor(prompts[:PER_TASK]).to(dev),
                  MAMBA_NEW)
    return api, params, launches


def mamba_train_phase(cfg, dev, kernels, full_params):
    """Phase 12: sync training of falcon-mamba-7b at full width, depth cut
    to MAMBA_TRAIN_LAYERS; ``full_params`` is the full-depth model's
    parameter count."""
    from repro_torch.data import MarkovDataset
    from repro_torch.kernels.mamba_scan import KERNEL as SCAN
    from repro_torch.models import build
    from repro_torch.runtime.train_loop import TrainConfig, Trainer

    cut = cfg.replace(n_layers=MAMBA_TRAIN_LAYERS)
    say(f"  depth cut: {cfg.n_layers} -> {MAMBA_TRAIN_LAYERS} layers at full "
        f"width (at {cfg.n_layers} layers the fp32 AdamW moments alone take "
        f"{8 * full_params / 1e9:.1f} GB beside {2 * full_params / 1e9:.1f} GB "
        f"of bf16 weights and as much again of gradients)")
    api = build(cut)
    tc = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=100, seed=SEED)
    ds = MarkovDataset(cut.vocab_size, TRAIN_SEQ, MAMBA_TRAIN_BATCH, seed=SEED)
    trainer = Trainer(api, tc, ds, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.KERNELS:
        kern.launches = 0
    logs = trainer.run(TRAIN_STEPS)
    launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = [m["step_time_s"] for m in logs]
    med = float(np.median(step_s))
    say(f"  {cut.name}: {cut.n_layers} layers, "
        f"{sum(p.numel() for p in trainer.state['params'].parameters()) / 1e9:.3f} B "
        f"params, {TRAIN_STEPS} AdamW steps ({cut.opt_state_dtype} moments) on "
        f"batches of {MAMBA_TRAIN_BATCH} x {TRAIN_SEQ} tokens")
    losses = ", ".join(f"{m['loss']:.4f}" for m in logs)
    norms = ", ".join(f"{m['grad_norm']:.3f}" for m in logs)
    steps = ", ".join(f"{t * 1e3:.1f}" for t in step_s)
    say(f"  losses {losses}; grad norms {norms}")
    say(f"  step time median {med * 1e3:.1f} ms (steps {steps}; after the first "
        f"{np.median(step_s[1:]) * 1e3:.1f} ms), {MAMBA_TRAIN_BATCH * TRAIN_SEQ / med:.0f} "
        f"tok/s; peak memory {peak:.2f} GB")
    say(f"  launches on the training path: {launches}")
    if not all(np.isfinite(m["loss"]) for m in logs):
        raise AssertionError("non-finite training loss")
    # one scan per layer per step, in the forward; the backward recomputes
    # through the plain chunked scan and launches no kernel
    if launches[SCAN.name] != TRAIN_STEPS * MAMBA_TRAIN_LAYERS:
        raise AssertionError(f"scan kernel launched {launches[SCAN.name]} "
                             f"times in training, not {TRAIN_STEPS} steps x "
                             f"{MAMBA_TRAIN_LAYERS} layers")
    batch = {k: torch.as_tensor(v).to(dev) for k, v in ds.batch_at(99).items()}
    profile_window("training step", lambda i: trainer.train_step(
        trainer.state, batch), 1)


def family_phase(arch, dev, lookup, kernels, layers=None, experts=None, then=None):
    """Phase 15 (and 17, 19) for one family: serve it at full width, at
    full depth or cut to ``layers`` layers (and ``experts`` experts),
    through ``BasicClient`` on the services in ``lookup`` with every launch
    count zeroed just before and read just after (exact counts a task: one
    flash launch a prefill attention, one decode launch a self-attention
    layer and new token but none for MLA, one scan launch a Mamba layer,
    nothing else), then its logits through the kernels against the plain
    versions (with an MoE's routing flips), then ``then(api, params,
    batches, tap, pin, largest held |logits difference|)``.
    minicpm3's and the MoE families' task is timed alone and profiled.
    Returns the launch counts."""
    import repro_torch.configs as cfgs
    from repro_torch.core import BasicClient
    from repro_torch.kernels import decode_attention as decode
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.models import build
    from repro_torch.runtime.serve_loop import (ServeConfig, make_generate_program,
                                                serve_requests)

    from repro_torch.kernels import mamba_scan as scan

    full = cfgs.get(arch)
    cfg = full if layers is None else full.replace(n_layers=layers)
    if experts is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=experts))
    api = build(cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    encdec = cfg.is_encoder_decoder
    depth = (f"{cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder layers" if encdec
             else f"{cfg.n_layers} layers")
    say(f"  {cfg.name}: {depth}, d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv_heads} kv-heads, {sum(p.numel() for p in params.parameters()) / 1e9:.3f} "
        f"B params in {cfg.param_dtype}, initialised in {time.perf_counter() - t0:.2f} s")
    if layers is not None:
        say_depth_cut(full, cfg, params)
    if cfg.moe is not None and cfg.moe.n_experts != full.moe.n_experts:
        say_expert_cut(full, cfg, params)
    prompt, new = (WHISPER_PROMPT, WHISPER_NEW) if encdec else (PROMPT, FAMILY_NEW)
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (FAMILY_REQUESTS, prompt)))
    sc = ServeConfig(max_new_tokens=new, prompt_len=prompt, batch_per_task=PER_TASK)
    if encdec:  # tasks carry the frontend stub's frames beside the prompt
        frames = torch.randn((FAMILY_REQUESTS, cfg.encoder_seq_len, cfg.d_model),
                             generator=torch.Generator().manual_seed(SEED))
        tasks = [{"tokens": prompts[i:i + PER_TASK], "enc_frames": frames[i:i + PER_TASK]}
                 for i in range(0, FAMILY_REQUESTS, PER_TASK)]

        def serve(sc, tasks):
            out: list = []
            client = BasicClient(make_generate_program(api, sc, params), None, tasks, out,
                                 lookup=lookup)
            client.compute(timeout=600)
            return torch.cat([o["generated"].cpu() for o in out]), client.stats()
    else:
        tasks = prompts

        def serve(sc, tasks):
            return serve_requests(api, params, tasks, sc, lookup=lookup, timeout=600)
    # warm-up (cuBLAS handles, allocator), not counted
    serve(ServeConfig(max_new_tokens=2, prompt_len=prompt, batch_per_task=PER_TASK),
          tasks[:1] if encdec else tasks[:PER_TASK])
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    gen, stats = serve(sc, tasks)
    wall = time.perf_counter() - t0
    launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    n_tasks = FAMILY_REQUESTS // PER_TASK
    say(f"  served {tuple(gen.shape)} tokens in {wall:.3f} s: {gen.numel() / wall:.1f} tok/s "
        f"across {SERVICES} services; {stats['done']} tasks, {stats['reschedules']} "
        f"reschedules; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    say(f"  launches on the main path: {launches}")
    if tuple(gen.shape) != (FAMILY_REQUESTS, new):
        raise AssertionError(f"generated shape {tuple(gen.shape)}")
    if not (int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size):
        raise AssertionError("generated token ids out of range")
    want = {kern.name: 0 for kern in kernels.KERNELS}
    mixers = [cfg.pattern[i % len(cfg.pattern)].mixer for i in range(cfg.n_layers)]
    self_attn = mixers.count("attn")
    # whisper: the encoder's, the decoder's self- and cross-attention prefills
    prefills = cfg.n_encoder_layers + 2 * cfg.n_layers if encdec else self_attn
    want[flash.SM90_KERNEL.name] = n_tasks * prefills
    want[decode.KERNEL.name] = 0 if cfg.attention == "mla" else n_tasks * self_attn * new
    want[scan.KERNEL.name] = n_tasks * mixers.count("mamba")
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if arch == "minicpm3_4b" or cfg.moe is not None:
        time_one_task(api, params, prompts[:PER_TASK].to(dev), new)

    say(f"  {cfg.name}: kernels vs plain versions at full width")
    batches = []
    for i in range(FAMILY_BATCHES):
        g = np.random.default_rng(SEED + 1 + i)
        batch = {"tokens": torch.as_tensor(g.integers(0, cfg.vocab_size,
                                                      (PER_TASK, prompt))).to(dev)}
        if encdec:
            batch["enc_frames"] = randn((PER_TASK, cfg.encoder_seq_len, cfg.d_model),
                                        torch.float32, SEED + 60 + i)
        if cfg.frontend == "vision":
            batch["patch_embeds"] = randn((PER_TASK, PATCHES, cfg.d_model), torch.float32,
                                          SEED + 70 + i)
        batches.append((batch, prompt + (PATCHES if cfg.frontend == "vision" else 0)))
    steps = 4 if cfg.frontend == "vision" or cfg.moe is not None else 1
    pin = RoutingPin() if arch in PINNED else None
    tap = RoutingTap(params, pin) if cfg.moe is not None else None
    gap = kernels_vs_plain(api, params, kernels.PLAIN, batches, batches[0][1] + new, steps,
                           FAMILY_LIMITS[arch], tap, pin=pin)
    if then is not None:
        then(api, params, batches, tap, pin, gap)
    for hooks in (tap, pin):
        if hooks is not None:
            hooks.close()
    return launches


def say_depth_cut(full, cfg, params):
    """Phase 17's cut, as a ``reduced`` list: the layers kept at full
    width, the weights they take, what the full depth and one more pattern
    repeat would take beside the embeddings and the fp32 unembedding copy,
    and the card's memory."""
    def gb(named):
        return sum(p.numel() * p.element_size() for _, p in named) / 1e9

    blocks = gb(params.blocks.named_parameters())
    rest = gb((n, p) for n, p in params.named_parameters() if not n.startswith("blocks."))
    f32 = params.head().table_f32().numel() * 4 / 1e9
    per_repeat = blocks / cfg.n_repeats
    card = torch.cuda.get_device_properties(0).total_memory / 1e9
    say("  reduced: " + json.dumps([
        f"n_layers {full.n_layers} -> {cfg.n_layers}: {cfg.n_repeats} of {full.n_repeats} "
        f"repeats of the pattern ({', '.join(s.mlp for s in cfg.pattern)} MLPs), widths "
        "as published"]))
    say(f"  weights: blocks {blocks:.2f} GB ({per_repeat:.2f} GB a repeat), embeddings "
        f"{rest:.2f} GB, fp32 unembedding copy {f32:.2f} GB: {blocks + rest + f32:.2f} GB; "
        f"one more repeat {blocks + per_repeat + rest + f32:.2f} GB, full depth "
        f"{per_repeat * full.n_repeats + rest + f32:.1f} GB; the card has {card:.1f} GB")


def say_expert_cut(full, cfg, params):
    """Phase 19's expert cut, as a ``reduced`` list beside what it saves:
    the expert stacks at the published count (their bytes scale with it)."""
    kept = sum(p.numel() * p.element_size() for n, p in params.named_parameters()
               if ".moe.experts." in n) / 1e9
    total = sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9
    f32 = params.head().table_f32().numel() * 4 / 1e9
    grown = kept * full.moe.n_experts / cfg.moe.n_experts
    say("  reduced: " + json.dumps([
        f"moe.n_experts {full.moe.n_experts} -> {cfg.moe.n_experts} in each of the "
        f"{sum(s.mlp == 'moe' for s in cfg.pattern) * cfg.n_repeats} MoE layers; top_k "
        f"{cfg.moe.top_k}, capacity {cfg.moe.capacity_factor}, groups of "
        f"{cfg.moe.group_size} as published"]))
    say(f"  experts: {kept:.2f} GB kept of {grown:.2f} GB; weights {total:.2f} GB and the "
        f"fp32 unembedding copy {f32:.2f} GB: {total + f32:.2f} GB, "
        f"{total - kept + grown + f32:.2f} GB with every expert (saves {grown - kept:.2f} GB)")


def long_context_tokens(cfg, dev):
    """Phase 19's long-context request: one prompt of JAMBA_LONG_PROMPT
    tokens and the JAMBA_LONG_STEPS tokens fed after it, from the seed."""
    return torch.as_tensor(np.random.default_rng(SEED + 90).integers(
        0, cfg.vocab_size, (1, JAMBA_LONG_PROMPT + JAMBA_LONG_STEPS))).to(dev)


def decode_vs_prefill(api, params, tokens):
    """The serve-consistency comparison at long context: prefill the first
    JAMBA_LONG_PROMPT tokens and decode the rest one at a time, each
    step's logits beside those of a prefill of the prompt that ends at
    the fed token, all with ``long_context=True``.  Returns [(decode
    logits, prefill logits)]."""
    S, n = JAMBA_LONG_PROMPT, JAMBA_LONG_STEPS
    _, caches = api.prefill(params, {"tokens": tokens[:, :S]}, seq_budget=S + n,
                            long_context=True)
    pairs = []
    for i in range(n):
        lg, caches = api.decode(params, {"tokens": tokens[:, S + i:S + i + 1],
                                         "cache_index": S + i}, caches, long_context=True)
        ref, _ = api.prefill(params, {"tokens": tokens[:, :S + i + 1]}, long_context=True)
        pairs.append((lg, ref))
    return pairs


def long_context_phase(api, params, batches, tap, pin, gap):
    """Phase 19's long context on the served model.  Within the window
    (PROMPT-token prompts), ``long_context=True`` (the plain windowed path)
    against the kernels' ``long_context=False`` logits, held to jamba's
    FAMILY_LIMITS.  Past it, one request of JAMBA_LONG_PROMPT tokens
    through ``prefill(long_context=True)`` and JAMBA_LONG_STEPS decode
    steps, the launch counts zeroed just before and read just after: no
    flash or decode launch, one scan launch a Mamba layer, finite logits.
    The window bites: the prompt's last logits differ from those of the
    same plain attention without a window (which computes the positions
    inside the window bit for bit alike) by more than BITES times ``gap``,
    the largest kernels-vs-plain gap held before; the kernels'
    ``long_context=False`` gap is printed beside it, and the served
    model's decode-vs-prefill gap."""
    from repro_torch import kernels
    from repro_torch.kernels import AttentionOps
    from repro_torch.kernels import mamba_scan as scan
    from repro_torch.models.attention import chunked_attention

    cfg = api.cfg
    W, S, n = cfg.long_context_window, JAMBA_LONG_PROMPT, JAMBA_LONG_STEPS
    say(f"  long_context=True within the window ({batches[0][1]}-token prompts, window {W}) "
        "against the kernels' long_context=False")
    gap = max(gap, kernels_vs_plain(api, params, None, batches[:1],
                                    batches[0][1] + FAMILY_NEW, 4, FAMILY_LIMITS[JAMBA],
                                    tap, other={"long_context": True}, pin=pin))
    tokens = long_context_tokens(cfg, params.device)
    for kern in kernels.KERNELS:
        kern.launches = 0
    lg, caches = api.prefill(params, {"tokens": tokens[:, :S]}, seq_budget=S + n,
                             long_context=True)
    steps = []
    for i in range(n):
        out, caches = api.decode(params, {"tokens": tokens[:, S + i:S + i + 1],
                                          "cache_index": S + i}, caches, long_context=True)
        steps.append(out)
    torch.cuda.synchronize()
    launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    want = {kern.name: 0 for kern in kernels.KERNELS}
    want[scan.KERNEL.name] = sum(s.mixer == "mamba" for s in cfg.pattern) * cfg.n_repeats
    say(f"  long context (B=1, prompt {S}, window {W}, {n} decode steps): launches {launches}")
    if launches != want:
        raise AssertionError(f"long-context launches {launches}, expected {want}")
    if not all(torch.isfinite(t).all() for t in [lg] + steps):
        raise AssertionError("non-finite long-context logits")
    del caches
    # the same plain attention without a window: bit-identical inside it
    unwindowed = AttentionOps(
        lambda q, k, v, *, causal=True, window=None: chunked_attention(q, k, v, causal=causal),
        kernels.DISPATCH.decode, None, kernels.DISPATCH.scan)
    for kern in kernels.KERNELS:
        kern.launches = 0
    lg_plain, _ = api.prefill(params, {"tokens": tokens[:, :S]}, ops=unwindowed)
    lg_kern, _ = api.prefill(params, {"tokens": tokens[:, :S]})
    bites = (lg - lg_plain).abs()
    say(f"  the window bites: last logits vs the same attention unwindowed max |diff| "
        f"{bites.max().item():.3e}, mean {bites.mean().item():.3e}; vs the kernels' "
        f"long_context=False max {(lg - lg_kern).abs().max().item():.3e}, mean "
        f"{(lg - lg_kern).abs().mean().item():.3e}; max |logit| {lg.abs().max().item():.3f}")
    say(f"  the window's largest gap is {bites.max().item() / gap:.1f} times the largest "
        f"kernels-vs-plain gap {gap:.3e} (limit: more than {BITES})")
    if not bites.max().item() > BITES * gap:
        raise AssertionError("long_context=True is within rounding of the unwindowed "
                             "logits: the window does not bite")
    gaps = [(a - b).abs().max().item() for a, b in decode_vs_prefill(api, params, tokens)]
    say(f"  served bf16 model, decode vs prefill of the longer prompt at long context: max "
        f"|diff| {', '.join(f'{g:.3e}' for g in gaps)} (bf16, capacity "
        f"{cfg.moe.capacity_factor}: not held; the fp32 check below is)")


def long_context_fp32_phase(dev):
    """Phase 19's serve-consistency check at long context, in fp32 (see
    JAMBA_FP32_EXPERTS): each decode step's logits within CONSISTENCY_TOL
    (absolute and relative) of a prefill of the longer prompt."""
    import repro_torch.configs as cfgs
    from repro_torch.models import build

    full = cfgs.get(JAMBA)
    cfg = full.replace(n_layers=JAMBA_LAYERS, param_dtype="float32", compute_dtype="float32",
                       moe=dataclasses.replace(full.moe, n_experts=JAMBA_FP32_EXPERTS,
                                               capacity_factor=JAMBA_FP32_EXPERTS
                                               / full.moe.top_k))
    api = build(cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    say(f"  fp32: {cfg.n_layers} layers, {cfg.moe.n_experts} experts at capacity "
        f"{cfg.moe.capacity_factor}, {sum(p.numel() for p in params.parameters()) / 1e9:.3f} "
        f"B params, initialised in {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i, (lg, ref) in enumerate(decode_vs_prefill(api, params, long_context_tokens(cfg, dev))):
        diff = (lg - ref).abs()
        excess = (diff / (CONSISTENCY_TOL + CONSISTENCY_TOL * ref.abs())).max().item()
        say(f"  decode at {JAMBA_LONG_PROMPT + i} vs prefill of {JAMBA_LONG_PROMPT + i + 1} "
            f"tokens: max |diff| {diff.max().item():.3e}, worst |diff| / limit {excess:.4f}, "
            f"max |logit| {ref.abs().max().item():.3f}")
        if not (torch.isfinite(lg).all() and excess <= 1):
            raise AssertionError("long-context decode disagrees with prefill")
    say(f"  fp32 consistency check in {time.perf_counter() - t0:.2f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


class FamilyBatches:
    """A family's training batches: MarkovDataset tokens and targets and,
    as the reference's own smoke batch carries them, the frontend stub's
    input made from the seed and the step: PATCHES patch embeddings before
    the text for the vision model, the encoder's frames for whisper."""

    def __init__(self, cfg, seq_len, batch, seed):
        from repro_torch.data import MarkovDataset

        self.cfg, self.batch, self.seed = cfg, batch, seed
        self.tokens = MarkovDataset(cfg.vocab_size, seq_len, batch, seed=seed)

    def batch_at(self, step: int) -> dict:
        cfg, out = self.cfg, self.tokens.batch_at(step)
        rng = np.random.default_rng((self.seed, step, 1))
        if cfg.is_encoder_decoder:
            out["enc_frames"] = rng.standard_normal(
                (self.batch, cfg.encoder_seq_len, cfg.d_model), np.float32)
        if cfg.frontend == "vision":
            out["patch_embeds"] = rng.standard_normal((self.batch, PATCHES, cfg.d_model),
                                                      np.float32)
        return out


def train_and_check(api, ds, seq, dev, kernels, want):
    """Phases 16 and 18: sync training of ``api``'s config on ``ds``
    (``Trainer``, TRAIN_STEPS AdamW steps, the config's moment dtype,
    weights from the seed) with every launch count zeroed just before and
    read just after and held equal to ``want``; the losses finite and step
    0's batch scoring lower after training; step time, tok/s, peak memory
    and one profiled step printed.  Returns (trainer, launches, peak GB,
    median step s)."""
    from repro_torch.runtime.train_loop import TrainConfig, Trainer

    cfg = api.cfg
    tc = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=100, seed=SEED)
    t0 = time.perf_counter()
    trainer = Trainer(api, tc, ds, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in trainer.state["params"].parameters())
    say(f"  {cfg.name}: {n_params / 1e9:.3f} B params in {cfg.param_dtype}, state made in "
        f"{time.perf_counter() - t0:.2f} s; {TRAIN_STEPS} AdamW steps "
        f"({cfg.opt_state_dtype} moments{', remat' if cfg.remat else ''}) on batches of "
        f"{ds.batch} x {seq} tokens")
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.KERNELS:
        kern.launches = 0
    logs = trainer.run(TRAIN_STEPS)
    launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = [m["step_time_s"] for m in logs]
    med = float(np.median(step_s))
    losses = [m["loss"] for m in logs]
    norms = ", ".join(f"{m['grad_norm']:.3f}" for m in logs)
    aux = ("" if cfg.moe is None else
           "; aux losses " + ", ".join(f"{m['aux_loss']:.4f}" for m in logs))
    steps = ", ".join(f"{t * 1e3:.1f}" for t in step_s)
    say(f"  losses {', '.join(f'{x:.4f}' for x in losses)}; grad norms {norms}{aux}")
    say(f"  step time median {med * 1e3:.1f} ms (steps {steps}; after the first "
        f"{np.median(step_s[1:]) * 1e3:.1f} ms), {ds.batch * seq / med:.0f} tok/s; "
        f"peak memory {peak:.2f} GB")
    say(f"  launches on the training path: {launches}")
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite training loss")
    # falling: step 0's batch again, on the trained weights (the steps'
    # own losses are of different batches, and step 0's rate is 0)
    first = {k: torch.as_tensor(v).to(dev) for k, v in ds.batch_at(0).items()}
    with torch.no_grad():
        after = float(api.train_loss(trainer.state["params"], first)[0])
    say(f"  loss of step 0's batch: {losses[0]:.4f} before training, {after:.4f} after "
        f"{TRAIN_STEPS} steps")
    if not after < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses[0]} -> {after}")
    batch = {k: torch.as_tensor(v).to(dev) for k, v in ds.batch_at(99).items()}
    profile_window("training step", lambda i: trainer.train_step(trainer.state, batch), 1)
    return trainer, launches, peak, med


def family_train_phase(arch, dev, kernels):
    """Phase 16 for one family: sync training at full width and full
    depth with fp32 moments on FamilyBatches (``train_and_check``: exactly
    one bf16 flash forward, dq and dk/dv launch an attention layer a step,
    nothing else); then, the moments freed, one step's loss and gradients
    through the kernels and through the plain versions, same weights, same
    batch, held to FAMILY_TRAIN_LIMITS.  Returns the launch counts."""
    import repro_torch.configs as cfgs
    from repro_torch.models import build

    cfg = cfgs.get(arch)
    encdec = cfg.is_encoder_decoder
    api = build(cfg)
    seq = WHISPER_TRAIN_SEQ if encdec else TRAIN_SEQ
    depth = (f"{cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder layers" if encdec
             else f"{cfg.n_layers} layers")
    extra = (f" beside {cfg.encoder_seq_len} encoder frames" if encdec else
             f" after {PATCHES} patch embeddings" if cfg.frontend == "vision" else "")
    say(f"  {cfg.name}: {depth}, d_model {cfg.d_model}{extra}")
    attn_layers = cfg.n_encoder_layers + 2 * cfg.n_layers if encdec else cfg.n_layers
    want = {kern.name: 0 for kern in kernels.KERNELS}
    for name in BF16_TRAIN_KERNELS:
        want[name] = TRAIN_STEPS * attn_layers
    ds = FamilyBatches(cfg, seq, FAMILY_TRAIN_BATCH, SEED)
    trainer, launches, _, _ = train_and_check(api, ds, seq, dev, kernels, want)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in ds.batch_at(99).items()}

    say(f"  {cfg.name}: one training step, kernels vs plain versions (moments freed)")
    model = trainer.state["params"]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    train_step_agreement(api, model, batch, kernels.PLAIN, FAMILY_TRAIN_LIMITS[arch])
    return launches


def moe_train_cfg(arch):
    """Phase 18's config: phase 17's depth cut, MOE_TRAIN_EXPERTS experts,
    everything else as published (remat and the moment dtype included)."""
    import repro_torch.configs as cfgs

    full = cfgs.get(arch)
    return full, full.replace(n_layers=MOE_LAYERS[arch], moe=dataclasses.replace(
        full.moe, n_experts=MOE_TRAIN_EXPERTS))


def say_moe_cuts(full, cfg, model, opt):
    """Phase 18's cuts, as a ``reduced`` list with the training state
    (weights, gradients and moments) each saves, and the state kept beside
    the loss's fp32 unembedding table and its fp32 gradient."""
    named = dict(model.named_parameters())
    n = sum(p.numel() for p in named.values())
    wbytes = sum(p.numel() * p.element_size() for p in named.values())
    mbytes = sum(t.numel() * t.element_size() for mom in ("m", "v")
                 for x in opt[mom].values()
                 for t in (x.values() if isinstance(x, dict) else (x,)))
    per_param = (2 * wbytes + mbytes) / n  # weight, gradient and both moments
    experts = sum(p.numel() for k, p in named.items() if ".moe.experts." in k)
    blocks = sum(p.numel() for k, p in named.items() if k.startswith("blocks."))
    per_repeat = blocks / cfg.n_repeats
    e_full, e_cut = full.moe.n_experts, cfg.moe.n_experts
    saved_experts = experts / e_cut * (e_full - e_cut) * per_param / 1e9
    saved_depth = (per_repeat + experts / cfg.n_repeats / e_cut * (e_full - e_cut)) \
        * (full.n_repeats - cfg.n_repeats) * per_param / 1e9
    say("  reduced: " + json.dumps([
        f"n_experts {e_full} -> {e_cut} in each of the {sum(s.mlp == 'moe' for s in cfg.pattern) * cfg.n_repeats} "
        f"MoE layers kept: saves {saved_experts:.1f} GB of training state",
        f"n_layers {full.n_layers} -> {cfg.n_layers} ({cfg.n_repeats} of {full.n_repeats} "
        f"repeats of the pattern): saves {saved_depth:.1f} GB more at {e_full} experts",
        "widths, heads, top_k, capacity_factor, group_size and dense_residual as published"]))
    table = cfg.vocab_size * cfg.d_model * 4 * 2 / 1e9
    say(f"  training state: {n / 1e9:.3f} B params (experts {experts / 1e9:.3f} B), weights "
        f"{wbytes / 1e9:.2f} GB + gradients {wbytes / 1e9:.2f} GB + {cfg.opt_state_dtype} "
        f"moments {mbytes / 1e9:.2f} GB = {(2 * wbytes + mbytes) / 1e9:.2f} GB; the loss's "
        f"fp32 table and its fp32 gradient {table:.2f} GB")
    return (2 * wbytes + mbytes) / 1e9 + table


def moe_train_phase(arch, dev, kernels):
    """Phase 18 for one MoE config (``moe_train_cfg``): sync training
    (``train_and_check``: exactly 2 bf16 flash forwards an attention layer
    a step, the second the recompute of remat, one dq and one dk/dv,
    nothing else), the peak memory below the card's 80 GB; then, the
    moments freed, one step's loss and gradients through the kernels and
    through the plain versions, same weights, same batch, held to
    FAMILY_TRAIN_LIMITS, with the routing decisions that differ between
    the two and between each forward and its recompute; then the same step
    with remat off, whose gradients must equal remat's within
    REMAT_GRAD_TOL.  Returns the launch counts."""
    from repro_torch.models import build
    from repro_torch.runtime.train_loop import loss_and_grads

    full, cfg = moe_train_cfg(arch)
    if not cfg.remat:
        raise AssertionError(f"{cfg.name}: the config no longer carries remat")
    api = build(cfg)
    say(f"  {cfg.name}: {cfg.n_layers} layers ({', '.join(s.mlp for s in cfg.pattern)} "
        f"MLPs), d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} kv-heads, "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}")
    want = {kern.name: 0 for kern in kernels.KERNELS}
    for name in BF16_TRAIN_KERNELS:  # the forward twice: the step's and remat's
        want[name] = TRAIN_STEPS * cfg.n_layers * (2 if name == "flash_attention_sm90" else 1)
    ds = FamilyBatches(cfg, TRAIN_SEQ, FAMILY_TRAIN_BATCH, SEED)
    trainer, launches, peak, med = train_and_check(api, ds, TRAIN_SEQ, dev, kernels, want)
    expected = say_moe_cuts(full, cfg, trainer.state["params"], trainer.state["opt"])
    say(f"  peak memory {peak:.2f} GB against {expected:.2f} GB of state and loss "
        f"temporaries reckoned; step {med * 1e3:.1f} ms")
    if not peak < 80:
        raise AssertionError(f"peak memory {peak:.2f} GB: over the card's 80 GB")
    batch = {k: torch.as_tensor(v).to(dev) for k, v in ds.batch_at(99).items()}

    say(f"  {cfg.name}: one training step, kernels vs plain versions (moments freed)")
    model = trainer.state["params"]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    tap = RoutingTap(model)
    loss_k, g_k = train_step_agreement(api, model, batch, kernels.PLAIN,
                                       FAMILY_TRAIN_LIMITS[arch], tap)
    gc.collect()
    torch.cuda.empty_cache()
    tap.close()

    say(f"  {cfg.name}: the same step with remat off (same weights, same batch)")
    model.cfg = cfg.replace(remat=False)
    for kern in kernels.KERNELS:
        kern.launches = 0
    loss_n, _, g_n = loss_and_grads(api, model, batch)
    model.cfg = cfg
    off = {kern.name: kern.launches for kern in kernels.KERNELS}
    if off != {name: n // TRAIN_STEPS // (2 if name == "flash_attention_sm90" else 1)
               for name, n in want.items()}:
        raise AssertionError(f"remat off launched {off}: the forward ran again")
    same = torch.equal(loss_n, loss_k) and all(torch.equal(g_n[k], g_k[k]) for k in g_k)
    say(f"  remat off: loss {loss_n.item():.6f} (remat {loss_k.item():.6f}); loss and "
        f"gradients bit-identical to remat's: {same}")
    if not same:
        rel = compare_grads(g_n, g_k, "g_remat_off - g_remat", "g_remat", quiet=True)
        say(f"  largest relative difference of a parameter's gradient {rel:.3e} (limit "
            f"{REMAT_GRAD_TOL:g})")
        if not (rel <= REMAT_GRAD_TOL and abs(loss_n.item() - loss_k.item()) <= REMAT_GRAD_TOL
                * abs(loss_k.item())):
            raise AssertionError("remat's gradients differ from remat off's")
    return launches


def fp32_family_phase(arch, dev, kernels):
    """Phase 20 for one D = 96 family in fp32: full width, depth cut to
    TRAIN_LAYERS, seeded weights.  (a) one training step on a FamilyBatches
    batch through the kernels and through the plain versions
    (``train_step_agreement``, TRAIN_LIMITS[fp32]); (b) a prefill and 4
    decode steps of each of FP32_FAMILY_BATCHES batches (phi-3's with
    PATCHES seeded patch embeddings), the same greedy token fed to both
    paths, logits held to CONSISTENCY_TOL.  Every count is zeroed just
    before each and read just after: (a) one fp32 flash forward, dq and
    dk/dv launch a layer; (b) one fp32 flash forward a layer a prefill and,
    for phi-3, one decode launch a layer a step (minicpm3's decode is the
    absorbed form); no bf16 kernel.  Returns the launches of (a) and (b)
    summed."""
    import repro_torch.configs as cfgs
    from repro_torch.kernels import decode_attention as decode
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.models import build

    full = cfgs.get(arch)
    cfg = full.replace(n_layers=TRAIN_LAYERS, param_dtype="float32", compute_dtype="float32")
    dims = ((cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim)
            if cfg.attention == "mla" else (cfg.head_dim, cfg.head_dim))
    vision = cfg.frontend == "vision"
    api = build(cfg)
    t0 = time.perf_counter()
    model = api.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    say(f"  {cfg.name} in float32: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, (D, Dv) = {dims}, {n / 1e9:.3f} B params ({4 * n / 1e9:.2f} GB), "
        f"initialised in {time.perf_counter() - t0:.2f} s")
    say("  reduced: " + json.dumps([f"n_layers {full.n_layers} -> {cfg.n_layers} (phase 7's "
                                    "depth), widths and head dims as published"]))

    def counted(fn):
        for kern in kernels.KERNELS:
            kern.launches = 0
        fn()
        torch.cuda.synchronize()
        return {kern.name: kern.launches for kern in kernels.KERNELS}

    def expect(label, launches, want):
        say(f"  launches on the fp32 {label}: {launches}")
        if launches != want:
            raise AssertionError(f"{cfg.name} fp32 {label}: launches {launches}, "
                                 f"expected {want}")

    model.requires_grad_(True)
    model.head().drop_f32()
    ds = FamilyBatches(cfg, TRAIN_SEQ, FAMILY_TRAIN_BATCH, SEED)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in ds.batch_at(0).items()}
    torch.cuda.reset_peak_memory_stats()
    train = counted(lambda: train_step_agreement(api, model, batch, kernels.PLAIN,
                                                 TRAIN_LIMITS[torch.float32]))
    want = {kern.name: 0 for kern in kernels.KERNELS}
    for name in FP32_TRAIN_KERNELS:
        want[name] = cfg.n_layers
    expect("training step", train, want)
    say(f"  training step peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"(batch {FAMILY_TRAIN_BATCH} x {batch['tokens'].shape[1]} tokens"
        f"{f' after {PATCHES} patches' if vision else ''})")
    model.requires_grad_(False)
    del batch
    gc.collect()
    torch.cuda.empty_cache()

    batches = []
    for i in range(FP32_FAMILY_BATCHES):
        g = np.random.default_rng(SEED + 1 + i)
        b = {"tokens": torch.as_tensor(g.integers(0, cfg.vocab_size, (PER_TASK, PROMPT))).to(dev)}
        if vision:
            b["patch_embeds"] = randn((PER_TASK, PATCHES, cfg.d_model), torch.float32,
                                      SEED + 70 + i)
        batches.append((b, PROMPT + (PATCHES if vision else 0)))
    steps = 4
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        serve = counted(lambda: kernels_vs_plain(
            api, model, kernels.PLAIN, batches, batches[0][1] + FAMILY_NEW, steps,
            (CONSISTENCY_TOL, CONSISTENCY_TOL)))
    want = {kern.name: 0 for kern in kernels.KERNELS}
    want[flash.SM90_FP32_KERNEL.name] = len(batches) * cfg.n_layers
    want[decode.KERNEL.name] = 0 if cfg.attention == "mla" else len(batches) * steps * cfg.n_layers
    expect("prefill and decode", serve, want)
    say(f"  serving peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return {name: train[name] + serve[name] for name in train}


def compare_grads(got, ref, num, den, quiet=False):
    """Per parameter group (``group_of``), ||num|| / ||den||; prints each
    unless ``quiet`` (then per parameter) and returns the largest."""
    acc: dict = {}
    for name in ref:
        grp = name if quiet else group_of(name)
        d = (got[name].float() - ref[name].float()).square().sum()
        r = ref[name].float().square().sum()
        a, b = acc.get(grp, (0.0, 0.0))
        acc[grp] = (a + d, b + r)
    worst = 0.0
    for grp, (d, r) in acc.items():
        rel = (d.sqrt() / r.sqrt().clamp_min(1e-30)).item()
        worst = max(worst, rel)
        if not quiet:
            say(f"    {grp}: ||{num}|| / ||{den}|| {rel:.3e}")
    return worst


# --------------------------------------------------------------------- #
# phase 13: the farm over worker processes
# --------------------------------------------------------------------- #
# Weights cannot ride a program to a worker: qwen3-1.7B's bf16 weights are
# 3.2 GiB, over the wire's 1 GiB frame cap.  So the serve program a worker
# gets carries only (arch, seed, ServeConfig); its first call builds the
# weights on the worker's device from phase 3's seeded generator, and the
# worker process keeps them for its later tasks and connections (a worker
# unpickles a shipped program once per connection, and every round's
# client opens new connections).
_WORKER_MODELS: dict = {}


class WorkerGenerate:
    """Phase 3's serve program, shipped to a worker by reference (as
    ``chip_smoke.WorkerGenerate``: workers import this file)."""

    def __init__(self, arch, seed, sc):
        self.arch, self.seed, self.sc = arch, seed, sc

    def __call__(self, payload):
        dev = payload["tokens"].device  # the worker's service device
        key = (self.arch, self.seed, self.sc, str(dev))
        generate = _WORKER_MODELS.get(key)
        if generate is None:
            import repro_torch.configs as cfgs
            from repro_torch.models import build
            from repro_torch.runtime.serve_loop import make_generate_program

            api = build(cfgs.get(self.arch))
            params = api.init(torch.Generator(device=dev).manual_seed(self.seed))
            generate = make_generate_program(api, self.sc, params).fn
            _WORKER_MODELS[key] = generate
        return generate(payload)


class WorkerLaunches:
    """A worker's kernel launch counts by kernel name (launch counters are
    per process); with ``reset`` every count is set to 0 first."""

    def __init__(self, reset: bool):
        self.reset = reset

    def __call__(self, payload):
        from repro_torch import kernels

        if self.reset:
            for kern in kernels.KERNELS:
                kern.launches = 0
        return {kern.name: kern.launches for kern in kernels.KERNELS}


class WorkerState:
    """A worker's weight builds (models it holds), and the reconnects and
    replayed registrations of the process's ``RemoteLookup`` (a ``tcp://``
    worker's entry point keeps its lookup to itself, so it is found among
    the process's objects)."""

    def __call__(self, payload):
        from repro_torch.core.transport.tcp import RemoteLookup

        lookups = [o for o in gc.get_objects() if type(o) is RemoteLookup]
        return {"builds": len(_WORKER_MODELS), "lookups": len(lookups),
                "reconnects": sum(lk.reconnects for lk in lookups),
                "replayed": sum(lk.replayed_registrations for lk in lookups)}


def worker_programs():
    """The programs phases 13 and 14 ship to workers by reference: serve,
    reset the launch counts, read them, read the worker's state."""
    import chip_smoke  # run as __main__: ship the programs by module name
    from repro_torch.core import Program
    from repro_torch.runtime.serve_loop import ServeConfig

    # workers import chip_smoke: the repo root goes on their PYTHONPATH
    paths = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    if str(ROOT) not in paths:
        os.environ["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + paths)
    sc = ServeConfig(max_new_tokens=NEW, prompt_len=PROMPT,
                     batch_per_task=PER_TASK)
    return (Program(chip_smoke.WorkerGenerate(ARCH, SEED, sc),
                    name=f"generate[{ARCH}]"),
            Program(chip_smoke.WorkerLaunches(True), name="launches-reset",
                    host=True),
            Program(chip_smoke.WorkerLaunches(False), name="launches",
                    host=True),
            Program(chip_smoke.WorkerState(), name="worker-state", host=True))


def worker_round(label, program, prompts, lookup, ref, on_client=None):
    """One farm round over the pool registered in ``lookup``; its tokens
    must equal ``ref`` (phase 3's for the same prompts) bit for bit.
    Returns (wall s, client stats, perf_counter of the first result)."""
    from repro_torch.core import BasicClient

    tasks = [{"tokens": torch.as_tensor(prompts[i:i + PER_TASK])}
             for i in range(0, len(prompts), PER_TASK)]
    out: list = []
    client = BasicClient(program, None, tasks, out, lookup=lookup,
                         speculation=False)
    first: dict = {}

    def watch_first():
        if client.repository.wait_until(lambda s: s["done"] >= 1, timeout=900):
            first["t"] = time.perf_counter()

    threading.Thread(target=watch_first, daemon=True).start()
    if on_client is not None:
        on_client(client)
    t0 = time.perf_counter()
    client.compute(timeout=900)
    wall = time.perf_counter() - t0
    stats = client.stats()
    gen = torch.cat([o["generated"] for o in out], dim=0)
    same = tuple(gen.shape) == tuple(ref.shape) and torch.equal(gen, ref)
    say(f"  {label}: {tuple(gen.shape)} tokens in {wall:.3f} s, "
        f"{gen.numel() / wall:.1f} tok/s; {stats['done']} tasks, "
        f"{stats['reschedules']} reschedules, per worker {stats['per_service']}; "
        f"tokens equal phase 3's: {same}")
    if not same:
        differ = (gen != ref).any(dim=1).nonzero().flatten().tolist() \
            if gen.shape == ref.shape else "shape"
        raise AssertionError(f"{label}: tokens differ from phase 3's "
                             f"(rows {differ})")
    return wall, stats, first.get("t")


def counted_round(label, programs, prompts, lookup, ref, handles, kernels):
    """A warm round with each worker's launch counts zeroed just before and
    read just after (through ``handles``, one per worker): summed over the
    workers, one bf16 flash launch a layer and one decode launch a layer
    and new token, per task, and no other kernel's.  Returns wall s."""
    import repro_torch.configs as cfgs
    from repro_torch.kernels import decode_attention as decode
    from repro_torch.kernels import flash_attention as flash

    program, reset, read, _ = programs
    for h in handles:
        h.execute(reset, None)
    wall, _, _ = worker_round(label, program, prompts, lookup, ref)
    counts = [h.execute(read, None) for h in handles]
    n_tasks = len(prompts) // PER_TASK
    summed = {k.name: sum(c[k.name] for c in counts) for k in kernels.KERNELS}
    say(f"  launches in the workers ({n_tasks} tasks): per worker {counts}")
    want = {k.name: 0 for k in kernels.KERNELS}
    layers = cfgs.get(ARCH).n_layers
    want[flash.SM90_KERNEL.name] = n_tasks * layers
    want[decode.KERNEL.name] = n_tasks * layers * NEW
    if summed != want:
        raise AssertionError(f"worker launches {summed}, expected {want}")
    return wall


def kill_round(label, program, prompts, lookup, ref, pool):
    """A round in which the pool's worker 0 is SIGKILLed after its first
    task, once it holds another lease (or nothing is pending); at least
    one task must be rescheduled.  Returns wall s."""
    victim = pool.workers[0].service_id
    killed = threading.Event()

    def arm(client):
        def killer():
            if client.repository.wait_until(
                    lambda s: s["per_service"].get(victim, 0) >= 1
                    and (s["leased"] >= 2 or s["pending"] == 0),
                    timeout=900):
                pool.kill(0)  # SIGKILL: no goodbye
                killed.set()
        threading.Thread(target=killer, daemon=True).start()

    wall, stats, _ = worker_round(label, program, prompts, lookup, ref,
                                  on_client=arm)
    if not killed.is_set() or pool.workers[0].alive:
        raise AssertionError(f"worker 0 was not killed during {label}")
    if stats["reschedules"] < 1:
        raise AssertionError(f"no task was rescheduled after the kill ({label})")
    return wall


def worker_phase(prompts, ref_gen, kernels):
    """Phase 13: phase 3's load on 2 proc:// workers (cold, warm with the
    workers' launch counts, one worker SIGKILLed), then on 2 shm://
    workers.  Returns each round's wall s and the start-up to first
    result."""
    from repro_torch.core import LookupService, resolve_handle
    from repro_torch.launch.now import NowPool

    programs = worker_programs()
    program = programs[0]
    lookup = LookupService()
    t_start = time.perf_counter()
    with NowPool(WORKERS, lookup, service_prefix="gpu-proc") as pool:
        cold, _, t_first = worker_round(
            f"round 1 (cold) on {WORKERS} proc:// workers", program, prompts,
            lookup, ref_gen)
        startup = t_first - t_start
        say(f"  worker start-up to first result: {startup:.3f} s (pool "
            f"start, torch import, CUDA context, weight build, first task)")
        handles = [resolve_handle(w.descriptor) for w in pool.workers]
        try:
            warm = counted_round(f"round 2 (warm) on {WORKERS} proc:// workers",
                                 programs, prompts, lookup, ref_gen, handles,
                                 kernels)
        finally:
            for h in handles:
                h.close()
        kill_wall = kill_round("round 3, worker 0 SIGKILLed after its first task",
                               program, prompts, lookup, ref_gen, pool)
    lookup = LookupService()
    with NowPool(WORKERS, lookup, service_prefix="gpu-shm",
                 transport="shm") as pool:
        shm_wall, _, _ = worker_round(
            f"round 4 (cold) on {WORKERS} shm:// workers, {SHM_REQUESTS} "
            "requests", program, prompts[:SHM_REQUESTS], lookup,
            ref_gen[:SHM_REQUESTS])
    from repro_torch.core.transport.shm import detach_all
    detach_all()
    return {"cold": cold, "startup": startup, "warm": warm, "kill": kill_wall,
            "shm": shm_wall}


def tcp_phase(prompts, ref_gen, kernels):
    """Phase 14: phase 3's load on a ``TcpPool`` of 2 tcp:// workers that
    register themselves into a network lookup server; the client's lookup
    is a ``RemoteLookup``.  Rounds: cold; warm with the workers' launch
    counts; after a lookup restart (registry wiped, every connection
    dropped) once both workers have re-registered; worker 0 SIGKILLed.
    Returns each round's wall s and the start-up to first result."""
    from repro_torch.core import resolve_handle
    from repro_torch.launch.tcp import TcpPool

    programs = worker_programs()
    program, state = programs[0], programs[3]
    ids = {f"gpu-tcp{i}" for i in range(WORKERS)}

    def registered():
        """Handles of both workers, resolved from the client's lookup."""
        if not pool.lookup.wait_for_services(WORKERS, timeout_s=60):
            raise AssertionError(f"only {len(pool.lookup)} of {WORKERS} tcp "
                                 "workers registered within 60 s")
        descs = pool.lookup.query()
        if {d.service_id for d in descs} != ids:
            raise AssertionError(f"registered {[d.service_id for d in descs]}")
        return [resolve_handle(d) for d in descs]

    t_start = time.perf_counter()
    with TcpPool(WORKERS, service_prefix="gpu-tcp") as pool:
        say(f"  lookup server {pool.lookup_address}; workers "
            f"{[w.address for w in pool.workers]}")
        cold, _, t_first = worker_round(
            f"round 1 (cold) on {WORKERS} tcp:// workers", program, prompts,
            pool.lookup, ref_gen)
        startup = t_first - t_start
        say(f"  worker start-up to first result: {startup:.3f} s (pool "
            "start, torch import, CUDA context, registration, weight build, "
            "first task)")
        handles = registered()
        try:
            warm = counted_round(f"round 2 (warm) on {WORKERS} tcp:// workers",
                                 programs, prompts, pool.lookup, ref_gen,
                                 handles, kernels)
            before = {h.service_id: h.execute(state, None) for h in handles}
        finally:
            for h in handles:
                h.close()

        t0 = time.perf_counter()
        pool.server.restart()  # registry wiped, every connection dropped
        for h in registered():
            h.close()
        say(f"  lookup restarted: both workers re-registered in "
            f"{time.perf_counter() - t0:.3f} s; client lookup reconnects "
            f"{pool.lookup.reconnects}")
        restart, stats, _ = worker_round(
            "round 3, after the lookup restart", program, prompts,
            pool.lookup, ref_gen)
        served = {sid: stats["per_service"].get(sid, 0) for sid in sorted(ids)}
        if min(served.values()) < 1:
            raise AssertionError(f"a re-registered worker served no task: {served}")
        handles = registered()
        try:
            after = {h.service_id: h.execute(state, None) for h in handles}
        finally:
            for h in handles:
                h.close()
        say(f"  workers' state before the restart {before}, after round 3 "
            f"{after}")
        for sid, s in after.items():
            if (s["builds"] != 1 or s["reconnects"] <= before[sid]["reconnects"]
                    or s["replayed"] <= before[sid]["replayed"]):
                raise AssertionError(f"{sid} rebuilt its weights, or did not "
                                     "reconnect and replay its registration")

        kill_wall = kill_round("round 4, worker 0 SIGKILLed after its first task",
                               program, prompts, pool.lookup, ref_gen, pool)
    return {"cold": cold, "startup": startup, "warm": warm, "restart": restart,
            "kill": kill_wall}


# --------------------------------------------------------------------- #
# phase 21: model programs under Service.execute_batch
# --------------------------------------------------------------------- #
def counted_fold(kern, entry, fn, *args):
    """``torch.func.vmap(fn)(*args)``, which must launch ``kern`` once and
    call ``entry``'s vmap rule once."""
    from repro_torch.kernels import batched

    before, calls = kern.launches, batched.RULE_CALLS[entry]
    out = torch.func.vmap(fn)(*args)
    launched, ruled = kern.launches - before, batched.RULE_CALLS[entry] - calls
    if launched != 1 or ruled != 1:
        raise AssertionError(f"{entry} under vmap launched {kern.name} {launched} times "
                             f"through {ruled} rule calls; expected 1 and 1")
    return out


def fold_checks(flash, decode, scan, widths):
    """Phase 21's direct check: each kernel entry under torch.func.vmap on
    BATCH_TASKS stacked tasks at every serve shape of FLASH_SHAPES and
    DECODE_SHAPES, and the scan at ``widths`` (b = PER_TASK, s = PROMPT),
    against BATCH_TASKS per-task launches of the same kernel: one folded
    launch and one rule call each; flash and the scan bit-identical, decode
    within BATCH_DECODE_TOL (its KV split counts printed)."""
    n = BATCH_TASKS
    for label, (B, sq, skv, H, K, D, Dv, causal, dtypes) in FLASH_SHAPES.items():
        for dt in dtypes:
            q = randn((n, B, sq, H, D), dt, 21)
            k = randn((n, B, skv, K, D), dt, 22)
            v = randn((n, B, skv, K, Dv), dt, 23)
            out, lse = counted_fold(flash.forward_kernel(dt), "flash_attention_fwd",
                                    lambda a, b, c: flash.flash_attention_fwd(
                                        a, b, c, causal=causal), q, k, v)
            per = [flash.flash_attention_fwd(q[i], k[i], v[i], causal=causal)
                   for i in range(n)]
            diff = max(max((out[i].float() - o.float()).abs().max().item(),
                           (lse[i] - l).abs().max().item()) for i, (o, l) in enumerate(per))
            same = all(torch.equal(out[i], o) and torch.equal(lse[i], l)
                       for i, (o, l) in enumerate(per))
            say(f"  folded flash {label} {str(dt)[6:]}: one launch at B={n * B} against "
                f"{n} launches at B={B}: {'bit-identical' if same else 'DIFFERENT'} "
                f"(out and lse, largest |diff| {diff:.3e})")
            if not same:
                raise AssertionError(f"folded flash {label} {dt} is not bit-identical to "
                                     "its per-task launches")
    splits = kernel_entry(decode.KERNEL, "_splits", 4)
    for label, (B, H, K, D, slots, ci, dtypes) in DECODE_SHAPES.items():
        for dt in dtypes:
            qd = randn((n, B, 1, H, D), dt, 24)
            kc = randn((n, B, slots, K, D), dt, 25)
            vc = randn((n, B, slots, K, D), dt, 26)
            got = counted_fold(decode.KERNEL, "decode_attention_fwd",
                               lambda a, b, c: decode.decode_attention_fwd(
                                   a, b, c, cache_index=ci), qd, kc, vc)
            per = torch.stack([decode.decode_attention_fwd(qd[i], kc[i], vc[i],
                                                           cache_index=ci)
                               for i in range(n)])
            tol = BATCH_DECODE_TOL[dt]
            check(f"folded decode {label} {str(dt)[6:]} cache_index {ci}: one launch at "
                  f"B={n * B} ({splits(n * B, H, K, ci)} KV splits) against {n} at B={B} "
                  f"({splits(B, H, K, ci)} KV splits); bit-identical "
                  f"{torch.equal(got, per)}", got, per, tol, tol)
    for d, nstate in widths:
        xs = [scan_inputs(PER_TASK, PROMPT, d, nstate, 30 + 10 * i) for i in range(n)]
        A = xs[0][2]  # one A for every task, as the weights give it
        x, dt, B, C = (torch.stack([t[j] for t in xs]) for j in (0, 1, 3, 4))
        y, hf = counted_fold(scan.KERNEL, "mamba_scan",
                             lambda a, b, c, e: scan.mamba_scan(a, b, A, c, e),
                             x, dt, B, C)
        per = [scan.mamba_scan_fwd(x[i], dt[i], A, B[i], C[i]) for i in range(n)]
        same = all(torch.equal(y[i], a) and torch.equal(hf[i], b)
                   for i, (a, b) in enumerate(per))
        diff = max(max((y[i] - a).abs().max().item(), (hf[i] - b).abs().max().item())
                   for i, (a, b) in enumerate(per))
        say(f"  folded scan d={d}: one launch at b={n * PER_TASK} against {n} launches at "
            f"b={PER_TASK}: {'bit-identical' if same else 'DIFFERENT'} (y and h_final, "
            f"largest |diff| {diff:.3e})")
        if not same:
            raise AssertionError(f"folded scan d={d} is not bit-identical to its per-task "
                                 "launches")
        del x, dt, B, C, y, hf, per, xs
    torch.cuda.synchronize()


def launch_counts(kernels):
    from repro_torch.kernels import batched

    out = {kern.name: kern.launches for kern in kernels.KERNELS}
    out.update({f"rule {k}": v for k, v in batched.RULE_CALLS.items()})
    return out


def zero_counts(kernels):
    from repro_torch.kernels import batched

    for kern in kernels.KERNELS:
        kern.launches = 0
    batched.reset_rule_calls()


def one_task_launches(cfg, steps, kernels):
    """A task's exact launches through prefill and ``steps`` decode steps:
    one flash forward (of the compute dtype) an attention layer, one decode
    an attention layer and step (none for MLA's absorbed decode), one scan
    a Mamba layer; and the rule calls a batched call adds, one a launch."""
    from repro_torch.kernels import decode_attention as decode
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import mamba_scan as scan

    attn = sum(b.mixer == "attn" for b in cfg.pattern) * cfg.n_repeats
    mamba = cfg.n_layers - attn
    want = {kern.name: 0 for kern in kernels.KERNELS}
    want[flash.forward_kernel(cfg.dtype).name] = attn
    want[decode.KERNEL.name] = 0 if cfg.attention == "mla" else attn * steps
    want[scan.KERNEL.name] = mamba
    rules = {"rule flash_attention_fwd": attn,
             "rule decode_attention_fwd": want[decode.KERNEL.name],
             "rule mamba_scan": mamba}
    return want, rules


def batch_logits_program(api, params, steps):
    """A task's prefill and ``steps`` decode steps fed the payload's
    ``feed`` tokens: {"logits": (B, steps + 1, V), "choices": each MoE
    routing's own top-k choices}.  With ``pins`` in the payload (another
    run's choices, in call order) each routing takes the pinned choices in
    place of its own and gathers its gates from its own probabilities."""
    from repro_torch.core import Program
    from repro_torch.models import moe

    def fn(payload):
        own, pins, choose = [], list(payload.get("pins", ())), moe.top_k

        def top_k(probs, k):
            gate, idx = choose(probs, k)
            own.append(idx)
            if pins:
                idx = pins[len(own) - 1]
                gate = probs.gather(-1, idx)
            return gate, idx

        moe.top_k = top_k
        try:
            logits, caches = api.prefill(params, {"tokens": payload["tokens"]},
                                         seq_budget=PROMPT + steps)
            out = [logits]
            for i in range(steps):
                logits, caches = api.decode(params, {"tokens": payload["feed"][:, i:i + 1],
                                                     "cache_index": PROMPT + i}, caches)
                out.append(logits)
        finally:
            moe.top_k = choose
        return {"logits": torch.stack(out, 1), "choices": own}

    return Program(fn, name=f"logits[{api.cfg.name}]")


def batched_logits(label, api, params, dev, kernels, limits):
    """Per task against batched on one Service: BATCH_TASKS tasks of
    PER_TASK prompts through ``batch_logits_program`` one at a time, then
    as one ``execute_batch``.  Each launch count of the batched call must
    equal one task's (and the rule calls its launches); the |logits
    difference| at the prefill and each decode step is held to ``limits``
    (largest, mean over the tasks); an MoE model's batched choices are
    pinned to the per-task ones, its own flips held to
    ROUTING_LIMITS["pinned"].  Returns the batched call's launch counts."""
    from repro_torch.core import Service

    cfg = api.cfg
    rng = np.random.default_rng(SEED + 21)
    payloads = [{"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                        (PER_TASK, PROMPT))),
                 "feed": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                      (PER_TASK, BATCH_STEPS)),
                                         dtype=torch.int32)} for _ in range(BATCH_TASKS)]
    prog = batch_logits_program(api, params, BATCH_STEPS)
    svc = Service(None, device=dev)
    want, rules = one_task_launches(cfg, BATCH_STEPS, kernels)
    per = []
    for i, p in enumerate(payloads):
        zero_counts(kernels)
        per.append(svc.execute(prog, p))
        got = launch_counts(kernels)
        if any(got[k] != v for k, v in want.items()) or any(got[k] for k in rules):
            raise AssertionError(f"{label} task {i}: launches {got}, expected {want} and no "
                                 "rule call")
    if per[0]["choices"]:
        for p, r in zip(payloads, per):
            p["pins"] = r["choices"]
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    t0 = time.perf_counter()
    bat = svc.execute_batch(prog, payloads)
    wall = time.perf_counter() - t0
    got = launch_counts(kernels)
    say(f"  {label}: batched call of {BATCH_TASKS} tasks (prefill + {BATCH_STEPS} decode "
        f"steps, {wall:.3f} s): launches {got}; one task's {want}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if any(got[k] != v for k, v in {**want, **rules}.items()):
        raise AssertionError(f"{label}: a batched call's launches {got} differ from one "
                             f"task's {want} (rule calls {rules})")
    max_lim, mean_lim = limits
    for s in range(BATCH_STEPS + 1):
        a = torch.stack([r["logits"][:, s] for r in per])
        b = torch.stack([r["logits"][:, s] for r in bat])
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{label}: non-finite logits")
        diff = (a - b).abs()
        err, mean = diff.max().item(), diff.mean().item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        name = "prefill" if s == 0 else f"decode at {PROMPT + s - 1}"
        say(f"    {name} logits, batched vs per task: max |diff| {err:.3e} (limit "
            f"{max_lim:g}), mean |diff| {mean:.3e} (limit {mean_lim:g}), greedy tokens "
            f"agree on {agree:.3f} of rows")
        if not (err <= max_lim and mean <= mean_lim):
            raise AssertionError(f"{label} {name}: batched logits disagree with per-task")
    if per[0]["choices"]:
        flips = total = 0
        for r_per, r_bat in zip(per, bat):
            for a, b in zip(r_per["choices"], r_bat["choices"]):
                flips += int((a != b).sum())
                total += a.numel()
        say(f"    routing: {flips} of {total} (token, choice) top-k choices the batched "
            f"router makes otherwise on the pinned path ({flips / total:.4f}; limit "
            f"{ROUTING_LIMITS['pinned']})")
        if flips / total > ROUTING_LIMITS["pinned"]:
            raise AssertionError(f"{label}: the batched routing flips too many choices")
    svc.drop_programs()
    return got


def time_batched(api, params, tokens, new, one):
    """The batched prefill and decode step of ``tokens`` (N, B, PROMPT) on
    the card as one torch.func.vmap call each, CUDA events, median of
    TIMED_ROUNDS rounds of a prefill and ``new`` steps after an untimed
    one; then one profiled of each, printed beside ``one`` (a task alone,
    phase 3's ``time_one_task``)."""
    n, budget = tokens.shape[0], PROMPT + new
    prefill = torch.func.vmap(lambda t: api.prefill(params, {"tokens": t},
                                                    seq_budget=budget))

    def step(nxt, caches, ci):
        return torch.func.vmap(lambda t, c: api.decode(
            params, {"tokens": t, "cache_index": ci}, c)[0])(nxt, caches)

    times = []
    for r in range(TIMED_ROUNDS + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        logits, caches = prefill(tokens)
        ev[1].record()
        for i in range(new):
            logits = step(torch.argmax(logits, -1).to(torch.int32)[..., None], caches,
                          PROMPT + i)
        ev[2].record()
        torch.cuda.synchronize()
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite batched logits")
        if r:
            times.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]) / new))
    pre, dec = float(np.median([t[0] for t in times])), float(np.median([t[1] for t in times]))
    idle_p = profile_window(f"batched prefill of {n} tasks", lambda i: prefill(tokens), 2)
    _, caches = prefill(tokens)
    nxt = tokens[..., -1:].to(torch.int32)
    idle_d = profile_window(f"batched decode step of {n} tasks",
                            lambda i: step(nxt, caches, PROMPT + i), 4)

    def idle(x):
        return "not measured" if x is None else f"{x:.3f}"

    say(f"  {n} tasks batched, median of {TIMED_ROUNDS} rounds: prefill {pre:.3f} ms "
        f"(rounds {', '.join(f'{t[0]:.3f}' for t in times)}; idle {idle(idle_p)}), decode "
        f"{dec:.3f} ms per step ({new} steps; rounds "
        f"{', '.join(f'{t[1]:.3f}' for t in times)}; idle {idle(idle_d)}); one task alone "
        f"(phase 3): prefill {one['prefill_ms']:.3f} ms (idle {idle(one['idle'][0])}), "
        f"decode {one['decode_ms']:.3f} ms per step (idle {idle(one['idle'][1])}); per task "
        f"batched: prefill {pre / n:.3f} ms, decode {dec / n:.3f} ms per step")


def batched_farm(cfg, dev):
    """BATCH_FARM_TASKS tasks of PER_TASK prompts through BasicClient on
    SERVICES fresh in-process services, at max_batch 4 (batches of 4 leased
    and run by execute_batch; the adaptive controller off) and at 1, with
    ``cfg`` cut to TRAIN_LAYERS layers: tok/s of each, a reading, not a
    claim."""
    from repro_torch.core import BasicClient, LookupService, Service
    from repro_torch.models import build
    from repro_torch.runtime.serve_loop import ServeConfig, make_generate_program

    cfg = cfg.replace(n_layers=TRAIN_LAYERS)
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(SEED))
    say(f"  farm reading on {cfg.name} cut to {cfg.n_layers} layers; reduced: "
        + json.dumps([f"n_layers 28 -> {cfg.n_layers} for the farm reading, widths as "
                      "published"]))
    lookup = LookupService()
    services = [Service(lookup, device=dev) for _ in range(SERVICES)]
    for svc in services:
        svc.start()
    prompts = np.random.default_rng(SEED + 22).integers(
        0, api.cfg.vocab_size, (BATCH_FARM_TASKS * PER_TASK, PROMPT))
    tasks = [{"tokens": torch.as_tensor(prompts[i:i + PER_TASK])}
             for i in range(0, len(prompts), PER_TASK)]
    program = make_generate_program(
        api, ServeConfig(max_new_tokens=BATCH_FARM_NEW, prompt_len=PROMPT,
                         batch_per_task=PER_TASK), params)
    gens = {}
    for mb in (4, 1):
        out = []
        client = BasicClient(program, None, tasks, out, lookup=lookup, max_batch=mb,
                             adaptive_batching=False)
        t0 = time.perf_counter()
        client.compute(timeout=900)
        wall = time.perf_counter() - t0
        stats = client.stats()
        gens[mb] = torch.cat([o["generated"].cpu() for o in out])
        batches = (sum(b["batches_dispatched"] for b in stats["batching"].values())
                   if "batching" in stats else stats["done"])
        say(f"  farm, max_batch={mb}: {BATCH_FARM_TASKS} tasks x {PER_TASK} requests x "
            f"{BATCH_FARM_NEW} new tokens in {wall:.3f} s: {gens[mb].numel() / wall:.1f} tok/s "
            f"on {SERVICES} services; {stats['done']} tasks done in {batches} calls, "
            f"{stats['reschedules']} reschedules")
        if stats["done"] != BATCH_FARM_TASKS or tuple(gens[mb].shape) != (
                BATCH_FARM_TASKS * PER_TASK, BATCH_FARM_NEW):
            raise AssertionError(f"the farm at max_batch={mb} did not complete")
    differ = int((gens[4] != gens[1]).sum())
    say(f"  farm tokens, max_batch 4 vs 1: {differ} of {gens[1].numel()} differ (bf16 "
        "near-ties; the logits are held below)")
    free(services)
    for svc in services:
        svc.kill()


def batched_serve_phase(dev, kernels, one):
    """Phase 21 on qwen3-1.7B at full size: the generate program on one
    Service, the same BATCH_TASKS tasks one at a time and as one
    execute_batch (launches exact: one task's, through the rules), timed
    and profiled; per task against batched logits; then the farm at
    max_batch 4 and 1."""
    import repro_torch.configs as cfgs
    from repro_torch.core import Service
    from repro_torch.models import build
    from repro_torch.runtime.serve_loop import ServeConfig, make_generate_program

    cfg = cfgs.get(ARCH)
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(SEED))
    svc = Service(None, device=dev)
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                   (BATCH_TASKS * PER_TASK, PROMPT))
    payloads = [{"tokens": torch.as_tensor(prompts[i:i + PER_TASK])}
                for i in range(0, len(prompts), PER_TASK)]
    gen = make_generate_program(api, ServeConfig(max_new_tokens=NEW, prompt_len=PROMPT,
                                                 batch_per_task=PER_TASK), params)
    warm = make_generate_program(api, ServeConfig(max_new_tokens=2, prompt_len=PROMPT,
                                                  batch_per_task=PER_TASK), params)
    svc.execute(warm, payloads[0])
    svc.execute_batch(warm, payloads)
    want, rules = one_task_launches(cfg, NEW, kernels)
    zero_counts(kernels)
    t0 = time.perf_counter()
    per = [svc.execute(gen, p) for p in payloads]
    wall_per = time.perf_counter() - t0
    got_per = launch_counts(kernels)
    zero_counts(kernels)
    t0 = time.perf_counter()
    bat = svc.execute_batch(gen, payloads)
    wall_bat = time.perf_counter() - t0
    got = launch_counts(kernels)
    tok = BATCH_TASKS * PER_TASK * NEW
    say(f"  {cfg.name}: {BATCH_TASKS} tasks one at a time in {wall_per:.3f} s "
        f"({tok / wall_per:.1f} tok/s), launches {got_per}")
    say(f"  {cfg.name}: the same {BATCH_TASKS} tasks as one execute_batch in "
        f"{wall_bat:.3f} s ({tok / wall_bat:.1f} tok/s), launches {got}; one task's {want}")
    if any(got_per[k] != BATCH_TASKS * v for k, v in want.items()) or any(
            got_per[k] for k in rules):
        raise AssertionError("the per-task runs' launches changed")
    if any(got[k] != v for k, v in {**want, **rules}.items()):
        raise AssertionError("the batched call's launches are not one task's, through "
                             "the rules")
    differ = sum(int((a["generated"] != b["generated"]).sum()) for a, b in zip(per, bat))
    gen_b = torch.cat([b["generated"].cpu() for b in bat])
    if not (int(gen_b.min()) >= 0 and int(gen_b.max()) < cfg.vocab_size) or tuple(
            gen_b.shape) != (BATCH_TASKS * PER_TASK, NEW):
        raise AssertionError("batched generated tokens out of range or of the wrong shape")
    say(f"  greedy tokens, batched vs per task: {differ} of {gen_b.numel()} differ (a bf16 "
        "near-tie flips a token and what follows; the logits are held below)")
    time_batched(api, params, torch.stack([p["tokens"] for p in payloads]).to(dev),
                 BATCH_TIMED_NEW, one)
    batched_logits(f"{cfg.name} bf16, {cfg.n_layers} layers", api, params, dev, kernels,
                   BATCH_QWEN3_LIMITS)
    svc.drop_programs()
    del api, params, gen, warm
    gc.collect()
    torch.cuda.empty_cache()
    batched_farm(cfg, dev)


def batched_family(arch, layers, dtype, limits, dev, kernels):
    """Phase 21 on one model of BATCH_MODELS, at full width, depth cut to
    ``layers``, in ``dtype``: per task against batched logits and launches
    (``batched_logits``)."""
    import repro_torch.configs as cfgs
    from repro_torch.models import build

    full = cfgs.get(arch)
    cfg = full.replace(n_layers=layers)
    if dtype == torch.float32:
        cfg = cfg.replace(param_dtype="float32", compute_dtype="float32")
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    say(f"  {cfg.name} in {str(dtype)[6:]}: {cfg.n_layers} of {full.n_layers} layers, "
        f"d_model {cfg.d_model}, {sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
        "params; reduced: " + json.dumps([f"n_layers {full.n_layers} -> {cfg.n_layers} "
                                          "for phase 21, widths as published"]))
    batched_logits(f"{cfg.name} {str(dtype)[6:]}, {cfg.n_layers} layers", api, params, dev,
                   kernels, limits)
    del api, params
    gc.collect()
    torch.cuda.empty_cache()


def per_row_scan_checks(scan):
    """Phase 24's direct check: the scan kernel with A (b, d, n), one
    matrix a batch row (how a folded batch of training tasks gives it),
    against the plain scan at phase 9's limits; and with every row's A the
    shared one, the (b, d, n) launch bit-identical to the stride-0 launch
    of the (d, n) matrix."""
    for b, s, d, n in BATCH_SCAN_SHAPES:
        x, dt, A, B, C = scan_inputs(b, s, d, n, 61)
        rows = torch.stack([A * (1.0 + 0.1 * i) for i in range(b)])
        got, ref = scan.mamba_scan_fwd(x, dt, rows, B, C), scan.mamba_scan_plain(x, dt, rows, B, C)
        for name, a, r in zip(("y", "h_final"), got, ref):
            check(f"scan one A a row ({b}, {s}, {d}, {n}) {name}", a, r, SCAN_TOL, SCAN_TOL)
        shared = scan.mamba_scan_fwd(x, dt, A, B, C)
        strided = scan.mamba_scan_fwd(x, dt, A.expand(b, d, n), B, C)
        same = all(torch.equal(a, r) for a, r in zip(strided, shared))
        say(f"  scan ({b}, {s}, {d}, {n}): the shared A as one a row (batch stride d n) "
            f"against the stride-0 launch: {'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError("the scan reads a row's A otherwise than the shared A")
        del x, dt, A, B, C, rows, got, ref, shared, strided
    torch.cuda.synchronize()


def device_batch(batch, dev):
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def worst_group_delta(got, ref) -> float:
    """The largest per-group (``group_of``) ||got - ref|| / ||ref||."""
    acc: dict = {}
    for name in ref:
        d = (got[name].float() - ref[name].float()).square().sum()
        r = ref[name].float().square().sum()
        a, b = acc.get(group_of(name), (0.0, 0.0))
        acc[group_of(name)] = (a + d, b + r)
    return max((d.sqrt() / r.sqrt().clamp_min(1e-30)).item() for d, r in acc.values())


def round_launches(cfg, dtype, kernels):
    """One task's launches in a round of FARM_INNER steps: each attention
    layer's forward (twice with remat) and its dq and dk/dv, each Mamba
    layer's scan (twice with remat); and the rule calls a batched call
    makes for them, one a launch."""
    n_attn = sum(s.mixer == "attn" for s in cfg.pattern) * cfg.n_layers // len(cfg.pattern)
    again = 2 if cfg.remat else 1
    fwd, dq, dkv = BF16_TRAIN_KERNELS if dtype == torch.bfloat16 else FP32_TRAIN_KERNELS
    want = {kern.name: 0 for kern in kernels.KERNELS}
    want.update({fwd: FARM_INNER * n_attn * again, dq: FARM_INNER * n_attn,
                 dkv: FARM_INNER * n_attn,
                 "mamba_scan_sm90": FARM_INNER * (cfg.n_layers - n_attn) * again})
    rules = {"rule flash_attention_fwd": want[fwd], "rule flash_attention_bwd": want[dq],
             "rule decode_attention_fwd": 0, "rule mamba_scan": want["mamba_scan_sm90"]}
    return want, rules


def batched_train_case(arch, layers, dtype, tasks, experts, limits, dev, kernels):
    """Phase 24 on one configuration of BATCH_TRAIN: the round's ``tasks``
    tasks as one execute_batch (after a first, cold call) and one at a
    time: launches, wall times, peak memory; each task's round loss, and
    the loss of a held-out batch after its batched and its per-task delta,
    within the loss limit; the deltas' per-group difference read; one
    inner step's gradients of each task, batched against per task, within
    the gradient limit (phase 7's metric); qwen3 in bf16 then through
    BasicClient.  Returns the batched call's launch counts."""
    import repro_torch.configs as cfgs
    from repro_torch.core import BasicClient, LookupService, Service
    from repro_torch.models import build
    from repro_torch.models.registry import skeleton
    from repro_torch.runtime.local_sgd import (LocalSGDConfig, make_local_round_program,
                                               markov_batch)
    from repro_torch.runtime.train_loop import TrainConfig, functional_loss_and_grads

    full = cfgs.get(arch)
    cfg = full.replace(n_layers=layers)
    cuts = [f"n_layers {full.n_layers} -> {layers}"]
    if experts is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=experts))
        cuts.append(f"n_experts {full.moe.n_experts} -> {experts}")
    if dtype == torch.float32:
        cfg = cfg.replace(param_dtype="float32", compute_dtype="float32")
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(SEED))
    params.head().drop_f32()
    n = sum(p.numel() for p in params.parameters())
    wb = params.embed.table.element_size()
    mb = {"float32": 8, "bfloat16": 4, "int8": 2 + 16 / 256}[cfg.opt_state_dtype]
    table = 2 * cfg.vocab_size * cfg.d_model * 4
    reckoned = (n * wb + tasks * (n * (3 * wb + mb) + table)) / 1e9
    say(f"  {cfg.name} in {str(dtype)[6:]}: {n / 1e9:.3f} B params, {tasks} tasks of "
        f"{FARM_INNER} AdamW steps ({cfg.opt_state_dtype} moments{', remat' if cfg.remat else ''}) "
        f"on {FARM_BATCH} x {TRAIN_SEQ} tokens; reduced: "
        + json.dumps(cuts + ["widths as published"])
        + f"; reckoned peak {reckoned:.1f} GB (the client's weights; a task's stacked copy, "
          "working copy, gradients and moments; its fp32 loss table and table gradient)")
    tc = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=100, seed=SEED)
    ls = LocalSGDConfig(inner_steps=FARM_INNER, n_shards=tasks, batch_per_shard=FARM_BATCH,
                        seq_len=TRAIN_SEQ)
    perm = np.random.default_rng(SEED).permutation(cfg.vocab_size).astype("int32")
    program = make_local_round_program(api, tc, ls, perm, skeleton=params)
    weights = dict(params.named_parameters())
    payloads = [{"params": weights, "round": 0, "shard": i} for i in range(tasks)]
    svc = Service(None, device=dev)
    want, rules = round_launches(cfg, dtype, kernels)

    def run(fn):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, wall, launch_counts(kernels), torch.cuda.max_memory_allocated() / 1e9

    _, wall_cold, _, _ = run(lambda: svc.execute_batch(program, payloads))
    bat, wall_bat, got, peak_bat = run(lambda: svc.execute_batch(program, payloads))
    say(f"  {tasks} tasks as one execute_batch: {wall_bat:.3f} s (the first call "
        f"{wall_cold:.3f} s), peak {peak_bat:.2f} GB, launches {got}")
    if any(got[k] != v for k, v in {**want, **rules}.items()):
        raise AssertionError(f"{cfg.name}: the batched round's launches are not one task's, "
                             "through the rules")
    loss_lim, grad_lim = limits
    sk = skeleton(params)
    held_out = device_batch(markov_batch(perm, SEED, 99, 0, 0, FARM_BATCH, TRAIN_SEQ), dev)

    def held_out_loss(delta):
        with torch.no_grad():
            moved = {k: (p.float() + delta[k]).to(p.dtype) for k, p in weights.items()}
            return torch.func.functional_call(sk, moved, (held_out,))[0].item()

    before = held_out_loss({k: torch.zeros((), device=dev) for k in weights})
    # the same tasks one at a time, each compared with its batched result and
    # freed before the next (a task's fp32 delta is 10.8 GB for llama4)
    wall_per, got_per, peak_per = 0.0, {}, 0.0
    for i, (payload, b) in enumerate(zip(payloads, bat)):
        p, wall, counts, peak = run(lambda: svc.execute(program, payload))
        wall_per, peak_per = wall_per + wall, max(peak_per, peak)
        got_per = {k: got_per.get(k, 0) + v for k, v in counts.items()}
        dloss = abs(b["loss"].item() - p["loss"].item())
        after_b, after_p = held_out_loss(b["delta"]), held_out_loss(p["delta"])
        worst = worst_group_delta(b["delta"], p["delta"])
        say(f"  task {i}: round loss batched {b['loss'].item():.6f}, per task "
            f"{p['loss'].item():.6f}: |dloss| {dloss:.3e} (limit {loss_lim:g}); a held-out "
            f"batch's loss {before:.6f} before, after the batched delta {after_b:.6f}, after "
            f"the per-task delta {after_p:.6f}: |difference| {abs(after_b - after_p):.3e} (limit "
            f"{loss_lim:g}); largest per-group relative delta difference {worst:.3e} (read, "
            "not held: see BATCH_TRAIN)")
        finite = all(torch.isfinite(d).all() for d in b["delta"].values())
        if not (np.isfinite(b["loss"].item()) and finite and dloss <= loss_lim
                and abs(after_b - after_p) <= loss_lim):
            raise AssertionError(f"{cfg.name}: batched task {i} disagrees with its per-task round")
        del p
    say(f"  the same {tasks} one at a time: {wall_per:.3f} s, peak {peak_per:.2f} GB (the "
        f"batched results held), launches {got_per}; one task's {want}")
    if any(got_per[k] != tasks * v for k, v in want.items()) or any(got_per[k] for k in rules):
        raise AssertionError(f"{cfg.name}: the per-task rounds' launches changed")
    if arch == ARCH and dtype == torch.bfloat16:
        lookup = LookupService()
        farm = Service(lookup, device=dev)
        farm.start()
        out = []
        client = BasicClient(program, None, payloads, out, lookup=lookup, max_batch=tasks,
                             adaptive_batching=False)
        t0 = time.perf_counter()
        client.compute(timeout=600)
        wall = time.perf_counter() - t0
        stats = client.stats()
        calls = sum(b["batches_dispatched"] for b in stats["batching"].values())
        same = all(torch.equal(o["loss"], b["loss"]) and all(
            torch.equal(o["delta"][k], b["delta"][k]) for k in weights) for o, b in zip(out, bat))
        say(f"  BasicClient, max_batch={tasks}, one service: {stats['done']} tasks in {calls} "
            f"call(s), {wall:.3f} s; results equal to the direct call's: {same}")
        if stats["done"] != tasks or calls != 1 or not same:
            raise AssertionError("the farm's batched round is not the direct call")
        farm.drop_programs()
        farm.kill()
        del out
    del bat
    # one inner step's gradients of every task, batched against per task:
    # phase 7's metric, at its limit
    first = [device_batch(markov_batch(perm, SEED, 0, i, 0, FARM_BATCH, TRAIN_SEQ), dev)
             for i in range(tasks)]
    stacked = {k: torch.stack([p] * tasks) for k, p in weights.items()}
    _, _, g_bat = torch.func.vmap(lambda w, b: functional_loss_and_grads(sk, w, b))(
        stacked, {k: torch.stack([f[k] for f in first]) for k in first[0]})
    del stacked
    for i in range(tasks):
        _, _, g_task = functional_loss_and_grads(sk, weights, first[i])
        worst = worst_group_delta({k: g[i] for k, g in g_bat.items()}, g_task)
        say(f"  task {i}: step 0's gradients, batched vs per task: largest per-group relative "
            f"difference {worst:.3e} (limit {grad_lim:g})")
        if not worst <= grad_lim:
            raise AssertionError(f"{cfg.name}: batched task {i}'s gradients disagree")
        del g_task
    del g_bat
    svc.drop_programs()
    del api, params, weights, payloads, program, sk
    gc.collect()
    torch.cuda.empty_cache()
    return got


def batched_train_phase(scan, dev, kernels):
    """Phase 24: the scan with one A a row, then BATCH_TRAIN's rounds.
    Returns each configuration's batched launches by (arch, dtype)."""
    t0 = time.perf_counter()
    say(f"  {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before the phase")
    per_row_scan_checks(scan)
    counts = {}
    for arch, layers, dtype, tasks, experts, limits in BATCH_TRAIN:
        counts[arch, dtype] = batched_train_case(arch, layers, dtype, tasks, experts, limits,
                                                 dev, kernels)
    say(f"  phase 24 took {time.perf_counter() - t0:.1f} s")
    return counts


def examples_phase():
    """Phase 22: the port's three examples on the card at their defaults,
    as a user runs them, side by side (one process each, the kernels this
    checkout built; the serving farm is host-bound, the training run
    device-bound): the serving farm's tenants, the training run's loss
    drop, the autotuner's sim:// sweeps and its dispatch through the
    cache."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    runs = {name: subprocess.Popen([sys.executable, str(ROOT / "examples" / name)], env=env,
                                   cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                   text=True)
            for name in ("torch_serve_farm.py", "torch_train_lm.py", "torch_autotune.py")}
    failed = []
    for name, proc in runs.items():
        try:
            out, err = proc.communicate(timeout=900)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        say(f"  examples/{name}: exit {proc.returncode} after {time.perf_counter() - t0:.1f} s")
        for line in out.splitlines():
            say(f"    {line}")
        if proc.returncode != 0 or not out.rstrip().endswith("OK"):
            say(err[-4000:])
            failed.append(name)
    if failed:
        raise AssertionError(f"examples failed: {failed}")


def flash_name(D, Dv, heads, bq, bk):
    return f"flash_fwd_sm90_kernel<{D}, {Dv}, {heads}, {bq // 64}, {bk}>"


def tune_space_checks(flash, decode, scan, logs, build_s):
    """Phase 23, part 1: the tuning space against the kernels.  For every
    (D, Dv), q-heads a block and tiles of the bf16 forward, the library's
    shared-memory query is the space's ``smem_bytes`` where the space's
    rule builds the instantiation and -1 where it does not; the fp32
    forward's and backward pair's, decode's and the scan's queries equal
    ``smem_bytes`` at every config they take; ptxas reports no spill for
    any instantiation tuning adds (the untuned tiles' own figures printed
    beside them)."""
    from repro_torch.tune import space

    say(f"  kernels built in {build_s:.2f} s (phase 1), every instantiation of the tunable "
        "tiles included")
    records = {}
    for log in logs.values():
        records.update(ptxas_records(log))
    fwd = kernel_entry(flash.SM90_KERNEL, "_smem", 5)
    built = []
    for D, Dv in HEAD_PAIRS:
        for heads in (1, 2):
            shape = {"Sq": PROMPT, "Skv": PROMPT, "H": heads, "K": 1, "D": D, "Dv": Dv}
            for bq in (64, 128):
                for bk in (64, 128):
                    cfg = {"block_q": bq, "block_k": bk}
                    ok = space.flash_instantiated(D, Dv, heads, bq, bk)
                    want = space.smem_bytes("flash_fwd", shape, cfg, "bfloat16") if ok else -1
                    got = fwd(D, Dv, heads, bq, bk)
                    if got != want:
                        raise AssertionError(f"bf16 flash forward ({D}, {Dv}), {heads} heads, "
                                             f"{cfg}: the library's shared memory {got}, the "
                                             f"space's {want}")
                    if ok:
                        built.append((D, Dv, heads, bq, bk, got))
    say(f"  bf16 flash forward: {len(built)} instantiations built of {len(HEAD_PAIRS) * 16}, "
        "each one's shared memory the space's smem_bytes, the others refused by both: " +
        ", ".join(f"({D}, {Dv}) x{h} {bq}x{bk} {b:,} B" for D, Dv, h, bq, bk, b in built
                  if (bq, bk) != (64, 64)))
    tile_smem_queries(flash)  # the fp32 forward's and both pairs', as phase 1
    ring = kernel_entry(decode.KERNEL, "_smem", 2)
    for D in (32, 64, 96, 128):
        for name, code in (("float32", 0), ("bfloat16", 1)):
            want = space.smem_bytes("decode", {"D": D}, {"splits": 1}, name)
            if ring(D, code) != want:
                raise AssertionError(f"decode D={D} {name}: ring {ring(D, code)}, space {want}")
    tiles = kernel_entry(scan.KERNEL, "_smem", 2)
    for n in (4, 8, 16, 32):
        for lanes in (0, 1, 2, 3, 4):
            try:
                space.validate_config("mamba", {"n": n}, {"lanes": lanes or
                                                           space.scan_geometry(n)[0]}, "cuda")
                want = space.smem_bytes("mamba", {"n": n}, {"lanes": lanes})
            except space.KernelConfigError:
                want = -1
            if tiles(n, lanes) != want:
                raise AssertionError(f"scan n={n} lanes={lanes}: ring {tiles(n, lanes)}, "
                                     f"space {want}")
    say("  fp32 forward, bf16 and fp32 backward pairs, decode, scan: each library's shared "
        "memory the space's smem_bytes at every config it takes")
    if not records:
        raise AssertionError("no ptxas report: phase 1 found the kernels built already")
    # (instantiation, whether tuning adds it): every bf16 forward built,
    # the scan's three at n = 16, decode's at the sweeps' shape, and every
    # instantiation of the fp32 forward and both pairs (those of the
    # untuned tiles are today's)
    reach = ([(flash_name(D, Dv, h, bq, bk), (bq, bk) != (64, 64))
              for D, Dv, h, bq, bk, _ in built]
             + [(f"scan_sm90_kernel<{lanes}, {16 // lanes}>", lanes == 4)
                for lanes in (1, 2, 4)]
             + [("decode_sm90_kernel<bf16, 128, 2>", False)])
    untuned = {"flash_fwd_sm90_fp32_kernel": lambda t: t[-2:] == [1, 32],
               "flash_bwd_dq_sm90_kernel": lambda t: t[-2:] == [1, 64],
               "flash_bwd_dkv_sm90_kernel": lambda t: t[-2:] == [64, 32],
               "flash_bwd_dq_sm90_fp32_kernel": lambda t: t[-1] == 32,
               "flash_bwd_dkv_sm90_fp32_kernel": lambda t: t[-1] == 16}
    for name in records:
        kern, _, args = name.partition("<")
        if kern in untuned:
            reach.append((name, not untuned[kern]([int(x) for x in args[:-1].split(", ")])))
    spilled, added = [], 0
    for name, new in reach:
        regs, stores, _, _ = records[name]
        added += new
        say(f"  {name}: {regs} registers, {stores} bytes spill stores "
            f"({'tuning adds it' if new else 'untuned'})")
        if new and stores:
            spilled.append(name)
    say(f"  {added} instantiations tuning adds, none of which may spill")
    if spilled:
        raise AssertionError(f"instantiations tuning adds spill: {spilled}")


def worst_ratio(got, ref, rtol, atol):
    """(largest |got - ref|, largest |got - ref| / (atol + rtol |ref|))."""
    diff = (got.float() - ref.float()).abs()
    return diff.max().item(), (diff / (atol + rtol * ref.float().abs())).max().item()


def tiles_check(flash, label, kernel, dtype, shape, cands):
    """Phase 23, part 2, for the fp32 forward's and the pairs' sweeps:
    every candidate at the sweep's shape and at TUNE_RAGGED_FLASH's
    (forward) or TUNE_RAGGED_BWD's (pairs) sizes, held to the plain
    version with phase 2's (forward) or phase 5's (pairs) element check,
    each kernel launched once a call; the untuned call bit-identical to
    an explicit call at the untuned tiles; the pairs' results bit-identical
    on a second launch.  A line a size: the worst candidate's ratio."""
    from repro_torch.tune import default_config

    dt = getattr(torch, dtype)
    default = default_config(kernel, "cuda", dtype)
    kerns = ((flash.forward_kernel(dt),) if kernel == "flash_fwd"
             else flash.backward_kernels(dt))
    ragged = TUNE_RAGGED_FLASH if kernel == "flash_fwd" else TUNE_RAGGED_BWD
    for B, sq, skv, causal in [(shape["B"], shape["Sq"], shape["Skv"], True)] + list(ragged):
        q = randn((B, sq, shape["H"], shape["D"]), dt, 61)
        k = randn((B, skv, shape["K"], shape["D"]), dt, 62)
        v = randn((B, skv, shape["K"], shape["Dv"]), dt, 63)
        tag = f"{label} B={B} Sq={sq} Skv={skv} {'causal' if causal else 'non-causal'}"
        if kernel == "flash_fwd":
            ref = flash.flash_attention_plain(q, k, v, causal=causal)
            untuned = flash.flash_attention_fwd(q, k, v, causal=causal)
            run = lambda c: flash.flash_attention_fwd(q, k, v, causal=causal, **c)  # noqa: E731
            limits = ((RTOL[dt], ATOL), (0.0, ATOL))
        else:
            g = randn((B, sq, shape["H"], shape["Dv"]), dt, 64)
            out, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
            ref = flash.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal)
            untuned = flash.flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
            run = lambda c: flash.flash_attention_bwd(  # noqa: E731
                q, k, v, out, lse, g, causal=causal, **c)
            limits = ((RTOL[dt], BWD_ATOL),) * 3
        worst, err = (0.0, None), 0.0
        for c in cands:
            before = [kern.launches for kern in kerns]
            got = run(c)
            if [kern.launches for kern in kerns] != [n + 1 for n in before]:
                raise AssertionError(f"{tag} {c}: not one launch of each kernel")
            for a, r, (rtol, atol) in zip(got, ref, limits):
                e, ratio = worst_ratio(a, r, rtol, atol)
                err = max(err, e)
                if ratio > worst[0]:
                    worst = (ratio, c)
            if kernel == "flash_bwd" and not all(
                    torch.equal(a, b) for a, b in zip(got, run(c))):
                raise AssertionError(f"{tag} {c}: a second launch differs")
            if c == default and not all(torch.equal(a, b) for a, b in zip(got, untuned)):
                raise AssertionError(f"{tag}: the untuned call differs from {c}")
        say(f"  {tag}: {len(cands)} candidates, worst |err| / limit {worst[0]:.3f} ({worst[1]}), "
            f"max_abs_err {err:.3e}; untuned call bit-identical to {default}"
            + ("; every candidate's second launch bit-identical" if kernel == "flash_bwd"
               else ""))
        if worst[0] > 1.0:
            raise AssertionError(f"{tag} {worst[1]}: the kernel disagrees with its plain "
                                 "version")
        del q, k, v, ref, untuned


def tune_candidates_check(flash, decode, scan):
    """Phase 23, part 2: every candidate a sweep may time, launched at its
    sweep's shape (and flash at TUNE_RAGGED_FLASH, decode on a ragged
    24-slot cache, the scan at ragged and other state sizes), held to its
    plain version with phase 2's (phase 9's) element check; the plain
    scan's chunks, forward against the kernel and gradients against the
    default chunk's; then a config the kernel refuses raises, named, from
    an explicit argument and from a cache entry, and launches nothing."""
    from repro_torch.tune import (KernelConfigError, TuningCache, search_space,
                                  set_cache)

    bf = torch.bfloat16
    for label, (kernel, backend, dtype, shape) in TUNE_SWEEPS.items():
        cands, pruned = search_space(kernel, shape, dtype, backend)
        say(f"  {label}: {len(cands)} candidates {cands}, {pruned} pruned")
        if kernel == "flash_fwd" and dtype == "bfloat16":
            sizes = [(shape["B"], shape["Sq"], shape["Skv"], True)] + list(TUNE_RAGGED_FLASH)
            for B, sq, skv, causal in sizes:
                q = randn((B, sq, shape["H"], shape["D"]), bf, 61)
                k = randn((B, skv, shape["K"], shape["D"]), bf, 62)
                v = randn((B, skv, shape["K"], shape["Dv"]), bf, 63)
                ref, ref_lse = flash.flash_attention_plain(q, k, v, causal=causal)
                for c in cands:
                    before = flash.SM90_KERNEL.launches
                    out, lse = flash.flash_attention_fwd(q, k, v, causal=causal, **c)
                    if flash.SM90_KERNEL.launches != before + 1:
                        raise AssertionError(f"{label} {c} did not launch once")
                    tag = f"{label} {c} B={B} Sq={sq} Skv={skv} {'causal' if causal else ''}"
                    check(tag + " out", out, ref, RTOL[bf])
                    check(tag + " lse", lse, ref_lse, 0.0)
        elif kernel in ("flash_fwd", "flash_bwd"):  # the fp32 forward, the pairs
            tiles_check(flash, label, kernel, dtype, shape, cands)
        elif kernel == "decode":
            B, H, K, D = shape["B"], shape["H"], shape["K"], shape["D"]
            for slots, ci in ((shape["S"], shape["S"] - 1), (24, 11)):
                qd, kc, vc = (randn(s, bf, 64 + i) for i, s in enumerate(
                    ((B, 1, H, D), (B, slots, K, D), (B, slots, K, D))))
                ref = decode.decode_attention_plain(qd, kc, vc, cache_index=ci)
                for c in cands:
                    got = decode.decode_attention_fwd(qd, kc, vc, cache_index=ci, **c)
                    check(f"{label} {c} S={slots} cache_index {ci}", got, ref, RTOL[bf])
        elif backend == "cuda":  # the scan's lanes
            runs = [((shape["b"], shape["s"], shape["d"], shape["n"]), cands),
                    ((2, 13, 96, 16), cands), ((2, 13, 96, 8), cands),
                    ((2, 13, 96, 32), search_space("mamba", {"n": 32}, backend="cuda")[0])]
            for dims, cs in runs:
                inputs = scan_inputs(*dims, 71)
                ref = scan.mamba_scan_plain(*inputs)
                for c in cs:
                    got = scan.mamba_scan_fwd(*inputs, **c)
                    for name, a, r in zip(("y", "h_final"), got, ref):
                        check(f"{label} {c} {dims} {name}", a, r, SCAN_TOL, SCAN_TOL)
        else:  # the plain scan's chunks
            inputs = scan_inputs(shape["b"], shape["s"], shape["d"], shape["n"], 71)
            y_k, h_k = scan.mamba_scan_fwd(*inputs)
            base = None
            for c in [{"chunk": 256}] + cands:
                leaves = [t.detach().requires_grad_() for t in inputs]
                y, h = scan.mamba_scan_plain(*leaves, **c)
                grads = torch.autograd.grad(y.sum() + h.sum(), leaves)
                check(f"{label} {c} y vs the kernel", y.detach(), y_k, SCAN_TOL, SCAN_TOL)
                check(f"{label} {c} h_final vs the kernel", h.detach(), h_k, SCAN_TOL,
                      SCAN_TOL)
                if base is None:
                    base = grads
                    continue
                for name, g, g0 in zip(("x", "dt", "A", "B", "C"), grads, base):
                    rel = ((g - g0).norm() / g0.norm()).item()
                    if not rel <= 1e-3:
                        raise AssertionError(f"{label} {c}: grad {name} {rel:.2e} from "
                                             "chunk 256's (limit 1e-3)")
                del leaves, y, h, grads
            del base
    torch.cuda.synchronize()
    # refused configs raise, named, and launch nothing
    q = randn((PER_TASK, PROMPT, 16, 128), bf, 61)
    k = randn((PER_TASK, PROMPT, 8, 128), bf, 62)
    refused = [("flash block_q=128 at G=2, D=128 (not built)",
                lambda: flash.flash_attention_fwd(q, k, k, block_q=128, block_k=64)),
               ("flash block_q=0", lambda: flash.flash_attention_fwd(q, k, k, block_q=0)),
               ("decode splits=16", lambda: decode.decode_attention_fwd(
                   q[:, :1].contiguous(), k, k, cache_index=PROMPT - 1, splits=16)),
               ("scan lanes=3", lambda: scan.mamba_scan_fwd(
                   *scan_inputs(2, 13, 96, 16, 71), lanes=3))]
    # the fp32 forward and the pairs at qwen3's D = 128: 64-key fp32 tiles
    # and 32-query fp32 steps take more than a block's shared memory; a
    # 128-key bf16 dq tile more registers than a thread may have
    q32, k32 = q.float(), k.float()
    out, lse = flash.flash_attention_fwd(q, k, k)
    out32, lse32 = flash.flash_attention_fwd(q32, k32, k32)
    refused += [("fp32 flash 64x64 at D=128 (shared memory)",
                 lambda: flash.flash_attention_fwd(q32, k32, k32, block_q=64, block_k=64)),
                ("bf16 pair dq_block_k=128 at D=128 (registers)",
                 lambda: flash.flash_attention_bwd(q, k, k, out, lse, out, dq_block_k=128)),
                ("fp32 pair dkv_block_q=32 at D=128 (shared memory)",
                 lambda: flash.flash_attention_bwd(q32, k32, k32, out32, lse32, out32,
                                                   dkv_block_q=32)),
                ("bf16 pair dkv_block_q=0", lambda: flash.flash_attention_bwd(
                    q, k, k, out, lse, out, dkv_block_q=0))]
    qwen3 = {"B": PER_TASK, "Sq": PROMPT, "Skv": PROMPT, "H": 16, "K": 8, "D": 128, "Dv": 128}
    cache = TuningCache()
    for kernel, dtype, cfg in (("flash_fwd", "bfloat16", {"block_q": 128, "block_k": 64}),
                               ("flash_fwd", "float32", {"block_q": 128, "block_k": 32}),
                               ("flash_bwd", "bfloat16", {"dq_block_k": 128}),
                               ("flash_bwd", "float32", {"dkv_block_q": 32})):
        cache.put(kernel, qwen3, dtype, "cuda", cfg, 1.0, save=False)
    every = (flash.SM90_KERNEL, flash.SM90_FP32_KERNEL) + flash.backward_kernels(bf) + \
        flash.backward_kernels(torch.float32) + (decode.KERNEL, scan.KERNEL)
    prev = set_cache(cache)
    try:
        refused += [("a cache entry of flash block_q=128 at G=2, D=128",
                     lambda: flash.flash_attention_fwd(q, k, k)),
                    ("a cache entry of fp32 flash 128x32 at D=128",
                     lambda: flash.flash_attention_fwd(q32, k32, k32)),
                    ("a cache entry of the bf16 pair's dq_block_k=128 at D=128",
                     lambda: flash.flash_attention_bwd(q, k, k, out, lse, out)),
                    ("a cache entry of the fp32 pair's dkv_block_q=32 at D=128",
                     lambda: flash.flash_attention_bwd(q32, k32, k32, out32, lse32, out32))]
        for what, call in refused:
            before = [kern.launches for kern in every]
            try:
                call()
            except KernelConfigError as e:
                say(f"  refused, as it must be: {what}: {e}")
            else:
                raise AssertionError(f"{what} was not refused")
            if [kern.launches for kern in every] != before:
                raise AssertionError(f"{what} launched a kernel")
    finally:
        set_cache(prev)


def tune_sweeps(dev, cache_path):
    """Phase 23, part 3: each of TUNE_SWEEPS on the card through a
    KernelTuner over a farm of one in-process service, its summary printed
    and its winner cached at ``cache_path``; then the winner and the
    default re-timed one after the other, in turns, and the winner held no
    slower than the default within the re-timing's spread; every candidate
    re-timed once beside them.  Returns {label: (TuneResult, winner median
    us, default median us, {candidate: us})}."""
    from repro_torch.core import LookupService, Service
    from repro_torch.tune import KernelTuner, TuningCache, search_space
    from repro_torch.tune.measure import build_fn, make_inputs, time_fn

    lookup = LookupService()
    Service(lookup, device=dev).start()
    out = {}
    with KernelTuner(lookup, cache=TuningCache(cache_path)) as tuner:
        for label, (kernel, backend, dtype, shape) in TUNE_SWEEPS.items():
            t0 = time.perf_counter()
            r = tuner.tune(kernel, shape, dtype, backend, seed=SEED)
            say(f"  sweep {label} ({time.perf_counter() - t0:.1f} s): "
                f"{json.dumps(r.summary())}")
            if r.failed:
                raise AssertionError(f"sweep {label}: {r.failed} candidates failed")
            args = make_inputs(kernel, shape, dtype, SEED)
            fns = {"winner": build_fn(kernel, r.config, backend),
                   "default": build_fn(kernel, r.default_config, backend)}
            times = {"winner": [], "default": []}
            for i in range(TUNE_RETIMES):
                for name in (("winner", "default") if i % 2 == 0 else ("default", "winner")):
                    times[name].append(time_fn(fns[name], args, reps=5))
            med = {name: float(np.median(ts)) for name, ts in times.items()}
            spread = max(max(ts) - min(ts) for ts in times.values())
            say(f"    re-timed in turns ({TUNE_RETIMES} each, best of 5): winner {r.config} "
                f"median {med['winner']:.2f} us, default {r.default_config} median "
                f"{med['default']:.2f} us ({med['default'] / med['winner']:.3f}x), spread "
                f"{spread:.2f} us")
            if med["winner"] > med["default"] + spread:
                raise AssertionError(f"sweep {label}: the winner is slower than the default "
                                     "beyond the re-timing's spread")
            each = {json.dumps(cfg, sort_keys=True): time_fn(build_fn(kernel, cfg, backend),
                                                             args, reps=5)
                    for cfg in search_space(kernel, shape, dtype, backend)[0]}
            say("    every candidate re-timed once (best of 5): " + ", ".join(
                f"{cfg} {us:.2f} us" for cfg, us in each.items()))
            out[label] = (r, med["winner"], med["default"], each)
            del args, fns
            torch.cuda.empty_cache()
    return out


def tune_determinism():
    """Phase 23, part 4: two same-seed ``sim://`` sweeps with the scripted
    cost model, of the reference's own sweep (``xla_flash``) and of the
    port's knobs, give byte-identical summaries."""
    from repro_torch.sim import SimCluster
    from repro_torch.tune import KernelTuner, TuningCache

    sweeps = [("xla_flash", "torch", "float32",
               {"B": 1, "Sq": 1024, "Skv": 1024, "H": 8, "K": 2, "D": 64, "Dv": 64})]
    sweeps += [TUNE_SWEEPS[label] for label in ("flash llama4 G=5", "decode qwen3 B=4",
                                                "scan lanes falcon-mamba", "bf16 pair minicpm3",
                                                "fp32 pair qwen3", "fp32 flash minicpm3")]
    for kernel, backend, dtype, shape in sweeps:
        runs = []
        for _ in range(2):
            with SimCluster(speed_factors=[1, 1, 2, 4], seed=7) as cluster:
                with cluster.make_scheduler(max_batch=4) as sched:
                    r = KernelTuner(scheduler=sched, cache=TuningCache()).tune(
                        kernel, shape, dtype, backend, cost_model="scripted", seed=3)
            runs.append(json.dumps(r.summary(), sort_keys=True))
        say(f"  sim:// {kernel} ({backend}) twice, seed 3: summaries "
            f"{'byte-identical' if runs[0] == runs[1] else 'DIFFERENT'}: {runs[0]}")
        if runs[0] != runs[1]:
            raise AssertionError(f"same-seed sim:// sweeps of {kernel} differ")


def tune_probe_cost(flash, decode, host_us, calls=200_000):
    """Phase 23, part 5: the cache-hit probe a wrapper pays on every call
    (its ConfigProbe on the call's raw dims) in host µs, held to
    TUNE_PROBE_SHARE of phase 2's host µs of a wrapper call."""
    import importlib

    from repro_torch.tune import TuningCache, set_cache

    # the wrappers' modules (the packages' names are shadowed by functions)
    flash = importlib.import_module(flash.__name__ + ".flash_attention")
    decode = importlib.import_module(decode.__name__ + ".decode_attention")
    cache = TuningCache()
    B, S, H, K, D = PER_TASK, PROMPT + NEW, 16, 8, 128
    cache.put("decode", {"B": B, "S": S, "H": H, "K": K, "D": D, "Dv": D}, "bfloat16",
              "cuda", {"splits": 4}, 1.0, save=False)
    cache.put("flash_fwd", {"B": B, "Sq": PROMPT, "Skv": PROMPT, "H": H, "K": K, "D": D,
                            "Dv": D}, "bfloat16", "cuda", {"block_q": 64, "block_k": 128},
              1.0, save=False)
    prev = set_cache(cache)
    bf, Sq = torch.bfloat16, PROMPT
    try:
        worst = 0.0
        for name in ("decode", "flash"):
            probe = decode._SPLITS_PROBE if name == "decode" else flash._TILES_PROBE
            probe((B, S, H, K, D, D) if name == "decode" else (B, Sq, Sq, H, K, D, D), bf)
            hits = cache.hits
            t0 = time.perf_counter()
            if name == "decode":  # the tuple built at each call, as a wrapper builds it
                for _ in range(calls):
                    probe((B, S, H, K, D, D), bf)
            else:
                for _ in range(calls):
                    probe((B, Sq, Sq, H, K, D, D), bf)
            us = (time.perf_counter() - t0) / calls * 1e6
            if cache.hits - hits != calls:
                raise AssertionError(f"{name} probe: {cache.hits - hits} hits of {calls}")
            say(f"  {name} cache-hit probe: {us:.3f} us a call, {us / host_us:.4f} of phase "
                f"2's {host_us:.1f} us a wrapper call (limit {TUNE_PROBE_SHARE})")
            worst = max(worst, us / host_us)
        if worst > TUNE_PROBE_SHARE:
            raise AssertionError("a cache-hit probe costs more than its share of a call")
    finally:
        set_cache(prev)


def tune_serve(cfg, dev, kernels, cache_path, phase3_launches, sweeps):
    """Phase 23, part 6: qwen3-1.7B at full width, TUNE_SERVE_LAYERS
    layers, served through ``launch/serve.py --tune-cache`` with the
    sweeps' winners: the cache reports hits, the kernels launch as phase 3
    does a task and layer; then prefill and a decode step through the
    tuned dispatch against the untuned kernels (explicit default tiles
    and splits), |logits difference| held to phase 4's limits; and the
    same through a cache of each serve sweep's fastest candidate other
    than the default."""
    from repro_torch.kernels import AttentionOps
    from repro_torch.kernels import decode_attention as decode
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch import serve
    from repro_torch.models import build
    from repro_torch.tune import TuningCache, get_cache, set_cache

    zero_counts(kernels)
    serve.main(["--arch", cfg.name, "--layers", str(TUNE_SERVE_LAYERS), "--requests",
                str(REQUESTS), "--prompt-len", str(PROMPT), "--new-tokens",
                str(TUNE_SERVE_NEW), "--batch-per-task", str(PER_TASK), "--tune-cache",
                cache_path])
    cache = get_cache()
    got = launch_counts(kernels)
    tasks = REQUESTS // PER_TASK
    want = {name: 0 for name in got}
    want[flash.SM90_KERNEL.name] = tasks * TUNE_SERVE_LAYERS
    want[decode.KERNEL.name] = tasks * TUNE_SERVE_LAYERS * TUNE_SERVE_NEW
    say(f"  served through the cache: {cache.hits} hits, {cache.misses} misses; launches "
        f"{got} (phase 3, 28 layers, {NEW} new tokens: "
        f"{ {k: v for k, v in phase3_launches.items() if v} })")
    if cache.hits < 1:
        raise AssertionError("serving through --tune-cache read no tuned config")
    if got != want:
        raise AssertionError(f"launches through the cache {got}, expected {want}: one "
                             "flash a layer, one decode a layer and step, as phase 3")
    api = build(cfg.replace(n_layers=TUNE_SERVE_LAYERS))
    params = api.init(torch.Generator(device=dev).manual_seed(SEED))
    try:
        untuned = AttentionOps(
            lambda q, k, v, *, causal=True, window=None: flash.flash_attention_fwd(
                q, k, v, causal=causal, block_q=64, block_k=64)[0],
            lambda q, kc, vc, *, cache_index, window=None: decode.decode_attention_fwd(
                q, kc, vc, cache_index=cache_index, splits=0))
        prompts = [{"tokens": torch.as_tensor(np.random.default_rng(SEED + 1 + i).integers(
            0, cfg.vocab_size, (PER_TASK, PROMPT))).to(dev)} for i in range(TUNE_LOGIT_BATCHES)]
        hits = cache.hits
        kernels_vs_plain(api, params, untuned, [(b, PROMPT) for b in prompts], PROMPT + NEW,
                         1, (FULL_WIDTH_MAX_ERR, FULL_WIDTH_MEAN_ERR))
        say(f"  tuned dispatch vs the untuned kernels: {cache.hits - hits} cache hits")
        # the winners may be the defaults: the same through a cache of each
        # serve sweep's fastest candidate other than the default, so that
        # the served path runs tiles and splits of its own
        other = TuningCache()
        for label in ("flash qwen3 G=2", "decode qwen3 B=4", "decode qwen3 B=1"):
            kernel, backend, dtype, shape = TUNE_SWEEPS[label]
            r, _, _, each = sweeps[label]
            runner = min((us, cfg) for cfg, us in each.items()
                         if json.loads(cfg) != r.default_config)[1]
            other.put(kernel, shape, dtype, backend, json.loads(runner), 0.0, save=False)
        set_cache(other)
        before = {k.name: k.launches for k in (flash.SM90_KERNEL, decode.KERNEL)}
        say(f"  the same with the runners-up {list(other.entries())}:")
        kernels_vs_plain(api, params, untuned, [(b, PROMPT) for b in prompts], PROMPT + NEW,
                         1, (FULL_WIDTH_MAX_ERR, FULL_WIDTH_MEAN_ERR))
        ran = {k.name: k.launches - before[k.name] for k in (flash.SM90_KERNEL, decode.KERNEL)}
        say(f"  runners-up through the cache: {other.hits} hits, launches {ran}")
        if other.hits < 1:
            raise AssertionError("the runners-up's cache was not read")
    finally:
        set_cache(None)
        del api, params
        gc.collect()
        torch.cuda.empty_cache()


def tune_train(cfg, dev, kernels, cache_path, sweeps):
    """Phase 23, part 7: one qwen3-1.7B training step at full width,
    TRAIN_LAYERS layers, in bf16 and in fp32, through the sweeps' winners
    (``repro_torch.tune.configure(cache_path)``: the pairs' and the fp32
    forward's tiles) and then through a cache of each training sweep's
    fastest candidate other than the default: each launches one forward,
    one dq and one dk/dv a layer, and its loss and gradients are held to
    phase 7's TRAIN_LIMITS against the untuned kernels (no cache)."""
    from repro_torch.models import build
    from repro_torch.runtime.train_loop import loss_and_grads
    from repro_torch.tune import TuningCache, configure, set_cache

    tcfg = cfg.replace(n_layers=TRAIN_LAYERS)
    runners = TuningCache()
    for label, (kernel, backend, dtype, shape) in TUNE_SWEEPS.items():
        if shape == {"B": TRAIN_BATCH, "Sq": TRAIN_SEQ, "Skv": TRAIN_SEQ, "H": 16, "K": 8,
                     "D": 128, "Dv": 128} and kernel in ("flash_bwd", "flash_fwd") \
                and (dtype == "float32" or kernel == "flash_bwd"):
            r, _, _, each = sweeps[label]
            others = [(us, c) for c, us in each.items() if json.loads(c) != r.default_config]
            if others:
                runners.put(kernel, shape, dtype, backend, json.loads(min(others)[1]), 0.0,
                            save=False)
    for dt, names in ((torch.bfloat16, BF16_TRAIN_KERNELS), (torch.float32, FP32_TRAIN_KERNELS)):
        name = str(dt)[6:]
        api = build(tcfg if dt == torch.bfloat16
                    else tcfg.replace(param_dtype="float32", compute_dtype="float32"))
        model = api.init(torch.Generator(device=dev).manual_seed(SEED))
        model.requires_grad_(True)
        if dt == torch.float32:
            model.head().drop_f32()
        batch = markov_batch(tcfg, dev)
        set_cache(None)
        loss_u, _, g_u = loss_and_grads(api, model, batch)
        loss_lim, grad_lim = TRAIN_LIMITS[dt]
        for which, install in (("the winners", lambda: configure(cache_path)),
                               ("the runners-up", lambda: set_cache(runners) or runners)):
            cache = install()
            zero_counts(kernels)
            try:
                loss_t, _, g_t = loss_and_grads(api, model, batch)
            finally:
                set_cache(None)
            got = {k: v for k, v in launch_counts(kernels).items() if v}
            want = {n: TRAIN_LAYERS for n in names}
            tiles = {k: e["config"] for k, e in cache.entries().items()
                     if f"|{name}|" in k and k.startswith("flash")}
            dloss = abs(loss_t.item() - loss_u.item())
            worst = compare_grads(g_t, g_u, "g_tuned - g_untuned", "g_untuned", quiet=True)
            say(f"  {name} training step through {which} {tiles}: {cache.hits} cache hits, "
                f"launches {got}; |dloss| {dloss:.3e} (limit {loss_lim:g}), largest relative "
                f"gradient difference from the untuned kernels {worst:.3e} (limit {grad_lim:g})")
            if got != want:
                raise AssertionError(f"{name} tuned training step launched {got}, not {want}")
            if cache.hits < 1:
                raise AssertionError(f"{name} tuned training step read no tuned config")
            if not (dloss <= loss_lim and worst <= grad_lim):
                raise AssertionError(f"{name} training step through {which} disagrees with "
                                     "the untuned kernels")
        del api, model, g_u, g_t
        gc.collect()
        torch.cuda.empty_cache()


def tune_phase(cfg, dev, kernels, flash, decode, scan, logs, build_s, host_us,
               phase3_launches):
    """Phase 23: the autotuner on the card (parts 1-7 above); returns the
    sweeps' results."""
    t0 = time.perf_counter()
    tune_space_checks(flash, decode, scan, logs, build_s)
    tune_candidates_check(flash, decode, scan)
    cache_path = str(ROOT / "build" / "chip_smoke_tune.json")
    if os.path.exists(cache_path):
        os.remove(cache_path)
    sweeps = tune_sweeps(dev, cache_path)
    tune_determinism()
    tune_probe_cost(flash, decode, host_us)
    tune_serve(cfg, dev, kernels, cache_path, phase3_launches, sweeps)
    tune_train(cfg, dev, kernels, cache_path, sweeps)
    took = time.perf_counter() - t0
    say(f"  phase 23 took {took:.1f} s (limit {TUNE_PHASE_LIMIT_S} s)")
    if took > TUNE_PHASE_LIMIT_S:
        raise AssertionError("phase 23 took longer than its limit")
    return sweeps


# --------------------------------------------------------------------- #
# phase 25: the SPMD layer on one card
# --------------------------------------------------------------------- #
# One NCCL rank makes a ("data", "model") = (1, 1) mesh: every collective is
# a copy, so the mesh path must give the mesh-free path's numbers (held at
# phase 4's and phase 7's limits, bit-identity printed) and launch the flash
# kernels and the decode kernel through local_map (a "model" axis of one
# device leaves decode nothing to merge).  What one rank cannot show, the
# head plans and the decode merge at real tensor-parallel degrees, runs
# serialized: each of SPMD_TP shards' local kernels in turn, each cache
# chunk's decode kernel with its log-sum-exp in turn.
SPMD_AXES = ("data", "model")
SPMD_BATCH, SPMD_PROMPT, SPMD_STEPS = 4, 512, 4
SPMD_TP = 16
# (label, H, K, D, Dv) at SPMD_TP
SPMD_HEAD_PLANS = (("qwen3", 16, 8, 128, 128), ("llama4 G=5", 40, 8, 128, 128),
                   ("arctic G=7", 56, 8, 128, 128), ("jamba G=8", 64, 8, 128, 128),
                   ("minicpm3 MLA", 40, 40, 96, 64))
# qwen3's decode cache split over tp chunks, at cache_index 0, the middle and
# the end (whole chunks masked); the reference's bf16 decode tolerance, and
# the chunks' log-sum-exps (fp32 from bf16 inputs) against the plain
# partials' at LSE_TOL
SPMD_DECODE = dict(B=4, H=16, K=8, D=128, slots=576, tps=(4, 8, 16), indices=(0, 287, 575))
DECODE_TOL_BF16 = 3e-2
LSE_TOL = 1e-3
# jamba's long context (B=1, S=4096, H=64, K=8, D=128, window 2048, bf16):
# the chunked flash with its manual backward against autograd through
# chunked_attention, at the reference's bf16 forward limit (2e-2,
# tests/test_kernels_flash.py) and its bf16 backward limit (atol 6e-2, rtol
# 1e-2, tests/test_kernels_flash_bwd.py).  Both round p (and the manual one
# ds) to bf16 where the reference does, at other points of the recurrence,
# so they differ by bf16 roundings (a CPU run at 1 x 1024, 16 heads: 0.016-
# 0.031 largest), beyond phase 5's one-ulp element check, which either
# breaks 25-50 times against an fp64 reference too.
SPMD_LONG = dict(B=1, S=4096, H=64, K=8, D=128, window=2048)
LONG_GRAD_TOL = (6e-2, 1e-2)


def spmd_mesh():
    """(a): a one-rank NCCL group on a HashStore (no address, no port) and
    its ("data", "model") = (1, 1) mesh through the elastic re-meshing."""
    import torch.distributed as dist

    from repro_torch.runtime.elastic import make_elastic_mesh, viable_mesh_shape

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    shape = viable_mesh_shape(1, model=1)
    mesh = make_elastic_mesh(shape)
    say(f"  (a) mesh {dict(zip(mesh.mesh_dim_names, list(mesh.mesh.shape)))} on one "
        f"NCCL rank (viable_mesh_shape(1, model=1) = {shape})")
    return mesh


def _full(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def spmd_serve(mesh, dev, kernels):
    """(b): qwen3-1.7B at full width and depth, distributed by its serve
    specs, one prefill of SPMD_BATCH x SPMD_PROMPT tokens and SPMD_STEPS
    decode steps under the mesh against the same without it."""
    import repro_torch.configs as cfgs
    from repro_torch.models import build
    from repro_torch.sharding.hints import mesh_axes, use_mesh
    from repro_torch.sharding.specs import (cache_partition_specs, distribute_batch,
                                            distribute_model, mesh_sizes, placements)

    cfg = cfgs.get(ARCH)
    api = build(cfg)
    model = api.init(torch.Generator(device=dev).manual_seed(SEED))
    tokens = torch.as_tensor(np.random.default_rng(SEED + 25).integers(
        0, cfg.vocab_size, (SPMD_BATCH, SPMD_PROMPT))).to(dev)
    budget = SPMD_PROMPT + SPMD_STEPS
    fed = []  # the mesh-free path's greedy tokens, fed to both paths

    def where(caches):
        return [str(list(getattr(caches[0][n], "placements", []))) for n in ("k", "v")]

    def run(batch_of):
        logits, caches = model.prefill(batch_of({"tokens": tokens}), seq_budget=budget)
        out, placed = [_full(logits)], [where(caches)]
        for j in range(SPMD_STEPS):
            if len(fed) == j:
                fed.append(torch.argmax(out[-1], -1).to(torch.int32)[:, None])
            logits, caches = model.decode(batch_of({"tokens": fed[j]}), caches,
                                          cache_index=SPMD_PROMPT + j)
            out.append(_full(logits))
            placed.append(where(caches))
        return out, placed

    ref, _ = run(lambda b: b)
    distribute_model(model, mesh, mode="serve")
    zero_counts(kernels)
    with use_mesh(mesh), mesh_axes(SPMD_AXES):
        got, placed = run(lambda b: distribute_batch(b, mesh))
    torch.cuda.synchronize()
    counts = launch_counts(kernels)
    say(f"  (b) {cfg.name} distributed by tree_partition_specs (serve) on the mesh, "
        f"embed.table placed {list(model.embed.table.placements)}; launches under the "
        f"mesh over one prefill and {SPMD_STEPS} decode steps: {counts}")
    want = str(placements(cache_partition_specs(
        [{"k": torch.empty(SPMD_BATCH, budget, cfg.n_kv_heads, cfg.head_dim, device="meta")}],
        SPMD_AXES, global_batch=SPMD_BATCH, dp_size=1, axis_sizes=mesh_sizes(mesh))[0]["k"],
        mesh))
    say(f"  (b) layer 0's KV caches placed {placed[0]} after prefill, {placed[-1]} after "
        f"the last decode step (cache_partition_specs: {want})")
    if any(p != [want, want] for p in placed):
        raise AssertionError("(b) the KV caches are not where cache_partition_specs puts "
                             "them, or decode moved them")
    for j, (a, b) in enumerate(zip(got, ref)):
        diff = (a - b).abs()
        err, mean = diff.max().item(), diff.mean().item()
        name = "prefill" if j == 0 else f"decode at {SPMD_PROMPT + j - 1}"
        say(f"  (b) {name} logits under the mesh vs without: max |diff| {err:.3e} "
            f"(limit {FULL_WIDTH_MAX_ERR:g}), mean {mean:.3e} (limit "
            f"{FULL_WIDTH_MEAN_ERR:g}), bit-identical {torch.equal(a, b)}")
        if not (torch.isfinite(a).all() and err <= FULL_WIDTH_MAX_ERR
                and mean <= FULL_WIDTH_MEAN_ERR):
            raise AssertionError(f"(b) {name}: logits under the mesh disagree")
    if (counts["flash_attention_sm90"] != cfg.n_layers
            or counts["decode_attention_sm90"] != cfg.n_layers * SPMD_STEPS):
        raise AssertionError(f"(b) expected {cfg.n_layers} bf16 flash launches and "
                             f"{cfg.n_layers} decode launches a step through local_map")
    return counts


def spmd_train(mesh, dev, kernels):
    """(c): qwen3 at full width cut to TRAIN_LAYERS, one training step on
    DTensor parameters (train specs) under make_train_step(axes=...)
    against the mesh-free step: loss and gradients at phase 7's limits,
    the updated weights printed."""
    import repro_torch.configs as cfgs
    from repro_torch.models import build
    from repro_torch.runtime.train_loop import (TrainConfig, loss_and_grads,
                                                make_train_state, make_train_step)
    from repro_torch.sharding.hints import mesh_axes, use_mesh
    from repro_torch.sharding.specs import distribute_batch, distribute_model

    tcfg = cfgs.get(ARCH).replace(n_layers=TRAIN_LAYERS)
    api = build(tcfg)
    tc = TrainConfig(warmup_steps=1, total_steps=10)
    batch = markov_batch(tcfg, dev)

    ref_state = make_train_state(api, tc, device=dev)
    loss0, _, g0 = loss_and_grads(api, ref_state["params"], batch)
    ref_state, ref_m = make_train_step(api, tc)(ref_state, batch)
    params = api.init(torch.Generator(device=dev).manual_seed(tc.seed))
    state = make_train_state(api, tc, params=distribute_model(params, mesh))
    with use_mesh(mesh), mesh_axes(SPMD_AXES):
        loss1, _, g1 = loss_and_grads(api, state["params"], distribute_batch(batch, mesh))
    loss1, g1 = _full(loss1), {k: _full(g) for k, g in g1.items()}
    zero_counts(kernels)
    state, m = make_train_step(api, tc, axes=SPMD_AXES)(state, batch)
    torch.cuda.synchronize()
    counts = launch_counts(kernels)
    say(f"  (c) {tcfg.name} at {TRAIN_LAYERS} layers, one make_train_step(axes="
        f"{SPMD_AXES}) step on DTensor parameters: launches {counts}")
    dloss = abs(loss1.item() - loss0.item())
    worst = compare_grads(g1, g0, "g_mesh - g", "g")
    same = torch.equal(loss1, loss0) and all(torch.equal(g1[k], g0[k]) for k in g0)
    loss_lim, grad_lim = TRAIN_LIMITS[torch.bfloat16]
    say(f"  (c) loss under the mesh {loss1.item():.6f}, without {loss0.item():.6f}: "
        f"|dloss| {dloss:.3e} (limit {loss_lim:g}); largest relative gradient "
        f"difference {worst:.3e} (limit {grad_lim:g}); bit-identical {same}")
    step_same = torch.equal(m["loss"], ref_m["loss"])
    upd = compare_grads({k: _full(p.detach()) for k, p in state["params"].named_parameters()},
                        dict(ref_state["params"].named_parameters()), "p_mesh - p", "p",
                        quiet=True)
    say(f"  (c) the step's loss {m['loss'].item():.6f} (without the mesh "
        f"{ref_m['loss'].item():.6f}, equal {step_same}), grad_norm "
        f"{m['grad_norm'].item():.6f} ({ref_m['grad_norm'].item():.6f}); updated weights' "
        f"largest relative difference {upd:.3e}")
    if not (dloss <= loss_lim and worst <= grad_lim and upd <= grad_lim):
        raise AssertionError("(c) the training step under the mesh disagrees")
    want = {name: TRAIN_LAYERS for name in BF16_TRAIN_KERNELS}
    if any(counts[name] != n for name, n in want.items()) or any(
            counts[k.name] for k in kernels.KERNELS if k.name not in want):
        raise AssertionError(f"(c) expected {want} through local_map and nothing else")
    return counts


def spmd_head_plans(flash, tp=SPMD_TP, B=SPMD_BATCH, S=SPMD_PROMPT):
    """(d): each SPMD_HEAD_PLANS case split over ``tp`` head shards as
    flash_attention_tp lays it out (plan_heads' permutation, duplicated kv
    heads, zero heads), every shard's forward and backward pair launched
    in turn, the plan inverted (a duplicated kv head's gradient the bf16
    sum of its copies', as autograd through the permutation sums them);
    held to the unsharded kernels: the output by phase 2's element check,
    dq by phase 5's, dk and dv by phase 5's with the rtol term over the
    copies' magnitudes (each copy rounded to bf16 once before the sum)."""
    from repro_torch.kernels.flash_attention.sharded import _take_heads, plan_heads

    dt = torch.bfloat16
    for label, H, K, D, Dv in SPMD_HEAD_PLANS:
        q, k, v = (randn((B, S, H, D), dt, 61), randn((B, S, K, D), dt, 62),
                   randn((B, S, K, Dv), dt, 63))
        g = randn((B, S, H, Dv), dt, 64)
        plan = plan_heads(H, K, tp)
        qp, gp = _take_heads(q, plan.q_src), _take_heads(g, plan.q_src)
        kp, vp = _take_heads(k, plan.kv_src), _take_heads(v, plan.kv_src)
        hq, hk = plan.Hp // tp, plan.Kp // tp
        parts = {"out": [], "dq": [], "dk": [], "dv": []}
        for i in range(tp):
            qs, gs = (t[:, :, i * hq:(i + 1) * hq].contiguous() for t in (qp, gp))
            ks, vs = (t[:, :, i * hk:(i + 1) * hk].contiguous() for t in (kp, vp))
            out, lse = flash.flash_attention_fwd(qs, ks, vs, causal=True)
            dq, dk, dv = flash.flash_attention_bwd(qs, ks, vs, out, lse, gs, causal=True)
            for name, t in zip(parts, (out, dq, dk, dv)):
                parts[name].append(t)
        inv = torch.tensor(plan.inv, device=q.device)
        src = torch.tensor([max(s, 0) for s in plan.kv_src], device=q.device)
        real = torch.tensor([s >= 0 for s in plan.kv_src], device=q.device)
        got = {n: torch.cat(parts[n], 2).index_select(2, inv) for n in ("out", "dq")}
        for n, like in (("dk", k), ("dv", v)):
            cat = torch.cat(parts[n], 2)[:, :, real]
            got[n] = torch.zeros_like(like).index_add_(2, src[real], cat)
            got[n + " copies"] = torch.zeros_like(like, dtype=torch.float32).index_add_(
                2, src[real], cat.float().abs())
        out, lse = flash.flash_attention_fwd(q, k, v, causal=True)
        ref = dict(zip(("dq", "dk", "dv"), flash.flash_attention_bwd(q, k, v, out, lse, g,
                                                                    causal=True)))
        tag = (f"(d) {label} (H={H}, K={K}, D={D}, Dv={Dv}) at tp={tp}: Hp={plan.Hp}, "
               f"Kp={plan.Kp}, {tp} shards of {hq} q-heads and {hk} kv-heads")
        check(f"{tag} out", got["out"], out, RTOL[dt])
        check(f"{tag} dq", got["dq"], ref["dq"], RTOL[dt], BWD_ATOL)
        for n in ("dk", "dv"):
            diff = (got[n].float() - ref[n].float()).abs()
            lim = BWD_ATOL + RTOL[dt] * (ref[n].float().abs() + got[n + " copies"])
            worst = (diff / lim).max().item()
            say(f"  {tag} {n}: max_abs_err {diff.max().item():.3e}, largest |err| / "
                f"({BWD_ATOL:g} + {RTOL[dt]:g} (|ref| + sum |copy|)) {worst:.3f} (limit 1)")
            if not worst <= 1.0:
                raise AssertionError(f"{tag} {n}: the head plan's gradient disagrees")
        same = {n: torch.equal(got[n], r) for n, r in (("out", out), *ref.items())}
        say(f"  {tag}: bit-identical to the unsharded kernels {same}")


def spmd_decode_merge(decode):
    """(e): qwen3's bf16 cache split into tp chunks as decode_attention_tp
    splits it; each chunk's decode kernel (chunk_decode: out and
    log-sum-exp, no launch for a chunk wholly past cache_index) against the
    plain partials of the chunk, and the merge the "model" all-reduces make
    (max, then sums, here over the stacked chunks) against the unsharded
    decode kernel."""
    from repro_torch.kernels.decode_attention.sharded import (_local_partials,
                                                              chunk_decode, merge_chunks)

    def stacked(x, op):
        return x.amax(0) if op == "max" else x.sum(0)

    c, dt = SPMD_DECODE, torch.bfloat16
    q = randn((c["B"], 1, c["H"], c["D"]), dt, 71)
    kc = randn((c["B"], c["slots"], c["K"], c["D"]), dt, 72)
    vc = randn((c["B"], c["slots"], c["K"], c["D"]), dt, 73)
    for tp in c["tps"]:
        sl = c["slots"] // tp
        for ci in c["indices"]:
            chunks = [(kc[:, i * sl:(i + 1) * sl].contiguous(),
                       vc[:, i * sl:(i + 1) * sl].contiguous()) for i in range(tp)]
            before = decode.KERNEL.launches
            parts = [chunk_decode(q, k, v, start=i * sl, cache_index=ci)
                     for i, (k, v) in enumerate(chunks)]
            launched = decode.KERNEL.launches - before
            live = sum(i * sl <= ci for i in range(tp))
            tag = (f"(e) decode, {c['slots']} slots in {tp} chunks of {sl}, cache_index {ci} "
                   f"({tp - live} chunks wholly masked)")
            if launched != live:
                raise AssertionError(f"{tag}: {launched} launches, {live} chunks hold keys")
            out_worst = lse_err = 0.0
            for i, ((k, v), (out, lse)) in enumerate(zip(chunks, parts)):
                if i * sl > ci:
                    continue
                acc, m, l = _local_partials(q, k, v, start=i * sl, cache_index=ci, window=None)
                plain = (acc / l[..., None])[:, None].to(dt).float()
                out_worst = max(out_worst, ((out.float() - plain).abs() / (
                    DECODE_TOL_BF16 + DECODE_TOL_BF16 * plain.abs())).max().item())
                lse_err = max(lse_err, (lse - (m + torch.log(l))).abs().max().item())
            say(f"  {tag}: {launched} launches; the chunks' outputs against the plain "
                f"partials' largest |err| / ({DECODE_TOL_BF16:g} + {DECODE_TOL_BF16:g} |ref|) "
                f"{out_worst:.3f} (limit 1), their lse max_abs_err {lse_err:.3e} (limit "
                f"{LSE_TOL:g})")
            if not (out_worst <= 1.0 and lse_err <= LSE_TOL):
                raise AssertionError(f"{tag}: a chunk's output or log-sum-exp disagrees")
            out, lse = (torch.stack(t) for t in zip(*parts))
            ref = decode.decode_attention_fwd(q, kc, vc, cache_index=ci)
            check(f"{tag} merged", merge_chunks(out, lse, stacked).to(dt), ref,
                  DECODE_TOL_BF16, DECODE_TOL_BF16)


def spmd_long_context():
    """(f): jamba's long-context attention, the chunked flash with its
    manual backward against autograd through chunked_attention: output,
    gradients and each one's peak memory from its forward to the end of
    its backward."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.chunked import flash_attention_chunked
    from repro_torch.models.attention import chunked_attention

    c, dt = SPMD_LONG, torch.bfloat16
    q = randn((c["B"], c["S"], c["H"], c["D"]), dt, 81)
    k = randn((c["B"], c["S"], c["K"], c["D"]), dt, 82)
    v = randn((c["B"], c["S"], c["K"], c["D"]), dt, 83)
    g = randn((c["B"], c["S"], c["H"], c["D"]), dt, 84)
    chunks = kernels._chunks(q, v)
    runs = {}
    for name, fn in (
            ("chunked flash, manual backward", lambda a, b, d: flash_attention_chunked(
                a, b, d, True, c["window"], chunks["q_chunk"], chunks["kv_chunk"])),
            ("autograd through chunked_attention", lambda a, b, d: chunked_attention(
                a, b, d, causal=True, window=c["window"], **chunks))):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(*leaves)
        out.backward(g)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        runs[name] = (out.detach(), *(t.grad for t in leaves))
        say(f"  (f) {name} at B={c['B']}, S={c['S']}, H={c['H']}, K={c['K']}, "
            f"D={c['D']}, window {c['window']}, chunks {chunks}: peak memory above the "
            f"inputs {peak:.3f} GB, {time.perf_counter() - t0:.3f} s")
        del out, leaves
    got, ref = runs.values()
    check("(f) output", got[0], ref[0], 2e-2, 2e-2)
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
        check(f"(f) {name}", a, b, LONG_GRAD_TOL[1], LONG_GRAD_TOL[0])


def spmd_phase(dev, kernels, flash, decode):
    """Phase 25: (a) the mesh, (b) serving and (c) training under it, (d)
    the head plans and (e) the decode merge at real tensor-parallel
    degrees, serialized, (f) the chunked flash's manual backward at long
    context, (g) the phase's seconds.  Returns (b)'s and (c)'s launches."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    mesh = spmd_mesh()
    try:
        serve = spmd_serve(mesh, dev, kernels)
        gc.collect()
        torch.cuda.empty_cache()
        train = spmd_train(mesh, dev, kernels)
        gc.collect()
        torch.cuda.empty_cache()
        spmd_head_plans(flash)
        spmd_decode_merge(decode)
        spmd_long_context()
    finally:
        dist.destroy_process_group()
    say(f"  (g) phase 25 took {time.perf_counter() - t0:.1f} s")
    return serve, train


# --------------------------------------------------------------------- #
# phase 26: the dry run held to the card
# --------------------------------------------------------------------- #
# The dry run (repro_torch.launch.dryrun) runs a step on fake tensors over a
# fake process group and predicts, per device, each kernel op's calls, the
# matmul FLOPs and the peak memory.  Here it runs on fake CUDA tensors (each
# kernel wrapper through its op's fake impl) on a (1, 1) mesh at phase 25's
# shapes, in a subprocess (it needs a fake default process group), while the
# same steps run for real and mesh-free on the card; then on the production
# meshes, whose records and roofline rows are predictions from one card's
# data-sheet constants, not timings.
DRY_ARCH = "qwen3_1p7b"
DRY_PEAK_TOL = 0.10  # predicted peak memory against max_memory_allocated
# the production cells: (shape, mesh), each a subprocess of its own, all
# started with the phase and cut at DRY_PROD_LIMIT_S from their start
DRY_PROD = (("train_4k", "single"), ("prefill_32k", "single"), ("decode_32k", "single"),
            ("train_4k", "multi"))
DRY_PROD_LIMIT_S = 120
# each kernel op of the bf16 paths and the kernels its call launches
DRY_LAUNCHES = {"flash_attention_fwd": ("flash_attention_sm90",),
                "flash_attention_bwd": ("flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"),
                "decode_attention_fwd": ("decode_attention_sm90",),
                "decode_attention_fwd_lse": ("decode_attention_sm90",),
                "mamba_scan_fwd": ("mamba_scan_sm90",)}
DRY_ONE_CARD = """
import json
from repro_torch.launch.dryrun import run_mesh
from repro_torch.models.registry import ShapeCell
cells = {{"prefill": (ShapeCell("prefill", {prompt}, {batch}), None),
          "decode": (ShapeCell("decode", {budget}, {batch}), None),
          "train": (ShapeCell("train", {seq}, {tbatch}), {{"n_layers": {layers}}})}}
out = {{name: run_mesh({arch!r}, cell, (1, 1), ("data", "model"), device="cuda",
                        train_overrides=over) for name, (cell, over) in cells.items()}}
print("RESULT" + json.dumps(out))
"""


def _dry_env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def dry_start(out_dir):
    """Starts the one-card dry runs and the production cells; returns
    (the one-card process, {cell: process})."""
    one = subprocess.Popen(
        [sys.executable, "-c", DRY_ONE_CARD.format(
            arch=DRY_ARCH, prompt=SPMD_PROMPT, batch=SPMD_BATCH,
            budget=SPMD_PROMPT + SPMD_STEPS, seq=TRAIN_SEQ, tbatch=TRAIN_BATCH,
            layers=TRAIN_LAYERS)],
        env=_dry_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    prod = {(shape, mesh): subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", DRY_ARCH, "--shape",
         shape, "--mesh", mesh, "--out-dir", str(out_dir), "--force"],
        env=_dry_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for shape, mesh in DRY_PROD}
    return one, prod


def real_step(label, fn, resident_before, kernels):
    """``fn()`` once on the card under FlopCounterMode, its kernels' launch
    counters zeroed just before: (launches, FLOPs, peak bytes above what
    was allocated before the step's arguments existed)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.utils.op_stats import EXTRA_FLOPS

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    # addmm_ counted as addmm, as the dry run counts it
    with FlopCounterMode(display=False, custom_mapping=EXTRA_FLOPS) as fc:
        out = fn()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS if k.launches}
    peak = torch.cuda.max_memory_allocated() - resident_before
    say(f"  (a) {label} on the card: launches {launches}; FlopCounterMode "
        f"{fc.get_total_flops():.6g} FLOPs; peak {peak / 1e9:.3f} GB above the "
        f"{resident_before / 1e9:.3f} GB allocated before its arguments")
    del out
    return launches, fc.get_total_flops(), peak


def hold_dry(label, rec, launches, flops, peak):
    """(a), (b), (c) for one step: the dry run's kernel ops against the
    launches, its non-kernel FLOPs against FlopCounterMode's, its peak
    against the card's."""
    want = {}
    for op, n in rec["kernel_ops"].items():
        for name in DRY_LAUNCHES[op]:
            want[name] = want.get(name, 0) + n
    nonkernel = rec["dot_flops_per_device"] - rec["kernel_flops_per_device"]
    ratio = rec["memory"]["peak_bytes_per_device"] / peak
    say(f"  {label}: (a) dry-run kernel ops {rec['kernel_ops']} -> launches {want}, the "
        f"card's {launches}; (b) dry-run non-kernel FLOPs {nonkernel:.6g} (kernel ops "
        f"{rec['kernel_flops_per_device']:.6g}), FlopCounterMode's {flops:.6g}; (c) "
        f"predicted peak {rec['memory']['peak_bytes_per_device'] / 1e9:.3f} GB, "
        f"max_memory_allocated {peak / 1e9:.3f} GB, ratio {ratio:.4f} (limit "
        f"1 +- {DRY_PEAK_TOL:g}); trace {rec['trace_s']:.1f} s")
    if want != launches:
        raise AssertionError(f"(a) {label}: the dry run's kernel ops do not match the launches")
    if nonkernel != flops:
        raise AssertionError(f"(b) {label}: non-kernel FLOPs {nonkernel} != {flops}")
    if abs(ratio - 1) > DRY_PEAK_TOL:
        raise AssertionError(f"(c) {label}: predicted peak off by more than "
                             f"{DRY_PEAK_TOL:.0%}")


def dry_mamba(dev, kernels):
    """(b) falcon-mamba-7b's prefill at phase 11's shape: under OpStatsMode on
    fake CUDA tensors with no mesh, against the same prefill on the card:
    scan op calls against scan launches, non-kernel FLOPs against
    FlopCounterMode's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    import repro_torch.configs as cfgs
    from repro_torch.models import build
    from repro_torch.models.layers import ShapeInit
    from repro_torch.utils.op_stats import OpStatsMode

    api = build(cfgs.get(MAMBA_ARCH))
    tokens = torch.as_tensor(np.random.default_rng(SEED + 26).integers(
        0, api.cfg.vocab_size, (PER_TASK, PROMPT))).to(dev)
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = api.init(ShapeInit(dev))
        batch = {"tokens": torch.zeros((PER_TASK, PROMPT), dtype=torch.int64, device=dev)}
        with OpStatsMode([*model.parameters(), batch["tokens"]]) as mode:
            api.prefill(model, batch)
    rec = mode.result
    trace_s = time.perf_counter() - t0
    del model
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    model = api.init(torch.Generator(device=dev).manual_seed(SEED))
    launches, flops, _ = real_step(f"{api.cfg.name} prefill {PER_TASK} x {PROMPT}",
                                   lambda: api.prefill(model, {"tokens": tokens}), before,
                                   kernels)
    nonkernel = rec.dot_flops - rec.kernel_flops
    say(f"  (b) {api.cfg.name} prefill on fake CUDA tensors, no mesh ({trace_s:.1f} s): "
        f"scan op calls {dict(rec.kernel_ops)}, the card's launches {launches}; non-kernel "
        f"FLOPs {nonkernel:.6g}, FlopCounterMode's {flops:.6g}")
    if rec.kernel_ops != {"mamba_scan_fwd": launches.get("mamba_scan_sm90", -1)} or len(
            launches) != 1:
        raise AssertionError("(b) the scan's fake route does not count the card's launches")
    if nonkernel != flops:
        raise AssertionError(f"(b) falcon-mamba non-kernel FLOPs {nonkernel} != {flops}")
    del model


def dry_production(prod, out_dir, started):
    """(d): the production cells' records and roofline rows, each cell cut at
    DRY_PROD_LIMIT_S from the phase's start."""
    from repro_torch.launch import roofline

    done, cut = [], []
    for (shape, mesh), proc in prod.items():
        try:
            log = proc.communicate(timeout=max(started + DRY_PROD_LIMIT_S
                                               - time.perf_counter(), 1))[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            cut.append(f"{shape} on the {mesh} mesh")
            continue
        if proc.returncode != 0:
            raise AssertionError(f"(d) the dry run of {shape} ({mesh}) failed:\n{log[-3000:]}")
        done.append((shape, mesh))
    recs = [json.load(open(Path(out_dir) / f"{DRY_ARCH}__{shape}__{mesh}.json"))
            for shape, mesh in done]
    for rec in recs:
        row = roofline.analyze_cell(rec)
        say(f"  (d) {rec['arch']} {rec['shape']} on the {rec['mesh']} mesh "
            f"{rec['mesh_shape']}: trace {rec['trace_s']:.1f} s, peak "
            f"{rec['memory']['peak_bytes_per_device'] / 2**30:.2f} GiB a card, "
            f"{rec['dot_flops_per_device']:.4g} FLOPs a card (kernel ops "
            f"{rec['kernel_ops']}), collectives {rec['collectives']['count']}, wire "
            f"{rec['collectives']['total_wire_bytes']:.4g} B; roofline: compute "
            f"{row['compute_s']:.4f} s, memory {row['memory_s']:.4f} s, collective "
            f"{row['collective_s']:.4f} s, dominant {row['dominant']}")
    say("  (d) predictions from one H100's data-sheet constants "
        f"(repro_torch.launch.mesh.HW), not timings:\n"
        + roofline.to_markdown([roofline.analyze_cell(r) for r in recs], "single")
        + roofline.to_markdown([roofline.analyze_cell(r) for r in recs], "multi"))
    if cut:
        say(f"  (e) not run within {DRY_PROD_LIMIT_S} s, cut: {', '.join(cut)}")
    return recs


def dry_run_phase(dev, kernels):
    """Phase 26: (a) the kernel ops of one-card dry runs against the real
    steps' launches, (b) their non-kernel FLOPs against FlopCounterMode's
    (and falcon-mamba's prefill), (c) their peak memory against the card's,
    (d) the production meshes' records and roofline rows, (e) the phase's
    seconds."""
    import repro_torch.configs as cfgs
    from repro_torch.models import build
    from repro_torch.runtime.train_loop import TrainConfig, make_train_state, make_train_step

    started = time.perf_counter()
    out_dir = ROOT / "build" / "chip_smoke_dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    one, prod = dry_start(out_dir)
    try:
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        cfg = cfgs.get(DRY_ARCH)
        api = build(cfg)
        model = api.init(torch.Generator(device=dev).manual_seed(SEED))
        tokens = torch.as_tensor(np.random.default_rng(SEED + 26).integers(
            0, cfg.vocab_size, (SPMD_BATCH, SPMD_PROMPT + 1))).to(dev)
        real = {"prefill": real_step(
            f"{cfg.name} prefill {SPMD_BATCH} x {SPMD_PROMPT}",
            lambda: model.prefill({"tokens": tokens[:, :SPMD_PROMPT]}), before, kernels)}
        budget = SPMD_PROMPT + SPMD_STEPS
        caches = model.make_caches(SPMD_BATCH, budget)
        real["decode"] = real_step(
            f"{cfg.name} decode step at cache_index {budget - 1} of {budget} slots",
            lambda: model.decode({"tokens": tokens[:, -1:]}, caches, cache_index=budget - 1),
            before, kernels)
        del model, caches
        gc.collect()
        torch.cuda.empty_cache()
        tapi = build(cfg.replace(n_layers=TRAIN_LAYERS))
        state = make_train_state(tapi, TrainConfig(), device=dev)
        batch = markov_batch(tapi.cfg, dev)
        step = make_train_step(tapi, TrainConfig())
        real["train"] = real_step(
            f"{cfg.name} at {TRAIN_LAYERS} layers, one AdamW step on {TRAIN_BATCH} x {TRAIN_SEQ}",
            lambda: step(state, batch), before, kernels)
        del state, batch
        gc.collect()
        torch.cuda.empty_cache()
        dry_mamba(dev, kernels)
        out, err = one.communicate(timeout=600)
        if one.returncode != 0:
            raise AssertionError(f"the one-card dry runs failed:\n{err[-3000:]}")
        recs = json.loads(next(s for s in out.splitlines()
                               if s.startswith("RESULT"))[len("RESULT"):])
        for name in ("prefill", "decode", "train"):
            hold_dry(f"{cfg.name} {name} on a fake (1, 1) cuda mesh", recs[name], *real[name])
        dry_production(prod, out_dir, started)
    finally:
        for proc in (one, *prod.values()):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        gc.collect()
        torch.cuda.empty_cache()
    say(f"  (e) phase 26 took {time.perf_counter() - started:.1f} s")


# --------------------------------------------------------------------- #
# phase 27: the Mamba, MoE and hybrid families sharded
# --------------------------------------------------------------------- #
# On a one-rank NCCL mesh (as phase 25) the Mamba mixer runs channel-parallel
# with the scan kernel under local_map on its d_inner shard, the MoE runs
# expert-parallel under one local_map, and the loss goes vocabulary-parallel
# where "model" divides the vocabulary (on one rank it takes the whole table,
# as with no mesh): every logit, loss, gradient and updated weight must be
# the mesh-free path's bit for bit.  The dry-run cells of these families
# (train_4k and prefill_32k) run on fake CUDA tensors over a 16 x 16 fake
# process group, depth cut to stay within the phase's time, each in a subprocess
# started with the phase; and qwen3's train_4k cell at full depth with the
# loss vocabulary-parallel and, patched, with the whole table on every rank.
MESH_SERVE = {MAMBA_ARCH: {}, "llama4_maverick_400b_a17b": {"n_layers": 2}}
# training: falcon-mamba at MAMBA_TRAIN_LAYERS and batch MAMBA_TRAIN_BATCH as
# phase 12; llama4 at 2 layers and 8 experts, so that the mesh-free path's
# gradients and updated weights (kept on the host) and the mesh path's
# training state fit one card together
MESH_TRAIN = {MAMBA_ARCH: ({"n_layers": MAMBA_TRAIN_LAYERS}, None, MAMBA_TRAIN_BATCH),
              "llama4_maverick_400b_a17b": ({"n_layers": 2}, 8, TRAIN_BATCH)}
# the eight cells and their depth cuts (n_layers; None: as published): the
# training cells, whose plain scan backward and remat recompute take the
# longest to dry-run, cut to stay within the phase's time (a period for
# jamba); the prefill cells at full depth
DRY_CELLS = {("falcon_mamba_7b", "train_4k"): 4, ("falcon_mamba_7b", "prefill_32k"): None,
             ("jamba_1p5_large_398b", "train_4k"): 8,
             ("jamba_1p5_large_398b", "prefill_32k"): None,
             ("llama4_maverick_400b_a17b", "train_4k"): 4,
             ("llama4_maverick_400b_a17b", "prefill_32k"): None,
             ("arctic_480b", "train_4k"): 4, ("arctic_480b", "prefill_32k"): None}
DRY_CELLS_LIMIT_S = 240
DRY_CELL = """
import json
{patch}
from repro_torch.launch.dryrun import run_cell
print("RESULT" + json.dumps(run_cell({arch!r}, {shape!r}, False, {over!r}, device="cuda")))
"""
# the loss with the whole table on each rank (data_parallel), for comparison
WHOLE_TABLE_LOSS = """
import repro_torch.models.loss as loss
from repro_torch.sharding.hints import data_parallel
loss.vocab_parallel = lambda fn, whole_fn, rows, table: data_parallel(whole_fn, rows, (table,))
"""


def dry_cells_start():
    """The dry-run subprocesses: {label: (process, depth cut)}."""
    runs = {}
    for (arch, shape), layers in DRY_CELLS.items():
        code = DRY_CELL.format(patch="", arch=arch, shape=shape,
                               over={"n_layers": layers} if layers else None)
        runs[f"{arch} {shape}"] = (code, layers)
    for label, patch in (("vocabulary-parallel loss", ""),
                         ("whole table a rank (data_parallel)", WHOLE_TABLE_LOSS)):
        runs[f"{DRY_ARCH} train_4k, {label}"] = (DRY_CELL.format(
            patch=patch, arch=DRY_ARCH, shape="train_4k", over=None), None)
    return {label: (subprocess.Popen([sys.executable, "-c", code], env=_dry_env(),
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True), layers)
            for label, (code, layers) in runs.items()}


def dry_cells_read(procs, started, smi):
    """(d), (e): each cell's status, FLOPs and peak a card, its cut; qwen3's
    FLOPs and MODEL/HLO with the loss vocabulary-parallel and with the
    whole table a rank."""
    import repro_torch.configs as cfgs
    from repro_torch.launch import roofline

    recs, failed = {}, []
    for label, (proc, layers) in procs.items():
        try:
            out, err = proc.communicate(timeout=max(started + DRY_CELLS_LIMIT_S
                                                    - time.perf_counter(), 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            failed.append(f"{label}: not done within {DRY_CELLS_LIMIT_S} s")
            continue
        if proc.returncode != 0:
            failed.append(f"{label}: {err.strip().splitlines()[-1] if err.strip() else '?'}")
            say(f"  {label}: failed\n{err[-3000:]}")
            continue
        rec = json.loads(next(s for s in out.splitlines()
                              if s.startswith("RESULT"))[len("RESULT"):])
        recs[label] = rec
        cut = (f"depth cut {cfgs.get(rec['arch']).n_layers} -> {layers} layers"
               if layers else "full depth")
        say(f"  (d) {label} on the 16 x 16 mesh ({cut}): status {rec['status']}, "
            f"{rec['dot_flops_per_device']:.6g} FLOPs a card, peak "
            f"{rec['memory']['peak_bytes_per_device'] / 2**30:.2f} GiB a card, kernel ops "
            f"{rec['kernel_ops']}, collectives {rec['collectives']['count']}, trace "
            f"{rec['trace_s']:.1f} s")
    for label, rec in recs.items():
        if label.startswith(DRY_ARCH):
            row = roofline.analyze_cell(rec)
            say(f"  (e) {label}: {rec['dot_flops_per_device']:.6g} FLOPs a card, MODEL/HLO "
                f"{row['useful_ratio']:.4f}, compute {row['compute_s']:.4f} s, collective "
                f"{row['collective_s']:.4f} s, dominant {row['dominant']} ({smi})")
    if failed or any(r["status"] != "ok" for r in recs.values()):
        raise AssertionError("(d) dry-run cells did not reach ok: " + "; ".join(failed))


def mesh_serve_case(arch, over, mesh, dev, kernels):
    """(b): ``arch`` (cut by ``over``) served on the mesh (serve specs)
    against the same weights without it: SPMD_BATCH x SPMD_PROMPT prompt
    tokens, SPMD_STEPS greedy decode steps (the mesh-free path's tokens fed
    to both); logits bit-identical; the launches under the mesh, one flash
    an attention layer's prefill, one decode an attention layer and step,
    one scan a Mamba layer's prefill."""
    import repro_torch.configs as cfgs
    from repro_torch.models import build
    from repro_torch.sharding.hints import mesh_axes, use_mesh
    from repro_torch.sharding.specs import distribute_batch, distribute_model

    cfg = cfgs.get(arch).replace(**over)
    api = build(cfg)
    model = api.init(torch.Generator(device=dev).manual_seed(SEED))
    tokens = torch.as_tensor(np.random.default_rng(SEED + 27).integers(
        0, cfg.vocab_size, (SPMD_BATCH, SPMD_PROMPT))).to(dev)
    fed = []

    def run(batch_of):
        logits, caches = model.prefill(batch_of({"tokens": tokens}),
                                       seq_budget=SPMD_PROMPT + SPMD_STEPS)
        out = [_full(logits)]
        for j in range(SPMD_STEPS):
            if len(fed) == j:
                fed.append(torch.argmax(out[-1], -1).to(torch.int32)[:, None])
            logits, caches = model.decode(batch_of({"tokens": fed[j]}), caches,
                                          cache_index=SPMD_PROMPT + j)
            out.append(_full(logits))
        return out

    ref = run(lambda b: b)
    distribute_model(model, mesh, mode="serve")
    zero_counts(kernels)
    with use_mesh(mesh), mesh_axes(SPMD_AXES):
        got = run(lambda b: distribute_batch(b, mesh))
    torch.cuda.synchronize()
    counts = {k: n for k, n in launch_counts(kernels).items() if n}
    layers = [s.mixer for s in cfg.pattern] * cfg.n_repeats
    want = {name: n for name, n in (
        ("flash_attention_sm90", layers.count("attn")),
        ("decode_attention_sm90", layers.count("attn") * SPMD_STEPS),
        ("mamba_scan_sm90", layers.count("mamba"))) if n}
    same = [torch.equal(a, b) for a, b in zip(got, ref)]
    say(f"  (b) {cfg.name} served ({cfg.n_layers} of {cfgs.get(arch).n_layers} layers"
        f"{', ' + str(cfg.moe.n_experts) + ' experts' if cfg.moe else ''}) on the mesh: "
        f"launches {counts} (want {want}); prefill and {SPMD_STEPS} decode steps' logits "
        f"bit-identical to the mesh-free path's: {same}; largest |diff| "
        f"{max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref)):.3e}")
    if counts != want:
        raise AssertionError(f"(b) {cfg.name}: launches under the mesh {counts}, not {want}")
    if not all(same) or not all(torch.isfinite(a).all() for a in got):
        raise AssertionError(f"(b) {cfg.name}: logits under the mesh differ from without it")


def mesh_train_case(arch, over, experts, batch_size, mesh, dev, kernels):
    """(c): ``arch`` (cut) trained one make_train_step(axes=...) step on
    DTensor parameters against the mesh-free step on the same weights and
    batch: the loss and gradients of loss_and_grads, the step's loss,
    grad_norm and updated weights, all bit-identical (the mesh-free ones
    kept on the host); the step's launches: the scan once a Mamba layer (its
    backward is the plain scan's), the flash pair once an attention layer,
    the forward again under remat."""
    import repro_torch.configs as cfgs
    from repro_torch.data import MarkovDataset
    from repro_torch.models import build
    from repro_torch.runtime.train_loop import (TrainConfig, loss_and_grads,
                                                make_train_state, make_train_step)
    from repro_torch.sharding.hints import mesh_axes, use_mesh
    from repro_torch.sharding.specs import distribute_batch, distribute_model

    cfg = cfgs.get(arch).replace(**over)
    if experts:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=experts))
    api = build(cfg)
    tc = TrainConfig(warmup_steps=1, total_steps=10)
    ds = MarkovDataset(cfg.vocab_size, TRAIN_SEQ, batch_size, seed=SEED + 27)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in ds.batch_at(0).items()}
    host = lambda d: {k: v.detach().cpu() for k, v in d.items()}  # noqa: E731

    state = make_train_state(api, tc, device=dev)
    loss0, _, g0 = loss_and_grads(api, state["params"], batch)
    g0 = host(g0)
    state, m0 = make_train_step(api, tc)(state, batch)
    p0 = host(dict(state["params"].named_parameters()))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    params = api.init(torch.Generator(device=dev).manual_seed(tc.seed))
    state = make_train_state(api, tc, params=distribute_model(params, mesh))
    with use_mesh(mesh), mesh_axes(SPMD_AXES):
        loss1, _, g1 = loss_and_grads(api, state["params"], distribute_batch(batch, mesh))
    same_g = all(torch.equal(_full(g).cpu(), g0[k]) for k, g in g1.items())
    del g1
    zero_counts(kernels)
    state, m1 = make_train_step(api, tc, axes=SPMD_AXES)(state, batch)
    torch.cuda.synchronize()
    counts = {k: n for k, n in launch_counts(kernels).items() if n}
    same_p = all(torch.equal(_full(p.detach()).cpu(), p0[k])
                 for k, p in state["params"].named_parameters())
    same_m = all(torch.equal(_full(m1[k]), m0[k]) for k in ("loss", "grad_norm"))
    layers = [s.mixer for s in cfg.pattern] * cfg.n_repeats
    attn = layers.count("attn")
    want = {name: n for name, n in (
        ("flash_attention_sm90", attn * (2 if cfg.remat else 1)),
        ("flash_bwd_dq_sm90", attn), ("flash_bwd_dkv_sm90", attn),
        ("mamba_scan_sm90", layers.count("mamba") * (2 if cfg.remat else 1))) if n}
    say(f"  (c) {cfg.name} trained ({cfg.n_layers} layers"
        f"{', ' + str(cfg.moe.n_experts) + ' experts' if cfg.moe else ''}, batch "
        f"{batch_size} x {TRAIN_SEQ}, {cfg.opt_state_dtype} moments) on the mesh: loss "
        f"{_full(loss1).item():.6f} (without {loss0.item():.6f}); loss, gradients, the "
        f"step's loss and grad_norm ({_full(m1['grad_norm']).item():.6f}) and updated "
        f"weights bit-identical: {torch.equal(_full(loss1), loss0)}, {same_g}, {same_m}, "
        f"{same_p}; the step's launches {counts} (want {want})")
    if counts != want:
        raise AssertionError(f"(c) {cfg.name}: the step launched {counts}, not {want}")
    if not (torch.equal(_full(loss1), loss0) and same_g and same_m and same_p):
        raise AssertionError(f"(c) {cfg.name}: the step on the mesh differs from without it")
    del state
    gc.collect()
    torch.cuda.empty_cache()


def mesh_families_phase(dev, kernels, smi):
    """Phase 27: (a) the mesh, (b) falcon-mamba at full size and llama4 at 2
    layers served on it, (c) trained on it, (d) the dry-run cells of these
    families, (e) qwen3's train_4k cell with the loss
    vocabulary-parallel and with the whole table a rank, (f) the phase's
    seconds."""
    import torch.distributed as dist

    started = time.perf_counter()
    procs = dry_cells_start()
    try:
        mesh = spmd_mesh()
        try:
            for arch, over in MESH_SERVE.items():
                mesh_serve_case(arch, over, mesh, dev, kernels)
                gc.collect()
                torch.cuda.empty_cache()
            for arch, (over, experts, batch) in MESH_TRAIN.items():
                mesh_train_case(arch, over, experts, batch, mesh, dev, kernels)
        finally:
            dist.destroy_process_group()
        dry_cells_read(procs, started, smi)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        gc.collect()
        torch.cuda.empty_cache()
    say(f"  (f) phase 27 took {time.perf_counter() - started:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch.configs as cfgs
    from repro_torch import kernels
    from repro_torch.core import LookupService, Service
    from repro_torch.kernels import decode_attention as decode
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import mamba_scan as scan
    from repro_torch.kernels.build import build_all
    from repro_torch.models import build
    from repro_torch.runtime.serve_loop import ServeConfig, serve_requests

    dev = torch.device("cuda", 0)
    phase("phase 1: build")
    t0 = time.perf_counter()
    lib_s = {}
    probe = start_register_probe()
    logs = build_all(kernels.KERNELS, lib_s)
    build_s = time.perf_counter() - t0
    say(f"  kernels built in {build_s:.2f} s, one nvcc a library in parallel: "
        + (", ".join(f"{name} {sec:.2f} s" for name, sec in sorted(lib_s.items()))
           or "already built"))
    for log in logs.values():
        say_registers(log)
    for kern in (flash.SM90_KERNEL, flash.SM90_FP32_KERNEL, flash.DQ_SM90_KERNEL,
                 flash.DKV_SM90_KERNEL, flash.DQ_SM90_FP32_KERNEL,
                 flash.DKV_SM90_FP32_KERNEL):
        say_sass(kern)
    for kern in (decode.KERNEL, scan.KERNEL):
        say_sass(kern, ("LDGSTS",))
    tile_smem_queries(flash)
    say_register_probe(probe, logs)
    say_async_smem(decode, scan)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    say(smi)

    phase("phase 2: kernels vs plain versions")
    k_rows = kernel_phase(flash, decode)

    phase("phase 3: serve")
    cfg = cfgs.get(ARCH)
    api = build(cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    say(f"  {cfg.name}: {sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
        f"params in {cfg.param_dtype} on {dev}, initialised in "
        f"{time.perf_counter() - t0:.2f} s; fp32 unembedding copy "
        f"{params.head().table_f32().numel() * 4 / 1e9:.3f} GB")
    lookup = LookupService()
    services = [Service(lookup, device=dev) for _ in range(SERVICES)]
    for s in services:
        s.start()
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                   (REQUESTS, PROMPT))
    sc = ServeConfig(max_new_tokens=NEW, prompt_len=PROMPT,
                     batch_per_task=PER_TASK)
    # warm-up (cuBLAS handles, allocator), not counted
    serve_requests(api, params, prompts[:PER_TASK],
                   ServeConfig(max_new_tokens=2, prompt_len=PROMPT,
                               batch_per_task=PER_TASK), lookup=lookup)
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    gen, stats = serve_requests(api, params, prompts, sc, lookup=lookup)
    wall = time.perf_counter() - t0
    launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    n_tasks = REQUESTS // PER_TASK
    say(f"  served {tuple(gen.shape)} tokens in {wall:.3f} s: "
        f"{gen.numel() / wall:.1f} tok/s across {SERVICES} services; "
        f"{stats['done']} tasks, {stats['reschedules']} reschedules; peak "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    say(f"  launches on the main path: {launches}")
    if tuple(gen.shape) != (REQUESTS, NEW):
        raise AssertionError(f"generated shape {tuple(gen.shape)}")
    if not (int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size):
        raise AssertionError("generated token ids out of range")
    if launches["flash_attention_sm90"] < n_tasks * cfg.n_layers:
        raise AssertionError("flash kernel launched fewer times than prefill needs")
    if launches["flash_attention_sm90_fp32"]:
        raise AssertionError("the fp32 flash kernel ran on the bf16 serve path")
    if launches[decode.KERNEL.name] < n_tasks * cfg.n_layers * NEW:
        raise AssertionError("decode kernel launched fewer times than decode needs")

    one_task = time_one_task(api, params, torch.as_tensor(prompts[:PER_TASK]).to(dev), NEW)

    phase("phase 4: full width, kernels vs plain versions")
    full_width_phase(api, params, cfg, dev, kernels.PLAIN)

    phase("phase 5: backward kernels vs the plain backward")
    bwd = backward_phase(flash)

    phase("phase 6: sync training at full width, depth cut")
    del params
    tcfg = cfg.replace(n_layers=TRAIN_LAYERS)
    tapi = build(tcfg)
    say("  reduced: " + json.dumps([f"n_layers {cfg.n_layers} -> {TRAIN_LAYERS} for "
                                    "phases 6-7, widths as published"]))
    train_launches, state = sync_training_phase(
        tapi, tapi.init(torch.Generator(device=dev).manual_seed(SEED)), dev, kernels)

    phase("phase 7: full-width training step, kernels vs plain versions")
    train_step_agreement(tapi, state["params"], markov_batch(tcfg, dev), kernels.PLAIN,
                         TRAIN_LIMITS[torch.bfloat16])
    del state
    torch.cuda.empty_cache()
    api32 = build(tcfg.replace(param_dtype="float32", compute_dtype="float32"))
    model32 = api32.init(torch.Generator(device=dev).manual_seed(SEED))
    model32.requires_grad_(True)
    model32.head().drop_f32()
    for kern in kernels.KERNELS:
        kern.launches = 0
    train_step_agreement(api32, model32, markov_batch(tcfg, dev), kernels.PLAIN,
                         TRAIN_LIMITS[torch.float32])
    fp32_launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    say(f"  launches on the fp32 training step: {fp32_launches}")
    if (any(fp32_launches[name] != tcfg.n_layers for name in FP32_TRAIN_KERNELS)
            or any(fp32_launches[name] for name in BF16_TRAIN_KERNELS)):
        raise AssertionError("the fp32 training step did not go through the fp32 "
                             "flash kernels (forward, dq, dk/dv) once per layer, "
                             "and only through them")
    del model32
    torch.cuda.empty_cache()

    phase("phase 8: farm-mode training")
    farm_phase(cfg, dev, lookup, services, kernels)
    del api
    free(services)  # their cached programs hold qwen3's weights
    say(f"  qwen3 state freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "still allocated")

    phase("phase 9: scan kernel vs plain")
    mcfg, jcfg = cfgs.get(MAMBA_ARCH), cfgs.get(JAMBA)
    scan_err, scan_row = scan_phase(scan, PER_TASK, PROMPT, mcfg.d_inner,
                                    mcfg.ssm.state_dim)
    jscan_err, jscan_row = scan_phase(scan, PER_TASK, PROMPT, jcfg.d_inner,
                                      jcfg.ssm.state_dim)

    phase("phase 10: serve falcon-mamba-7b")
    for svc in services:  # phase 8 failed one on purpose
        svc.revive()
    mapi, mparams, mamba_launches = mamba_serve_phase(mcfg, dev, lookup, kernels)

    phase("phase 11: falcon-mamba-7b full width, kernels vs plain versions")
    full_width_phase(mapi, mparams, mcfg, dev, kernels.PLAIN,
                     MAMBA_FULL_WIDTH_BATCHES,
                     MAMBA_FULL_WIDTH_LIMITS[torch.bfloat16])
    full_params = sum(p.numel() for p in mparams.parameters())
    del mapi, mparams
    free(services)
    say("  the same in fp32 (fresh fp32 weights)")
    cfg32 = mcfg.replace(param_dtype="float32", compute_dtype="float32")
    api32 = build(cfg32)
    model32 = api32.init(torch.Generator(device=dev).manual_seed(SEED))
    full_width_phase(api32, model32, cfg32, dev, kernels.PLAIN, 2,
                     MAMBA_FULL_WIDTH_LIMITS[torch.float32])
    del api32, model32
    free(services)

    phase("phase 12: falcon-mamba-7b sync training, depth cut")
    mamba_train_phase(mcfg, dev, kernels, full_params)
    gc.collect()
    torch.cuda.empty_cache()

    phase("phase 13: serve on worker processes (proc://, shm://)")
    now = worker_phase(prompts, gen, kernels)
    tok = REQUESTS * NEW
    say(f"  {smi}: in-process (phase 3, {SERVICES} services) {wall:.3f} s, "
        f"{tok / wall:.1f} tok/s; proc:// cold {now['cold']:.3f} s "
        f"({tok / now['cold']:.1f} tok/s, start-up to first result "
        f"{now['startup']:.3f} s), warm {now['warm']:.3f} s "
        f"({tok / now['warm']:.1f} tok/s), with a kill {now['kill']:.3f} s "
        f"({tok / now['kill']:.1f} tok/s); shm:// cold {now['shm']:.3f} s "
        f"({SHM_REQUESTS * NEW / now['shm']:.1f} tok/s)")

    phase("phase 14: serve on tcp:// workers behind a network lookup")
    tcp = tcp_phase(prompts, gen, kernels)
    rounds = "; ".join(
        f"{name} {tcp[key]:.3f} s ({tok / tcp[key]:.1f} tok/s, proc:// "
        f"{now[key]:.3f} s)" if key in now else
        f"{name} {tcp[key]:.3f} s ({tok / tcp[key]:.1f} tok/s, "
        f"{tcp[key] / tcp['warm']:.2f}x warm)"
        for name, key in (("cold", "cold"), ("warm", "warm"),
                          ("after the lookup restart", "restart"),
                          ("with a kill", "kill")))
    say(f"  {smi}: in-process (phase 3) {wall:.3f} s, {tok / wall:.1f} tok/s; "
        f"tcp:// start-up to first result {tcp['startup']:.3f} s (proc:// "
        f"{now['startup']:.3f} s); {rounds}")

    phase("phase 15: serve minicpm3-4b (MLA), phi-3-vision-4.2b and whisper-tiny")
    gc.collect()
    torch.cuda.empty_cache()
    family_launches = {}
    for arch in FAMILIES:
        family_launches[arch] = family_phase(arch, dev, lookup, kernels)
        free(services)
        say(f"  {arch} freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")

    phase("phase 16: train minicpm3-4b (MLA), phi-3-vision-4.2b and whisper-tiny")
    trained = {}
    for arch in FAMILIES:
        trained[arch] = family_train_phase(arch, dev, kernels)
        gc.collect()
        torch.cuda.empty_cache()
        say(f"  {arch} freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")

    phase("phase 17: serve llama4-maverick-400b-a17b and arctic-480b (MoE), depth cut")
    for arch in MOE_FAMILIES:
        family_launches[arch] = family_phase(arch, dev, lookup, kernels, MOE_LAYERS[arch])
        free(services)
        say(f"  {arch} freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")

    phase("phase 18: train llama4-maverick-400b-a17b and arctic-480b (MoE), depth and "
        "experts cut, remat")
    for arch in MOE_FAMILIES:
        trained[arch] = moe_train_phase(arch, dev, kernels)
        gc.collect()
        torch.cuda.empty_cache()
        say(f"  {arch} freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")

    phase("phase 19: serve jamba-1.5-large-398b (hybrid), one period, experts cut; long "
        "context")
    family_launches[JAMBA] = family_phase(JAMBA, dev, lookup, kernels, JAMBA_LAYERS,
                                          JAMBA_EXPERTS, then=long_context_phase)
    free(services)
    say(f"  {JAMBA} freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")
    long_context_fp32_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()

    phase("phase 20: minicpm3-4b (MLA) and phi-3-vision-4.2b in fp32, depth cut: one "
          "training step and serving, kernels vs plain versions")
    fp32_launches_d96 = {}
    for arch in FP32_FAMILIES:
        fp32_launches_d96[arch] = fp32_family_phase(arch, dev, kernels)
        gc.collect()
        torch.cuda.empty_cache()
        say(f"  {arch} freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")

    phase("phase 21: model programs batched through Service.execute_batch (vmap, each "
          "kernel folded)")
    t21 = time.perf_counter()
    fold_checks(flash, decode, scan, sorted({(c.d_inner, c.ssm.state_dim)
                                             for c in (mcfg, jcfg)}))
    batched_serve_phase(dev, kernels, one_task)
    free(services)
    for arch, layers, dtype, limits in BATCH_MODELS:
        batched_family(arch, layers, dtype, limits, dev, kernels)
    say(f"  phase 21 took {time.perf_counter() - t21:.1f} s")

    phase("phase 22: the port's examples (serving farm, training run, autotuner) on the "
          "card")
    examples_phase()

    phase("phase 23: the autotuner (repro_torch.tune) on the card")
    tune_phase(cfg, dev, kernels, flash, decode, scan, logs, build_s,
               k_rows["flash"]["host_us"], launches)

    phase("phase 24: training programs batched through Service.execute_batch (the "
          "local-SGD round under vmap(grad), each kernel folded)")
    batched_train_phase(scan, dev, kernels)
    gc.collect()
    torch.cuda.empty_cache()

    phase("phase 25: the SPMD layer on one card (a one-rank mesh, local_map, the head "
          "plans and the decode merge serialized, the chunked flash's manual backward)")
    spmd_phase(dev, kernels, flash, decode)

    phase("phase 26: the dry run held to the card (kernel ops, FLOPs and peak memory "
          "against one card's steps; the production meshes' records and roofline)")
    dry_run_phase(dev, kernels)

    phase("phase 27: the Mamba, MoE and hybrid families sharded (the scan under local_map "
          "on d_inner, expert-parallel MoE, vocabulary-parallel loss; the dry run's cells)")
    mesh_families_phase(dev, kernels, smi)

    say(f"all phases in {time.perf_counter() - START:.1f} s")
    # the kernels line: (name, kernel, its times, its largest |error|, the
    # Pallas call it replaces, the launch counts of the path that reports it)
    flash_py = "src/repro/kernels/flash_attention/flash_attention.py"
    decode_py = "src/repro/kernels/decode_attention/decode_attention.py"
    table = [
        ("flash_attention_fwd", flash.SM90_KERNEL, k_rows["flash"],
         k_rows["flash"]["err"], f"{flash_py}:127", launches),
        ("flash_attention_fwd_fp32", flash.SM90_FP32_KERNEL, k_rows["flash_fp32"],
         k_rows["flash_fp32"]["err"], f"{flash_py}:127", fp32_launches),
        ("decode_attention_fwd", decode.KERNEL, k_rows["decode"], k_rows["decode"]["err"],
         f"{decode_py}:116", launches),
        ("mamba_scan_fwd", scan.KERNEL, scan_row, scan_err,
         "src/repro/kernels/mamba_scan/mamba_scan.py:83", mamba_launches),
        ("flash_attention_fwd_d96_dv64", flash.SM90_KERNEL, k_rows["d96_dv64"],
         k_rows["d96_dv64"]["err"], f"{flash_py}:127", family_launches["minicpm3_4b"]),
        ("flash_attention_fwd_d96", flash.SM90_KERNEL, k_rows["d96"],
         k_rows["d96"]["err"], f"{flash_py}:127", family_launches["phi3_vision_4p2b"]),
        ("decode_attention_fwd_d96", decode.KERNEL, k_rows["decode_d96"],
         k_rows["decode_d96"]["err"], f"{decode_py}:116", family_launches["phi3_vision_4p2b"]),
    ]
    # phase 17's odd GQA groups: G = 5 (llama4), G = 7 (arctic); phase 19's
    # G = 8 (jamba)
    for sfx, arch in (("g5", "llama4_maverick_400b_a17b"), ("g7", "arctic_480b"),
                      ("g8", JAMBA)):
        table += [(f"flash_attention_fwd_{sfx}", flash.SM90_KERNEL, k_rows[sfx],
                   k_rows[sfx]["err"], f"{flash_py}:127", family_launches[arch]),
                  (f"decode_attention_fwd_{sfx}", decode.KERNEL, k_rows[f"decode_{sfx}"],
                   k_rows[f"decode_{sfx}"]["err"], f"{decode_py}:116", family_launches[arch])]
    table.append(("mamba_scan_d16384", scan.KERNEL, jscan_row, jscan_err,
                  "src/repro/kernels/mamba_scan/mamba_scan.py:83", family_launches[JAMBA]))
    # phase 20's fp32 forward at (96, 64) and (96, 96)
    for sfx, arch in (("d96_dv64", "minicpm3_4b"), ("d96", "phi3_vision_4p2b")):
        r = k_rows[f"fp32_{sfx}"]
        table.append((f"flash_attention_fwd_fp32_{sfx}", flash.SM90_FP32_KERNEL, r, r["err"],
                      f"{flash_py}:127", fp32_launches_d96[arch]))
    # the backward rows: one BWD_SHAPES label and dtype each, with the
    # launches of the training run that gives the pair that shape
    for sfx, label, dt, count in (
            ("", "qwen3", torch.bfloat16, train_launches),
            ("_fp32", "qwen3", torch.float32, fp32_launches),
            ("_d96_dv64", "minicpm3 MLA", torch.bfloat16, trained["minicpm3_4b"]),
            ("_d96", "phi-3 with patches", torch.bfloat16, trained["phi3_vision_4p2b"]),
            ("_whisper", "whisper encoder", torch.bfloat16, trained["whisper_tiny"]),
            ("_g5", "llama4 G=5", torch.bfloat16, trained["llama4_maverick_400b_a17b"]),
            ("_g7", "arctic G=7", torch.bfloat16, trained["arctic_480b"]),
            ("_fp32_d96_dv64", "minicpm3 MLA", torch.float32, fp32_launches_d96["minicpm3_4b"]),
            ("_fp32_d96", "phi-3 with patches", torch.float32,
             fp32_launches_d96["phi3_vision_4p2b"])):
        for part, kern, line in zip(("dq", "dkv"), flash.backward_kernels(dt), (280, 307)):
            r = bwd[(label, dt)][part]
            table.append((f"flash_attention_bwd_{part}{sfx}", kern, r, r["err"],
                          f"{flash_py}:{line}", count))
    rows = [{"name": name, "route": "cuda", "source": str(kern.source.relative_to(ROOT)),
             "replaces": replaces, "launches": count[kern.name], "max_abs_err": err,
             "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"],
             "library": r.get("library"), "knobs": TUNABLE_KNOBS.get(kern.name, {})}
            for name, kern, r, err, replaces, count in table]
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
