#!/usr/bin/env python3
"""Drive the PyTorch port's serving, SGD training and ALS paths, its bias,
neighbourhood and content models, its KernelMF sweep, its native host
packs, its sparse-gram top-k CF, EASE, BPR, SVD++, NMF and Popularity, the
recipe recommender's serving path, the batch pipeline and multi-device
KernelMF (SGD and ALS), bias models, NMF, BPR, SVD++, EASE and the CF
models, retrieval and the hybrid evaluation on a mesh and sharded
checkpoints on one CUDA GPU and check them.

    python3 chip_smoke.py [--seed N]

Needs one CUDA GPU, ``nvcc`` and the checkout around this file; it fails
(non-zero exit, no result line) without them. Imports nothing of JAX or
of ``matrix_factorization_tpu``. Each phase prints one JSON line; any
failed check ends the run with a non-zero exit:

1. device: the card (``nvidia-smi`` name and power limit), torch, CUDA;
   TF32 off for every f32 product.
2. build: every ``csrc/*.cu`` of the port (the scorer, the SGD step and
   apply, the GJ SPD leaf, the segment sum, the top-k selection), compiled
   for sm_90a, all ``nvcc`` processes at once; each kernel's registers,
   spill and stack bytes from ptxas (the scorer, the GJ leaf, the SGD
   step, the segment sum and the top-k must not spill).
3. compare: the catalog-scoring kernel against its plain PyTorch version
   on the card, for kernels linear/sigmoid/rbf, f32 and bf16 tables, at
   (B, I, Kp) = (1, 59392, 256), (B_s, 59392, 256), (B_s + 1, 59392, 256)
   and (256, 59392, 256) (the two sides of the streaming/tiled boundary
   B_s), (5, 1000, 128), (3, 777, 1024) and (70, 1000, 1024) (I not a
   multiple of any tile); atol = rtol = 1e-4 (both sum in f32, in
   different orders). Then the cross-path check: every row of the B=256
   scores equals, bitwise, the same user scored alone (B=1, streaming)
   and inside a batch of B_s.
4. serve: MovieLens-25M KernelMF at full width (162,000 x 59,392, k=200,
   gamma 1/200, ratings in [0.5, 5]; ``BASELINE.json`` config 3) for
   sigmoid and rbf, random tables from ``--seed``: ``params_from_numpy``
   -> ``save_model`` -> ``load_model`` on the card -> ``predict`` (4,096
   pairs with unknown ids, against a float64 numpy reference) ->
   ``recommend`` with known items -> ``recommend_batch`` of 256 users
   (top-k sets against the plain scorer on the card) -> 64 concurrent
   requests through ``CoalescingRecommender`` (each equal to a direct
   ``recommend``). Launch counts are zeroed before this phase; each
   catalog step must launch the kernel.
5. latency / kernel_time: serving latencies; the scorer's kernel, plain
   and library (cuBLAS GEMM + torch epilogue: f32 for f32 tables, bf16
   with f32 output for bf16 tables, and the f32 GEMM on the widened bf16
   values as ``library_f32_ms``) times with CUDA events (median, L2
   flushed before each launch, then a device spin so that the window
   holds device time only: ``Timer``) and the bound of each shape, at
   B = 1, 16, 64 and 256, every kernel and table type.
5a. topk_kernel_time: the top-k selection kernel (``csrc/topk_select.cu``,
   ``ops/cuda_topk.py``) at ``dense_topk``'s blocks over RecipeNLG's
   2,231,142 items (60 rows at k 100 and 500, the 16-row tail at k 100,
   60 rows rounded to 1/64 so that ties straddle the cut): bitwise equal
   to the torch selection body and to a second run, no host sync inside
   the call (``set_sync_debug_mode("error")``); kernel, plain and library
   (``torch.topk`` alone, whose order among ties is unstated) times
   (``Timer``) and the bound (the scores read once, the answers written
   once). The kernel's launches are counted over the whole run (every
   selection block of the later phases: the recipe search, config 4's CF
   strips, EASE, TF-IDF).
6. data / pack: config-3 ratings (25M unique pairs of 162,000 x 59,392,
   half stars, as ``benchmarks/run_configs.py::_gen`` makes them, plus
   4,096 held out), the headline ratings of ``bench.py`` (2M, 10,000 x
   20,000), each packed once on the card (``pack_ratings``,
   ``order='auto'``).
6a. host_native: the host library (``csrc/host_loader.cpp``, g++) built
   and its seconds; ``load_ratings_csv`` of a 1M-row CSV of the config-2
   ratings, native against pandas (equal arrays); the config-3 pack
   (``order='auto'``, bs 2,097,152) and the config-3 ALS bucket packs,
   native against numpy (every tensor equal), seconds for each. Every
   later pack and fit packs natively.
7. compare_sgd: the SGD step kernel + the apply kernel against the plain
   step on the card, same tables and batch: config-3 sigmoid (bs 2M, Kp
   256, user-primary), config-3 rbf (bs 1M), a skewed config-3 batch
   (both ids drawn as floor(rows * U^2): one user run of ~5,000 entries),
   the headline linear batch (bs 131,072, Kp 128, item-primary), k=126
   (Kp 128, no spare lane), a frozen item side and the config-1 sweep's
   pack (first and last batch); both tables at atol = rtol = 1e-5, and
   two runs of the kernels bitwise equal; the apply alone on the plain
   step's deltas bitwise equal to its plain order model and to a second
   run.
8. train (sigmoid, rbf): config 3 through ``KernelMF.fit`` (3 epochs,
   falling train RMSE) and ``update_users`` (1,000 users, half of them
   known; the item table bitwise unchanged) with the step and apply
   counts zeroed just before and read just after; ``predict`` on the
   held-out pairs and ``recommend``; then updates/s (median of 3
   one-epoch windows on the pack made once), one epoch against the plain
   step (atol 1e-4), the epoch repeated (bitwise equal) and a profiled
   epoch (device busy share, top kernels).
9. golden: the golden mini fixture trained on the card, held-out RMSE
   within 1e-3 of the pinned oracle values (3 kernels x 2 pack orders).
10. train_headline: ``bench.py``'s shape, updates/s over a 20-epoch
    window, median of 5, beside the card's name and power limit.
11. sgd_kernel_time: the step and the apply on the first batch of the
    config-3 sigmoid and rbf packs, on the skewed config-3 batch, on the
    first batch of the headline pack and of the config-1 sweep's pack:
    kernel, plain and library (``index_add_`` for the apply) times
    (``Timer``), the bounds computed from that batch, and its longest
    primary run.

12. als_pack: config 3 grouped into count buckets once (by user: chunks of
    15,625 x 256; by item: 7,812 x 512).
12a. normal_eq_kernel_time: the normal-equation kernel
    (``ials.normal_equations`` on the card) against
    ``plain_normal_equations`` on the first full user chunk (d = 201) and
    on the first 256 entities of the shortest bucket past one 1,024-slot
    slice (the finish kernel), against the seeded initial tables: A and b
    within 1e-5 of the plain body's largest entry, two calls the same
    bits; kernel, plain and library (the batched product alone) times
    and the bound. The kernel's launches are counted on every ALS path
    from here on.
12b. spd_block_solve_time: the block solve's kernels on the same chunk's
    systems (``ials.normal_equations`` on the card): ``mf_spd_split``
    against ``plain_spd_split`` bit for bit, ``mf_spd_block_solve``
    against ``plain_block_solve`` at refine 1 within 1e-6 of the largest
    |x|, two calls the same bits, one launch a call; kernel, plain and
    library (what each replaced: the scaling's broadcast products; the
    explicit inverse applied, the residual, applied again) times and the
    bytes bound. Both kernels' launches are counted on every ALS path from
    here on.
13. compare_spd: the GJ leaf kernel against its plain version on the card,
    both against the float64 inverse, at (E, d) = (15,625, 104),
    (15,625, 97), (7,812, 101), (1,000, 128), (4,096, 64), (3, 8), (5, 1)
    on Jacobi-scaled ridged grams of seeded rows, and on the two leaves
    (104 and 97) of the first full config-3 user chunk at k=200; atol =
    rtol = 1e-4 between the two, ``max|A X - I| < 5e-3``.
14. train_als: ``KernelMF(method='als')`` at config 3, k=200, reg 0.1 per
    observation, through ``fit`` (3 sweeps, bucketed, falling RMSE) and
    ``update_users`` (1,000 users, half known; items bitwise unchanged)
    with the GJ count zeroed just before and read just after; ``predict``,
    ``recommend`` and a checkpoint round trip. als_sweeps: one sweep's
    seconds at k=200 and k=100 on the buckets of 12; the first full user
    chunk's system solved with the Cholesky leaf against the GJ leaf (atol
    1e-4); the sweep repeated (bitwise equal); a profiled sweep and the
    GJ leaf's share of its device time.
15. warm_start: a sigmoid ``KernelMF`` (k=200, bs 2,097,152) with one ALS
    warm sweep and one SGD epoch on the first 2.5M config-3 ratings, GJ
    and SGD counts > 0, its train RMSE below a cold fit's.
16. implicit: ``ImplicitALS()`` (k=64) on 1M seeded interactions of
    6,040 x 3,706: ``fit`` (3 epochs, falling loss), ``update_users`` of
    100 new users, ``recommend``; GJ count > 0.
17. spd_kernel_time: the GJ leaf's kernel, plain and library
    (``torch.linalg.inv``) times at the first five shapes of 13, and
    their bounds.
17a. cf_topk: ``BASELINE.json`` config 4 at full scale: ``TopKItemItemCF``
    (50 neighbours) on the 25M config-3 ratings, ``fit`` seconds and peak
    memory, one strip timed by its parts (host sort and windows, tile
    builds + exact f32 GEMMs, cosine + ``stable_topk``, the top-k alone), a
    bulk ``predict`` of 1M seeded pairs, 64 sampled columns against a
    float64 scipy.sparse centered cosine (values within 1e-5, ids where
    separated by more than 1e-5), 4,096 predictions against a float64
    replay of the formula on the fitted lists (1e-4); then user-user
    ``similarity_topk(i, u, r, ...)`` once, timed, 16 of its columns held
    the same way, and its strip split.
17b. bpr, svdpp, nmf: each family at the MovieLens-25M shape its JAX
    bench uses (k=64, Kp 128, bs 1,048,576, 3 epochs) on the config-3
    ratings (BPR takes them as positives), from one user-primary pack
    made once: one epoch through ``mf_segment_apply`` (BPR, SVD++)
    or ``mf_segment_sum`` (NMF) against the same epoch through their plain
    versions on the card, same tables and draws (atol 1e-4, SVD++ 2e-4),
    the kernel epoch twice bitwise; updates/s (median of 3 one-epoch
    windows on the pack made once); then ``fit`` and ``update_users``
    (1,000 users, half known; the item table, and SVD++'s Y, bitwise
    unchanged) with the apply, segment-sum and scorer counts zeroed just
    before and read after serving: BPR's visited loss and SVD++'s train
    RMSE fall, NMF's never rises and its factors stay >= 0; ``predict`` on
    the held-out pairs against a float64 replay of the served formula
    (1e-4); ``recommend`` and a 256-user ``recommend_batch`` on the scorer,
    top-10 sets equal to the plain scorer's; BPR's ``auc`` on the held-out
    pairs (at chance: the ratings are uniform) and on 4,096 trained pairs
    (> 0.5); a checkpoint round trip, bitwise.
17c. popularity: ``Popularity`` ('mean') on the config-3 ratings: counts
    against ``bincount``, scores against float64 (1e-4), 256 equal lists,
    ``update_users``, a checkpoint round trip.
17d. family_kernel_time: the apply and the segment sum on the first batch
    of the families' pack (n = 1,048,576, d = 128) over the batch's user
    order, its secondary order and (the apply) sorted uniform negatives:
    kernel, plain and library (``index_add_``) times and bounds.

18. ml1m_data / compare_segsum: MovieLens-1M-shaped ratings
    (``BASELINE.json`` config 2: 1M unique pairs of 6,040 x 3,706, half
    stars, as ``run_configs._gen`` makes them, plus 10,000 held out); the
    segment-sum kernel against ``index_add_`` on the card (rtol 1e-5, atol
    1e-5 x the row's absolute sum), bitwise against its plain model and a
    second run: the 1M ratings by user and by item, by user with 18
    columns, a 4,096-entry batch, a stream with one 200,000-entry segment,
    1M entries in runs of 1-19 straddling the lanes' slices of 8.
19. baseline: ``BaselineModel`` at config 2 by ALS (reg 0.5) and by SGD
    (lr 0.02, reg 0.02, bs 4,096), 20 epochs each: ``fit`` (falling train
    RMSE, seconds), ``update_users`` (1,000 users, half known; item biases
    bitwise unchanged), ``predict`` on the held-out pairs (float64 numpy,
    atol 1e-5), ``recommend``, ``recommend_batch`` of 256 users, with the
    segment-sum count zeroed just before and read just after; the fit
    repeated (bitwise equal), a checkpoint round trip, the ALS-SGD gap.
20. cf: ``UserUserCF`` and ``ItemItemCF`` (50 neighbours) on the config-2
    ratings: ``fit`` seconds (a second fit bitwise equal), ``predict`` of
    100,000 pairs, 2,000 of them against a float64 oracle (atol 6e-3),
    ``recommend``.
21. content: ``ContentBasedRecommender`` with 18 seeded binary genre
    columns and without: profiles and both ``predict_mode``s against
    float64 numpy (atol 1e-5); segment-sum count > 0.
22. sweep: ``grid_search_kernel_mf`` at config 1 (MovieLens-100K shape,
    linear, k=100, bs 4,096, 20 epochs, the 3 x 3 grid, 10,000 held out):
    seconds, aggregate updates/s, step and apply counts = 9 x batches x 20,
    ``recommend`` on the winner (scorer count > 0); the sweep again through
    ``grid_train`` (the winner bitwise), its best and worst candidates
    against ``sgd_train`` alone (atol 1e-5).
23. segsum_kernel_time: the segment sum's kernel, plain and library
    (``index_add_``) times at the shapes of 18 (``Timer``), and their
    bounds.
24. ease: EASE at MovieLens-1M shape (the config-2 ratings as implicit
    feedback, lam 250) through ``fit`` with the GJ count zeroed just
    before and read just after, ``B`` against float64 numpy EASE (atol
    1e-4), the top-10 of 256 users against float64 where separated by
    more than 1e-5, a checkpoint round trip; at the item budget (16,384
    items, 100,000 users x 100 interactions, lam 100) ``item_gram`` and
    ``ease_weights`` timed apart with peak memory, held by
    ``(G + lam I)(I - B) = diag(1 / diag P)`` on 256 columns (off-diagonal
    within 1e-3 of the diagonal).
25. spd_kernel_time at EASE's leaves: every leaf input the two EASE fits'
    Schur recursions handed the GJ leaf, the kernel held to its plain
    version (atol = rtol = 1e-4) and both to the float64 inverse
    (``|A X - I|`` < 5e-3); the kernel, plain and library times on the
    first input of each width.

26. recipe_serve: the recipe recommender at RecipeNLG's catalog
    (2,231,142 recipes): a dense index of 2,231,142 x 512 (the first 3,706
    rows ``hash_embed`` of seeded recipe texts, the rest seeded unit rows)
    on the card; a ``KernelMF`` (linear, k=200, Kp 256) fitted there by SGD
    on the config-2 ratings (3 epochs, bs 131,072; the step and apply counts
    zeroed just before, read just after), the step and apply held against
    the plain step on that fit's own pack (its first and last batch, as
    compare_sgd holds them), pickled to ``model.pkl``; a
    ``TorchLogisticRegression`` reranker trained there on ``featurize`` rows
    of ``generate_queries`` over 200 recipes; the service loaded by
    ``from_artifacts`` (index, model, reranker) with a seeded metadata
    frame; ``search_topk`` of 64 queries at k 10 and at ``candidate_k``
    500, and ``search_topk_batch`` of 256, against a float64 numpy top-k on
    the host (``np.partition`` then ``np.lexsort``; values within 1e-5,
    positions equal except where scores tie within 1e-6 at the cut; the
    batch's top-k kernel launches counted alone, one a row block of
    ``dense_topk`` past ``SORT_MAX_SCORES``: 5 at 256 x 2,231,142), their
    device times (``Timer``) against the bytes / operations bound; 64
    hybrid ``recommend`` calls (k 10, ``candidate_k`` 500, alpha 0.5; model
    scores not the zeros fallback, within 1e-5 of the model loaded on the
    CPU; the scores the blend), p50 / p99; 4 ``plan_meals`` with the
    reranker and avoid terms at the default diversity penalty (no avoided
    ingredient, no repeat within a meal; repeats across meals, which the
    planner allows as JAX's does, counted); the HTTP
    routes' statuses; the batched TF-IDF scores of 64 queries at
    ``vocab_block`` 1,024 on a seeded l2-normalized 2,231,142 x 50,000 CSR
    (32 terms a row) within 1e-5 of scipy's product, and their top-10.

27. pipeline: the batch pipeline end to end, every stage through its
    ``main()`` with no ``--platform`` (the default device, the card): config
    3's 25M ratings (item ids written as strings, as the MovieLens stage
    writes them) and 59,392 seeded recipe texts in; ``build_recipe_metadata``,
    ``build_structured_features``, ``build_item_embeddings --dim 512``,
    ``export_artifacts`` (the dense index), ``train`` of config 3's sigmoid
    KernelMF (k=200, bs 2,097,152, 3 epochs), ``evaluate`` of 1,000 users
    inside ``utils.profiling.trace`` (the first 200 lists against a float64
    numpy top-k of the model's tables with the same known items excluded,
    users whose 10th and 11th scores tie within 1e-5 skipped and counted;
    the metrics recomputed from every list equal to the stage's JSON; the
    trace's scorer kernels equal to the scorer's launch count; the
    device's busy share of the trace's window read from it); the same
    ``train`` (a narrow sigmoid KernelMF) and ``evaluate`` on 100,000
    seeded low-rank ratings (2,000 x 1,000), whose held-out items the model
    ranks high: the recomputed metrics equal to the JSON and above 0
    (config 3's uniform draws hit nothing at k 10), the first 200 lists
    held as above;
    ``evaluate_hybrid`` (64 of its batched profile top-k against a float64
    ``np.lexsort`` top-k, ties within 1e-5 allowed), ``train_reranker`` as
    logreg then mlp, ``evaluate_llm``, ``serve.app`` (one plan, no repeat
    within a meal), then ``train --model baseline --method als`` (its
    biases, made by 12 segment sums over the 25M entries, within 1e-5 of
    a float64 numpy replay of the same sweeps) and ``evaluate`` again;
    each stage's file checked with its rows; seconds
    per stage, ``fit`` seconds, ``evaluate`` users/s, peak device memory,
    host RSS and the launches of the scorer, the step, the apply and the
    segment sum, each stage's counted apart.

28. parallel: multi-device KernelMF, the bias models and NMF on
    ``torch.distributed``. (a) NCCL at
    world size 1 in this process (a ``FileStore`` under ``build/``; NCCL
    refuses two ranks on one GPU), config 3 sigmoid at full scale (bs
    2,097,152, 3 epochs, orders given): ``dp_fit`` tiled with the
    item-primary pack (``'shuffle'``: the step's accumulator mode) and
    the user-primary pack, then ``ShardedCatalog`` serving 256 users'
    top-10 (ids equal to ``recommend_batch``'s top-k, scores 1e-5), the
    step, apply and scorer counts zeroed just before and read just after;
    each synchronous fit held to ``sgd_train`` on the same pack, tables
    and orders (history rtol 1e-5, held-out RMSE 1e-3, tables after one
    epoch 2e-5); fit and pack seconds, updates/s of the dp trainer beside
    ``sgd_train``'s (one-epoch windows), ``psum_every='auto'`` and
    ``overlap_psum`` (falling RMSE, held-out RMSE, one epoch against the
    same trainer with the plain step and apply at 2e-5), a profiled epoch
    (the NCCL kernels' device time), peak memory. (c) parallel_kernels:
    the step's accumulator mode against its plain version (1e-5) on config
    3's item-primary batch and a 2D cell's batch (config 2's shape, 2 x 2,
    bs 65,536), the apply into a zeroed delta table (bitwise its plain
    order model), with device times and bounds. (b) gloo ranks sharing the
    card (``spawn_world``, every rank on cuda:0), config 3's width on
    config 2's ratings (bs 65,536, 2 epochs): a world of 2 (one-batch
    epoch against the single-device step on the union batch at 2e-5;
    ``KernelMF(mesh=make_mesh(2))`` flat and tiled, twice each: the same
    bits, Q's replicas bit-equal, RMSE falling) and a world of 4
    (``make_mesh(2, 2)``, ``dp_tp_fit``, ``keep_sharded`` serving equal to
    the single-device top-10 of the gathered tables); then both worlds fit
    on ``make_mesh(W)``, twice from one seed, ``KernelMF(method='als')``
    (k=200, reg 0.1 per observation; the second fit ``keep_sharded``),
    ``BaselineModel`` by ALS and by SGD (BASE's arguments) and ``NMF``
    (k=64, bs 1,048,576), 3 epochs each: every rank's tables bit-equal, the
    two fits bit-equal, ALS within 1e-4 of the single-device fit (tables
    and history) with ``keep_sharded`` serving the whole tables' lists, bias
    ALS within 1e-5, bias SGD within 1e-5 of a float64 replay of its own
    pack and batch orders, NMF at JAX's bars (history rtol 2e-4, tables rtol 2e-3,
    predictions 1e-3), and every
    kernel of the path (the GJ leaf and the segment sum too) launched on
    some rank. (d) parallel_als, in the same NCCL world of one rank: the
    single-device references first (``ials_train_bucketed``,
    ``als_train``, ``nmf_train``), then with the GJ, segment-sum and scorer
    counts zeroed just before and read just after: ``dp_ials_train_bucketed``
    at config 3 (k=200, reg 0.1 per observation, 3 sweeps; bit-equal to
    ``ials_train_bucketed``, else within 1e-6 with the flag recorded, and as
    many GJ launches), ``dp_als_train`` on config 3 (reg 0.005, 5 epochs;
    1e-5 of ``als_train`` and of float64), ``dp_bias_sgd_train`` on config 2
    (BASE's SGD, 3 epochs, seeded batch orders; 1e-5 of a float64 replay of
    the same orders; seconds a step and the all-reduces' share of the host
    time), ``dp_nmf_train`` (k=64, bs 1,048,576, 3 epochs on config 3; rtol
    1e-5 of ``nmf_train``, bit equality recorded) and ``ShardedCatalog``
    serving 256 users' top-10 of the dp ALS tables (ids equal to
    ``catalog_topk``'s, scores 1e-5); then the sweep's median seconds and a
    profiled sweep (the all-gather's device time). (e) parallel_families,
    in the same NCCL world of one rank, at the families' shape (config 3's
    25M ratings, k=64, bs 1,048,576, 3 epochs, draws given): the
    single-device BPR and SVD++ trainers on one user-primary pack and on
    the flat stream, then with the apply and scorer counts zeroed just
    before and read just after ``dp_bpr_train_tiled``, ``dp_bpr_train``,
    ``dp_svdpp_train_batched`` and ``dp_svdpp_train`` on the same inputs
    (each within JAX's bars of its single-device trainer: BPR 2e-5 and
    loss rtol 1e-5, SVD++ 1e-5; as many apply launches) and ``BPR`` /
    ``SVDpp`` with ``mesh=make_mesh(1)`` fitted for one epoch and served
    (``recommend``, 256-user ``recommend_batch``); each fit's seconds and a
    profiled epoch of each dp trainer. The gloo worlds of (b) also fit
    ``BPR(mesh=make_mesh(W))`` and ``SVDpp(mesh=...)`` at config 2's shape
    (k=64, bs 65,536, 2 epochs), flat and tiled (``psum_every='auto'``,
    ``overlap_psum``), the tiled twice: every rank's tables bit-equal, the
    same lists served, two fits bit-equal, and each fit within 1e-5 of a
    float64 replay of its own pack and draws (``family_mesh_f64``).
29. parallel_gram: the gram models on a mesh. (f) In the same NCCL world
    of one rank (it drives the mesh paths and bypasses the collectives'
    wire): config 4's item-item fit at full scale through
    ``TopKItemItemCF(mesh=make_mesh(1))``, equal to the ``cf_topk`` phase's
    mesh-free lists, and its seconds; EASE at its budget (16,384 items x
    100,000 users x 100): ``dp_item_gram`` equal to ``item_gram``, then
    ``ease_weights_sharded(inverse='ns')`` (the GJ count zeroed just before
    and read just after: 0) within 5e-4 of the single-device ``B`` and the
    closed form's identity on 256 columns (1e-3), with its steps, seconds
    and peak; config 2's EASE by the same path for the world-1 peak. (g)
    gloo ranks sharing the card, worlds of 2 and 4 side by side at config
    2's shape:
    ``EASE(mesh=make_mesh(W))`` on the Schur path (the GJ leaf launched on
    every rank, scores within 5e-4 of the single-device fit),
    ``TopKItemItemCF`` / ``TopKUserUserCF(mesh=)`` (k=50, blocks of 1,024;
    sims 1e-5, means 1e-6, ids where apart by more than 1e-4, predictions
    1e-4), ``ItemItemCF`` / ``UserUserCF(mesh=)`` (predictions 1e-4, each
    rank its ``ceil(E / W)`` similarity rows, equal to the single-device
    matrix's), and on the world of 4 the
    Newton-Schulz inverse forced on config 2's gram: within 5e-4 of Schur,
    each rank's peak during the steps below half of world 1's.
30. parallel_retrieval: retrieval and the hybrid evaluation on a mesh.
    After the pipeline phase, on its artifacts: ``evaluate_hybrid
    --mesh-devices 1`` (the stage starts one NCCL rank) for 200 users,
    its report equal to the mesh-free run's, and ``--mesh-devices 2``
    raising on one card. In the NCCL world of one rank, after (f), at
    recipe_serve's catalog made anew (2,231,142 x 512 dense, 2,231,142 x
    50,000 TF-IDF): ``search_topk_batch(mesh=make_mesh(1))`` of 256
    queries and ``tfidf_batch_topk(mesh=)`` of 64 at ``vocab_block``
    1,024, each equal to the mesh-free call, with the dense search's
    device times; the catalog is written to files, and (g)'s gloo ranks
    then each read their rows of it (memory maps) and take the
    row-sharded dense and TF-IDF top-k (the first 64 and 32 of those
    queries), held to the single-device ones at JAX's bars (values 1e-5,
    positions where the gap to the next is at least 1e-6).
31. sharded_checkpoint: in the NCCL world of one rank, config 3's
    ``KernelMF(mesh=make_mesh(1))`` (one epoch) through
    ``save_model_sharded`` / ``load_model_sharded`` and through
    ``save_model`` / ``load_model``, equal, with seconds and bytes; then
    on (b)'s gloo worlds of 2 and 4: ``KernelMF(keep_sharded=True)`` on
    the flat mesh (fitted by SGD) and, on the world of 4, (b)'s 2 x 2 fit,
    saved and restored onto the mesh, every rank's shards equal, lists
    equal, ``predict`` 1e-6, the scorer launched on every rank by the
    restored model, the meshless load equal to the gathered tables.

Then the ``kernels`` line (``score_catalog``, ``sgd_step``,
``segment_apply``, ``spd_gj`` with its EASE launches and shapes,
``segment_sum``, ``topk_select``, ``ease_gram``, ``normal_eq``,
``spd_split`` and ``spd_block_solve`` with their launches on each ALS path; the apply's and the sum's launches and shapes on the
families' paths beside the rest, and each kernel's launches on the
parallel paths), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, f32 on the CUDA
# cores, bf16 and int8 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
INT8_OPS_PER_S = 1979e12
N_USERS, N_ITEMS, N_FACTORS = 162_000, 59_392, 200  # config 3


class SmokeFailure(Exception):
    pass


STEP = ("mf_sgd_step", "mf_sgd_step_acc")  # the SGD step's entry points


def n_launches(*entries):
    """Launches of the named C entry points together, as ``ops/_build.py``
    counts them (zero returns of the checked call)."""
    from matrix_factorization_tpu_torch.ops import _build

    return _build.launches(*entries)


def zero_launches(*entries):
    from matrix_factorization_tpu_torch.ops import _build

    _build.reset_launches(*entries)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def ext_tables(rng, n_rows, cfg, side, sd=0.1):
    """Bias-folded rows as ``init_params`` lays them out: factors and
    biases N(0, sd), the const column 1 (rbf: no extension columns)."""
    import numpy as np

    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    t = np.zeros((n_rows, cfg.padded_factors), np.float32)
    t[:, : cfg.n_factors] = sd * rng.standard_normal((n_rows, cfg.n_factors),
                                                     dtype=np.float32)
    if cfg.kernel != "rbf":
        t[:, sgd.bias_col(cfg, side)] = sd * rng.standard_normal(
            n_rows, dtype=np.float32)
        t[:, sgd.const_col(cfg, side)] = 1.0
    return t


def bound(B, I, kp, kernel, dtype):
    """(bound_ms, bound_by): each input read once, the (B, I) f32 scores
    written once; 2 B I Kp product operations (+ the rbf norms) at the
    peak of the tables' type."""
    size = 4 if dtype == "float32" else 2
    nbytes = (B + I) * kp * size + B * I * 4 + 4
    flops = 2 * B * I * kp + (2 * (B + I) * kp if kernel == "rbf" else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_summary(logs):
    """[kernel, registers, spill bytes (stores + loads), stack frame bytes]
    of every kernel in ``nvcc -Xptxas -v`` logs."""
    import re

    out, name, spill = [], None, None
    for log in logs:
        for ln in log.splitlines():
            m = re.search(r"Function properties for (\S+)", ln)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", ln)
            if m:
                spill = (int(m.group(2)) + int(m.group(3)), int(m.group(1)))
            m = re.search(r"Used (\d+) registers", ln)
            if m and name is not None:
                out.append([name[:120], int(m.group(1)), *(spill or (0, 0))])
                name, spill = None, None
    return out


class Timer:
    """Median device time of one call, by CUDA events, the L2 cache
    flushed (a 256 MB write) before each timed call as a serving request
    would find it cold. Between the flush and the start event the card
    spins for ``SPIN_CYCLES`` (``torch.cuda._sleep``, which touches no
    memory): the host enqueues the call while the card still spins, so
    a wrapper's host work, when it outlasts the flush, does not fall
    inside the timed window. Readings before this spin included that host
    time."""

    SPIN_CYCLES = 1_000_000  # ~0.5 ms at the H100's 1.98 GHz boost clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32,
                                 device="cuda")

    def ms(self, fn, reps=25, warmup=3, before=None):
        """``before`` (default: the written flush) runs ahead of each
        timed call, then the spin."""
        torch = self.torch
        before = self.flush.zero_ if before is None else before
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(reps):
            before()
            torch.cuda._sleep(self.SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def compare_shapes(b_s):
    """(B, I, Kp) of the compare phase: both sides of the path boundary
    B_s at config 3's width, and ragged item counts at Kp 128 and 1024."""
    return ((1, N_ITEMS, 256), (b_s, N_ITEMS, 256), (b_s + 1, N_ITEMS, 256),
            (256, N_ITEMS, 256), (5, 1000, 128), (3, 777, 1024),
            (70, 1000, 1024))


def score_cfg(SGDConfig, kernel, kp):
    n_factors = {256: N_FACTORS, 128: 100, 1024: 1000}[kp]
    return SGDConfig(kernel=kernel, n_factors=n_factors, gamma=1.0 / n_factors,
                     min_rating=0.5, max_rating=5.0)


def cross_path_equal(torch, cuda_scores, cfg, mu, pu, Q, whole, b_s):
    """Whether every row of ``whole`` (the scores of ``pu`` against ``Q``)
    equals, bitwise, the same user scored alone and inside its batch of
    ``b_s``: each score is one k-ordered f32 FMA chain on every path."""
    for r in range(pu.shape[0]):
        solo = cuda_scores.cuda_score_catalog(cfg, mu, pu[r:r + 1], Q)
        if not torch.equal(solo[0], whole[r]):
            return False
    for g in range(0, pu.shape[0], b_s):
        part = cuda_scores.cuda_score_catalog(cfg, mu, pu[g:g + b_s], Q)
        if not torch.equal(part, whole[g:g + b_s]):
            return False
    return True


def phase_compare(torch, rng, SGDConfig, cuda_scores):
    """Kernel vs plain version on the card, and at B=256 the cross-path
    bitwise check; returns the largest error."""
    worst = 0.0
    b_s = cuda_scores.STREAM_MAX_B
    for B, I, kp in compare_shapes(b_s):
        for kernel in ("linear", "sigmoid", "rbf"):
            cfg = score_cfg(SGDConfig, kernel, kp)
            pu32 = torch.from_numpy(ext_tables(rng, B, cfg, "user")).to("cuda")
            Q32 = torch.from_numpy(ext_tables(rng, I, cfg, "item")).to("cuda")
            mu = torch.tensor(3.5, device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                pu, Q = pu32.to(dtype), Q32.to(dtype)
                got = cuda_scores.cuda_score_catalog(cfg, mu, pu, Q)
                want = cuda_scores.plain_score_catalog(cfg, mu, pu, Q)
                err = float((got - want).abs().max())
                ok = bool(torch.isfinite(got).all()) and torch.allclose(
                    got, want, atol=1e-4, rtol=1e-4)
                out = {"phase": "compare", "B": B, "I": I, "Kp": kp,
                       "kernel": kernel, "dtype": str(dtype).split(".")[-1],
                       "path": cuda_scores.score_plan(
                           B, I, kp, pu.element_size()).path,
                       "max_abs_err": err, "ok": ok}
                if B == 256:
                    out["cross_path_equal"] = cross_path_equal(
                        torch, cuda_scores, cfg, mu, pu, Q, got, b_s)
                emit(out)
                check(ok, f"kernel disagrees with its plain version at "
                          f"B={B} I={I} Kp={kp} {kernel} {dtype}: {err}")
                check(out.get("cross_path_equal", True),
                      f"B=256 scores differ from B=1 / B={b_s} ones "
                      f"({kernel} {dtype})")
                worst = max(worst, err)
    return worst


def phase_serve(torch, rng, kernel, tmpdir, launches):
    """Config 3 through the port's public entry points."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import (
        CoalescingRecommender, KernelMF, load_model, params_from_numpy,
        save_model)
    from matrix_factorization_tpu_torch.core.ids import IdVocab
    from matrix_factorization_tpu_torch.ops import cuda_scores
    from matrix_factorization_tpu_torch.ops.scoring import stable_topk

    out = {"phase": "serve", "kernel": kernel}
    t0 = time.perf_counter()
    src = KernelMF(n_factors=N_FACTORS, kernel=kernel, gamma=1.0 / N_FACTORS,
                   min_rating=0.5, max_rating=5.0, device="cuda")
    cfg = src._cfg()
    P = ext_tables(rng, N_USERS, cfg, "user")
    Q = ext_tables(rng, N_ITEMS, cfg, "item")
    mean = 3.5
    src.user_vocab = IdVocab(range(N_USERS))
    src.item_vocab = IdVocab(range(10_000_000, 10_000_000 + N_ITEMS))
    src.global_mean = mean
    src._params = params_from_numpy(P, Q, mean, device="cuda", cfg=cfg)
    save_model(src, f"{tmpdir}/{kernel}")
    del src
    model = load_model(f"{tmpdir}/{kernel}")
    check(model._params.item_features.device.type == "cuda",
          "load_model put the tables elsewhere")
    out["setup_s"] = time.perf_counter() - t0

    # predict: known and unknown ids, against float64 numpy
    n = 4096
    u = rng.integers(0, N_USERS, n)
    i = rng.integers(0, N_ITEMS, n)
    u_raw = u.astype(object)
    i_raw = (i + 10_000_000).astype(object)
    u_raw[::37] = -1  # unknown user
    i_raw[::41] = -2  # unknown item
    n0 = launches()
    preds = np.asarray(model.predict(
        pd.DataFrame({"user_id": u_raw, "item_id": i_raw})))
    possible = np.asarray(model.predictions_possible)
    kp = cfg.padded_factors
    cold_u = np.zeros(kp)
    cold_i = np.zeros(kp)
    if kernel != "rbf":
        cold_u[cfg.n_factors + 1] = cold_i[cfg.n_factors] = 1.0
    pu = np.where((u_raw == -1)[:, None], cold_u, P[u].astype(np.float64))
    qi = np.where((i_raw == -2)[:, None], cold_i, Q[i].astype(np.float64))
    if kernel == "rbf":
        ref = cfg.a + cfg.c * np.exp(-cfg.gamma * ((pu - qi) ** 2).sum(1))
    else:
        ref = cfg.a + cfg.c / (1 + np.exp(-(mean + (pu * qi).sum(1))))
    ref = np.clip(ref, 0.5, 5.0)
    err = float(np.abs(preds - ref).max())
    check(preds.shape == (n,) and np.isfinite(preds).all(), "predict shape")
    check(preds.min() >= 0.5 and preds.max() <= 5.0, "predict outside [0.5, 5]")
    check(err < 1e-4, f"predict differs from the numpy reference by {err}")
    check((possible == ((u_raw != -1) & (i_raw != -2))).all(),
          "predictions_possible")
    out["predict_max_abs_err"] = err
    out["predict_launches"] = launches() - n0

    # recommend with known items
    user = int(rng.integers(N_USERS))
    base = model.recommend(user, amount=10)
    known = list(base["item_id"].iloc[:5]) + list(
        rng.integers(0, N_ITEMS, 15) + 10_000_000)
    n0 = launches()
    rec = model.recommend(user, amount=10, items_known=known)
    check(launches() > n0, "recommend did not launch the kernel")
    check(len(rec) == 10 and not set(rec["item_id"]) & set(known),
          "recommend returned a known item")
    s = rec["rating_pred"].to_numpy()
    check(bool((np.diff(s) <= 0).all()), "recommend scores not descending")

    # an unknown user is scored pair by pair from the cold row
    cold = model.recommend(-1, amount=10)
    check(len(cold) == 10 and not any(model.predictions_possible),
          "recommend for an unknown user")

    # recommend_batch, top-k sets against the plain scorer on the card
    users = [int(x) for x in rng.choice(N_USERS, 256, replace=False)]
    n0 = launches()
    batch = model.recommend_batch(users, amount=10)
    check(launches() > n0, "recommend_batch did not launch the kernel")
    check(len(batch) == 2560, "recommend_batch row count")
    params = model._params
    ud = torch.as_tensor(users, device="cuda")
    plain = cuda_scores.plain_score_catalog(
        cfg, params.global_mean, params.user_features[ud],
        params.item_features[:N_ITEMS])
    pv, pi = stable_topk(plain, 11)
    pv, pi = pv.cpu().numpy(), pi.cpu().numpy() + 10_000_000
    compared = 0
    for row, usr in enumerate(users):
        got = batch.loc[batch.user_id == usr]
        check(bool((np.diff(got["rating_pred"].to_numpy()) <= 0).all()),
              "recommend_batch scores not descending")
        if pv[row, 9] - pv[row, 10] >= 1e-4:
            compared += 1
            check(set(got["item_id"]) == set(pi[row, :10]),
                  f"recommend_batch top-10 of user {usr} differs from plain")
    out["topk_rows_compared"] = compared
    check(compared >= 128, "too few rows without a near-tie to compare")

    # concurrent requests through the coalescer
    co_users = users[:64]
    solo = {usr: model.recommend(usr, amount=10) for usr in co_users}
    results, errors = {}, []
    co = CoalescingRecommender(model, window_ms=5.0, max_batch=64)
    n0 = launches()
    try:
        def work(usr):
            try:
                results[usr] = co.recommend(usr, amount=10)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=work, args=(usr,)) for usr in co_users]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        check(not any(t.is_alive() for t in threads), "coalesced callers hung")
    finally:
        co.close()
    check(not errors, f"coalesced requests failed: {errors[:3]}")
    check(launches() > n0, "the coalescer did not launch the kernel")
    for usr in co_users:
        got, want = results[usr], solo[usr]
        check((got["user_id"] == usr).all(), "a caller got another user's rows")
        check(list(got["item_id"]) == list(want["item_id"]) and np.array_equal(
            got["rating_pred"].to_numpy(), want["rating_pred"].to_numpy()),
            f"coalesced rows of user {usr} differ from recommend")
    out["coalesce_dispatches"] = co.dispatches
    out["coalesce_served"] = co.served
    return model, out


def device_time(events):
    """The device's work in a Chrome trace's ``events``: its kernel, copy
    and memset intervals ((start, end, name), microseconds, by start), the
    milliseconds of each name, and the busy microseconds (the union of the
    intervals)."""
    ev = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                for e in events if e.get("ph") == "X"
                and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    by_name, busy_us, cur = {}, 0.0, None
    for t_start, t_end, name in ev:
        by_name[name] = by_name.get(name, 0.0) + (t_end - t_start) / 1e3
        if cur is None or t_start > cur[1]:
            busy_us += 0 if cur is None else cur[1] - cur[0]
            cur = [t_start, t_end]
        else:
            cur[1] = max(cur[1], t_end)
    if cur is not None:
        busy_us += cur[1] - cur[0]
    return ev, by_name, busy_us


def _device_share(torch, fn, calls, match=None):
    """Run ``fn`` over ``calls`` under ``torch.profiler`` and read the
    exported trace: the device time per call, the device's busy share
    (the union of its kernel and copy intervals over the span from the
    first to the last; the rest is idle, waiting on the host), the device
    time over the host's wall time (a lower bound: the profiler slows the
    host), the kernels that took most of the time and, for ``match``, the
    time and share of device time of the kernels whose name holds it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for c in calls:
            fn(c)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(f"{d}/trace.json")
        trace = json.loads(Path(f"{d}/trace.json").read_text())
    ev, by_name, busy_us = device_time(trace["traceEvents"])
    dev_ms = sum(by_name.values())
    span_us = ev[-1][1] - ev[0][0] if ev else 0.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    out = {"device_ms_per_call": dev_ms / len(calls),
           "device_busy_share": busy_us / span_us if span_us else None,
           "device_share_of_wall": dev_ms / wall_ms if dev_ms else None,
           "top_kernels_ms_per_call": [[n[:80], t / len(calls)] for n, t in top]}
    if match is not None:
        hit = [(n, t) for n, t in by_name.items() if match in n]
        ms = sum(t for _, t in hit)
        out[f"{match}_calls"] = sum(1 for e in ev if match in e[2]) / len(calls)
        out[f"{match}_ms_per_call"] = ms / len(calls)
        out[f"{match}_share"] = ms / dev_ms if dev_ms else None
    return out


def phase_latency(torch, rng, model):
    """Host-clock serving latency (the calls return host frames, so each
    ends synchronised with the card), and the device's share of it."""
    import numpy as np

    users = [int(x) for x in rng.choice(N_USERS, 256, replace=False)]
    for usr in users[:5]:
        model.recommend(usr, amount=10)
    lat, topk = [], []
    for usr in users[:50]:
        t0 = time.perf_counter()
        model.recommend(usr, amount=10)
        lat.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        model._catalog_topk(np.asarray([usr], np.int32), 10)
        topk.append((time.perf_counter() - t0) * 1e3)
    batch = []
    for _ in range(5):
        t0 = time.perf_counter()
        model.recommend_batch(users, amount=10)
        batch.append((time.perf_counter() - t0) * 1e3)
    return {
        "recommend_p50_ms": float(np.median(lat)),
        "catalog_topk_b1_p50_ms": float(np.median(topk)),
        "recommend_batch_ms_per_user": float(np.median(batch)) / len(users),
        "recommend_profile": _device_share(
            torch, lambda u: model.recommend(u, amount=10), users[50:70]),
        "recommend_batch_profile": _device_share(
            torch, lambda us: model.recommend_batch(us, amount=10), [users] * 3),
    }


def library_scores(torch, cfg, mu, pu, Q):
    """One cuBLAS GEMM (f32, or bf16 with f32 output for bf16 tables) plus
    the torch epilogue: a yardstick of the same function; the port never
    calls it."""
    if pu.dtype == torch.float32:
        dots = torch.mm(pu, Q.t())
    else:
        dots = torch.mm(pu, Q.t(), out_dtype=torch.float32)
    if cfg.kernel == "linear":
        return dots.add_(mu)
    if cfg.kernel == "sigmoid":
        return dots.add_(mu).sigmoid_().mul_(cfg.c).add_(cfg.a)
    pn = pu.float().square().sum(1)
    qn = Q.float().square().sum(1)
    sq = pn[:, None] + qn[None, :] - 2 * dots
    return sq.clamp_(min=0).mul_(-cfg.gamma).exp_().mul_(cfg.c).add_(cfg.a)


SCORE_TIMED_B = (1, 16, 64, 256)


def phase_kernel_times(torch, rng, SGDConfig, cuda_scores, timer):
    """Kernel, plain and library times at the serving shapes of config 3,
    every kernel and table type."""
    rows = []
    for B in SCORE_TIMED_B:
        for kernel in ("linear", "sigmoid", "rbf"):
            cfg = score_cfg(SGDConfig, kernel, 256)
            pu32 = torch.from_numpy(ext_tables(rng, B, cfg, "user")).to("cuda")
            Q32 = torch.from_numpy(ext_tables(rng, N_ITEMS, cfg, "item")).to("cuda")
            mu = torch.tensor(3.5, device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                pu, Q = pu32.to(dtype), Q32.to(dtype)
                name = str(dtype).split(".")[-1]
                b_ms, b_by = bound(B, N_ITEMS, cfg.padded_factors, kernel, name)
                row = {
                    "B": B, "I": N_ITEMS, "Kp": cfg.padded_factors,
                    "kernel": kernel, "dtype": name,
                    "path": cuda_scores.score_plan(B, N_ITEMS, cfg.padded_factors,
                                                   pu.element_size()).path,
                    "ms": timer.ms(lambda: cuda_scores.cuda_score_catalog(cfg, mu, pu, Q)),
                    "plain_ms": timer.ms(lambda: cuda_scores.plain_score_catalog(cfg, mu, pu, Q)),
                    "library_ms": timer.ms(lambda: library_scores(torch, cfg, mu, pu, Q)),
                    "bound_ms": b_ms, "bound_by": b_by,
                }
                if dtype != torch.float32:
                    # the f32 GEMM on the widened values, the earlier yardstick
                    pw, Qw = pu.float(), Q.float()
                    row["library_f32_ms"] = timer.ms(
                        lambda: library_scores(torch, cfg, mu, pw, Qw))
                    del pw, Qw
                rows.append(row)
                emit({"phase": "kernel_time", **row})
    return rows


# ---------------------------------------------------------------------------
# Training (slice 2): the SGD step and apply kernels
# ---------------------------------------------------------------------------

# config 3 (benchmarks/run_configs.py:170-185): bs 2M for sigmoid, 1M for rbf
CONFIG3 = {"sigmoid": {"lr": 0.01, "batch_size": 2_097_152},
           "rbf": {"lr": 0.05, "batch_size": 1_048_576}}
N_RATINGS = 25_000_000
N_HELD_OUT = 4096
# the headline shape of bench.py:29-39
HEAD = {"n_ratings": 2_000_000, "n_users": 10_000, "n_items": 20_000,
        "n_factors": 100, "batch_size": 131_072, "lr": 0.002, "reg": 0.005,
        "epochs": 20, "trials": 5}


def gen_ratings(n_users, n_items, n_ratings, seed):
    """Unique (user, item) pairs with half-star ratings in [0.5, 5], made
    as ``benchmarks/run_configs.py::_gen`` makes them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    flat = rng.integers(0, n_users * n_items, int(n_ratings * 1.15),
                        dtype=np.int64)
    flat = np.unique(flat)[:n_ratings]
    rng.shuffle(flat)
    u = (flat // n_items).astype(np.int32)
    i = (flat % n_items).astype(np.int32)
    r = np.round(rng.uniform(0.5, 5, len(u)) * 2).astype(np.float32) / 2
    return u, i, r


def headline_ratings(seed):
    """The uniform ratings of ``bench.py``'s headline shape."""
    import numpy as np

    hr = np.random.default_rng(seed)
    return (hr.integers(0, HEAD["n_users"], HEAD["n_ratings"]).astype(np.int32),
            hr.integers(0, HEAD["n_items"], HEAD["n_ratings"]).astype(np.int32),
            hr.uniform(0.5, 5.0, HEAD["n_ratings"]).astype(np.float32))


def skewed_pack(n_users, n_items, batch_size, seed):
    """One user-primary batch of a skewed rating log: both ids drawn as
    ``floor(n_rows * U**2)``, U uniform in [0, 1), so that id 0 holds
    ~0.25% of the users' entries and ~0.41% of the items' at config 3 (the
    head of MovieLens-25M is close to that); stored as the pack stores a
    batch (stable sort by user, stable secondary argsort). A pair may
    repeat: the batch is for the kernels, not for a fit."""
    import numpy as np

    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    rng = np.random.default_rng(seed)
    u = (n_users * rng.random(batch_size) ** 2).astype(np.int32)
    i = (n_items * rng.random(batch_size) ** 2).astype(np.int32)
    r = np.round(rng.uniform(0.5, 5, batch_size) * 2).astype(np.float32) / 2
    return sgd.pack_ratings(u, i, r, batch_size, shuffle_seed=None,
                            order="user", device="cuda")


def sgd_kernel_shapes(seed):
    """(shape, cfg, pack, n_users, n_items) of the step's and the apply's
    measured shapes without the 25M ratings (``tools/probe_kernels.py``),
    each pack made directly from the seed: a config-3 sigmoid batch as the
    25M-rating pack lays one out (two batches of uniform ratings sorted by
    user as one chunk; batch 0 is the lower half of the users), the skewed
    config-3 batch, the headline pack, and the config-1 sweep's pack."""
    import numpy as np

    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    bs = CONFIG3["sigmoid"]["batch_size"]
    cfg3 = sgd_cfg("sigmoid", N_FACTORS, CONFIG3["sigmoid"]["lr"], bs)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, N_USERS, 2 * bs).astype(np.int32)
    i = rng.integers(0, N_ITEMS, 2 * bs).astype(np.int32)
    r = np.round(rng.uniform(0.5, 5, 2 * bs) * 2).astype(np.float32) / 2
    yield ("config3_sigmoid", cfg3,
           sgd.pack_ratings(u, i, r, bs, shuffle_seed=None, order="user",
                            item_sort_chunks=1, device="cuda"),
           N_USERS, N_ITEMS)
    yield ("config3_skewed", cfg3, skewed_pack(N_USERS, N_ITEMS, bs, seed),
           N_USERS, N_ITEMS)
    yield ("headline_linear",
           sgd_cfg("linear", HEAD["n_factors"], HEAD["lr"], HEAD["batch_size"],
                   reg=HEAD["reg"]),
           sgd.pack_ratings(*headline_ratings(seed), HEAD["batch_size"],
                            order="auto", device="cuda"),
           HEAD["n_users"], HEAD["n_items"])
    sw = sweep_inputs(seed)
    yield ("config1_sweep_linear", sw["cfg"], sw["data"], sw["n_users"],
           sw["n_items"])


def longest_run(ids):
    """Length of the longest run of equal values in a sorted id tensor."""
    _, counts = ids.unique_consecutive(return_counts=True)
    return int(counts.max())


def sgd_cfg(kernel, n_factors, lr, batch_size, **kw):
    from matrix_factorization_tpu_torch.core.config import SGDConfig

    return SGDConfig(kernel=kernel, n_factors=n_factors, lr=lr,
                     reg=kw.pop("reg", 0.005), gamma=1.0 / n_factors,
                     min_rating=0.5, max_rating=5.0, batch_size=batch_size,
                     **kw)


def random_params(torch, rng, cfg, n_users, n_items):
    from matrix_factorization_tpu_torch import params_from_numpy

    return params_from_numpy(ext_tables(rng, n_users, cfg, "user"),
                             ext_tables(rng, n_items, cfg, "item"), 3.5,
                             device="cuda", cfg=cfg)


def clone_params(p):
    return p._replace(user_features=p.user_features.clone(),
                      item_features=p.item_features.clone())


def step_args(params, b, cfg, primary):
    """The step's arguments for a pack's batch (sorted by ``primary``,
    with its argsort) as ``segment_sgd.minibatch_update`` maps them:
    (positional args, keyword args, the secondary table)."""
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    prim, sec = ("user", "item") if primary == "user" else ("item", "user")
    tables = {"user": params.user_features, "item": params.item_features}
    ids = {"user": b["u"], "item": b["i"]}
    upd = {"user": cfg.update_user_params, "item": cfg.update_item_params}
    dev = params.user_features.device
    args = (cfg, params.global_mean, tables[prim], tables[sec], ids[prim],
            ids[sec], b["r"], b["w"], sgd.mask_tensor(cfg, prim, dev),
            sgd.mask_tensor(cfg, sec, dev), cfg.lr, cfg.reg)
    return args, {"update_prim": upd[prim], "write_dq": upd[sec]}, tables[sec]


def run_step(params, b, cfg, primary, plain):
    """One step on the card, in place: the step and apply kernels, or
    (``plain``) their plain versions. Returns the secondary deltas."""
    from matrix_factorization_tpu_torch.ops import cuda_sgd
    from matrix_factorization_tpu_torch.ops import segment_sum as ss

    step, apply = ((cuda_sgd.plain_sgd_step, ss.plain_segment_apply)
                   if plain else
                   (cuda_sgd.cuda_sgd_step, ss.cuda_segment_apply))
    args, kw, sec_tbl = step_args(params, b, cfg, primary)
    dq = step(*args, **kw)
    if kw["write_dq"]:
        apply(sec_tbl, dq, b["sp"], b["ss"])
    return dq


def phase_compare_sgd(torch, rng, cases):
    """Step kernel + apply kernel against the plain step on the card, from
    the same tables and batch; both tables and the step's ``dq`` at
    atol = rtol = 1e-5: both sum in f32, in different orders. The apply is
    also held alone, both versions applying the plain step's ``dq``, and
    bitwise against its plain order model ``segmented_segment_sum``
    (chunks of ``APPLY_CHUNK``) and a second run of itself. Returns the
    largest error of the step (primary table, dq) and of the apply
    (secondary table). Two runs of the kernels from the same tables must
    agree bitwise."""
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.ops import segment_sum as ss

    worst = {"sgd_step": 0.0, "segment_apply": 0.0}
    for name, cfg, pack, k, n_users, n_items in cases:
        t0 = time.perf_counter()
        b = sgd.batch_at(pack, k)
        p0 = random_params(torch, rng, cfg, n_users, n_items)
        pk, pp = clone_params(p0), clone_params(p0)
        dq = run_step(pk, b, cfg, pack.primary, plain=False)
        again = clone_params(p0)
        dq_again = run_step(again, b, cfg, pack.primary, plain=False)
        check(torch.equal(pk.user_features, again.user_features)
              and torch.equal(pk.item_features, again.item_features)
              and (dq is None or torch.equal(dq, dq_again)),
              f"compare_sgd {name}: two runs of the kernels differ")
        del again, dq_again
        dq_plain = run_step(pp, b, cfg, pack.primary, plain=True)
        prim, sec = (("user_features", "item_features")
                     if pack.primary == "user"
                     else ("item_features", "user_features"))
        upd_sec = dq is not None
        out = {"phase": "compare_sgd", "case": name, "kernel": cfg.kernel,
               "bs": pack.batch_size, "Kp": cfg.padded_factors,
               "primary": pack.primary,
               "longest_prim_run": longest_run(
                   b["u"] if pack.primary == "user" else b["i"]),
               "update_prim": (cfg.update_user_params if prim == "user_features"
                               else cfg.update_item_params),
               "update_sec": upd_sec}
        errs = {}
        for tname in ("user_features", "item_features"):
            got, want = getattr(pk, tname), getattr(pp, tname)
            errs[tname] = float((got - want).abs().max())
            ok = bool(torch.isfinite(got).all()) and torch.allclose(
                got, want, atol=1e-5, rtol=1e-5)
            check(ok, f"compare_sgd {name}: {tname} differs by {errs[tname]}")
        step_err = errs[prim]
        if not out["update_prim"]:
            check(torch.equal(getattr(pk, prim), getattr(p0, prim)),
                  f"compare_sgd {name}: the frozen primary side moved")
        if upd_sec:
            step_err = max(step_err, float((dq - dq_plain).abs().max()))
            check(torch.allclose(dq, dq_plain, atol=1e-5, rtol=1e-5),
                  f"compare_sgd {name}: dq differs")
            got, again, model, want = (getattr(p0, sec).clone()
                                       for _ in range(4))
            ss.cuda_segment_apply(got, dq_plain, b["sp"], b["ss"])
            ss.cuda_segment_apply(again, dq_plain, b["sp"], b["ss"])
            ss.segmented_segment_sum(model, dq_plain, b["sp"], b["ss"],
                                     chunk=ss.APPLY_CHUNK,
                                     layout="columns")
            ss.plain_segment_apply(want, dq_plain, b["sp"], b["ss"])
            apply_err = float((got - want).abs().max())
            check(torch.equal(got, again),
                  f"compare_sgd {name}: two runs of the apply differ")
            check(torch.equal(got, model),
                  f"compare_sgd {name}: the apply is not its plain model")
            check(torch.allclose(got, want, atol=1e-5, rtol=1e-5),
                  f"compare_sgd {name}: the apply differs by {apply_err}")
            del again, model
            worst["segment_apply"] = max(worst["segment_apply"], apply_err)
            out["apply_max_abs_err"] = apply_err
        else:
            check(torch.equal(getattr(pk, sec), getattr(p0, sec)),
                  f"compare_sgd {name}: the frozen side moved")
        worst["sgd_step"] = max(worst["sgd_step"], step_err)
        torch.cuda.synchronize()
        out.update({"user_max_abs_err": errs["user_features"],
                    "item_max_abs_err": errs["item_features"],
                    "step_max_abs_err": step_err,
                    "seconds": time.perf_counter() - t0, "ok": True})
        emit(out)
        del pk, pp, p0, dq, dq_plain
        torch.cuda.empty_cache()  # the plain step's (bs, Kp) temporaries
    return worst


def plain_epoch(params, data, cfg, order):
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    for k in order.tolist():
        run_step(params, sgd.batch_at(data, k), cfg, data.primary, plain=True)


def phase_train(torch, rng, kernel, data3, pack, pack_seconds, seed):
    """Config 3 through ``KernelMF.fit`` and ``update_users`` (the main
    path; the step and apply counts are zeroed just before it and read
    just after), then throughput on the pack made once, the plain epoch,
    bitwise repeatability, the profile, ``predict`` and ``recommend``."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import KernelMF
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    u, i, r, hu, hi = data3
    spec = CONFIG3[kernel]
    out = {"phase": "train", "kernel": kernel, "n_ratings": len(r),
           "batch_size": spec["batch_size"], "pack_seconds": pack_seconds,
           "n_batches": pack.n_batches, "primary": pack.primary}
    model = KernelMF(n_factors=N_FACTORS, kernel=kernel, lr=spec["lr"],
                     reg=0.005, gamma=1.0 / N_FACTORS, min_rating=0.5,
                     max_rating=5.0, batch_size=spec["batch_size"],
                     epoch_order="auto", seed=seed)
    X = pd.DataFrame({"user_id": u, "item_id": i})
    y = pd.Series(r)

    # -- the main path: fit, then update_users -------------------------
    zero_launches(*STEP, "mf_segment_apply")
    t0 = time.perf_counter()
    model.fit(X, y, n_epochs=3)
    out["fit_seconds"] = time.perf_counter() - t0
    hist = model.train_rmse
    out["train_rmse"] = hist
    check(len(hist) == 3 and all(np.isfinite(hist)), f"train RMSE {hist}")
    check(hist[2] < hist[1] < hist[0], f"train RMSE not falling: {hist}")
    check(model._params.item_features.device.type == "cuda", "tables left the card")
    fit_launches = (n_launches(*STEP), n_launches("mf_segment_apply"))

    known = rng.choice(np.unique(u), 500, replace=False)
    new = np.arange(500) + 10_000_000
    uu = np.repeat(np.concatenate([known, new]), 100)
    ii = rng.integers(0, N_ITEMS, len(uu))
    pairs = np.unique(uu.astype(np.int64) * N_ITEMS + ii)
    Xu = pd.DataFrame({"user_id": pairs // N_ITEMS, "item_id": pairs % N_ITEMS})
    yu = pd.Series(np.round(rng.uniform(0.5, 5, len(Xu)) * 2) / 2)
    items = model._params.item_features.clone()
    n_users0 = model.n_users
    t0 = time.perf_counter()
    model.update_users(Xu, yu)
    torch.cuda.synchronize()
    out["update_users_seconds"] = time.perf_counter() - t0
    launches = {"sgd_step": n_launches(*STEP),
                "segment_apply": n_launches("mf_segment_apply")}
    check(launches["sgd_step"] > fit_launches[0], "update_users did not step")
    check(torch.equal(model._params.item_features, items),
          "update_users moved the frozen item table")
    check(model.n_users == n_users0 + 500, "update_users did not add users")
    out.update({"fit_launches": dict(zip(launches, fit_launches)),
                "launches": launches, "update_users_ratings": len(Xu),
                "update_users_rmse_last": model.train_rmse[-1]})

    # -- predict held-out pairs, recommend -----------------------------
    preds = np.asarray(model.predict(pd.DataFrame({"user_id": hu,
                                                   "item_id": hi})))
    check(preds.shape == (N_HELD_OUT,) and np.isfinite(preds).all(),
          "held-out predict shape")
    check(preds.min() >= 0.5 and preds.max() <= 5.0,
          "held-out predict outside [0.5, 5]")
    out["heldout_predict_mean"] = float(preds.mean())
    n0 = n_launches("mf_score_catalog")
    rec = model.recommend(int(u[0]), amount=10)
    check(n_launches("mf_score_catalog") > n0 and len(rec) == 10,
          "recommend after training did not launch the scorer")
    del model, X
    torch.cuda.empty_cache()

    # -- throughput on the pack made once ------------------------------
    cfg = sgd_cfg(kernel, N_FACTORS, spec["lr"], spec["batch_size"],
                  compute_epoch_rmse=False)
    p0 = sgd.init_params(torch.Generator(device="cuda").manual_seed(seed),
                         N_USERS, N_ITEMS, cfg, float(r.mean()))
    gen = torch.Generator().manual_seed(seed)
    sgd.sgd_train(p0, pack, gen, cfg, 1, cfg.lr)  # warm-up epoch
    windows, enqueue = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sgd.sgd_train(p0, pack, gen, cfg, 1, cfg.lr)
        enqueue.append(time.perf_counter() - t0)  # host time to enqueue
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - t0)
    out["epoch_seconds"] = windows
    out["epoch_enqueue_seconds"] = enqueue
    out["updates_per_sec"] = pack.n_real / statistics.median(windows)

    # -- one epoch against the plain step; the kernel epoch repeated -----
    order = torch.randperm(pack.n_batches, generator=gen)
    pk = clone_params(p0)
    sgd.epoch(pk, pack, cfg, cfg.lr, order=order)
    pk2 = clone_params(p0)
    sgd.epoch(pk2, pack, cfg, cfg.lr, order=order)
    pp = clone_params(p0)
    plain_epoch(pp, pack, cfg, order)
    torch.cuda.synchronize()
    err = max(float((pk.user_features - pp.user_features).abs().max()),
              float((pk.item_features - pp.item_features).abs().max()))
    out["epoch_vs_plain_max_abs_err"] = err
    check(err <= 1e-4, f"a kernel epoch differs from the plain epoch by {err}")
    check(torch.equal(pk.user_features, pk2.user_features)
          and torch.equal(pk.item_features, pk2.item_features),
          "the kernel epoch is not bitwise repeatable")
    del pk, pk2, pp
    torch.cuda.empty_cache()

    # -- where an epoch's time goes ------------------------------------
    out["epoch_profile"] = _device_share(
        torch, lambda _: sgd.sgd_train(p0, pack, gen, cfg, 1, cfg.lr), [0])
    out["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    return out


def phase_golden(torch):
    """The golden mini fixture on the card: held-out RMSE within 1e-3 of
    the pinned sequential-oracle values (``tests/test_golden_mini.py``),
    replaying the JAX engine's batch orders recorded beside the fixture."""
    import numpy as np

    from matrix_factorization_tpu_torch import params_from_numpy
    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    data_dir = Path(__file__).resolve().parent / "tests" / "data"
    exp = json.loads((data_dir / "golden_mini_expected.json").read_text())
    orders = json.loads((data_dir / "golden_mini_batch_orders.json").read_text())
    raw = np.genfromtxt(data_dir / "golden_mini.csv", delimiter=",",
                        skip_header=1)
    u, i = raw[:, 0].astype(np.int32), raw[:, 1].astype(np.int32)
    r, tr = raw[:, 2].astype(np.float64), raw[:, 3].astype(bool)
    init = np.random.default_rng(exp["init_seed"])
    nu, ni, K = exp["n_users"], exp["n_items"], exp["n_factors"]
    P0 = init.normal(0, 0.1, (nu, K))
    Q0 = init.normal(0, 0.1, (ni, K))
    mu = float(r[tr].mean())
    lo, hi = exp["min_rating"], exp["max_rating"]
    out = {"phase": "golden", "budget": 1e-3}
    for kernel in ("linear", "sigmoid", "rbf"):
        cfg = SGDConfig(kernel=kernel, n_factors=K, lr=exp["lrs"][kernel],
                        reg=exp["reg"], gamma=exp["gamma"], min_rating=lo,
                        max_rating=hi, batch_size=1024)
        kp = cfg.padded_factors
        uf = np.zeros((sgd.round_up(nu, 8), kp), np.float32)
        uf[:nu, :K] = P0
        itf = np.zeros((sgd.round_up(ni, 8), kp), np.float32)
        itf[:ni, :K] = Q0
        if kernel != "rbf":
            uf[:, sgd.const_col(cfg, "user")] = 1.0
            itf[:, sgd.const_col(cfg, "item")] = 1.0
        for order in ("shuffle", "item"):
            params = params_from_numpy(uf, itf, mu, device="cuda")
            data = sgd.pack_ratings(u[tr], i[tr], r[tr].astype(np.float32),
                                    1024, order=order, device="cuda")
            params, _ = sgd.sgd_train(params, data, None, cfg, exp["n_epochs"],
                                      cfg.lr, batch_orders=orders["orders"])
            P = params.user_features.cpu().numpy().astype(np.float64)
            Q = params.item_features.cpu().numpy().astype(np.float64)
            ut, it_, rt = u[~tr], i[~tr], r[~tr]
            Pu, Qi = P[ut, :K], Q[it_, :K]
            if kernel == "rbf":
                pred = lo + (hi - lo) * np.exp(
                    -exp["gamma"] * ((Pu - Qi) ** 2).sum(1))
            else:
                x = (mu + P[ut, sgd.bias_col(cfg, "user")]
                     + Q[it_, sgd.bias_col(cfg, "item")] + (Pu * Qi).sum(1))
                pred = x if kernel == "linear" else lo + (hi - lo) / (1 + np.exp(-x))
            e = float(np.sqrt(np.mean((np.clip(pred, lo, hi) - rt) ** 2)))
            gap = abs(e - exp["oracle_test_rmse"][kernel])
            out[f"{kernel}_{order}_test_rmse"] = e
            out[f"{kernel}_{order}_gap"] = gap
            check(gap <= 1e-3, f"golden {kernel}/{order}: held-out RMSE {e} "
                               f"vs pinned {exp['oracle_test_rmse'][kernel]}")
    return out


def phase_train_headline(torch, head_data, pack, pack_seconds, seed, smi):
    """bench.py's headline shape: updates/s over a 20-epoch window,
    median of 5."""
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    u, i, r = head_data
    cfg = sgd_cfg("linear", HEAD["n_factors"], HEAD["lr"], HEAD["batch_size"],
                  reg=HEAD["reg"], compute_epoch_rmse=False, shuffle="batch")
    params = sgd.init_params(torch.Generator(device="cuda").manual_seed(seed),
                             HEAD["n_users"], HEAD["n_items"], cfg,
                             float(r.mean()))
    gen = torch.Generator().manual_seed(seed)
    sgd.sgd_train(params, pack, gen, cfg, HEAD["epochs"], cfg.lr)  # warm-up
    rates, enqueue = [], []
    for _ in range(HEAD["trials"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sgd.sgd_train(params, pack, gen, cfg, HEAD["epochs"], cfg.lr)
        enqueue.append(time.perf_counter() - t0)  # host time to enqueue
        torch.cuda.synchronize()
        rates.append(HEAD["epochs"] * pack.n_real / (time.perf_counter() - t0))
    prof = _device_share(
        torch, lambda _: sgd.sgd_train(params, pack, gen, cfg, 1, cfg.lr), [0])
    return {"phase": "train_headline", "nvidia_smi": smi,
            "kernelmf_sgd_rating_updates_per_sec": statistics.median(rates),
            "updates_per_sec_best": max(rates), "trials": rates,
            "window_enqueue_seconds": enqueue,
            "window_epochs": HEAD["epochs"], "n_ratings": pack.n_real,
            "batch_size": pack.batch_size, "n_batches": pack.n_batches,
            "primary": pack.primary, "pack_seconds": pack_seconds,
            "epoch_profile": prof}


def sgd_bounds(b, kp, primary):
    """(bound_ms, bound_by) of the step and of the apply on this batch:
    each input read once (ids, r, w; each distinct secondary row; each
    primary run's row), each output written once (the primary rows, dq;
    the apply's touched rows), at 3.35 TB/s; about 12 f32 operations per
    entry and column for the step, 1 for the apply, at 67 TFLOP/s."""
    prim = b["u"] if primary == "user" else b["i"]
    n = prim.numel()
    runs_prim = int(prim.unique_consecutive().numel())
    runs_sec = int(b["ss"].unique_consecutive().numel())
    row = kp * 4
    step_bytes = n * 16 + runs_sec * row + 2 * runs_prim * row + n * row
    apply_bytes = n * (row + 8) + 2 * runs_sec * row
    out = {}
    for name, nbytes, flops in (("sgd_step", step_bytes, 12 * n * kp),
                                ("segment_apply", apply_bytes, n * kp)):
        tb, to = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]
        out[name] = (max(tb, to) * 1e3, "bytes" if tb >= to else "operations",
                     nbytes)
    return out, runs_prim, runs_sec


def phase_sgd_kernel_times(torch, rng, shapes, timer):
    """Kernel, plain and library times of the step and the apply on the
    first batch of each (name, cfg, pack, n_users, n_items) shape, and
    their bounds; returns {shape name: {kernel name: row}}."""
    from matrix_factorization_tpu_torch.ops import cuda_sgd
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.ops import segment_sum as ss

    out = {}
    for shape, cfg, pack, n_users, n_items in shapes:
        b = sgd.batch_at(pack, 0)
        p = random_params(torch, rng, cfg, n_users, n_items)
        args, _, S = step_args(p, b, cfg, pack.primary)
        bounds, runs_prim, runs_sec = sgd_bounds(b, cfg.padded_factors,
                                                 pack.primary)
        dq = cuda_sgd.cuda_sgd_step(*args)
        ss_long, dq_perm = b["ss"].long(), dq[b["sp"].long()]
        rows = {
            "sgd_step": {
                "ms": timer.ms(lambda: cuda_sgd.cuda_sgd_step(*args)),
                "plain_ms": timer.ms(lambda: cuda_sgd.plain_sgd_step(*args)),
                "library_ms": None},
            "segment_apply": {
                "ms": timer.ms(lambda: ss.cuda_segment_apply(
                    S, dq, b["sp"], b["ss"])),
                "plain_ms": timer.ms(lambda: ss.plain_segment_apply(
                    S, dq, b["sp"], b["ss"])),
                # one PyTorch call of the same function on the pre-permuted
                # rows: a float-atomic scatter, a yardstick the port never
                # calls
                "library_ms": timer.ms(lambda: S.index_add_(0, ss_long, dq_perm))},
        }
        for name, row in rows.items():
            row.update({"shape": shape, "bound_ms": bounds[name][0],
                        "bound_by": bounds[name][1],
                        "bound_bytes": bounds[name][2], "bs": pack.batch_size,
                        "Kp": cfg.padded_factors, "kernel": cfg.kernel,
                        "primary": pack.primary, "runs_prim": runs_prim,
                        "runs_sec": runs_sec,
                        "longest_prim_run": longest_run(
                            b["u"] if pack.primary == "user" else b["i"]),
                        "launches_per_epoch": pack.n_batches})
            emit({"phase": "sgd_kernel_time", "name": name, **row})
        out[shape] = rows
        del dq, dq_perm, p, args, S
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Factor ALS (slice 3): the Gauss-Jordan SPD leaf
# ---------------------------------------------------------------------------

# (E, d) of the leaf comparisons: the two Schur halves of a config-3 user
# chunk at k=200 (15,625 users of 256 slots, d=201 split 104 + 97), an item
# chunk at k=100 (d=101), d=128 past the 48 KB shared-memory opt-in,
# ImplicitALS's default d=64, and two small shapes
SPD_SHAPES = ((15_625, 104), (15_625, 97), (7_812, 101), (1_000, 128),
              (4_096, 64), (3, 8), (5, 1))
SPD_TIMED = SPD_SHAPES[:5]
# KernelMF(method='als') at config 3's width (benchmarks/RESULTS.md,
# "Extension: factor ALS")
ALS = {"n_factors": 200, "reg": 0.1, "reg_scale": "per_obs", "sweeps": 3}
# the ALS warm start of a sigmoid fit, on the first 2.5M config-3 ratings
WARM = {"n_ratings": 2_500_000, "batch_size": 2_097_152, "lr": 0.01,
        "reg": 0.005, "als_warm_reg": 0.1}
# ImplicitALS at its default width on the MovieLens-1M shape
IMPLICIT = {"n_users": 6_040, "n_items": 3_706, "n": 1_000_000, "epochs": 3,
            "new_users": 100}


def jacobi_scaled(torch, A):
    """``A`` scaled to a unit diagonal, as ``spd_solve`` hands it down."""
    ds = torch.rsqrt(torch.diagonal(A, dim1=-2, dim2=-1))
    return (A * ds[:, :, None] * ds[:, None, :]).contiguous()


def ridged_grams(torch, gen, E, d, L=64, ridge=0.5):
    """Jacobi-scaled ``X^T X + ridge I`` of seeded N(0, 0.3^2) rows, as
    ``tests/test_spd.py::_ridged_gram`` makes them: (E, d, d) f32."""
    X = torch.randn((E, L, d), generator=gen, device="cuda") * 0.3
    A = X.transpose(1, 2) @ X
    A.diagonal(dim1=-2, dim2=-1).add_(ridge)
    return jacobi_scaled(torch, A)


def spd_bound(E, d):
    """(bound_ms, bound_by) of E GJ inverses: 2 d^3 f32 operations and
    8 d^2 bytes (read once, written once) a matrix."""
    t_ops = 2.0 * d ** 3 * E / PEAK_FLOPS["float32"]
    t_bytes = 8.0 * d * d * E / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def first_full_chunk(buckets):
    return max(buckets, key=lambda b: b.other_ids.shape[0])


def chunk_leaves(torch, A):
    """The two GJ leaf inputs of ``spd_solve`` on a d=201 batch: the
    Jacobi-scaled A11 (104) and its Schur complement S (97), formed as
    ``spd_inverse`` forms them."""
    from matrix_factorization_tpu_torch.ops import cuda_spd, spd

    As = jacobi_scaled(torch, A)
    d = As.shape[-1]
    m = ((d // 2 + 7) // 8) * 8
    A11 = As[:, :m, :m].contiguous()
    A12 = As[:, :m, m:]
    inv11 = cuda_spd.cuda_gj_inverse(A11)
    S = As[:, m:, m:] - spd._mm(A12.transpose(1, 2), spd._mm(inv11, A12))
    return A11, S.contiguous()


def phase_compare_spd(torch, gen, real):
    """The GJ kernel against its plain version on the card, both against
    the float64 inverse; returns the largest kernel-vs-plain error.
    ``real``: (name, batch) leaf inputs of the config-3 chunk."""
    from matrix_factorization_tpu_torch.ops import cuda_spd

    def cases():
        for E, d in SPD_SHAPES:
            yield f"ridged_{E}x{d}", ridged_grams(torch, gen, E, d)
        yield from real

    worst = 0.0
    for name, A in cases():
        E, d = A.shape[0], A.shape[-1]
        got = cuda_spd.cuda_gj_inverse(A)
        want = cuda_spd.plain_gj_inverse(A)
        A64 = A.double()
        exact = torch.linalg.inv(A64)
        eye = torch.eye(d, dtype=torch.float64, device="cuda")
        err = float((got - want).abs().max())
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, want, atol=1e-4, rtol=1e-4)
        out = {"phase": "compare_spd", "case": name, "E": E, "d": d,
               "max_abs_err": err,
               "kernel_eye_err": float((A64 @ got.double() - eye).abs().max()),
               "plain_eye_err": float((A64 @ want.double() - eye).abs().max()),
               "kernel_vs_f64": float((got.double() - exact).abs().max()),
               "plain_vs_f64": float((want.double() - exact).abs().max()),
               "inv_max_abs": float(exact.abs().max()), "ok": ok}
        emit(out)
        check(ok, f"compare_spd {name}: kernel differs from plain by {err}")
        check(out["kernel_eye_err"] < 5e-3 and out["plain_eye_err"] < 5e-3,
              f"compare_spd {name}: |A X - I| too large")
        worst = max(worst, err)
        del A, A64, got, want, exact
        torch.cuda.empty_cache()
    return worst


def phase_train_als(torch, rng, data3, seed, tmpdir):
    """KernelMF(method='als') at config 3 through ``fit`` (3 sweeps, on the
    bucketed path) and ``update_users`` (1,000 users, half known; the item
    table bitwise unchanged), with the GJ count zeroed just before and
    read just after; then ``predict``, ``recommend`` and a checkpoint
    round trip."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import KernelMF, load_model, save_model
    from matrix_factorization_tpu_torch.models import kernel_mf

    u, i, r, hu, hi = data3
    model = KernelMF(method="als", kernel="linear", n_factors=ALS["n_factors"],
                     reg=ALS["reg"], reg_scale=ALS["reg_scale"], min_rating=0.5,
                     max_rating=5.0, seed=seed)
    X = pd.DataFrame({"user_id": u, "item_id": i})
    out = {"phase": "train_als", "n_ratings": len(r), **ALS}

    zero_launches("mf_gj_inverse")
    t0 = time.perf_counter()
    model.fit(X, pd.Series(r), n_epochs=ALS["sweeps"])
    torch.cuda.synchronize()
    out["fit_seconds"] = time.perf_counter() - t0
    hist = model.train_rmse
    out["train_rmse"] = hist
    check(kernel_mf._als_needs_buckets(u, i, model.n_users, model.n_items),
          "config 3 should take the bucketed ALS path")
    check(len(hist) == ALS["sweeps"] and all(np.isfinite(hist)),
          f"ALS train RMSE {hist}")
    check(hist[-1] < hist[0], f"ALS train RMSE not falling: {hist}")
    fit_launches = n_launches("mf_gj_inverse")

    known = rng.choice(np.unique(u), 500, replace=False)
    new = np.arange(500) + 10_000_000
    uu = np.repeat(np.concatenate([known, new]), 100)
    ii = rng.integers(0, N_ITEMS, len(uu))
    pairs = np.unique(uu.astype(np.int64) * N_ITEMS + ii)
    Xu = pd.DataFrame({"user_id": pairs // N_ITEMS, "item_id": pairs % N_ITEMS})
    yu = pd.Series(np.round(rng.uniform(0.5, 5, len(Xu)) * 2) / 2)
    items = model._params.item_features.clone()
    n_users0 = model.n_users
    t0 = time.perf_counter()
    model.update_users(Xu, yu)
    torch.cuda.synchronize()
    out["update_users_seconds"] = time.perf_counter() - t0
    launches = n_launches("mf_gj_inverse")
    check(launches > fit_launches, "ALS update_users did not launch the GJ leaf")
    check(torch.equal(model._params.item_features, items),
          "ALS update_users moved the frozen item table")
    check(model.n_users == n_users0 + 500, "ALS update_users did not add users")
    out.update({"fit_launches": fit_launches, "launches": launches,
                "update_users_rmse": model.train_rmse})

    preds = np.asarray(model.predict(pd.DataFrame({"user_id": hu,
                                                   "item_id": hi})))
    check(preds.shape == (N_HELD_OUT,) and np.isfinite(preds).all()
          and preds.min() >= 0.5 and preds.max() <= 5.0,
          "ALS held-out predict")
    out["heldout_predict_mean"] = float(preds.mean())
    n0 = n_launches("mf_score_catalog")
    rec = model.recommend(int(u[0]), amount=10)
    check(n_launches("mf_score_catalog") > n0 and len(rec) == 10,
          "ALS recommend did not launch the scorer")
    save_model(model, f"{tmpdir}/als")
    back = load_model(f"{tmpdir}/als")
    again = back.recommend(int(u[0]), amount=10)
    check(list(again["item_id"]) == list(rec["item_id"]) and np.array_equal(
        again["rating_pred"].to_numpy(), rec["rating_pred"].to_numpy()),
        "the reloaded ALS model recommends otherwise")
    del model, back, X
    torch.cuda.empty_cache()
    return out


def phase_als_sweeps(torch, data3, buckets, seed):
    """One sweep's seconds at k=200 and k=100 on buckets made once
    (median of 3), the first full user chunk's normal equations solved
    with the Cholesky leaf against the GJ leaf, the sweep repeated
    (bitwise equal) and a profiled sweep."""
    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import ials, spd
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    bu, bi = buckets
    mean = float(data3[2].mean())
    out = {"phase": "als_sweeps", "user_chunks": len(bu), "item_chunks": len(bi)}
    for k in (ALS["n_factors"], 100):
        cfg = SGDConfig(kernel="linear", n_factors=k, reg=ALS["reg"],
                        min_rating=0.5, max_rating=5.0, compute_epoch_rmse=False)
        p0 = sgd.init_params(torch.Generator(device="cuda").manual_seed(seed),
                             N_USERS, N_ITEMS, cfg, mean)

        def sweep(_=None):
            return ials.ials_train_bucketed(p0, bu, bi, None, cfg, 1,
                                            reg_scale=ALS["reg_scale"])[0]

        sweep()  # warm-up
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p1 = sweep()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        out[f"k{k}_sweep_seconds"] = secs
        out[f"k{k}_sweep_median_s"] = statistics.median(secs)
        if k != ALS["n_factors"]:
            continue
        p2 = sweep()
        check(torch.equal(p1.user_features, p2.user_features)
              and torch.equal(p1.item_features, p2.item_features),
              "the ALS sweep is not bitwise repeatable")
        ch = first_full_chunk(bu)
        A, b = ials.normal_equations(p0.item_features, ch.other_ids, ch.ratings,
                                     ch.mask, p0.global_mean, cfg, "user",
                                     reg_scale=ALS["reg_scale"])
        x_gj = spd.spd_solve(A, b)
        x_chol = spd.spd_solve(A, b, leaf="cholesky")
        err = float((x_gj - x_chol).abs().max())
        out.update({"cholesky_vs_gj_max_abs_err": err,
                    "solution_max_abs": float(x_gj.abs().max()),
                    "chunk_E": int(A.shape[0]), "chunk_L": int(ch.other_ids.shape[1])})
        check(torch.allclose(x_gj, x_chol, atol=1e-4, rtol=0),
              f"Cholesky-leaf solve differs from the GJ-leaf solve by {err}")
        del A, b, x_gj, x_chol, p2
        torch.cuda.empty_cache()
        out["sweep_profile"] = _device_share(torch, sweep, [0],
                                             match="gj_inverse_kernel")
        out["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    return out


# the normal equations' long chunk: entities of two slices' slots, each
# the lists of several item entities side by side (config 3's buckets stop
# at 1,024 slots, one slice)
NORMAL_EQ_LONG_E = 256


def normal_eq_work(k, E, L, live):
    """(operations, bytes) of E entities' normal equations of L slots at k
    factors, ``live`` of the slots live: each live row's augmented upper
    triangle, 2 (d + 1)(d + 2) / 2 flops at d = k + 1, and its k + 2
    columns read, the (E, L) slots read, A and b written."""
    d = k + 1
    flops = 2 * live * (d + 1) * (d + 2) // 2
    nbytes = live * (-(-(k + 2) // 4) * 4) * 4 + E * L * 12 + E * (d * d + d) * 4
    return flops, nbytes


def phase_normal_eq(torch, buckets, p, cfg, reg_scale, timer):
    """The normal-equation kernel (``ials.normal_equations`` on the card)
    against ``plain_normal_equations`` on the same slots, at the first
    full user chunk (d = 201) and at ``NORMAL_EQ_LONG_E`` entities of two
    slices' slots, each the lists of 2 * SLICE / L consecutive entities of
    the first full item chunk side by side (their padding left in place:
    a mask with holes), so that the finish kernel runs: A and b within
    1e-5 of the plain body's largest entry, two calls the same bits, one
    launch a call; then the kernel, the plain body and the library (the
    batched product alone on the plain body's masked design block) timed
    in turns, beside the bound. Returns the rows and the largest absolute
    difference."""
    from matrix_factorization_tpu_torch.ops import cuda_normal_eq, ials
    from matrix_factorization_tpu_torch.ops.segment_sgd import bias_col, const_col
    from matrix_factorization_tpu_torch.ops.spd import exact_f32

    bu, bi = buckets
    k = cfg.n_factors
    b = first_full_chunk(bi)
    E0, L0 = b.other_ids.shape
    f = -(-2 * cuda_normal_eq.SLICE // L0)
    n = min(NORMAL_EQ_LONG_E, E0 // f)
    check(n >= 1, f"normal_eq: the item chunk {E0} x {L0} makes no long list")
    long_slots = [x[:n * f].reshape(n, f * L0) for x in (b.other_ids, b.ratings, b.mask)]
    rows, worst = [], 0.0
    for name, side, (ids, r, m) in (("user_chunk", "user", first_full_chunk(bu)[1:]),
                                    ("long_chunk", "item", long_slots)):
        other = p.item_features if side == "user" else p.user_features
        o_side = "item" if side == "user" else "user"
        o_bias, o_const = bias_col(cfg, o_side), const_col(cfg, o_side)

        def kernel():
            return ials.normal_equations(other, ids, r, m, p.global_mean, cfg,
                                         side, reg_scale=reg_scale)

        def plain():
            return ials.plain_normal_equations(other, ids, r, m, p.global_mean, k,
                                               o_bias, o_const, cfg.reg,
                                               reg_scale=reg_scale)

        n0 = n_launches("mf_normal_eq")
        A, rhs = kernel()
        A2, rhs2 = kernel()
        check(n_launches("mf_normal_eq") == n0 + 2,
              f"normal_eq {name}: normal_equations did not launch the kernel")
        same = bool(torch.equal(A, A2) and torch.equal(rhs, rhs2))
        del A2, rhs2
        wA, wb = plain()
        E, L = ids.shape
        err = {"err_A": float((A - wA).abs().max()), "err_b": float((rhs - wb).abs().max()),
               "plain_max_A": float(wA.abs().max()), "plain_max_b": float(wb.abs().max())}
        worst = max(worst, err["err_A"], err["err_b"])
        del A, rhs, wA, wb
        check(same, f"normal_eq {name}: two kernel calls differ")
        check(err["err_A"] <= 1e-5 * err["plain_max_A"]
              and err["err_b"] <= 1e-5 * err["plain_max_b"],
              f"normal_eq {name}: the kernel against the plain body {err}")
        design = torch.cat([other[:, :k], other[:, o_const:o_const + 1]], dim=1)
        Xm = design[ids.long()].mul_(m[..., None])
        del design

        def library():
            with exact_f32():
                return torch.bmm(Xm.transpose(1, 2), Xm)

        bodies = {"kernel": kernel, "plain": plain, "library": library}
        times = {w: [] for w in bodies}
        for w in (*bodies, *reversed(bodies)):
            times[w].append(timer.ms(bodies[w], reps=5))
        live = int(m.count_nonzero())
        flops, nbytes = normal_eq_work(k, E, L, live)
        t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / HBM_BYTES_PER_S
        row = {"shape": name, "side": side, "E": E, "L": L, "d": k + 1,
               "live_rows": live,
               "slices": cuda_normal_eq.normal_eq_plan(k + 1, L).slices,
               **err, "same_bits": same,
               **{f"{w}_ms": min(t) for w, t in times.items()},
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        row["roofline"] = row["bound_ms"] / row["kernel_ms"]
        rows.append(row)
        emit({"phase": "normal_eq_kernel_time", **row})
        del Xm
        torch.cuda.empty_cache()
    check(rows[1]["slices"] > 1, "the long chunk did not take the slices")
    return rows, worst


def split_bytes(E, d, m):
    """The block solve's split: As11, As12 and As22 read from A and
    written, ds written."""
    n = d - m
    return 4 * E * (2 * (m * m + m * n + n * n) + d)


def backsolve_bytes(E, d):
    """The block solve's back-solve at one refinement: the staged blocks
    (d^2 floats), A, ds and b read, x written."""
    return 4 * E * (2 * d * d + 3 * d)


def phase_spd_block_solve(torch, A, b, timer):
    """The block solve's kernels against their plain versions on the card
    at the systems ``A`` (E, d, d), ``b`` (E, d): ``mf_spd_split`` the
    bits of ``plain_spd_split``; ``mf_spd_block_solve`` at refine 1, on
    the blocks ``spd._schur_blocks`` forms, within 1e-6 of
    ``plain_block_solve`` (relative to its largest |x|); two calls the
    same bits, one launch a call. Then kernel, plain and library (what
    each kernel replaced in the solve before it: ``_jacobi`` and the
    scaling's two broadcast products; the explicit inverse applied, the
    residual, applied again, by batched matrix-vector products) timed in
    turns beside the bytes bound. Returns the two rows."""
    from matrix_factorization_tpu_torch.ops import cuda_spd_solve as css
    from matrix_factorization_tpu_torch.ops import spd

    E, d = A.shape[0], A.shape[-1]
    m = css.split_point(d)
    n0 = n_launches("mf_spd_split")
    got, again = css.cuda_spd_split(A), css.cuda_spd_split(A)
    check(n_launches("mf_spd_split") == n0 + 2, "spd_split: not one launch a call")
    want = css.plain_spd_split(A)
    split = {"same_bits": all(torch.equal(g, w) for g, w in zip(got, want)),
             "repeat_same_bits": all(torch.equal(g, h) for g, h in zip(got, again))}
    del got, again, want
    check(split["same_bits"] and split["repeat_same_bits"],
          f"spd_split: the kernel against the plain split {split}")

    blocks = spd._schur_blocks(A)
    n0 = n_launches("mf_spd_block_solve")
    x, x2 = (css.cuda_block_solve(*blocks, A, b, 1) for _ in range(2))
    check(n_launches("mf_spd_block_solve") == n0 + 2,
          "spd_block_solve: not one launch a call")
    xp = css.plain_block_solve(*blocks, A, b, 1)
    err = float((x - xp).abs().max())
    solve = {"repeat_same_bits": bool(torch.equal(x, x2)), "max_abs_err": err,
             "plain_max_x": float(xp.abs().max())}
    solve["rel_err"] = err / solve["plain_max_x"]
    del x, x2, xp
    check(solve["repeat_same_bits"] and solve["rel_err"] <= 1e-6,
          f"spd_block_solve: the kernel against the plain back-solve {solve}")

    def scale():
        ds = spd._jacobi(A)
        return A * ds[:, :, None] * ds[:, None, :]

    inv = spd._inverse(scale(), 32, "auto", inplace=True)
    ds = blocks[-1]

    def apply_inverse():
        x = ds * spd._matvec(inv, ds * b)
        return x + ds * spd._matvec(inv, ds * (b - spd._matvec(A, x)))

    rows = []
    for name, bodies, nbytes, check_row in (
            ("spd_split", {"kernel": lambda: css.cuda_spd_split(A),
                           "plain": lambda: css.plain_spd_split(A),
                           "library": scale}, split_bytes(E, d, m), split),
            ("spd_block_solve", {"kernel": lambda: css.cuda_block_solve(*blocks, A, b, 1),
                                 "plain": lambda: css.plain_block_solve(*blocks, A, b, 1),
                                 "library": apply_inverse},
             backsolve_bytes(E, d), solve)):
        times = {w: [] for w in bodies}
        for w in (*bodies, *reversed(bodies)):
            times[w].append(timer.ms(bodies[w], reps=5))
        row = {"kernel": name, "E": E, "d": d, "m": m, **check_row,
               **{f"{w}_ms": min(t) for w, t in times.items()},
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        row["roofline"] = row["bound_ms"] / row["kernel_ms"]
        rows.append(row)
        emit({"phase": "spd_block_solve_time", **row})
        torch.cuda.empty_cache()
    del inv, blocks
    torch.cuda.empty_cache()
    return rows


def phase_warm_start(torch, data3, seed):
    """A sigmoid fit with one ALS warm sweep then one SGD epoch, on the
    first 2.5M config-3 ratings, against a cold fit of the same epoch."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import KernelMF

    n = WARM["n_ratings"]
    X = pd.DataFrame({"user_id": data3[0][:n], "item_id": data3[1][:n]})
    y = pd.Series(data3[2][:n])
    kw = dict(kernel="sigmoid", n_factors=N_FACTORS, lr=WARM["lr"],
              reg=WARM["reg"], min_rating=0.5, max_rating=5.0,
              batch_size=WARM["batch_size"], seed=seed)
    out = {"phase": "warm_start", **WARM}
    zero_launches("mf_gj_inverse", *STEP, "mf_segment_apply")
    t0 = time.perf_counter()
    warm = KernelMF(als_warm_start=1, als_warm_reg=WARM["als_warm_reg"],
                    **kw).fit(X, y, n_epochs=1)
    torch.cuda.synchronize()
    out["fit_seconds"] = time.perf_counter() - t0
    launches = {"spd_gj": n_launches("mf_gj_inverse"), "sgd_step": n_launches(*STEP),
                "segment_apply": n_launches("mf_segment_apply")}
    check(all(v > 0 for v in launches.values()),
          f"the warm-start fit missed a kernel: {launches}")
    cold = KernelMF(**kw).fit(X, y, n_epochs=1)
    out.update({"launches": launches, "warm_train_rmse": warm.train_rmse,
                "cold_train_rmse": cold.train_rmse})
    check(np.isfinite(warm.train_rmse).all()
          and warm.train_rmse[-1] < cold.train_rmse[-1],
          f"warm start {warm.train_rmse} not below cold {cold.train_rmse}")
    del warm, cold
    torch.cuda.empty_cache()
    return out


def phase_implicit(torch, seed):
    """ImplicitALS at its default width (k=64) on 1M seeded interactions of
    6,040 x 3,706 (the MovieLens-1M shape), strengths 1..10: ``fit`` (loss
    falling), ``update_users`` for new users, ``recommend``."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import ImplicitALS

    nu, ni, n = IMPLICIT["n_users"], IMPLICIT["n_items"], IMPLICIT["n"]
    rng = np.random.default_rng(seed + 2)
    flat = np.unique(rng.integers(0, nu * ni, int(n * 1.05)))
    rng.shuffle(flat)
    flat = flat[:n]  # after the shuffle: the sorted head would drop users
    X = pd.DataFrame({"user_id": flat // ni, "item_id": flat % ni})
    s = pd.Series(rng.integers(1, 11, len(flat)).astype(np.float32))
    out = {"phase": "implicit", **IMPLICIT}
    zero_launches("mf_gj_inverse")
    t0 = time.perf_counter()
    m = ImplicitALS(n_epochs=IMPLICIT["epochs"], seed=seed).fit(X, s)
    torch.cuda.synchronize()
    out["fit_seconds"] = time.perf_counter() - t0
    loss = m.train_loss
    check(len(loss) == IMPLICIT["epochs"] and np.isfinite(loss).all()
          and loss[-1] < loss[0], f"implicit loss not falling: {loss}")
    k = IMPLICIT["new_users"]
    Xn = pd.DataFrame({"user_id": np.repeat(np.arange(k) + 10_000_000, 20),
                       "item_id": np.concatenate(
                           [rng.choice(ni, 20, replace=False) for _ in range(k)])})
    items = m._params.item_features.clone()
    m.update_users(Xn, pd.Series(rng.integers(1, 11, len(Xn)).astype(np.float32)))
    check(torch.equal(m._params.item_features, items),
          "implicit update_users moved the item table")
    rec = m.recommend(10_000_000, amount=10)
    check(len(rec) == 10 and m.n_users == nu + k, "implicit recommend")
    out.update({"train_loss": loss, "launches": n_launches("mf_gj_inverse")})
    check(n_launches("mf_gj_inverse") > 0, "ImplicitALS launched no GJ leaf")
    return out


TOPK_TIMED = ((60, 2_231_142, 100, "normal"), (16, 2_231_142, 100, "normal"),
              (60, 2_231_142, 500, "normal"), (60, 2_231_142, 100, "steps"))


def phase_topk_kernel_times(torch, timer):
    """The selection kernel against the torch selection body, bitwise, and
    both timed beside ``torch.topk`` alone, at ``TOPK_TIMED``."""
    from matrix_factorization_tpu_torch.ops import cuda_topk, scoring

    rows_out = []
    g = torch.Generator(device="cuda").manual_seed(0)
    for rows, n, k, kind in TOPK_TIMED:
        s = torch.randn((rows, n), generator=g, device="cuda")
        if kind == "steps":
            s = torch.round(s * 64) / 64
        want = scoring._plain_select_topk(s, k)
        before = n_launches("mf_topk_select")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = scoring._select_topk(s, k)
            again = scoring._select_topk(s, k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(n_launches("mf_topk_select") == before + 2,
              "_select_topk did not launch the selection kernel")
        check(all(torch.equal(a, b) for a, b in zip(got + again, want + got)),
              f"the selection kernel differs from the torch body at "
              f"{rows} x {n}, k {k}, {kind}")
        nbytes = rows * n * 4 + rows * k * 12
        row = {"rows": rows, "n": n, "k": k, "scores": kind,
               "chunks": cuda_topk.select_plan(
                   rows, n, k, torch.cuda.get_device_properties(0).multi_processor_count,
                   cuda_topk.blocks_per_sm()).chunks,
               "ms": timer.ms(lambda: scoring._select_topk(s, k)),
               "plain_ms": timer.ms(lambda: scoring._plain_select_topk(s, k)),
               "library_ms": timer.ms(lambda: torch.topk(s, k, dim=-1)),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        row["roofline"] = row["bound_ms"] / row["ms"]
        rows_out.append(row)
        emit({"phase": "topk_kernel_time", **row})
        del s, want, got, again
        torch.cuda.empty_cache()
    return rows_out


def phase_spd_kernel_times(torch, gen, timer):
    """Kernel, plain and library (``torch.linalg.inv``) times of the leaf
    at the main path's shapes, and their bounds."""
    from matrix_factorization_tpu_torch.ops import cuda_spd

    rows = []
    for E, d in SPD_TIMED:
        A = ridged_grams(torch, gen, E, d)
        b_ms, b_by = spd_bound(E, d)
        row = {"E": E, "d": d,
               "ms": timer.ms(lambda: cuda_spd.cuda_gj_inverse(A)),
               "plain_ms": timer.ms(lambda: cuda_spd.plain_gj_inverse(A)),
               # the one PyTorch call of the same function (LU-based): a
               # yardstick the port never calls
               "library_ms": timer.ms(lambda: torch.linalg.inv(A)),
               "bound_ms": b_ms, "bound_by": b_by}
        row["tflops"] = 2.0 * d ** 3 * E / (row["ms"] * 1e-3) / 1e12
        rows.append(row)
        emit({"phase": "spd_kernel_time", **row})
        del A
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# The bias, neighbourhood and content models and the sweep: the segment-sum
# kernel
# ---------------------------------------------------------------------------

# BASELINE.json config 2 (benchmarks/run_configs.py:126-162): MovieLens-1M
# shape, the bias model by ALS and by SGD
ML1M = {"n_users": 6_040, "n_items": 3_706, "n_ratings": 1_000_000,
        "held_out": 10_000}
BASE = {"als": {"method": "als", "reg": 0.5, "n_epochs": 20,
                "batch_size": 4096},
        "sgd": {"method": "sgd", "lr": 0.02, "reg": 0.02, "n_epochs": 20,
                "batch_size": 4096}}
CF_NEIGHBOURS = 50
CF_PREDICT = 100_000  # pairs timed; the first CF_ORACLE held to float64
CF_ORACLE = 2_000
N_GENRES = 18  # MovieLens-1M's genre count
# BASELINE.json config 1 (benchmarks/run_configs.py:114-123): MovieLens-100K
# shape, linear KernelMF, k=100, bs 4,096; the default 3 x 3 grid
ML100K = {"n_users": 943, "n_items": 1_682, "n_ratings": 100_000,
          "held_out": 10_000, "n_factors": 100, "batch_size": 4096,
          "epochs": 20}


def ml1m_ratings(seed):
    """MovieLens-1M-shaped ratings, as ``run_configs._gen`` makes them:
    (u, i, r) of the 1M training pairs and of the 10,000 held out."""
    n = ML1M["n_ratings"]
    u, i, r = gen_ratings(ML1M["n_users"], ML1M["n_items"],
                          n + ML1M["held_out"], seed)
    return (u[:n], i[:n], r[:n]), (u[n:], i[n:], r[n:])


def segsum_cases(train, rng):
    """(name, ids, n_rows, d) of the segment sum at the slice's shapes:
    the 1M ratings by user and by item (the bias sums, one column), by user
    with the 18 genre columns (the content profiles), a 4,096-entry batch
    (bias SGD's step), a stream with one 200,000-entry segment, and 1M
    entries in runs of 1-19 that straddle the lanes' slices of 8."""
    import numpy as np

    u, i, _ = train
    nu, ni = ML1M["n_users"], ML1M["n_items"]
    long_ids = np.concatenate([np.full(200_000, nu // 2),
                               rng.integers(0, nu, 300_000)])
    straddle = np.repeat(np.arange(100_000), rng.integers(1, 20, 100_000))
    return (("ml1m_by_user", u, nu, 1), ("ml1m_by_item", i, ni, 1),
            ("ml1m_profiles_by_user", u, nu, N_GENRES),
            ("batch_4096", u[:4096], nu, 1),
            ("long_segment", long_ids, nu, 1),
            ("straddle_slices", straddle, 100_000, 1))


def phase_compare_segsum(torch, rng, train):
    """The segment-sum kernel against ``index_add_`` on the card (rtol
    1e-5, atol 1e-5 x the row's absolute sum: both sum in f32, in other
    orders), bitwise against its plain model ``segmented_segment_sum``
    in the layout ``segsum_plan`` picks (the same adds in the same order)
    and against a second run. Returns the largest error."""
    import numpy as np

    from matrix_factorization_tpu_torch.ops import segment_sum as ss

    worst = 0.0
    for name, ids, n_rows, d in segsum_cases(train, rng):
        t0 = time.perf_counter()
        ids_t = torch.from_numpy(np.asarray(ids, np.int32)).to("cuda")
        vals = torch.from_numpy(rng.standard_normal(
            (len(ids), d), dtype=np.float32)).to("cuda")
        order = ss.sorted_order(ids_t)
        got = torch.zeros((n_rows, d), device="cuda")
        ss.cuda_segment_sum(got, vals, *order)
        again = torch.zeros_like(got)
        ss.cuda_segment_sum(again, vals, *order)
        model = torch.zeros_like(got)
        ss.segmented_segment_sum(model, vals, *order)
        want = torch.zeros_like(got)
        ss.plain_segment_sum(want, vals, *order)
        scale = torch.zeros_like(got)
        ss.plain_segment_sum(scale, vals.abs(), *order)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        check(torch.equal(got, again), f"compare_segsum {name}: two runs differ")
        check(torch.equal(got, model),
              f"compare_segsum {name}: the kernel is not its plain model")
        check(bool(torch.all((got - want).abs()
                             <= 1e-5 * want.abs() + 1e-5 * scale)),
              f"compare_segsum {name}: off index_add_ by {err}")
        emit({"phase": "compare_segsum", "case": name, "n": len(ids),
              "d": d, "rows": n_rows,
              "layout": ss.segsum_plan(len(ids), d).layout,
              "longest_segment": longest_run(order[1]),
              "max_abs_err": err, "max_abs_sum": float(want.abs().max()),
              "seconds": time.perf_counter() - t0, "ok": True})
    return worst


def bias_oracle(model, u_raw, i_raw):
    """float64 numpy predictions of a fitted ``BaselineModel`` from its
    biases: mu + the known sides' biases, clipped to the rating range."""
    import numpy as np

    uu = model.user_vocab.encode(np.asarray(u_raw, dtype=object))
    ii = model.item_vocab.encode(np.asarray(i_raw, dtype=object))
    bu = model.user_biases.astype(np.float64)
    bi = model.item_biases.astype(np.float64)
    pred = (float(model._params.global_mean) + np.where(uu >= 0, bu[uu], 0.0)
            + np.where(ii >= 0, bi[ii], 0.0))
    return np.clip(pred, model.min_rating, model.max_rating)


def bias_als_oracle(model, train, kw):
    """float64 numpy of the closed-form bias ALS that ``BaselineModel.fit``
    ran, from the raw ``train`` (u, i, r) encoded through the model's
    vocabularies: from zero biases, ``n_epochs`` sweeps of the user half
    (``np.bincount`` by user), then the item half with the fresh user
    biases; an id without ratings keeps its bias. Returns (user, item)
    biases."""
    import numpy as np

    u, i, r = train
    uu = model.user_vocab.encode(np.asarray(u, dtype=object))
    ii = model.item_vocab.encode(np.asarray(i, dtype=object))
    return bias_als_f64(uu, ii, r, model.n_users, model.n_items, kw["reg"],
                        kw["n_epochs"])


def bias_als_f64(uu, ii, r, nu, ni, reg, n_epochs):
    """float64 numpy of the closed-form bias ALS on dense ids: from zero
    biases, ``n_epochs`` sweeps of the user half, then the item half with
    the fresh user biases; an id without ratings keeps its bias. Returns
    (user, item) biases."""
    import numpy as np

    rr = np.asarray(r, np.float64)
    mu = rr.mean()
    cu = np.bincount(uu, minlength=nu).astype(np.float64)
    ci = np.bincount(ii, minlength=ni).astype(np.float64)
    bu, bi = np.zeros(nu), np.zeros(ni)
    for _ in range(n_epochs):
        bu = np.where(cu > 0, np.bincount(uu, rr - mu - bi[ii], nu)
                      / (reg + cu), bu)
        bi = np.where(ci > 0, np.bincount(ii, rr - mu - bu[uu], ni)
                      / (reg + ci), bi)
    return bu, bi


def bias_sgd_oracle(torch, model, X, y, kw, seed):
    """float64 numpy of the bias SGD that ``BaselineModel.fit`` ran: the
    same pack, the same per-epoch permutations (redrawn from the fit's
    seeded generator on the card), every entry reading the pre-step biases
    and each side's deltas summed by id. Returns (user, item) biases."""
    import numpy as np

    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    u = model.user_vocab.encode(X["user_id"].to_numpy())
    i = model.item_vocab.encode(X["item_id"].to_numpy())
    data = sgd.pack_ratings(u, i, np.asarray(y, np.float32), kw["batch_size"],
                            device="cpu")
    uf, if_ = (t.reshape(-1).long().numpy() for t in (data.user_ids,
                                                       data.item_ids))
    rf, wf = (t.reshape(-1).double().numpy() for t in (data.ratings,
                                                        data.weights))
    n_pad = len(uf)
    nb = max(1, n_pad // kw["batch_size"])
    gen = sgd.seeded_generator(model._device, seed, 0)
    visits = [torch.randperm(n_pad, generator=gen, device=gen.device)
              .cpu().numpy().reshape(nb, -1) for _ in range(kw["n_epochs"])]
    return bias_sgd_f64((uf, if_, rf, wf), visits,
                        float(model._params.global_mean), kw["lr"], kw["reg"],
                        model.n_users, model.n_items)


def bias_sgd_f64(stream, visits, mu, lr, reg, nu, ni):
    """float64 numpy of synchronous mini-batch bias SGD from zero biases
    over the flat padded ``stream`` (u, i, r, w): ``visits`` holds one
    (nb, bs) array of stream indices an epoch, its rows the batches in
    visit order; every entry of a batch reads the pre-step biases and
    each side's deltas are summed by id. Returns (user, item) biases."""
    import numpy as np

    uf, if_, rf, wf = stream
    bu, bi = np.zeros(nu), np.zeros(ni)
    for visit in visits:
        for uu, ii, rr, ww in zip(*(a[visit] for a in (uf, if_, rf, wf))):
            pu, pi = bu[uu], bi[ii]
            err = (rr - (mu + pu + pi)) * ww
            bu += np.bincount(uu, lr * (err - reg * ww * pu), nu)
            bi += np.bincount(ii, lr * (err - reg * ww * pi), ni)
    return bu, bi


def bias_sgd_mesh_f64(model, X, y, kw, seed, world):
    """float64 numpy of the bias SGD that ``BaselineModel(mesh=)`` runs on
    ``world`` data ranks from zero biases: the host pack at
    ``round_up(batch_size, world)`` (``aggregate=False``), epoch ``e``'s
    batch order from ``seeded_generator('cpu', seed, 0, e)``, replayed whole
    by ``bias_sgd_f64`` (the ranks' column slices of a batch make up the
    batch). ``model`` gives the id encoding and the global mean. Returns
    (user, item) biases."""
    import numpy as np
    import torch

    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    u = model.user_vocab.encode(X["user_id"].to_numpy())
    i = model.item_vocab.encode(X["item_id"].to_numpy())
    data = sgd.pack_ratings(u, i, np.asarray(y, np.float32),
                            sgd.round_up(kw["batch_size"], world),
                            aggregate=False, device="cpu")
    stream = (data.user_ids.reshape(-1).long().numpy(),
              data.item_ids.reshape(-1).long().numpy(),
              data.ratings.reshape(-1).double().numpy(),
              data.weights.reshape(-1).double().numpy())
    index = np.arange(stream[0].size).reshape(data.n_batches, -1)
    visits = [index[torch.randperm(data.n_batches, generator=sgd.seeded_generator(
        "cpu", seed, 0, e)).numpy()] for e in range(kw["n_epochs"])]
    return bias_sgd_f64(stream, visits, float(model._params.global_mean),
                        kw["lr"], kw["reg"], model.n_users, model.n_items)


def update_cohort(rng, u, n_items, per_user=100):
    """1,000 users, half of them known, ``per_user`` unique seeded items
    each: the ``update_users`` frame and its ratings."""
    import numpy as np
    import pandas as pd

    known = rng.choice(np.unique(u), 500, replace=False)
    new = np.arange(500) + 10_000_000
    uu = np.repeat(np.concatenate([known, new]), per_user)
    ii = rng.integers(0, n_items, len(uu))
    pairs = np.unique(uu.astype(np.int64) * n_items + ii)
    X = pd.DataFrame({"user_id": pairs // n_items, "item_id": pairs % n_items})
    return X, pd.Series(np.round(rng.uniform(0.5, 5, len(X)) * 2) / 2)


def phase_baseline(torch, rng, train, held, tmpdir, seed):
    """``BaselineModel`` at config 2, by ALS and by SGD, through ``fit``
    (ALS: its train RMSE below the global mean's and not rising, the
    biases against ``bias_als_oracle``, atol 1e-5; SGD: the biases
    against ``bias_sgd_oracle``, atol 1e-5: on ratings without
    signal, as ``run_configs._gen`` makes them, SGD at lr 0.02 settles at
    its noise floor in the first epoch, so its RMSE need not fall further)
    and ``update_users`` (1,000 users, half known; item biases bitwise
    unchanged), ``predict`` (the held-out pairs against float64 numpy of
    the fitted biases, atol 1e-5), ``recommend`` and ``recommend_batch``
    (256 users), the segment-sum count zeroed just before and read just
    after; then the fit repeated (bitwise equal biases) and a checkpoint
    round trip."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import BaselineModel, load_model, save_model

    u, i, r = train
    X = pd.DataFrame({"user_id": u, "item_id": i})
    y = pd.Series(r)
    Xh = pd.DataFrame({"user_id": held[0], "item_id": held[1]})
    Xu, yu = update_cohort(rng, u, ML1M["n_items"])
    cohort = [int(x) for x in np.unique(u)[:256]]
    rmse_mean = float(np.sqrt(np.mean((r.astype(np.float64)
                                       - np.mean(r.astype(np.float64))) ** 2)))
    out = {"phase": "baseline", "n_ratings": len(r), "config": BASE,
           "global_mean_rmse": rmse_mean, "launches": {}}
    for method, kw in BASE.items():
        res = {}
        zero_launches("mf_segment_sum")
        t0 = time.perf_counter()
        model = BaselineModel(min_rating=0.5, max_rating=5.0, seed=seed,
                              **kw).fit(X, y)
        torch.cuda.synchronize()
        res["fit_seconds"] = time.perf_counter() - t0
        res["fit_launches"] = n_launches("mf_segment_sum")
        hist = model.train_rmse
        check(len(hist) == kw["n_epochs"] and np.isfinite(hist).all(),
              f"baseline {method} RMSE {hist}")
        fitted = (model._params.user_biases.clone(),
                  model._params.item_biases.clone())
        t0 = time.perf_counter()
        if method == "als":
            # exact from its first sweep on: below the mean, then it stalls
            check(hist[-1] <= hist[0] < rmse_mean,
                  f"baseline als RMSE {hist} against {rmse_mean}")
            bu, bi = bias_als_oracle(model, train, kw)
        else:
            bu, bi = bias_sgd_oracle(torch, model, X, y, kw, seed)
        res["oracle_seconds"] = time.perf_counter() - t0
        res["oracle_max_abs_err"] = max(
            float(np.abs(model.user_biases - bu).max()),
            float(np.abs(model.item_biases - bi).max()))
        check(res["oracle_max_abs_err"] <= 1e-5,
              f"baseline {method} off its float64 oracle by "
              f"{res['oracle_max_abs_err']}")
        items = fitted[1]
        t0 = time.perf_counter()
        model.update_users(Xu, yu)
        torch.cuda.synchronize()
        res["update_users_seconds"] = time.perf_counter() - t0
        check(torch.equal(model._params.item_biases, items),
              f"baseline {method} update_users moved the item biases")
        check(model.n_users == len(np.unique(u)) + 500,
              f"baseline {method} update_users did not add the new users")
        t0 = time.perf_counter()
        preds = np.asarray(model.predict(Xh))
        res["predict_seconds"] = time.perf_counter() - t0
        want = bias_oracle(model, held[0], held[1])
        res["predict_max_abs_err"] = float(np.abs(preds - want).max())
        check(res["predict_max_abs_err"] <= 1e-5,
              f"baseline {method} predict off float64 by "
              f"{res['predict_max_abs_err']}")
        rec = model.recommend(cohort[0], amount=10)
        batch = model.recommend_batch(cohort, amount=10)
        check(len(rec) == 10 and len(batch) == 2560
              and list(batch["item_id"][:10]) == list(rec["item_id"]),
              f"baseline {method} recommend")
        scores = bias_oracle(model, [cohort[0]] * ML1M["n_items"],
                             model.item_vocab.raw_ids)
        check(np.allclose(np.sort(scores)[::-1][:10], rec["rating_pred"],
                          atol=1e-5), f"baseline {method} recommend scores")
        res["launches"] = n_launches("mf_segment_sum")
        out["launches"][method] = n_launches("mf_segment_sum")
        check(n_launches("mf_segment_sum") > 0,
              f"baseline {method} launched no segment sum")
        res["train_rmse_first_last"] = [hist[0], hist[-1]]
        again = BaselineModel(min_rating=0.5, max_rating=5.0, seed=seed,
                              **kw).fit(X, y)
        check(torch.equal(again._params.user_biases, fitted[0])
              and torch.equal(again._params.item_biases, fitted[1]),
              f"baseline {method}: two fits differ")
        save_model(model, f"{tmpdir}/baseline_{method}")
        back = load_model(f"{tmpdir}/baseline_{method}")
        check(torch.equal(back._params.user_biases, model._params.user_biases)
              and back.predict(Xh.iloc[:100]) == model.predict(Xh.iloc[:100]),
              f"baseline {method}: the reloaded model differs")
        out[method] = res
        del model, again, back
    out["rmse_gap_als_sgd"] = abs(out["als"]["train_rmse_first_last"][1]
                                  - out["sgd"]["train_rmse_first_last"][1])
    return out


def cf_oracle(torch, model, train, pu, pi, k):
    """float64 predictions of a fitted CF model for dense pairs (pu, pi),
    both known, by the reference's neighbourhood formula
    (``tests/test_cf.py``): the top-``k`` raters by similarity, ties to the
    lower index. The rating matrix is built here from the raw ``train``
    (u, i, r) through the vocabularies and must equal the model's; the
    means over the filled matrix and the float64 similarity come from it.
    Returns (predictions from the model's f32 similarity rows, predictions
    from float64 similarity rows, the largest difference between the two
    similarities). On ratings without signal many similarities lie within
    f32 rounding of the k-th one, so the two precisions may pick different
    neighbours: only the first prediction is held to the formula."""
    import numpy as np

    u, i, r = train
    Rh = np.zeros((model.n_users, model.n_items))
    Rh[model.user_vocab.encode(np.asarray(u, dtype=object)),
       model.item_vocab.encode(np.asarray(i, dtype=object))] = r
    R = torch.from_numpy(Rh).to("cuda")
    check(torch.equal(model._state.ratings, R.float()),
          f"{type(model).__name__}: the rating matrix is not the raw ratings")
    if model._mode == "item":
        R, Rh = R.T, Rh.T
        q, c = pi, pu
    else:
        q, c = pu, pi
    means = R.mean(dim=1)
    cen = R - means[:, None]
    normed = cen / cen.norm(dim=1, keepdim=True).clamp(min=1e-12)
    qt = torch.from_numpy(q).to(R.device)
    S64 = (normed[qt] @ normed.T).cpu().numpy()
    S32 = model._state.sim[qt].double().cpu().numpy()
    m = means.cpu().numpy()

    def predict(S):
        out = np.empty(len(q))
        for j, (a, b) in enumerate(zip(q, c)):
            rated = Rh[:, b] > 0
            rated[a] = False
            s, r, mm = S[j][rated], Rh[rated, b], m[rated]
            top = np.argsort(-s, kind="stable")[:k]
            s, r, mm = s[top], r[top], mm[top]
            den = np.abs(s).sum()
            out[j] = m[a] if not len(s) or den == 0 else (
                m[a] + (s * (r - mm)).sum() / den)
        return out

    return predict(S32), predict(S64), float(np.abs(S64 - S32).max())


def phase_cf(torch, rng, train):
    """``UserUserCF`` and ``ItemItemCF`` (50 neighbours) on the config-2
    ratings: ``fit`` seconds, a second fit bitwise equal, ``predict`` of
    100,000 seeded pairs (seconds), 2,000 of them against the float64
    oracle of ``cf_oracle`` (the rating matrix equal to the raw ratings,
    the similarity within 1e-4 of float64, the predictions atol 6e-3,
    ``tests/test_cf.py``'s bar), ``recommend`` for one user."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import ItemItemCF, UserUserCF

    u, i, r = train
    X = pd.DataFrame({"user_id": u, "item_id": i})
    y = pd.Series(r)
    # dense ids of users and items that have ratings (``_gen`` keeps the
    # first 1M of the sorted unique pairs: the highest user ids have none)
    pu = rng.integers(0, len(np.unique(u)), CF_PREDICT)
    pi = rng.integers(0, len(np.unique(i)), CF_PREDICT)
    out = {"phase": "cf", "n_neighbors": CF_NEIGHBOURS, "pairs": CF_PREDICT}
    for cls in (UserUserCF, ItemItemCF):
        res = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = cls(n_neighbors=CF_NEIGHBOURS, min_rating=0.5,
                    max_rating=5.0).fit(X, y)
        torch.cuda.synchronize()
        res["fit_seconds"] = time.perf_counter() - t0
        raw_u = np.asarray(model.user_vocab.raw_ids)[pu]
        raw_i = np.asarray(model.item_vocab.raw_ids)[pi]
        pairs = pd.DataFrame({"user_id": raw_u, "item_id": raw_i})
        t0 = time.perf_counter()
        preds = np.asarray(model.predict(pairs, bound_ratings=False))
        res["predict_seconds"] = time.perf_counter() - t0
        res["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
        check(np.isfinite(preds).all(), f"{cls.__name__} predict")
        want, want64, sim_err = cf_oracle(torch, model, train, pu[:CF_ORACLE],
                                          pi[:CF_ORACLE], CF_NEIGHBOURS)
        err = np.abs(preds[:CF_ORACLE] - want)
        err64 = np.abs(preds[:CF_ORACLE] - want64)
        res.update({"oracle_max_abs_err": float(err.max()),
                    "oracle_median_abs_err": float(np.median(err)),
                    "sim_max_abs_err": sim_err,
                    "f64_sim_max_abs_err": float(err64.max()),
                    "f64_sim_pairs_over_6e-3": int((err64 > 6e-3).sum())})
        check(sim_err <= 1e-4, f"{cls.__name__} similarity off float64 by "
                               f"{sim_err}")
        check(err.max() <= 6e-3, f"{cls.__name__} off the float64 oracle by "
                                 f"{err.max()}")
        rec = model.recommend(int(u[0]), amount=10)
        check(len(rec) == 10 and np.isfinite(rec["rating_pred"]).all(),
              f"{cls.__name__} recommend")
        state = model._state
        again = cls(n_neighbors=CF_NEIGHBOURS, min_rating=0.5,
                    max_rating=5.0).fit(X, y)
        check(torch.equal(again._state.sim, state.sim)
              and torch.equal(again._state.means, state.means),
              f"{cls.__name__}: two fits differ")
        res["sim_shape"] = list(state.sim.shape)
        out[cls.__name__] = res
        del model, again, state
        torch.cuda.empty_cache()
    return out


def phase_content(torch, rng, train, held, seed):
    """``ContentBasedRecommender`` on the config-2 ratings, without
    features (user means) and with 18 seeded binary genre columns: the
    profiles against float64 numpy (atol 1e-5), both ``predict_mode``s on
    the held-out pairs against float64 numpy of the fitted profiles (atol
    1e-5); the segment-sum count zeroed just before the fits and read
    just after."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import ContentBasedRecommender

    u, i, r = train
    X = pd.DataFrame({"user_id": u, "item_id": i})
    y = pd.Series(r)
    nu, ni = ML1M["n_users"], ML1M["n_items"]
    genres = np.random.default_rng(seed + 4).integers(
        0, 2, (ni, N_GENRES)).astype(np.float32)
    feats = pd.DataFrame(genres, columns=[f"g{j}" for j in range(N_GENRES)])
    feats.insert(0, "item_id", np.arange(ni))
    out = {"phase": "content", "genres": N_GENRES}
    zero_launches("mf_segment_sum")
    t0 = time.perf_counter()
    plain = ContentBasedRecommender(min_rating=0.5, max_rating=5.0).fit(X, y)
    models = {mode: ContentBasedRecommender(
        min_rating=0.5, max_rating=5.0, predict_mode=mode).fit(
            X, y, item_features=feats)
        for mode in ("profile_mean", "similarity")}
    torch.cuda.synchronize()
    out["fit_seconds"] = time.perf_counter() - t0
    out["launches"] = n_launches("mf_segment_sum")
    check(n_launches("mf_segment_sum") > 0,
          "the content fits launched no segment sum")

    m = models["profile_mean"]
    uu = m.user_vocab.encode(np.asarray(u, dtype=object))
    ii = m.item_vocab.encode(np.asarray(i, dtype=object))
    rr = r.astype(np.float64)
    n_u = np.bincount(uu, minlength=m.n_users)
    mean = np.bincount(uu, weights=rr, minlength=m.n_users) / np.maximum(n_u, 1)
    F = np.zeros((m.n_items, N_GENRES))
    enc = m.item_vocab.encode(np.arange(ni).astype(object))
    F[enc[enc >= 0]] = genres[enc >= 0]
    w = rr - 0.5
    num = np.stack([np.bincount(uu, weights=w * F[ii, g], minlength=m.n_users)
                    for g in range(N_GENRES)], axis=1)
    den = np.bincount(uu, weights=w, minlength=m.n_users)
    prof = np.where(den[:, None] > 0, num / np.maximum(den[:, None], 1e-12), 0)
    errs = {"user_mean": float(np.abs(plain._profiles.cpu().numpy()
                                      - mean).max()),
            "profiles": float(np.abs(m._profiles.cpu().numpy() - prof).max())}
    hu = m.user_vocab.encode(np.asarray(held[0], dtype=object))
    hi = m.item_vocab.encode(np.asarray(held[1], dtype=object))
    ok = (hu >= 0) & (hi >= 0)
    gm = float(np.mean(r))
    p = prof[np.maximum(hu, 0)]
    want = {"profile_mean": p.mean(axis=1)}
    f = F[np.maximum(hi, 0)]
    cos = (p * f).sum(1) / np.maximum(np.linalg.norm(p, axis=1)
                                      * np.linalg.norm(f, axis=1), 1e-12)
    want["similarity"] = 0.5 + cos * 4.5
    Xh = pd.DataFrame({"user_id": held[0], "item_id": held[1]})
    for mode, model in models.items():
        got = np.asarray(model.predict(Xh, bound_ratings=False))
        errs[mode] = float(np.abs(got - np.where(ok, want[mode], gm)).max())
    out["max_abs_err"] = errs
    check(max(errs.values()) <= 1e-5, f"content off float64 numpy: {errs}")
    check(len(m.recommend(int(u[0]), amount=10)) == 10, "content recommend")
    del plain, models, m
    torch.cuda.empty_cache()
    return out


def sweep_inputs(seed):
    """Config 1's ratings and what its sweep trains on: the 90,000
    training and 10,000 held-out ratings as frames, the ``KernelMF``
    keywords, the encoded training (u, i, r), the pack (on the card, as
    ``grid_search_kernel_mf`` packs it), the id counts and the model's
    config."""
    import pandas as pd

    from matrix_factorization_tpu_torch import KernelMF
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    c = ML100K
    u, i, r = gen_ratings(c["n_users"], c["n_items"], c["n_ratings"], seed + 3)
    n = c["n_ratings"] - c["held_out"]
    kw = dict(n_factors=c["n_factors"], batch_size=c["batch_size"],
              kernel="linear", min_rating=0.5, max_rating=5.0)
    model = KernelMF(seed=seed, **kw)
    X = pd.DataFrame({"user_id": u[:n], "item_id": i[:n]})
    y = pd.Series(r[:n])
    uu, ii, rr = model._preprocess_fit(X, y)
    return {"X": X, "y": y,
            "Xv": pd.DataFrame({"user_id": u[n:], "item_id": i[n:]}),
            "yv": pd.Series(r[n:]), "kw": kw, "raw_u0": int(u[0]),
            "rr": rr, "data": sgd.pack_ratings(uu, ii, rr, c["batch_size"],
                                               order=model.epoch_order),
            "n_users": model.n_users, "n_items": model.n_items,
            "cfg": model._cfg()}


def phase_sweep(torch, sw, seed):
    """``grid_search_kernel_mf`` at config 1 (linear, k=100, bs 4,096, 20
    epochs, the default 3 x 3 grid) on 90,000 ratings with 10,000 held
    out (``sweep_inputs``): seconds and aggregate updates/s, the step and
    apply counts zeroed just before and read just after (9 x batches x 20
    each), ``recommend`` on the winner (scorer count > 0). Then the sweep
    again through ``sweep.grid_train`` (its best candidate bitwise the
    winner's tables), its best and worst candidates against ``sgd_train``
    run alone from the same tables and batch orders (atol 1e-5), and the
    best candidate's first epoch through the kernels against the plain
    step from the same tables and order (atol 1e-5)."""
    import numpy as np

    from matrix_factorization_tpu_torch import grid_search_kernel_mf
    from matrix_factorization_tpu_torch.ops import sweep
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    c = ML100K
    n = len(sw["X"])
    out = {"phase": "sweep", "n_train": n, "held_out": c["held_out"],
           "epochs": c["epochs"], **sw["kw"]}
    zero_launches(*STEP, "mf_segment_apply", "mf_score_catalog")
    t0 = time.perf_counter()
    model, results = grid_search_kernel_mf(sw["X"], sw["y"], sw["Xv"],
                                           sw["yv"], n_epochs=c["epochs"],
                                           seed=seed, **sw["kw"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rec = model.recommend(sw["raw_u0"], amount=10)
    launches = {"sgd_step": n_launches(*STEP),
                "segment_apply": n_launches("mf_segment_apply"),
                "score_catalog": n_launches("mf_score_catalog")}
    nb = -(-n // c["batch_size"])
    k = len(results)
    out.update({"seconds": secs, "candidates": k,
                "updates_per_s": k * c["epochs"] * n / secs,
                "launches": launches, "batches": nb,
                "best": results[0], "worst": results[-1]})
    check(k == 9 and all(np.isfinite(d["val_rmse"]) for d in results),
          f"sweep results {results}")
    check(launches["sgd_step"] == launches["segment_apply"]
          == k * nb * c["epochs"], f"sweep launches {launches}")
    check(launches["score_catalog"] > 0 and len(rec) == 10,
          "the winner's recommend did not launch the scorer")

    # the same sweep through grid_train: the winner's tables, bitwise
    cfg, data, rr = model._cfg(), sw["data"], sw["rr"]
    check(cfg == dataclasses.replace(sw["cfg"], lr=model.lr, reg=model.reg)
          and (model.n_users, model.n_items) == (sw["n_users"], sw["n_items"]),
          "the sweep's model is not configured as its inputs")
    lrs = [d["lr"] for d in results]
    regs = [d["reg"] for d in results]
    t0 = time.perf_counter()
    params_k, _ = sweep.grid_train(data, model.n_users, model.n_items, cfg,
                                   c["epochs"], lrs, regs, float(rr.mean()),
                                   seed=seed)
    torch.cuda.synchronize()
    out["grid_train_seconds"] = time.perf_counter() - t0
    check(torch.equal(params_k.user_features[0], model._params.user_features)
          and torch.equal(params_k.item_features[0],
                          model._params.item_features),
          "two sweeps differ: the winner's tables are not bitwise equal")
    init = sgd.init_params(torch.Generator(device="cuda").manual_seed(seed),
                           model.n_users, model.n_items, cfg, float(rr.mean()))
    gen = sgd.seeded_generator("cpu", seed, 1)
    orders = [torch.randperm(nb, generator=gen) for _ in range(c["epochs"])]
    errs = {}
    for name, j in (("best", 0), ("worst", k - 1)):
        alone, _ = sgd.sgd_train(init, data, None, cfg, c["epochs"], lrs[j],
                                 batch_orders=orders, reg=regs[j])
        errs[name] = max(float((alone.user_features
                                - params_k.user_features[j]).abs().max()),
                         float((alone.item_features
                                - params_k.item_features[j]).abs().max()))
    out["alone_max_abs_err"] = errs
    check(max(errs.values()) <= 1e-5, f"sweep candidates off sgd_train: {errs}")

    # the best candidate's first epoch: the kernels against the plain step
    pk = clone_params(init)
    sgd.epoch(pk, data, cfg, lrs[0], order=orders[0], reg=regs[0])
    pp = clone_params(init)
    plain_epoch(pp, data, dataclasses.replace(cfg, lr=lrs[0], reg=regs[0]),
                orders[0])
    torch.cuda.synchronize()
    err = max(float((pk.user_features - pp.user_features).abs().max()),
              float((pk.item_features - pp.item_features).abs().max()))
    out["epoch_vs_plain_max_abs_err"] = err
    check(torch.allclose(pk.user_features, pp.user_features, atol=1e-5,
                         rtol=1e-5)
          and torch.allclose(pk.item_features, pp.item_features, atol=1e-5,
                             rtol=1e-5),
          f"a sweep epoch through the kernels differs from the plain epoch "
          f"by {err}")
    return out


def segsum_bound(ids_sorted, n, d):
    """(bound_ms, bound_by): ids and perm read once (8 B an entry), vals
    once (4 d B an entry), each touched row of out read and written once;
    one f32 add an entry and column at 67 TFLOP/s."""
    rows = int(ids_sorted.unique_consecutive().numel())
    nbytes = n * (8 + 4 * d) + 2 * rows * 4 * d
    tb, to = nbytes / HBM_BYTES_PER_S, n * d / PEAK_FLOPS["float32"]
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def phase_segsum_kernel_times(torch, rng, train, timer):
    """Kernel, plain (``index_add_`` of the permuted rows) and library (one
    ``index_add_`` of the unsorted stream, a float-atomic scatter the port
    never calls) times of the segment sum at the slice's shapes, by CUDA
    events around the call with the L2 flushed (``Timer.ms``, as every
    other kernel row), and their bounds."""
    import numpy as np

    from matrix_factorization_tpu_torch.ops import segment_sum as ss

    rows = []
    for name, ids, n_rows, d in segsum_cases(train, rng):
        ids_t = torch.from_numpy(np.asarray(ids, np.int32)).to("cuda")
        ids_l = ids_t.long()
        vals = torch.from_numpy(rng.standard_normal(
            (len(ids), d), dtype=np.float32)).to("cuda")
        order = ss.sorted_order(ids_t)
        out = torch.zeros((n_rows, d), device="cuda")
        b_ms, b_by = segsum_bound(order[1], len(ids), d)
        calls = {"": lambda: ss.cuda_segment_sum(out, vals, *order),
                 "plain_": lambda: ss.plain_segment_sum(out, vals, *order),
                 "library_": lambda: out.index_add_(0, ids_l, vals)}
        row = {"shape": name, "n": len(ids), "d": d, "rows": n_rows,
               "bound_ms": b_ms, "bound_by": b_by}
        for key, fn in calls.items():
            row[f"{key}ms"] = timer.ms(fn)
        rows.append(row)
        emit({"phase": "segsum_kernel_time", **row})
    return rows


# ---------------------------------------------------------------------------
# The native host library, the sparse-gram top-k CF (config 4) and EASE
# ---------------------------------------------------------------------------

# BASELINE.json config 4 (benchmarks/run_configs.py:221-286): item-item and
# user-user centered-cosine top-k CF on the config-3 ratings
CF4 = {"n_neighbors": 50, "block": 4096, "predict_pairs": 1_000_000,
       "oracle_columns": 64, "oracle_pairs": 4096}
# EASE at MovieLens-1M shape (the config-2 ratings as implicit feedback,
# the JAX model's default lam) and at the JAX package's one-rank item budget
# (16,384; the port's on a CUDA card is larger), as
# benchmarks/ease_bench.py::run_combo makes it, each pair once
EASE_ML1M = {"reg": 250.0, "users": 256, "k": 10}
EASE_BUDGET = {"n_users": 100_000, "n_items": 16_384, "per_user": 100,
               "reg": 100.0, "oracle_columns": 256}
# The int8 gram at the Million Song Dataset's width (41,140 items, 41,144
# padded; ~59 plays a user, each pair once): one chunk of the int8 path's
# 16,384 users, and a prefix of 65,536 users (four chunks)
EASE_GRAM_TIMED = {"n_items": 41_140, "per_user": 59,
                   "users": ((16_384, "chunk"), (65_536, "prefix"))}
# parallel_gram's Newton-Schulz at the budget, cut from JAX's 100 steps for
# time: in f32 its residual stalls at 5.7e-5, above the stop test's 1e-5,
# and all 100 ran in PR 16's runs (35.5 s); B is held to Schur's after it
EASE_NS_STEPS = 50


def timed(torch, fn):
    """(result, wall seconds) of ``fn()`` ending in a device synchronise."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_host_native(torch, data3, tmpdir, seed):
    """The host library's build; ``load_ratings_csv`` on a 1M-row CSV of the
    config-2 ratings, native against pandas; the config-3 SGD pack
    (``order='auto'``, bs 2,097,152) and the config-3 ALS bucket packs,
    native against numpy: every array equal, seconds for each."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch.data import loader
    from matrix_factorization_tpu_torch.ops import _build, ials
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    out = {"phase": "host_native", "threads": loader.native_threads()}
    out["build_seconds"] = _build.build(["host_loader"])
    loader.host_lib()

    (u, i, r), _ = ml1m_ratings(seed)
    path = Path(tmpdir) / "ratings.csv"
    pd.DataFrame({"userId": u, "movieId": i, "rating": r}).to_csv(path, index=False)
    loads = {}
    for backend in ("native", "pandas"):
        t0 = time.perf_counter()
        loads[backend] = loader.load_ratings_csv(path, force_backend=backend)
        out[f"csv_{backend}_seconds"] = time.perf_counter() - t0
    nat, pdl = loads["native"], loads["pandas"]
    check(nat.backend == "native" and pdl.backend == "pandas", "csv backends")
    check(all(np.array_equal(getattr(nat, f), getattr(pdl, f))
              for f in ("user_ids", "item_ids", "ratings", "user_uniques",
                        "item_uniques")), "native and pandas CSV loads differ")
    check(np.array_equal(nat.user_uniques[nat.user_ids], u)
          and np.array_equal(nat.ratings, r), "the CSV load lost ratings")
    out["csv_rows"] = len(r)

    u3, i3, r3 = data3[:3]
    bs = CONFIG3["sigmoid"]["batch_size"]
    packs = {}
    for native in (True, False):
        packs[native], out[f"pack_{'native' if native else 'numpy'}_seconds"] = timed(
            torch, lambda: sgd.pack_ratings(u3, i3, r3, bs, order="auto",
                                            device="cuda", native=native))
    fields = ("user_ids", "item_ids", "ratings", "weights", "sec_perm",
              "sec_ids_sorted")
    check(all(torch.equal(getattr(packs[True], f), getattr(packs[False], f))
              for f in fields) and packs[True].primary == packs[False].primary,
          "the native config-3 pack differs from numpy's")
    out["pack_primary"] = packs[True].primary
    packs.clear()
    torch.cuda.empty_cache()

    buckets = {}
    for native in (True, False):
        buckets[native], out[f"als_pack_{'native' if native else 'numpy'}_seconds"] = timed(
            torch, lambda: ials.group_both_sides_bucketed(
                u3, i3, r3, N_USERS, N_ITEMS, device="cuda", native=native))
    same = all(
        len(a) == len(b) and all(torch.equal(s, t) for x, y in zip(a, b)
                                 for s, t in zip(x, y))
        for a, b in zip(buckets[True], buckets[False]))
    check(same, "the native config-3 ALS packs differ from numpy's")
    out["als_chunks"] = [len(side) for side in buckets[True]]
    buckets.clear()
    torch.cuda.empty_cache()
    return out


def cosine_columns_f64(u, i, r, n_rows, n_cols, cols):
    """float64 centered cosine of columns ``cols`` against every column of
    the (n_rows, n_cols) sparse ratings (scipy.sparse), self pairs -inf:
    (len(cols), n_cols)."""
    import numpy as np
    import scipy.sparse as sp

    R = sp.csc_matrix((r.astype(np.float64), (u, i)), shape=(n_rows, n_cols))
    m = np.asarray(R.sum(axis=0)).ravel() / n_rows
    sq = np.asarray(R.multiply(R).sum(axis=0)).ravel()
    norms = np.sqrt(np.maximum(sq - n_rows * m * m, 0.0))
    G = (R.T @ R[:, cols]).toarray().T  # (len(cols), n_cols)
    C = G - n_rows * m[cols][:, None] * m[None, :]
    S = C / np.maximum(np.outer(norms[cols], norms), 1e-12)
    S[np.arange(len(cols)), cols] = -np.inf
    return S


def hold_topk(sims, ids, S, tol):
    """(max |value error|, ids checked, ids wrong) of top-k lists against
    the float64 rows ``S``: values sorted as the oracle's; an id counts
    where its oracle value is more than ``tol`` from its neighbours'."""
    import numpy as np

    k = sims.shape[1]
    order = np.argsort(-S, axis=1, kind="stable")[:, :k + 1]
    want = np.take_along_axis(S, order, axis=1)
    err = float(np.abs(sims - want[:, :k]).max())
    gaps = np.abs(np.diff(want, axis=1)) > tol  # gap after position t
    sep = gaps[:, :k].copy()
    sep[:, 1:] &= gaps[:, :k - 1]
    checked = int(sep.sum())
    wrong = int((ids[sep] != order[:, :k][sep]).sum())
    return err, checked, wrong


def strip_split(torch, rows, cols, r, n_rows, n_cols, k, block):
    """One strip of ``similarity_topk`` timed by its parts: the host sort
    and the device windows, the accumulation (tile builds + exact f32
    GEMMs), the centered cosine with its top-k, and ``stable_topk``
    alone, with the strip count and the GEMMs' operations."""
    from matrix_factorization_tpu_torch.ops import sparse_gram as sg
    from matrix_factorization_tpu_torch.ops.scoring import stable_topk
    from matrix_factorization_tpu_torch.ops.segment_sgd import round_up

    pad = round_up(n_cols, block)
    (ub, ib, rb, counts), t_bucket = timed(
        torch, lambda: sg._bucket_by_block(rows, cols, r, n_rows, block, "cuda"))
    acc, t_acc = timed(torch, lambda: sg._strip_accumulate(
        ub, ib, rb, counts, 0, block, block, pad))
    ones = torch.ones(pad, device="cuda")
    _, t_topk = timed(torch, lambda: sg._strip_topk(
        acc, torch.arange(block, device="cuda"), ones, n_rows, ones, k, n_cols))
    del acc
    x = torch.rand((block, pad), device="cuda")
    _, t_sort = timed(torch, lambda: stable_topk(x, k))
    del x, ub, ib, rb
    torch.cuda.empty_cache()
    n_strips = -(-n_cols // block)
    flops = 2.0 * block * block * pad * int((counts > 0).sum())
    return {"strips": n_strips, "bucket_seconds": t_bucket,
            "accumulate_seconds_per_strip": t_acc,
            "topk_seconds_per_strip": t_topk, "sort_seconds_per_strip": t_sort,
            "accumulate_tflops": flops / t_acc / 1e12,
            "accumulate_seconds": t_acc * n_strips,
            "topk_seconds": t_topk * n_strips}


def phase_cf_topk(torch, rng, data3):
    """``TopKItemItemCF`` at BASELINE config 4 (162,000 x 59,392, the 25M
    config-3 ratings, 50 neighbours): ``fit`` seconds and peak memory, one
    strip split into its parts, a bulk ``predict`` of 1M seeded pairs, 64
    sampled columns against a float64 scipy.sparse centered cosine (values
    within 1e-5, ids where separated by more than 1e-5), 4,096 predictions
    against a float64 replay of the formula on the fitted lists (1e-4);
    then user-user ``similarity_topk(i, u, r, ...)`` once, timed, and its
    strip split. Returns (out, the item-item neighbour lists (sims, ids)
    as host tensors)."""
    import numpy as np
    import pandas as pd
    import scipy.sparse as sp

    from matrix_factorization_tpu_torch import TopKItemItemCF
    from matrix_factorization_tpu_torch.ops import sparse_gram as sg

    u, i, r = data3[:3]
    k = CF4["n_neighbors"]
    out = {"phase": "cf_topk", "n_users": N_USERS, "n_items": N_ITEMS,
           "n_ratings": len(r), "n_neighbors": k}
    X = pd.DataFrame({"user_id": u, "item_id": i})
    torch.cuda.reset_peak_memory_stats()
    model, out["item_fit_seconds"] = timed(torch, lambda: TopKItemItemCF(
        n_neighbors=k, min_rating=0.5, max_rating=5.0).fit(X, pd.Series(r)))
    out["item_fit_peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    del X
    # dense ids; users without ratings (the top of config 3's id range, as
    # ``_gen`` keeps the lowest of the sorted unique pairs) are not in them
    n_u, n_i = model.n_users, model.n_items
    out["users_rated"] = n_u
    ud = model.user_vocab.encode(u)
    idd = model.item_vocab.encode(i)
    out["item_split"] = strip_split(torch, ud, idd, r, n_u, n_i, k, CF4["block"])

    n = CF4["predict_pairs"]
    qu = rng.integers(0, n_u, n).astype(np.int32)
    qi = rng.integers(0, n_i, n).astype(np.int32)
    model._predict_arrays(qu[:1024], qi[:1024], True)
    (preds, possible), dt = timed(torch, lambda: model._predict_arrays(qu, qi, True))
    check(np.isfinite(preds).all() and possible.all(), "config-4 bulk predict")
    out.update({"predict_pairs": n, "predict_seconds": dt,
                "predict_pairs_per_s": n / dt})

    lists = (model._neighbor_sims.cpu(), model._neighbor_ids.cpu())
    sims, ids = lists[0].numpy(), lists[1].numpy()
    cols = np.sort(rng.choice(n_i, CF4["oracle_columns"], replace=False))
    S = cosine_columns_f64(ud, idd, r, n_u, n_i, cols)
    err, checked, wrong = hold_topk(sims[cols], ids[cols], S, 1e-5)
    out.update({"columns_max_abs_err": err, "columns_ids_checked": checked,
                "columns_ids_wrong": wrong})
    check(err <= 1e-5, f"config-4 top-k values off float64 by {err}")
    check(wrong == 0 and checked > 0, f"config-4 top-k ids: {wrong} of "
                                      f"{checked} separated ids differ")

    m = CF4["oracle_pairs"]
    R = sp.csr_matrix((r.astype(np.float64), (ud, idd)), shape=(n_u, n_i))
    means = model._means.cpu().numpy().astype(np.float64)
    nb = ids[qi[:m]]
    s = sims[qi[:m]].astype(np.float64)
    rated = np.asarray(R[np.repeat(qu[:m], k), nb.ravel()]).reshape(m, k)
    found = rated > 0
    num = np.where(found, s * (rated - means[nb]), 0.0).sum(1)
    den = np.where(found, np.abs(s), 0.0).sum(1)
    base = means[qi[:m]]
    want = np.clip(np.where(den > 0, base + num / np.maximum(den, 1e-12), base),
                   0.5, 5.0)
    perr = float(np.abs(preds[:m] - want).max())
    out.update({"predict_max_abs_err": perr, "predict_neighbours_found": int(found.sum())})
    check(perr <= 1e-4, f"config-4 predictions off the float64 replay by {perr}")
    del model, R, S
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    (usims, uids, _, _), out["user_seconds"] = timed(
        torch, lambda: sg.similarity_topk(i, u, r, N_ITEMS, N_USERS, k=k,
                                          device="cuda"))
    out["user_peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    check(usims.shape == (N_USERS, k) and np.isfinite(usims).all()
          and (uids >= 0).all() and (uids < N_USERS).all(), "user-user top-k")
    ucols = np.sort(rng.choice(N_USERS, 16, replace=False))
    uerr, uchecked, uwrong = hold_topk(
        usims[ucols], uids[ucols], cosine_columns_f64(i, u, r, N_ITEMS, N_USERS, ucols),
        1e-5)
    out.update({"user_columns_max_abs_err": uerr, "user_columns_ids_checked": uchecked,
                "user_columns_ids_wrong": uwrong})
    check(uerr <= 1e-5 and uwrong == 0, f"user-user top-k off float64: {uerr}, "
                                        f"{uwrong} ids")
    out["user_split"] = strip_split(torch, i, u, r, N_ITEMS, N_USERS, k, CF4["block"])
    return out, lists


class LeafRecorder:
    """Wraps ``cuda_spd.gj_inverse`` (the leaf the Schur recursion calls)
    to keep every input it is handed, by leaf width, for holding the
    kernel to its plain version and timing it at the path's own inputs;
    the launches are counted by the wrapper."""

    def __init__(self):
        from matrix_factorization_tpu_torch.ops import cuda_spd

        self.cuda_spd = cuda_spd
        self.inputs = {}

    def __enter__(self):
        self.orig = self.cuda_spd.gj_inverse

        def record(A):
            self.inputs.setdefault(A.shape[-1], []).append(A.clone())
            return self.orig(A)

        self.cuda_spd.gj_inverse = record
        return self

    def __exit__(self, *exc):
        self.cuda_spd.gj_inverse = self.orig


def ease_f64(u, i, n_users, n_items, lam):
    """float64 dense EASE: (X, B) with B = -P / diag(P), zero diagonal."""
    import numpy as np

    X = np.zeros((n_users, n_items))
    X[u, i] = 1.0
    P = np.linalg.inv(X.T @ X + lam * np.eye(n_items))
    B = -P / np.diag(P)[None, :]
    np.fill_diagonal(B, 0.0)
    return X, B


def phase_ease(torch, rng, train, tmpdir, seed):
    """EASE at MovieLens-1M shape (the config-2 ratings as implicit
    feedback, lam 250): ``fit`` with the GJ count zeroed just before and
    read just after, ``B`` against float64 numpy EASE (atol 1e-4), the
    top-10 of 256 users against the float64 top-10 where separated by
    more than 1e-5, a checkpoint round trip; then at the JAX package's
    one-rank budget (16,384 items, 100,000 users x 100 distinct
    interactions) ``item_gram`` and ``ease_weights`` timed apart with peak
    memory, held by the closed form's identity ``(G + lam I)(I - B) =
    diag(1 / diag P)`` on 256 columns. Both grams are binary with no
    repeated pair, so both take the int8 gram: its tile-kernel count is
    zeroed before each and must rise. Returns (out, GJ launches, the int8
    gram's launches, the recorded leaf inputs)."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import EASE, load_model, save_model
    from matrix_factorization_tpu_torch.ops import ease as ease_ops
    from matrix_factorization_tpu_torch.ops.spd import exact_f32

    u, i, r = train
    lam = EASE_ML1M["reg"]
    out = {"phase": "ease", "ml1m": {"n_users": ML1M["n_users"],
                                     "n_items": ML1M["n_items"], "reg": lam}}
    res = out["ml1m"]
    X = pd.DataFrame({"user_id": u, "item_id": i})
    torch.cuda.reset_peak_memory_stats()
    zero_launches("mf_gj_inverse", "mf_ease_gram_tiles")
    with LeafRecorder() as rec_ml1m:
        model, res["fit_seconds"] = timed(
            torch, lambda: EASE(reg=lam).fit(X, pd.Series(r)))
    launches = {"ml1m": n_launches("mf_gj_inverse")}
    gram_launches = {"ml1m": n_launches("mf_ease_gram_tiles")}
    check(launches["ml1m"] > 0, "EASE fit did not launch the GJ leaf")
    check(gram_launches["ml1m"] > 0, "EASE fit did not take the int8 gram")
    res["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    res["leaf_d"] = sorted(rec_ml1m.inputs)
    ud = model.user_vocab.encode(u)
    idd = model.item_vocab.encode(i)
    Xd, B_ref = ease_f64(ud, idd, model.n_users, model.n_items, lam)
    n_i = model.n_items
    B = model._params.item_weights.cpu().numpy()
    res["B_max_abs_err"] = float(np.abs(B[:n_i, :n_i] - B_ref).max())
    check(res["B_max_abs_err"] <= 1e-4, f"EASE B off float64 by {res['B_max_abs_err']}")
    users = np.sort(rng.choice(model.n_users, EASE_ML1M["users"], replace=False))
    vals, idx = model._catalog_topk(users, EASE_ML1M["k"])
    S = Xd[users] @ B_ref
    err, checked, wrong = hold_topk(vals, idx, S, 1e-5)
    res.update({"top10_max_abs_err": err, "top10_ids_checked": checked,
                "top10_ids_wrong": wrong})
    check(err <= 1e-4 and wrong == 0 and checked > 0,
          f"EASE top-10 off float64: {err}, {wrong} of {checked} ids")
    save_model(model, f"{tmpdir}/ease")
    back = load_model(f"{tmpdir}/ease")
    raw = list(model.user_vocab.raw_ids[:8])
    check(torch.equal(back._params.item_weights, model._params.item_weights)
          and back.recommend_batch(raw, amount=10).equals(
              model.recommend_batch(raw, amount=10)),
          "the reloaded EASE model differs")
    del model, back, Xd, B_ref
    torch.cuda.empty_cache()

    cfg = EASE_BUDGET
    res = out["budget"] = dict(cfg)
    bu, bi, w, gen = ease_budget_data(seed)
    res["pairs"] = len(bu)
    torch.cuda.reset_peak_memory_stats()
    zero_launches("mf_ease_gram_tiles")
    G, res["gram_seconds"] = timed(torch, lambda: ease_ops.item_gram(
        bu, bi, w, cfg["n_users"], cfg["n_items"], device="cuda"))
    gram_launches["at_16384"] = n_launches("mf_ease_gram_tiles")
    check(gram_launches["at_16384"] > 0, "EASE at 16k did not take the int8 gram")
    res["gram_peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    zero_launches("mf_gj_inverse")
    with LeafRecorder() as rec_budget:
        Bt, res["inverse_seconds"] = timed(
            torch, lambda: ease_ops.ease_weights(G, cfg["reg"]))
    launches["budget"] = n_launches("mf_gj_inverse")
    check(launches["budget"] > 0, "EASE at the budget did not launch the GJ leaf")
    res["inverse_peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    res["leaf_d"] = sorted(rec_budget.inputs)
    check(bool(torch.isfinite(Bt).all()) and not Bt.diagonal().any(), "EASE B at 16k")
    cols = torch.from_numpy(np.sort(gen.choice(cfg["n_items"], cfg["oracle_columns"],
                                               replace=False))).to("cuda")
    A = G.clone()
    A.diagonal().add_(cfg["reg"])
    IB = -Bt[:, cols]
    IB[cols, torch.arange(len(cols), device="cuda")] += 1.0
    with exact_f32():
        M = A @ IB  # = diag(1 / diag P) on the sampled columns
    diag = M[cols, torch.arange(len(cols), device="cuda")].clone()
    M[cols, torch.arange(len(cols), device="cuda")] = 0.0
    res["identity_rel_err"] = float(M.abs().max() / diag.abs().min())
    check(res["identity_rel_err"] <= 1e-3 and bool((diag > 0).all()),
          f"EASE at 16k: (G + lam I)(I - B) off diagonal by {res['identity_rel_err']}")
    del G, Bt, A, IB, M
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["gram_launches"] = gram_launches
    leaves = {"ease_ml1m": rec_ml1m.inputs, "ease_budget": rec_budget.inputs}
    return out, launches, gram_launches, leaves


def unique_plays(gen, n_users, n_items, per_user, skew=1.0):
    """(users, items) int64 of ``per_user`` seeded draws a user, each
    (user, item) pair once (repeats dropped, so a user keeps a few less);
    ``skew`` > 1 draws low item ids more often."""
    import numpy as np

    u = np.repeat(np.arange(n_users, dtype=np.int64), per_user)
    i = (n_items * gen.random(len(u)) ** skew).astype(np.int64)
    key = np.unique(u * n_items + i)
    return key // n_items, key % n_items


def library_int8_gram(torch, pack):
    """``cuda_gram.int8_gram``'s steps with the library's product in place
    of the tile kernel: each chunk's slab by the plain version, the whole
    ``Dt Dt^T`` by ``torch._int_mm`` (cuBLASLt's int8 GEMM) into a scratch
    int32 matrix added to the int32 gram, then the gram as f32."""
    from matrix_factorization_tpu_torch.ops import cuda_gram

    n, rows = pack.ip, cuda_gram.slab_rows(pack.ip)
    G = torch.zeros((n, n), dtype=torch.int32, device="cuda")
    prod = torch.empty((rows, rows), dtype=torch.int32, device="cuda")
    for s, e in zip(pack.bounds[:-1], pack.bounds[1:]):
        Dt = cuda_gram.plain_slab(pack.lu[s:e], pack.ii[s:e], pack.ww[s:e], rows,
                                  pack.cu)
        torch._int_mm(Dt, Dt.T, out=prod)
        G.add_(prod[:n, :n])
    return G.float()


def phase_ease_gram_kernel_time(torch, timer, seed):
    """The int8 gram (``ops/cuda_gram.py``, ``csrc/ease_gram.cu``) at the
    Million Song Dataset's width, ``EASE_GRAM_TIMED``: for one chunk of
    16,384 users and a 65,536-user prefix, ``gram_scan`` of the int8 pack
    equal bit for bit to ``gram_scan`` of the exact-f32 pack of the same
    pairs and to :func:`library_int8_gram`; then device times of the three
    (``ms``, ``plain_ms`` the f32 scan, ``library_ms``), beside the int8
    bound (the symmetric half of the slab product at 1,979 TOP/s, or its
    bytes at HBM's rate); and on the chunk's slab the tile kernel alone
    (``tile_ms``) against ``torch._int_mm`` with its add into the int32
    gram (``int_mm_ms``). Returns (rows, tile-kernel launches)."""
    import numpy as np

    from matrix_factorization_tpu_torch.ops import cuda_gram
    from matrix_factorization_tpu_torch.ops import ease as ease_ops

    cfg = EASE_GRAM_TIMED
    n_items = cfg["n_items"]
    gen = np.random.default_rng(seed)
    n_max = max(n for n, _ in cfg["users"])
    u_all, i_all = unique_plays(gen, n_max, n_items, cfg["per_user"], skew=2.0)
    zero_launches("mf_ease_gram_tiles")
    rows_out = []
    for n_users, name in cfg["users"]:
        keep = u_all < n_users
        u, i = u_all[keep], i_all[keep]
        w = np.ones(len(u), np.float32)
        p8 = ease_ops.gram_pack(u, i, w, n_users, n_items, device="cuda")
        check(p8.tiles is not None, f"the int8 gram's pack at {name} took the f32 path")
        lu, ii, ww, bounds = ease_ops._gram_chunks(u, i, w, n_users, 2048)
        pf = ease_ops.GramPack(*(torch.from_numpy(x).cuda() for x in (lu, ii, ww)),
                               tuple(int(b) for b in bounds), p8.ip, 2048, None)
        Gf = ease_ops.gram_scan(pf)
        equal = torch.equal(ease_ops.gram_scan(p8), Gf)
        check(equal and torch.equal(library_int8_gram(torch, p8), Gf),
              f"the int8 gram at {name} ({n_users} users x {n_items} items) "
              f"differs from the exact-f32 scan or the library's product")
        del Gf
        torch.cuda.empty_cache()
        t_ops = n_users * n_items * (n_items + 1.0) / INT8_OPS_PER_S
        t_bytes = (n_users * n_items + 4.0 * n_items * n_items) / HBM_BYTES_PER_S
        big = n_users > cfg["users"][0][0]
        row = {"shape": name, "users": n_users, "n_items": n_items, "ip": p8.ip,
               "pairs": len(u), "chunks": len(p8.bounds) - 1, "equal": equal,
               "ms": timer.ms(lambda: ease_ops.gram_scan(p8), reps=5 if big else 10),
               "plain_ms": timer.ms(lambda: ease_ops.gram_scan(pf), reps=2,
                                    warmup=1),
               "library_ms": timer.ms(lambda: library_int8_gram(torch, p8),
                                      reps=5 if big else 10),
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "ops" if t_ops >= t_bytes else "bytes"}
        if not big:
            # the tile kernel raw: timed alone and outside the launch count
            run_tiles, cu = cuda_gram.LIB.fn("mf_ease_gram_tiles"), p8.cu
            rows = cuda_gram.slab_rows(p8.ip)
            Dt = cuda_gram.plain_slab(p8.lu, p8.ii, p8.ww, rows, cu)
            G = torch.zeros((p8.ip, p8.ip), dtype=torch.int32, device="cuda")
            prod = torch.empty((rows, rows), dtype=torch.int32, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def tiles():
                rc = run_tiles(Dt.data_ptr(), cu, cu // cuda_gram.K_TILE,
                               p8.tiles.data_ptr(), p8.tiles.shape[0], G.data_ptr(),
                               p8.ip, stream)
                check(rc == 0, f"mf_ease_gram_tiles returned {rc}")

            def int_mm():
                torch._int_mm(Dt, Dt.T, out=prod)
                G.add_(prod[:p8.ip, :p8.ip])

            row["tile_ms"] = timer.ms(tiles)
            row["int_mm_ms"] = timer.ms(int_mm)
            del Dt, G, prod
        row["roofline"] = row["bound_ms"] / row["ms"]
        rows_out.append(row)
        emit({"phase": "ease_gram_kernel_time", **row})
        del p8, pf
        torch.cuda.empty_cache()
    return rows_out, n_launches("mf_ease_gram_tiles")


def phase_ease_leaf_times(torch, leaves, timer):
    """The GJ leaf at every input EASE's Schur recursion handed it: the
    kernel against its plain version (atol = rtol = 1e-4, as compare_spd)
    and both against the float64 inverse; then the kernel, plain and
    library (``torch.linalg.inv``) times and bounds on the first input
    of each width. Returns (rows, the largest kernel-vs-plain error)."""
    from matrix_factorization_tpu_torch.ops import cuda_spd

    rows, worst = [], 0.0
    for path, inputs in leaves.items():
        for d, batch in sorted(inputs.items()):
            err = eye_err = plain_eye_err = vs_f64 = 0.0
            for n, A in enumerate(batch):
                got = cuda_spd.cuda_gj_inverse(A)
                want = cuda_spd.plain_gj_inverse(A)
                A64 = A.double()
                eye = torch.eye(d, dtype=torch.float64, device="cuda")
                e = float((got - want).abs().max())
                ok = bool(torch.isfinite(got).all()) and torch.allclose(
                    got, want, atol=1e-4, rtol=1e-4)
                check(ok, f"EASE leaf {path} d={d} #{n}: kernel differs from "
                          f"plain by {e}")
                err = max(err, e)
                eye_err = max(eye_err, float((A64 @ got.double() - eye).abs().max()))
                plain_eye_err = max(plain_eye_err,
                                    float((A64 @ want.double() - eye).abs().max()))
                vs_f64 = max(vs_f64, float(
                    (got.double() - torch.linalg.inv(A64)).abs().max()))
            check(eye_err < 5e-3 and plain_eye_err < 5e-3,
                  f"EASE leaf {path} d={d}: |A X - I| too large "
                  f"({eye_err}, plain {plain_eye_err})")
            A = batch[0]
            E = A.shape[0]
            b_ms, b_by = spd_bound(E, d)
            row = {"path": path, "E": E, "d": d, "leaves": len(batch),
                   "max_abs_err": err, "kernel_eye_err": eye_err,
                   "plain_eye_err": plain_eye_err, "kernel_vs_f64": vs_f64,
                   "ms": timer.ms(lambda: cuda_spd.cuda_gj_inverse(A)),
                   "plain_ms": timer.ms(lambda: cuda_spd.plain_gj_inverse(A)),
                   "library_ms": timer.ms(lambda: torch.linalg.inv(A)),
                   "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            emit({"phase": "spd_kernel_time", **row})
            worst = max(worst, err)
    return rows, worst


# ---------------------------------------------------------------------------
# The remaining model families: BPR, SVD++, NMF (every training scatter on
# the segment-sum kernels, serving on the scorer) and Popularity
# ---------------------------------------------------------------------------

# The MovieLens-25M shape the JAX package benches these families at
# (benchmarks/bpr_bench.py:146-151, nmf_bench.py:81-86,
# svdpp_bench.py:171-176): k = 64 (Kp 128), bs 1,048,576; 3 epochs here, on
# the config-3 ratings; each family's lr and reg as its bench sets them
# (BPR: its model's defaults, as bpr_bench)
FAM = {"n_factors": 64, "batch_size": 1_048_576, "epochs": 3}
FAM_KW = {"BPR": {},
          "SVDpp": {"lr": 0.005, "reg": 0.02, "min_rating": 0.5,
                    "max_rating": 5.0},
          "NMF": {"reg": 0.05, "min_rating": 0.5, "max_rating": 5.0}}
FAM_TOL = {"BPR": 1e-4, "SVDpp": 2e-4, "NMF": 1e-4}  # one epoch, kernel vs plain


def plain_scatters(fn):
    """``fn()`` with ``cuda_sgd.sgd_step``, ``segment_sum.segment_apply`` and
    ``segment_sum.segment_sum`` routed to their plain versions (gathers and
    ``index_add_``) for the call: the trainers reach them through those
    names."""
    from matrix_factorization_tpu_torch.ops import cuda_sgd
    from matrix_factorization_tpu_torch.ops import segment_sum as ss

    saved = cuda_sgd.sgd_step, ss.segment_apply, ss.segment_sum
    cuda_sgd.sgd_step = cuda_sgd.plain_sgd_step
    ss.segment_apply = ss.plain_segment_apply
    ss.segment_sum = lambda out, *a: (ss.plain_segment_sum(out, *a), out)[1]
    try:
        return fn()
    finally:
        cuda_sgd.sgd_step, ss.segment_apply, ss.segment_sum = saved


def family_epoch_fn(torch, family, pack, seed, n_users, n_items, ids):
    """(run, tables): ``run(n_epochs, draws)`` trains ``family`` on ``pack``
    from seeded tables and returns its output tables; ``draws`` True hands
    in one batch order and negatives made once from ``seed`` (the same
    every call), False draws them from a seeded generator. ``ids`` is the
    (users, items) of the ratings, for the counts and weights."""
    import numpy as np

    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import bpr, nmf, svdpp
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    kw = FAM_KW[family]
    cfg = SGDConfig(kernel="linear", n_factors=FAM["n_factors"],
                    lr=kw.get("lr", 0.05), reg=kw.get("reg", 0.002),
                    min_rating=0.5, max_rating=5.0,
                    compute_epoch_rmse=False)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    order = [rng.permutation(pack.n_batches)]
    if family == "NMF":
        p0 = nmf.init_nmf_params(gen, n_users, n_items, cfg)
        cnt = [torch.from_numpy(np.bincount(ids_, minlength=t.shape[0]).astype(
            np.float32)).cuda() for ids_, t in ((ids[0], p0.user_features),
                                                (ids[1], p0.item_features))]

        def run(n_epochs, draws):
            out, _ = nmf.nmf_train(p0, pack, *cnt, cfg, n_epochs, cfg.reg,
                                   cfg.reg)
            return out.user_features, out.item_features
        return run, cfg
    if family == "BPR":
        p0 = sgd.init_params(gen, n_users, n_items, cfg, 0.0)
        negs = [torch.randint(0, n_items, (pack.n_batches, pack.batch_size),
                              generator=gen, device="cuda", dtype=torch.int32)]

        def run(n_epochs, draws):
            out, hist = bpr.bpr_train_tiled(
                p0, pack, sgd.seeded_generator("cuda", seed, 9), cfg, n_epochs,
                0.05, n_items, batch_orders=order if draws else None,
                negatives=negs if draws else None)
            return out.user_features, out.item_features
        return run, cfg
    p0 = svdpp.init_params(gen, n_users, n_items, cfg, 2.75)
    Y = torch.zeros_like(p0.implicit_features)
    Y[:, :cfg.n_factors] = 0.05 * torch.randn(
        (Y.shape[0], cfg.n_factors), generator=gen, device="cuda")
    p0 = p0._replace(implicit_features=Y)
    wvec = torch.from_numpy(svdpp._neighbor_weights(
        ids[0], n_users, p0.user_features.shape[0])).cuda()
    deg = torch.from_numpy(np.bincount(ids[1], minlength=Y.shape[0]).astype(
        np.float32)).cuda()

    def run(n_epochs, draws):
        out, _ = svdpp.svdpp_train_batched(
            p0, pack, wvec, deg, sgd.seeded_generator("cuda", seed, 9), cfg,
            n_epochs, cfg.lr, cfg.reg, batch_orders=order if draws else None)
        return (out.user_features, out.item_features, out.implicit_features,
                out.user_implicit_sums)
    return run, cfg


def family_serving_check(torch, model, family, held, rng, users_pool):
    """``predict`` on the held-out pairs against a float64 numpy replay of
    the served formula; ``recommend`` and a 256-user ``recommend_batch``
    launch the scorer, top-10 sets equal to the plain scorer's (rows
    without a near-tie at the cut)."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch.ops import cuda_scores
    from matrix_factorization_tpu_torch.ops.scoring import stable_topk

    out = {}
    hu, hi = held
    preds = np.asarray(model.predict(pd.DataFrame({"user_id": hu,
                                                   "item_id": hi})))
    possible = np.asarray(model.predictions_possible)
    serve = (model._cached_serving_params(model._mf_view) if family == "SVDpp"
             else model._cached_serving_params())
    ud = model.user_vocab.encode(hu)[possible]
    idd = model.item_vocab.encode(hi)[possible]
    P = serve.user_features.cpu().numpy().astype(np.float64)
    Q = serve.item_features.cpu().numpy().astype(np.float64)
    ref = float(serve.global_mean) + (P[ud] * Q[idd]).sum(1)
    if family != "BPR":
        ref = np.clip(ref, model.min_rating, model.max_rating)
    err = float(np.abs(preds[possible] - ref).max())
    check(np.isfinite(preds).all() and possible.sum() > len(hu) // 2,
          f"{family} held-out predict")
    check(err <= 1e-4, f"{family} predict differs from the float64 replay by {err}")
    if family == "NMF":
        fb = float(np.clip(model.global_mean, model.min_rating,
                           model.max_rating))
        check(bool((preds[~possible] == np.float32(fb)).all()),
              "NMF cold pairs do not predict the global mean")
    out.update(predict_max_abs_err=err, predict_possible=int(possible.sum()))
    users = [int(x) for x in rng.choice(users_pool, 256, replace=False)]
    n0 = n_launches("mf_score_catalog")
    rec = model.recommend(users[0], amount=10)
    check(n_launches("mf_score_catalog") > n0 and len(rec) == 10,
          f"{family} recommend did not launch the scorer")
    n0 = n_launches("mf_score_catalog")
    batch = model.recommend_batch(users, amount=10)
    check(n_launches("mf_score_catalog") > n0 and len(batch) == 2560,
          f"{family} recommend_batch did not launch the scorer")
    out["score_launches"] = n_launches("mf_score_catalog")
    dense = torch.as_tensor(model.user_vocab.encode(np.asarray(users)),
                            device="cuda")
    plain = cuda_scores.plain_score_catalog(
        model._cfg(), serve.global_mean, serve.user_features[dense],
        serve.item_features[:model.n_items])
    pv, pi = (t.cpu().numpy() for t in stable_topk(plain, 11))
    raw = np.asarray(model.item_vocab.raw_ids)
    compared = 0
    for row, usr in enumerate(users):
        if pv[row, 9] - pv[row, 10] >= 1e-4:
            compared += 1
            got = set(batch.item_id.iloc[10 * row:10 * row + 10])
            check(got == set(raw[pi[row, :10]]),
                  f"{family} top-10 of user {usr} differs from plain")
    check(compared >= 64, f"{family}: too few rows without a near-tie")
    out["topk_rows_compared"] = compared
    return out


def phase_family(torch, rng, family, data3, pack, pack_seconds, tmpdir, seed):
    """One family at the MovieLens-25M shape: one epoch through the kernels
    against the same epoch through the plain versions on the card (the
    kernel epoch twice, bitwise); a device epoch's updates/s on the pack
    made once; then the main path, with the apply, segment-sum and scorer
    counts zeroed just before and read just after: ``fit``,
    ``update_users`` (1,000 users, half known), ``predict``, ``recommend``
    and ``recommend_batch``; then a checkpoint round trip."""
    import numpy as np
    import pandas as pd

    import matrix_factorization_tpu_torch as mf

    u, i, r, hu, hi = data3
    out = {"phase": family.lower(), "n_ratings": len(r), **FAM,
           "pack_seconds": pack_seconds, "n_batches": pack.n_batches}
    kernel_name = "segment_sum" if family == "NMF" else "segment_apply"

    def count():
        return n_launches("mf_" + kernel_name)

    # -- one epoch, kernels against plain, from the same tables and draws --
    run, cfg = family_epoch_fn(torch, family, pack, seed, N_USERS, N_ITEMS,
                               (u, i))
    n0 = count()
    got = run(1, True)
    again = run(1, True)
    check(count() > n0, f"{family}'s epoch launched no {kernel_name}")
    plain = plain_scatters(lambda: run(1, True))
    torch.cuda.synchronize()
    err = max(float((a - c).abs().max()) for a, c in zip(got, plain))
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{family}'s kernel epoch is not bitwise repeatable")
    check(err <= FAM_TOL[family],
          f"{family}'s kernel epoch differs from plain by {err}")
    out["epoch_vs_plain_max_abs_err"] = err
    del got, again, plain

    # -- throughput: one-epoch windows on the pack made once -------------
    run(1, False)  # warm-up
    windows = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(1, False)
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - t0)
    out["epoch_seconds"] = windows
    out["updates_per_sec"] = pack.n_real / statistics.median(windows)
    del run
    torch.cuda.empty_cache()

    # -- the main path: fit, then update_users ---------------------------
    X = pd.DataFrame({"user_id": u, "item_id": i})
    y = None if family == "BPR" else pd.Series(r)
    model = getattr(mf, family)(n_factors=FAM["n_factors"],
                                n_epochs=FAM["epochs"],
                                batch_size=FAM["batch_size"], seed=seed,
                                **FAM_KW[family])
    zero_launches(*STEP, "mf_segment_apply", "mf_segment_sum", "mf_score_catalog")
    t0 = time.perf_counter()
    model.fit(X, y)
    torch.cuda.synchronize()
    out["fit_seconds"] = time.perf_counter() - t0
    fit_launches = count()
    hist = model.train_loss if family == "BPR" else model.train_rmse
    out["train_loss" if family == "BPR" else "train_rmse"] = hist
    check(len(hist) == FAM["epochs"] and np.isfinite(hist).all(),
          f"{family} history {hist}")
    if family == "NMF":
        check(all(b <= a for a, b in zip(hist, hist[1:])),
              f"NMF train RMSE rose: {hist}")
        check(float(model._params.user_features.min()) >= 0
              and float(model._params.item_features.min()) >= 0,
              "NMF factors went negative")
    else:
        check(hist[-1] < hist[0], f"{family} history not falling: {hist}")
    Xu, yu = update_cohort(rng, u, N_ITEMS)
    frozen = [model._params.item_features.clone()]
    if family == "SVDpp":
        frozen.append(model._params.implicit_features.clone())
    t0 = time.perf_counter()
    model.update_users(Xu, None if family == "BPR" else yu, n_epochs=3)
    torch.cuda.synchronize()
    out["update_users_seconds"] = time.perf_counter() - t0
    out["launches"] = count()
    out["fit_launches"] = fit_launches
    check(fit_launches > 0 and out["launches"] > fit_launches,
          f"{family}'s fit or update_users launched no {kernel_name}")
    check(torch.equal(model._params.item_features, frozen[0])
          and (family != "SVDpp"
               or torch.equal(model._params.implicit_features, frozen[1])),
          f"{family}'s update_users moved a frozen table")

    # -- serving, AUC, checkpoint ----------------------------------------
    out.update(family_serving_check(torch, model, family, (hu, hi), rng,
                                    np.unique(u)))
    if family == "BPR":
        # the config-3 ratings are uniform: a held-out pair is a random
        # item, so its AUC is at chance by construction; the trained pairs
        # are what the tables must rank above random items
        t0 = time.perf_counter()
        out["auc_held_out"] = model.auc(pd.DataFrame({"user_id": hu,
                                                      "item_id": hi}))
        out["auc_seconds"] = time.perf_counter() - t0
        k = rng.choice(len(u), N_HELD_OUT, replace=False)
        out["auc_trained_pairs"] = model.auc(pd.DataFrame(
            {"user_id": u[k], "item_id": i[k]}))
        check(0.0 <= out["auc_held_out"] <= 1.0, "BPR held-out AUC")
        check(out["auc_trained_pairs"] > 0.5,
              f"BPR AUC on trained pairs {out['auc_trained_pairs']}")
    t0 = time.perf_counter()
    mf.save_model(model, f"{tmpdir}/{family}")
    back = mf.load_model(f"{tmpdir}/{family}")
    out["checkpoint_seconds"] = time.perf_counter() - t0
    check(all(torch.equal(a, b) for a, b in zip(model._params, back._params)),
          f"{family}'s checkpoint round trip is not bitwise")
    if family == "BPR":
        check(all(np.array_equal(a, b) for a, b in zip(model._train_pairs,
                                                       back._train_pairs)),
              "BPR's training pairs did not round-trip")
    out["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    del model, back, X
    torch.cuda.empty_cache()
    return out


def phase_popularity(rng, data3, tmpdir):
    """``Popularity`` (host numpy) in 'mean' mode on the config-3 ratings:
    its statistics against ``bincount``, its scores against the damped-mean
    formula in float64, ``recommend_batch`` (user-independent lists),
    ``update_users`` and a checkpoint round trip."""
    import numpy as np
    import pandas as pd

    import matrix_factorization_tpu_torch as mf

    u, i, r, _, _ = data3
    out = {"phase": "popularity"}
    X = pd.DataFrame({"user_id": u, "item_id": i})
    t0 = time.perf_counter()
    m = mf.Popularity(score="mean", damping=10.0, min_rating=0.5,
                      max_rating=5.0).fit(X, pd.Series(r))
    out["fit_seconds"] = time.perf_counter() - t0
    idx = m.item_vocab.encode(np.arange(N_ITEMS))
    cnt = np.bincount(i, minlength=N_ITEMS).astype(np.float64)
    sums = np.bincount(i, weights=r.astype(np.float64), minlength=N_ITEMS)
    ref = (sums + 10.0 * r.astype(np.float64).mean()) / (cnt + 10.0)
    check(np.array_equal(m._item_counts[idx], cnt), "Popularity counts")
    err = float(np.abs(m.item_scores_[idx] - ref).max())
    check(err <= 1e-4, f"Popularity scores differ from float64 by {err}")
    users = [int(x) for x in rng.choice(np.unique(u), 256, replace=False)]
    t0 = time.perf_counter()
    batch = m.recommend_batch(users, amount=10)
    out["recommend_batch_seconds"] = time.perf_counter() - t0
    top = list(np.asarray(m.item_vocab.raw_ids)[
        np.argsort(-m.item_scores_, kind="stable")[:10]])
    check(len(batch) == 2560 and all(
        list(batch.item_id.iloc[10 * k:10 * k + 10]) == top
        for k in range(256)), "Popularity lists are not the catalog top-10")
    Xu, yu = update_cohort(rng, u, N_ITEMS)
    m.update_users(Xu, yu)
    check(m._item_counts.sum() == len(r) + len(Xu), "Popularity update_users")
    mf.save_model(m, f"{tmpdir}/pop")
    back = mf.load_model(f"{tmpdir}/pop")
    check(np.array_equal(back.item_scores_, m.item_scores_),
          "Popularity checkpoint round trip")
    out.update(score_max_abs_err=err, n_users=m.n_users)
    return out


def phase_family_kernel_times(torch, rng, pack, timer):
    """Kernel, plain and library (one ``index_add_`` of the rows at their
    unsorted ids, a float-atomic scatter the port never calls) times of
    the apply and the segment sum at the families' shapes, on the first
    batch of the families' user-primary pack (n = 1,048,576, Kp 128; NMF's
    accumulator 2k = 128): over the batch's user order (BPR's P, SVD++'s
    P, A and S; NMF's user side), over its secondary order (BPR's Q[i],
    SVD++'s Q and gY; NMF's item side), and over sorted uniform negatives
    (BPR's Q[j]); with their bounds."""
    import numpy as np

    from matrix_factorization_tpu_torch.ops import segment_sum as ss

    b = {"u": pack.user_ids[0], "i": pack.item_ids[0], "sp": pack.sec_perm[0],
         "ss": pack.sec_ids_sorted[0]}
    n = b["u"].numel()
    j = torch.from_numpy(rng.integers(0, N_ITEMS, n, dtype=np.int32)).cuda()
    kp = 128
    vals = torch.from_numpy(rng.standard_normal((n, kp), dtype=np.float32)).cuda()
    orders = {"user_order": (ss.identity_order(b["u"]), b["u"], N_USERS),
              "secondary_order": ((b["sp"], b["ss"]), b["i"], N_ITEMS),
              "negatives": (ss.sorted_order(j), j, N_ITEMS)}
    rows = []
    for kernel, cases in (("segment_apply", orders),
                          ("segment_sum", {k: orders[k] for k in
                                           ("user_order", "secondary_order")})):
        for name, (order, raw, n_rows) in cases.items():
            out = torch.zeros((n_rows, kp), device="cuda")
            raw_l = raw.long()
            if kernel == "segment_apply":
                fns = {"": lambda: ss.cuda_segment_apply(out, vals, *order),
                       "plain_": lambda: ss.plain_segment_apply(out, vals, *order)}
            else:
                fns = {"": lambda: ss.cuda_segment_sum(out, vals, *order),
                       "plain_": lambda: ss.plain_segment_sum(out, vals, *order)}
            # vals[t] belongs to the batch's entry t, whose id is raw[t]
            fns["library_"] = lambda: out.index_add_(0, raw_l, vals)
            b_ms, b_by = segsum_bound(order[1], n, kp)
            row = {"name": kernel, "shape": f"families_{name}", "n": n, "d": kp,
                   "rows": n_rows, "bound_ms": b_ms, "bound_by": b_by}
            for key, fn in fns.items():
                row[f"{key}ms"] = timer.ms(fn)
            rows.append(row)
            emit({"phase": "family_kernel_time", **row})
    return rows



# ---------------------------------------------------------------------------
# The recipe recommender's serving path at RecipeNLG's catalog
# ---------------------------------------------------------------------------

# RecipeNLG's full_dataset.csv (2,231,142 recipes; the reference's
# prepare_recipes_full_dataset.py), the hash_embed width (512), the TF-IDF
# index's max_features (50,000, build_tfidf_index); the model is config 3's
# KernelMF width (linear, k = 200) on the config-2 ratings, whose 3,706
# items are the first 3,706 recipes
RECIPE = {"n_items": 2_231_142, "dim": 512, "n_known": 3_706,
          "vocab": 50_000, "terms": 32, "queries": 64, "batch": 256,
          "k": 10, "candidate_k": 500, "alpha": 0.5, "vocab_block": 1_024,
          "reranker_seeds": 200, "n_factors": 200, "epochs": 3,
          "batch_size": 131_072, "lr": 0.01, "reg": 0.02}
RECIPE_WORDS = (
    "chicken breast", "rice", "tofu", "salmon", "beef", "egg", "milk",
    "peanut butter", "walnut", "lettuce", "potato", "carrot", "noodle",
    "curry paste", "cheese", "butter", "lentils", "black beans", "spinach",
    "greek yogurt", "shrimp", "flour", "soy sauce", "olive oil", "garlic",
    "onion", "tomato", "mushroom", "pork loin", "turkey", "chickpeas",
    "broccoli", "honey", "oats", "cod", "quinoa")
RECIPE_STYLE = ("smoky", "spicy", "creamy", "crispy", "light", "hearty",
                "zesty", "golden", "rustic", "quick")
RECIPE_DISH = ("bowl", "stew", "salad", "bake", "stir fry", "soup", "wrap",
               "skillet", "casserole", "curry")
RECIPE_VERB = ("grill", "bake", "boil", "steam", "fry", "simmer", "roast")


def recipe_texts(rng, n_known, n_items):
    """Seeded recipe texts in the JAX pipeline's "title / ingredients /
    directions" form: full ones for the first ``n_known``, short ones for
    the rest. Returns (texts, titles of the known recipes)."""
    import numpy as np

    W, S, D, V = RECIPE_WORDS, RECIPE_STYLE, RECIPE_DISH, RECIPE_VERB
    texts, titles = [], []
    for i in range(n_known):
        ings = rng.choice(len(W), size=int(rng.integers(3, 7)), replace=False)
        title = f"{S[rng.integers(len(S))]} {W[ings[0]]} {D[rng.integers(len(D))]} {i}"
        verb = V[rng.integers(len(V))]
        texts.append(f"title: {title}\ningredients: "
                     f"{'; '.join(W[j] for j in ings)}\ndirections: {verb} "
                     f"{int(rng.integers(5, 120))} minutes")
        titles.append(title)
    rest = n_items - n_known
    a, b = rng.integers(0, len(W), rest), rng.integers(0, len(W), rest)
    v, m = rng.integers(0, len(V), rest), rng.integers(5, 120, rest)
    texts += [f"title: recipe {i}\ningredients: {W[x]}; {W[y]}\ndirections: "
              f"{V[z]} {t} minutes" for i, x, y, z, t in
              zip(range(n_known, n_items), a.tolist(), b.tolist(), v.tolist(),
                  m.tolist())]
    return texts, titles


class HashVectorizer:
    """A TF-IDF vectorizer stand-in (this script needs no sklearn): tokens
    hashed (crc32) into ``vocab`` columns, term counts, l2-normalized CSR
    rows, as ``TfidfVectorizer.transform`` gives them."""

    def __init__(self, vocab):
        self.vocab = vocab

    def transform(self, queries):
        import re
        import zlib

        import numpy as np
        import scipy.sparse as sp

        rows, cols = [], []
        for r, q in enumerate(queries):
            for tok in re.findall(r"[a-z0-9]+", q.lower()):
                rows.append(r)
                cols.append(zlib.crc32(tok.encode()) % self.vocab)
        m = sp.csr_matrix((np.ones(len(rows)), (rows, cols)),
                          shape=(len(queries), self.vocab))
        m.sum_duplicates()
        norms = np.sqrt(np.asarray(m.multiply(m).sum(1)).ravel())
        return sp.csr_matrix(sp.diags(1.0 / np.maximum(norms, 1e-12)) @ m)


def tfidf_catalog(rng, n_items, vocab, terms):
    """A seeded l2-normalized CSR of ``n_items`` x ``vocab``, ``terms``
    distinct columns a row (an arithmetic progression from a random start:
    unique by construction, as a CSR's (row, col) pairs are)."""
    import numpy as np
    import scipy.sparse as sp

    start = rng.integers(0, vocab, n_items)
    step = rng.integers(1, vocab // terms, n_items)
    cols = (start[:, None] + step[:, None] * np.arange(terms)) % vocab
    vals = rng.uniform(0.1, 1.0, (n_items, terms)).astype(np.float32)
    vals /= np.linalg.norm(vals, axis=1, keepdims=True)
    return sp.csr_matrix(
        (vals.ravel(), cols.ravel().astype(np.int32),
         np.arange(0, n_items * terms + 1, terms, dtype=np.int64)),
        shape=(n_items, vocab))


def f64_topk_positions(s, k):
    """The top-``k`` positions of one float64 score row, by score
    descending then position ascending: ``np.partition`` finds the k-th
    score, ``np.lexsort`` orders every score at or above it (the same
    order as ``np.lexsort((np.arange(n), -s))[:k]``, without sorting the
    whole row)."""
    import numpy as np

    n = s.shape[0]
    k = min(k, n)
    t = np.partition(s, n - k)[n - k]
    cand = np.flatnonzero(s >= t)
    return cand[np.lexsort((cand, -s[cand]))][:k]


def host_f64_topk(emb, Q, k, chunk=131_072):
    """float64 scores of every item against every query, on the host, and
    each query's top-k positions (``f64_topk_positions``). Returns (scores
    (B, n), positions (B, k), seconds)."""
    import numpy as np

    t0 = time.perf_counter()
    Q64 = Q.astype(np.float64)
    S = np.empty((Q.shape[0], emb.shape[0]), np.float64)
    for lo in range(0, emb.shape[0], chunk):
        S[:, lo:lo + chunk] = Q64 @ emb[lo:lo + chunk].astype(np.float64).T
    pos = np.stack([f64_topk_positions(s, k) for s in S])
    return S, pos, time.perf_counter() - t0


def hold_search(vals, pos, S, want, tol=1e-5, tie=1e-6):
    """Device top-k against the host float64 one (``S`` (B, n)): values
    within ``tol`` of the float64 scores at both position lists; positions equal except where
    the float64 scores tie within ``tie`` (``want`` holds k + 1 positions).
    Returns the largest value error."""
    import numpy as np

    err = 0.0
    k = pos.shape[1]
    for j in range(pos.shape[0]):
        s = S[j]
        err = max(err, float(np.abs(vals[j] - s[pos[j]]).max()),
                  float(np.abs(vals[j] - s[want[j, :k]]).max()))
        gap = np.abs(np.diff(s[want[j]])) > tie
        sep = np.concatenate([[True], gap[:-1]]) & gap
        bad = np.flatnonzero((pos[j] != want[j, :k]) & sep)
        check(bad.size == 0, f"query {j}: positions {pos[j][bad]} differ from "
                             f"the float64 top-k {want[j, :k][bad]}")
    check(err < tol, f"search values off the float64 scores by {err}")
    return err


def reranker_rows(index, texts, meta, rng_seed, n_seeds):
    """Weak-supervision rows as the JAX pipeline's ``train_reranker`` makes
    them: queries from seed recipes, the seed's hit positive, three hard
    negatives from the same top-30."""
    import random

    import numpy as np

    from matrix_factorization_tpu_torch.rank.reranker import featurize, generate_queries
    from matrix_factorization_tpu_torch.retrieval import search

    rng = random.Random(rng_seed)
    X, y = [], []
    for seed_id in range(n_seeds):
        for q in generate_queries(texts[seed_id], rng):
            cand = search.search_topk_pos(
                index, search.encode_query_for_index(index, q), 30)
            hit = next((c for c in cand if c[1] == seed_id), None)
            if hit is None:
                continue
            X.append(featurize(q, texts[hit[0]], hit[2], meta.loc[str(seed_id)]))
            y.append(1)
            negs = [c for c in cand if c[1] != seed_id]
            rng.shuffle(negs)
            for p, nid, s in negs[:3]:
                X.append(featurize(q, texts[p], s, meta.loc[str(nid)]))
                y.append(0)
    return np.vstack(X), np.asarray(y, np.int32)


def http_statuses(svc, user, query):
    """One pass over the HTTP routes on 127.0.0.1:0: the statuses of
    ``tests/test_serve_checkpoint.py::test_http_api`` (and the batch and
    plan routes)."""
    import urllib.error
    import urllib.request

    from matrix_factorization_tpu_torch.serve.api import serve

    httpd = serve(svc, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def status(path, body=None):
        req = urllib.request.Request(base + path, data=None if body is None
                                     else json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, None

    try:
        got = {
            "health": status("/health"),
            "recommend": status("/recommend", {"query": query, "user_id": user,
                                               "k": 5}),
            "missing_query": status("/recommend", {}),
            "k_out_of_bounds": status("/recommend", {"query": "x", "k": 999}),
            "unknown_path": status("/nope"),
            "batch": status("/recommend_batch", {"queries": [query, "rice"],
                                                 "k": 3}),
            "plan": status("/plan", {"meals": ["午餐"], "per_meal_k": 2,
                                     "avoid": ["peanut"], "use_reranker": False}),
            "bad_plan": status("/plan", {"nope": 1}),
        }
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)
    check(not th.is_alive(), "the HTTP server thread did not stop")
    want = {"health": 200, "recommend": 200, "missing_query": 422,
            "k_out_of_bounds": 422, "unknown_path": 404, "batch": 200,
            "plan": 200, "bad_plan": 422}
    codes = {k: v[0] for k, v in got.items()}
    check(codes == want, f"HTTP statuses {codes}, want {want}")
    check(got["health"][1]["n_items"] == len(svc.index.item_ids)
          and len(got["recommend"][1]["results"]) == 5
          and len(got["batch"][1]["results"]) == 2
          and got["plan"][1]["plan"], "HTTP bodies")
    return codes


def phase_recipe_serve(torch, rng, train, tmpdir, seed, timer):
    """The recipe recommender's serving path at RecipeNLG's catalog: a
    2,231,142 x 512 dense index on the card, a KernelMF fitted there by SGD
    (the step and apply counts zeroed just before the fit and read just
    after), a reranker trained there, the service loaded from its artifacts
    (``item_index.pkl``, ``model.pkl``, ``reranker.pkl``), 64 hybrid
    ``recommend`` calls, 4 ``plan_meals``, the HTTP routes, and the batched
    TF-IDF path on a 2,231,142 x 50,000 CSR."""
    import pickle

    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import KernelMF
    from matrix_factorization_tpu_torch.core.artifacts import load_pickle
    from matrix_factorization_tpu_torch.ops import scoring
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.rank import hybrid
    from matrix_factorization_tpu_torch.rank.recipe_features import (
        contains_any, expand_avoid_terms, featurize_item_text)
    from matrix_factorization_tpu_torch.rank.reranker import (
        FEATURE_NAMES, TorchLogisticRegression, rerank_scores)
    from matrix_factorization_tpu_torch.retrieval import index as rindex
    from matrix_factorization_tpu_torch.retrieval import search, sparse_scoring
    from matrix_factorization_tpu_torch.retrieval.encode import hash_embed
    from matrix_factorization_tpu_torch.serve.planner import PlanRequest, plan_meals
    from matrix_factorization_tpu_torch.serve.service import RecommendService

    R = RECIPE
    n, dim, n_known = R["n_items"], R["dim"], R["n_known"]
    out = {"phase": "recipe_serve", "n_items": n, "dim": dim, "n_known": n_known}
    tmp = Path(tmpdir)

    # -- catalog: texts, embeddings (unit rows, hash_embed of the known) ---
    t0 = time.perf_counter()
    texts, titles = recipe_texts(rng, n_known, n)
    g = torch.Generator(device="cuda").manual_seed(seed)
    E = torch.randn((n, dim), generator=g, device="cuda")
    E /= E.norm(dim=1, keepdim=True)
    E[:n_known] = torch.from_numpy(hash_embed(texts[:n_known], dim=dim)).cuda()
    emb = E.cpu().numpy()
    del E
    meta = pd.DataFrame([featurize_item_text(t) for t in texts[:n_known]])
    rest = n - n_known
    meta = pd.concat([meta[["time_min", "protein_score", "low_calorie_score",
                            "ingredients_count"]], pd.DataFrame({
        "time_min": rng.integers(5, 120, rest).astype(float),
        "protein_score": rng.integers(0, 4, rest).astype(float),
        "low_calorie_score": rng.uniform(0, 5, rest),
        "ingredients_count": rng.integers(2, 12, rest)})], ignore_index=True)
    meta.index = [str(i) for i in range(n)]
    out["data_seconds"] = time.perf_counter() - t0

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    index = rindex.build_dense_index(list(range(n)), texts, emb, normalize=False)
    dev_emb = search.device_embeddings(index)
    torch.cuda.synchronize()
    out["index_build_seconds"] = time.perf_counter() - t0
    out["index_device_bytes"] = torch.cuda.memory_allocated() - mem0
    out["memory_allocated_bytes"] = torch.cuda.memory_allocated()
    check(out["index_device_bytes"] >= n * dim * 4, "the index is not on the card")

    # -- the model: KernelMF by SGD on the card, the counts zeroed ---------
    u, i, r = train
    X = pd.DataFrame({"user_id": u, "item_id": i})
    model = KernelMF(n_factors=R["n_factors"], kernel="linear", lr=R["lr"],
                     reg=R["reg"], batch_size=R["batch_size"], min_rating=0.5,
                     max_rating=5.0, seed=seed)
    zero_launches(*STEP, "mf_segment_apply")
    t0 = time.perf_counter()
    model.fit(X, pd.Series(r), n_epochs=R["epochs"])
    torch.cuda.synchronize()
    out["fit_seconds"] = time.perf_counter() - t0
    out["launches"] = {"sgd_step": n_launches(*STEP),
                       "segment_apply": n_launches("mf_segment_apply")}
    check(all(v > 0 for v in out["launches"].values()),
          f"the fit missed a kernel: {out['launches']}")
    hist = model.train_rmse
    out["train_rmse"] = hist
    check(len(hist) == R["epochs"] and hist[-1] < hist[0], f"train RMSE {hist}")
    out["Kp"] = int(model._params.item_features.shape[1])
    # the step and the apply against the plain step at this fit's own
    # shape (linear, Kp 256, bs 131,072), on the pack fit made: its first
    # batch and its last (which holds pads)
    cfg = model._cfg()
    pack = sgd.pack_ratings(model.user_vocab.encode(u), model.item_vocab.encode(i),
                            np.asarray(r, np.float32), cfg.batch_size,
                            order=model.epoch_order, device="cuda")
    out["compare_sgd"] = phase_compare_sgd(torch, rng, [
        (f"recipe_linear_k200_batch{b}", cfg, pack, b, model.n_users,
         model.n_items) for b in (0, pack.n_batches - 1)])
    del pack

    # -- the reranker, trained on the card ---------------------------------
    t0 = time.perf_counter()
    Xr, yr = reranker_rows(index, texts, meta, seed, R["reranker_seeds"])
    clf = TorchLogisticRegression().fit(Xr, yr)
    out["reranker_seconds"] = time.perf_counter() - t0
    out["reranker_rows"] = int(len(yr))
    out["reranker_accuracy"] = float((clf.predict(Xr) == yr).mean())
    check(np.isfinite(clf.coef_).all() and out["reranker_accuracy"] > 0.5,
          f"reranker accuracy {out['reranker_accuracy']}")

    # -- artifacts and the service ------------------------------------------
    t0 = time.perf_counter()
    rindex.save_item_index(index, tmp / "item_index.pkl")
    with (tmp / "model.pkl").open("wb") as f:
        pickle.dump(model, f)
    with (tmp / "reranker.pkl").open("wb") as f:
        pickle.dump({"model_type": "logreg", "index_type": "dense",
                     "feature_names": FEATURE_NAMES, "model": clf}, f)
    out["artifact_save_seconds"] = time.perf_counter() - t0
    out["item_index_pkl_bytes"] = (tmp / "item_index.pkl").stat().st_size
    t0 = time.perf_counter()
    svc = RecommendService.from_artifacts(tmp)
    out["service_load_seconds"] = time.perf_counter() - t0
    (tmp / "item_index.pkl").unlink()
    del index, emb, dev_emb
    index = svc.index
    svc.meta = meta
    check(svc.health() == {"status": "ok", "index_type": "dense", "n_items": n,
                           "has_model": True, "has_reranker": True},
          f"health {svc.health()}")
    check(svc.model._params.item_features.device.type == "cuda",
          "the loaded model is not on the card")
    check(isinstance(svc.reranker["model"], TorchLogisticRegression),
          "reranker type")
    cpu_model = load_pickle(tmp / "model.pkl", device="cpu")
    t0 = time.perf_counter()
    emb_dev = search.device_embeddings(index)
    torch.cuda.synchronize()
    out["index_device_copy_seconds"] = time.perf_counter() - t0

    # -- search against the host float64 top-k -------------------------------
    k = R["k"]
    Q = np.stack([search.encode_query_for_index(index, t)
                  for t in titles[:R["batch"]]])
    S, want, host_s = host_f64_topk(index.embeddings, Q, k + 1)
    out["host_f64_seconds"] = host_s
    out["host_f64_ms_per_query"] = host_s / len(Q) * 1e3
    vals = np.zeros((R["queries"], k), np.float32)
    pos = np.zeros((R["queries"], k), np.int64)
    for j in range(R["queries"]):
        rows = search.search_topk_pos(index, Q[j], k)
        pos[j] = [p for p, _, _ in rows]
        vals[j] = [s for _, _, s in rows]
    out["search_max_abs_err"] = hold_search(vals, pos, S[:R["queries"]],
                                            want[:R["queries"]])
    # the service's own depth: candidate_k rows of every query
    ck = R["candidate_k"]
    cvals = np.zeros((R["queries"], ck), np.float32)
    cpos = np.zeros((R["queries"], ck), np.int64)
    for j in range(R["queries"]):
        rows = search.search_topk_pos(index, Q[j], ck)
        cpos[j] = [p for p, _, _ in rows]
        cvals[j] = [s for _, _, s in rows]
    cwant = np.stack([f64_topk_positions(S[j], ck + 1)
                      for j in range(R["queries"])])
    out["search_candidate_k_max_abs_err"] = hold_search(
        cvals, cpos, S[:R["queries"]], cwant)
    out["search_self_hit"] = float(np.mean(pos[:, 0] == np.arange(R["queries"])))
    # the main path: each of dense_topk's row blocks past SORT_MAX_SCORES
    # launches the top-k kernel once, and nothing else in the call does
    block = max(1, search._TOPK_ELEMS // n)
    want_launches = sum(min(block, len(Q) - lo) * n > scoring.SORT_MAX_SCORES
                        for lo in range(0, len(Q), block))
    zero_launches("mf_topk_select")
    bvals, bpos = search.search_topk_batch(index, Q, k)
    out["topk_launches"] = {"recipe_search": n_launches("mf_topk_select")}
    check(n_launches("mf_topk_select") == want_launches,
          f"search_topk_batch launched the top-k kernel {n_launches("mf_topk_select")} "
          f"times, not once a row block past SORT_MAX_SCORES ({want_launches})")
    out["batch_max_abs_err"] = hold_search(bvals, bpos, S, want)
    del S

    q1 = torch.from_numpy(Q[:1]).cuda()
    qb = torch.from_numpy(Q).cuda()
    b_bytes = n * dim * 4 / HBM_BYTES_PER_S * 1e3
    out["search_ms"] = timer.ms(lambda: search.dense_topk(emb_dev, q1, k))
    out["search_bound_ms"] = max(b_bytes, 2 * n * dim / PEAK_FLOPS["float32"] * 1e3)
    out["search_batch_ms"] = timer.ms(lambda: search.dense_topk(emb_dev, qb, k),
                                      reps=10)
    out["search_batch_bound_ms"] = max(
        b_bytes, 2 * len(Q) * n * dim / PEAK_FLOPS["float32"] * 1e3)
    host = []
    for j in range(R["queries"]):
        t0 = time.perf_counter()
        search.search_topk(index, Q[j], k)
        host.append((time.perf_counter() - t0) * 1e3)
    out["search_host_p50_ms"] = float(np.percentile(host, 50))

    # -- 64 hybrid recommend calls -------------------------------------------
    users = rng.choice(np.unique(u), R["queries"], replace=False).tolist()
    lat, err = [], 0.0
    for j, user in enumerate(users):
        t0 = time.perf_counter()
        res = svc.recommend(titles[j], user_id=user, k=k,
                            candidate_k=R["candidate_k"], alpha=R["alpha"])
        lat.append((time.perf_counter() - t0) * 1e3)
        check(len(res) == k and all(x["reason"].startswith("hybrid") for x in res),
              f"recommend {j}: {res[:1]}")
        cands = search.search_topk(index, search.encode_query_for_index(
            index, titles[j]), R["candidate_k"])
        ids = [c[0] for c in cands]
        ms = hybrid.model_scores(svc.model, user, ids)
        ms_cpu = hybrid.model_scores(cpu_model, user, ids)
        check(np.any(ms != 0), f"recommend {j}: model scores are the zeros fallback")
        err = max(err, float(np.abs(ms - ms_cpu).max()))
        blended = hybrid.blend(ms, np.asarray([c[1] for c in cands], np.float32),
                               R["alpha"])
        check(np.allclose(np.sort(blended)[::-1][:k], [x["score"] for x in res],
                          atol=1e-6), f"recommend {j}: scores are not the blend")
    check(err < 1e-5, f"model scores on the card off the CPU model's by {err}")
    out["model_scores_vs_cpu"] = err
    out["recommend_p50_ms"] = float(np.percentile(lat, 50))
    out["recommend_p99_ms"] = float(np.percentile(lat, 99))

    # -- 4 meal plans with the reranker and avoid terms ----------------------
    # at the planner's default diversity penalty; the greedy never picks a
    # candidate twice in a meal, while across meals only the carried-over
    # penalty holds a repeat back (JAX's semantics), so those are counted
    plans, cross = [], 0
    t0 = time.perf_counter()
    for goal, avoid in (("增肌/高蛋白", ["milk"]), ("减脂/低卡", ["peanut"]),
                        ("控糖/低碳", ["egg"]), ("", ["beef", "pork"])):
        req = PlanRequest(goal=goal, avoid=avoid, per_meal_k=3, candidate_k=100,
                          alpha=0.3, user_id=users[0], use_reranker=True)
        rows = plan_meals(svc, req)
        terms = expand_avoid_terms(avoid, enable=True)
        check(len(rows) == 3 * len(req.meals), f"plan {goal} {avoid}: {len(rows)} rows")
        check(not any(contains_any(index.texts[x["item_id"]], terms) for x in rows),
              f"plan {goal} {avoid}: an avoided ingredient")
        for meal in req.meals:
            ids = [x["item_id"] for x in rows if x["meal"] == meal]
            check(len(ids) == len(set(ids)), f"plan {goal} {avoid}: a repeat in {meal}")
        ids = [x["item_id"] for x in rows]
        cross += len(ids) - len(set(ids))
        plans.append(len(rows))
    out["plan_seconds"] = time.perf_counter() - t0
    out["plan_rows"] = plans
    out["plan_cross_meal_repeats"] = cross
    cand = search.search_topk_pos(index, Q[0], 20)
    rr = rerank_scores(svc.reranker, titles[0],
                       [(index.texts[p], s) for p, _, s in cand],
                       {str(c[1]): meta.loc[str(c[1])] for c in cand},
                       [c[1] for c in cand])
    check(rr.shape == (20,) and np.isfinite(rr).all(), "rerank_scores")

    out["http"] = http_statuses(svc, users[0], titles[0])

    # -- the batched TF-IDF path at the catalog's size ------------------------
    t0 = time.perf_counter()
    M = tfidf_catalog(rng, n, R["vocab"], R["terms"])
    tix = rindex.TfidfItemIndex(item_ids=index.item_ids, texts=index.texts,
                                vectorizer=HashVectorizer(R["vocab"]), matrix=M)
    out["tfidf_data_seconds"] = time.perf_counter() - t0
    qs = titles[:R["queries"]]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scores = sparse_scoring.tfidf_scores_device(tix, qs, vocab_block=R["vocab_block"])
    torch.cuda.synchronize()
    out["tfidf_scores_seconds"] = time.perf_counter() - t0
    got = scores.cpu().numpy()
    del scores
    ref = np.ascontiguousarray((M @ tix.vectorizer.transform(qs).T).toarray().T)
    out["tfidf_max_abs_err"] = float(np.abs(got - ref).max())
    check(out["tfidf_max_abs_err"] < 1e-5,
          f"TF-IDF scores off scipy's by {out['tfidf_max_abs_err']}")
    tvals, tpos = sparse_scoring.tfidf_batch_topk(tix, qs, k,
                                                  vocab_block=R["vocab_block"])
    twant = np.stack([f64_topk_positions(ref[j].astype(np.float64), k + 1)
                      for j in range(len(qs))])
    hold_search(tvals, tpos, ref, twant)
    out["tfidf_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["topk_launches"]["recipe_other"] = (
        n_launches("mf_topk_select") - out["topk_launches"]["recipe_search"])
    del got, ref, M, tix
    svc.model = svc.reranker = None
    torch.cuda.empty_cache()
    return out


# the batch pipeline at MovieLens-25M (config 3's ratings) over a recipe
# catalog of the same width: the stages' argv as the JAX e2e test gives
# them, no --platform (the default device), in run_all's order with the
# dense index in the TF-IDF index's place
PIPE = {"dim": 512, "max_users": 1_000, "k": 10, "held": 200, "profiles": 64,
        "tie": 1e-5, "candidate_k": 100, "reranker_seeds": 200,
        "query": "chicken rice dinner"}
PIPE_TRAIN = ["--model", "kernel_mf", "--kernel", "sigmoid", "--factors", "200",
              "--lr", "0.01", "--reg", "0.005", "--batch-size", "2097152",
              "--epochs", "3"]
# hits for the metric check: low-rank seeded ratings (few reach the 4.0
# positive threshold, so a user's held-out items are their two highest
# rated, which a fitted model ranks near the top; chance would be 0.2% a
# slot) and a narrow sigmoid KernelMF
PIPE_SIGNAL_DATA = {"n_users": 2_000, "n_items": 1_000, "n_factors": 8,
                    "density": 0.05}
PIPE_SIGNAL = ["--model", "kernel_mf", "--kernel", "sigmoid", "--factors", "32",
               "--lr", "0.01", "--batch-size", "8192", "--epochs", "10"]
PIPE_BASELINE_KW = {"reg": 0.005, "n_epochs": 5}
SCORER_KERNELS = ("score_stream_kernel", "score_tile_kernel")


def run_cli(module, argv):
    """``module.main()`` with ``argv``, as the JAX pipeline tests drive a
    stage; returns what it printed."""
    import contextlib
    import io

    old = sys.argv
    sys.argv = [module.__name__] + argv
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            module.main()
    finally:
        sys.argv = old
    return buf.getvalue()


class Recorded:
    """Within the block, ``module.name`` is wrapped: each call's
    arguments, result and seconds are kept in ``calls`` (``keep`` of them
    at most), and ``on_result`` may replace the result."""

    def __init__(self, module, name, keep=None, on_result=None):
        self.module, self.name, self.keep = module, name, keep
        self.on_result = on_result
        self.calls, self.seconds = [], 0.0

    def __enter__(self):
        inner = self.inner = getattr(self.module, self.name)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            self.seconds += time.perf_counter() - t0
            if self.on_result is not None:
                out = self.on_result(out)
            if self.keep is None or len(self.calls) < self.keep:
                self.calls.append((args, kwargs, out))
            return out

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)
        return False


def record_recommend(model, calls):
    """``model`` with its ``recommend`` calls kept in ``calls``: (user,
    known items, recommended ids, their scores)."""
    import numpy as np

    inner = model.recommend

    def recommend(user, amount=10, items_known=None, **kw):
        out = inner(user=user, amount=amount, items_known=items_known, **kw)
        calls.append((user, list(items_known or ()), list(out["item_id"]),
                      out["rating_pred"].to_numpy(np.float64)))
        return out

    model.recommend = recommend
    return model


def f64_scores(cfg, mu, p, Q):
    """float64 scores of one user row ``p`` against the item rows ``Q``
    under the model's kernel (``ops/cuda_scores.py::plain_score_catalog``'s
    formula)."""
    import numpy as np

    dots = Q @ p
    if cfg.kernel == "linear":
        return mu + dots
    if cfg.kernel == "sigmoid":
        return cfg.a + cfg.c / (1.0 + np.exp(-(mu + dots)))
    sq = np.maximum(p @ p + (Q * Q).sum(1) - 2.0 * dots, 0.0)
    return cfg.a + cfg.c * np.exp(-cfg.gamma * sq)


def topk_metrics(ratings, calls, k):
    """precision, recall and ndcg@k of the recorded ``recommend`` calls, as
    ``eval/topk_eval.py`` defines them: a user's relevant items are the
    ones of their ``ratings`` rows that were not passed as known."""
    import numpy as np

    hist = (ratings[ratings["user_id"].isin([c[0] for c in calls])]
            .groupby("user_id")["item_id"].agg(set))
    ps, rs, ns = [], [], []
    for user, known, rec, _ in calls:
        rel = hist[user] - set(known)
        hits = np.asarray([it in rel for it in rec], np.float64)
        ps.append(hits.mean() if hits.size else 0.0)
        rs.append(hits.sum() / max(1, len(rel)))
        dcg = float(np.sum(hits / np.log2(np.arange(2, hits.size + 2))))
        n_ideal = min(k, int(hits.sum()))
        ns.append(dcg / float(np.sum(1.0 / np.log2(np.arange(2, n_ideal + 2))))
                  if n_ideal else 0.0)
    return float(np.mean(ps)), float(np.mean(rs)), float(np.mean(ns))


def hold_recommended(model, calls, n_held, tie):
    """The first ``n_held`` recorded lists against a float64 numpy top-k of
    the model's own tables with the same known items excluded (score
    descending, then item position ascending): where the 10th and 11th
    float64 scores are more than ``tie`` apart, positions equal except
    among ties within the list and scores within 1e-5 (``hold_search``).
    Returns (users held, users skipped at a tied cut, largest error)."""
    import numpy as np

    cfg, p = model._cfg(), model._params
    n_items = model.n_items
    Q = p.item_features[:n_items].double().cpu().numpy()
    mu = float(p.global_mean)
    k = len(calls[0][2])
    S, want, got_pos, got_val, skipped = [], [], [], [], 0
    for user, known, rec, vals in calls[:n_held]:
        u = int(model.user_vocab.encode(np.asarray([user], dtype=object))[0])
        s = f64_scores(cfg, mu, p.user_features[u].double().cpu().numpy(), Q)
        s[model.item_vocab.encode(np.asarray(known, dtype=object))] = -np.inf
        w = f64_topk_positions(s, k + 1)
        if s[w[k - 1]] - s[w[k]] <= tie:
            skipped += 1
            continue
        S.append(s)
        want.append(w)
        got_pos.append(model.item_vocab.encode(np.asarray(rec, dtype=object)))
        got_val.append(vals)
    check(S, "every held user's top-k cut ties")
    err = hold_search(np.stack(got_val), np.stack(got_pos), np.stack(S),
                      np.stack(want), tol=1e-5, tie=tie)
    return len(S), skipped, err


def trace_summary(trace_dir, names):
    """The Chrome trace in ``trace_dir``: its kernel events whose name holds
    one of ``names`` (count, device milliseconds), the device's busy
    milliseconds (``device_time``) and the trace's window in milliseconds
    (its first event's start to its last event's end, host or device)."""
    files = sorted(Path(trace_dir).glob("trace_*.json"))
    check(len(files) == 1, f"{len(files)} trace files in {trace_dir}")
    events = json.loads(files[0].read_text())["traceEvents"]
    ev, by_name, busy_us = device_time(events)
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("ph") == "X"]
    window_us = max(t for _, t in spans) - min(s for s, _ in spans)
    n = sum(1 for e in events if e.get("cat") == "kernel"
            and any(x in e.get("name", "") for x in names))
    ms = sum(t for x, t in by_name.items() if any(y in x for y in names))
    return {"kernels": n, "kernel_ms": ms, "device_busy_ms": busy_us / 1e3,
            "window_ms": window_us / 1e3}


def host_rss_mib():
    """(current, peak) resident set of this process, MiB: ``VmRSS`` of
    ``/proc/self/status`` and ``getrusage``'s ``ru_maxrss``."""
    import resource

    rss = None
    for line in Path("/proc/self/status").read_text().splitlines():
        key, _, val = line.partition(":")
        if key == "VmRSS":
            rss = int(val.split()[0]) / 1024
    return rss, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def pipeline_launches():
    return {"score_catalog": n_launches("mf_score_catalog"),
            "sgd_step": n_launches(*STEP),
            "segment_apply": n_launches("mf_segment_apply"),
            "segment_sum": n_launches("mf_segment_sum")}


def phase_pipeline(torch, rng, data3, tmpdir, seed):
    """The batch pipeline end to end on the card, every stage through its
    ``main()`` with no ``--platform``: config 3's 25M ratings (item ids
    written as strings) and 59,392 seeded recipe texts in, the recipe
    metadata, structured features, 512-wide embeddings and dense index, a
    config-3 sigmoid KernelMF, ``evaluate`` (traced), ``evaluate_hybrid``,
    both rerankers, ``evaluate_llm``, the app's plan, then
    ``BaselineModel`` by ALS (held to ``bias_als_oracle``) and ``evaluate``
    again; between them ``train`` and ``evaluate`` on low-rank ratings
    (from ``seed``), whose lists hit. The launch counts are zeroed
    just before the first stage and read after each."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch.core.artifacts import load_pickle
    from matrix_factorization_tpu_torch.data.synthetic import lowrank_ratings
    from matrix_factorization_tpu_torch.eval import hybrid_eval
    from matrix_factorization_tpu_torch.pipeline import (
        build_item_embeddings, build_recipe_metadata, build_structured_features,
        evaluate, evaluate_hybrid, evaluate_llm, export_artifacts, train,
        train_reranker)
    from matrix_factorization_tpu_torch.rank.reranker import (
        TorchLogisticRegression, TorchMLPReranker)
    from matrix_factorization_tpu_torch.retrieval.index import load_item_index
    from matrix_factorization_tpu_torch.serve import app
    from matrix_factorization_tpu_torch.utils.profiling import trace

    P = PIPE
    root = Path(tmpdir) / "pipeline"
    data, feats, art = root / "data", root / "features", root / "artifacts"
    data.mkdir(parents=True)
    out = {"phase": "pipeline", "n_ratings": int(len(data3[0])),
           "n_items": N_ITEMS, "dim": P["dim"]}

    # -- inputs: ratings.parquet (str item ids) and items.parquet ----------
    t0 = time.perf_counter()
    names = np.asarray([str(j) for j in range(N_ITEMS)], dtype=object)
    ratings = pd.DataFrame({"user_id": data3[0].astype(np.int64),
                            "item_id": names[data3[1]], "rating": data3[2]})
    ratings.to_parquet(data / "ratings.parquet", index=False)
    texts, _ = recipe_texts(rng, N_ITEMS, N_ITEMS)
    pd.DataFrame({"item_id": names, "text": texts}).to_parquet(
        data / "items.parquet", index=False)
    out["input_seconds"] = time.perf_counter() - t0
    n_users = int(ratings["user_id"].nunique())

    torch.cuda.reset_peak_memory_stats()
    zero_launches("mf_score_catalog", *STEP, "mf_segment_apply", "mf_segment_sum")
    seconds, launches, printed = {}, {}, {}

    def stage(name, module, argv, at=root):
        before = pipeline_launches()
        t0 = time.perf_counter()
        printed[name] = run_cli(module, ([] if at is None else ["--root", str(at)])
                                + argv)
        seconds[name] = time.perf_counter() - t0
        after = pipeline_launches()
        launches[name] = {k: after[k] - before[k] for k in after}

    def last_json(name):
        return json.loads([x for x in printed[name].splitlines()
                           if x.startswith(("{", "["))][-1])

    def evaluate_recorded(name, at, frame):
        """``evaluate`` on ``at``'s model, its ``recommend`` lists kept; the
        metrics recomputed from them (``frame``: the ratings it read) must
        equal the stage's JSON. Returns (the model, the lists, the JSON,
        ``evaluate_topk``'s seconds)."""
        recs = []
        with Recorded(evaluate, "load_pickle",
                      on_result=lambda m: record_recommend(m, recs)) as ld, \
                Recorded(evaluate, "evaluate_topk") as ev:
            stage(name, evaluate, ["--k", str(P["k"]),
                                   "--max-users", str(P["max_users"])], at=at)
        res = last_json(name)
        check(res["n_users"] == len(recs) > 0, f"{name} {res}, {len(recs)} lists")
        got = topk_metrics(frame, recs, P["k"])
        want = (res["precision"], res["recall"], res["ndcg"])
        check(np.allclose(got, want, rtol=0, atol=1e-12),
              f"{name}: metrics from the lists {got} != the stage's {want}")
        return ld.calls[0][2], recs, res, ev.seconds

    stage("build_recipe_metadata", build_recipe_metadata, [])
    meta = pd.read_parquet(feats / "recipe_meta.parquet")
    check(len(meta) == N_ITEMS and meta["item_id"].tolist() == names.tolist(),
          f"recipe_meta: {len(meta)} rows")
    stage("build_structured_features", build_structured_features, [])
    uf = pd.read_parquet(feats / "user_features.parquet")
    itf = pd.read_parquet(feats / "item_features.parquet")
    check(len(uf) == n_users and len(itf) == N_ITEMS
          and int(uf["rating_count"].sum()) == len(ratings),
          f"structured features: {len(uf)} users, {len(itf)} items")
    stage("build_item_embeddings", build_item_embeddings, ["--dim", str(P["dim"])])
    emb_df = pd.read_parquet(feats / "items_emb.parquet")
    check(emb_df.shape == (N_ITEMS, P["dim"] + 1), f"items_emb {emb_df.shape}")
    del emb_df
    stage("export_artifacts", export_artifacts, [])
    index = load_item_index(art / "item_index.pkl")
    check(len(index.item_ids) == N_ITEMS
          and index.embeddings.shape == (N_ITEMS, P["dim"]),
          f"item_index: {len(index.item_ids)} x {index.embeddings.shape}")

    # -- the config-3 KernelMF, then evaluate inside the trace ----------------
    with Recorded(train, "train_model") as fit:
        stage("train_kernel_mf", train, PIPE_TRAIN)
    out["fit_seconds"] = fit.seconds
    trace_dir = root / "trace"
    with trace(str(trace_dir)):
        before = n_launches("mf_score_catalog")
        model, recs, res, eval_seconds = evaluate_recorded("evaluate", root,
                                                           ratings)
        eval_launches = n_launches("mf_score_catalog") - before
    check(model._params.item_features.device.type == "cuda"
          and model._params.user_features.device.type == "cuda",
          "the loaded model is not on the card")
    hist = model.train_rmse
    check(len(hist) == 3 and hist[-1] < hist[0], f"train RMSE {hist}")
    out["train_rmse"] = hist
    out["evaluate"] = res
    out["evaluate_users_per_s"] = res["n_users"] / eval_seconds
    out["evaluate_topk_seconds"] = eval_seconds
    held, skipped, err = hold_recommended(model, recs, P["held"], P["tie"])
    out["evaluate_held_users"], out["evaluate_skipped_tied_cut"] = held, skipped
    out["evaluate_max_abs_err"] = err
    tr = trace_summary(trace_dir, SCORER_KERNELS)
    out["evaluate_trace"] = dict(tr, scorer_launches=eval_launches,
                                 device_busy_share=tr["device_busy_ms"] / tr["window_ms"])
    check(tr["kernels"] == eval_launches >= res["n_users"],
          f"the trace holds {tr['kernels']} scorer kernels, the counter {eval_launches}")
    del recs, model
    shutil.rmtree(trace_dir)

    # -- hits the metric check can see: config 3's draws are uniform, so its
    # top-10 lists hit nothing; low-rank ratings go through the same two
    # stages -----------------------------------------------------------------
    sig = root / "signal"
    (sig / "data").mkdir(parents=True)
    Xs, ys = lowrank_ratings(seed=seed, **PIPE_SIGNAL_DATA)
    sig_ratings = Xs.assign(item_id=Xs["item_id"].astype(str), rating=ys)
    sig_ratings.to_parquet(sig / "data" / "ratings.parquet", index=False)
    stage("train_signal", train, PIPE_SIGNAL, at=sig)
    model, recs, res, _ = evaluate_recorded("evaluate_signal", sig, sig_ratings)
    out["evaluate_signal"] = res
    check(min(res["precision"], res["recall"], res["ndcg"]) > 0,
          f"the signal run's lists hit nothing: {res}")
    out["evaluate_signal_held_users"], _, out["evaluate_signal_max_abs_err"] = (
        hold_recommended(model, recs, P["held"], P["tie"]))
    del recs, model

    # -- hybrid, rerankers, judge, app ----------------------------------------
    with Recorded(hybrid_eval, "_profile_topk", keep=1) as prof:
        stage("evaluate_hybrid", evaluate_hybrid, [
            "--alpha", "0.5", "--candidate-k", str(P["candidate_k"]),
            "--max-users", str(P["max_users"])])
    rep = last_json("evaluate_hybrid")
    out["evaluate_hybrid"] = rep
    check(len(rep) == 2 and all(v["n_users"] > 0 for v in rep.values()),
          f"evaluate_hybrid {rep}")
    args, kw, (sims, pos) = prof.calls[0]
    prof64 = np.stack(args[1][:P["profiles"]]).astype(np.float64)
    S = prof64 @ index.embeddings.astype(np.float64).T
    kk = kw["k"]
    want = np.stack([f64_topk_positions(s, kk + 1) for s in S])
    out["hybrid_profile_k"] = int(kk)
    out["hybrid_max_abs_err"] = hold_search(sims[:P["profiles"]], pos[:P["profiles"]],
                                            S, want, tol=1e-5, tie=P["tie"])
    del S, prof
    for kind, cls, extra in (("logreg", TorchLogisticRegression, []),
                             ("mlp", TorchMLPReranker, ["--model-type", "mlp"])):
        stage(f"train_reranker_{kind}", train_reranker, [
            "--n-seed-items", str(P["reranker_seeds"]), "--log-every", "0"] + extra)
        payload = load_pickle(art / "reranker.pkl")
        check(payload["model_type"] == kind and isinstance(payload["model"], cls)
              and payload["train_stats"]["n_samples"] > 0,
              f"reranker payload {kind}: {payload['train_stats']}")
        out[f"reranker_{kind}_samples"] = payload["train_stats"]["n_samples"]
    stage("evaluate_llm", evaluate_llm, [
        "--query", P["query"], "--must-include", "chicken", "--avoid", "peanut"])
    report = json.loads((art / "llm_eval_report.json").read_text())
    check(report["n_cases"] == 1, f"llm report {report['n_cases']} cases")
    out["llm"] = {k: report[k] for k in ("avg_relevance", "violation_rate",
                                         "diversity")}
    stage("app", app, ["--artifacts", str(art), "--features", str(feats),
                       "--query", P["query"], "--json"], at=None)
    rows = last_json("app")
    check(rows, "the app planned nothing")
    for meal in {r["meal"] for r in rows}:
        ids = [r["item_id"] for r in rows if r["meal"] == meal]
        check(len(ids) == len(set(ids)), f"the plan repeats an item in {meal}")
    out["app_rows"] = len(rows)

    # -- run_all's default model, then evaluate again -------------------------
    with Recorded(train, "train_model") as fit:
        stage("train_baseline", train, ["--model", "baseline", "--method", "als",
                                        "--epochs", str(PIPE_BASELINE_KW["n_epochs"]),
                                        "--reg", str(PIPE_BASELINE_KW["reg"])])
    out["baseline_fit_seconds"] = fit.seconds
    base_model = load_pickle(art / "model.pkl")
    check(base_model.train_rmse[-1] < base_model.train_rmse[0],
          f"baseline train RMSE {base_model.train_rmse}")
    # the fit's segment sums at 25M entries, held through the biases they
    # made: float64 numpy of the same closed-form sweeps, atol 1e-5
    t0 = time.perf_counter()
    bu, bi = bias_als_oracle(base_model, (ratings["user_id"], ratings["item_id"],
                                          ratings["rating"]), PIPE_BASELINE_KW)
    out["baseline_oracle_seconds"] = time.perf_counter() - t0
    err = max(float(np.abs(base_model.user_biases - bu).max()),
              float(np.abs(base_model.item_biases - bi).max()))
    out["baseline_oracle_max_abs_err"] = err
    check(err <= 1e-5, f"baseline ALS at 25M off its float64 oracle by {err}")
    del base_model, bu, bi
    with Recorded(evaluate, "evaluate_topk") as ev:
        stage("evaluate_baseline", evaluate, ["--k", str(P["k"]),
                                              "--max-users", str(P["max_users"])])
    out["evaluate_baseline"] = last_json("evaluate_baseline")
    out["evaluate_baseline_users_per_s"] = (out["evaluate_baseline"]["n_users"]
                                            / ev.seconds)

    out["seconds"] = seconds
    out["launches_by_stage"] = {k: v for k, v in launches.items() if any(v.values())}
    total = {k: sum(v[k] for v in launches.values()) for k in pipeline_launches()}
    out["launches"] = total
    check(all(v > 0 for v in total.values()), f"the pipeline missed a kernel: {total}")
    out["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["host_rss_mib"], out["host_peak_rss_mib"] = host_rss_mib()
    return out


# ---------------------------------------------------------------------------
# Multi-device KernelMF on torch.distributed
# ---------------------------------------------------------------------------

# phase (a): NCCL at world size 1, config 3 sigmoid; phase (b): gloo ranks on
# the one card at config 2's shape and config 3's width
PAR = {"epochs": 3, "gloo_bs": 65_536, "gloo_epochs": 2, "serve_users": 256,
       "k": 10, "lr": 0.01}


def table_err(a, b):
    return max(float((a.user_features - b.user_features).abs().max()),
               float((a.item_features - b.item_features).abs().max()))


def heldout_rmse(torch, params, cfg, hu, hi, hr):
    import numpy as np

    from matrix_factorization_tpu_torch.ops.segment_sgd import predict_pairs

    pred, _ = predict_pairs(params, torch.from_numpy(hu.astype(np.int64)).cuda(),
                            torch.from_numpy(hi.astype(np.int64)).cuda(), cfg,
                            True)
    return float(np.sqrt(np.mean((pred.cpu().numpy().astype(np.float64)
                                  - hr) ** 2)))


@contextlib.contextmanager
def nccl_world(torch, store_dir):
    """A ``torch.distributed`` world of this process alone on NCCL (NCCL
    refuses two ranks on one GPU), rendezvous through a ``FileStore`` in
    ``store_dir``; destroyed on exit."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{store_dir}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda:0"))
    try:
        yield
    finally:
        dist.destroy_process_group()


def phase_parallel_nccl(torch, rng, data3, held_r, seed):
    """(a) NCCL at world size 1 in this process (inside ``nccl_world``),
    config 3 sigmoid at full scale: ``dp_fit`` tiled with the item-primary pack (``'shuffle'``, the
    step's accumulator mode) and the user-primary pack, given orders, 3
    epochs (each fit's seconds and its own pack's, read through a wrapper
    of ``pack_ratings``), then ``ShardedCatalog`` serving; the counts are
    zeroed just before and read just after. Then the synchronous fits held to
    ``sgd_train`` on the same pack, tables and orders (history rtol 1e-5,
    held-out RMSE 1e-3, tables after one epoch 2e-5), ``psum_every='auto'``
    and ``overlap_psum`` (falling RMSE; one epoch held to the same trainer
    with the plain step and apply, 2e-5), updates/s beside the single-device
    trainer's, and the all-reduce's device time in a profiled epoch.
    Returns (out, the shuffle and user packs)."""
    import numpy as np

    from matrix_factorization_tpu_torch.ops import scoring
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.parallel import distributed as pdist
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh
    from matrix_factorization_tpu_torch.parallel.serving import ShardedCatalog

    u, i, r, hu, hi = data3
    bs, E = CONFIG3["sigmoid"]["batch_size"], PAR["epochs"]
    cfg = sgd_cfg("sigmoid", N_FACTORS, PAR["lr"], bs)
    out = {"phase": "parallel_nccl", "backend": "nccl", "world_size": 1,
           "n_ratings": len(r), "batch_size": bs, "epochs": E}
    mesh = make_mesh(1)
    p0 = sgd.init_params(torch.Generator(device="cuda").manual_seed(seed),
                         N_USERS, N_ITEMS, cfg, float(r.mean()),
                         user_capacity=sgd.round_up(N_USERS, 8))
    nb = -(-len(r) // bs)
    orng = np.random.default_rng(seed)
    flat_orders = [orng.permutation(nb) for _ in range(E)]
    orders = [[o] for o in flat_orders]

    # -- the main path: dp_fit, then the sharded catalog ----------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(*STEP, "mf_segment_apply", "mf_score_catalog")
    fits, pack_seconds = {}, []
    pack_ratings = sgd.pack_ratings

    def timed_pack(*a, **k):  # the fit's own pack, timed where it runs
        t = time.perf_counter()
        out_ = pack_ratings(*a, **k)
        torch.cuda.synchronize()
        pack_seconds.append(time.perf_counter() - t)
        return out_

    for order in ("shuffle", "user"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sgd.pack_ratings = timed_pack
        try:
            local, hist = pdist.dp_fit(u, i, r, N_USERS, N_ITEMS, cfg, E,
                                       cfg.lr, mesh, seed=seed,
                                       layout="tiled", pack_order=order,
                                       params=p0, orders=orders,
                                       device="cuda")
        finally:
            sgd.pack_ratings = pack_ratings
        torch.cuda.synchronize()
        fits[order] = (local, hist, time.perf_counter() - t0,
                       pack_seconds[-1])
    served = fits["shuffle"][0]
    cat = ShardedCatalog(served, N_ITEMS, cfg, mesh)
    ud = rng.choice(N_USERS, PAR["serve_users"], replace=False).astype(np.int32)
    vals, idx = cat.topk(served.user_features[torch.from_numpy(ud).cuda()],
                         PAR["k"])
    launches = {"sgd_step": n_launches(*STEP),
                "sgd_step_acc": n_launches("mf_sgd_step_acc"),
                "segment_apply": n_launches("mf_segment_apply"),
                "score_catalog": n_launches("mf_score_catalog")}
    out["launches"] = launches
    out["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    check(all(v > 0 for v in launches.values()),
          f"the parallel path missed a kernel: {launches}")
    wv, wi = scoring.catalog_topk(cfg, served, N_ITEMS, ud, PAR["k"])
    check(np.array_equal(idx, wi), "the sharded catalog's top-10 ids differ "
                                   "from recommend_batch's")
    out["serve_max_abs_err"] = float(np.abs(vals - wv).max())
    check(out["serve_max_abs_err"] <= 1e-5, "sharded catalog scores differ")

    # -- the synchronous fits against sgd_train on the same pack --------
    packs = {}
    for order in ("shuffle", "user"):
        local, hist, fit_s, pack_s = fits[order]
        pack = sgd.pack_ratings(u, i, r, bs, shuffle_seed=seed, order=order,
                                device="cuda")
        ref, href = sgd.sgd_train(p0, pack, None, cfg, E, cfg.lr,
                                  batch_orders=flat_orders)
        href = href.cpu().numpy()
        rel = float(np.max(np.abs(hist - href) / href))
        h_dp = heldout_rmse(torch, local, cfg, hu, hi, held_r)
        h_ref = heldout_rmse(torch, ref, cfg, hu, hi, held_r)
        check(rel <= 1e-5, f"dp_fit {order}: RMSE history off by {rel}")
        check(abs(h_dp - h_ref) <= 1e-3, f"dp_fit {order}: held-out RMSE "
                                         f"{h_dp} against {h_ref}")
        check(hist[-1] < hist[0], f"dp_fit {order}: RMSE not falling {hist}")
        one, _ = pdist.dp_sgd_train_tiled(pdist.place_params(p0, mesh), pack,
                                          cfg, 1, cfg.lr, mesh,
                                          orders=orders[:1])
        ref1, _ = sgd.sgd_train(p0, pack, None, cfg, 1, cfg.lr,
                                batch_orders=flat_orders[:1])
        err1 = table_err(one, ref1)
        check(err1 <= 2e-5, f"dp {order}: one epoch off by {err1}")
        out[f"sync_{order}"] = {
            "primary": pack.primary, "fit_seconds": fit_s,
            "pack_seconds": pack_s, "pack_share": pack_s / fit_s,
            "train_rmse": hist.tolist(), "single_device_rmse": href.tolist(),
            "rmse_max_rel_err": rel, "heldout_rmse": h_dp,
            "single_device_heldout_rmse": h_ref,
            "one_epoch_max_abs_err": err1}
        packs[order] = pack
        del ref, one, ref1
    del fits
    pack = packs["shuffle"]

    # -- updates/s: the dp trainer and sgd_train, one-epoch windows
    # without the RMSE pass (as the train phase times them) ------------
    fast = dataclasses.replace(cfg, compute_epoch_rmse=False)
    for tag, run in (
            ("dp", lambda: pdist.dp_sgd_train_tiled(
                pdist.place_params(p0, mesh), pack, fast, 1, cfg.lr, mesh,
                orders=orders[:1])),
            ("single_device", lambda: sgd.sgd_train(
                p0, pack, None, fast, 1, cfg.lr,
                batch_orders=flat_orders[:1]))):
        run()
        windows = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            windows.append(time.perf_counter() - t0)
        out[f"{tag}_epoch_seconds"] = windows
        out[f"{tag}_updates_per_sec"] = pack.n_real / statistics.median(windows)

    # -- the windowed and overlapped schedules ---------------------------
    for tag, kw in (("auto", {"psum_every": "auto"}),
                    ("overlap", {"overlap_psum": True})):
        p3, h3 = pdist.dp_sgd_train_tiled(pdist.place_params(p0, mesh), pack,
                                          cfg, E, cfg.lr, mesh,
                                          orders=orders, **kw)
        h3 = h3.cpu().numpy()
        check(h3[-1] < h3[0], f"{tag}: train RMSE not falling {h3}")
        k1, _ = pdist.dp_sgd_train_tiled(pdist.place_params(p0, mesh), pack,
                                         cfg, 1, cfg.lr, mesh,
                                         orders=orders[:1], **kw)
        pl1, _ = plain_scatters(lambda kw=kw: pdist.dp_sgd_train_tiled(
            pdist.place_params(p0, mesh), pack, cfg, 1, cfg.lr, mesh,
            orders=orders[:1], **kw))
        err = table_err(k1, pl1)
        check(err <= 2e-5, f"{tag}: one epoch against plain off by {err}")
        out[tag] = {"train_rmse": h3.tolist(),
                    "heldout_rmse": heldout_rmse(torch, p3, cfg, hu, hi,
                                                 held_r),
                    "epoch_vs_plain_max_abs_err": err,
                    "window": pdist._check_psum_every(kw.get("psum_every", 1),
                                                      pack.n_batches)}
        del p3, k1, pl1
        torch.cuda.empty_cache()

    # -- where a dp epoch's device time goes: the all-reduce -------------
    out["epoch_profile"] = _device_share(
        torch, lambda _: pdist.dp_sgd_train_tiled(
            pdist.place_params(p0, mesh), pack, fast, 1, cfg.lr, mesh,
            orders=orders[:1]), [0], match="nccl")
    return out, packs


def gloo_inputs(train1m, seed):
    """What every gloo rank gets: the config-2-shaped ratings, config 3's
    width, seeded whole initial tables and the 256 users to serve."""
    import numpy as np

    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    u, i, r = train1m
    cfg = sgd_cfg("sigmoid", N_FACTORS, PAR["lr"], PAR["gloo_bs"])
    rng = np.random.default_rng(seed)
    ucap = sgd.round_up(ML1M["n_users"], 8 * 2)
    P0 = ext_tables(rng, ucap, cfg, "user")
    Q0 = ext_tables(rng, sgd.round_up(ML1M["n_items"], 8), cfg, "item")
    users = rng.choice(np.unique(u), PAR["serve_users"], replace=False)
    return {"train": (u, i, r), "P0": P0, "Q0": Q0, "mu": float(r.mean()),
            "users": users, "seed": seed}


# the slice-6b models on the gloo ranks, config 2's shape: KernelMF ALS at
# config 3's width (ALS's k, reg and reg_scale), the bias models with BASE's
# arguments and NMF with FAM's, each for GLOO_6B_EPOCHS
GLOO_6B_EPOCHS = 3


def gloo_6b_models():
    """(name, class name, keyword arguments) of the slice-6b models that
    every gloo world fits on the mesh and the phase fits on one device."""
    als_kw = dict(method="als", kernel="linear", n_factors=ALS["n_factors"],
                  reg=ALS["reg"], reg_scale=ALS["reg_scale"], min_rating=0.5,
                  max_rating=5.0, n_epochs=GLOO_6B_EPOCHS)
    base = {m: dict(min_rating=0.5, max_rating=5.0,
                    **{**kw, "n_epochs": GLOO_6B_EPOCHS})
            for m, kw in BASE.items()}
    nmf_kw = dict(n_factors=FAM["n_factors"], batch_size=FAM["batch_size"],
                  n_epochs=GLOO_6B_EPOCHS, **FAM_KW["NMF"])
    return (("als", "KernelMF", als_kw), ("bias_als", "BaselineModel", base["als"]),
            ("bias_sgd", "BaselineModel", base["sgd"]), ("nmf", "NMF", nmf_kw))


def gloo_6b_rank(world, inp, X, y):
    """The slice-6b models on this rank, on ``make_mesh(world)``: each fitted
    twice from one seed (KernelMF ALS the second time with
    ``keep_sharded``), ``predict`` of the first 4,096 pairs, and for
    KernelMF ``recommend`` and ``recommend_batch`` (256 users) of both
    fits. Returns host arrays per model."""
    import numpy as np
    import torch

    import matrix_factorization_tpu_torch as port
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(world)
    users = list(inp["users"])
    res = {}
    for name, cls, kw in gloo_6b_models():
        kw = dict(kw, seed=inp["seed"], mesh=mesh)
        first = getattr(port, cls)(**kw).fit(X, y)
        again = getattr(port, cls)(**kw, **(
            {"keep_sharded": True} if name == "als" else {})).fit(X, y)
        p = first._params
        tables = [t.cpu().numpy() for t in p]
        out = {"tables": tables, "train_rmse": first.train_rmse,
               "same_bits": all(torch.equal(a, b)
                                for a, b in zip(p, again._params)),
               "predict": np.asarray(first.predict(X.iloc[:4096]))}
        if name == "als":
            out.update(
                one=first.recommend(users[0], amount=PAR["k"]),
                batch=first.recommend_batch(users, amount=PAR["k"],
                                            bound_ratings=False),
                kept_batch=again.recommend_batch(users, amount=PAR["k"],
                                                 bound_ratings=False),
                kept=(again._sharding, again._topk_catalog is not None))
        res[name] = out
    return res


def parallel_gloo_rank(rank, world, inp):
    """One gloo rank on cuda:0. World 2 (a 2 x 1 mesh): one one-batch epoch
    of ``dp_sgd_train`` from the given tables, then ``KernelMF(mesh=)``
    flat and tiled, each fitted twice. World 4 (2 x 2): ``KernelMF`` with
    ``keep_sharded=True`` (``dp_tp_fit``), ``recommend_batch`` through the
    sharded catalog beside the single-device top-k of the gathered tables.
    Both worlds then fit the slice-6b models (``gloo_6b_rank``) and the
    slice-6c ones (``gloo_6c_rank``), and last put ``keep_sharded`` fits
    through the sharded checkpoints (``gloo_ckpt_rank``). Returns host
    arrays and the rank's kernel launches (the checkpoint part's apart)."""
    import numpy as np
    import pandas as pd
    import torch

    from matrix_factorization_tpu_torch import KernelMF, params_from_numpy
    from matrix_factorization_tpu_torch.ops import scoring
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.parallel import distributed as pdist
    from matrix_factorization_tpu_torch.parallel.mesh import device_index, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    u, i, r = inp["train"]
    X = pd.DataFrame({"user_id": u, "item_id": i})
    y = pd.Series(r)
    kw = dict(n_factors=N_FACTORS, kernel="sigmoid", lr=PAR["lr"], reg=0.005,
              gamma=1.0 / N_FACTORS, min_rating=0.5, max_rating=5.0,
              batch_size=PAR["gloo_bs"], n_epochs=PAR["gloo_epochs"],
              seed=inp["seed"])
    zero_launches(*STEP, "mf_segment_apply", "mf_score_catalog", "mf_gj_inverse",
                  "mf_segment_sum")
    out = {"rank": rank}
    fitted = {}  # keep_sharded fits that the checkpoint part reuses
    t0 = time.perf_counter()
    if world == 2:
        mesh = make_mesh(2)
        d = device_index(mesh)
        ucap = inp["P0"].shape[0]
        su, si, sr, sw, n_pad = pdist.shard_ratings_by_user(u, i, r, ucap, 2, 1)
        cfg = sgd_cfg("sigmoid", N_FACTORS, PAR["lr"], n_pad)
        p0 = params_from_numpy(inp["P0"], inp["Q0"], inp["mu"], device="cuda")
        loc, _ = pdist.dp_sgd_train(
            pdist.place_params(p0, mesh),
            pdist.local_ratings((su, si, sr, sw), d, 2, "cuda"), cfg, 1,
            cfg.lr, mesh, len(r), orders=[[[0], [0]]])
        whole = pdist.gather_params(loc, mesh, q_sharded=False)
        out["one_batch"] = (whole.user_features.cpu().numpy(),
                            whole.item_features.cpu().numpy())
        for layout in ("flat", "tiled"):
            runs = [KernelMF(mesh=mesh, dp_layout=layout, **kw).fit(X, y)
                    for _ in range(2)]
            out[layout] = {
                "train_rmse": runs[0].train_rmse,
                "same_bits": all(torch.equal(getattr(runs[0]._params, f),
                                             getattr(runs[1]._params, f))
                                 for f in ("user_features", "item_features")),
                "Q": runs[0]._params.item_features.cpu().numpy()}
    else:
        mesh = make_mesh(2, 2)
        m = fitted["2x2"] = KernelMF(mesh=mesh, keep_sharded=True, **kw).fit(X, y)
        users = list(inp["users"])
        recs = m.recommend_batch(users, amount=PAR["k"], bound_ratings=False)
        whole = m._whole_params()
        sv, si_ = scoring.catalog_topk(m._cfg(), whole, m.n_items,
                                       m.user_vocab.encode(np.asarray(users)),
                                       PAR["k"])
        items = np.asarray(m.item_vocab.raw_ids)
        out["two_d"] = {
            "train_rmse": m.train_rmse,
            "held_rows": (m._sharding, m._params.user_features.shape[0],
                          m._params.item_features.shape[0],
                          whole.user_features.shape[0],
                          whole.item_features.shape[0]),
            "rec_items": recs["item_id"].to_numpy().reshape(len(users), -1),
            "rec_scores": recs["rating_pred"].to_numpy().reshape(len(users), -1),
            "single_items": items[si_], "single_scores": sv,
            "Q": whole.item_features.cpu().numpy()}
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["6b"] = gloo_6b_rank(world, inp, X, y)
    torch.cuda.synchronize()
    out["6b_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    n0 = n_launches("mf_segment_apply"), n_launches("mf_score_catalog")
    out["6c"] = gloo_6c_rank(world, inp, X, y)
    torch.cuda.synchronize()
    out["6c_seconds"] = time.perf_counter() - t0
    out["6c_launches"] = {"segment_apply": n_launches("mf_segment_apply") - n0[0],
                          "score_catalog": n_launches("mf_score_catalog") - n0[1]}
    out["launches"] = {"sgd_step": n_launches(*STEP),
                       "sgd_step_acc": n_launches("mf_sgd_step_acc"),
                       "segment_apply": n_launches("mf_segment_apply"),
                       "score_catalog": n_launches("mf_score_catalog"),
                       "spd_gj": n_launches("mf_gj_inverse"),
                       "segment_sum": n_launches("mf_segment_sum")}
    t0 = time.perf_counter()
    out["ckpt"] = gloo_ckpt_rank(world, inp, X, y, kw, fitted)
    out["ckpt_seconds"] = time.perf_counter() - t0
    return out


def phase_parallel_gloo(torch, train1m, seed):
    """(b) gloo ranks sharing the card (NCCL refuses two ranks on one GPU),
    every rank on cuda:0, by ``parallel.launch.spawn_world``: a world of 2
    and one of 4 (``parallel_gloo_rank``). Checks: the one-batch epoch
    equals the single-device step on the union batch (2e-5); every
    rank's Q bit-equal; two fits of one seed bit-equal; train RMSE falls;
    under ``keep_sharded`` each rank holds half of P and half of Q; the
    sharded top-10 equals the single-device top-10 of the gathered tables
    (ids, scores 1e-5); the slice-6b models (``check_gloo_6b``), the
    slice-6c ones (``check_gloo_6c``) and the sharded checkpoints
    (``check_gloo_ckpt``, whose line it returns under
    ``sharded_checkpoint``)."""
    import numpy as np

    from matrix_factorization_tpu_torch import params_from_numpy
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.parallel.launch import spawn_world

    from matrix_factorization_tpu_torch.ops import _build

    inp = gloo_inputs(train1m, seed)
    out = {"phase": "parallel_gloo", "backend": "gloo", "device": "cuda:0",
           "n_ratings": len(inp["train"][2]), "batch_size": PAR["gloo_bs"],
           "epochs": PAR["gloo_epochs"]}
    worlds = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as ckpt_dir:
        inp["ckpt_dir"] = ckpt_dir
        for world in (2, 4):
            t0 = time.perf_counter()
            worlds[world] = spawn_world(parallel_gloo_rank, world, "gloo",
                                        "cuda:0", args=(inp,), timeout=600)
            out[f"world{world}_seconds"] = time.perf_counter() - t0
    w2, w4 = worlds[2], worlds[4]

    # one global step on 2 ranks = the single-device step on the union batch
    u, i, r = inp["train"]
    p0 = params_from_numpy(inp["P0"], inp["Q0"], inp["mu"], device="cuda")
    cfg = sgd_cfg("sigmoid", N_FACTORS, PAR["lr"], len(r))
    b = {"u": torch.from_numpy(u).cuda(), "i": torch.from_numpy(i).cuda(),
         "r": torch.from_numpy(r).cuda(), "w": torch.ones(len(r), device="cuda")}
    sgd.minibatch_update(p0, b, cfg, cfg.lr, "user")
    P1, Q1 = w2[0]["one_batch"]
    err = max(float(np.abs(P1 - p0.user_features.cpu().numpy()).max()),
              float(np.abs(Q1 - p0.item_features.cpu().numpy()).max()))
    out["one_batch_max_abs_err"] = err
    check(err <= 2e-5, f"gloo one-batch epoch off the union step by {err}")
    for layout in ("flat", "tiled"):
        hist = w2[0][layout]["train_rmse"]
        check(hist[-1] < hist[0], f"gloo {layout}: RMSE not falling {hist}")
        check(all(rk[layout]["same_bits"] for rk in w2),
              f"gloo {layout}: two fits of one seed differ")
        check(all(np.array_equal(rk[layout]["Q"], w2[0][layout]["Q"])
                  for rk in w2), f"gloo {layout}: the replicas of Q differ")
        out[layout] = {"train_rmse": hist}
    t = w4[0]["two_d"]
    check(t["train_rmse"][-1] < t["train_rmse"][0],
          f"gloo 2D: RMSE not falling {t['train_rmse']}")
    tag, p_rows, q_rows, p_all, q_all = t["held_rows"]
    check(tag == "2d" and 2 * p_rows == p_all and 2 * q_rows == q_all,
          f"gloo 2D: keep_sharded holds {t['held_rows']}, not its shards")
    check(all(np.array_equal(rk["two_d"]["Q"], t["Q"]) for rk in w4),
          "gloo 2D: the gathered Q differs across ranks")
    check(all(np.array_equal(rk["two_d"]["rec_items"], t["rec_items"])
              for rk in w4), "gloo 2D: the ranks served different lists")
    check(np.array_equal(t["rec_items"], t["single_items"]),
          "gloo 2D: the sharded top-10 ids differ from the single-device's")
    serve_err = float(np.abs(t["rec_scores"] - t["single_scores"]).max())
    check(serve_err <= 1e-5, f"gloo 2D: sharded scores off by {serve_err}")
    out["two_d"] = {"train_rmse": t["train_rmse"], "serve_max_abs_err": serve_err,
                    "held_rows": t["held_rows"]}
    out["6b"] = check_gloo_6b(torch, inp, worlds)
    out["6c"] = check_gloo_6c(torch, inp, worlds)
    out["rank_seconds"] = {w: [rk["seconds"] for rk in worlds[w]] for w in worlds}
    out["rank_6b_seconds"] = {w: [rk["6b_seconds"] for rk in worlds[w]]
                              for w in worlds}
    out["rank_6c_seconds"] = {w: [rk["6c_seconds"] for rk in worlds[w]]
                              for w in worlds}
    out["6c_launches"] = {k: sum(rk["6c_launches"][k] for w in worlds.values()
                                 for rk in w)
                          for k in w2[0]["6c_launches"]}
    check(all(v > 0 for v in out["6c_launches"].values()),
          f"the gloo ranks' BPR / SVD++ fits missed a kernel: {out['6c_launches']}")
    out["launches"] = {k: sum(rk["launches"][k] for w in worlds.values()
                              for rk in w)
                       for k in w2[0]["launches"]}
    check(all(v > 0 for v in out["launches"].values()),
          f"the gloo ranks missed a kernel: {out['launches']}")
    out["sharded_checkpoint"] = check_gloo_ckpt(worlds)
    return out


def check_gloo_6b(torch, inp, worlds):
    """The slice-6b models of every gloo world against the same models fit
    on one device here: every rank's tables bit-equal to rank 0's, two fits
    of one seed bit-equal; KernelMF ALS within 1e-4 of the single-device
    fit (tables and RMSE history; JAX ``tests/test_ials.py:179-183``), its
    ``keep_sharded`` lists those of the whole tables; bias ALS within 1e-5;
    bias SGD within 1e-5 of a float64 replay of the mesh fit's own pack
    and batch orders (``bias_sgd_mesh_f64``; the single-device fit visits
    other orders, so its RMSE and the global mean's are only recorded
    beside it); NMF at JAX's bars (``tests/test_nmf.py:181-186``: history
    rtol 2e-4 / atol 2e-5, tables rtol 2e-3 / atol 2e-4, predictions
    1e-3)."""
    import numpy as np
    import pandas as pd

    import matrix_factorization_tpu_torch as port

    u, i, r = inp["train"]
    X = pd.DataFrame({"user_id": u, "item_id": i})
    y = pd.Series(r)
    rmse_mean = float(np.sqrt(np.mean((r.astype(np.float64) - r.mean()) ** 2)))
    single, replay = {}, {}
    for name, cls, kw in gloo_6b_models():
        m = getattr(port, cls)(seed=inp["seed"], **kw).fit(X, y)
        single[name] = ([t.cpu().numpy() for t in m._params], m.train_rmse,
                        np.asarray(m.predict(X.iloc[:4096])))
        if name == "bias_sgd":
            replay = {w: bias_sgd_mesh_f64(m, X, y, kw, inp["seed"], w)
                      for w in worlds}
        del m
    torch.cuda.empty_cache()
    out = {}
    for world, ranks in worlds.items():
        res = {}
        for name in single:
            got = ranks[0]["6b"][name]
            check(all(np.array_equal(a, b) for rk in ranks
                      for a, b in zip(rk["6b"][name]["tables"], got["tables"])),
                  f"gloo {world} {name}: the replicas differ across ranks")
            check(all(rk["6b"][name]["same_bits"] for rk in ranks),
                  f"gloo {world} {name}: two fits of one seed differ")
            tables, hist, pred = single[name]
            rows = [min(a.shape[0], b.shape[0])
                    for a, b in zip(got["tables"][:2], tables[:2])]
            err = max(float(np.abs(a[:n] - b[:n]).max()) for a, b, n in
                      zip(got["tables"][:2], tables[:2], rows))
            herr = float(np.abs(np.asarray(got["train_rmse"])
                                - np.asarray(hist)).max())
            res[name] = {"max_abs_err_single_device": err,
                         "rmse_max_abs_err_single_device": herr,
                         "train_rmse": got["train_rmse"]}
            if name == "als":
                check(err <= 1e-4 and herr <= 1e-4,
                      f"gloo {world} mesh ALS off the single-device fit by "
                      f"{err} (history {herr})")
                b, kb = got["batch"], got["kept_batch"]
                check(got["kept"] == (None, True)
                      and b["item_id"].tolist() == kb["item_id"].tolist()
                      and np.allclose(b["rating_pred"], kb["rating_pred"],
                                      atol=1e-5, rtol=0)
                      and len(got["one"]) == PAR["k"],
                      f"gloo {world} mesh ALS: keep_sharded serves otherwise")
            elif name == "bias_als":
                check(err <= 1e-5, f"gloo {world} bias ALS off by {err}")
            elif name == "bias_sgd":
                fbu, fbi = replay[world]
                ferr = max(float(np.abs(got["tables"][0][:len(fbu)] - fbu).max()),
                           float(np.abs(got["tables"][1][:len(fbi)] - fbi).max()))
                res[name].update(max_abs_err_float64=ferr,
                                 single_device_rmse=hist,
                                 global_mean_rmse=rmse_mean)
                check(ferr <= 1e-5, f"gloo {world} bias SGD off the float64 "
                                    f"replay of its orders by {ferr}")
            else:
                ok = (np.allclose(got["train_rmse"], hist, rtol=2e-4, atol=2e-5)
                      and all(np.allclose(a[:n], b[:n], rtol=2e-3, atol=2e-4)
                              for a, b, n in zip(got["tables"][:2], tables[:2],
                                                 rows))
                      and np.allclose(got["predict"], pred, rtol=1e-3,
                                      atol=1e-3))
                check(ok, f"gloo {world} NMF off the single-device fit by {err}")
        out[f"world{world}"] = res
    return out


def acc_bounds(b, kp, primary):
    """(bound_ms, bound_by, bytes) of the step's accumulator mode on this
    batch: the in-place step's bytes plus a read of each run's row of
    ``prim_out`` (its primary row is read from the table and its delta
    row read and written in ``prim_out``)."""
    bounds, runs_prim, runs_sec = sgd_bounds(b, kp, primary)
    nbytes = bounds["sgd_step"][2] + runs_prim * kp * 4
    n = b["u"].numel()
    tb, to = nbytes / HBM_BYTES_PER_S, 12 * n * kp / PEAK_FLOPS["float32"]
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations", nbytes,
            runs_prim, runs_sec)


def cell_batch(torch, train1m, bs):
    """The first batch of 2D cell (0, 0) of the config-2-shaped ratings on a
    2 x 2 mesh, sorted by user on the card with its secondary argsort, as
    ``dp_tp_sgd_train`` hands it to the step."""
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.parallel import distributed as pdist

    u, i, r = train1m
    ucap = sgd.round_up(ML1M["n_users"], 16)
    icap = sgd.round_up(ML1M["n_items"], 16)
    su, si, sr, sw, n_pad = pdist.shard_ratings_2d(u, i, r, ucap, icap, 2, 2, bs)
    cols = [torch.from_numpy(a[:bs].copy()).cuda() for a in (su, si, sr, sw)]
    uu, order = torch.sort(cols[0], stable=True)
    ii, rr, ww = (c[order] for c in cols[1:])
    ss, sp = torch.sort(ii, stable=True)
    return ({"u": uu, "i": ii, "r": rr, "w": ww, "sp": sp.to(torch.int32),
             "ss": ss}, ucap // 2, icap // 2)


def phase_parallel_kernels(torch, rng, packs, train1m, timer):
    """(c) The kernels against their plain versions at the shapes the
    parallel path hands them (atol = rtol = 1e-5): the step's accumulator
    mode on the first batch of config 3's item-primary pack (n 2,097,152)
    and on a 2D cell's batch (n 65,536, user-primary), the primary table
    unchanged and ``dq`` equal to the plain step's; the apply into a zeroed
    delta table on config 3's user-primary batch and on the cell batch,
    bitwise against its plain order model. Then device times: the
    accumulator mode at both shapes and the apply into the zeroed table at
    config 3 (kernel, plain, library ``index_add_``), with their bounds."""
    from matrix_factorization_tpu_torch.ops import cuda_sgd
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.ops import segment_sum as ss

    cfg3 = sgd_cfg("sigmoid", N_FACTORS, PAR["lr"], CONFIG3["sigmoid"]["batch_size"])
    cell, cu, ci = cell_batch(torch, train1m, PAR["gloo_bs"])
    shapes = [("config3_item_primary", cfg3, sgd.batch_at(packs["shuffle"], 0),
               "item", N_USERS, N_ITEMS),
              ("config3_user_primary", cfg3, sgd.batch_at(packs["user"], 0),
               "user", N_USERS, N_ITEMS),
              ("two_d_cell", sgd_cfg("sigmoid", N_FACTORS, PAR["lr"],
                                     PAR["gloo_bs"]), cell, "user", cu, ci)]
    worst = {"sgd_step": 0.0, "segment_apply": 0.0}
    rows = []

    def zero(t):  # the L2 flush, then the delta table zeroed as a window starts
        timer.flush.zero_()
        t.zero_()

    for name, cfg, b, primary, n_users, n_items in shapes:
        p = random_params(torch, rng, cfg, n_users, n_items)
        args, _, S = step_args(p, b, cfg, primary)
        prim_tbl = args[2]
        before = prim_tbl.clone()
        acc_k, acc_p = torch.zeros_like(prim_tbl), torch.zeros_like(prim_tbl)
        dq_k = cuda_sgd.cuda_sgd_step(*args, prim_out=acc_k)
        dq_p = cuda_sgd.plain_sgd_step(*args, prim_out=acc_p)
        torch.cuda.synchronize()
        check(torch.equal(prim_tbl, before),
              f"parallel_kernels {name}: the accumulator mode wrote the table")
        step_err = max(float((acc_k - acc_p).abs().max()),
                       float((dq_k - dq_p).abs().max()))
        check(torch.allclose(acc_k, acc_p, atol=1e-5, rtol=1e-5)
              and torch.allclose(dq_k, dq_p, atol=1e-5, rtol=1e-5),
              f"parallel_kernels {name}: the accumulator mode off by {step_err}")
        zk, zp, zm = (torch.zeros_like(S) for _ in range(3))
        ss.cuda_segment_apply(zk, dq_p, b["sp"], b["ss"])
        ss.plain_segment_apply(zp, dq_p, b["sp"], b["ss"])
        ss.segmented_segment_sum(zm, dq_p, b["sp"], b["ss"],
                                 chunk=ss.APPLY_CHUNK, layout="columns")
        apply_err = float((zk - zp).abs().max())
        check(torch.equal(zk, zm) and torch.allclose(zk, zp, atol=1e-5,
                                                     rtol=1e-5),
              f"parallel_kernels {name}: the apply into dQ off by {apply_err}")
        worst["sgd_step"] = max(worst["sgd_step"], step_err)
        worst["segment_apply"] = max(worst["segment_apply"], apply_err)
        row = {"phase": "parallel_kernels", "shape": name, "bs": b["u"].numel(),
               "primary": primary, "step_acc_max_abs_err": step_err,
               "apply_into_zeros_max_abs_err": apply_err}
        if name != "config3_user_primary":
            bms, bby, nbytes, runs_prim, runs_sec = acc_bounds(
                b, cfg.padded_factors, primary)
            row.update({
                "name": "sgd_step_acc",
                "ms": timer.ms(lambda: cuda_sgd.cuda_sgd_step(
                    *args, prim_out=acc_k)),
                "in_place_ms": timer.ms(lambda: cuda_sgd.cuda_sgd_step(*args)),
                "plain_ms": timer.ms(lambda: cuda_sgd.plain_sgd_step(
                    *args, prim_out=acc_p)),
                "library_ms": None, "bound_ms": bms, "bound_by": bby,
                "bound_bytes": nbytes, "runs_prim": runs_prim,
                "runs_sec": runs_sec, "Kp": cfg.padded_factors})
        else:
            bounds, runs_prim, runs_sec = sgd_bounds(b, cfg.padded_factors,
                                                     primary)
            ss_long, dq_perm = b["ss"].long(), dq_p[b["sp"].long()]
            row.update({
                "name": "segment_apply_into_zeros",
                "ms": timer.ms(lambda: ss.cuda_segment_apply(
                    zk, dq_p, b["sp"], b["ss"]), before=lambda: zero(zk)),
                "plain_ms": timer.ms(lambda: ss.plain_segment_apply(
                    zp, dq_p, b["sp"], b["ss"]), before=lambda: zero(zp)),
                "library_ms": timer.ms(lambda: zm.index_add_(0, ss_long, dq_perm),
                                       before=lambda: zero(zm)),
                "bound_ms": bounds["segment_apply"][0],
                "bound_by": bounds["segment_apply"][1],
                "bound_bytes": bounds["segment_apply"][2],
                "runs_prim": runs_prim, "runs_sec": runs_sec,
                "Kp": cfg.padded_factors})
            del ss_long, dq_perm
        emit(row)
        rows.append(row)
        del p, args, S, acc_k, acc_p, dq_k, dq_p, zk, zp, zm, before
        torch.cuda.empty_cache()
    return rows, worst



# phase parallel_als: the slice-6b trainers at world size 1 on NCCL. Factor
# ALS as ALS (k=200, 3 sweeps) and NMF as FAM (k=64, bs 1,048,576, 3 epochs)
# on config 3; bias ALS with the pipeline's reg and epochs on config 3; bias
# SGD with BASE['sgd'] on config 2, 3 epochs
PAR_ALS = {"bias_bs": 1024, "sgd_epochs": 3, "nmf_epochs": 3,
           "nmf_reg": FAM_KW["NMF"]["reg"]}


class HostTimed:
    """A stand-in for ``torch.distributed.all_reduce`` that counts the calls
    and the host seconds spent inside them."""

    def __init__(self, fn):
        self.fn, self.calls, self.seconds = fn, 0, 0.0

    def __call__(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return self.fn(*a, **k)
        finally:
            self.seconds += time.perf_counter() - t0
            self.calls += 1


def phase_parallel_als(torch, rng, data3, train1m, seed):
    """(d) The slice-6b trainers at NCCL world size 1 in this process
    (inside ``nccl_world``). References first (each trainer's single-device
    counterpart on the same inputs: ``ials_train_bucketed``, ``als_train``,
    ``nmf_train``; the GJ count of the first read), then the main path with
    the GJ, segment-sum and scorer counts zeroed just before and read just
    after: ``dp_ials_train_bucketed`` at config 3 (k=200, reg 0.1 per
    observation, 3 sweeps, config 3's count buckets and seeded tables),
    ``dp_als_train`` on config 3 (the pipeline's reg 0.005, 5 epochs),
    ``dp_bias_sgd_train`` on config 2 (lr 0.02, reg 0.02, bs 4,096, 3
    epochs, seeded batch orders; ``all_reduce`` wrapped to count its calls
    and host seconds), ``dp_nmf_train`` (k=64, bs 1,048,576, 3 epochs on
    config 3), and ``ShardedCatalog`` serving 256 users' top-10 of the dp
    ALS tables. Checks: the dp ALS tables and history bit-equal to
    ``ials_train_bucketed`` (else within 1e-6, the flag recorded) with as
    many GJ launches; bias ALS within 1e-5 of ``als_train`` and of the
    float64 ``bias_als_f64``; bias SGD within 1e-5 of a float64 replay of
    the same batch orders; NMF within rtol 1e-5 of ``nmf_train`` (bit
    equality recorded); the sharded top-10 ids equal to ``catalog_topk``'s,
    scores 1e-5. Then the fit and median sweep seconds (3 one-sweep runs)
    and one profiled sweep (the all-gather's device time)."""
    import numpy as np
    import torch.distributed as dist

    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import als, ials, nmf
    from matrix_factorization_tpu_torch.ops import scoring
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.parallel import distributed as pdist
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh
    from matrix_factorization_tpu_torch.parallel.serving import ShardedCatalog

    def sync_time(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    u, i, r = data3[:3]
    mesh = make_mesh(1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"phase": "parallel_als", "backend": "nccl", "world_size": 1,
           "n_ratings": len(r), "als": ALS, "bias_als": PIPE_BASELINE_KW,
           "bias_sgd": {**BASE["sgd"], "n_epochs": PAR_ALS["sgd_epochs"]},
           "nmf": {**FAM, "epochs": PAR_ALS["nmf_epochs"],
                   "reg": PAR_ALS["nmf_reg"]}}

    # -- inputs ------------------------------------------------------------
    t0 = time.perf_counter()
    bu, bi = ials.group_both_sides_bucketed(u, i, r, N_USERS, N_ITEMS)
    out["als_pack_seconds"] = sync_time(t0)
    cfg = SGDConfig(kernel="linear", n_factors=ALS["n_factors"], reg=ALS["reg"],
                    min_rating=0.5, max_rating=5.0,
                    batch_size=CONFIG3["sigmoid"]["batch_size"])
    fast = dataclasses.replace(cfg, compute_epoch_rmse=False)
    rmse_pack = sgd.pack_ratings(u, i, r, cfg.batch_size, aggregate=False,
                                 device="cuda")
    p0 = sgd.init_params(torch.Generator(device="cuda").manual_seed(seed),
                         N_USERS, N_ITEMS, cfg, float(r.mean()))
    base_kw = PIPE_BASELINE_KW
    cols3 = als.shard_bias_data(
        sgd.pack_ratings(u, i, r, PAR_ALS["bias_bs"], aggregate=False,
                         device="cpu"), mesh, "cuda")
    b3 = als.init_bias_params(N_USERS, N_ITEMS, float(r.mean()), device="cuda")
    u2, i2, r2 = train1m
    n2u, n2i = ML1M["n_users"], ML1M["n_items"]
    skw = out["bias_sgd"]
    pack2 = sgd.pack_ratings(u2, i2, r2, skw["batch_size"], aggregate=False,
                             device="cpu")
    cols2 = als.shard_bias_data(pack2, mesh, "cuda")
    b2 = als.init_bias_params(n2u, n2i, float(r2.mean()), device="cuda")
    orders = [rng.permutation(pack2.n_batches) for _ in range(skw["n_epochs"])]
    ncfg = SGDConfig(kernel="linear", n_factors=FAM["n_factors"],
                     reg=PAR_ALS["nmf_reg"], min_rating=0.5, max_rating=5.0,
                     batch_size=FAM["batch_size"])
    t0 = time.perf_counter()
    npack = sgd.pack_ratings(u, i, r, FAM["batch_size"], order="auto",
                             device="cuda")
    out["nmf_pack_seconds"] = sync_time(t0)
    q0 = nmf.init_nmf_params(torch.Generator(device="cuda").manual_seed(seed),
                             N_USERS, N_ITEMS, ncfg)
    cnt_u = torch.from_numpy(np.bincount(u, minlength=q0.user_features.shape[0])
                             .astype(np.float32)).cuda()
    cnt_i = torch.from_numpy(np.bincount(i, minlength=q0.item_features.shape[0])
                             .astype(np.float32)).cuda()

    # -- the single-device references -------------------------------------
    zero_launches("mf_gj_inverse")
    t0 = time.perf_counter()
    ref, href = ials.ials_train_bucketed(p0, bu, bi, rmse_pack, cfg,
                                         ALS["sweeps"], reg_scale=ALS["reg_scale"])
    out["single_device_fit_seconds"] = sync_time(t0)
    single_gj = n_launches("mf_gj_inverse")
    bref, _ = als.als_train(b3, cols3, base_kw["reg"], base_kw["n_epochs"])
    qref, qhref = nmf.nmf_train(q0, npack, cnt_u, cnt_i, ncfg,
                                PAR_ALS["nmf_epochs"], PAR_ALS["nmf_reg"],
                                PAR_ALS["nmf_reg"])

    # -- the main path, counts zeroed just before --------------------------
    torch.cuda.synchronize()
    zero_launches("mf_gj_inverse", "mf_segment_sum", "mf_score_catalog")
    t0 = time.perf_counter()
    got, hist = ials.dp_ials_train_bucketed(p0, bu, bi, rmse_pack, cfg,
                                            ALS["sweeps"], mesh,
                                            reg_scale=ALS["reg_scale"])
    out["fit_seconds"] = sync_time(t0)
    dp_gj = n_launches("mf_gj_inverse")
    t0 = time.perf_counter()
    bdp, bhist = als.dp_als_train(b3, cols3, base_kw["reg"], base_kw["n_epochs"],
                                  mesh)
    out["bias_als_seconds"] = sync_time(t0)
    timed = HostTimed(dist.all_reduce)
    dist.all_reduce = timed
    try:
        t0 = time.perf_counter()
        sdp, shist = als.dp_bias_sgd_train(b2, cols2, orders, skw["lr"],
                                           skw["reg"], mesh)
        sgd_s = sync_time(t0)
    finally:
        dist.all_reduce = timed.fn
    t0 = time.perf_counter()
    qdp, qhist = nmf.dp_nmf_train(pdist.place_params(q0, mesh), npack, cnt_u,
                                  cnt_i, ncfg, PAR_ALS["nmf_epochs"],
                                  PAR_ALS["nmf_reg"], PAR_ALS["nmf_reg"], mesh)
    out["nmf_seconds"] = sync_time(t0)
    ud = rng.choice(N_USERS, PAR["serve_users"], replace=False).astype(np.int32)
    cat = ShardedCatalog(got, N_ITEMS, cfg, mesh)
    vals, idx = cat.topk(got.user_features[torch.from_numpy(ud).cuda()], PAR["k"])
    launches = {"spd_gj": dp_gj, "segment_sum": n_launches("mf_segment_sum"),
                "score_catalog": n_launches("mf_score_catalog")}
    out["launches"] = launches
    check(all(v > 0 for v in launches.values()),
          f"the parallel ALS path missed a kernel: {launches}")

    # -- the checks ----------------------------------------------------------
    hist, href = hist.cpu().numpy(), href.cpu().numpy()
    bit = (torch.equal(got.user_features, ref.user_features)
           and torch.equal(got.item_features, ref.item_features)
           and np.array_equal(hist, href))
    err = max(table_err(got, ref), float(np.abs(hist - href).max()))
    out.update({"train_rmse": hist.tolist(), "bit_equal_single_device": bit,
                "max_abs_err_single_device": err, "gj_launches_single": single_gj})
    check(bit or err <= 1e-6, f"dp ALS off ials_train_bucketed by {err}")
    check(dp_gj == single_gj, f"dp ALS launched the GJ leaf {dp_gj} times, "
                              f"single device {single_gj}")
    check(hist[-1] < hist[0], f"dp ALS RMSE not falling {hist}")
    wv, wi = scoring.catalog_topk(cfg, got, N_ITEMS, ud, PAR["k"])
    check(np.array_equal(idx, wi), "parallel ALS: the sharded top-10 ids differ")
    out["serve_max_abs_err"] = float(np.abs(vals - wv).max())
    check(out["serve_max_abs_err"] <= 1e-5, "parallel ALS: sharded scores differ")

    fbu, fbi = bias_als_f64(u, i, r, N_USERS, N_ITEMS, base_kw["reg"],
                            base_kw["n_epochs"])
    errs = {"single_device": max(float((bdp.user_biases - bref.user_biases).abs().max()),
                                 float((bdp.item_biases - bref.item_biases).abs().max())),
            "float64": max(float(np.abs(bdp.user_biases.cpu().numpy() - fbu).max()),
                           float(np.abs(bdp.item_biases.cpu().numpy() - fbi).max()))}
    out["bias_als_max_abs_err"] = errs
    out["bias_als_rmse"] = bhist.cpu().tolist()
    check(max(errs.values()) <= 1e-5, f"dp bias ALS off by {errs}")

    stream = (pack2.user_ids.reshape(-1).long().numpy(),
              pack2.item_ids.reshape(-1).long().numpy(),
              pack2.ratings.reshape(-1).double().numpy(),
              pack2.weights.reshape(-1).double().numpy())
    index = np.arange(stream[0].size).reshape(pack2.n_batches, -1)
    fbu, fbi = bias_sgd_f64(stream, [index[o] for o in orders], float(b2.global_mean),
                            skw["lr"], skw["reg"], n2u, n2i)
    sgd_err = max(float(np.abs(sdp.user_biases.cpu().numpy() - fbu).max()),
                  float(np.abs(sdp.item_biases.cpu().numpy() - fbi).max()))
    steps = pack2.n_batches * skw["n_epochs"]
    out["bias_sgd_result"] = {
        "seconds": sgd_s, "steps": steps, "seconds_per_step": sgd_s / steps,
        "all_reduce_calls": timed.calls, "all_reduce_host_seconds": timed.seconds,
        "all_reduce_host_share": timed.seconds / sgd_s,
        "max_abs_err_float64": sgd_err, "train_rmse": shist.cpu().tolist()}
    check(sgd_err <= 1e-5, f"dp bias SGD off its float64 replay by {sgd_err}")
    check(timed.calls == 2 * steps + skw["n_epochs"],
          f"dp bias SGD made {timed.calls} all-reduces for {steps} steps")

    qbit = all(torch.equal(a, b) for a, b in (
        (qdp.user_features, qref.user_features),
        (qdp.item_features, qref.item_features), (qhist, qhref)))
    qerr = max(table_err(qdp, qref), float((qhist - qhref).abs().max()))
    out["nmf_result"] = {"bit_equal_single_device": qbit,
                         "max_abs_err_single_device": qerr,
                         "train_rmse": qhist.cpu().tolist()}
    check(qbit or all(torch.allclose(a, b, rtol=1e-5, atol=0) for a, b in (
        (qdp.user_features, qref.user_features),
        (qdp.item_features, qref.item_features), (qhist, qhref))),
        f"dp NMF off nmf_train by {qerr}")
    del ref, qref, qdp, bref, npack, cols3
    torch.cuda.empty_cache()

    # -- sweep seconds and where a sweep's device time goes -----------------
    def sweep(_=None):
        return ials.dp_ials_train_bucketed(p0, bu, bi, None, fast, 1, mesh,
                                           reg_scale=ALS["reg_scale"])[0]

    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        sweep()
        secs.append(sync_time(t0))
    out["sweep_seconds"] = secs
    out["sweep_median_s"] = statistics.median(secs)
    out["sweep_profile"] = _device_share(torch, sweep, [0], match="nccl")
    out["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    return out


# phase parallel_families: the slice-6c trainers at world size 1 on NCCL at
# the families' shape (FAM on config 3), their draws given; the gloo worlds
# fit BPR and SVD++ on a mesh at config 2's shape (GLOO_6C)
GLOO_6C = {"n_factors": 64, "batch_size": 65_536, "n_epochs": 2}


def phase_parallel_families(torch, rng, data3, seed):
    """(e) The slice-6c trainers at NCCL world size 1 in this process
    (inside ``nccl_world``), at the families' shape: config 3's 25M ratings,
    k=64, bs 1,048,576, 3 epochs, one user-primary pack (BPR reads its ids
    and weights, SVD++ its ratings too) and the flat stream of
    ``dp_fit_plumbing``, the draws given (a batch order and (nb, bs)
    negatives an epoch for the pack; a permutation and a negative a triplet
    for the stream), seeded tables (SVD++'s Y seeded too, so that S is not
    zero). The single-device trainers first (``bpr_train_tiled``,
    ``bpr_train``, ``svdpp_train_batched``, ``svdpp_train``), then with the
    apply and scorer counts zeroed just before and read just after:
    ``dp_bpr_train_tiled``, ``dp_bpr_train``, ``dp_svdpp_train_batched``,
    ``dp_svdpp_train`` on the same inputs, and ``BPR`` / ``SVDpp`` with
    ``mesh=make_mesh(1)`` fitted for one epoch (at one data rank the model
    trains on its single-device path, as JAX's does) and served:
    ``recommend`` and a 256-user ``recommend_batch``. Checks: each dp
    trainer within JAX's bars of its single-device trainer (BPR tables
    2e-5, loss rtol 1e-5; SVD++ 1e-5) with as many apply launches; the
    served lists of 10. Each fit's seconds, and a profiled epoch of each dp
    trainer (device time, busy share, the NCCL kernels' time)."""
    import numpy as np
    import pandas as pd

    import matrix_factorization_tpu_torch as port
    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import bpr, svdpp
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.parallel import distributed as pdist
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    def sync_time(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    u, i, r = data3[:3]
    E, bs, lr = FAM["epochs"], FAM["batch_size"], 0.05
    mesh = make_mesh(1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"phase": "parallel_families", "backend": "nccl", "world_size": 1,
           "n_ratings": len(r), **FAM}

    # -- inputs ------------------------------------------------------------
    t0 = time.perf_counter()
    pack = sgd.pack_ratings(u, i, r, bs, shuffle_seed=seed, order="user",
                            device="cuda")
    out["pack_seconds"] = sync_time(t0)
    t0 = time.perf_counter()
    _, fbs, stream = pdist.dp_fit_plumbing(u, i, r, N_USERS, mesh, bs)
    flat = pdist.local_ratings(stream, 0, 1, "cuda")
    out["stream_seconds"] = sync_time(t0)
    n_pad, nb = flat.user_ids.shape[0], pack.n_batches
    gen = torch.Generator(device="cuda").manual_seed(seed)
    orders = [torch.from_numpy(rng.permutation(nb)) for _ in range(E)]
    negs = [torch.randint(0, N_ITEMS, (nb, bs), generator=gen, device="cuda",
                          dtype=torch.int32) for _ in range(E)]
    perms = [torch.randperm(n_pad, generator=gen, device="cuda")
             for _ in range(E)]
    fnegs = [torch.randint(0, N_ITEMS, (n_pad,), generator=gen, device="cuda",
                           dtype=torch.int32) for _ in range(E)]
    kw = FAM_KW["SVDpp"]  # the models' configs at the families' shape
    bcfg = SGDConfig(kernel="linear", n_factors=FAM["n_factors"], reg=0.002,
                     min_rating=0.0, max_rating=1.0)
    scfg = SGDConfig(kernel="linear", n_factors=FAM["n_factors"], lr=kw["lr"],
                     reg=kw["reg"], min_rating=kw["min_rating"],
                     max_rating=kw["max_rating"], batch_size=bs)
    b0 = sgd.init_params(gen, N_USERS, N_ITEMS, bcfg, 0.0)
    s0 = svdpp.init_params(gen, N_USERS, N_ITEMS, scfg, float(r.mean()))
    Y = torch.zeros_like(s0.implicit_features)
    Y[:, :scfg.n_factors] = 0.05 * torch.randn(
        (Y.shape[0], scfg.n_factors), generator=gen, device="cuda")
    s0 = s0._replace(implicit_features=Y)
    wvec = torch.from_numpy(svdpp._neighbor_weights(
        u, N_USERS, s0.user_features.shape[0])).cuda()
    deg = torch.from_numpy(np.bincount(i, minlength=Y.shape[0]).astype(
        np.float32)).cuda()
    lr_y, reg_y = scfg.lr, scfg.reg

    def per_rank(draws):
        return [[x] for x in draws]

    runs = {  # name: (single-device run, dp run)
        "bpr_tiled": (
            lambda: bpr.bpr_train_tiled(b0, pack, None, bcfg, E, lr, N_ITEMS,
                                        batch_orders=orders, negatives=negs),
            lambda e=E: bpr.dp_bpr_train_tiled(
                pdist.place_params(b0, mesh), pack, bcfg, e, lr, N_ITEMS, mesh,
                batch_orders=per_rank(orders[:e]),
                negatives=per_rank(negs[:e]))),
        "bpr_flat": (
            lambda: bpr.bpr_train(b0, flat.user_ids, flat.item_ids,
                                  flat.weights, None, bcfg, E, lr, N_ITEMS,
                                  fbs, len(r), perms=perms, negatives=fnegs),
            lambda e=E: bpr.dp_bpr_train(
                pdist.place_params(b0, mesh), flat, bcfg, e, lr, N_ITEMS, fbs,
                len(r), mesh, perms=per_rank(perms[:e]),
                negatives=per_rank(fnegs[:e]))),
        "svdpp_tiled": (
            lambda: svdpp.svdpp_train_batched(s0, pack, wvec, deg, None, scfg,
                                              E, lr_y, reg_y,
                                              batch_orders=orders),
            lambda e=E: svdpp.dp_svdpp_train_batched(
                s0, pack, wvec, deg, scfg, e, lr_y, reg_y, mesh,
                batch_orders=per_rank(orders[:e]))),
        "svdpp_flat": (
            lambda: svdpp.svdpp_train(s0, *flat, wvec, deg, None, scfg, E,
                                      lr_y, reg_y, fbs, len(r), perms=perms),
            lambda e=E: svdpp.dp_svdpp_train(
                s0, flat, wvec, deg, scfg, e, lr_y, reg_y, fbs, len(r), mesh,
                perms=per_rank(perms[:e]))),
    }

    # -- the single-device references --------------------------------------
    refs = {}
    for name, (single, _) in runs.items():
        n0 = n_launches("mf_segment_apply")
        t0 = time.perf_counter()
        refs[name] = single()
        out[f"{name}_single_device_seconds"] = sync_time(t0)
        out[f"{name}_single_device_launches"] = n_launches("mf_segment_apply") - n0

    # -- the main path, counts zeroed just before --------------------------
    torch.cuda.synchronize()
    zero_launches(*STEP, "mf_segment_apply", "mf_score_catalog")
    got = {}
    for name, (_, dp) in runs.items():
        n0 = n_launches("mf_segment_apply")
        t0 = time.perf_counter()
        got[name] = dp()
        out[f"{name}_seconds"] = sync_time(t0)
        out[f"{name}_launches"] = n_launches("mf_segment_apply") - n0
    X = pd.DataFrame({"user_id": u, "item_id": i})
    served = {}
    for cls, y in (("BPR", None), ("SVDpp", pd.Series(r))):
        t0 = time.perf_counter()
        m = getattr(port, cls)(n_factors=FAM["n_factors"], n_epochs=1,
                               batch_size=bs, seed=seed, mesh=mesh,
                               **FAM_KW[cls]).fit(X, y)
        out[f"{cls.lower()}_model_fit_seconds"] = sync_time(t0)
        users = [int(x) for x in rng.choice(np.unique(u), PAR["serve_users"],
                                            replace=False)]
        one = m.recommend(users[0], amount=PAR["k"])
        batch = m.recommend_batch(users, amount=PAR["k"])
        served[cls] = (len(one), len(batch))
        del m
    launches = {"segment_apply": n_launches("mf_segment_apply"),
                "score_catalog": n_launches("mf_score_catalog")}
    out["launches"] = launches
    check(all(v > 0 for v in launches.values()),
          f"the parallel families' path missed a kernel: {launches}")
    check(all(v == (PAR["k"], PAR["k"] * PAR["serve_users"])
              for v in served.values()),
          f"the mesh models served lists of another length: {served}")

    # -- the checks ----------------------------------------------------------
    for name in runs:
        (gp, gh), (rp, rh) = got[name], refs[name]
        errs = [float((a - b).abs().max()) for a, b in zip(gp, rp)
                if a.dim() == 2]
        gh, rh = gh.cpu().numpy(), rh.cpu().numpy()
        if name.startswith("bpr"):
            hist_err = float(np.max(np.abs(gh - rh) / np.abs(rh)))
            ok = max(errs) <= 2e-5 and hist_err <= 1e-5
            check(gh[-1] < gh[0], f"{name}: the loss did not fall {gh}")
        else:
            hist_err = float(np.abs(gh - rh).max())
            ok = max(errs) <= 1e-5 and hist_err <= 1e-5
            check(gh[-1] < gh[0], f"{name}: the train RMSE did not fall {gh}")
        out[f"{name}_max_abs_err_single_device"] = max(errs)
        out[f"{name}_hist_err_single_device"] = hist_err
        out[f"{name}_bit_equal_single_device"] = all(
            torch.equal(a, b) for a, b in zip(gp, rp))
        out[f"{name}_history"] = gh.tolist()
        check(ok, f"{name} at world 1 off its single-device trainer by "
                  f"{max(errs)} (history {hist_err})")
        check(out[f"{name}_launches"] == out[f"{name}_single_device_launches"],
              f"{name}: {out[f'{name}_launches']} apply launches, single "
              f"device {out[f'{name}_single_device_launches']}")
    del got, refs
    torch.cuda.empty_cache()

    # -- where a dp epoch's device time goes -----------------------------
    for name, (_, dp) in runs.items():
        out[f"{name}_epoch_profile"] = _device_share(
            torch, lambda _, dp=dp: dp(1), [0], match="nccl")
    out["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    return out


def gloo_6c_models():
    """(name, class name, keyword arguments) of the slice-6c fits of every
    gloo world: BPR and SVD++ at config 2's shape with the families' width
    and lr / reg, each layout once, the tiled one windowed ('auto') and
    overlapped."""
    out = []
    for cls in ("BPR", "SVDpp"):
        base = dict(GLOO_6C, **FAM_KW[cls])
        out += [(f"{cls.lower()}_flat", cls, dict(base, dp_layout="flat")),
                (f"{cls.lower()}_tiled", cls,
                 dict(base, dp_layout="tiled", psum_every="auto",
                      overlap_psum=True))]
    return out


def gloo_6c_rank(world, inp, X, y):
    """The slice-6c models on this rank, on ``make_mesh(world)``: each fit
    once (the tiled ones twice from one seed), then ``recommend`` and a
    256-user ``recommend_batch``. Returns host arrays per fit."""
    import torch

    import matrix_factorization_tpu_torch as port
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(world)
    users = list(inp["users"])
    res = {}
    for name, cls, kw in gloo_6c_models():
        kw = dict(kw, seed=inp["seed"], mesh=mesh)
        yy = None if cls == "BPR" else y
        m = getattr(port, cls)(**kw).fit(X, yy)
        out = {"tables": [t.cpu().numpy() for t in m._params],
               "hist": m.train_loss if cls == "BPR" else m.train_rmse,
               "one": len(m.recommend(users[0], amount=PAR["k"])),
               "batch": m.recommend_batch(users, amount=PAR["k"])[
                   "item_id"].to_numpy()}
        if name.endswith("tiled"):
            again = getattr(port, cls)(**kw).fit(X, yy)
            out["same_bits"] = all(torch.equal(a, b) for a, b in
                                   zip(m._params, again._params))
        res[name] = out
    return res


def family_mesh_f64(torch, cls, kw, X, y, seed, world):
    """float64 replay, in one process, of ``cls(mesh=make_mesh(world),
    **kw).fit``: the same ids (``_preprocess_fit``), the same initial tables
    (seeded with ``seed``, grown by fresh rows to ``round_up(n_users, 8 *
    world)``), each rank's part of the positives or ratings (its segment of
    the device-major pack, or its user range of the stream), the same
    draws (``bpr.rank_draws`` / ``svdpp._rank_order`` keyed (seed, 1)), and
    the windows of ``psum_every`` steps: within a window every rank's steps
    read Q as it stood at the window's start and every rank's Q deltas are
    summed, P (and SVD++'s accumulator) updated in place; under
    ``overlap_psum`` a window's sum is added after the next window's
    steps. SVD++'s S and Y gradient over all pairs, Y updated an epoch, S
    refreshed at the end. Plain ``index_add_`` in float64 on the card.
    Returns the tables as float64 numpy: (P, Q) or (P, Q, Y, S)."""
    import numpy as np
    import pandas as pd

    import matrix_factorization_tpu_torch as port
    from matrix_factorization_tpu_torch.ops import bpr, svdpp
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd
    from matrix_factorization_tpu_torch.parallel import distributed as pdist

    dev, f64 = "cuda", torch.float64
    is_bpr = cls == "BPR"
    m = getattr(port, cls)(n_factors=kw["n_factors"], seed=seed,
                           **FAM_KW[cls])
    u, i, r = m._preprocess_fit(
        X, pd.Series(np.ones(len(X), np.float32)) if is_bpr else y)
    cfg = m._cfg()
    nu, ni = m.n_users, m.n_items
    ucap = sgd.round_up(nu, 8 * world)
    rows = ucap // world
    bs = min(kw["batch_size"], max(1, len(u)))
    mu = 0.0 if is_bpr else float(np.mean(r))
    base = sgd.init_params(torch.Generator(device=dev).manual_seed(seed), nu,
                           ni, cfg, mu, init_sd=m.init_sd)
    P = base.user_features
    if ucap > P.shape[0]:
        P = torch.cat([P, sgd.fresh_user_rows(sgd.seeded_generator(dev, seed, 0),
                                              ucap - P.shape[0], cfg, 0.0,
                                              m.init_sd)])
    P, Q = P.to(f64), base.item_features.to(f64)
    umask, imask = (sgd.mask_tensor(cfg, s, dev).to(f64) for s in ("user", "item"))
    fmask = svdpp.factor_mask(cfg, P.shape[1], dev).to(f64)
    vals = np.ones(len(u), np.float32) if is_bpr else r.astype(np.float32)
    key, lr = (seed, 1), m.lr
    tiled = kw["dp_layout"] == "tiled"
    if tiled:
        packs = [sgd.pack_ratings(u.astype(np.int32), i.astype(np.int32), vals,
                                  bs, shuffle_seed=seed, order="user",
                                  n_dev=world, users_per_dev=rows, segment=d,
                                  device=dev) for d in range(world)]
        nb = packs[0].n_batches
        T = pdist._check_psum_every(kw.get("psum_every", 1), nb)
    else:
        su, si, sr, sw, n_pad = pdist.shard_ratings_by_user(
            u.astype(np.int32), i.astype(np.int32), vals, ucap, world, bs)
        nb, T = n_pad // bs, 1
        cols = [{k: torch.from_numpy(a[d * n_pad:(d + 1) * n_pad]).to(dev)
                 for k, a in zip("uirw", (su, si, sr, sw))} for d in range(world)]

    def rank_batches(e, d):
        """Rank d's batches of epoch e in visit order, global user ids."""
        if tiled:
            if is_bpr:
                visit, negs = bpr.rank_draws(None, None, key, e, d, nb, (nb, bs),
                                             ni, dev)
            else:
                visit = svdpp._rank_order(None, e, d, nb, key, dev)
            p = packs[d]
            return [{"u": p.user_ids[k].long() + d * rows,
                     "i": p.item_ids[k].long(), "r": p.ratings[k].to(f64),
                     "w": p.weights[k].to(f64),
                     "j": negs[t].long() if is_bpr else None}
                    for t, k in enumerate(visit.tolist())]
        if is_bpr:
            perm, negs = bpr.rank_draws(None, None, key, e, d, n_pad, (n_pad,),
                                        ni, dev)
        else:
            perm = svdpp._rank_order(None, e, d, n_pad, key, dev)
        c = {k: v[perm] for k, v in cols[d].items()}
        return [{"u": c["u"][lo:lo + bs].long() + d * rows,
                 "i": c["i"][lo:lo + bs].long(), "r": c["r"][lo:lo + bs].to(f64),
                 "w": c["w"][lo:lo + bs].to(f64),
                 "j": negs[lo:lo + bs].long() if is_bpr else None}
                for lo in range(0, n_pad, bs)]

    def windows(e, step):
        batches = [rank_batches(e, d) for d in range(world)]
        pending = None
        for w in range(nb // T):
            dQ = torch.zeros_like(Q)
            for d in range(world):
                for b in batches[d][w * T:(w + 1) * T]:
                    step(b, dQ)
            if kw.get("overlap_psum"):
                if pending is not None:
                    Q.add_(pending)
                pending = dQ
            else:
                Q.add_(dQ)
        if pending is not None:
            Q.add_(pending)

    if is_bpr:
        def step(b, dQ):
            u_, i_, j_, w_ = b["u"], b["i"], b["j"], b["w"]
            pu, qi, qj = P[u_], Q[i_], Q[j_]
            s = torch.sigmoid(-(pu * (qi - qj)).sum(1)) * w_
            reg_w = (cfg.reg * w_)[:, None]
            P.index_add_(0, u_, lr * (s[:, None] * (qi - qj) - reg_w * pu) * umask)
            dQ.index_add_(0, i_, lr * (s[:, None] * pu - reg_w * qi) * imask)
            dQ.index_add_(0, j_, lr * (-s[:, None] * pu - reg_w * qj) * imask)

        for e in range(kw["n_epochs"]):
            windows(e, step)
        return P.cpu().numpy(), Q.cpu().numpy()

    lr_y, reg_y = cfg.lr, cfg.reg
    Y = torch.zeros_like(Q)
    uu = torch.from_numpy(u.astype(np.int64)).to(dev)
    ii = torch.from_numpy(i.astype(np.int64)).to(dev)
    wvec = torch.from_numpy(svdpp._neighbor_weights(u, nu, ucap)).to(dev, f64)
    deg = torch.zeros(Q.shape[0], dtype=f64, device=dev)
    deg.index_add_(0, ii, torch.ones(len(i), dtype=f64, device=dev))

    def implicit():
        S = torch.zeros_like(P)
        S.index_add_(0, uu, Y[ii])
        return S * wvec[:, None]

    for e in range(kw["n_epochs"]):
        S = implicit()
        A = torch.zeros_like(P)

        def step(b, dQ):
            u_, i_, w_ = b["u"], b["i"], b["w"]
            pu, qi = P[u_], Q[i_]
            eff = pu + S[u_]
            err = (b["r"] - (mu + (eff * qi).sum(1))) * w_
            reg_w = (cfg.reg * w_)[:, None]
            A.index_add_(0, u_, err[:, None] * qi * fmask)
            P.index_add_(0, u_, cfg.lr * (err[:, None] * qi - reg_w * pu) * umask)
            dQ.index_add_(0, i_, cfg.lr * (err[:, None] * eff - reg_w * qi) * imask)

        windows(e, step)
        gY = torch.zeros_like(Y)
        gY.index_add_(0, ii, A[uu] * wvec[uu][:, None])
        Y = Y + lr_y * (gY - reg_y * deg[:, None] * Y) * fmask
    return tuple(t.cpu().numpy() for t in (P, Q, Y, implicit()))


def check_gloo_6c(torch, inp, worlds):
    """The slice-6c fits of every gloo world: every rank's tables bit-equal
    to rank 0's and the same lists served, two tiled fits of one seed
    bit-equal, every table within 1e-5 of the float64 replay of the fit's
    own pack and draws (``family_mesh_f64``). The loss and the RMSE are only
    recorded: config 2's ratings carry no signal."""
    import numpy as np
    import pandas as pd

    u, i, r = inp["train"]
    X = pd.DataFrame({"user_id": u, "item_id": i})
    y = pd.Series(r)
    out = {}
    for world, ranks in worlds.items():
        res = {}
        for name, cls, kw in gloo_6c_models():
            got = ranks[0]["6c"][name]
            check(all(np.array_equal(a, b) for rk in ranks
                      for a, b in zip(rk["6c"][name]["tables"], got["tables"])),
                  f"gloo {world} {name}: the replicas differ across ranks")
            check(all(np.array_equal(rk["6c"][name]["batch"], got["batch"])
                      for rk in ranks),
                  f"gloo {world} {name}: the ranks served different lists")
            check(got["one"] == PAR["k"]
                  and len(got["batch"]) == PAR["k"] * len(inp["users"]),
                  f"gloo {world} {name}: served lists of another length")
            if "same_bits" in got:
                check(all(rk["6c"][name]["same_bits"] for rk in ranks),
                      f"gloo {world} {name}: two fits of one seed differ")
            replay = family_mesh_f64(torch, cls, kw, X, y, inp["seed"], world)
            err = max(float(np.abs(a - b).max())
                      for a, b in zip(got["tables"], replay))
            res[name] = {"max_abs_err_float64": err, "history": got["hist"]}
            check(err <= 1e-5, f"gloo {world} {name} off the float64 replay of "
                               f"its pack and draws by {err}")
            torch.cuda.empty_cache()
        out[f"world{world}"] = res
    return out


# ---------------------------------------------------------------------------
# The gram models on a mesh (slice 6d, part 1): EASE, the sparse gram's
# top-k and the dense CF models
# ---------------------------------------------------------------------------

# the gloo worlds' CF arguments at config 2's shape: config 4's 50
# neighbours, blocks and strips of 1,024 so that every rank holds blocks
GRAM_GLOO = {"block": 1024, "predict": 4096, "users": 256}


class NSRecorder:
    """Wraps ``ops/ease.py``'s ``ns_sharded_steps`` (the row-sharded
    Newton-Schulz steps that ``ease_weights_sharded`` runs) to record the
    step count, the last residual and the device memory the steps hold at
    their peak beyond what the process held before them without the
    padded rows (so: ``As``, ``P``, ``As P`` and the slab), the peak
    counter reset at the steps' start, after the gram has been let go."""

    def __init__(self, torch, max_iters=None):
        """``max_iters``: a cap on the steps handed to the wrapped call."""
        from matrix_factorization_tpu_torch.ops import ease as ease_ops

        self.torch, self.ease_ops, self.calls = torch, ease_ops, []
        self.cap = {} if max_iters is None else {"max_iters": max_iters}

    def __enter__(self):
        torch, orig = self.torch, self.ease_ops.ns_sharded_steps
        self.orig = orig

        def record(Ap, lay, *args, **kw):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated() - Ap.numel() * Ap.element_size()
            torch.cuda.reset_peak_memory_stats()
            info = {}
            t0 = time.perf_counter()
            P = orig(Ap, lay, *args, info=info, **{**kw, **self.cap})
            torch.cuda.synchronize()
            self.calls.append({
                # the residual is read on the axis' first rank (None elsewhere)
                "steps": info["steps"], "residual": info["residual"],
                "seconds": time.perf_counter() - t0, "dp": lay.dp, "dl": lay.dl,
                "blk": lay.blk, "rows": lay.hi - lay.lo,
                "peak_mib": (torch.cuda.max_memory_allocated() - base) / 2**20,
                "three_shards_mib": 3 * lay.dl * lay.dp * 4 / 2**20})
            return P

        self.ease_ops.ns_sharded_steps = record
        return self

    def __exit__(self, *exc):
        self.ease_ops.ns_sharded_steps = self.orig


def ease_identity_err(torch, G, B, reg, cols):
    """The closed form's identity ``(G + lam I)(I - B) = diag(1 / diag P)``
    on the columns ``cols`` of the whole ``B``: the largest off-diagonal
    entry over the smallest diagonal one, and whether the diagonal is
    positive."""
    from matrix_factorization_tpu_torch.ops.spd import exact_f32

    A = G.clone()
    A.diagonal().add_(reg)
    at = torch.arange(len(cols), device=G.device)
    IB = -B[:, cols]
    IB[cols, at] += 1.0
    with exact_f32():
        M = A @ IB
    diag = M[cols, at].clone()
    M[cols, at] = 0.0
    return float(M.abs().max() / diag.abs().min()), bool((diag > 0).all())


def ease_budget_data(seed):
    """EASE's interactions at the JAX package's one-rank budget
    (``phase_ease``): 100,000 users x 100 seeded items of 16,384, binary,
    each pair once (a repeat would send the gram to the f32 path)."""
    import numpy as np

    cfg = EASE_BUDGET
    gen = np.random.default_rng(seed)
    bu, bi = unique_plays(gen, cfg["n_users"], cfg["n_items"], cfg["per_user"])
    return bu, bi, np.ones(len(bu), np.float32), gen


def ml1m_gram_args(train):
    """Config 2's ratings as EASE's binary implicit feedback, dense ids."""
    import numpy as np

    u, i, _ = train
    return (u.astype(np.int64), i.astype(np.int64), np.ones(len(u), np.float32),
            ML1M["n_users"], ML1M["n_items"])


def phase_parallel_gram_nccl(torch, data3, train1m, item_lists, seed):
    """(f) The gram models at NCCL world size 1 in this process (inside
    ``nccl_world``): it drives the mesh paths and bypasses the collectives'
    wire (NCCL runs no kernel at world 1). Config 4's item-item fit at full
    scale, ``TopKItemItemCF(mesh=make_mesh(1))`` on the config-3 ratings
    (k=50, 4,096-row blocks, 4,096-column strips), held equal to the
    mesh-free lists (``item_lists``, the ``cf_topk`` phase's fit); EASE at its budget (16,384 items x 100,000 users x
    100): ``dp_item_gram`` equal to ``item_gram``, then
    ``ease_weights_sharded(inverse='ns')`` with the GJ count zeroed just
    before and read just after (0: Newton-Schulz has no leaf), ``B``
    within 5e-4 of the single-device ``ease_weights`` and the closed
    form's identity on 256 columns (1e-3), its steps, seconds and peak
    memory; then config 2's EASE gram through the same Newton-Schulz path
    (the world-1 peak the gloo world of 4 is read against)."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import TopKItemItemCF
    from matrix_factorization_tpu_torch.ops import ease as ease_ops
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1)
    out = {"phase": "parallel_gram", "part": "nccl_world_1", "backend": "nccl",
           "world": 1}
    u, i, r = data3[:3]
    X = pd.DataFrame({"user_id": u, "item_id": i})
    y = pd.Series(r)
    kw = dict(n_neighbors=CF4["n_neighbors"], user_block=CF4["block"],
              item_tile=CF4["block"], min_rating=0.5, max_rating=5.0)
    torch.cuda.reset_peak_memory_stats()
    model, out["config4_item_fit_seconds"] = timed(
        torch, lambda: TopKItemItemCF(mesh=mesh, **kw).fit(X, y))
    out["config4_item_fit_peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    same = (torch.equal(model._neighbor_sims.cpu(), item_lists[0])
            and torch.equal(model._neighbor_ids.cpu(), item_lists[1]))
    out["config4_equal_to_mesh_free"] = same
    check(same, "config 4 at world 1: the mesh fit's lists differ from the "
                "mesh-free fit's")
    del model, X, y
    torch.cuda.empty_cache()

    res = out["ease_budget"] = dict(EASE_BUDGET)
    bu, bi, w, gen = ease_budget_data(seed)
    args = (bu, bi, w, EASE_BUDGET["n_users"], EASE_BUDGET["n_items"])
    G1, res["gram_seconds"] = timed(torch, lambda: ease_ops.item_gram(
        *args, device="cuda"))
    Gd, res["dp_gram_seconds"] = timed(torch, lambda: ease_ops.dp_item_gram(
        *args, mesh, device="cuda"))
    res["dp_gram_equal"] = torch.equal(Gd, G1)
    check(res["dp_gram_equal"], "EASE at 16k: dp_item_gram differs from item_gram")
    del Gd
    B1, res["single_device_inverse_seconds"] = timed(
        torch, lambda: ease_ops.ease_weights(G1, EASE_BUDGET["reg"]))
    zero_launches("mf_gj_inverse")
    with NSRecorder(torch, max_iters=EASE_NS_STEPS) as rec:
        B, res["ns_seconds"] = timed(torch, lambda: ease_ops.ease_weights_sharded(
            ease_ops.dp_item_gram(*args, mesh, device="cuda"),
            EASE_BUDGET["reg"], mesh, inverse="ns"))
    res["gj_launches"] = n_launches("mf_gj_inverse")
    check(res["gj_launches"] == 0, f"EASE's Newton-Schulz path launched the "
                                   f"GJ leaf {res['gj_launches']} times")
    res["ns"] = rec.calls[0]
    res["B_max_abs_err_vs_single_device"] = float((B - B1).abs().max())
    check(bool(torch.isfinite(B).all()) and not B.diagonal().any()
          and res["B_max_abs_err_vs_single_device"] <= 5e-4,
          f"EASE at 16k by Newton-Schulz off the Schur B by "
          f"{res['B_max_abs_err_vs_single_device']}")
    cols = torch.from_numpy(np.sort(gen.choice(
        EASE_BUDGET["n_items"], EASE_BUDGET["oracle_columns"], replace=False))).cuda()
    res["identity_rel_err"], pos = ease_identity_err(torch, G1, B,
                                                     EASE_BUDGET["reg"], cols)
    check(res["identity_rel_err"] <= 1e-3 and pos,
          f"EASE at 16k by Newton-Schulz: (G + lam I)(I - B) off diagonal by "
          f"{res['identity_rel_err']}")
    del G1, B1, B
    torch.cuda.empty_cache()

    # config 2's gram through the same path: the world-1 peak of the steps
    with NSRecorder(torch) as rec:
        Bm = ease_ops.ease_weights_sharded(
            ease_ops.dp_item_gram(*ml1m_gram_args(train1m), mesh, device="cuda"),
            EASE_ML1M["reg"], mesh, inverse="ns")
    out["ml1m_ns"] = rec.calls[0]
    check(bool(torch.isfinite(Bm).all()), "config 2's EASE by Newton-Schulz")
    del Bm
    torch.cuda.empty_cache()
    return out


def gloo_gram_rank(rank, world, inp):
    """The gram models on one gloo rank on cuda:0, on ``make_mesh(world)``
    at config 2's shape, each with the GJ count zeroed just before and read
    just after: ``EASE(mesh=)`` (the Schur path: the GJ leaf on this rank)
    and its 256 users' catalog scores; ``TopKItemItemCF`` /
    ``TopKUserUserCF(mesh=)`` (k=50, blocks and strips of 1,024): the
    neighbour lists, means and 4,096 predictions; ``ItemItemCF`` /
    ``UserUserCF(mesh=)``: 4,096 predictions and the similarity rows held;
    on a world of 4, ``ease_weights_sharded(inverse='ns')`` forced on
    config 2's gram: this rank's rows of ``B`` and the steps' peak
    (``NSRecorder``); last, with ``inp['retrieval']``, the row-sharded
    retrieval (``gloo_retrieval_rank``)."""
    import numpy as np
    import pandas as pd
    import torch

    import matrix_factorization_tpu_torch as port
    from matrix_factorization_tpu_torch.ops import ease as ease_ops
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(world)
    u, i, r = inp["train"]
    X = pd.DataFrame({"user_id": u, "item_id": i})
    y = pd.Series(r)
    pairs = X.iloc[:GRAM_GLOO["predict"]]
    out = {"rank": rank}
    t0 = time.perf_counter()
    zero_launches("mf_gj_inverse")
    m = port.EASE(reg=EASE_ML1M["reg"], mesh=mesh).fit(X, y)
    torch.cuda.synchronize()
    out["ease"] = {"gj_launches": n_launches("mf_gj_inverse"), "sharding": m._sharding,
                   "rows": tuple(m._params.item_weights.shape),
                   "scores": m._catalog_scores_batch(
                       m.user_vocab.encode(inp["users"]))}
    del m
    kw = dict(n_neighbors=CF_NEIGHBOURS, user_block=GRAM_GLOO["block"],
              item_tile=GRAM_GLOO["block"], min_rating=0.5, max_rating=5.0,
              mesh=mesh)
    for cls in ("TopKItemItemCF", "TopKUserUserCF"):
        m = getattr(port, cls)(**kw).fit(X, y)
        out[cls] = {"sims": m._neighbor_sims.cpu().numpy(),
                    "ids": m._neighbor_ids.cpu().numpy(),
                    "means": m._means.cpu().numpy(),
                    "predict": np.asarray(m.predict(pairs))}
    for cls in ("ItemItemCF", "UserUserCF"):
        m = getattr(port, cls)(n_neighbors=CF_NEIGHBOURS, min_rating=0.5,
                               max_rating=5.0, mesh=mesh).fit(X, y)
        out[cls] = {"predict": np.asarray(m.predict(pairs)),
                    "sim": m._state.sim.cpu().numpy()}
    del m
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    if world == 4:
        torch.cuda.empty_cache()
        zero_launches("mf_gj_inverse")
        with NSRecorder(torch) as rec:
            B = ease_ops.ease_weights_sharded(
                ease_ops.dp_item_gram(*ml1m_gram_args(inp["train"]), mesh,
                                      device="cuda"),
                EASE_ML1M["reg"], mesh, inverse="ns")
        out["ns"] = {"B_rows": B.cpu().numpy(), **rec.calls[0],
                     "gj_launches": n_launches("mf_gj_inverse")}
    out["launches"] = {"spd_gj": out["ease"]["gj_launches"]}
    if "retrieval" in inp:
        out["retrieval"] = gloo_retrieval_rank(rank, world, inp["retrieval"])
    return out


def hold_lists(got, want):
    """JAX's bars for the sparse gram's top-k (``tests/test_cf_topk.py:
    172-193``): (sims err, means err, rows whose ids differ where the top
    two similarities are more than 1e-4 apart)."""
    import numpy as np

    top = np.sort(want[0], axis=1)
    gap = np.abs(top[:, -1] - top[:, -2])
    differ = ~(got[1] == want[1]).all(axis=1)
    return (float(np.abs(got[0] - want[0]).max()),
            float(np.abs(got[2] - want[2]).max()),
            int((differ & (gap > 1e-4)).sum()))


def phase_parallel_gram_gloo(torch, train1m, seed, ml1m_ns_peak_mib,
                             retrieval=None):
    """(g) The gram models on gloo ranks sharing the card (worlds of 2 and
    4 on cuda:0, side by side, ``gloo_gram_rank``) at config 2's shape,
    against the same
    models without a mesh here: EASE scores within 5e-4 and the GJ leaf
    launched on every rank; the top-k models' lists at JAX's bars (sims
    1e-5, means 1e-6, ids where separated by more than 1e-4) and
    predictions 1e-4; the dense models' predictions 1e-4 with
    ``ceil(E / W)`` similarity rows a rank, equal to the single-device
    matrix's rows; on the world of 4, the forced
    Newton-Schulz ``B`` within 5e-4 of Schur and each rank's peak during
    the steps below half of world 1's (``ml1m_ns_peak_mib``). With
    ``retrieval`` (``phase_parallel_retrieval``'s second result) the ranks
    also run the row-sharded retrieval, and ``check_gloo_retrieval``'s line
    comes back under ``parallel_retrieval``."""
    import numpy as np
    import pandas as pd

    import matrix_factorization_tpu_torch as port
    from matrix_factorization_tpu_torch.ops import ease as ease_ops
    from matrix_factorization_tpu_torch.parallel.launch import spawn_world

    rng = np.random.default_rng(seed)
    u, i, r = train1m
    inp = {"train": train1m,
           "users": rng.choice(np.unique(u), GRAM_GLOO["users"], replace=False)}
    if retrieval is not None:
        inp["retrieval"] = retrieval["inp"]
    out = {"phase": "parallel_gram", "part": "gloo", "backend": "gloo",
           "device": "cuda:0", "n_ratings": len(r)}
    # the two worlds side by side (six processes on the card), so that their
    # processes' starts overlap; each rank's own seconds are recorded
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        runs = {world: pool.submit(spawn_world, gloo_gram_rank, world, "gloo",
                                   "cuda:0", args=(inp,), timeout=600)
                for world in (2, 4)}
        worlds = {world: run.result() for world, run in runs.items()}
    out["worlds_seconds"] = time.perf_counter() - t0
    X = pd.DataFrame({"user_id": u, "item_id": i})
    y = pd.Series(r)
    pairs = X.iloc[:GRAM_GLOO["predict"]]
    m = port.EASE(reg=EASE_ML1M["reg"]).fit(X, y)
    want = {"ease": m._catalog_scores_batch(m.user_vocab.encode(inp["users"]))}
    G = ease_ops.item_gram(*ml1m_gram_args(train1m), device="cuda")
    B_schur = ease_ops.ease_weights(G, EASE_ML1M["reg"]).cpu().numpy()
    del m, G
    kw = dict(n_neighbors=CF_NEIGHBOURS, user_block=GRAM_GLOO["block"],
              item_tile=GRAM_GLOO["block"], min_rating=0.5, max_rating=5.0)
    for cls in ("TopKItemItemCF", "TopKUserUserCF"):
        m = getattr(port, cls)(**kw).fit(X, y)
        want[cls] = (m._neighbor_sims.cpu().numpy(), m._neighbor_ids.cpu().numpy(),
                     m._means.cpu().numpy(), np.asarray(m.predict(pairs)))
    E = {}  # the entities rated: the similarity matrix's side
    for cls in ("ItemItemCF", "UserUserCF"):
        m = getattr(port, cls)(n_neighbors=CF_NEIGHBOURS, min_rating=0.5,
                               max_rating=5.0).fit(X, y)
        want[cls] = (np.asarray(m.predict(pairs)), m._state.sim.cpu().numpy())
        E[cls] = m._state.sim.shape[0]
    del m
    torch.cuda.empty_cache()

    errs = {"ease": 0.0, "topk_sims": 0.0, "topk_means": 0.0, "topk_ids_wrong": 0,
            "topk_predict": 0.0, "dense_predict": 0.0}
    for world, ranks in worlds.items():
        for rk in ranks:
            e = rk["ease"]
            check(e["gj_launches"] > 0 and e["sharding"] == "rows",
                  f"gloo world {world} rank {rk['rank']}: EASE(mesh=) launched "
                  f"the GJ leaf {e['gj_launches']} times")
            errs["ease"] = max(errs["ease"],
                               float(np.abs(e["scores"] - want["ease"]).max()))
            for cls in ("TopKItemItemCF", "TopKUserUserCF"):
                g = rk[cls]
                s_err, m_err, wrong = hold_lists((g["sims"], g["ids"], g["means"]),
                                                 want[cls][:3])
                errs["topk_sims"] = max(errs["topk_sims"], s_err)
                errs["topk_means"] = max(errs["topk_means"], m_err)
                errs["topk_ids_wrong"] += wrong
                errs["topk_predict"] = max(errs["topk_predict"], float(
                    np.abs(g["predict"] - want[cls][3]).max()))
            for cls in ("ItemItemCF", "UserUserCF"):
                per = -(-E[cls] // world)
                lo = min(rk["rank"] * per, E[cls])
                sim = rk[cls]["sim"]
                check(sim.shape == (min(per, E[cls] - lo), E[cls]),
                      f"gloo world {world}: {cls} holds {sim.shape} "
                      f"similarity rows, not its {per} of {E[cls]}")
                check(np.array_equal(sim, want[cls][1][lo:lo + len(sim)]),
                      f"gloo world {world}: {cls}'s similarity rows differ "
                      f"from the single-device matrix's")
                errs["dense_predict"] = max(errs["dense_predict"], float(
                    np.abs(rk[cls]["predict"] - want[cls][0]).max()))
    out["max_errs"] = errs
    check(errs["ease"] <= 5e-4, f"gloo EASE(mesh=) scores off by {errs['ease']}")
    check(errs["topk_sims"] <= 1e-5 and errs["topk_means"] <= 1e-6
          and errs["topk_ids_wrong"] == 0 and errs["topk_predict"] <= 1e-4,
          f"gloo top-k CF on the mesh off the mesh-free fit: {errs}")
    check(errs["dense_predict"] <= 1e-4,
          f"gloo dense CF on the mesh off by {errs['dense_predict']}")

    ns = [rk["ns"] for rk in worlds[4]]
    B_ns = np.concatenate([n["B_rows"] for n in ns], axis=0)
    out["ns_world4"] = [{k: v for k, v in n.items() if k != "B_rows"} for n in ns]
    out["ns_world4_B_max_abs_err_vs_schur"] = float(np.abs(B_ns - B_schur).max())
    out["ns_world1_peak_mib"] = ml1m_ns_peak_mib
    check(B_ns.shape == B_schur.shape and not np.diagonal(B_ns).any()
          and out["ns_world4_B_max_abs_err_vs_schur"] <= 5e-4,
          f"gloo world 4: Newton-Schulz B off Schur by "
          f"{out['ns_world4_B_max_abs_err_vs_schur']}")
    check(len({n["steps"] for n in ns}) == 1 and all(n["gj_launches"] == 0 for n in ns),
          "gloo world 4: the ranks' Newton-Schulz steps differ, or it launched GJ")
    check(all(n["peak_mib"] < 0.5 * ml1m_ns_peak_mib for n in ns),
          f"gloo world 4: a rank's Newton-Schulz peak "
          f"{[n['peak_mib'] for n in ns]} MiB is not below half of world 1's "
          f"{ml1m_ns_peak_mib} MiB")
    out["rank_seconds"] = {w: [rk["seconds"] for rk in worlds[w]] for w in worlds}
    out["launches"] = {"spd_gj": sum(rk["launches"]["spd_gj"]
                                     for w in worlds.values() for rk in w)}
    if retrieval is not None:
        out["parallel_retrieval"] = check_gloo_retrieval(worlds, retrieval["want"])
    return out


# ---------------------------------------------------------------------------
# Retrieval, the hybrid evaluation and sharded checkpoints on a mesh
# ---------------------------------------------------------------------------

# parallel_retrieval at recipe_serve's catalog (RECIPE: 2,231,142 x 512
# dense, x 50,000 TF-IDF at vocab_block 1,024): 256 dense and 64 TF-IDF
# queries at NCCL world 1, the first 64 and 32 of them on the gloo worlds
# (cut for time); the pipeline stage's users
RETR = {"batch": 256, "tfidf_queries": 64, "gloo_batch": 64,
        "gloo_tfidf_queries": 32, "max_users": 200}


def retrieval_catalog(torch, rng, seed):
    """recipe_serve's catalog at full width, made anew: a dense index of
    2,231,142 seeded unit rows of 512, a TF-IDF index of a seeded
    l2-normalized 2,231,142 x 50,000 CSR (32 terms a row) with
    ``HashVectorizer``, 256 dense queries (catalog rows plus noise,
    normalized) and 64 recipe titles as TF-IDF queries."""
    from matrix_factorization_tpu_torch.retrieval import index as rindex

    R = RECIPE
    n, dim = R["n_items"], R["dim"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    E = torch.randn((n, dim), generator=g, device="cuda")
    E /= E.norm(dim=1, keepdim=True)
    pick = torch.randint(0, n, (RETR["batch"],), generator=g, device="cuda")
    Q = E[pick] + 0.5 * torch.randn((RETR["batch"], dim), generator=g,
                                    device="cuda") / dim ** 0.5
    Q /= Q.norm(dim=1, keepdim=True)
    emb, q = E.cpu().numpy(), Q.cpu().numpy()
    del E, Q
    ids, texts = list(range(n)), [""] * n
    dix = rindex.build_dense_index(ids, texts, emb, normalize=False)
    tix = rindex.TfidfItemIndex(item_ids=ids, texts=texts,
                                vectorizer=HashVectorizer(R["vocab"]),
                                matrix=tfidf_catalog(rng, n, R["vocab"], R["terms"]))
    _, titles = recipe_texts(rng, RETR["tfidf_queries"], RETR["tfidf_queries"])
    return dix, tix, q, titles


def hold_sharded_topk(got, want, tol=1e-5, tie=1e-6):
    """JAX's bars for a sharded top-k against the single-device one
    (``tests/test_retrieval_rank.py:253-278``): values within ``tol``,
    positions equal wherever the single-device value is at least ``tie``
    above the next. Returns (largest value error, positions compared)."""
    import numpy as np

    vals, pos = got
    wv, wp = want
    check(vals.shape == wv.shape and pos.shape == wp.shape,
          f"top-k of shape {vals.shape}, not {wv.shape}")
    err = float(np.abs(vals - wv).max())
    sep = np.concatenate([wv[:, :-1] - wv[:, 1:] >= tie,
                          np.ones((len(wv), 1), bool)], axis=1)
    bad = int(((pos != wp) & sep).sum())
    check(err <= tol and bad == 0,
          f"sharded top-k off the single-device one: values {err}, "
          f"{bad} separated positions differ")
    return err, int(sep.sum())


def gloo_retrieval_rank(rank, world, inp):
    """The row-sharded dense and TF-IDF top-k on one gloo rank on cuda:0,
    ``make_mesh(world)``: the catalog read from the phase's files (memory
    maps: the rank reads its rows alone), the rank's rows, seconds and
    peak device memory."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh
    from matrix_factorization_tpu_torch.parallel.topk import catalog_shard
    from matrix_factorization_tpu_torch.retrieval import index as rindex
    from matrix_factorization_tpu_torch.retrieval import search, sparse_scoring

    torch.backends.cuda.matmul.allow_tf32 = False
    d = Path(inp["dir"])
    emb = np.load(d / "emb.npy", mmap_mode="r")
    n = emb.shape[0]
    M = sp.csr_matrix(tuple(np.load(d / f"{a}.npy", mmap_mode="r")
                            for a in ("data", "indices", "indptr")),
                      shape=(n, inp["vocab"]))
    ids, texts = list(range(n)), [""] * n
    dix = rindex.build_dense_index(ids, texts, emb, normalize=False)
    tix = rindex.TfidfItemIndex(item_ids=ids, texts=texts,
                                vectorizer=HashVectorizer(inp["vocab"]), matrix=M)
    mesh = make_mesh(world)
    out = {"rank": rank, "rows": catalog_shard(n, mesh)[:2]}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out["dense"] = search.dense_topk_mesh(dix, inp["q"], inp["k"], mesh)
    out["dense_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["tfidf"] = sparse_scoring.tfidf_batch_topk(
        tix, inp["titles"], inp["k"], vocab_block=RECIPE["vocab_block"], mesh=mesh)
    out["tfidf_seconds"] = time.perf_counter() - t0
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    return out


def phase_parallel_retrieval(torch, rng, files_dir, seed, timer):
    """(a) Retrieval on a mesh at recipe_serve's catalog
    (``retrieval_catalog``), in the NCCL world of one rank (it drives the
    mesh paths and bypasses the collectives' wire):
    ``search_topk_batch(mesh=make_mesh(1))`` of 256 queries and
    ``tfidf_batch_topk(mesh=)`` of 64 at ``vocab_block`` 1,024, each equal
    to its mesh-free call; the dense search's device times (``Timer``):
    ``dense_topk`` alone, the mesh-free call and the mesh call. Then the
    catalog is written to ``files_dir`` for (b), which the gloo worlds of
    ``parallel_gram`` run (``gloo_retrieval_rank``, held by
    ``check_gloo_retrieval``). No hand-written kernel runs here: JAX's
    mesh retrieval reaches no Pallas kernel (a matmul and a scatter, then
    ``lax.top_k``), so the port's is ``torch.mm`` / ``addmm_`` and
    ``stable_topk``. Returns (the phase's line, (b)'s inputs and the
    single-device top-k they are held to)."""
    import numpy as np

    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh
    from matrix_factorization_tpu_torch.retrieval import search, sparse_scoring

    R = RECIPE
    n, dim, k, vb = R["n_items"], R["dim"], R["k"], R["vocab_block"]
    out = {"phase": "parallel_retrieval", "part": "nccl",
           "n_items": n, "dim": dim, "vocab": R["vocab"], "vocab_block": vb,
           "k": k, "hand_kernels": "none: torch.mm / addmm_ and stable_topk, "
           "as JAX's mesh retrieval reaches no Pallas kernel",
           "note": "NCCL at world size 1 drives the mesh paths and bypasses "
                   "the wire"}
    t0 = time.perf_counter()
    dix, tix, q, titles = retrieval_catalog(torch, rng, seed)
    out["data_seconds"] = time.perf_counter() - t0
    mesh = make_mesh(1)

    free = search.search_topk_batch(dix, q, k)
    got = search.search_topk_batch(dix, q, k, mesh=mesh)
    check(all(np.array_equal(a, b) for a, b in zip(got, free)),
          "search_topk_batch(mesh=make_mesh(1)) differs from the mesh-free call")
    emb_dev = search.device_embeddings(dix)
    qd = torch.from_numpy(q).cuda()
    out["search_batch_ms"] = timer.ms(lambda: search.dense_topk(emb_dev, qd, k),
                                      reps=10)
    out["search_topk_batch_ms"] = timer.ms(
        lambda: search.search_topk_batch(dix, q, k), reps=10)
    out["dense_topk_mesh_ms"] = timer.ms(
        lambda: search.dense_topk_mesh(dix, q, k, mesh), reps=10)
    out["search_batch_bound_ms"] = max(
        n * dim * 4 / HBM_BYTES_PER_S,
        2 * len(q) * n * dim / PEAK_FLOPS["float32"]) * 1e3
    out["queries"] = {"dense": len(q), "tfidf": len(titles)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    free_t = sparse_scoring.tfidf_batch_topk(tix, titles, k, vocab_block=vb)
    out["tfidf_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got_t = sparse_scoring.tfidf_batch_topk(tix, titles, k, vocab_block=vb,
                                            mesh=mesh)
    out["tfidf_mesh_seconds"] = time.perf_counter() - t0
    check(all(np.array_equal(a, b) for a, b in zip(got_t, free_t)),
          "tfidf_batch_topk(mesh=make_mesh(1)) differs from the mesh-free call")
    check(np.isfinite(free_t[0]).all() and free_t[0][:, 0].min() > 0,
          "a TF-IDF query scored nothing")
    del emb_dev, qd
    search._device_cache.pop(dix, None)

    # (b)'s catalog: written once, each gloo rank reads its rows
    t0 = time.perf_counter()
    d = Path(files_dir)
    M = tix.matrix
    np.save(d / "emb.npy", dix.embeddings)
    np.save(d / "data.npy", M.data)
    np.save(d / "indices.npy", M.indices.astype(np.int32))
    np.save(d / "indptr.npy", M.indptr.astype(np.int32))
    out["files_seconds"] = time.perf_counter() - t0
    out["files_bytes"] = sum(f.stat().st_size for f in d.iterdir())
    gloo = {"inp": {"dir": str(d), "vocab": R["vocab"], "k": k,
                    "q": q[:RETR["gloo_batch"]],
                    "titles": titles[:RETR["gloo_tfidf_queries"]]},
            "want": {"dense": tuple(a[:RETR["gloo_batch"]] for a in free),
                     "tfidf": tuple(a[:RETR["gloo_tfidf_queries"]] for a in free_t)}}
    return out, gloo


def check_gloo_retrieval(worlds, want):
    """(b) The row-sharded dense and TF-IDF top-k of every rank of
    ``parallel_gram``'s gloo worlds of 2 and 4 on the card (each rank its
    rows of the catalog, read from the files of (a)) against the
    single-device top-k at JAX's bars (values 1e-5, positions where the
    gap to the next is at least 1e-6), every rank the same. Returns the
    phase's line."""
    import numpy as np

    out = {"phase": "parallel_retrieval", "part": "gloo", "backend": "gloo",
           "device": "cuda:0", "queries": {k_: len(v[0]) for k_, v in want.items()},
           "note": "gloo ranks sharing one card: the multi-rank merge, not its "
                   "speed"}
    errs = {"dense": 0.0, "tfidf": 0.0}
    for world, ranks in worlds.items():
        for rk in ranks:
            got = rk["retrieval"]
            for name in errs:
                err, _ = hold_sharded_topk(got[name], want[name])
                errs[name] = max(errs[name], err)
                check(all(np.array_equal(a, b) for a, b in
                          zip(got[name], ranks[0]["retrieval"][name])),
                      f"gloo world {world}: the ranks' {name} top-k differ")
    out["max_abs_err"] = errs
    out["ranks"] = {w: [{k_: rk["retrieval"][k_] for k_ in (
        "rows", "dense_seconds", "tfidf_seconds", "peak_mib")} for rk in ranks]
        for w, ranks in worlds.items()}
    return out


def phase_hybrid_mesh(root):
    """(c) ``pipeline/evaluate_hybrid.py --mesh-devices 1`` on a pipeline
    root's artifacts (the stage starts one NCCL rank on the card), its
    report equal to the mesh-free run's on the same root and users; then
    ``--mesh-devices 2`` must raise on one card (NCCL takes one GPU a
    rank)."""
    from matrix_factorization_tpu_torch.pipeline import evaluate_hybrid

    argv = ["--root", str(root), "--alpha", "0.5", "--candidate-k",
            str(PIPE["candidate_k"]), "--max-users", str(RETR["max_users"])]
    out = {"phase": "parallel_retrieval", "part": "evaluate_hybrid",
           "max_users": RETR["max_users"]}
    reports = {}
    for name, extra in (("mesh_free", []), ("mesh_devices_1", ["--mesh-devices", "1"])):
        t0 = time.perf_counter()
        printed = run_cli(evaluate_hybrid, argv + extra)
        out[f"{name}_seconds"] = time.perf_counter() - t0
        reports[name] = json.loads([x for x in printed.splitlines()
                                    if x.startswith("{")][-1])
    out["report"] = reports["mesh_devices_1"]
    check(reports["mesh_devices_1"] == reports["mesh_free"],
          f"--mesh-devices 1 reported {reports['mesh_devices_1']}, the mesh-free "
          f"run {reports['mesh_free']}")
    check(all(v["n_users"] > 0 for v in out["report"].values()),
          f"evaluate_hybrid evaluated no user: {out['report']}")
    try:
        run_cli(evaluate_hybrid, argv + ["--mesh-devices", "2"])
        raised = None
    except ValueError as e:
        raised = str(e)
    check(raised is not None and "GPUs" in raised,
          "--mesh-devices 2 on one card did not raise")
    out["mesh_devices_2_raised"] = raised
    return out


def hybrid_root(torch, rng, train1m, tmpdir):
    """A small pipeline root for ``phase_hybrid_mesh`` when the pipeline
    phase has not made one (``tools/run_parallel.py``): config 2's ratings
    (string item ids), seeded recipe texts, 512-wide embeddings and the
    dense index, a ``BaselineModel`` by ALS; every stage through its
    ``main()`` on the card."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch.pipeline import (
        build_item_embeddings, export_artifacts, train)

    root = Path(tmpdir) / "hybrid_root"
    (root / "data").mkdir(parents=True)
    u, i, r = train1m
    names = np.asarray([str(j) for j in range(ML1M["n_items"])], dtype=object)
    pd.DataFrame({"user_id": u.astype(np.int64), "item_id": names[i],
                  "rating": r}).to_parquet(root / "data" / "ratings.parquet",
                                           index=False)
    texts, _ = recipe_texts(rng, ML1M["n_items"], ML1M["n_items"])
    pd.DataFrame({"item_id": names, "text": texts}).to_parquet(
        root / "data" / "items.parquet", index=False)
    at = ["--root", str(root)]
    run_cli(build_item_embeddings, at + ["--dim", str(PIPE["dim"])])
    run_cli(export_artifacts, at)
    run_cli(train, at + ["--model", "baseline", "--method", "als", "--epochs",
                         str(PIPE_BASELINE_KW["n_epochs"]), "--reg",
                         str(PIPE_BASELINE_KW["reg"])])
    return root


# sharded_checkpoint: config 2's ratings at config 3's width on
# parallel_gloo's worlds (its batch and epochs); config 3 at NCCL world 1,
# fitted for one epoch (cut for time: the checkpoint, not the fit, is
# measured)


def gloo_ckpt_rank(world, inp, X, y, kw, fitted):
    """The sharded checkpoints on one gloo rank of ``parallel_gloo``'s
    worlds: ``KernelMF(keep_sharded=True)`` by SGD (``kw``) on
    ``make_mesh(world)``, and on a world of 4 the 2 x 2 fit the rank
    already made (``fitted``), through ``save_model_sharded`` and
    ``load_model_sharded(mesh=)`` into ``inp['ckpt_dir']``: the shards
    before and after, the served lists of both models, ``predict`` of
    both, the meshless load against the gathered tables, the seconds and
    bytes; the step, apply and scorer launches (the scorer's in the
    restored model's serving), counted apart from the rank's others."""
    import numpy as np
    import torch

    from matrix_factorization_tpu_torch import (
        KernelMF, load_model_sharded, save_model_sharded)
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    import torch.distributed.checkpoint  # noqa: F401 (its import, timed apart)

    out = {"dcp_import_seconds": time.perf_counter() - t0, "cells": {}}
    pairs = X.iloc[:4096]
    users = list(inp["users"])
    n_step, n_apply, n_score = (n_launches(*STEP), n_launches("mf_segment_apply"),
                                n_launches("mf_score_catalog"))
    for shape in [(world, 1)] + ([(2, 2)] if world == 4 else []):
        tag = f"{shape[0]}x{shape[1]}"
        res = {}
        m = fitted.get(tag)
        if m is None:
            t0 = time.perf_counter()
            m = KernelMF(mesh=make_mesh(*shape), keep_sharded=True, **kw).fit(X, y)
            torch.cuda.synchronize()
            res["fit_seconds"] = time.perf_counter() - t0
        mesh = m.mesh
        path = f"{inp['ckpt_dir']}/w{world}_{tag}"
        t0 = time.perf_counter()
        save_model_sharded(m, path)
        res["save_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        m2 = load_model_sharded(path, mesh=mesh)
        torch.cuda.synchronize()
        res["load_seconds"] = time.perf_counter() - t0
        n0 = n_launches("mf_score_catalog")
        recs2 = m2.recommend_batch(users, amount=PAR["k"], bound_ratings=False)
        torch.cuda.synchronize()
        res["serve_launches"] = n_launches("mf_score_catalog") - n0
        recs = m.recommend_batch(users, amount=PAR["k"], bound_ratings=False)
        whole = m._whole_params()
        m3 = load_model_sharded(path)
        res.update({
            "sharding": (m._sharding, m2._sharding, m2.keep_sharded,
                         m2.mesh is mesh),
            "equal": [torch.equal(a, b) for a, b in zip(m._params, m2._params)],
            "rows": [tuple(t.shape) for t in m2._params[:2]],
            "whole_rows": [tuple(t.shape) for t in whole[:2]],
            "recs_equal": bool(recs.equals(recs2)),
            "predict_err": float(np.abs(np.asarray(m.predict(pairs))
                                        - np.asarray(m2.predict(pairs))).max()),
            "meshless_equal": [torch.equal(a, b) for a, b in zip(m3._params, whole)],
            "meshless_state": (m3.keep_sharded, m3.mesh, m3._sharding,
                               str(m3._params.user_features.device)),
            "bytes": sum(f.stat().st_size for f in Path(path).rglob("*")
                         if f.is_file()),
        })
        out["cells"][tag] = res
        del m, m2, m3, whole
    fitted.clear()
    torch.cuda.empty_cache()
    out["launches"] = {"sgd_step": n_launches(*STEP) - n_step,
                       "segment_apply": n_launches("mf_segment_apply") - n_apply,
                       "score_catalog": n_launches("mf_score_catalog") - n_score}
    return out


def check_gloo_ckpt(worlds):
    """(a) ``save_model_sharded`` / ``load_model_sharded(mesh=)`` on
    ``parallel_gloo``'s worlds of 2 and 4 sharing the card, at config 2's
    shape and config 3's width (``gloo_ckpt_rank``): every rank's restored
    shards equal to its saved ones and fewer rows than the whole table (P;
    Q too on the 2 x 2 mesh), the restored model's lists equal to the
    fitted model's, ``predict`` within 1e-6, the scorer launched on every
    rank when the restored model serves, the meshless load equal to the
    gathered tables and not ``keep_sharded``. Returns the phase's line."""
    out = {"phase": "sharded_checkpoint", "part": "gloo", "backend": "gloo",
           "device": "cuda:0", "epochs": PAR["gloo_epochs"],
           "n_factors": N_FACTORS, "batch_size": PAR["gloo_bs"]}
    launches = {"sgd_step": 0, "segment_apply": 0, "score_catalog": 0}
    worst = 0.0
    cells = {}
    for world, ranks in worlds.items():
        for rk in ranks:
            ck = rk["ckpt"]
            for k_ in launches:
                launches[k_] += ck["launches"][k_]
            for tag, res in ck["cells"].items():
                where = f"gloo world {world} rank {rk['rank']} mesh {tag}"
                sharding = "2d" if tag == "2x2" else "1d"
                check(res["sharding"] == (sharding, sharding, True, True),
                      f"{where}: layout {res['sharding']}")
                check(all(res["equal"]), f"{where}: a restored shard differs")
                check(res["rows"][0][0] < res["whole_rows"][0][0]
                      and (tag != "2x2" or res["rows"][1][0] < res["whole_rows"][1][0]),
                      f"{where}: holds {res['rows']} of {res['whole_rows']}")
                check(res["recs_equal"], f"{where}: the restored lists differ")
                check(res["predict_err"] <= 1e-6,
                      f"{where}: predict off by {res['predict_err']}")
                check(res["serve_launches"] > 0,
                      f"{where}: the restored model's serving missed the scorer")
                check(all(res["meshless_equal"])
                      and res["meshless_state"][:3] == (False, None, None),
                      f"{where}: the meshless load {res['meshless_state']}")
                worst = max(worst, res["predict_err"])
                cells.setdefault(f"w{world}_{tag}", []).append(
                    {k_: res.get(k_) for k_ in ("fit_seconds", "save_seconds",
                                                 "load_seconds", "bytes", "rows",
                                                 "whole_rows", "serve_launches")})
    out["cells"] = cells
    out["dcp_import_seconds"] = [rk["ckpt"]["dcp_import_seconds"]
                                 for ranks in worlds.values() for rk in ranks]
    out["rank_seconds"] = {w: [rk["ckpt_seconds"] for rk in worlds[w]]
                           for w in worlds}
    out["predict_max_abs_err"] = worst
    out["launches"] = launches
    check(all(v > 0 for v in launches.values()),
          f"the sharded checkpoint path missed a kernel: {launches}")
    return out


def phase_sharded_checkpoint_nccl(torch, data3, seed, tmpdir):
    """(b) In the NCCL world of one rank: ``KernelMF(mesh=make_mesh(1))`` at
    config 3 (sigmoid, k=200, bs 2,097,152, one epoch) through
    ``save_model_sharded`` / ``load_model_sharded(mesh=)`` and through
    ``save_model`` / ``load_model``: each round trip's tables equal to the
    fit's and ``predict`` equal; the seconds and bytes of each save and
    load."""
    import numpy as np
    import pandas as pd

    from matrix_factorization_tpu_torch import (
        KernelMF, load_model, load_model_sharded, save_model, save_model_sharded)
    from matrix_factorization_tpu_torch.parallel.mesh import make_mesh

    u, i, r = data3[:3]
    X = pd.DataFrame({"user_id": u, "item_id": i})
    mesh = make_mesh(1)
    out = {"phase": "sharded_checkpoint", "part": "nccl", "world": 1,
           "n_ratings": len(r), "epochs": 1}
    t0 = time.perf_counter()
    import torch.distributed.checkpoint  # noqa: F401 (its import, timed apart)

    out["dcp_import_seconds"] = time.perf_counter() - t0
    zero_launches(*STEP, "mf_segment_apply")
    t0 = time.perf_counter()
    m = KernelMF(n_factors=N_FACTORS, kernel="sigmoid", gamma=1.0 / N_FACTORS,
                 min_rating=0.5, max_rating=5.0, n_epochs=1, mesh=mesh,
                 **CONFIG3["sigmoid"], seed=seed).fit(X, pd.Series(r))
    torch.cuda.synchronize()
    out["fit_seconds"] = time.perf_counter() - t0
    out["launches"] = {"sgd_step": n_launches(*STEP),
                       "segment_apply": n_launches("mf_segment_apply")}
    pairs = X.iloc[:4096]
    want = np.asarray(m.predict(pairs))
    for name, save, load in (
            ("dcp", save_model_sharded, lambda p: load_model_sharded(p, mesh=mesh)),
            ("npz", save_model, load_model)):
        path = Path(tmpdir) / f"ckpt_{name}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(m, path)
        out[f"{name}_save_seconds"] = time.perf_counter() - t0
        out[f"{name}_bytes"] = sum(f.stat().st_size for f in path.rglob("*")
                                   if f.is_file())
        t0 = time.perf_counter()
        m2 = load(path)
        torch.cuda.synchronize()
        out[f"{name}_load_seconds"] = time.perf_counter() - t0
        check(all(torch.equal(a, b) for a, b in zip(m._params, m2._params)),
              f"the {name} round trip changed the tables")
        check(np.array_equal(np.asarray(m2.predict(pairs)), want),
              f"the {name} round trip's predictions differ")
        del m2
        shutil.rmtree(path)
    out["table_bytes"] = sum(t.numel() * t.element_size() for t in m._params)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import numpy as np

    from matrix_factorization_tpu_torch.core.config import SGDConfig
    from matrix_factorization_tpu_torch.ops import _build, cuda_scores, cuda_sgd, ials
    from matrix_factorization_tpu_torch.ops import segment_sgd as sgd

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    secs = _build.build(sources)
    ptxas = ptxas_summary(_build.build_logs.values())
    emit({"phase": "build", "sources": sources, "seconds": secs,
          "ptxas": ptxas})
    spilled = [k for k in ptxas if k[2] and any(
        n in k[0] for n in ("score_stream", "score_tile", "gj_inverse",
                            "sgd_step_kernel", "step_finish", "segsum",
                            "apply_", "topk_", "ease_gram", "normal_eq",
                            "spd_split", "block_solve"))]
    check(not spilled, f"the scorer, the GJ leaf, the SGD step, the segment "
                       f"sum, the apply, the top-k, the EASE gram, the "
                       f"normal equations or the block solve spill: {spilled}")

    # -- serving (slice 1) -------------------------------------------------
    rng = np.random.default_rng(args.seed)
    worst = phase_compare(torch, rng, SGDConfig, cuda_scores)

    zero_launches("mf_score_catalog")
    launches = lambda: n_launches("mf_score_catalog")  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    models = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        for kernel in ("sigmoid", "rbf"):
            models[kernel], out = phase_serve(torch, rng, kernel, tmpdir, launches)
            emit(out)
    main_path_launches = launches()
    check(main_path_launches > 0, "the serving path launched no kernel")
    latency = {k: phase_latency(torch, rng, m) for k, m in models.items()}
    latency["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    emit({"phase": "latency", **latency})
    models.clear()

    timer = Timer(torch)
    rows = phase_kernel_times(torch, rng, SGDConfig, cuda_scores, timer)
    topk_rows = phase_topk_kernel_times(torch, timer)
    zero_launches("mf_topk_select")
    head = next(r for r in rows if r["B"] == 256 and r["kernel"] == "sigmoid"
                and r["dtype"] == "float32")

    # -- training (slice 2): data and packs, made once ---------------------
    t0 = time.perf_counter()
    u3, i3, r3 = gen_ratings(N_USERS, N_ITEMS, N_RATINGS + N_HELD_OUT,
                             args.seed)
    data3 = (u3[:N_RATINGS], i3[:N_RATINGS], r3[:N_RATINGS],
             u3[N_RATINGS:], i3[N_RATINGS:])
    t_config3 = time.perf_counter() - t0
    head_data = headline_ratings(args.seed)
    small = gen_ratings(5000, 3000, 200_000, args.seed + 1)
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "config3_seconds": t_config3,
          "config3_ratings": N_RATINGS, "held_out": N_HELD_OUT,
          "config3_users_rated": int(np.unique(data3[0]).size)})
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        emit(phase_host_native(torch, data3, tmpdir, args.seed))
    packs, pack_seconds = {}, {}
    for name, (u, i, r), bs in (
            ("sigmoid", data3[:3], CONFIG3["sigmoid"]["batch_size"]),
            ("rbf", data3[:3], CONFIG3["rbf"]["batch_size"]),
            ("headline", head_data, HEAD["batch_size"]),
            ("small", small, 16_384)):
        t0 = time.perf_counter()
        packs[name] = sgd.pack_ratings(u, i, r, bs, order="auto", device="cuda")
        torch.cuda.synchronize()
        pack_seconds[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    packs["skewed"] = skewed_pack(N_USERS, N_ITEMS,
                                  CONFIG3["sigmoid"]["batch_size"], args.seed)
    pack_seconds["skewed"] = time.perf_counter() - t0
    emit({"phase": "pack", "seconds": pack_seconds,
          "primary": {k: v.primary for k, v in packs.items()},
          "n_batches": {k: v.n_batches for k, v in packs.items()}})

    cases = [
        ("config3_sigmoid", sgd_cfg("sigmoid", N_FACTORS, 0.01, 2_097_152),
         packs["sigmoid"], 0, N_USERS, N_ITEMS),
        ("config3_rbf", sgd_cfg("rbf", N_FACTORS, 0.05, 1_048_576),
         packs["rbf"], 0, N_USERS, N_ITEMS),
        ("config3_skewed", sgd_cfg("sigmoid", N_FACTORS, 0.01, 2_097_152),
         packs["skewed"], 0, N_USERS, N_ITEMS),
        ("headline_linear", sgd_cfg("linear", HEAD["n_factors"], HEAD["lr"],
                                    HEAD["batch_size"], reg=HEAD["reg"]),
         packs["headline"], 0, HEAD["n_users"], HEAD["n_items"]),
        ("ragged_k126_sigmoid", sgd_cfg("sigmoid", 126, 0.05, 16_384),
         packs["small"], 1, 5000, 3000),
        ("frozen_items_sigmoid", sgd_cfg("sigmoid", HEAD["n_factors"], 0.05,
                                         HEAD["batch_size"],
                                         update_item_params=False),
         packs["headline"], 1, HEAD["n_users"], HEAD["n_items"]),
    ]
    # the sweep's own pack and launch plan (config 1: linear, k=100, bs
    # 4,096), at the grid's largest lr and reg; the last batch holds pads
    sweep_in = sweep_inputs(args.seed)
    sweep_cfg = dataclasses.replace(sweep_in["cfg"], lr=0.05, reg=0.5)
    cases += [(f"config1_sweep_linear_batch{k}", sweep_cfg, sweep_in["data"],
               k, sweep_in["n_users"], sweep_in["n_items"])
              for k in (0, sweep_in["data"].n_batches - 1)]
    check(packs["headline"].primary == "item", "the headline pack is item-primary")
    sgd_worst = phase_compare_sgd(torch, rng, cases)

    train_launches = {"sgd_step": 0, "segment_apply": 0}
    for kernel in ("sigmoid", "rbf"):
        out = phase_train(torch, rng, kernel, data3, packs[kernel],
                          pack_seconds[kernel], args.seed)
        for k in train_launches:
            train_launches[k] += out["launches"][k]
        emit(out)
    check(all(v > 0 for v in train_launches.values()),
          f"the training path missed a kernel: {train_launches}")

    t0 = time.perf_counter()
    golden = phase_golden(torch)
    golden["seconds"] = time.perf_counter() - t0
    emit(golden)
    emit(phase_train_headline(torch, head_data, packs["headline"],
                              pack_seconds["headline"], args.seed, smi))
    sgd_rows = phase_sgd_kernel_times(torch, rng, [
        (name, cases[k][1], packs[pk], *cases[k][4:])
        for name, k, pk in (("config3_sigmoid", 0, "sigmoid"),
                            ("config3_rbf", 1, "rbf"),
                            ("config3_skewed", 2, "skewed"),
                            ("headline_linear", 3, "headline"))] + [
        ("config1_sweep_linear", sweep_cfg, sweep_in["data"],
         sweep_in["n_users"], sweep_in["n_items"])], timer)

    # -- factor ALS (slice 3) ------------------------------------------------
    packs.clear()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t0 = time.perf_counter()
    buckets = ials.group_both_sides_bucketed(*data3[:3], N_USERS, N_ITEMS)
    torch.cuda.synchronize()
    emit({"phase": "als_pack", "seconds": time.perf_counter() - t0,
          "chunks": [[(int(b.other_ids.shape[0]), int(b.other_ids.shape[1]))
                      for b in side] for side in buckets]})
    # the leaves of the first full user chunk's solve against the seeded
    # initial item table (the first sweep of a fit)
    cfg_als = SGDConfig(kernel="linear", n_factors=ALS["n_factors"],
                        reg=ALS["reg"], min_rating=0.5, max_rating=5.0)
    p_init = sgd.init_params(torch.Generator(device="cuda").manual_seed(args.seed),
                             N_USERS, N_ITEMS, cfg_als, float(data3[2].mean()))
    # the launches of the ALS kernels (the normal equations, the block
    # solve's split and back-solve) on each ALS path, counted from here
    # (every earlier phase runs none)
    als_entries = ("mf_normal_eq", "mf_spd_split", "mf_spd_block_solve")
    zero_launches(*als_entries)
    als_launches = {e: {} for e in als_entries}
    ne_launches = als_launches["mf_normal_eq"]

    def ne_mark(path):
        for e, by_path in als_launches.items():
            by_path[path] = n_launches(e) - sum(by_path.values())

    def als_check(paths, what):
        missed = {e: {p: by_path[p] for p in paths}
                  for e, by_path in als_launches.items()}
        check(all(v > 0 for by_path in missed.values() for v in by_path.values()),
              f"{what} missed an ALS kernel: {missed}")

    ne_rows, ne_worst = phase_normal_eq(torch, buckets, p_init, cfg_als,
                                        ALS["reg_scale"], timer)
    ch = first_full_chunk(buckets[0])
    A, rhs = ials.normal_equations(p_init.item_features, ch.other_ids, ch.ratings,
                                   ch.mask, p_init.global_mean, cfg_als, "user",
                                   reg_scale=ALS["reg_scale"])
    bs_rows = phase_spd_block_solve(torch, A, rhs, timer)
    ne_mark("kernel_checks")
    real = list(zip(("config3_chunk_A11", "config3_chunk_schur"),
                    chunk_leaves(torch, A)))
    del A, rhs, p_init
    spd_worst = phase_compare_spd(torch, gen, real)
    del real
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        train_als = phase_train_als(torch, rng, data3, args.seed, tmpdir)
    emit(train_als)
    ne_mark("train_als")
    emit(phase_als_sweeps(torch, data3, buckets, args.seed))
    ne_mark("als_sweeps")
    del buckets
    torch.cuda.empty_cache()
    warm = phase_warm_start(torch, data3, args.seed)
    emit(warm)
    ne_mark("warm_start")
    als_check(("kernel_checks", "train_als", "als_sweeps", "warm_start"), "an ALS path")
    implicit = phase_implicit(torch, args.seed)
    emit(implicit)
    spd_rows = phase_spd_kernel_times(torch, gen, timer)
    spd_launches = {"train_als": train_als["launches"],
                    "warm_start": warm["launches"]["spd_gj"],
                    "implicit": implicit["launches"]}
    # -- BPR, SVD++, NMF and Popularity at the MovieLens-25M shape -----------
    t0 = time.perf_counter()
    fam_pack = sgd.pack_ratings(*data3[:3], FAM["batch_size"],
                                shuffle_seed=args.seed, order="user",
                                device="cuda")
    torch.cuda.synchronize()
    fam_pack_seconds = time.perf_counter() - t0
    fam = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        for family in ("BPR", "SVDpp", "NMF"):
            fam[family] = phase_family(torch, rng, family, data3, fam_pack,
                                       fam_pack_seconds, tmpdir, args.seed)
            emit(fam[family])
        emit(phase_popularity(rng, data3, tmpdir))
    fam_rows = phase_family_kernel_times(torch, rng, fam_pack, timer)
    del fam_pack
    torch.cuda.empty_cache()
    # -- sparse-gram top-k CF at config 4 ------------------------------------
    cf4_out, cf4_item_lists = phase_cf_topk(torch, rng, data3)
    emit(cf4_out)
    torch.cuda.empty_cache()

    # -- bias, neighbourhood and content models, the sweep -----------------
    t0 = time.perf_counter()
    train1m, held1m = ml1m_ratings(args.seed)
    emit({"phase": "ml1m_data", "seconds": time.perf_counter() - t0, **ML1M})
    segsum_worst = phase_compare_segsum(torch, rng, train1m)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        baseline = phase_baseline(torch, rng, train1m, held1m, tmpdir,
                                  args.seed)
    emit(baseline)
    emit(phase_cf(torch, rng, train1m))
    content = phase_content(torch, rng, train1m, held1m, args.seed)
    emit(content)
    sweep_out = phase_sweep(torch, sweep_in, args.seed)
    emit(sweep_out)
    segsum_rows = phase_segsum_kernel_times(torch, rng, train1m, timer)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        ease_out, ease_launches, gram_launches, leaves = phase_ease(
            torch, rng, train1m, tmpdir, args.seed)
    emit(ease_out)
    gram_rows, gram_launches["kernel_time"] = phase_ease_gram_kernel_time(
        torch, timer, args.seed)
    spd_launches["ease"] = sum(ease_launches.values())
    ease_rows, ease_worst = phase_ease_leaf_times(torch, leaves, timer)
    spd_rows += ease_rows
    spd_worst = max(spd_worst, ease_worst)
    del leaves
    # -- the recipe recommender's serving path at RecipeNLG's catalog --------
    # top-k kernel launches of the phases since the kernel's timing phase;
    # the recipe phase resets the counter before its main path
    topk_launches = {"before_recipe": n_launches("mf_topk_select")}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        recipe = phase_recipe_serve(torch, rng, train1m, tmpdir, args.seed, timer)
    emit(recipe)
    topk_launches.update(recipe["topk_launches"])
    # -- the batch pipeline at MovieLens-25M -----------------------------------
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        pipeline = phase_pipeline(torch, rng, data3, tmpdir, args.seed)
        emit(pipeline)
        # the pipeline's artifacts, evaluated with --mesh-devices 1
        t1 = time.perf_counter()
        hybrid_mesh = phase_hybrid_mesh(Path(tmpdir) / "pipeline")
        hybrid_mesh["seconds"] = time.perf_counter() - t1
        emit(hybrid_mesh)
    # -- multi-device KernelMF, ALS, the bias models and NMF -------------------
    # the recipe catalog's files, from parallel_retrieval to parallel_gram's
    # gloo worlds
    retrieval_files = tempfile.TemporaryDirectory(dir=_build.BUILD_DIR)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir, \
            nccl_world(torch, tmpdir):
        par_nccl, par_packs = phase_parallel_nccl(
            torch, rng, data3, r3[N_RATINGS:], args.seed)
        par_nccl["seconds"] = time.perf_counter() - t0
        emit(par_nccl)
        par_rows, par_worst = phase_parallel_kernels(torch, rng, par_packs,
                                                     train1m, timer)
        del par_packs
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ne_mark("before_parallel_als")
        par_als = phase_parallel_als(torch, rng, data3, train1m, args.seed)
        par_als["seconds"] = time.perf_counter() - t1
        emit(par_als)
        ne_mark("parallel_als")
        als_check(("parallel_als",), "dp ALS at one NCCL rank")
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        par_fam = phase_parallel_families(torch, rng, data3, args.seed)
        par_fam["seconds"] = time.perf_counter() - t1
        emit(par_fam)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        par_gram = phase_parallel_gram_nccl(torch, data3, train1m,
                                            cf4_item_lists, args.seed)
        par_gram["seconds"] = time.perf_counter() - t1
        emit(par_gram)
        del cf4_item_lists
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        retrieval, retrieval_gloo = phase_parallel_retrieval(
            torch, rng, retrieval_files.name, args.seed, timer)
        retrieval["seconds"] = time.perf_counter() - t1
        emit(retrieval)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ckpt_nccl = phase_sharded_checkpoint_nccl(torch, data3, args.seed, tmpdir)
        ckpt_nccl["seconds"] = time.perf_counter() - t1
        emit(ckpt_nccl)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    par_gloo = phase_parallel_gloo(torch, train1m, args.seed)
    par_gloo["seconds"] = time.perf_counter() - t1
    ckpt_gloo = par_gloo.pop("sharded_checkpoint")
    emit(par_gloo)
    emit(ckpt_gloo)
    t1 = time.perf_counter()
    par_gram_gloo = phase_parallel_gram_gloo(torch, train1m, args.seed,
                                             par_gram["ml1m_ns"]["peak_mib"],
                                             retrieval_gloo)
    par_gram_gloo["seconds"] = time.perf_counter() - t1
    retrieval_files.cleanup()
    retrieval = par_gram_gloo.pop("parallel_retrieval")
    emit(par_gram_gloo)
    emit(retrieval)
    ckpt_launches = {k: ckpt_gloo["launches"][k] + ckpt_nccl["launches"].get(k, 0)
                     for k in ckpt_gloo["launches"]}
    par_launches = {k: (par_nccl["launches"][k], par_gloo["launches"][k])
                    for k in ("sgd_step", "segment_apply", "score_catalog")}
    par_launches["score_catalog"] += (par_als["launches"]["score_catalog"],
                                      par_fam["launches"]["score_catalog"])
    del data3
    pipe_launches = pipeline["launches"]
    for name in sgd_worst:
        sgd_worst[name] = max(sgd_worst[name], recipe["compare_sgd"][name])
    segsum_launches = {"baseline_als": baseline["launches"]["als"],
                       "baseline_sgd": baseline["launches"]["sgd"],
                       "content": content["launches"]}
    check(all(v > 0 for v in segsum_launches.values()),
          f"a path of the slice missed the segment sum: {segsum_launches}")
    segsum_launches["nmf"] = fam["NMF"]["launches"]
    segsum_launches["pipeline"] = pipe_launches["segment_sum"]
    segsum_launches["parallel_als"] = par_als["launches"]["segment_sum"]
    segsum_launches["parallel_gloo"] = par_gloo["launches"]["segment_sum"]
    spd_launches["parallel_als"] = par_als["launches"]["spd_gj"]
    spd_launches["parallel_gloo"] = par_gloo["launches"]["spd_gj"]
    spd_launches["parallel_gram"] = par_gram_gloo["launches"]["spd_gj"]
    check(spd_launches["parallel_gram"] > 0,
          "the gloo ranks' EASE(mesh=) fits missed the GJ leaf")

    kernels = [{
        "name": "score_catalog", "route": "cuda",
        "source": "matrix_factorization_tpu_torch/csrc/score_catalog.cu",
        "replaces": "matrix_factorization_tpu/ops/pallas_scores.py:34",
        "launches": (main_path_launches + sweep_out["launches"]["score_catalog"]
                     + sum(f["score_launches"] for f in fam.values())
                     + pipe_launches["score_catalog"]
                     + sum(par_launches["score_catalog"])
                     + ckpt_launches["score_catalog"]),
        "launches_by_path": {"serve": main_path_launches,
                             "sweep": sweep_out["launches"]["score_catalog"],
                             **{k.lower(): f["score_launches"]
                                for k, f in fam.items()},
                             "pipeline": pipe_launches["score_catalog"],
                             "parallel": par_launches["score_catalog"][0],
                             "parallel_gloo": par_launches["score_catalog"][1],
                             "parallel_als": par_launches["score_catalog"][2],
                             "parallel_families": par_launches["score_catalog"][3],
                             "sharded_checkpoint": ckpt_launches["score_catalog"]},
        "max_abs_err": worst,
        "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": {k: head[k] for k in ("B", "I", "Kp", "kernel", "dtype")},
        "shapes": rows, "serving": latency,
    }]
    for name, source, replaces, note in (
            ("sgd_step", "sgd_step.cu",
             "matrix_factorization_tpu/ops/pallas_sgd.py:65",
             "the fused mini-batch step (_step_kernel)"),
            ("segment_apply", "segment_sum.cu",
             "matrix_factorization_tpu/ops/segment_sgd.py:923",
             "the secondary apply (tile_sec_scatter), an XLA scatter on the "
             "TPU and not a Pallas kernel; the port needs it deterministic")):
        row = sgd_rows["config3_sigmoid"][name]
        by_path = {"train": train_launches[name],
                   "sweep": sweep_out["launches"][name],
                   "recipe_serve": recipe["launches"][name],
                   "pipeline": pipe_launches[name],
                   "parallel": par_launches[name][0],
                   "parallel_gloo": par_launches[name][1],
                   "sharded_checkpoint": ckpt_launches[name]}
        if name == "segment_apply":
            by_path.update(bpr=fam["BPR"]["launches"],
                           svdpp=fam["SVDpp"]["launches"],
                           parallel_families=par_fam["launches"][name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"matrix_factorization_tpu_torch/csrc/{source}",
            "replaces": replaces, "note": note,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(sgd_worst[name], par_worst[name]),
            "ms": row["ms"],
            "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": {k: row[k] for k in ("bs", "Kp", "kernel", "primary",
                                          "runs_prim", "runs_sec")},
            "shapes": [rows_[name] for rows_ in sgd_rows.values()],
            "family_shapes": [r for r in fam_rows if r["name"] == name],
            "parallel_shapes": [r for r in par_rows
                                if r["name"].startswith(name)],
            **({"accumulator_launches": {
                "parallel": par_nccl["launches"]["sgd_step_acc"],
                "parallel_gloo": par_gloo["launches"]["sgd_step_acc"]}}
               if name == "sgd_step" else {})})
    row = spd_rows[0]
    kernels.append({
        "name": "spd_gj", "route": "cuda",
        "source": "matrix_factorization_tpu_torch/csrc/spd_gj.cu",
        "replaces": "matrix_factorization_tpu/ops/pallas_spd.py:56",
        "note": "the Gauss-Jordan SPD leaf (_gj_kernel) of every ALS solve",
        "launches": sum(spd_launches.values()),
        "launches_by_path": spd_launches, "max_abs_err": spd_worst,
        "ms": row["ms"], "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "shape": {"E": row["E"], "d": row["d"]}, "shapes": spd_rows})
    row = next(r for r in segsum_rows if r["shape"] == "ml1m_by_user")
    kernels.append({
        "name": "segment_sum", "route": "cuda",
        "source": "matrix_factorization_tpu_torch/csrc/segment_sum.cu",
        "replaces": "matrix_factorization_tpu/ops/als.py:75",
        "note": "jax.ops.segment_sum and .at[].add of the bias, count and "
                "profile sums (XLA scatters, not a Pallas kernel); the port "
                "needs them deterministic",
        "launches": sum(segsum_launches.values()),
        "launches_by_path": segsum_launches, "max_abs_err": segsum_worst,
        "ms": row["ms"], "kernel_ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "shape": {k: row[k] for k in ("n", "d", "rows")}, "shapes": segsum_rows,
        "family_shapes": [r for r in fam_rows if r["name"] == "segment_sum"]})
    row = topk_rows[0]
    topk_launches["after_recipe"] = (n_launches("mf_topk_select")
                                     - topk_launches["recipe_search"]
                                     - topk_launches["recipe_other"])
    kernels.append({
        "name": "topk_select", "route": "cuda",
        "source": "matrix_factorization_tpu_torch/csrc/topk_select.cu",
        "replaces": "none: lax.top_k on the TPU",
        "note": "the tie rule's top-k selection (ops/scoring.py::_select_topk "
                "on CUDA), one 64-bit key a score, no host sync",
        "launches": sum(topk_launches.values()),
        "launches_by_path": topk_launches,
        "ms": row["ms"], "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "shape": {k: row[k] for k in ("rows", "n", "k")}, "shapes": topk_rows})
    row = gram_rows[-1]
    kernels.append({
        "name": "ease_gram", "route": "cuda",
        "source": "matrix_factorization_tpu_torch/csrc/ease_gram.cu",
        "replaces": "none: XLA's f32 product of user slabs on the TPU "
                    "(matrix_factorization_tpu/ops/ease.py::item_gram)",
        "note": "EASE's exact int8 gram (ease_gram_slab/tile/finish_kernel); "
                "plain_ms is the exact-f32 scan, library_ms the same steps "
                "with torch._int_mm's whole product in place of the tile kernel",
        "launches": sum(gram_launches.values()),
        "launches_by_path": gram_launches, "max_abs_err": 0.0,
        "ms": row["ms"], "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "shape": {k: row[k] for k in ("users", "ip", "chunks")}, "shapes": gram_rows})
    row = ne_rows[0]
    ne_mark("after_parallel_als")
    kernels.append({
        "name": "normal_eq", "route": "cuda",
        "source": "matrix_factorization_tpu_torch/csrc/als_normal_eq.cu",
        "replaces": "none: XLA's design gather and batched products on the TPU "
                    "(matrix_factorization_tpu/ops/ials.py::_jit_bucket_sweep)",
        "note": "the ALS normal equations (normal_eq_kernel, normal_eq_finish_kernel "
                "past 1,024 slots); plain_ms is plain_normal_equations, library_ms "
                "the batched product alone on its masked design block",
        "launches": sum(ne_launches.values()), "launches_by_path": ne_launches,
        "max_abs_err": ne_worst,
        "ms": row["kernel_ms"], "kernel_ms": row["kernel_ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "shape": {k: row[k] for k in ("E", "L", "d", "live_rows", "slices")},
        "shapes": ne_rows})
    for row, entry, note in (
            (bs_rows[0], "mf_spd_split",
             "the block solve's Jacobi scaling and split (spd_split_kernel); plain_ms "
             "is plain_spd_split, library_ms _jacobi and the scaling's broadcast "
             "products into one (E, d, d) tensor, as the solve before it scaled"),
            (bs_rows[1], "mf_spd_block_solve",
             "the block solve's back-solve and float64-residual refinement "
             "(block_solve_kernel); plain_ms is plain_block_solve, library_ms the "
             "explicit inverse applied, the residual, applied again by batched "
             "matrix-vector products, as the solve before it applied them")):
        kernels.append({
            "name": row["kernel"], "route": "cuda",
            "source": "matrix_factorization_tpu_torch/csrc/spd_block_solve.cu",
            "replaces": "none: XLA's scaling and batched matrix-vector products of the "
                        "explicit inverse on the TPU "
                        "(matrix_factorization_tpu/ops/spd.py::spd_solve)",
            "note": note,
            "launches": sum(als_launches[entry].values()),
            "launches_by_path": als_launches[entry],
            "max_abs_err": row.get("max_abs_err", 0.0),
            "ms": row["kernel_ms"], "kernel_ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": {k: row[k] for k in ("E", "d", "m")}})
    emit({"kernels": kernels, "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        sys.exit(1)
