"""Smoke run of the PyTorch/CUDA port (lightgbm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds every kernel from lightgbm_tpu_torch/csrc (one nvcc per source,
all at once), then drives the port's scoring and training paths through
the entry points a user calls:

1. device: needs CUDA; prints the card's name and power limit;
2. build: nvcc's time and register report for each kernel source, and
   g++'s time for the text parser (csrc/fast_parser.cpp);
3. golden: every case of tests/data/golden2 through
   ``Booster(model_file=...).predict`` against the reference LightGBM's
   predictions (host binning, float64 X), and the same X as float32
   (device binning) against the port's float64 host walk;
4. full width: a HIGGS-shape model (500 trees x 255 leaves, 28
   features, random from a seed) scoring 500,000 rows; every row of
   both forest-kernel launches against the plain PyTorch version on the
   same device codes, scores and leaf indices bit for bit
   (``check_forest``), and a subset against the host walk; the kernel's
   time, plan and compact tables' bytes at the 262,144-row chunk;
5. serving: an LRB window model (50 trees x 31 leaves, 53 features)
   answering requests of 1, 7, 1000 and 65,536 rows through the C-API
   calls, each checked against the plain version; the kernel's time,
   plan and tables at 65,536 rows;
6. LRB window training: the paper's TRAIN_PARAMS on 1,000,000 rows x 53
   features through the C-API sequence (DatasetCreateFromMat ->
   SetField -> BoosterCreate -> UpdateOneIter x50 -> GetEval ->
   SaveModelToString -> PredictForMat on the next 65,536 rows);
7. HIGGS-shape training: 11,000,000 rows x 28 features, max_bin 63, 255
   leaves, 10 iterations through ``lightgbm_tpu_torch.train``; phases 6
   and 7 both capture the inputs of their first root pass (K2), their
   first and widest fused pass (K1; in phase 6 under bagging) and their
   first score update (K3);
8. kernels vs plain at those captured shapes: K1 and K2 bit for bit
   against their plain version run on the CPU in the kernels' order of
   addition (every channel, and K1's leaf ids), two launches
   bit-identical, K3 bit for bit; the g and h sums against a float64
   plain run as a second reading; times of each kernel (per launch over
   a run of launches between one pair of CUDA events), its plain
   version and the nearest PyTorch library call; for the f32 histogram
   pass the share of rows it counts, its launch plan on this card
   (features per group, slot classes, warps, blocks per SM, grid, row
   ranges) and its slot, histogram and reduce kernels' card time (CUDA
   events at the pass boundaries); K3 and ``index_select`` timed alike
   over 200 launches, with the host's microseconds per call of each;
9. card vs CPU: the LRB parameters at 100,000 rows trained on the card
   and with ``device="cpu"``. The card's tree at the first difference,
   grown again with K1 and K2 swapped for their kernel-order plain
   versions, equals its record bit for bit; the differing split is a
   near tie, within the f32 rounding of the two runs' own gains
   (``explain_difference``); train AUC within 4e-4;
10. HIGGS-shape training on the headline tier, int8 count-proxy
   histograms (``tpu_quantized_hist``, W=64), on phase 7's rows through
   ``train``: ms and launches per iteration, the card's busy share, and
   the holdout AUC within 0.01 of phase 7's exact tier;
11. the LRB window on the int8 tier with exact counts
   (``tpu_count_proxy=0``, W=30) through the C-API sequence, 50
   iterations under bagging, then the next window's 65,536 rows scored;
12. 4-bit packed bins at full width: phase 7's rows at max_bin 15 (16
   bins, two per byte on the card), 10 iterations on the exact tier and
   10 on the count-proxy tier; phases 10-12 capture their first root
   pass and their first and widest wave;
13. the int8 kernels (K2q, K1q) against their plain version on the card
   bit for bit (every channel, K1's leaf ids and cnt_r) and two launches
   bit-identical; each packed launch bit-identical to the unpacked launch
   on the same rows; each variant's time, its plain version's, the
   ``index_add_`` library call (int32 for the int8 tiers) and its bound;
   for the int8 pass its plan on this card (``int_plan``), the share of
   rows it counts, its slot, histogram and flush kernels' card time
   (CUDA events at the pass boundaries) and the host's microseconds a
   call; each int8 launch not more than 10% above its time before the
   pass's redesign (``INT8_MS_BEFORE``) when the power limit is 700 W;
14. card vs CPU on the quantized tier: the LRB parameters with
   ``tpu_quantized_hist`` at 100,000 rows, 20 iterations; trees equal up
   to a near tie of the quantized gains, train AUC within 4e-4;
15. categorical training at full width: 10,000,000 rows (and a 500,000
   row holdout) in the column layout of the airline on-time data of
   szilard/benchm-ml (``make_airline_like``: six categorical columns,
   two numerical), 255 leaves, max_bin 255, the default categorical
   parameters, 10 iterations through ``train`` on the exact tier: ms per
   iteration, K1 launches per iteration and those with categorical
   slots, the card's busy share, the holdout AUC (scored through
   ``Booster.predict``, the forest kernel with no fallback; every
   holdout row of its launches against the plain version, scores and
   leaf indices bit for bit, and the kernel's time, plan and tables)
   beside the same rows trained with every column numerical;
16. the same rows on ``tpu_quantized_hist`` with ``tpu_count_proxy=1``:
   the tier resolves to int8 with exact counts (W=40) and logs the JAX
   package's warning; 10 iterations;
17. K1 with categorical rows against its plain version at phases 15-16's
   captured inputs (the root pass and the widest wave with a
   categorical slot): the f32 kernel bit for bit against the plain
   version run on the CPU in the kernels' order (every channel, the
   leaf ids; two launches bit-identical), the int8 kernel bit for bit
   against its plain version on the card; times, bounds and the
   ``index_add_`` of one pass, the int8 pass's plan and split as in
   phase 13; the root pass (K2) timed beside it;
   phase 8's K1 time on phase 7's inputs (the launch without
   categorical rows) not more than 10% above its 7.583 ms before the
   categorical rows existed (PERF.md's kernel table) when the card's
   power limit is 700 W;
18. card vs CPU at 100,000 rows of phase 15's generator, 20 iterations
   of 31 leaves (phase 15's 255 take the CPU about 20 s an iteration),
   on the exact and the int8 tier: trees equal up to a near tie, train
   AUC within 4e-4;
19. the LRB loop (``lightgbm_tpu_torch.lrb``), run after phase 5 and
   before phases 6-18 (torch.profiler keeps all its records this early):
   ``synthetic_trace(3,000,000, n_objects=100,000, seed=7)`` written as
   a trace file and driven through ``lrb.run_trace_file`` on cuda:0 in
   the default pipelined mode: cache 2**24 bytes, windows of 1,000,000
   requests, a uniform sample of 500,000 (``TRAIN_PARAMS``, 53
   features), cutoff 0.5; three windows, each OPT-labeled (its positive
   share in (0.05, 0.95)), trained and published, windows 2 and 3 also
   scored on the previous model in 15,625 calls of 64 rows. The same
   trace in sequential mode gives records equal on ``PARITY_KEYS``.
   Window 3's calls are bit-equal to one call with the same handle and
   to the plain K4 version on the same device codes
   (``check_forest``). Per window: wall, derive, train (ms an
   iteration), evaluate, predict calls, p50/p99 a batch and a request,
   and K1-K4 launches; then the host's operators and the card's busy
   share over 200 serving calls;
20. the fleet scoring daemon (``lightgbm_tpu_torch.serve``), right after
   phase 19 on its trace and models: tenants ``lrb_a`` and ``lrb_b``
   (phase 19's last published model, 50 trees of 31 leaves over 53
   features) and ``higgs`` (phase 4's 500 trees of 255 leaves over 28),
   all on cuda:0. First the shed drill of tests/test_fleet.py (p99
   objective 50 ms, shed at half the budget, 100 events before judging;
   400 healthy 64-row requests a tenant over HTTP, then
   ``fleet.predict.lrb_a@1+:sleep80``): lrb_a refused with HTTP 429 with
   budget left and not exhausted, lrb_b served bit-equal, faults
   cleared. Then 8,000 requests of 64 rows (LRB rows, HIGGS rows for
   ``higgs``) in the ratio 7:7:2 from 32 ``FleetClient`` threads over
   localhost HTTP, coalesce_us 2000 and max_batch 4096, every answer
   bit-equal to ``LGBM_BoosterPredictForMat`` on a freshly loaded handle
   and of version 1, the batches the dispatcher sends recorded at the
   coalescer's ``predict_fn`` seam and the largest held against the
   plain K4 version (``check_forest``); printed: requests/s, a request's
   p50/p99 at its client, the batches' rows p50/p99, K4 launches a
   request, and, over one request in 8 sent again under the profiler,
   the card's busy share and the host's top operators; the same for the
   first 2,000 requests with coalesce_us 0. Then 8 clients on lrb_a
   while it is registered 3 times, two model texts in turn: no failed
   request, every answer bit-equal to its version's, ``fleet/
   model_swaps`` +3. Last, phase 19's trace cut to 2 windows of 250,000
   requests (a quarter of its windows, sample 125,000), sequential, in
   process and then with ``serve_daemon=True`` (window 2's 3,907 calls
   of 64 rows over HTTP): records equal on ``PARITY_KEYS``, the
   tenant's version the windows published, no fallback to in-process
   scoring, one K4 launch a request and one a registration; window 2's
   evaluate time and a request's p50/p99 beside the in-process run's.
   Every number with the card's name and power limit;
21. valid sets, after phases 7 and 11 and against them: (a) phase 7's
   rows through ``train`` with phase 7's 500,000-row holdout as
   ``valid_sets=[dv]`` (auc, binary_logloss, binary_error recorded every
   iteration): the model text before its parameters equal to phase 7's,
   K1 and K2 launches as phase 7's and K3 2 a tree, the valid raw scores
   within 1e-5 of ``Booster.predict(raw_score=True)`` (K4) and the last
   recorded AUC within 1e-6 of ``auc_np`` on its predictions; (b) phase
   6's C-API sequence with the next window's 65,536 rows as a valid set
   (``DatasetCreateFromMat(reference=)``, ``BoosterAddValidData``,
   ``GetEval(bst, 1)`` after every iteration): the model text equal to
   phase 6's, the eval counts and names, ``GetPredict(1)`` within 1e-5
   of ``PredictForMat``, one ``RollbackOneIter`` after iteration 50
   giving the text saved after 49 and ``GetPredict(0)``,
   ``GetPredict(1)``, ``GetEval(1)`` within 1e-6 of the values saved
   then; K2's root pass and K1's widest wave with the passengers
   against their plain versions in the kernels' order bit for bit, two
   launches bit-identical, timed beside phase 8's LRB K2 and K1; (c)
   phase 11's int8 tier with the same valid set: the model text equal
   to phase 11's; (d) ``train`` on phase 6's
   rows with 65,536 valid rows of coin-flip labels,
   ``early_stopping_rounds=5`` of 500, with a user callback that
   records the iterations it sees: stopped before round 50, five
   iterations after the best, the callback called once an iteration. For
   (a) and (b) an iteration's host-clock ms with and without the valid
   set, in turns on this card, and the card's busy share;
22. every objective family, after phases 15-18, in at most 150 s: (a)
   multiclass at UCI Covertype's shape (``make_covertype_like``:
   464,809 train rows x 54 columns, 10 numerical, 4 + 40 one-hot; 7
   classes; the 116,203-row holdout as a valid set with multi_logloss
   and multi_error), 255 leaves, max_bin 255, 10 iterations (70 trees)
   through ``train``: ms an iteration, the card's busy share, K1/K2/K3
   launches an iteration (K3 7 + 7), K3 on class row 3 of the train
   scores bit-equal to its plain version, K4's [N, 7] holdout scores and
   leaf indices bit-equal to plain (``check_forest``), each row's class
   probabilities summing to 1 within 1e-6; (b) ``regression`` and
   ``regression_l1`` at YearPredictionMSD's shape and published split
   (``make_year_like``: 463,715 / 51,630 rows x 90), 10 iterations of
   255 leaves with l2 / l1 on the test rows: L2 at the hilo3 wave width
   W=40, the renewal's ms a tree (CUDA events), renewed outputs that
   differ from the grower's, the renewal bit-equal to its CPU run on the
   same leaf ids and residuals; (c) ``lambdarank`` at MSLR-WEB10K Fold
   1's shape (``make_mslr_like``: 723,412 rows x 136 in 6,000 queries,
   relevance 0-4, a tail to 908 rows a query), 10 iterations of 255
   leaves, NDCG@1,3,5,10 on a 1,000-query holdout within 1e-9 of the
   host's float64 NDCG (``ndcg_np``), the gradient step's ms and its
   chunks; (d) card against CPU (``card_and_cpu``, ``judge_trees``) at
   20,000 rows, 31 leaves, 5 iterations for multiclass, multiclassova,
   regression, regression_l1, huber, poisson, lambdarank (200 queries)
   and a custom ``fobj`` with L2's gradients, whose model text equals
   the regression model's. Each part's wall is printed;
23. the boosting variants, forced splits and continued training, after
   phase 22, in at most 150 s: (a) GOSS (top_rate 0.2, other_rate 0.1)
   on phase 7's 11,000,000 x 28 rows, 15 iterations of 255 leaves at
   learning_rate 0.1 (10 of warm-up, 5 sampled), on the exact tier and
   on the int8 count-proxy tier: each sampled iteration's kept mask and
   amplified g and h bit-equal to the plain sampler run on the CPU on
   the same gradients, the kept rows within 0.5% of n of 0.3 n, on the
   exact tier the warm-up trees equal to phase 7's trees and the holdout
   AUC in [-0.002, +0.05] of phase 7's (the same first 10 trees, then 5
   trees on 30% of the rows: more trees may raise it, a broken sampler
   would lower it), on the count-proxy tier within 0.01 of the exact
   tier's (that tier's cost, as in phase 10);
   (b) DART (drop_rate 0.1, skip_drop 0.5, max_drop 50, drop_seed 4) on
   phase 6's rows with ``TRAIN_PARAMS``, 50 iterations through the C
   API: K3 one launch a tree and two a dropped tree, the next 65,536
   rows through ``PredictForMat`` bit-equal to the plain forest
   (``check_forest``) and within 1e-5 of the float64 host walk on the
   rescaled trees; (c) RF at Covertype's shape (phase 22's generator, 7
   classes, bagging 0.632 every iteration, 255 leaves, 10 iterations):
   K4's [116,203, 7] holdout outputs bit-equal to plain with
   ``average_output``, each row's probabilities summing to 1 within
   1e-6; (d) forced splits on phase 6's rows (the root on feature 50,
   log2 size, at its median, its children on features 0 and 51, and a
   node on the constant feature 52 that is skipped), 10 iterations:
   every tree's first three splits the forced ones, K2 one root and
   three forced launches a tree; (e) 25 iterations, saved, 25 more with
   ``train(init_model=path)`` (the first scores equal to the loaded
   model's predictions in f32), ``LGBM_BoosterMerge`` (predictions
   within 1e-5 of the sum of both models'), ``LGBM_BoosterResetTraining
   Data`` on the next window (50 trees replayed into its scores, K3 a
   tree) and 10 more iterations, the train loss falling; (f) card
   against CPU at
   20,000 rows, 31 leaves, 5 iterations: GOSS at learning_rate 0.5,
   DART in its four modes, RF binary and multiclass, forced splits,
   continued training. Each part prints its ms an iteration, the card's
   busy share and its launches;
24. the file entry point, after phase 23, in at most 120 s (the files'
   writing untimed, at most 30 s): phase 6's window written as an
   integer TSV, the label first (``write_int_tsv``), and its next 65,536
   rows likewise. (a) ``lightgbm_tpu_torch.application.main(
   ["config=train.conf"])`` with ``TRAIN_PARAMS`` (the text parser built
   from csrc/fast_parser.cpp, the loader, the CLI training driver): the
   model text before its parameters equal to phase 6's, K1, K2 and K3
   launched; parse and binning seconds and ms an iteration printed from
   the driver's phase timers; (b) ``task=predict`` and
   ``LGBM_BoosterPredictForFile`` on the next rows: both result files
   equal line for line to ``f"{v:g}"`` of phase 6's answers, K4
   launched; (c) refit on the next rows through ``task=refit``,
   ``LGBM_BoosterRefit`` after ``LGBM_BoosterResetTrainingData`` (K3 50
   launches, one a tree) and ``Booster.refit``: the three models equal,
   a second run the same bits, the trees' structure (a)'s, each tree's
   outputs within the f32 bound (``refit_bound``) of the plain sums on the
   CPU on the card's leaf ids, g and h, and ``refit_decay_rate=1.0``
   giving (a)'s leaf values; (d) ``predict(pred_contrib=True)`` on 256
   rows equal to ``C_API_PREDICT_CONTRIB``, rows summing to the float64
   host walk within 1e-9 and to K4's raw scores within 1e-5; (e)
   ``Dataset(path).save_binary``, then the CLI trained from the ``.bin``:
   the model text (a)'s, the load seconds; (f) ``SetLeafValue`` (tree 7,
   leaf 3), then ``ShuffleModels``, each followed by ``PredictForMat`` on
   the next rows: K4 bit-equal to plain on the current tables
   (``check_forest``), within 1e-5 of the float64 host walk of the edited
   trees, ``GetLeafValue`` reading the value back, ``DumpModel`` parsing
   as JSON with 50 trees.

Phases 6-7, 10-12, 15-16 and 19-24 check that the main path launched
each kernel (and each histogram variant) of its tier. Prints a JSON line
of the kernels, then the last line ``{"ok": true, "device": {...}}``.
Any failed check raises, and the script exits non-zero without that
line. The model generators are importable (the body runs only under
``__main__``).
"""
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "golden2")
GOLDEN_CASES = ["binary", "regl2", "regl1", "multic", "catbin",
                "dart", "goss", "contin", "rank", "wbin"]
REVERSE_ONLY = ["proxy", "pkd4"]

HOLDOUT_ROWS = 500_000          # bench.py's HIGGS holdout
HIGGS_TREES, HIGGS_LEAVES = 500, 255
LRB_TREES, LRB_LEAVES = 50, 31
HISTFEATURES = 50               # lightgbm_tpu/lrb.py: 50 gaps + 3 columns
LRB_FEATURES = HISTFEATURES + 3
SUBSET = 16_384
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores

TRAIN_PARAMS = {                # lightgbm_tpu/lrb.py:64-81 (test.cpp:67-87)
    "boosting": "gbdt",
    "objective": "binary",
    "metric": "binary_logloss,auc",
    "metric_freq": "1",
    "is_provide_training_metric": "true",
    "max_bin": "255",
    "num_iterations": "50",
    "learning_rate": "0.1",
    "num_leaves": "31",
    "tree_learner": "serial",
    "feature_fraction": "0.8",
    "bagging_freq": "5",
    "bagging_fraction": "0.8",
    "min_data_in_leaf": "50",
    "min_sum_hessian_in_leaf": "5.0",
    "verbose": "-1",
}
LRB_TRAIN_ROWS = 1_000_000
LRB_NEXT_ROWS = 65_536
HIGGS_TRAIN_ROWS = 11_000_000   # bench.py BASELINE_ROWS
HIGGS_PARAMS = {"objective": "binary", "metric": "auc", "max_bin": 63,
                "num_leaves": 255, "learning_rate": 0.1,
                "min_data_in_leaf": 20, "verbose": -1}   # bench.py:877-881
HIGGS_ITERS = 10
CPU_ROWS = 100_000
AUC_TOL = 4e-4
PROXY_AUC_TOL = 0.01            # the count-proxy tier's cost is about 1e-3
PACKED_MAX_BIN = 15             # 16 bins: 4-bit packed
CPU_Q_ITERS = 20
# szilard/benchm-ml's airline set: Month, DayofMonth, DayOfWeek, DepTime,
# UniqueCarrier, Origin, Dest, Distance; None marks a numerical column
AIRLINE_CATEGORIES = (12, 31, 7, None, 22, 300, 300, None)
AIRLINE_CAT_COLUMNS = [j for j, k in enumerate(AIRLINE_CATEGORIES) if k]
AIRLINE_ROWS = 10_000_000
AIRLINE_PARAMS = {"objective": "binary", "metric": "auc", "max_bin": 255,
                  "num_leaves": 255, "learning_rate": 0.1, "verbose": -1}
AIRLINE_ITERS = 10
CAT_CPU_ITERS = 20
CAT_CPU_LEAVES = 31
K1_MS_BEFORE_CAT = 7.583        # PERF.md's table: phase 8's K1, 700 W
# phase 19: the LRB loop (lightgbm_tpu_torch/lrb.py) on a synthetic trace
LOOP_REQUESTS = 3_000_000
LOOP_OBJECTS = 100_000
LOOP_CACHE = 1 << 24            # OPT's positive share 0.878 a window
LOOP_WINDOW = 1_000_000
LOOP_SAMPLE = 500_000
LOOP_CUTOFF = 0.5
LOOP_SAMPLING = 2               # uniform random
LOOP_SEQ_WINDOWS = 3            # windows of the sequential comparison
SERVE_PROBE_CALLS = 200
# tests/test_lrb_pipeline.py:122
PARITY_KEYS = ("window", "eval_rows", "fp_rate", "fn_rate",
               "train_rows", "opt_obj_hit_ratio", "opt_byte_hit_ratio",
               "staleness_windows", "degraded", "degrade_reason")
# phase 20: the fleet scoring daemon (lightgbm_tpu_torch/serve/)
FLEET_REQUESTS = 8_000          # the coalesced run
FLEET_REPEAT = 2_000            # the first of them again, coalesce_us 0
FLEET_CLIENTS = 32              # FleetClient threads, one HTTP call each
FLEET_ROWS = 64                 # rows a request (the LRB loop's calls)
FLEET_MIX = (("lrb_a", 7), ("lrb_b", 7), ("higgs", 2))
FLEET_COALESCE_US = 2_000       # config.py tpu_fleet_coalesce_us default
FLEET_MAX_BATCH = 4_096         # tpu_fleet_max_batch default
FLEET_PROFILED = 8              # one request in 8 again, under the profiler
SWAP_CLIENTS = 8
DRILL_PREFILL = 400             # tests/test_fleet.py:301
FLEET_LOOP_WINDOWS = 2
FLEET_LOOP_WINDOW = 250_000     # phase 19's windows cut to a quarter
FLEET_LOOP_SAMPLE = 125_000     # for the run through the daemon
K3_RUNS = 200                   # K3 launches per timing window
# phase 21: valid sets
VALID_METRICS = "auc,binary_logloss,binary_error"
STOP_ROUNDS = 500
STOP_PATIENCE = 5
TURN_ROUNDS = 3                 # rounds of plain, valid, valid, plain
PASS_RUNS = 5                   # launches per timed pass split
# PERF.md's table: each int8 launch's card ms before the int8 pass's
# redesign (700 W), at phases 13 and 17's captures; a launch may not be
# more than 10% above it on a 700 W card
INT8_MS_BEFORE = {("K1", "proxy"): 1.372, ("K1", "proxy_packed4"): 1.324,
                  ("K1", "int8"): 0.193, ("K2", "proxy"): 1.257,
                  ("K2", "proxy_packed4"): 1.240, ("K2", "int8"): 0.294,
                  ("K1", "int8_cat"): 0.890}

# phase 22: every objective, at the published widths of public sets
COVERTYPE_ROWS = 581_012        # UCI Covertype: 54 columns, 7 classes
COVERTYPE_TRAIN = 464_809       # the train/holdout split of 464,809 and
COVERTYPE_CLASSES = 7           # 116,203 rows
YEAR_ROWS = 515_345             # UCI YearPredictionMSD: 90 columns, the
YEAR_TRAIN = 463_715            # published split of 463,715 / 51,630
YEAR_FEATURES = 90
MSLR_ROWS = 723_412             # MSLR-WEB10K Fold 1 train: 136 columns,
MSLR_QUERIES = 6_000            # 6,000 queries, relevance 0-4
MSLR_FEATURES = 136
MSLR_HOLDOUT_QUERIES = 1_000
MSLR_MAX_QUERY = 908            # the longest query of the generator
OBJ_PARAMS = {"num_leaves": 255, "max_bin": 255, "verbose": -1}
OBJ_ITERS = 10
OBJ_CPU_ROWS = 20_000           # (d): card against CPU
OBJ_CPU_LEAVES = 31
OBJ_CPU_ITERS = 5
OBJ_CPU_QUERIES = 200
OBJ_METRIC_TOL = 1e-3           # card vs CPU train metric, relative
NDCG_TOL = 1e-9
PHASE22_BUDGET_S = 150.0
PHASE23_BUDGET_S = 150.0
PHASE24_BUDGET_S = 120.0
SHAP_ROWS = 256                 # (d): rows explained by TreeSHAP on the host
LEAF_EDIT = (7, 3)              # (f): tree and leaf given a new value
WRITE_LIMIT_S = 30.0            # the window's text file, written untimed
GOSS_ITERS = 15                 # 10 of warm-up (learning_rate 0.1), 5 sampled
GOSS_RATES = {"top_rate": 0.2, "other_rate": 0.1}
GOSS_KEPT_TOL = 0.005           # kept rows within 0.5% of n of 0.3 n
GOSS_AUC_BAND = (-0.002, 0.05)  # exact tier: holdout AUC minus phase 7's
DART_PARAMS = {**TRAIN_PARAMS, "boosting": "dart", "drop_rate": "0.1",
               "skip_drop": "0.5", "max_drop": "50", "drop_seed": "4"}
RF_PARAMS = {**OBJ_PARAMS, "objective": "multiclass",
             "num_class": COVERTYPE_CLASSES, "boosting": "rf",
             "bagging_fraction": 0.632, "bagging_freq": 1}
RF_ITERS = 10
FORCED_ITERS = 10
CONTIN_ITERS = 25               # a first model, then as many continued
RESET_ITERS = 10                # after ResetTrainingData on the next window
VAR_CPU_ROWS = 20_000           # (f): card against CPU
VAR_CPU_ITERS = 5


def make_higgs_like(n_rows: int, n_features: int = 28, seed: int = 7):
    """Synthetic HIGGS-shaped task (bench.py): 28 continuous features,
    nonlinear decision boundary, balanced classes."""
    r = np.random.default_rng(seed)
    X = r.normal(size=(n_rows, n_features)).astype(np.float32)
    logit = (X[:, 0] * X[:, 1] + 0.5 * X[:, 2] - 0.3 * X[:, 3] * X[:, 4]
             + 0.2 * np.abs(X[:, 5]) + 0.1 * X[:, 6])
    y = (logit + 0.5 * r.normal(size=n_rows) > 0).astype(np.float32)
    return X, y


def make_lrb_rows(n_rows: int, seed: int = 3) -> np.ndarray:
    """LRB request features (lightgbm_tpu/lrb.py _derive_features):
    inter-arrival gaps (zero past an object's history), log2 size,
    log2 available bytes and cost, as float64 integers."""
    r = np.random.default_rng(seed)
    X = np.zeros((n_rows, LRB_FEATURES), np.float64)
    hist = r.integers(0, HISTFEATURES + 1, n_rows)
    gaps = r.integers(1, 50_000, size=(n_rows, HISTFEATURES))
    X[:, :HISTFEATURES] = np.where(
        np.arange(HISTFEATURES)[None, :] < hist[:, None], gaps, 0)
    X[:, HISTFEATURES] = np.round(100.0 * np.log2(
        r.integers(64, 1 << 24, n_rows)))
    X[:, HISTFEATURES + 1] = np.round(100.0 * np.log2(
        r.integers(1, 1 << 30, n_rows)))
    X[:, HISTFEATURES + 2] = 1.0
    return X


def lrb_labels(X: np.ndarray, seed: int) -> np.ndarray:
    """A seeded label rule on LRB rows: requested again soon when the
    last gap is short, flipped by log2 size, with 5% noise."""
    r = np.random.default_rng(seed)
    soon = (X[:, 0] > 0) & (X[:, 0] < 15_000)
    y = soon ^ (X[:, HISTFEATURES] < 2200)
    return (y ^ (r.random(X.shape[0]) < 0.05)).astype(np.float32)


def make_airline_like(n_rows: int, seed: int) -> np.ndarray:
    """Rows in the column layout of the airline on-time data
    (``AIRLINE_CATEGORIES``): each categorical column's codes drawn with
    Zipf-like frequencies (p ~ rank^-1.5) under one fixed shuffle of its
    codes, DepTime as hhmm in 1-2400, Distance in miles (30-4962). At
    that skew the 255 most frequent of Origin's and Dest's 300 codes
    hold over 99% of the rows: they get a bin each, the last bin also
    holds the other 45 (bin.cpp's 99% cut), and the bins fit a byte."""
    r = np.random.default_rng(seed)
    shuffle = np.random.default_rng(40)
    X = np.empty((n_rows, len(AIRLINE_CATEGORIES)), np.float64)
    for j, k in enumerate(AIRLINE_CATEGORIES):
        if k:
            p = np.arange(1, k + 1) ** -1.5
            X[:, j] = shuffle.permutation(k)[r.choice(k, n_rows,
                                                      p=p / p.sum())]
    hour = np.clip(np.rint(r.normal(13.5, 4.5, n_rows)), 0, 23)
    X[:, 3] = np.clip(hour * 100 + r.integers(0, 60, n_rows), 1, 2400)
    X[:, 7] = np.clip(np.rint(r.lognormal(6.4, 0.6, n_rows)), 30, 4962)
    return X


def airline_labels(X: np.ndarray, seed: int) -> np.ndarray:
    """dep_delayed_15min from a seeded rule: a scrambled 30% of the
    origins and of the carriers, later departures, logistic noise
    (``seed``)."""
    rule = np.random.default_rng(42)
    late_origin = rule.random(AIRLINE_CATEGORIES[5]) < 0.3
    late_carrier = rule.random(AIRLINE_CATEGORIES[4]) < 0.3
    logit = (1.1 * late_origin[X[:, 5].astype(np.int64)]
             + 0.8 * late_carrier[X[:, 4].astype(np.int64)]
             + 0.0009 * (X[:, 3] - 1400.0) - 1.0)
    noise = np.random.default_rng(seed).logistic(size=X.shape[0])
    return (logit + noise > 0).astype(np.float32)


def make_covertype_like(n_rows: int, seed: int):
    """Rows in the column layout of UCI Covertype: 10 numerical columns
    in their published ranges (elevation, aspect, slope, four
    distances, three hillshades), then 4 wilderness-area and 40
    soil-type one-hot columns; labels 0..6 from a seeded rule with
    learnable signal (elevation bands shifted by the area, a soil term
    and noise)."""
    rng = np.random.default_rng(seed)
    n = n_rows
    X = np.zeros((n, 54), np.float64)
    X[:, 0] = rng.normal(2960, 280, n).clip(1859, 3858)         # elevation
    X[:, 1] = rng.uniform(0, 360, n)                            # aspect
    X[:, 2] = rng.gamma(3.0, 4.7, n).clip(0, 66)                # slope
    X[:, 3] = rng.exponential(270, n).clip(0, 1397)
    X[:, 4] = rng.normal(46, 58, n).clip(-173, 601)
    X[:, 5] = rng.exponential(2350, n).clip(0, 7117)
    for j in (6, 7, 8):                                         # hillshade
        X[:, j] = rng.normal(212 - 40 * (j - 7) ** 2, 27, n).clip(0, 254)
    X[:, 9] = rng.exponential(1980, n).clip(0, 7173)
    area = rng.choice(4, n, p=[0.45, 0.05, 0.44, 0.06])
    soil = rng.integers(0, 40, n)
    X[np.arange(n), 10 + area] = 1.0
    X[np.arange(n), 14 + soil] = 1.0
    z = (X[:, 0] - 2960) / 280 + 0.6 * area - 0.5 * np.sin(soil * 0.7)
    z = z + 0.3 * (X[:, 5] - 2350) / 1600 - 0.2 * X[:, 2] / 14
    z = z + rng.normal(0, 0.35, n)
    y = np.digitize(z, [-1.6, -0.7, 0.0, 0.6, 1.2, 1.9]).astype(np.float64)
    return X, y


def make_year_like(n_rows: int, seed: int):
    """Rows in the column layout of UCI YearPredictionMSD: 12 timbre
    averages and 78 timbre covariances (90 real columns of their wide
    scales); the year, 1922-2011 and most of it after 1990, from a
    seeded rule with learnable signal and noise."""
    rng = np.random.default_rng(seed)
    n = n_rows
    X = np.empty((n, YEAR_FEATURES), np.float64)
    X[:, :12] = rng.normal(0, 1, (n, 12)) * np.linspace(60, 8, 12)
    X[:, 12:] = rng.standard_t(5, (n, 78)) * np.linspace(3000, 20, 78)
    z = (0.5 * X[:, 0] / 60 - 0.3 * X[:, 1] / 55 + 0.2 * np.tanh(
        X[:, 12] / 3000) + 0.2 * X[:, 5] * X[:, 6] / 1200
         + rng.normal(0, 0.5, n))
    y = np.clip(np.round(1998 + 7 * z), 1922, 2011)
    return X, y


def mslr_query_lengths(n_queries: int, n_rows: int, seed: int):
    """Query lengths of the MSLR-WEB10K shape: a mean of n_rows /
    n_queries (about 120), a long tail to ``MSLR_MAX_QUERY``, and exactly
    ``n_rows`` rows in all."""
    rng = np.random.default_rng(seed)
    c = rng.lognormal(np.log(90.0), 0.75, n_queries)
    c = np.clip(np.round(c * n_rows / c.sum()), 1, MSLR_MAX_QUERY)
    c = c.astype(np.int64)
    c[np.argmax(c)] = MSLR_MAX_QUERY
    while c.sum() != n_rows:
        d = n_rows - int(c.sum())
        idx = rng.choice(n_queries, min(abs(d), n_queries), replace=False)
        step = 1 if d > 0 else -1
        ok = (c[idx] + step >= 1) & (c[idx] + step < MSLR_MAX_QUERY)
        c[idx[ok]] += step
    return c


def make_mslr_like(n_queries: int, n_rows: int, seed: int):
    """(X [N, 136], relevance 0-4, query lengths) in the shape of
    MSLR-WEB10K: 136 non-negative feature columns (counts and scores of
    their usual scales), relevance from a seeded latent score with a
    per-query offset, in the set's proportions (about 52%, 32%, 13%, 2%,
    1% for 0..4)."""
    rng = np.random.default_rng(seed)
    counts = mslr_query_lengths(n_queries, n_rows, seed + 1)
    n = int(counts.sum())
    X = np.abs(rng.normal(0, 1, (n, MSLR_FEATURES)))
    X[:, :40] = np.floor(X[:, :40] * 6)                          # counts
    X[:, 40:100] *= np.linspace(1, 200, 60)                      # scores
    q_off = np.repeat(rng.normal(0, 0.5, n_queries), counts)
    latent = (X[:, 0] / 6 + 0.6 * X[:, 41] / 2 - 0.3 * X[:, 100]
              + 0.4 * np.sqrt(X[:, 5] * X[:, 7]) / 3 + q_off
              + rng.normal(0, 0.6, n))
    cut = np.quantile(latent, [0.52, 0.84, 0.97, 0.99])
    y = np.digitize(latent, cut).astype(np.float64)
    return X, y, counts


def ndcg_np(scores: np.ndarray, labels: np.ndarray, counts, ks,
            label_gain=None) -> list:
    """NDCG at each of ``ks``, averaged over the queries, in float64 on
    the host (rank_metric.hpp; the JAX package's NDCGMetric.eval): each
    query ranked by a stable descending sort of its scores; a query
    without relevant rows counts 1."""
    gain = (np.asarray(label_gain, np.float64) if label_gain is not None
            else 2.0 ** np.arange(31) - 1.0)
    out = {k: [] for k in ks}
    lo = 0
    for c in counts:
        hi = lo + int(c)
        g = gain[labels[lo:hi].astype(np.int64)]
        order = np.argsort(-scores[lo:hi], kind="mergesort")
        ideal = np.sort(g)[::-1]
        disc = 1.0 / np.log2(np.arange(hi - lo) + 2.0)
        for k in ks:
            kk = min(k, hi - lo)
            dcg = np.sum(g[order[:kk]] * disc[:kk])
            best = np.sum(ideal[:kk] * disc[:kk])
            out[k].append(1.0 if best <= 0 else dcg / best)
        lo = hi
    return [float(np.mean(out[k])) for k in ks]


def host_raw(gbdt, X: np.ndarray) -> np.ndarray:
    """The port's float64 host walk: raw scores [K, N]."""
    k = gbdt.num_tree_per_iteration
    out = np.zeros((k, X.shape[0]))
    for t, tree in enumerate(gbdt.models):
        out[t % k] += tree.predict(X)
    if gbdt.average_output:
        out /= max(len(gbdt.models) // k, 1)
    return out


def cuda_ms(fn, runs: int, warmup: int = 1) -> float:
    """Milliseconds per call of ``fn``: ``runs`` calls after ``warmup``,
    between one pair of CUDA events, over ``runs`` (a call's host time
    overlaps the card's work on the calls before it)."""
    import torch
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / runs


def queued_ms(fn, runs: int) -> float:
    """The card's milliseconds per call of ``fn`` with its queue kept
    full: a spin of about 3 ms on the stream first, so that the ``runs``
    calls are all enqueued before the first starts and the events time
    the card's work alone, not the host's time to enqueue each call
    (which ``cuda_ms`` shows where a launch is shorter than it)."""
    import torch
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(5_000_000)
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / runs


def host_us(fn, runs: int) -> float:
    """Host microseconds per call of ``fn`` over ``runs`` calls (what
    enqueueing a launch costs the host), then a synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / runs
    torch.cuda.synchronize()
    return us


def leaf_depths(gbdt, n_leaves: int) -> np.ndarray:
    """[T, n_leaves] nodes on the path from each tree's root to each of
    its leaves (0 for a single-leaf tree)."""
    out = np.zeros((len(gbdt.models), n_leaves), np.int64)
    for t, tree in enumerate(gbdt.models):
        stack = [(0, 1)] if tree.num_leaves > 1 else []
        while stack:
            node, d = stack.pop()
            for child in (tree.left_child[node], tree.right_child[node]):
                if child < 0:
                    out[t, ~child] = d
                else:
                    stack.append((child, d + 1))
    return out


def measure_kernel(gbdt, codes, dev, alternatives: bool = True) -> dict:
    """The forest kernel's time on ``codes`` (one [F, n] row chunk on the
    card, as predict cuts them): ``ms`` by calls back to back
    (``cuda_ms``, as for every kernel since the first slice) and
    ``queued_ms`` with the card's queue full; its launch plan on this
    card, its plain version's time, and its bound: the larger of the
    bytes it must move (the codes of the features it reads and its
    compact tables read once, scores written once) over HBM bandwidth
    and its operations (one per node visit this data makes, counted from
    the leaves it reaches, plus one f32 add per row-tree) over the f32
    rate. ``bound_ms_jax_layout`` counts the JAX layout's per-node tables
    (and every feature's codes) instead of the compact ones, as the
    bound of the first slices did. ``alternatives``: also time the other
    launches the code keeps (``plan_readings``)."""
    import torch
    from lightgbm_tpu_torch.ops import forest as forest_ops
    fc = gbdt._stacked_model().forest
    w = fc.walk
    T = len(fc.root_host)
    n = codes.shape[1]
    fcd = fc.to(dev)                    # the plain version's, on the card
    ms = cuda_ms(lambda: forest_ops.forest_predict(codes, fc, 0, T), 10)
    queued = queued_ms(lambda: forest_ops.forest_predict(codes, fc, 0, T), 10)
    plain_ms = cuda_ms(
        lambda: forest_ops.forest_predict_plain(codes, fcd, 0, T), 3)
    leaves = forest_ops.forest_predict(codes, fc, 0, T, leaf_mode=True)
    depth = torch.from_numpy(leaf_depths(gbdt, fc.leaf.shape[1])).to(dev)
    d = depth[torch.arange(T, device=dev)[None, :], leaves.long()]
    visits = int(d.sum())
    del leaves, fcd
    # lanes busy: visits over the lane-steps of lanes walking a row in step
    # (each warp step lasts as long as the deepest of the chunk's 32
    # trees; a last chunk of m <= 16 trees walks 32 // m rows at once) and
    # of lanes that move on to their next row of a batch of 16
    m = w.tail
    if m:
        tail = torch.nn.functional.pad(d[:, T - m:], (0, 0, 0, -n % (32 // m)))
        tail = int(tail.reshape(-1, 32 // m * m).max(1).values.sum())
    d = torch.nn.functional.pad(d, (0, -T % 32)).view(n, -1, 32)
    in_step = int(d.max(2).values.sum()) * 32
    if m:
        in_step += (tail - int(d[:, -1].max(1).values.sum())) * 32
    d = torch.nn.functional.pad(d, (0, 0, 0, 0, 0, -n % 16))
    moving_on = int(d.view(-1, 16, d.shape[1], 32).sum(1).max(2).values
                    .sum()) * 32
    del d
    F, S, Wn, L = (fc.num_features, fc.dec.shape[1], fc.dec.shape[2],
                   fc.leaf.shape[1])
    K = fc.num_class
    Fu = w.feat.shape[0]
    compact = sum(t.numel() * t.element_size() for t in w[:6])
    nbytes = 4 * Fu * n + compact + 4 * K * n
    jax_bytes = (4 * F * n + 4 * K * n + 16 * T * S + T * S * Wn + 4 * T * L
                 + 4 * T)
    ops_ms = (visits + n * T) / H100_F32_FLOPS * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    jax_bytes_ms = jax_bytes / H100_BYTES_PER_S * 1e3
    shape = (w.rec.shape[1], w.leaf.shape[1], Fu, K)
    lp = forest_ops.launch_plan(forest_ops.plan_for(fc, n, 0, T), *shape,
                                dev)
    host = host_us(lambda: forest_ops.forest_predict(codes, fc, 0, T), 50)
    return {"rows": n, "ms": ms, "queued_ms": queued,
            "plain_ms": plain_ms, "host_us": host,
            "alternatives": (plan_readings(gbdt, codes, dev)
                             if alternatives else {}),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_ms_jax_layout": max(jax_bytes_ms, ops_ms),
            "visits": visits, "bytes": nbytes, "bytes_jax_layout": jax_bytes,
            "lanes_busy": {"in_step": visits / in_step,
                           "moving_on": visits / moving_on},
            "compact_bytes": compact,
            "plan": {k: lp[k] for k in (
                "code_bytes", "rec_bytes", "warps", "batch", "rows",
                "chunks", "buffers", "blocks_per_sm", "tiles", "grid",
                "smem")}}


def plan_readings(gbdt, codes, dev) -> dict:
    """The forest kernel's ms per launch on ``codes`` with the card's
    queue full, by its plan and by each other launch the code keeps: for
    scores the other chunk-slot counts that fit (the range resident,
    double-buffered, one slot, records read from global memory), the
    other batch of rows (8 or 16) and 16-byte records; for leaf indices
    the other chunk-slot counts. Each one's output bit-equal to the
    plan's."""
    import torch
    from lightgbm_tpu_torch.ops import forest as forest_ops
    from lightgbm_tpu_torch.ops import stacked_predict as sp
    from lightgbm_tpu_torch.utils.log import LightGBMError
    sm = gbdt._stacked_model()
    fc = sm.forest
    w = fc.walk
    T = len(fc.root_host)
    n = codes.shape[1]
    shape = (n, 0, T, w.rec.shape[1], w.leaf.shape[1], w.feat.shape[0],
             fc.num_class, w.code_bytes)
    models = gbdt.models
    wide = fc._replace(walk=sp._compact_tables(
        [np.asarray(t.split_feature[:t.num_leaves - 1]) for t in models],
        [np.asarray(t.left_child[:t.num_leaves - 1]) for t in models],
        [np.asarray(t.right_child[:t.num_leaves - 1]) for t in models],
        fc.dec.numpy(), sm._rep_sizes, fc.leaf.numpy(), fc.root_host,
        sm._offsets, sm._zero_bands(sm._reps), True, dev))
    out = {}
    for leaf_mode in (False, True):
        plan = forest_ops.plan_for(fc, n, 0, T, leaf_mode)
        runs = {"plan": (fc, plan)}
        for b in sorted({plan.chunks, 2, 1, 0} - {plan.buffers},
                        reverse=True):
            if b <= plan.chunks:
                try:
                    runs[f"buffers {b}"] = (fc, forest_ops._plan(
                        *shape, w.rec_bytes, not leaf_mode, buffers=b,
                        batch=plan.batch))
                except LightGBMError:
                    pass
        if not leaf_mode:
            other = forest_ops.BATCH + forest_ops.BATCH_GROUPED - plan.batch
            runs[f"batch {other}"] = (fc, forest_ops._plan(
                *shape, w.rec_bytes, True, batch=other))
            runs["16-byte records"] = (wide, forest_ops._plan(
                *shape, 16, True, batch=plan.batch))
        want = forest_ops._predict(codes, fc, 0, T, leaf_mode, plan)
        for label, (f, p) in runs.items():
            got = forest_ops._predict(codes, f, 0, T, leaf_mode, p)
            assert torch.equal(got, want), f"{label}: != the plan's output"
            out[("leaves, " if leaf_mode else "") + label] = {
                "queued_ms": queued_ms(lambda: forest_ops._predict(
                    codes, f, 0, T, leaf_mode, p), 10),
                "warps": p.warps, "batch": p.batch, "rows": p.rows,
                "buffers": p.buffers}
        del want, got
    return out


def kernel_line(label: str, r: dict, T: int) -> str:
    """One line of ``measure_kernel``'s reading."""
    return (f"{label} kernel: {r['ms']:.4f} ms per {r['rows']}-row launch "
            f"by calls back to back ({r['rows'] / r['ms'] * 1e3:.0f} rows/s;"
            f" {r['queued_ms']:.4f} ms with the card's queue full), plain "
            f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}; {r['bytes']} bytes with the compact tables "
            f"of {r['compact_bytes']} bytes), with the JAX layout's "
            f"per-node tables {r['bound_ms_jax_layout']:.5f} ms "
            f"({r['bytes_jax_layout']} bytes); {r['visits']} node visits "
            f"({r['visits'] / r['rows'] / T:.2f} per row-tree; lanes busy "
            f"{r['lanes_busy']['in_step']:.3f} in step, "
            f"{r['lanes_busy']['moving_on']:.3f} moving on); host "
            f"{r['host_us']:.1f} us a call; plan {r['plan']}; launches "
            f"with the queue full (ms): "
            + ", ".join(f"{k} {v['queued_ms']:.4f}"
                        for k, v in r["alternatives"].items()))


def check_forest(label: str, bst, X: np.ndarray, prob: np.ndarray,
                 dev, convert=None, alternatives: bool = True) -> dict:
    """Every row of ``bst.predict(X)``'s forest launches (``prob``, the
    main path's output) against the plain version on the same codes, cut
    into chunks as predict cuts them (device binning where the model has
    it, else the host's): scores and leaf indices bit for bit, and the
    main path's probabilities from the plain scores (``convert`` of the
    [N, K] float64 raw scores; None: the binary sigmoid of column 0).
    Returns the kernel's reading at the first chunk (``measure_kernel``,
    with or without ``alternatives``) with ``max_abs_err``."""
    import torch
    from lightgbm_tpu_torch.ops import forest as forest_ops
    from lightgbm_tpu_torch.ops import stacked_predict as sp
    sm = bst._gbdt._stacked_model()
    fc = sm.forest
    fcd = fc.to(dev)
    T = len(fc.root_host)
    k_raw, p_raw, first = [], [], None
    for c0 in range(0, X.shape[0], sp.ROW_CHUNK):
        part = X[c0:c0 + sp.ROW_CHUNK]
        if sm.edges is not None:
            codes = sp.codes_from_x(
                torch.from_numpy(part.astype(np.float32)).to(dev),
                *sm.edges)
        else:
            codes = torch.from_numpy(np.ascontiguousarray(
                sm._bin_rows(part.astype(np.float64)).T)).to(dev)
        first = codes if first is None else first
        k_raw.append(forest_ops.forest_predict(codes, fc, 0, T).cpu())
        p_raw.append(forest_ops.forest_predict_plain(codes, fcd, 0, T).cpu())
        k_leaf = forest_ops.forest_predict(codes, fc, 0, T, leaf_mode=True)
        p_leaf = forest_ops.forest_predict_plain(codes, fcd, 0, T,
                                                 leaf_mode=True)
        assert torch.equal(k_leaf, p_leaf), f"{label}: kernel != plain leaves"
        del k_leaf, p_leaf
    del fcd
    k_raw, p_raw = torch.cat(k_raw), torch.cat(p_raw)
    assert torch.equal(k_raw, p_raw), f"{label}: kernel != plain scores"
    raw = p_raw.numpy().astype(np.float64)
    want = (1.0 / (1.0 + np.exp(-raw[:, 0])) if convert is None
            else convert(raw))
    assert np.array_equal(prob, want), f"{label}: main path != plain"
    r = measure_kernel(bst._gbdt, first, dev, alternatives)
    r["max_abs_err"] = float((k_raw - p_raw).abs().max())
    print(f"{label} check: kernel == plain on all {X.shape[0]} rows, "
          f"scores and leaf indices (the main path's probabilities too)")
    print(kernel_line(label, r, T))
    return r


def wall_ms(fn, runs: int) -> list:
    """Host-clock milliseconds of each of ``runs`` calls of ``fn``, each
    ending in a synchronize."""
    import torch
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def device_busy(fn, runs: int):
    """(wall ms, device-busy ms) of one window of ``runs`` calls of
    ``fn``: the host clock around the window, and the time the card
    spent in kernels and copies in it, from torch.profiler's CUDA
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return wall, busy


def host_ops(fn, runs: int, k: int = 6) -> str:
    """The ``k`` operators with the most host time over ``runs`` calls of
    ``fn`` (torch.profiler's self CPU time, per call, with their counts
    per call): where the host's part of an iteration goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    ev = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3 / runs:.2f} ms "
                     f"x{e.count // runs}" for e in ev[:k])


def host_prep_ms(X: np.ndarray) -> float:
    """Host time of predict's first step at this input: the float64 view
    and the f32-exactness check that picks device binning."""
    from lightgbm_tpu_torch.ops import stacked_predict as sp
    t0 = time.perf_counter()
    X64 = np.ascontiguousarray(np.asarray(X, np.float64))
    assert sp._f32_exact(X64, X64.astype(np.float32))
    return (time.perf_counter() - t0) * 1e3


def _clone(a):
    import torch
    if torch.is_tensor(a):
        return a.clone()
    if isinstance(a, tuple):
        return tuple(_clone(x) for x in a)
    return a


class Capture:
    """Calls ``fn`` and keeps clones of the tensor arguments (positional
    ``args``, keyword ``kw``) of its first call, or with ``key``, of the
    first call with the largest ``key(args)`` (cloned before the call: K3
    updates its scores in place)."""

    def __init__(self, fn, key=None):
        self.fn = fn
        self.key = key
        self.args = None
        self.kw = {}
        self.best = None
        self.hits = 0          # calls whose key is >= 0

    def __call__(self, *args, **kw):
        k = None if self.key is None else self.key(args)
        self.hits += k is not None and k >= 0
        if self.args is None or (k is not None and k > self.best):
            self.args = _clone(args)
            self.kw = {name: _clone(v) for name, v in kw.items()}
            self.best = k
        return self.fn(*args, **kw)


def _categorical_width(args) -> int:
    """A K1 call's wave width if its split table has a categorical slot,
    else -1 (reads the slots' flags back from the card)."""
    from lightgbm_tpu_torch.ops import hist_wave as hw
    tbl = args[5]
    if tbl.shape[0] <= hw.TBL_ROWS_NUM or not bool(
            tbl[hw.TBL_ISCAT].any()):
        return -1
    return tbl.shape[1]


@contextlib.contextmanager
def capturing():
    """While active, the grower's K1 and K2 calls and the boosting loop's
    K3 call go through Captures: K2's first call (the first root pass),
    K1's first, its widest and its widest with a categorical slot ("K1c",
    whose ``hits`` count the waves with categorical slots), K3's first.
    Yields them by name."""
    from lightgbm_tpu_torch.models import gbdt as gbdt_mod
    from lightgbm_tpu_torch.ops import wave_grower as wg
    k1 = Capture(wg.fused_partition_histogram)
    caps = {"K1": k1, "K2": Capture(wg.wave_histogram),
            "K3": Capture(gbdt_mod.add_leaf_outputs),
            "K1w": Capture(k1, key=lambda a: a[5].shape[1])}
    caps["K1c"] = Capture(caps["K1w"], key=_categorical_width)
    wg.fused_partition_histogram = caps["K1c"]
    wg.wave_histogram = caps["K2"]
    gbdt_mod.add_leaf_outputs = caps["K3"]
    try:
        yield caps
    finally:
        wg.fused_partition_histogram = k1.fn
        wg.wave_histogram = caps["K2"].fn
        gbdt_mod.add_leaf_outputs = caps["K3"].fn


def bound(nbytes: float, ops: float) -> dict:
    """The least time for a function: bytes over HBM bandwidth or its
    operations over the rate of the CUDA cores (f32, and int32 adds,
    counted at the same rate), whichever is larger."""
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_F32_FLOPS * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": int(nbytes), "ops": int(ops)}


def f32_sum_bound(counts, abs_sums):
    """Worst-case error of any order of f32 additions of a cell's
    values: (count - 1) * 2**-24 * sum |v| (the gamma_{n-1} bound),
    with 1% headroom for its second-order term."""
    return (counts - 1).clamp(min=0) * 2.0 ** -24 * abs_sums * 1.01


def plain_in_kernel_order(plain, args):
    """``plain(*args)`` in the f32 kernels' order of addition, on the
    CPU (``hist_wave.plain_in_kernel_order``); ``plain`` passes keywords
    on to a plain histogram version."""
    from lightgbm_tpu_torch.ops import hist_wave as hw
    return hw.plain_in_kernel_order(plain, *args)


def plain_kw(kw: dict) -> dict:
    """A wrapper's keyword arguments as its plain version takes them."""
    return {k: kw[k] for k in ("count_proxy", "packed4", "num_features",
                               "any_cat", "counted_rows") if k in kw}


def kernel_raw(kernel, kw: dict):
    """``kernel`` with the captured keywords and no dequantization: the
    raw sums the kernel writes."""
    kw = dict(kw, gh_scale=None)
    return lambda *a: kernel(*a, **kw)


def check_histogram(name, kernel, plain, args, hist_of, slots_of):
    """One histogram kernel (K1 or K2) on captured main-path inputs
    ``args`` (bins_t, g, h, ...): two launches bit-identical, and every
    channel (and K1's leaf ids) bit for bit equal to the plain version
    (``plain``, which passes keywords on) run on the CPU in the kernels'
    order of addition. A second reading,
    printed: the g and h sums against the plain version in float64, as a
    share of the f32 summation bound. Returns the stats."""
    import torch
    out1 = kernel(*args)
    out2 = kernel(*args)
    torch.cuda.synchronize()
    h1 = hist_of(out1)
    assert torch.equal(h1, hist_of(out2)), f"{name}: two launches differ"
    want = plain_in_kernel_order(plain, args)
    assert torch.equal(h1, hist_of(want)), \
        f"{name}: sums differ from the plain version in the kernels' order"
    if slots_of is not None:
        assert torch.equal(slots_of(out1), slots_of(out2)), \
            f"{name}: leaf ids differ between launches"
        assert torch.equal(slots_of(out1), slots_of(want)), \
            f"{name}: leaf ids differ from the plain version"
    bins_t, g, h = args[0], args[1], args[2]
    h64 = hist_of(plain(bins_t, g.double(), h.double(), *args[3:]))
    habs = hist_of(plain(bins_t, g.double().abs(), h.double().abs(),
                         *args[3:]))
    err = (h1[..., :2].double() - h64[..., :2]).abs()
    tol = f32_sum_bound(h64[..., 2:3], habs[..., :2])
    return {"max_abs_err": float((h1 - hist_of(want)).abs().max()),
            "max_abs_err_f64": float(err.max()),
            "max_bound_used": float((err / tol.clamp(min=1e-300)).max()),
            "rows_counted": int(h64[:, 0, :, 2].sum())}


def lib_index_add(args, dev, kw=None):
    """The K2 yardstick: one ``index_add_`` of the channels on a flat index
    built beforehand (the plain version's scatter): f32 for the f32 tier,
    int32 (g, h and, with exact counts, 1) for the int8 tier; packed bins
    are indexed as their unpacked features."""
    import torch
    from lightgbm_tpu_torch.ops import hist_wave as hw
    kw = kw or {}
    bins_t, g, h, leaf, wl, B = args
    if kw.get("packed4"):
        bins_t = hw.unpack4(bins_t, kw["num_features"])
    F, n = bins_t.shape
    W = wl.shape[0]
    eq = (leaf[None, :] == wl[:, None]) & (wl >= 0)[:, None]
    base = torch.where(eq.any(0), torch.argmax(eq.to(torch.uint8), 0)
                       * (F * B), W * F * B)
    flat = (base[None, :] + torch.arange(F, device=dev)[:, None] * B
            + bins_t.long()).reshape(-1)
    dt = torch.int32 if g.dtype == torch.int8 else torch.float32
    chans = [g.to(dt), h.to(dt), torch.ones((), dtype=dt, device=dev)]
    chans = chans[:2] if kw.get("count_proxy") else chans
    vals = torch.stack([c.expand(F, n) for c in chans], -1).reshape(
        -1, len(chans))
    out = torch.zeros(((W + 1) * F * B, len(chans)), dtype=dt, device=dev)

    def call():
        out.index_add_(0, flat, vals)
    return cuda_ms(call, 5)


def split_keys(tree) -> list:
    """(parent leaf, feature, threshold, decision type) of each split in
    split order. Split i's parent leaf is the leaf its left child keeps:
    the end of the left-child chain below node i."""
    keys = []
    for i in range(tree.num_leaves - 1):
        node = tree.left_child[i]
        while node >= 0:
            node = tree.left_child[node]
        keys.append((~node, tree.split_feature[i], tree.threshold[i],
                     tree.decision_type[i]))
    return keys


def tree_diff(a_models, b_models):
    """The first split where two lists of trees differ: None, or (tree,
    split, its gain in a, its gain in b); split -1 when every split
    agrees but a leaf or node count does not."""
    for t, (ta, tb) in enumerate(zip(a_models, b_models)):
        ka, kb = split_keys(ta), split_keys(tb)
        for i in range(max(len(ka), len(kb))):
            if i >= len(ka) or i >= len(kb) or ka[i] != kb[i]:
                ga = ta.split_gain[i] if i < len(ka) else 0.0
                gb = tb.split_gain[i] if i < len(kb) else 0.0
                return t, i, ga, gb
        if (ta.leaf_count != tb.leaf_count
                or ta.internal_count != tb.internal_count):
            return t, -1, 0.0, 0.0
    return None


def auc_np(y: np.ndarray, p: np.ndarray) -> float:
    """AUC with tied scores at their average rank."""
    order = np.argsort(p, kind="mergesort")
    ps, ys = p[order], y[order] > 0
    _, inv, cnt = np.unique(ps, return_inverse=True, return_counts=True)
    ends = np.cumsum(cnt)
    ranks = (ends - (cnt - 1) / 2.0)[inv]
    npos = ys.sum()
    nneg = len(ys) - npos
    return float((ranks[ys].sum() - npos * (npos + 1) / 2) / (npos * nneg))


def card_tree_in_kernel_order(booster, inputs, t: int) -> dict:
    """Tree ``t`` of a booster trained on the card, grown again on the
    card from the same grower inputs, with K1 and K2 swapped for their
    plain versions run on the CPU in the kernels' order: everything else,
    the split search included, runs as in training. Returns the record
    with the shrinkage folded as ``train_one_iter`` folds it (t >= 1: no
    bias). Equal records mean that every K1 and K2 launch of that tree
    matched its plain version bit for bit."""
    from lightgbm_tpu_torch.ops import hist_wave as hw
    from lightgbm_tpu_torch.ops import wave_grower as wg
    from lightgbm_tpu_torch.ops.f32math import fma
    gb = booster._gbdt
    assert gb._grower_cfg.precision == "f32"
    dev = gb.train_data.bins_t.device
    saved = wg.wave_histogram, wg.fused_partition_histogram

    def swap(plain):
        return lambda *a, gh_scale=None, precision="f32", **kw: \
            hw.plain_in_kernel_order(plain, *a, **plain_kw(kw))
    wg.wave_histogram = swap(hw.wave_histogram_plain)
    wg.fused_partition_histogram = swap(hw.fused_partition_histogram_plain)
    try:
        rec, _ = wg.WaveGrower.grow(gb._grower, gb.train_data.bins_t,
                                    *[x.to(dev) for x in inputs[t]])
    finally:
        wg.wave_histogram, wg.fused_partition_histogram = saved
    shrink = float(np.float32(gb.shrinkage_rate))
    return rec._replace(
        leaf_output=fma(rec.leaf_output, shrink, 0.0),
        internal_value=fma(rec.internal_value, shrink, 0.0)).to_numpy()


def explain_difference(runs: dict, t: int, i: int,
                       quantized: bool = False) -> dict:
    """Both runs' split number ``i`` of tree ``t`` (their first
    difference), each evaluated in float64 on each run's own grower
    inputs of that tree: the candidate's gain (l1 = 0), its two sides'
    hessian sums and counts. The trees agree on splits 0..i-1, so both
    candidates see the same leaf membership.

    The verdict is a near tie when the candidates' float64 gains differ
    by less than the f32 rounding that the two runs' own gains carry:
    each run's recorded f32 gain of its choice against that choice's
    float64 gain on its inputs, added over the two runs (a categorical
    candidate's gain adds cat_l2 to l2 in sorted mode, as the split
    search does). A leaf's f32
    histogram comes from its ancestors' by subtraction and carries their
    rounding, and two orders of addition can rank candidates that close
    either way. It is a hessian-boundary tie when a side's hessian sum
    lies within 1e-5 of min_sum_hessian_in_leaf, where f32 rounding
    decides validity. With ``quantized`` the gains are those of the
    tree's quantized g and h (ops/quantize.py, the same on both devices),
    dequantized, which is what that tier's splits maximise."""
    import torch
    from lightgbm_tpu_torch.ops.quantize import quantize
    from lightgbm_tpu_torch.ops.partition import row_goes_right
    from lightgbm_tpu_torch.ops.predict import replay_partition
    gb = runs["cpu"][0]._gbdt
    cfg, meta = gb.config, gb._grower.meta
    bins = gb.train_data.bins_t
    recs = {w: runs[w][0]._gbdt.records[t].to_numpy() for w in runs}
    cand = {w: tuple(int(r[k][i]) for k in ("split_leaf", "split_feature",
                                             "split_bin",
                                             "split_default_left",
                                             "split_is_cat"))
            + (tuple(int(x) for x in r["split_cat_words"][i]),)
            for w, r in recs.items()}
    leaf = replay_partition(gb.records[t]._replace(num_leaves=i + 1), bins,
                            meta)
    table = {}
    for src in runs:
        g, h, mask = runs[src][3][t][:3]
        if quantized:
            q = quantize(g.float() * mask, h.float() * mask)
            g = q.gq.double() * float(q.sg)
            h = q.hq.double() * float(q.sh)
        else:
            g, h = g.double() * mask.double(), h.double() * mask.double()
        for w, (lf, f, b, dl, ic, cw) in cand.items():
            rows = (leaf == lf) & (mask > 0)
            right = row_goes_right(bins[f].to(torch.int32), b, bool(dl),
                                   int(meta.missing_type[f]),
                                   int(meta.default_bin[f]),
                                   int(meta.num_bin[f]), bool(ic),
                                   torch.tensor(cw, dtype=torch.int32,
                                                device=bins.device))
            # a categorical split in sorted mode adds cat_l2
            l2 = cfg.lambda_l2 + (cfg.cat_l2 if ic and int(meta.num_bin[f])
                                  > cfg.max_cat_to_onehot else 0.0)
            side = {}
            for name, m in (("left", rows & ~right), ("right", rows & right)):
                side[name] = (float(g[m].sum()), float(h[m].sum()),
                              int(m.sum()))
            gl, hl, nl = side["left"]
            gr, hr, nr = side["right"]
            gain = (gl * gl / (hl + l2) + gr * gr / (hr + l2)
                    - (gl + gr) ** 2 / (hl + hr + l2))
            table[(src, w)] = {"leaf": lf, "feature": f, "bin": b,
                               "categorical": bool(ic), "gain": gain,
                               "hess": (hl, hr), "count": (nl, nr)}
    rounding = sum(abs(float(recs[w]["split_gain"][i]) - table[(w, w)]["gain"])
                   for w in runs)
    gap = max(abs(table[(src, "cuda")]["gain"] - table[(src, "cpu")]["gain"])
              for src in runs)
    msh = cfg.min_sum_hessian_in_leaf
    boundary = any(abs(hs - msh) <= 1e-5 * msh
                   for v in table.values() for hs in v["hess"])
    return {"table": table, "gap": gap, "rounding": rounding,
            "gain_tie": gap <= rounding, "hessian_boundary": boundary}


def card_and_cpu(params: dict, X, y, iters: int, fobj=None,
                 init_model: str = None, **ds_kw) -> dict:
    """``iters`` ``Booster.update(fobj=fobj)`` calls from the same rows on
    the card and with ``device="cpu"``: {"cuda" | "cpu": (booster, train
    metrics, seconds, each tree's grower inputs on the CPU)}; the inputs
    let ``explain_difference`` attribute a first difference. With
    ``init_model`` (model text) training continues from that model, its
    raw scores predicted on each run's device."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.basic import _InnerPredictor
    runs = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        device = None if where == "cuda" else "cpu"
        ds = lgt.Dataset(X, label=y, **ds_kw)
        if init_model is not None:
            ds._set_predictor(_InnerPredictor(model_str=init_model,
                                              device=device))
        b = lgt.Booster(params, ds, device=device)
        grower = b._gbdt._grower
        inputs = []

        def grow(*args, _grow=grower.grow, _inputs=inputs, **kw):
            _inputs.append([a.cpu() for a in args[1:]])
            return _grow(*args, **kw)
        grower.grow = grow
        for _ in range(iters):
            b.update(fobj=fobj)
        b.model_to_string()
        runs[where] = (b, dict((m, v) for _, m, v, _ in b.eval_train()),
                       time.perf_counter() - t0, inputs)
    return runs


def judge_trees(runs: dict, quantized: bool = False, metric: str = "auc",
                tol: float = 0.0) -> tuple:
    """The card's trees against the CPU's: equal, or equal up to a first
    difference that ``explain_difference`` finds a near tie; the train
    AUC within AUC_TOL, or another train ``metric`` within ``tol``
    relative. Returns (tree_diff's result, a line saying where the trees
    part)."""
    gm, cm = runs["cuda"][0]._gbdt.models, runs["cpu"][0]._gbdt.models
    assert len(gm) == len(cm), (len(gm), len(cm))
    diff = tree_diff(gm, cm)
    a, b = runs["cuda"][1][metric], runs["cpu"][1][metric]
    bar = AUC_TOL if metric == "auc" else tol * max(abs(b), 1e-12)
    assert abs(a - b) <= bar, f"card vs CPU {metric}: {a} against {b}"
    if diff is None:
        where = f"all {len(gm)} trees equal in structure and counts"
        if (runs["cuda"][0].model_to_string()
                == runs["cpu"][0].model_to_string()):
            where += "; model text byte-equal"
        return diff, where
    t, i, ga, gc = diff
    why = explain_difference(runs, t, i, quantized)
    for (src, w), v in why["table"].items():
        rule = ("in a categorical left set" if v["categorical"]
                else f"<= bin {v['bin']}")
        print(f"  tree {t} split {i} chosen on the {w}: leaf {v['leaf']}, "
              f"feature {v['feature']} {rule}; on the {src} run's "
              f"gradients: gain {v['gain']:.9g}, hessian sums "
              f"{v['hess'][0]:.9g} | {v['hess'][1]:.9g}, rows "
              f"{v['count'][0]} | {v['count'][1]}")
    print(f"  float64 gain gap {why['gap']:.6g}; the f32 rounding of the "
          f"two runs' own gains {why['rounding']:.6g}")
    assert why["gain_tie"] or why["hessian_boundary"], \
        f"card and CPU trees differ at tree {t} split {i}, not a tie"
    kind = ("a near tie in gain" if why["gain_tie"] else
            "a hessian sum at min_sum_hessian_in_leaf")
    return diff, (f"trees equal up to tree {t}, split {i}, {kind} (split "
                  f"gains {ga:.7g} on the card, {gc:.7g} on the CPU)")


def check_leaf_gather(args) -> dict:
    """K3 on a captured score update (scores, leaf ids, leaf outputs,
    shrinkage): bit for bit against its plain version, with its time, its
    plain version's, the library call ``table.index_select(0, leaf_ids)``
    (the gather alone, 8 bytes a row against K3's 12, for ids in range)
    and the bound. K3 and the library call are timed alike, over a run of
    K3_RUNS launches between one pair of events; the host's microseconds
    per call of each are a second reading."""
    import torch
    from lightgbm_tpu_torch.ops import predict as pr
    sc, leaf, table, shrink = args
    n = sc.shape[0]
    got = pr.add_leaf_outputs(sc.clone(), leaf, table, shrink)
    want = pr.add_leaf_outputs_plain(sc.clone(), leaf, table, shrink)
    assert torch.equal(got, want), "K3 != plain"
    s1, s2 = sc.clone(), sc.clone()

    def k3():
        pr.add_leaf_outputs(s1, leaf, table, shrink)

    def lib():
        table.index_select(0, leaf)
    return dict(
        max_abs_err=0.0, shape=f"N={n}, L={table.shape[0]}",
        ms=cuda_ms(k3, K3_RUNS, warmup=5),
        plain_ms=cuda_ms(
            lambda: pr.add_leaf_outputs_plain(s2, leaf, table, shrink), 20),
        library_ms=cuda_ms(lib, K3_RUNS, warmup=5),
        host_us=host_us(k3, K3_RUNS), library_host_us=host_us(lib, K3_RUNS),
        **bound(12 * n + 4 * table.shape[0], 2 * n))


def pass_report(label: str, kid: str, fn, args, kw: dict,
                counted: int) -> dict:
    """The f32 histogram pass of a captured K2 or K1 launch
    (``fn(*args)``): its plan on this card (features per group Fg, slot
    classes, warps, blocks resident per SM, grid, row ranges), the share
    of rows it counts, and the card's time in its slot, histogram and
    reduce kernels, from CUDA events the launch records at its pass
    boundaries (``hist_wave.pass_times``, PASS_RUNS launches;
    torch.profiler drops these kernels' records in the later phases of
    this long run). Prints one line; returns them."""
    from lightgbm_tpu_torch.ops import hist_wave as hw
    bins_t, B = args[0], args[-1]
    F = kw.get("num_features") or bins_t.shape[0]
    n = bins_t.shape[1]
    W = args[4].shape[0] if kid == "K2" else args[5].shape[1]
    lp = hw.launch_plan(n, F, W, B, bool(kw.get("packed4")), bins_t.device,
                        kw.get("counted_rows"))
    fn(*args)
    split = hw.pass_times(lambda: fn(*args), PASS_RUNS)
    print(f"  {label} {kid} f32 pass: counts {counted} of {n} rows "
          f"({counted / max(n, 1):.4f}); Fg {lp['fg']} of {F} features, "
          f"{lp['classes']} slot classes, {lp['warps']} warps a block, "
          f"{lp['blocks_per_sm']} blocks/SM, grid {lp['grid']}, "
          f"{lp['ranges']} ranges of {lp['rows_per_range']} rows; card ms "
          "a launch: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    return {"counted_share": counted / max(n, 1), "split_ms": split,
            "plan": {k: lp[k] for k in ("fg", "classes", "warps",
                                         "blocks_per_sm", "grid", "ranges",
                                         "rows_per_range")}}


def int_pass_report(kid: str, fn, args, kw: dict, counted: int) -> dict:
    """The int8 histogram pass of a captured K2q or K1q launch
    (``fn(*args)``): its plan on this card (``hist_wave.int_plan``:
    features per group Fg, slot classes, copies of each cell, the kernel
    instance's byte rows and blocks an SM, units, row parts; blocks
    resident per SM, grid, 8-byte loads or byte loads), the
    share of rows it counts, and the card's time in its slot, histogram
    and flush kernels, from CUDA events the launch records at its pass
    boundaries (``hist_wave.pass_times``, PASS_RUNS launches). Returns
    them and a line to print."""
    from lightgbm_tpu_torch.ops import hist_wave as hw
    bins_t, g, h, B = args[0], args[1], args[2], args[-1]
    F = kw.get("num_features") or bins_t.shape[0]
    n = bins_t.shape[1]
    W = args[4].shape[0] if kid == "K2" else args[5].shape[1]
    C = 2 if kw.get("count_proxy") else 3
    vec = hw.int_aligned(bins_t, g, h)
    lp = hw.launch_int_plan(n, F, W, B, C, bool(kw.get("packed4")), vec,
                            bins_t.device)
    fn(*args)
    t = hw.pass_times(lambda: fn(*args), PASS_RUNS)
    split = {"slot": t["slot"], "histogram": t["histogram"],
             "flush": t["reduce"]}
    plan = {k: lp[k] for k in ("fg", "classes", "copies", "byte_rows",
                               "blocks", "units", "parts", "rows_per_part",
                               "blocks_per_sm", "grid", "vec")}
    line = (f"counts {counted / max(n, 1):.4f} of the rows; plan Fg "
            f"{lp['fg']}, {lp['classes']} slot classes, {lp['copies']} "
            f"copies, {lp['units']} units x {lp['parts']} parts, "
            f"instance of {lp['byte_rows']} byte rows and {lp['blocks']} "
            f"blocks/SM, {lp['blocks_per_sm']} resident, grid {lp['grid']}, "
            f"{'8-byte' if vec else 'byte'} loads; card ms a launch: "
            + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    return {"counted_share": counted / max(n, 1), "split_ms": split,
            "plan": plan, "pass_line": line}


def check_kernels(caps, label: str, dev) -> dict:
    """K2, K1 and K3 against their plain versions on one training's
    captured inputs (check_histogram; K3 bit for bit), with each
    kernel's time, its plain version's, the library call's and the
    bound at those shapes. K2 is the first root pass, K1 the first and
    the widest wave (the widest is timed), K3 the first score update."""
    import torch
    from lightgbm_tpu_torch.ops import hist_wave as hw
    from lightgbm_tpu_torch.ops import predict as pr
    a2, a1 = caps["K2"].args, caps["K1w"].args
    kw2, kw1 = caps["K2"].kw, caps["K1w"].kw
    bins_t, B = a2[0], a2[-1]
    F, n = bins_t.shape
    out = {}

    def k2(*a):
        return hw.wave_histogram(*a, **kw2)

    def p2(*a, **k):
        return hw.wave_histogram_plain(*a, **plain_kw(kw2), **k)

    def k1(*a):
        return hw.fused_partition_histogram(*a, **kw1)

    def p1(*a, **k):
        return hw.fused_partition_histogram_plain(*a, **plain_kw(kw1), **k)
    st2 = check_histogram("K2", k2, p2, a2, lambda o: o, None)
    W2 = a2[4].shape[0]
    out["K2"] = dict(
        st2, shape=f"F={F}, N={n}, W={W2}, B={B}",
        ms=cuda_ms(lambda: k2(*a2), 5),
        plain_ms=cuda_ms(lambda: p2(*a2), 3),
        library_ms=lib_index_add(a2, dev),
        **pass_report(label, "K2", k2, a2, kw2, st2["rows_counted"]),
        **bound(F * n + 12 * n + 4 * W2 + 12 * W2 * F * B,
                3 * F * st2["rows_counted"]))
    first = check_histogram("K1", k1, p1, caps["K1"].args, lambda o: o[1],
                            lambda o: o[0])
    st1 = check_histogram("K1", k1, p1, a1, lambda o: o[1], lambda o: o[0])
    W1 = a1[5].shape[1]
    out["K1"] = dict(
        st1, shape=f"F={F}, N={n}, W={W1}, B={B}",
        first_wave={"W": caps["K1"].args[5].shape[1],
                    "max_abs_err_f64": first["max_abs_err_f64"]},
        in_bag_rows=int((a1[3] > 0).sum()),
        ms=cuda_ms(lambda: k1(*a1), 5),
        plain_ms=cuda_ms(lambda: p1(*a1), 3),
        library_ms=None,
        **pass_report(label, "K1", k1, a1, kw1, st1["rows_counted"]),
        **bound(F * n + 20 * n + 36 * W1 + 12 * W1 * F * B,
                n + 3 * F * st1["rows_counted"]))
    out["K3"] = check_leaf_gather(caps["K3"].args)
    for name in ("K2", "K1"):
        k = out[name]
        lib = k["library_ms"]
        print(f"{label} {name} at [{k['shape']}]: {k['ms']:.3f} ms, plain "
              f"{k['plain_ms']:.3f} ms, library "
              f"{'none' if lib is None else f'{lib:.3f} ms'}, bound "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']}); bit-equal to the "
              f"plain version in the kernels' order (sums, counts"
              f"{', leaf ids' if name == 'K1' else ''}); g/h within "
              f"{k['max_abs_err_f64']:.3g} of float64 "
              f"({k['max_bound_used']:.4f} of the f32 bound); two launches "
              f"bit-identical")
    print(f"{label} K1, first wave (W={out['K1']['first_wave']['W']}): "
          f"bit-equal too, g/h within {first['max_abs_err_f64']:.3g} of "
          f"float64; widest wave {out['K1']['in_bag_rows']} of {n} rows in "
          f"bag")
    k = out["K3"]
    print(f"{label} K3 at [{k['shape']}]: {k['ms']:.4f} ms a launch over "
          f"{K3_RUNS} ({100 * k['bound_ms'] / k['ms']:.0f}% of the bound), "
          f"plain {k['plain_ms']:.4f} ms, library (index_select, the "
          f"gather alone) {k['library_ms']:.4f} ms over {K3_RUNS}, bound "
          f"{k['bound_ms']:.4f} ms ({k['bound_by']}); host {k['host_us']:.1f}"
          f" us a call (index_select {k['library_host_us']:.1f}); bit-equal "
          f"to plain")
    return out


def _counters() -> dict:
    from lightgbm_tpu_torch.ops import forest as forest_ops
    from lightgbm_tpu_torch.ops import hist_wave as hw
    from lightgbm_tpu_torch.ops import predict as pr
    out = {"K2": hw.k2_launches, "K1": hw.k1_launches, "K3": pr.launches,
           "K4": forest_ops.launches, "K1/cat": hw.k1_cat_launches}
    for v in hw.VARIANTS:
        out[f"K2/{v}"] = hw.k2_variant_launches[v]
        out[f"K1/{v}"] = hw.k1_variant_launches[v]
    return out


def reset_counts() -> None:
    """Sets every kernel's launch count (and each histogram variant's) to
    0, after the card has finished what it was given."""
    import torch
    torch.cuda.synchronize()
    for c in _counters().values():
        c.reset()


def read_counts() -> dict:
    """Launches since ``reset_counts``: K1, K2, K3 and K4 in all, and each
    histogram variant launched at least once ("K2/proxy", ...)."""
    import torch
    torch.cuda.synchronize()
    return {k: c.value for k, c in _counters().items()
            if c.value or "/" not in k}


def train_phases(dev) -> tuple:
    """Phases 6-9 of the module docstring. Returns the kernels-line
    entries of K2, K1 and K3, and phase 7's rows, holdout AUC, model
    text, ms an iteration, busy share and launches, with phase 6's model
    text, ms an iteration and launches under "lrb" (for phases 10-14 and
    21)."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import capi
    reset, read = reset_counts, read_counts

    # 6. LRB window training through the C-API sequence, capturing kernel
    # inputs (bagging is on from the first iteration)
    X = make_lrb_rows(LRB_TRAIN_ROWS, seed=21)
    y = lrb_labels(X, seed=22)
    Xn = make_lrb_rows(LRB_NEXT_ROWS, seed=23)
    yn = lrb_labels(Xn, seed=24)
    with capturing() as lrb_caps:
        reset()
        t0 = time.perf_counter()
        ds = capi.LGBM_DatasetCreateFromMat(X, parameters=TRAIN_PARAMS)
        capi.LGBM_DatasetSetField(ds, "label", y)
        bst = capi.LGBM_BoosterCreate(ds, TRAIN_PARAMS)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        iters = []
        for _ in range(int(TRAIN_PARAMS["num_iterations"])):
            t1 = time.perf_counter()
            finished = capi.LGBM_BoosterUpdateOneIter(bst)
            torch.cuda.synchronize()
            iters.append(time.perf_counter() - t1)
            if finished:
                break
        evals = dict(capi.LGBM_BoosterGetEval(bst, 0))
        text = capi.LGBM_BoosterSaveModelToString(bst)
        pred = np.asarray(capi.LGBM_BoosterPredictForMat(bst, Xn))
        lrb_counts = read()
    assert all(v > 0 for v in lrb_counts.values()), lrb_counts
    assert bool((lrb_caps["K1"].args[3] == 0).any()), "no out-of-bag rows"
    assert pred.shape == (LRB_NEXT_ROWS,) and np.isfinite(pred).all()
    assert evals["auc"] > 0.6, evals
    host = host_raw(lgt.Booster(model_str=text, device="cpu")._gbdt,
                    Xn[:SUBSET])[0]
    err_host = float(np.abs(pred[:SUBSET] - 1 / (1 + np.exp(-host))).max())
    assert err_host <= 1e-5, f"lrb model text: {err_host} from host walk"
    n_it = len(iters)
    lrb_ms = 1e3 * float(np.median(iters))
    print(f"lrb training: {LRB_TRAIN_ROWS} x {LRB_FEATURES}, {n_it} "
          f"iterations; binning and setup {setup_s:.2f} s; median "
          f"{lrb_ms:.1f} ms/iteration, "
          f"{LRB_TRAIN_ROWS * n_it / sum(iters):.0f} row-iterations/s; "
          f"train auc {evals['auc']:.5f}, binary_logloss "
          f"{evals['binary_logloss']:.5f}; next window auc "
          f"{auc_np(yn, pred):.5f}; model text scores within "
          f"{err_host:.2g} of the host walk; launches {lrb_counts}")
    wall, busy = device_busy(lambda: capi.LGBM_BoosterUpdateOneIter(bst), 3)
    print(f"lrb profile, one window of 3 iterations: wall {wall:.1f} ms, "
          f"device busy {busy:.2f} ms ({100 * busy / wall:.1f}%); host time "
          f"per iteration by operator: "
          f"{host_ops(lambda: capi.LGBM_BoosterUpdateOneIter(bst), 3)}")
    capi.LGBM_BoosterFree(bst)
    del X, ds, bst
    lrb_run = {"text": text, "ms": lrb_ms, "counts": lrb_counts,
               "pred": pred}

    # 7. HIGGS-shape training through train(), capturing kernel inputs
    X, y = make_higgs_like(HIGGS_TRAIN_ROWS)
    Xt, yt = make_higgs_like(HOLDOUT_ROWS, seed=8)
    with capturing() as higgs_caps:
        reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ds = lgt.Dataset(X, label=y, params=HIGGS_PARAMS).construct()
        torch.cuda.synchronize()
        bin_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bst = lgt.train(HIGGS_PARAMS, ds, num_boost_round=HIGGS_ITERS)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        higgs_counts = read()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for k in ("K1", "K2", "K3"):
        assert higgs_counts[k] > 0, higgs_counts
    prob = bst.predict(Xt)
    assert prob.shape == (HOLDOUT_ROWS,) and np.isfinite(prob).all()
    auc_t = auc_np(yt, prob)
    assert auc_t > 0.7, auc_t
    host = host_raw(bst._gbdt, Xt[:SUBSET].astype(np.float64))[0]
    err_host = float(np.abs(prob[:SUBSET] - 1 / (1 + np.exp(-host))).max())
    assert err_host <= 1e-5, f"higgs: {err_host} from the host walk"
    leaves = [t.num_leaves for t in bst._gbdt.models]
    print(f"higgs training: {HIGGS_TRAIN_ROWS} x 28, {HIGGS_ITERS} "
          f"iterations of {leaves} leaves; binning {bin_s:.2f} s; train "
          f"{train_s:.2f} s = {1e3 * train_s / HIGGS_ITERS:.1f} "
          f"ms/iteration, {HIGGS_TRAIN_ROWS * HIGGS_ITERS / train_s:.0f} "
          f"row-iterations/s; holdout auc {auc_t:.5f}; peak device memory "
          f"{peak_gb:.2f} GB; launches {higgs_counts}")
    higgs_text = bst.model_to_string()
    wall, busy = device_busy(bst.update, 2)
    print(f"higgs profile, one window of 2 iterations: wall {wall:.1f} ms, "
          f"device busy {busy:.2f} ms ({100 * busy / wall:.1f}%)")
    del bst, ds
    higgs_data = {"X": X, "y": y, "Xt": Xt, "yt": yt, "auc": auc_t,
                  "text": higgs_text, "counts": higgs_counts,
                  "ms": 1e3 * train_s / HIGGS_ITERS, "busy": busy / wall,
                  "lrb": lrb_run}

    # 8. each kernel against its plain version at the captured shapes
    t0 = time.perf_counter()
    lrb = check_kernels(lrb_caps, "lrb", dev)
    higgs = check_kernels(higgs_caps, "higgs", dev)
    del lrb_caps, higgs_caps
    print(f"kernel checks: {time.perf_counter() - t0:.1f} s")

    # 9. card vs CPU on the LRB parameters at 100,000 rows: the same
    # Booster.update loop train() runs, with each tree's grower inputs
    # kept to attribute the first difference
    X = make_lrb_rows(CPU_ROWS, seed=31)
    y = lrb_labels(X, seed=32)
    runs = card_and_cpu(TRAIN_PARAMS, X, y,
                        int(TRAIN_PARAMS["num_iterations"]))
    diff, where = judge_trees(runs)
    gm = runs["cuda"][0]._gbdt.models
    # the card's tree at the first difference (else its last), grown
    # again with the histograms in the kernels' order: bit for bit
    t = len(gm) - 1 if diff is None else diff[0]
    assert t >= 1, f"card and CPU differ in the first tree: {diff}"
    emu = card_tree_in_kernel_order(runs["cuda"][0], runs["cuda"][3], t)
    card = runs["cuda"][0]._gbdt.records[t].to_numpy()
    for k in card:
        assert np.array_equal(emu[k], card[k]), \
            f"card tree {t}: {k} differs from the kernel-order plain grower"
    print(f"  card tree {t} grown again with K1/K2 as their plain versions "
          f"in the kernels' order: the record is equal bit for bit")
    print(f"card vs CPU, {CPU_ROWS} LRB rows x {len(gm)} iterations: {where};"
          f" train auc {runs['cuda'][1]['auc']:.6f} vs "
          f"{runs['cpu'][1]['auc']:.6f} (within {AUC_TOL}); "
          f"{runs['cuda'][2]:.1f} s on the card, {runs['cpu'][2]:.1f} s on "
          f"the CPU")

    out = []
    src = "lightgbm_tpu_torch/csrc/"
    notes = {"K2": ("index_add_ of the three channels on a flat index "
                    "built beforehand"),
             "K1": ("no single PyTorch call partitions rows and builds "
                    "their histograms"),
             "K3": ("table.index_select(0, leaf_ids): the gather alone, "
                    "for ids in range")}
    keep = ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err", "max_abs_err_f64", "counted_share", "split_ms",
            "plan", "host_us", "library_host_us")
    for name, kid, path, rep in (
            ("wave_histogram", "K2", "hist_wave.cu",
             "lightgbm_tpu/ops/hist_wave.py:482"),
            ("fused_partition_histogram", "K1", "hist_wave.cu",
             "lightgbm_tpu/ops/hist_wave.py:984"),
            ("leaf_gather_add", "K3", "leaf_gather.cu",
             "lightgbm_tpu/ops/predict.py:64")):
        k = higgs[kid]
        out.append({
            "name": name, "route": "cuda", "source": src + path,
            "replaces": rep,
            "launches": (lrb_counts[kid] + higgs_counts[kid]
                         if kid == "K3" else lrb_counts[f"{kid}/f32"]
                         + higgs_counts[f"{kid}/f32"]),
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "library_note": notes[kid],
            "shape": k["shape"],
            "launches_per_iteration": {"lrb": lrb_counts[kid] / n_it,
                                       "higgs": higgs_counts[kid]
                                       / HIGGS_ITERS},
            "vs_plain": ("bitwise" if kid == "K3" else
                         "bitwise against the plain version run in the "
                         "kernels' order of addition"),
            "lrb": {f: lrb[kid][f] for f in keep if f in lrb[kid]},
            **{f: k[f] for f in keep[8:] if f in k},
            **({} if kid == "K3" else
               {"max_abs_err_f64": k["max_abs_err_f64"]})})
    return out, higgs_data


def check_int_histogram(name, kernel, plain, args, kw, outs_of) -> None:
    """An int8-tier kernel (K2q or K1q) on captured main-path inputs: two
    raw launches bit-identical and equal, every output (sums, and K1's
    leaf ids and cnt_r), to the plain version run on the card, whose
    integer sums do not depend on order."""
    import torch
    raw = kernel_raw(kernel, kw)
    out1, out2 = outs_of(raw(*args)), outs_of(raw(*args))
    want = outs_of(plain(*args, **plain_kw(kw)))
    torch.cuda.synchronize()
    assert len(out1) == len(want), name
    for a, b, c in zip(out1, out2, want):
        assert torch.equal(a, b), f"{name}: two launches differ"
        assert torch.equal(a, c), f"{name}: differs from the plain version"


def check_packed(name, kernel, args, kw, outs_of) -> None:
    """A packed launch (4-bit bins, two per byte) against the unpacked
    launch on the same rows: bit-identical outputs."""
    import torch
    from lightgbm_tpu_torch.ops import hist_wave as hw
    raw = kernel_raw(kernel, kw)
    unpacked = dict(kw, packed4=False)
    flat = hw.unpack4(args[0], kw["num_features"]).contiguous()
    got = outs_of(raw(*args))
    want = outs_of(kernel_raw(kernel, unpacked)(flat, *args[1:]))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b), f"{name}: packed launch != unpacked launch"


def time_histogram(kid, caps_key, caps, dev, label="") -> dict:
    """Times (kernel, plain version on the card, library call) and the
    bound of a captured K2 or K1 launch of any tier, at its shapes, and
    its pass split and plan: ``pass_report`` (under ``label``) for the
    f32 tier, ``int_pass_report`` and the host's microseconds a call for
    the int8 tier. The
    bytes: each row's bins (one byte per feature, half under packed4),
    g and h (4 bytes each, 1 in the int8 tier), its leaf id (K1: in and
    out, and the bag mask), the split table and the output; the
    operations: one add per (row, feature, channel) counted, and K1's
    partition of every row."""
    import torch
    from lightgbm_tpu_torch.ops import hist_wave as hw
    cap = caps[caps_key]
    a, kw = cap.args, cap.kw
    bins_t, g, B = a[0], a[1], a[-1]
    F = kw.get("num_features") or bins_t.shape[0]
    n = bins_t.shape[1]
    C = 2 if kw.get("count_proxy") else 3
    fn, plain = ((hw.wave_histogram, hw.wave_histogram_plain) if kid == "K2"
                 else (hw.fused_partition_histogram,
                       hw.fused_partition_histogram_plain))
    # rows the pass counts, from the count channel of the 3-channel sums
    full = plain(*a, **dict(plain_kw(kw), count_proxy=False))
    full = full if kid == "K2" else full[1]
    counted = int(full[:, 0, :, 2].sum())
    W = a[4].shape[0] if kid == "K2" else a[5].shape[1]
    bin_bytes = ((F + 1) // 2 if kw.get("packed4") else F) * n
    io_bytes = (2 * g.element_size() + (4 if kid == "K2" else 12)) * n
    nbytes = (bin_bytes + io_bytes + 4 * a[4 if kid == "K2" else 5].numel()
              + W * F * B * C * 4)
    ops = C * F * counted + (n if kid == "K1" else 0)
    raw = kernel_raw(fn, kw)
    if g.dtype == torch.float32:
        extra = pass_report(label, kid, raw, a, kw, counted)
    else:
        extra = int_pass_report(kid, raw, a, kw, counted)
        extra["host_us"] = host_us(lambda: raw(*a), 20)
    if kw.get("packed4"):
        flat = hw.unpack4(bins_t, F).contiguous()
        unpacked = kernel_raw(fn, dict(kw, packed4=False))
        extra["unpacked_ms"] = cuda_ms(lambda: unpacked(flat, *a[1:]), 5)
    return dict(
        extra, shape=f"F={F}, N={n}, W={W}, B={B}, C={C}"
        + (", packed" if kw.get("packed4") else ""),
        ms=cuda_ms(lambda: raw(*a), 5),
        plain_ms=cuda_ms(lambda: plain(*a, **plain_kw(kw)), 3),
        library_ms=lib_index_add(a, dev, kw) if kid == "K2" else None,
        **bound(nbytes, ops))


def int8_vs_before(key, ms: float, power_limit_w: float) -> str:
    """An int8 launch's time against its reading before the int8 pass's
    redesign (``INT8_MS_BEFORE``): not more than 10% above it on a 700 W
    card (raises), else only reported."""
    before = INT8_MS_BEFORE[key]
    gap = ms / before - 1.0
    if abs(power_limit_w - 700.0) < 1.0:
        assert gap <= 0.10, f"int8 {key}: {ms:.3f} ms vs {before} ms before"
        verdict = "not more than 10% above it"
    else:
        verdict = f"not held: the card's power limit is {power_limit_w} W"
    return (f"{100 * gap:+.1f}% of the {before} ms before the int8 pass's "
            f"redesign ({verdict})")


def quant_phases(dev, higgs: dict, power_limit_w: float) -> list:
    """Phases 10-14 of the module docstring: the int8 tiers and 4-bit
    packed bins. ``higgs`` holds phase 7's rows and exact-tier holdout
    AUC (``train_phases``), and takes phase 11's model text
    ("lrb_int8_text", for phase 21); ``power_limit_w`` the card's, for
    the check of the int8 times against ``INT8_MS_BEFORE``. Returns the
    kernels-line entries of every quantized and packed histogram
    variant."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import capi
    from lightgbm_tpu_torch.ops import hist_wave as hw
    X, y, Xt, yt = higgs["X"], higgs["y"], higgs["Xt"], higgs["yt"]
    runs = {}

    def train_higgs(label, params, variant):
        """train() on phase 7's rows, capturing the first root pass and
        the first and widest wave; checks the variant ran."""
        with capturing() as caps:
            reset_counts()
            t0 = time.perf_counter()
            ds = lgt.Dataset(X, label=y, params=params).construct()
            torch.cuda.synchronize()
            bin_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            bst = lgt.train(params, ds, num_boost_round=HIGGS_ITERS)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            counts = read_counts()
        for k in (f"K2/{variant}", f"K1/{variant}", "K3"):
            assert counts.get(k, 0) > 0, (label, counts)
        cfg = bst._gbdt._grower_cfg
        prob = bst.predict(Xt)
        assert prob.shape == (HOLDOUT_ROWS,) and np.isfinite(prob).all()
        auc = auc_np(yt, prob)
        wall, busy = device_busy(bst.update, 2)
        per_it = {k: v / HIGGS_ITERS for k, v in counts.items()}
        print(f"{label}: {HIGGS_TRAIN_ROWS} x 28, {HIGGS_ITERS} iterations,"
              f" W={cfg.wave_size}, B={cfg.num_bins}, precision "
              f"{cfg.precision}, count-proxy {cfg.count_proxy}, packed4 "
              f"{cfg.packed4}; binning {bin_s:.2f} s; "
              f"{1e3 * train_s / HIGGS_ITERS:.1f} ms/iteration; holdout auc "
              f"{auc:.5f}; launches per iteration {per_it}; profile of 2 "
              f"iterations: wall {wall:.1f} ms, device busy {busy:.2f} ms "
              f"({100 * busy / wall:.1f}%)")
        runs[label] = {"caps": caps, "counts": counts, "auc": auc,
                       "ms_per_iteration": 1e3 * train_s / HIGGS_ITERS,
                       "busy": busy / wall}
        return bst, cfg

    # 10. the headline tier: int8 count-proxy histograms at the HIGGS shape
    bst, cfg = train_higgs("higgs proxy", {**HIGGS_PARAMS,
                                           "tpu_quantized_hist": True},
                           "proxy")
    assert (cfg.precision, cfg.count_proxy, cfg.wave_size) == (
        "int8", True, 64), cfg
    gap = abs(runs["higgs proxy"]["auc"] - higgs["auc"])
    assert gap <= PROXY_AUC_TOL, f"proxy tier auc {gap} from the exact tier"
    print(f"  holdout auc: count-proxy {runs['higgs proxy']['auc']:.5f}, "
          f"exact {higgs['auc']:.5f} (|diff| {gap:.2g} <= {PROXY_AUC_TOL})")
    del bst

    # 11. the LRB window on the int8 tier with exact counts, C API
    Xl = make_lrb_rows(LRB_TRAIN_ROWS, seed=21)
    yl = lrb_labels(Xl, seed=22)
    Xn = make_lrb_rows(LRB_NEXT_ROWS, seed=23)
    yn = lrb_labels(Xn, seed=24)
    params = {**TRAIN_PARAMS, "tpu_quantized_hist": "true",
              "tpu_count_proxy": "0"}
    with capturing() as caps:
        reset_counts()
        ds = capi.LGBM_DatasetCreateFromMat(Xl, parameters=params)
        capi.LGBM_DatasetSetField(ds, "label", yl)
        bst = capi.LGBM_BoosterCreate(ds, params)
        iters = []
        for _ in range(int(params["num_iterations"])):
            t1 = time.perf_counter()
            finished = capi.LGBM_BoosterUpdateOneIter(bst)
            torch.cuda.synchronize()
            iters.append(time.perf_counter() - t1)
            if finished:
                break
        evals = dict(capi.LGBM_BoosterGetEval(bst, 0))
        text = capi.LGBM_BoosterSaveModelToString(bst)
        pred = np.asarray(capi.LGBM_BoosterPredictForMat(bst, Xn))
        counts = read_counts()
    cfg = bst.gbdt._grower_cfg
    assert pred.shape == (LRB_NEXT_ROWS,) and np.isfinite(pred).all()
    host = host_raw(lgt.Booster(model_str=text, device="cpu")._gbdt,
                    Xn[:SUBSET])[0]
    err_host = float(np.abs(pred[:SUBSET] - 1 / (1 + np.exp(-host))).max())
    assert err_host <= 1e-5, f"lrb int8 model text: {err_host} from host walk"
    assert (cfg.precision, cfg.count_proxy, cfg.wave_size) == (
        "int8", False, 30), cfg
    for k in ("K2/int8", "K1/int8", "K3"):
        assert counts.get(k, 0) > 0, counts
    assert bool((caps["K1w"].args[3] == 0).any()), "no out-of-bag rows"
    assert evals["auc"] > 0.6 and text.startswith("tree"), evals
    wall, busy = device_busy(lambda: capi.LGBM_BoosterUpdateOneIter(bst), 3)
    top = host_ops(lambda: capi.LGBM_BoosterUpdateOneIter(bst), 3)
    n_it = len(iters)
    print(f"lrb int8: {LRB_TRAIN_ROWS} x {LRB_FEATURES}, {n_it} iterations, "
          f"W={cfg.wave_size}, B={cfg.num_bins}; median "
          f"{1e3 * float(np.median(iters)):.1f} ms/iteration; train auc "
          f"{evals['auc']:.5f}; next window auc {auc_np(yn, pred):.5f}, "
          f"model text scores within {err_host:.2g} of the host walk; "
          f"launches per iteration "
          f"{ {k: v / n_it for k, v in counts.items()} }; profile of 3 "
          f"iterations: wall {wall:.1f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%); host time per iteration by "
          f"operator: {top}")
    runs["lrb int8"] = {"caps": caps, "counts": counts, "iters": n_it}
    higgs["lrb_int8_text"] = text
    capi.LGBM_BoosterFree(bst)
    del Xl, Xn, ds, bst

    # 12. 4-bit packed bins at full width: the exact tier, then count-proxy
    for label, extra, variant in (
            ("higgs packed exact", {}, "f32_packed4"),
            ("higgs packed proxy", {"tpu_quantized_hist": True},
             "proxy_packed4")):
        bst, cfg = train_higgs(label, {**HIGGS_PARAMS, **extra,
                                       "max_bin": PACKED_MAX_BIN}, variant)
        assert cfg.packed4 and cfg.num_bins == 16, cfg
        assert bst._gbdt.train_data.packed4
        del bst

    # 13. the kernels on those captures
    t0 = time.perf_counter()
    out = {}
    for label, variant in (("higgs proxy", "proxy"), ("lrb int8", "int8"),
                           ("higgs packed exact", "f32_packed4"),
                           ("higgs packed proxy", "proxy_packed4")):
        caps = runs[label]["caps"]
        for kid, key, fn, plain, outs_of in (
                ("K2", "K2", hw.wave_histogram, hw.wave_histogram_plain,
                 lambda o: (o,)),
                ("K1", "K1", hw.fused_partition_histogram,
                 hw.fused_partition_histogram_plain, lambda o: tuple(o)),
                ("K1", "K1w", hw.fused_partition_histogram,
                 hw.fused_partition_histogram_plain, lambda o: tuple(o))):
            cap = caps[key]
            if variant != "f32_packed4":
                check_int_histogram(f"{label} {key}", fn, plain, cap.args,
                                    cap.kw, outs_of)
            if variant.endswith("packed4"):
                check_packed(f"{label} {key}", fn, cap.args, cap.kw, outs_of)
        for kid, key in (("K2", "K2"), ("K1", "K1w")):
            t = time_histogram(kid, key, caps, dev, label)
            t["launches"] = runs[label]["counts"][f"{kid}/{variant}"]
            t["launches_per_iteration"] = t["launches"] / runs[label].get(
                "iters", HIGGS_ITERS)
            out[(kid, variant)] = t
            lib = t["library_ms"]
            print(f"{label} {kid} [{t['shape']}]: {t['ms']:.3f} ms, plain "
                  f"{t['plain_ms']:.3f} ms, library "
                  f"{'none' if lib is None else f'{lib:.3f} ms'}, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}); "
                  f"{t['launches_per_iteration']:.2f} launches/iteration"
                  + (f"; the unpacked launch {t['unpacked_ms']:.3f} ms"
                     if "unpacked_ms" in t else ""))
            if "pass_line" in t:
                print(f"  {label} {kid} int8 pass: {t['pass_line']}; host "
                      f"{t['host_us']:.1f} us a call; "
                      + int8_vs_before((kid, variant), t["ms"],
                                       power_limit_w))
        if variant == "proxy":
            cap = caps["K2"]
            root = kernel_raw(hw.wave_histogram, cap.kw)(*cap.args)
            print(f"  {label} root pass: largest |g| cell "
                  f"{int(root[..., 0].abs().max())}, largest h cell "
                  f"{int(root[..., 1].max())} quantized units (exact in "
                  f"int32; f32 adds are exact below 2^24 = 16777216)")
        what = ("packed == unpacked launch" if variant == "f32_packed4" else
                "bit-equal to the plain version on the card, two launches "
                "bit-identical" + (", packed == unpacked launch"
                                   if variant.endswith("packed4") else ""))
        print(f"  {label} K2 (root), K1 (first and widest wave): {what}")
    print(f"quantized kernel checks: {time.perf_counter() - t0:.1f} s")

    # 14. card vs CPU on the quantized tier: the LRB parameters at 100,000
    # rows, 20 iterations
    Xc = make_lrb_rows(CPU_ROWS, seed=31)
    yc = lrb_labels(Xc, seed=32)
    params = {**TRAIN_PARAMS, "tpu_quantized_hist": "true",
              "num_iterations": str(CPU_Q_ITERS)}
    cmp_runs = card_and_cpu(params, Xc, yc, CPU_Q_ITERS)
    _, where = judge_trees(cmp_runs, quantized=True)
    print(f"quantized card vs CPU, {CPU_ROWS} LRB rows x {CPU_Q_ITERS} "
          f"iterations (count-proxy): {where}; train auc "
          f"{cmp_runs['cuda'][1]['auc']:.6f} vs "
          f"{cmp_runs['cpu'][1]['auc']:.6f} (within {AUC_TOL}); "
          f"{cmp_runs['cuda'][2]:.1f} s on the card, "
          f"{cmp_runs['cpu'][2]:.1f} s on the CPU")

    entries = []
    src = "lightgbm_tpu_torch/csrc/hist_wave.cu"
    for (kid, variant), t in sorted(out.items()):
        name = ("wave_histogram" if kid == "K2"
                else "fused_partition_histogram") + "_" + variant
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": ("lightgbm_tpu/ops/hist_wave.py:482" if kid == "K2"
                         else "lightgbm_tpu/ops/hist_wave.py:984"),
            "launches": t["launches"], "max_abs_err": 0.0,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_note": ("index_add_ of the channels on a flat index "
                             "built beforehand" if kid == "K2" else
                             "no single PyTorch call partitions rows and "
                             "builds their histograms"),
            "shape": t["shape"],
            "launches_per_iteration": t["launches_per_iteration"],
            **({"unpacked_ms": t["unpacked_ms"]} if "unpacked_ms" in t
               else {}),
            **{k: t[k] for k in ("counted_share", "split_ms", "plan",
                                 "host_us") if k in t},
            "vs_plain": ("bitwise against the unpacked launch"
                         if variant == "f32_packed4" else
                         "bitwise against the plain version on the card")})
    return entries


def cat_phases(dev, k1_ms_phase7: float, power_limit_w: float) -> tuple:
    """Phases 15-18 of the module docstring: categorical features.
    ``k1_ms_phase7`` is phase 8's K1 time on phase 7's inputs (no
    categorical rows). Returns the kernels-line entries of K1 with
    categorical rows, f32 and int8, and the forest kernel's reading on
    the categorical model's holdout (``check_forest``)."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import forest as forest_ops
    from lightgbm_tpu_torch.ops import hist_wave as hw
    from lightgbm_tpu_torch.ops import stacked_predict as sp
    from lightgbm_tpu_torch.utils import log as tlog
    X = make_airline_like(AIRLINE_ROWS, seed=41)
    y = airline_labels(X, seed=42)
    Xt = make_airline_like(HOLDOUT_ROWS, seed=43)
    yt = airline_labels(Xt, seed=44)
    runs = {}

    def train_airline(label, params, cats):
        """train() on the airline rows with ``cats`` categorical,
        capturing the root pass and the widest categorical wave; the
        holdout scored through Booster.predict."""
        lines = []
        tlog.set_callback(lines.append)
        try:
            with capturing() as caps:
                reset_counts()
                t0 = time.perf_counter()
                ds = lgt.Dataset(X, label=y, categorical_feature=cats,
                                 params=params).construct()
                torch.cuda.synchronize()
                bin_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                bst = lgt.train(params, ds, num_boost_round=AIRLINE_ITERS)
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
                counts = read_counts()
        finally:
            tlog.set_callback(None)
        torch.cuda.synchronize()
        forest_ops.launches.reset()
        sp.fallbacks.reset()
        prob = bst.predict(Xt)
        torch.cuda.synchronize()
        k4, fallbacks = forest_ops.launches.value, sp.fallbacks.value
        assert k4 > 0 and fallbacks == 0, (label, k4, fallbacks)
        assert prob.shape == (HOLDOUT_ROWS,) and np.isfinite(prob).all()
        if label == "airline categorical":
            runs["k4"] = check_forest("airline categorical", bst, Xt, prob,
                                      dev)
        auc = auc_np(yt, prob)
        cfg = bst._gbdt._grower_cfg
        iters = bst.current_iteration()
        leaves = [t.num_leaves for t in bst._gbdt.models]
        n_cat = sum(t.num_cat for t in bst._gbdt.models)
        wall, busy = device_busy(bst.update, 2)
        top = host_ops(bst.update, 2)
        cat_waves = caps["K1c"].hits
        print(f"{label}: {AIRLINE_ROWS} x 8 ({len(cats)} categorical), "
              f"{iters} iterations of {leaves} leaves ({n_cat} categorical "
              f"splits), W={cfg.wave_size}, B={cfg.num_bins}, precision "
              f"{cfg.precision}, count-proxy {cfg.count_proxy}; binning "
              f"{bin_s:.2f} s; {1e3 * train_s / iters:.1f} ms/iteration; "
              f"K1 {counts['K1'] / iters:.1f} launches/iteration, "
              f"{cat_waves / iters:.1f} of them with categorical slots; "
              f"holdout auc {auc:.5f} (predict: {k4} forest launches, "
              f"{fallbacks} fallbacks); profile of 2 iterations: wall "
              f"{wall:.1f} ms, device busy {busy:.2f} ms "
              f"({100 * busy / wall:.1f}%); host time per iteration by "
              f"operator: {top}; launches {counts}")
        runs[label] = {"caps": caps, "counts": counts, "iters": iters,
                       "cat_waves": cat_waves, "auc": auc, "cfg": cfg,
                       "lines": lines, "n_cat": n_cat,
                       "mappers": bst._gbdt.train_data.mappers}

    # 15. categorical training at full width, and the same rows numerical
    train_airline("airline categorical", AIRLINE_PARAMS, AIRLINE_CAT_COLUMNS)
    cat = runs["airline categorical"]
    airline_k4 = runs.pop("k4")
    assert cat["cfg"].hp.has_cat and cat["cfg"].precision == "f32"
    assert cat["counts"].get("K1/cat", 0) > 0 and cat["cat_waves"] > 0
    assert cat["n_cat"] > 0
    origin = cat["mappers"][5]          # no column is trivial here
    assert origin.bin_type == 1 and origin.num_bin < AIRLINE_CATEGORIES[5]
    train_airline("airline numerical", AIRLINE_PARAMS, [])
    num = runs.pop("airline numerical")
    assert not num["cfg"].hp.has_cat and "K1/cat" not in num["counts"]
    print(f"  holdout auc: categorical {cat['auc']:.5f}, every column "
          f"numerical {num['auc']:.5f}; Origin: {origin.num_bin} bins for "
          f"{AIRLINE_CATEGORIES[5]} codes (the rest share the last bin)")
    del num

    # 16. the int8 tier: count-proxy asked for, exact counts resolved
    train_airline("airline int8", {**AIRLINE_PARAMS,
                                   "tpu_quantized_hist": True,
                                   "tpu_count_proxy": 1},
                  AIRLINE_CAT_COLUMNS)
    q = runs["airline int8"]
    assert (q["cfg"].precision, q["cfg"].count_proxy) == ("int8", False)
    assert q["cfg"].wave_size <= 40, q["cfg"]
    assert any("tpu_count_proxy needs" in ln and "no categorical features"
               in ln for ln in q["lines"]), q["lines"]
    assert q["counts"].get("K1/int8", 0) > 0 and q["cat_waves"] > 0
    print(f"  int8 tier: W={q['cfg'].wave_size}, the count-proxy warning "
          f"logged; holdout auc {q['auc']:.5f} (exact tier "
          f"{cat['auc']:.5f})")

    # 17. the kernels on those captures
    t0 = time.perf_counter()
    out = []
    for label, variant in (("airline categorical", "f32"),
                           ("airline int8", "int8")):
        caps = runs[label]["caps"]
        assert caps["K1c"].best > 0, f"{label}: no categorical wave"
        k1c = caps["K1c"]
        assert k1c.kw.get("any_cat"), k1c.kw
        if variant == "f32":
            a2, kw2, kw1 = caps["K2"].args, caps["K2"].kw, k1c.kw
            check_histogram(
                f"{label} K2", lambda *a: hw.wave_histogram(*a, **kw2),
                lambda *a, **k: hw.wave_histogram_plain(
                    *a, **plain_kw(kw2), **k),
                a2, lambda o: o, None)
            st = check_histogram(
                f"{label} K1",
                lambda *a: hw.fused_partition_histogram(*a, **kw1),
                lambda *a, **k: hw.fused_partition_histogram_plain(
                    *a, **plain_kw(kw1), **k),
                k1c.args, lambda o: o[1], lambda o: o[0])
        else:
            for key, fn, plain, outs_of in (
                    ("K2", hw.wave_histogram, hw.wave_histogram_plain,
                     lambda o: (o,)),
                    ("K1c", hw.fused_partition_histogram,
                     hw.fused_partition_histogram_plain, tuple)):
                check_int_histogram(f"{label} {key}", fn, plain,
                                    caps[key].args, caps[key].kw, outs_of)
        t = time_histogram("K1", "K1c", caps, dev, label)
        if variant == "f32":
            # the root pass (K2) of the same rows, the pass's other shape
            t["k2_root"] = time_histogram("K2", "K2", caps, dev, label)
            k2r = t["k2_root"]
            print(f"{label} K2 (root) [{k2r['shape']}]: {k2r['ms']:.3f} ms,"
                  f" plain {k2r['plain_ms']:.3f} ms, library "
                  f"{k2r['library_ms']:.3f} ms, bound {k2r['bound_ms']:.4f}"
                  f" ms ({k2r['bound_by']})")
        lib = lib_index_add(caps["K2"].args, dev, caps["K2"].kw)
        # the same launch without its categorical rows (CAT=false, the
        # categorical slots taken as numerical ones)
        a = list(k1c.args)
        a[5] = a[5][:hw.TBL_ROWS_NUM].contiguous()
        no_cat = kernel_raw(hw.fused_partition_histogram,
                            dict(k1c.kw, any_cat=False))
        t["no_cat_ms"] = cuda_ms(lambda: no_cat(*a), 5)
        n_cat = int((k1c.args[5][hw.TBL_ISCAT] != 0).sum())
        it = runs[label]["iters"]
        launches = runs[label]["counts"]["K1/cat"]
        print(f"{label} K1 with categorical rows [{t['shape']}, {n_cat} "
              f"categorical slots]: {t['ms']:.3f} ms, plain "
              f"{t['plain_ms']:.3f} ms, library none ({lib:.3f} ms: "
              f"index_add_ of one pass), bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}); the same launch without its "
              f"categorical rows {t['no_cat_ms']:.3f} ms; "
              f"{launches / it:.2f} launches/iteration;"
              + (f" bit-equal to the plain version in the kernels' order "
                 f"(sums, counts, leaf ids), g/h within "
                 f"{st['max_abs_err_f64']:.3g} of float64"
                 if variant == "f32" else
                 " bit-equal to the plain version on the card")
              + "; two launches bit-identical")
        if "pass_line" in t:
            print(f"  {label} K1 int8 pass: {t['pass_line']}; host "
                  f"{t['host_us']:.1f} us a call; "
                  + int8_vs_before(("K1", "int8_cat"), t["ms"],
                                   power_limit_w))
        out.append({
            "name": f"fused_partition_histogram_{variant}_cat",
            "route": "cuda", "source": "lightgbm_tpu_torch/csrc/hist_wave.cu",
            "replaces": "lightgbm_tpu/ops/hist_wave.py:984",
            "launches": launches, "max_abs_err": 0.0,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "index_add_ms": lib,
            "no_cat_ms": t["no_cat_ms"],
            "library_note": ("no single PyTorch call partitions rows and "
                             "builds their histograms; index_add_ms is one "
                             "pass's index_add_ at the root's shape"),
            "shape": t["shape"], "categorical_slots": n_cat,
            **{k: t[k] for k in ("counted_share", "split_ms", "plan",
                                 "host_us", "k2_root") if k in t},
            "launches_per_iteration": launches / it,
            "categorical_waves_per_iteration": runs[label]["cat_waves"] / it,
            "vs_plain": ("bitwise against the plain version run in the "
                         "kernels' order of addition" if variant == "f32"
                         else "bitwise against the plain version on the "
                         "card")})
    del runs
    gap = k1_ms_phase7 / K1_MS_BEFORE_CAT - 1.0
    if abs(power_limit_w - 700.0) < 1.0:
        assert gap <= 0.10, \
            f"K1 without categorical rows {k1_ms_phase7:.3f} ms vs " \
            f"{K1_MS_BEFORE_CAT} ms"
        verdict = "not more than 10% above it"
    else:
        verdict = f"not held: the card's power limit is {power_limit_w} W"
    print(f"  K1 without categorical rows on phase 7's inputs (phase 8): "
          f"{k1_ms_phase7:.3f} ms, {100 * gap:+.1f}% of the earlier "
          f"{K1_MS_BEFORE_CAT} ms ({verdict})")
    print(f"categorical kernel checks: {time.perf_counter() - t0:.1f} s")
    del X, y, Xt, yt

    # 18. card vs CPU at 100,000 rows of the airline generator
    Xc = make_airline_like(CPU_ROWS, seed=51)
    yc = airline_labels(Xc, seed=52)
    for tier, extra in (("exact", {}),
                        ("int8", {"tpu_quantized_hist": True})):
        cmp_runs = card_and_cpu({**AIRLINE_PARAMS, **extra,
                                 "num_leaves": CAT_CPU_LEAVES}, Xc, yc,
                                CAT_CPU_ITERS,
                                categorical_feature=AIRLINE_CAT_COLUMNS)
        _, where = judge_trees(cmp_runs, quantized=bool(extra))
        n_cat = sum(t.num_cat for t in cmp_runs["cuda"][0]._gbdt.models)
        assert n_cat > 0
        print(f"categorical card vs CPU ({tier} tier), {CPU_ROWS} airline "
              f"rows x {CAT_CPU_ITERS} iterations of {CAT_CPU_LEAVES} "
              f"leaves, {n_cat} categorical "
              f"splits: {where}; train auc "
              f"{cmp_runs['cuda'][1]['auc']:.6f} vs "
              f"{cmp_runs['cpu'][1]['auc']:.6f} (within {AUC_TOL}); "
              f"{cmp_runs['cuda'][2]:.1f} s on the card, "
              f"{cmp_runs['cpu'][2]:.1f} s on the CPU")
    return out, airline_k4

def write_trace(path: str, n_requests: int) -> None:
    """``lrb.synthetic_trace(n_requests, LOOP_OBJECTS, seed=7)`` as a
    trace file, ``seq id size cost`` a line (test.cpp:376)."""
    from lightgbm_tpu_torch import lrb
    with open(path, "w") as fh:
        fh.writelines(f"{q} {o} {z} {c}\n" for q, o, z, c in
                      lrb.synthetic_trace(n_requests, LOOP_OBJECTS, seed=7))


@contextlib.contextmanager
def loop_probes():
    """While active, the LRB loop is watched at four seams: each window's
    training (``LrbDriver._train_model``: its K1, K2 and K3 launches and
    iterations), each window's evaluation (``_score_window``: the forest
    kernel's launches on the calling thread), the serving call the loop
    makes (``lrb.capi.LGBM_BoosterPredictForMat``: rows and host-clock
    ms of each call, and window 3's batches and scores with the handle
    that scored them) and ``forest.forest_predict`` (one launch a call
    for CUDA tensors, counted per thread). Yields the records."""
    import threading
    from lightgbm_tpu_torch import lrb
    from lightgbm_tpu_torch.obs import reqlog
    from lightgbm_tpu_torch.ops import forest as forest_ops
    from lightgbm_tpu_torch.ops import hist_wave as hw
    from lightgbm_tpu_torch.ops import predict as pr
    rec = {"train": {}, "eval": {}, "calls": {}, "window3": [],
           "handle3": None}
    tls = threading.local()
    orig = (lrb.LrbDriver._train_model, lrb.LrbDriver._score_window,
            lrb.capi.LGBM_BoosterPredictForMat, forest_ops.forest_predict)

    def k123():
        return (hw.k1_launches.value, hw.k2_launches.value,
                pr.launches.value)

    def train_model(self, labels, X, widx, deadline=None):
        before = k123()
        out = orig[0](self, labels, X, widx, deadline)
        after = k123()
        rec["train"][widx] = {
            "K1": after[0] - before[0], "K2": after[1] - before[1],
            "K3": after[2] - before[2],
            "iterations": len(out[1].gbdt.models) if out else 0}
        return out

    def score_window(self, *a, **kw):
        n0 = getattr(tls, "k4", 0)
        out = orig[1](self, *a, **kw)
        rec["eval"][kw.get("window")] = getattr(tls, "k4", 0) - n0
        return out

    def predict_for_mat(handle, data, *a, **kw):
        t0 = time.perf_counter()
        out = orig[2](handle, data, *a, **kw)
        ms = (time.perf_counter() - t0) * 1e3
        ctx = reqlog.current()
        w = ctx.window if ctx is not None else None
        rec["calls"].setdefault(w, []).append((len(data), ms))
        if w == 3:
            rec["window3"].append((data, out))
            rec["handle3"] = handle
        return out

    def forest_predict(*a, **kw):
        tls.k4 = getattr(tls, "k4", 0) + 1
        return orig[3](*a, **kw)

    lrb.LrbDriver._train_model = train_model
    lrb.LrbDriver._score_window = score_window
    lrb.capi.LGBM_BoosterPredictForMat = predict_for_mat
    forest_ops.forest_predict = forest_predict
    try:
        yield rec
    finally:
        (lrb.LrbDriver._train_model, lrb.LrbDriver._score_window,
         lrb.capi.LGBM_BoosterPredictForMat,
         forest_ops.forest_predict) = orig


def request_quantiles(calls) -> dict:
    """p50 and p99 of the per-call ms of ``calls`` [(rows, ms)], per
    batch and per request (a call's ms once for each of its rows)."""
    rows = np.array([r for r, _ in calls])
    ms = np.array([m for _, m in calls])
    per_req = np.repeat(ms, rows)
    return {"batch_p50": float(np.percentile(ms, 50)),
            "batch_p99": float(np.percentile(ms, 99)),
            "request_p50": float(np.percentile(per_req, 50)),
            "request_p99": float(np.percentile(per_req, 99))}


def lrb_loop_phase(dev, smi: str, tmp: str) -> dict:
    """Phase 19 of the module docstring, its trace written under ``tmp``.
    Returns, for the kernels line, each kernel's launches in the loop's
    run and per window, and K4's reading on window 3's rows; for phase
    20 the trace's path and the last two published models' text."""
    import itertools
    import types
    from lightgbm_tpu_torch import capi, lrb
    t_phase = time.perf_counter()
    path = os.path.join(tmp, "trace.txt")
    t0 = time.perf_counter()
    write_trace(path, LOOP_REQUESTS)
    print(f"lrb loop: trace of {LOOP_REQUESTS} requests over "
          f"{LOOP_OBJECTS} objects written in "
          f"{time.perf_counter() - t0:.1f} s")
    # the main path: the default pipelined loop on cuda:0
    with loop_probes() as probes:
        reset_counts()
        t0 = time.perf_counter()
        out = _Lines()
        drv = lrb.run_trace_file(path, LOOP_CACHE, LOOP_WINDOW,
                                 LOOP_SAMPLE, LOOP_CUTOFF,
                                 LOOP_SAMPLING, result_file=out)
        drv.close()
        loop_s = time.perf_counter() - t0
        counts = read_counts()
    res = drv.results
    for k in ("K1/f32", "K2/f32", "K3", "K4"):
        assert counts.get(k, 0) > 0, f"lrb loop: {k} never launched"
    n_win = LOOP_REQUESTS // LOOP_WINDOW
    assert len(res) == n_win and drv.degraded_windows() == 0, res
    for r in res:
        share = r["opt_obj_hit_ratio"]
        assert 0.05 < share < 0.95, f"OPT's positive share {share}"
        if r["window"] > 1:
            # the learned policy beats chance, as
            # tests/test_capi_lrb.py asks of the JAX loop
            assert r["eval_rows"] == LOOP_WINDOW, r
            assert r["fp_rate"] + r["fn_rate"] < 0.9, r
    swaps = sum(1 for r in res if not r.get("degraded"))
    k4_eval = [probes["eval"].get(w, 0) for w in range(1, n_win + 1)]
    # every K4 launch of the loop is a serving call's or the warm-up
    # predict of a published model's
    assert counts["K4"] == sum(k4_eval) + swaps, (counts, k4_eval)
    print(f"lrb loop, pipelined on {drv._device} ({smi}): {n_win} windows "
          f"of {LOOP_WINDOW} requests in {loop_s:.1f} s (cache "
          f"{LOOP_CACHE}, sample {LOOP_SAMPLE}, sampling "
          f"{LOOP_SAMPLING}); launches {counts}")
    for r in res:
        w = r["window"]
        tr = probes["train"][w]
        calls = probes["calls"].get(w, [])
        q = request_quantiles(calls) if calls else {}
        print(f"  window {w} ({smi}): wall {r['window_wall_s']} s, "
              f"derive {r['derive_s']} s, train {r['train_s']} s "
              f"({1e3 * r['train_s'] / tr['iterations']:.1f} ms an "
              f"iteration of {tr['iterations']}, {r['train_rows']} "
              f"rows; compile {r['compile_s']} s), evaluate "
              f"{r.get('evaluate_s', 0)} s, overlap {r['overlap_s']} "
              f"s; {len(calls)} predict calls"
              + (f" (p50/p99 ms a batch {q['batch_p50']:.3f}/"
                 f"{q['batch_p99']:.3f}, a request "
                 f"{q['request_p50']:.3f}/{q['request_p99']:.3f})"
                 if calls else "")
              + f"; launches K1 {tr['K1']}, K2 {tr['K2']}, K3 "
              f"{tr['K3']}, K4 {probes['eval'].get(w, 0)}; OPT "
              f"share {r['opt_obj_hit_ratio']}, fp {r.get('fp_rate')}"
              f", fn {r.get('fn_rate')}")
    print(f"  driver's quantiles ({smi}): window wall "
          f"{drv.window_wall_quantiles()}, serving latency per "
          f"request (s) {drv.serve_latency_quantiles()}")
    print("  result lines: " + " | ".join(out.lines[:n_win]))

    # the same trace, sequential: the records equal on PARITY_KEYS
    seq_path = path
    if LOOP_SEQ_WINDOWS < n_win:
        seq_path = os.path.join(tmp, "prefix.txt")
        write_trace(seq_path, LOOP_SEQ_WINDOWS * LOOP_WINDOW)
    t0 = time.perf_counter()
    seq = lrb.run_trace_file(seq_path, LOOP_CACHE, LOOP_WINDOW,
                             LOOP_SAMPLE, LOOP_CUTOFF,
                             LOOP_SAMPLING, result_file=_Lines(),
                             extra_params={"tpu_lrb_pipeline": 0})
    seq.close()
    seq_s = time.perf_counter() - t0
    assert len(seq.results) == LOOP_SEQ_WINDOWS
    for a, b in zip(seq.results, res):
        for k in PARITY_KEYS:
            assert a.get(k) == b.get(k), (a["window"], k, a.get(k),
                                          b.get(k))
    print(f"lrb loop, sequential ({smi}): {LOOP_SEQ_WINDOWS} windows "
          f"in {seq_s:.1f} s, records equal to the pipelined run's "
          f"on {len(PARITY_KEYS)} keys; per window (s) "
          + ", ".join(f"{r['window']}: wall {r['window_wall_s']} "
                      f"derive {r['derive_s']} train {r['train_s']} "
                      f"evaluate {r.get('evaluate_s', 0)}"
                      for r in seq.results)
          + f"; serving latency per request (s) "
          f"{seq.serve_latency_quantiles()}")

    # window 3's serving, bit for bit: its 64-row calls against one call
    # with the same handle, and against the plain K4 version
    h = probes["handle3"]
    X3 = np.concatenate([x for x, _ in probes["window3"]])
    p3 = np.concatenate([p for _, p in probes["window3"]])
    assert p3.shape == (LOOP_WINDOW,) and np.isfinite(p3).all()
    assert ((p3 >= 0) & (p3 <= 1)).all()
    one = np.asarray(capi.LGBM_BoosterPredictForMat(h, X3))
    assert np.array_equal(one, p3), "64-row calls != one call"
    print(f"lrb loop window 3: {len(probes['window3'])} serving calls "
          f"bit-equal to one call on its {X3.shape[0]} rows")
    kern = check_forest("lrb loop window 3",
                        types.SimpleNamespace(_gbdt=h.gbdt), X3, p3, dev)
    # the serving call's host path, over 200 of window 3's calls
    batches = itertools.cycle([x for x, _ in
                               probes["window3"][:SERVE_PROBE_CALLS]])

    def serve():
        capi.LGBM_BoosterPredictForMat(h, next(batches))
    wall, busy = device_busy(serve, SERVE_PROBE_CALLS)
    per_call = wall / SERVE_PROBE_CALLS
    print(f"lrb serving calls ({smi}): {SERVE_PROBE_CALLS} calls of "
          f"{drv.serve_batch} rows in {wall:.1f} ms ({per_call:.3f} ms a "
          f"call), device busy {busy:.2f} ms "
          f"({100 * busy / wall:.2f}%); host time a call by operator: "
          f"{host_ops(serve, SERVE_PROBE_CALLS, k=10)}")
    print(f"lrb loop phase: {time.perf_counter() - t_phase:.1f} s")
    per_window = {"K1": [], "K2": [], "K3": []}
    for w in range(1, n_win + 1):
        for k in per_window:
            per_window[k].append(probes["train"][w][k])
    return {"counts": counts, "per_window": per_window,
            "k4_per_window": k4_eval, "publish_warmups": swaps,
            "k4": kern, "trace": path,
            "model_texts": [capi.LGBM_BoosterSaveModelToString(b)
                            for b in (drv.booster, h)]}


def fleet_jobs(n: int, pools: dict, seed: int) -> list:
    """``n`` requests of ``FLEET_ROWS`` rows in the ratio ``FLEET_MIX``,
    in a seeded order: [(tenant, rows)], each tenant's requests taking
    consecutive row blocks of its pool."""
    r = np.random.default_rng(seed)
    pattern = [t for t, k in FLEET_MIX for _ in range(k)]
    used = {t: 0 for t, _ in FLEET_MIX}
    jobs = []
    for t in r.permutation(np.resize(pattern, n)):
        t = str(t)
        i = used[t]
        used[t] += 1
        jobs.append((t, pools[t][i * FLEET_ROWS:(i + 1) * FLEET_ROWS]))
    return jobs


def fleet_traffic(url: str, jobs: list, clients: int = FLEET_CLIENTS):
    """Sends ``jobs`` from ``clients`` threads, each with its own
    ``FleetClient`` (one HTTP call a request), thread c sending jobs c,
    c + clients, ... Returns the wall seconds, each request's host-clock
    ms at its client and each answer (predictions, version). Any failed
    request fails the phase."""
    import threading
    from lightgbm_tpu_torch.serve import FleetClient
    ms = [0.0] * len(jobs)
    out = [None] * len(jobs)
    errs = []

    def client(c):
        fc = FleetClient(url)
        try:
            for j in range(c, len(jobs), clients):
                t0 = time.perf_counter()
                out[j] = fc.predict_versioned(*jobs[j])
                ms[j] = (time.perf_counter() - t0) * 1e3
        except Exception as e:          # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    assert not errs, f"{len(errs)} requests failed: {errs[:3]}"
    return wall, np.array(ms), out


class BatchRecorder:
    """The coalescer's ``predict_fn`` seam, recording every batch its
    dispatcher sends: rows and host-clock ms of each predict call, the
    first ``keep`` batches (handle, rows) and the largest batch's rows,
    answer and handle."""

    def __init__(self, fn, keep: int = 64):
        self.fn = fn
        self.keep = keep
        self.rows, self.ms, self.sample, self.largest = [], [], [], None

    def __call__(self, handle, X):
        t0 = time.perf_counter()
        out = self.fn(handle, X)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.rows.append(X.shape[0])
        if len(self.sample) < self.keep:
            self.sample.append((handle, X))
        if self.largest is None or X.shape[0] > self.largest[0].shape[0]:
            self.largest = (X, np.asarray(out), handle)
        return out


def fleet_phase(dev, smi: str, loop: dict, higgs_text: str,
                higgs_X: np.ndarray, tmp: str) -> dict:
    """Phase 20 of the module docstring: the shed drill, the traffic (a
    coalesced run and its repeat with coalesce_us 0), the swap under
    load, and phase 19's trace through the daemon. Returns K4's fleet
    readings for the kernels line."""
    import itertools
    import threading
    import types
    from lightgbm_tpu_torch import capi, lrb
    from lightgbm_tpu_torch.obs import registry as obs
    from lightgbm_tpu_torch.serve import FleetClient, ScoringDaemon, ShedError
    from lightgbm_tpu_torch.utils import faults
    t_phase = time.perf_counter()
    text_new, text_old = loop["model_texts"]   # windows 3 and 2
    texts = {"lrb_a": text_new, "lrb_b": text_new, "higgs": higgs_text}
    share = {t: k for t, k in FLEET_MIX}
    total = sum(share.values())
    need = {t: -(-FLEET_REQUESTS * k // total) * FLEET_ROWS
            for t, k in FLEET_MIX}
    pools = {"lrb_a": make_lrb_rows(need["lrb_a"], seed=20),
             "lrb_b": make_lrb_rows(need["lrb_b"], seed=21),
             "higgs": higgs_X[:need["higgs"]].astype(np.float64)}
    handles = {}

    def direct(text, X):
        """The answer of a freshly loaded handle on the card."""
        h = handles.get(text)
        if h is None:
            h = handles[text] = capi.LGBM_BoosterLoadModelFromString(text)
        return np.asarray(capi.LGBM_BoosterPredictForMat(h, X))

    # -- the shed drill (first: the admission engine reads the process's
    # per-tenant latency histograms, which the traffic would fill)
    d = ScoringDaemon(coalesce_us=0, slo_p99_ms=50.0, shed_budget=0.5,
                      slo_eval_gap_s=0.0, slo_min_events=100,
                      shed_probe_every=16, device=dev).start()
    try:
        c = FleetClient(d.url)
        for t in ("lrb_a", "lrb_b"):
            assert c.register(t, text_new) == 1
        x_a, x_b = pools["lrb_a"][:FLEET_ROWS], pools["lrb_b"][:FLEET_ROWS]
        for _ in range(DRILL_PREFILL):
            c.predict("lrb_a", x_a)
            c.predict("lrb_b", x_b)
        assert d.shed_check("lrb_a") is None, "healthy tenant shed"
        faults.configure("fleet.predict.lrb_a@1+:sleep80")
        shed_at = None
        for i in range(12):
            try:
                c.predict("lrb_a", x_a)
            except ShedError as e:
                assert e.retry_after_s > 0
                shed_at = i
                break
        assert shed_at is not None, "admission never shed lrb_a"
        state = d.slo_report()["shedding"]["lrb_a"]
        assert state["budget_remaining_at_shed"] > 0, state
        assert state["exhausted_at_shed"] is False, state
        sheds = 0
        for _ in range(20):
            try:
                c.predict("lrb_a", x_a)
            except ShedError:
                sheds += 1
        assert sheds >= 15, sheds
        got_b = c.predict("lrb_b", x_b)
        assert np.array_equal(got_b, direct(text_new, x_b)), "lrb_b"
        rep = d.slo_report()
        assert "lrb_b" not in rep["shedding"]
    finally:
        faults.clear()
        d.stop()
    print(f"fleet shed drill ({smi}): slo_p99_ms 50, shed_budget 0.5, "
          f"{DRILL_PREFILL} healthy requests of {FLEET_ROWS} rows a tenant "
          f"over HTTP, then fleet.predict.lrb_a@1+:sleep80: lrb_a shed "
          f"(HTTP 429) at its request {shed_at + 1} with budget "
          f"{state['budget_remaining_at_shed']} left (exhausted "
          f"{state['exhausted_at_shed']}), {sheds} of the next 20 shed; "
          f"lrb_b served bit-equal, budget "
          + str(next(r["budget_remaining"] for r in rep["specs"]
                     if r["name"].endswith("lrb_b_p99")))
          + "; faults cleared")

    # -- the traffic: three tenants, 32 clients, coalesced then not
    jobs = fleet_jobs(FLEET_REQUESTS, pools, seed=22)
    want = [direct(texts[t], X) for t, X in jobs]
    runs = {}
    largest = None
    d = None
    try:
        for label, coalesce_us, js in (
                ("coalesced", FLEET_COALESCE_US, jobs),
                ("uncoalesced", 0, jobs[:FLEET_REPEAT])):
            d = ScoringDaemon(coalesce_us=coalesce_us,
                              max_batch=FLEET_MAX_BATCH, device=dev).start()
            rec = BatchRecorder(d.coalescer._predict)
            d.coalescer._predict = rec
            c = FleetClient(d.url)
            for t in texts:
                assert c.register(t, texts[t]) == 1
            # the main path of this phase: every count 0 just before it
            reset_counts()
            req0 = obs.counter("fleet/requests_total").value
            wall, ms, out = fleet_traffic(d.url, js)
            counts = read_counts()
            n_req = obs.counter("fleet/requests_total").value - req0
            assert n_req == len(js), (n_req, len(js))
            assert counts["K4"] > 0, "fleet: K4 never launched"
            # one launch a dispatched batch (each under ROW_CHUNK rows)
            assert counts["K4"] == len(rec.rows), (counts, len(rec.rows))
            for j, (preds, version) in enumerate(out):
                assert version == 1, (label, j, version)
                assert np.array_equal(preds, want[j]), (label, j)
            batch_rows = np.array(rec.rows)
            row = {"requests": len(js), "wall_s": wall,
                   "rps": len(js) / wall,
                   "p50_ms": float(np.percentile(ms, 50)),
                   "p99_ms": float(np.percentile(ms, 99)),
                   "batches": len(batch_rows),
                   "batch_rows_p50": float(np.percentile(batch_rows, 50)),
                   "batch_rows_p99": float(np.percentile(batch_rows, 99)),
                   "batch_rows_max": int(batch_rows.max()),
                   "launches": counts["K4"],
                   "launches_per_request": counts["K4"] / len(js),
                   "predict_ms_p50": float(np.percentile(rec.ms, 50)),
                   "predict_ms_p99": float(np.percentile(rec.ms, 99))}
            if largest is None:
                largest = rec.largest
            # one request in FLEET_PROFILED again under the profiler: the
            # card's busy share over the traffic
            prof = js[::FLEET_PROFILED]
            res = {}
            wall_p, busy = device_busy(
                lambda: res.setdefault("r", fleet_traffic(d.url, prof)), 1)
            for j, (preds, _) in enumerate(res["r"][2]):
                assert np.array_equal(preds, want[j * FLEET_PROFILED])
            # the dispatcher's predict calls run on its own thread, which
            # the profiler does not follow: the host's operators of a
            # batch's call, from the first batches replayed here
            batches = itertools.cycle(rec.sample)
            ops = host_ops(lambda: rec.fn(*next(batches)), len(rec.sample),
                           k=8)
            row.update(profiled=len(prof), profiled_ms=wall_p,
                       busy_ms=busy, busy_share=busy / wall_p,
                       replayed=len(rec.sample),
                       replayed_rows=int(np.median(
                           [X.shape[0] for _, X in rec.sample])),
                       host_ops=ops)
            runs[label] = row
            if label == "uncoalesced":
                d.stop()
                d = None
                break
            # -- the swap under load, on the coalesced daemon
            swaps0 = obs.counter("fleet/model_swaps").value
            blocks = [pools["lrb_a"][i * FLEET_ROWS:(i + 1) * FLEET_ROWS]
                      for i in range(16)]
            by_text = {tx: [direct(tx, b) for b in blocks]
                       for tx in (text_new, text_old)}
            version_text = {1: text_new, 2: text_old, 3: text_new,
                            4: text_old}
            stop = threading.Event()
            got, errs = [], []

            def hammer(k):
                fc = FleetClient(d.url)
                i = k
                try:
                    while not stop.is_set():
                        preds, v = fc.predict_versioned(
                            "lrb_a", blocks[i % 16])
                        got.append((i % 16, v, preds))
                        i += 1
                except Exception as e:  # noqa: BLE001 — reported below
                    errs.append(e)

            threads = [threading.Thread(target=hammer, args=(k,))
                       for k in range(SWAP_CLIENTS)]
            for th in threads:
                th.start()
            try:
                for v in (2, 3, 4):
                    assert c.register("lrb_a", version_text[v]) == v
                    t0 = time.monotonic()
                    while not errs and not any(g[1] == v for g in list(got)):
                        assert time.monotonic() - t0 < 60, f"v{v} unseen"
                        time.sleep(0.002)
            finally:
                stop.set()
                for th in threads:
                    th.join()
            assert not errs, errs[:3]
            for blk, v, preds in got:
                assert np.array_equal(preds, by_text[version_text[v]][blk]), \
                    (blk, v)
            n_swaps = obs.counter("fleet/model_swaps").value - swaps0
            assert n_swaps == 3, n_swaps
            per_v = {v: sum(1 for g in got if g[1] == v) for v in (1, 2, 3, 4)}
            print(f"fleet swap under load ({smi}): {SWAP_CLIENTS} clients on "
                  f"lrb_a while it was registered 3 times (two model texts "
                  f"in turn): {len(got)} responses, none failed, each "
                  f"bit-equal to its version's direct answer (per version "
                  f"{per_v}); fleet/model_swaps +{n_swaps}")
            d.stop()
            d = None
    finally:
        if d is not None:
            d.stop()
    for label, r in runs.items():
        print(f"fleet traffic, {label} ({smi}): {r['requests']} requests of "
              f"{FLEET_ROWS} rows from {FLEET_CLIENTS} clients over HTTP, "
              f"lrb_a:lrb_b:higgs 7:7:2, max_batch {FLEET_MAX_BATCH}: "
              f"{r['rps']:.1f} requests/s ({r['wall_s']:.2f} s); a request "
              f"p50/p99 {r['p50_ms']:.3f}/{r['p99_ms']:.3f} ms at its "
              f"client; {r['batches']} batches, fleet/coalesced_batch_rows "
              f"p50/p99 {r['batch_rows_p50']:.0f}/{r['batch_rows_p99']:.0f} "
              f"(max {r['batch_rows_max']}); predict call a batch p50/p99 "
              f"{r['predict_ms_p50']:.3f}/{r['predict_ms_p99']:.3f} ms; K4 "
              f"launches {r['launches']} ({r['launches_per_request']:.4f} a "
              f"request); every answer bit-equal to a direct call, version "
              f"1; profiled again on {r['profiled']} of the requests: wall "
              f"{r['profiled_ms']:.1f} ms, device busy {r['busy_ms']:.2f} ms "
              f"({100 * r['busy_share']:.2f}%); host time of a batch's "
              f"predict call by operator ({r['replayed']} recorded batches "
              f"replayed, median {r['replayed_rows']} rows): "
              f"{r['host_ops']}")
    X, preds, h = largest
    kern = check_forest(f"fleet largest batch ({X.shape[0]} rows)",
                        types.SimpleNamespace(_gbdt=h.gbdt), X, preds, dev)

    # -- phase 19's trace cut to FLEET_LOOP_WINDOWS windows of
    # FLEET_LOOP_WINDOW requests: in-process, then through the daemon
    prefix = os.path.join(tmp, "trace_prefix.txt")
    with open(loop["trace"]) as src, open(prefix, "w") as dst:
        dst.writelines(itertools.islice(
            src, FLEET_LOOP_WINDOWS * FLEET_LOOP_WINDOW))

    def run_prefix(daemon: bool):
        return lrb.run_trace_file(prefix, LOOP_CACHE, FLEET_LOOP_WINDOW,
                                  FLEET_LOOP_SAMPLE, LOOP_CUTOFF,
                                  LOOP_SAMPLING, result_file=_Lines(),
                                  extra_params={"tpu_lrb_pipeline": 0},
                                  serve_daemon=daemon)

    with loop_probes() as ref_probes:
        ref = run_prefix(False)
        ref.close()
    calls = []
    orig = lrb.LrbDriver._daemon_score

    def daemon_score(self, Xb):
        t0 = time.perf_counter()
        out = orig(self, Xb)
        calls.append((len(Xb), (time.perf_counter() - t0) * 1e3))
        return out

    lrb.LrbDriver._daemon_score = daemon_score
    drv = None
    try:
        reset_counts()
        req0 = obs.counter("fleet/requests_total").value
        t0 = time.perf_counter()
        drv = run_prefix(True)
        loop_s = time.perf_counter() - t0
        counts = read_counts()
        assert drv._fleet_daemon is not None, "the daemon did not start"
        version = drv._fleet_daemon.tenants.get("lrb")[1]
        warned = drv._fleet_warned
        res = drv.results
    finally:
        lrb.LrbDriver._daemon_score = orig
        if drv is not None:
            drv.close()
    n_req = obs.counter("fleet/requests_total").value - req0
    published = sum(1 for r in res if not r.get("degraded"))
    assert len(res) == FLEET_LOOP_WINDOWS and published == version, \
        (len(res), published, version)
    assert warned == 0, f"{warned} batches fell back to in-process scoring"
    assert len(ref.results) == FLEET_LOOP_WINDOWS
    for a, b in zip(res, ref.results):
        for k in PARITY_KEYS:
            assert a.get(k) == b.get(k), (a["window"], k, a.get(k), b.get(k))
    assert n_req == len(calls) == -(-FLEET_LOOP_WINDOW // FLEET_ROWS), \
        (n_req, len(calls))
    # one launch a request, and one warm-up a registration
    assert counts["K4"] == n_req + version, (counts, n_req, version)
    q = request_quantiles(calls)
    q_ref = request_quantiles(ref_probes["calls"][2])
    w2 = res[1]
    w2_ref = ref.results[1]
    print(f"lrb loop through the daemon ({smi}): phase 19's trace, "
          f"{FLEET_LOOP_WINDOWS} windows of {FLEET_LOOP_WINDOW} requests "
          f"(sample {FLEET_LOOP_SAMPLE}), sequential, serve_daemon=True on "
          f"{drv._device} in {loop_s:.1f} s: records equal to the same "
          f"windows' in-process run on {len(PARITY_KEYS)} keys; tenant "
          f"version {version}, fallbacks {warned}; window 2: {n_req} "
          f"requests of {FLEET_ROWS} rows over HTTP, evaluate "
          f"{w2.get('evaluate_s')} s (in-process {w2_ref.get('evaluate_s')}"
          f" s), a request p50/p99 {q['batch_p50']:.3f}/"
          f"{q['batch_p99']:.3f} ms (in-process {q_ref['batch_p50']:.3f}/"
          f"{q_ref['batch_p99']:.3f}); K4 "
          f"launches {counts['K4']} ({counts['K4'] / n_req:.4f} a request)")
    print(f"fleet phase: {time.perf_counter() - t_phase:.1f} s")
    co = runs["coalesced"]
    return {"launches": co["launches"], "requests": co["requests"],
            "launches_per_request": co["launches_per_request"],
            "batch_rows_p50": co["batch_rows_p50"],
            "batch_rows_p99": co["batch_rows_p99"],
            "uncoalesced": {k: runs["uncoalesced"][k] for k in (
                "launches", "requests", "launches_per_request",
                "batch_rows_p50", "batch_rows_p99")},
            "lrb_daemon_launches": counts["K4"],
            "largest_batch": {k: kern[k] for k in (
                "rows", "ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err")}}


class _Lines:
    """A result file that keeps its lines."""

    def __init__(self):
        self.lines = []

    def write(self, s: str) -> None:
        self.lines.extend(x for x in s.splitlines() if x)


def _body(text: str) -> str:
    """Model text before its parameters block."""
    return text[:text.index("\nparameters:")]


def in_turns(fns: dict, rounds: int) -> dict:
    """Median host-clock ms of a call of ``fns["plain"]`` and of
    ``fns["valid"]``, each ending in a synchronize, called in turns
    plain, valid, valid, plain, ``rounds`` times: the host's drift
    between runs (tens of ms an iteration) falls on both alike."""
    times = {"plain": [], "valid": []}
    for _ in range(rounds):
        for k in ("plain", "valid", "valid", "plain"):
            times[k] += wall_ms(fns[k], 1)
    return {k: float(np.median(v)) for k, v in times.items()}


def lrb_capi_with_valid(params: dict, Xl, yl, Xn, yn,
                        rollback: bool) -> dict:
    """Phase 6's C-API sequence with ``params``, the next window's rows
    as a valid set (``DatasetCreateFromMat(reference=)``,
    ``BoosterAddValidData``) and ``GetEval(bst, 1)`` after every
    iteration; with ``rollback``, the model text, ``GetPredict(0)``,
    ``GetPredict(1)`` and ``GetEval(1)`` saved before the last iteration
    and one ``RollbackOneIter`` after it. Counts are reset just before
    the sequence and read just after its last iteration."""
    import torch
    from lightgbm_tpu_torch import capi
    reset_counts()
    ds = capi.LGBM_DatasetCreateFromMat(Xl, parameters=params)
    capi.LGBM_DatasetSetField(ds, "label", yl)
    bst = capi.LGBM_BoosterCreate(ds, params)
    vd = capi.LGBM_DatasetCreateFromMat(Xn, parameters=params, reference=ds)
    capi.LGBM_DatasetSetField(vd, "label", yn)
    capi.LGBM_BoosterAddValidData(bst, vd)
    torch.cuda.synchronize()
    n_it = int(params["num_iterations"])
    iters, evals, saved = [], [], None
    for it in range(n_it):
        if rollback and it == n_it - 1:
            saved = (capi.LGBM_BoosterSaveModelToString(bst),
                     capi.LGBM_BoosterGetPredict(bst, 0),
                     capi.LGBM_BoosterGetPredict(bst, 1),
                     dict(capi.LGBM_BoosterGetEval(bst, 1)))
        t1 = time.perf_counter()
        finished = capi.LGBM_BoosterUpdateOneIter(bst)
        evals.append(dict(capi.LGBM_BoosterGetEval(bst, 1)))
        iters.append(time.perf_counter() - t1)
        if finished:
            break
    counts = read_counts()
    run = {"bst": bst, "vd": vd, "iters": iters, "evals": evals,
           "counts": counts, "text": capi.LGBM_BoosterSaveModelToString(bst),
           "ms": 1e3 * float(np.median(iters))}
    if rollback:
        capi.LGBM_BoosterRollbackOneIter(bst)
        text, p0, p1, ev = saved
        assert capi.LGBM_BoosterSaveModelToString(bst) == text, \
            "the rolled-back model is not the one saved before"
        errs = [float(np.abs(capi.LGBM_BoosterGetPredict(bst, 0) - p0).max()),
                float(np.abs(capi.LGBM_BoosterGetPredict(bst, 1) - p1).max())]
        errs += [abs(v - ev[k])
                 for k, v in capi.LGBM_BoosterGetEval(bst, 1)]
        assert max(errs) <= 1e-6, f"rollback: {errs} from the saved values"
        run["rollback_err"] = max(errs)
    return run


def valid_phases(dev, smi: str, earlier: dict, phase8: dict) -> dict:
    """Phase 21 of the module docstring: valid sets at full width.
    ``earlier`` holds phases 6, 7 and 11's readings (``train_phases``,
    ``quant_phases``), ``phase8`` phase 8's LRB readings of K2 and K1
    ({"K2": ..., "K1": ...}, each with "ms" and "shape"). Returns the
    readings the kernels line keeps."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import capi
    from lightgbm_tpu_torch.ops import hist_wave as hw
    t_phase = time.perf_counter()
    out = {}

    # (a) the HIGGS shape with its holdout as a valid set, through train()
    X, y, Xt, yt = (earlier[k] for k in ("X", "y", "Xt", "yt"))
    params = {**HIGGS_PARAMS, "metric": VALID_METRICS}
    ds = lgt.Dataset(X, label=y, params=params).construct()
    dv = ds.create_valid(Xt, label=yt).construct()
    res = {}
    reset_counts()
    t0 = time.perf_counter()
    bst = lgt.train(params, ds, num_boost_round=HIGGS_ITERS,
                    valid_sets=[dv], valid_names=["holdout"],
                    evals_result=res, verbose_eval=False,
                    keep_training_booster=True)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = read_counts()
    assert _body(bst.model_to_string()) == _body(earlier["text"]), \
        "higgs: the model trained with a valid set differs from phase 7's"
    assert counts["K3"] == 2 * HIGGS_ITERS, counts
    for k in ("K1", "K2"):
        assert counts[k] == earlier["counts"][k], (k, counts, earlier)
    assert bst._gbdt._n_total == HIGGS_TRAIN_ROWS + HOLDOUT_ROWS
    raw_valid = bst._gbdt.valid_scores(1)[0].double().cpu().numpy()
    raw_k4 = np.asarray(bst.predict(Xt, raw_score=True))
    err_k4 = float(np.abs(raw_valid - raw_k4).max())
    assert err_k4 <= 1e-5, f"higgs: valid scores {err_k4} from K4's"
    auc_k4 = auc_np(yt, np.asarray(bst.predict(Xt)))
    auc_rec = res["holdout"]["auc"][-1]
    assert abs(auc_rec - auc_k4) <= 1e-6, (auc_rec, auc_k4)
    assert len(res["holdout"]["binary_error"]) == HIGGS_ITERS
    wall, busy = device_busy(bst.update, 2)
    ms = 1e3 * train_s / HIGGS_ITERS
    # an iteration with and without the valid set, in turns: update and
    # the valid set's evaluation against phase 7's booster's update
    plain = lgt.Booster(HIGGS_PARAMS, lgt.Dataset(X, label=y,
                                                  params=HIGGS_PARAMS))
    plain.update()
    turns = in_turns({"plain": plain.update, "valid": lambda: (
        bst.update(), bst.eval_valid())},
        TURN_ROUNDS)
    del plain
    print(f"higgs with a valid set ({smi}): {HIGGS_TRAIN_ROWS} rows + the "
          f"{HOLDOUT_ROWS}-row holdout as passengers, {HIGGS_ITERS} "
          f"iterations through train() with {VALID_METRICS} on the holdout "
          f"every iteration: {ms:.1f} ms/iteration (phase 7 without it "
          f"{earlier['ms']:.1f}); profile of 2 iterations: wall {wall:.1f} "
          f"ms, device busy {busy:.2f} ms ({100 * busy / wall:.1f}%; phase 7 "
          f"{100 * earlier['busy']:.1f}%); model text (before its "
          f"parameters) equal to phase 7's; K1 {counts['K1']}, K2 "
          f"{counts['K2']} launches as phase 7, K3 {counts['K3']} (2 a "
          f"tree); valid scores within {err_k4:.3g} of K4's; holdout auc "
          f"{auc_rec:.6f} recorded, {auc_k4:.6f} from K4's predictions; in "
          f"turns ({TURN_ROUNDS} x plain, valid, valid, plain): an update "
          f"{turns['plain']:.1f} ms without the valid set, "
          f"{turns['valid']:.1f} ms with it and its evaluation")
    out["higgs"] = {"ms_per_iteration": ms, "phase7_ms": earlier["ms"],
                    "busy": busy / wall, "k3_launches": counts["K3"],
                    "k3_per_tree": counts["K3"] / HIGGS_ITERS,
                    "max_abs_err_vs_k4": err_k4, "in_turns_ms": turns}
    del bst, ds, dv

    # (b) the LRB window through the C API with the next window as a
    # valid set, K1's widest wave captured with the passengers
    lrb = earlier["lrb"]
    Xl = make_lrb_rows(LRB_TRAIN_ROWS, seed=21)
    yl = lrb_labels(Xl, seed=22)
    Xn = make_lrb_rows(LRB_NEXT_ROWS, seed=23)
    yn = lrb_labels(Xn, seed=24)
    with capturing() as caps:
        run = lrb_capi_with_valid(TRAIN_PARAMS, Xl, yl, Xn, yn, True)
    bst, counts, n_it = run["bst"], run["counts"], len(run["iters"])
    assert run["text"] == lrb["text"], \
        "lrb: the model trained with a valid set differs from phase 6's"
    assert counts["K3"] == 2 * n_it, counts
    for k in ("K1", "K2"):
        assert counts[k] == lrb["counts"][k], (k, counts, lrb["counts"])
    names = capi.LGBM_BoosterGetEvalNames(bst)
    assert capi.LGBM_BoosterGetEvalCounts(bst) == 2, names
    assert names == ["binary_logloss", "auc"], names
    assert capi.LGBM_BoosterGetNumPredict(bst, 1) == LRB_NEXT_ROWS
    # the model is back at 49 trees: score the next window with it
    got = capi.LGBM_BoosterGetPredict(bst, 1)
    want = np.asarray(capi.LGBM_BoosterPredictForMat(bst, Xn))
    err_pred = float(np.abs(got - want).max())
    assert err_pred <= 1e-5, f"lrb: GetPredict(1) {err_pred} from K4's"
    # K2's root pass and K1's widest wave with the passengers: bit for
    # bit against their plain versions in the kernels' order, timed
    # beside phase 8's launches without them (phase 8's bound formulas)
    kernels = {}
    for kid, key, fn, plain, hist_of, slots_of in (
            ("K2", "K2", hw.wave_histogram, hw.wave_histogram_plain,
             lambda o: o, None),
            ("K1", "K1w", hw.fused_partition_histogram,
             hw.fused_partition_histogram_plain, lambda o: o[1],
             lambda o: o[0])):
        args, kw = caps[key].args, caps[key].kw
        assert kw["counted_rows"] == LRB_TRAIN_ROWS, kw
        assert args[0].shape[1] == LRB_TRAIN_ROWS + LRB_NEXT_ROWS

        def kern(*a, fn=fn, kw=kw):
            return fn(*a, **kw)

        def ref(*a, plain=plain, kw=kw, **k):
            return plain(*a, **plain_kw(kw), **k)
        st = check_histogram(f"lrb {kid} with passengers", kern, ref, args,
                             hist_of, slots_of)
        F, n = args[0].shape
        W, B = (args[4].shape[0] if kid == "K2" else args[5].shape[1],
                args[-1])
        cnt = st["rows_counted"]
        kernels[kid] = dict(
            shape=f"F={F}, N={n} ({LRB_NEXT_ROWS} passengers), W={W}, "
                  f"B={B}",
            ms=cuda_ms(lambda: kern(*args), 5),
            plain_ms=cuda_ms(lambda: ref(*args), 3),
            max_abs_err=st["max_abs_err"],
            max_abs_err_f64=st["max_abs_err_f64"],
            phase8_ms=phase8[kid]["ms"], phase8_shape=phase8[kid]["shape"],
            launches=counts[f"{kid}/f32"],
            # K2's yardstick: one index_add_ of the same rows (none for
            # K1, which no PyTorch call computes)
            library_ms=(lib_index_add(args, dev, kw) if kid == "K2"
                        else None),
            **pass_report("lrb valid", kid, kern, args, kw, cnt),
            **(bound(F * n + 12 * n + 4 * W + 12 * W * F * B, 3 * F * cnt)
               if kid == "K2" else
               bound(F * n + 20 * n + 36 * W + 12 * W * F * B,
                     n + 3 * F * cnt)))
    print(f"lrb with a valid set ({smi}): {LRB_TRAIN_ROWS} rows + the next "
          f"{LRB_NEXT_ROWS} as passengers through the C API, {n_it} "
          f"iterations with GetEval(1) after each: median {run['ms']:.1f} "
          f"ms/iteration (phase 6 without it {lrb['ms']:.1f}); model text "
          f"equal to phase 6's; K1 {counts['K1']}, K2 {counts['K2']} "
          f"launches as phase 6, K3 {counts['K3']} (2 a tree); eval names "
          f"{names}; GetPredict(1) within {err_pred:.3g} of PredictForMat; "
          f"RollbackOneIter after iteration {n_it}: the text saved after "
          f"{n_it - 1}, GetPredict(0), GetPredict(1), GetEval(1) within "
          f"{run['rollback_err']:.3g}; last valid eval {run['evals'][-1]}")
    for kid, k in kernels.items():
        print(f"lrb {kid} with passengers at [{k['shape']}]: {k['ms']:.3f} "
              f"ms (phase 8 without them {k['phase8_ms']:.3f} ms at "
              f"[{k['phase8_shape']}]), plain {k['plain_ms']:.3f} ms, "
              + (f"index_add_ {k['library_ms']:.3f} ms, "
                 if k["library_ms"] is not None else "")
              + f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}); "
              f"bit-equal to the plain version in the kernels' order "
              f"(sums, counts"
              f"{', leaf ids' if kid == 'K1' else ''}), two launches "
              f"bit-identical")
    # an iteration with and without the valid set, in turns: phase 6's
    # sequence on the same rows against this booster's update and
    # GetEval(1)
    ds = capi.LGBM_DatasetCreateFromMat(Xl, parameters=TRAIN_PARAMS)
    capi.LGBM_DatasetSetField(ds, "label", yl)
    plain = capi.LGBM_BoosterCreate(ds, TRAIN_PARAMS)
    capi.LGBM_BoosterUpdateOneIter(plain)
    turns = in_turns({
        "plain": lambda: capi.LGBM_BoosterUpdateOneIter(plain),
        "valid": lambda: (capi.LGBM_BoosterUpdateOneIter(bst),
                          capi.LGBM_BoosterGetEval(bst, 1))},
        2 * TURN_ROUNDS)
    capi.LGBM_BoosterFree(plain)
    print(f"lrb in turns ({2 * TURN_ROUNDS} x plain, valid, valid, plain): "
          f"an update {turns['plain']:.1f} ms without the valid set, "
          f"{turns['valid']:.1f} ms with it and GetEval(1)")
    out["lrb"] = {"ms_per_iteration": run["ms"], "phase6_ms": lrb["ms"],
                  "k3_launches": counts["K3"],
                  "k3_per_tree": counts["K3"] / len(run["iters"]),
                  "rollback_err": run["rollback_err"], "in_turns_ms": turns}
    out.update(kernels)
    capi.LGBM_BoosterFree(bst)
    del caps, run, bst, ds

    # (c) the int8 tier with exact counts (phase 11's parameters)
    params = {**TRAIN_PARAMS, "tpu_quantized_hist": "true",
              "tpu_count_proxy": "0"}
    run = lrb_capi_with_valid(params, Xl, yl, Xn, yn, False)
    assert run["text"] == earlier["lrb_int8_text"], \
        "lrb int8: the model trained with a valid set differs from phase 11's"
    for k in ("K2/int8", "K1/int8"):
        assert run["counts"].get(k, 0) > 0, run["counts"]
    assert run["counts"]["K3"] == 2 * len(run["iters"]), run["counts"]
    print(f"lrb int8 with a valid set ({smi}): model text equal to phase "
          f"11's; median {run['ms']:.1f} ms/iteration with GetEval(1); "
          f"launches {run['counts']}")
    out["lrb_int8_ms"] = run["ms"]
    capi.LGBM_BoosterFree(run["bst"])
    del run

    # (d) early stopping: coin-flip valid labels
    params = {k: v for k, v in TRAIN_PARAMS.items() if k != "num_iterations"}
    coin = (np.random.default_rng(25).random(LRB_NEXT_ROWS) < 0.5).astype(
        np.float32)
    seen = []
    t0 = time.perf_counter()
    b = lgt.train(params, lgt.Dataset(Xl, label=yl), STOP_ROUNDS,
                  valid_sets=[lgt.Dataset(Xn, label=coin)],
                  early_stopping_rounds=STOP_PATIENCE, verbose_eval=False,
                  callbacks=[lambda env: seen.append(env.iteration)])
    torch.cuda.synchronize()
    stop_s = time.perf_counter() - t0
    bi, nt = b.best_iteration, b.num_trees()
    bs = {k: dict(v) for k, v in b.best_score.items()}
    assert nt == bi + STOP_PATIENCE < 50, (bi, nt)
    assert seen == list(range(nt)), seen
    print(f"early stopping ({smi}): {LRB_TRAIN_ROWS} LRB rows, "
          f"{LRB_NEXT_ROWS} valid rows of coin-flip labels, "
          f"early_stopping_rounds {STOP_PATIENCE} of {STOP_ROUNDS}: stopped "
          f"after {nt} iterations, best iteration {bi}, best score {bs}, "
          f"the user callback called at each; {stop_s:.2f} s with binning")
    out["early_stop"] = {"best_iteration": bi, "trees": nt, "s": stop_s}
    del b
    print(f"valid set phase: {time.perf_counter() - t_phase:.1f} s")
    return out


class _RowCapture:
    """Wraps the boosting loop's K3 calls (``models/gbdt.add_leaf_outputs``)
    and keeps clones of the arguments of call number ``index``."""

    def __init__(self, fn, index: int):
        self.fn, self.index, self.calls, self.args = fn, index, 0, None

    def __call__(self, *args, **kw):
        if self.calls == self.index:
            self.args = _clone(args)
        self.calls += 1
        return self.fn(*args, **kw)


class _RenewProbe:
    """Wraps ``models/gbdt.renew_leaf_outputs``: each call timed between
    CUDA events, the first call's inputs and output kept, and whether any
    call changed a leaf output."""

    def __init__(self, fn):
        self.fn, self.ms, self.first, self.changed = fn, [], None, 0

    def __call__(self, *args, **kw):
        import torch
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.fn(*args, **kw)
        b.record()
        b.synchronize()
        self.ms.append(a.elapsed_time(b))
        cur = args[5]
        self.changed += int(not torch.equal(out, cur))
        if self.first is None:
            self.first = (_clone(args), dict(kw), out.clone())
        return out


def _train_timed(params, ds, iters, **kw):
    """lgt.train on the card with the launch counts reset before it and
    read after it: (booster, seconds, counts)."""
    import torch
    import lightgbm_tpu_torch as lgt
    reset_counts()
    t0 = time.perf_counter()
    bst = lgt.train(params, ds, num_boost_round=iters, verbose_eval=False,
                    keep_training_booster=True, **kw)
    torch.cuda.synchronize()
    return bst, time.perf_counter() - t0, read_counts()


def _l2_fobj(preds, data):
    """A custom objective: L2's gradients from float64 raw scores."""
    return preds - data.get_label(), np.ones_like(preds)


def objective_phases(dev, smi: str) -> dict:
    """Phase 22 of the module docstring: every objective family on the
    card at the published widths of public sets, and card against CPU at
    small sizes. Returns the readings the kernels line keeps."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.models import gbdt as gbdt_mod
    from lightgbm_tpu_torch.objectives.objective import \
        LAMBDARANK_CHUNK_BYTES
    from lightgbm_tpu_torch.ops import forest as forest_ops
    from lightgbm_tpu_torch.ops import renew as renew_mod
    from lightgbm_tpu_torch.ops import stacked_predict as sp
    t_phase = time.perf_counter()
    out = {}
    walls = {}

    # (a) multiclass: Covertype's shape, the holdout as a valid set
    t0 = time.perf_counter()
    X, y = make_covertype_like(COVERTYPE_ROWS, seed=61)
    Xt, yt = X[COVERTYPE_TRAIN:], y[COVERTYPE_TRAIN:]
    X, y = X[:COVERTYPE_TRAIN], y[:COVERTYPE_TRAIN]
    K = COVERTYPE_CLASSES
    params = {**OBJ_PARAMS, "objective": "multiclass", "num_class": K,
              "metric": "multi_logloss,multi_error"}
    ds = lgt.Dataset(X, label=y, params=params).construct()
    dv = ds.create_valid(Xt, label=yt).construct()
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    res = {}
    # K3 on class row 3 of the train scores in iteration 2 (each class
    # updates the train rows, then the holdout's)
    cap = _RowCapture(gbdt_mod.add_leaf_outputs, 2 * K * 1 + 2 * 3)
    gbdt_mod.add_leaf_outputs = cap
    try:
        bst, train_s, counts = _train_timed(
            params, ds, OBJ_ITERS, valid_sets=[dv], valid_names=["holdout"],
            evals_result=res)
    finally:
        gbdt_mod.add_leaf_outputs = cap.fn
    g = bst._gbdt
    iters = bst.current_iteration()
    assert iters == OBJ_ITERS and len(g.models) == K * OBJ_ITERS
    assert counts["K3"] == 2 * K * OBJ_ITERS, counts
    assert cap.args is not None and cap.args[0].shape[0] == COVERTYPE_TRAIN
    k3 = check_leaf_gather(cap.args)
    forest_ops.launches.reset()
    sp.fallbacks.reset()
    prob = bst.predict(Xt)
    torch.cuda.synchronize()
    k4_launches = forest_ops.launches.value
    assert k4_launches > 0 and sp.fallbacks.value == 0
    assert prob.shape == (len(yt), K) and np.isfinite(prob).all()
    row_sum = float(np.abs(prob.sum(axis=1) - 1.0).max())
    assert row_sum <= 1e-6, f"covertype: class probabilities sum {row_sum}"

    def softmax_rows(raw):
        return g.objective.convert_output(
            torch.from_numpy(np.ascontiguousarray(raw.T))).numpy().T
    k4 = check_forest("covertype", bst, Xt, prob, dev, convert=softmax_rows,
                      alternatives=False)
    acc = float((prob.argmax(axis=1) == yt).mean())
    rec = {k: res["holdout"][k][-1] for k in ("multi_logloss",
                                              "multi_error")}
    assert abs(rec["multi_error"] - (1.0 - acc)) <= 1e-6, (rec, acc)
    checks_s = time.perf_counter() - t0 - prep_s - train_s
    wall, busy = device_busy(bst.update, 1)       # an 11th iteration
    cfg = g._grower_cfg
    ms = 1e3 * train_s / iters
    print(f"covertype multiclass ({smi}): {COVERTYPE_TRAIN} x 54 train rows "
          f"+ the {len(yt)}-row holdout as passengers, {K} classes, "
          f"{iters} iterations of {K} trees of {OBJ_PARAMS['num_leaves']} "
          f"leaves, W={cfg.wave_size}, B={cfg.num_bins}: {ms:.1f} ms an "
          f"iteration ({ms / K:.1f} a tree); profile of 1 iteration: wall "
          f"{wall:.1f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%); per iteration K1 "
          f"{counts['K1'] / iters:.1f}, K2 {counts['K2'] / iters:.1f}, K3 "
          f"{counts['K3'] / iters:.1f} ({K} train + {K} holdout) launches; "
          f"holdout multi_logloss {rec['multi_logloss']:.5f}, multi_error "
          f"{rec['multi_error']:.5f} (accuracy {acc:.5f} from K4's "
          f"probabilities, whose rows sum to 1 within {row_sum:.2g}); "
          f"walls: data and binning {prep_s:.1f} s, training "
          f"{train_s:.1f} s, K3/K4 checks {checks_s:.1f} s")
    print(f"covertype K3 on class row 3 [{k3['shape']}]: bit-equal to its "
          f"plain version; {k3['ms']:.4f} ms, plain {k3['plain_ms']:.4f} "
          f"ms, index_select {k3['library_ms']:.4f} ms, bound "
          f"{k3['bound_ms']:.4f} ms ({k3['bound_by']})")
    out["covertype"] = {
        "ms_per_iteration": ms, "busy": busy / wall,
        "launches_per_iteration": {k: counts[k] / iters
                                   for k in ("K1", "K2", "K3")},
        "k3_row3": k3, "k4": k4, "k4_launches": k4_launches,
        "holdout": rec}
    del X, y, Xt, yt, ds, dv, bst, g
    walls["a"] = time.perf_counter() - t0

    # (b) regression: YearPredictionMSD's shape and split, L2 and L1
    t0 = time.perf_counter()
    X, y = make_year_like(YEAR_ROWS, seed=62)
    Xt, yt = X[YEAR_TRAIN:], y[YEAR_TRAIN:]
    X, y = X[:YEAR_TRAIN], y[:YEAR_TRAIN]
    for objective, metric in (("regression", "l2"), ("regression_l1", "l1")):
        params = {**OBJ_PARAMS, "objective": objective, "metric": metric}
        ds = lgt.Dataset(X, label=y, params=params).construct()
        dv = ds.create_valid(Xt, label=yt).construct()
        res = {}
        probe = _RenewProbe(gbdt_mod.renew_leaf_outputs)
        gbdt_mod.renew_leaf_outputs = probe
        try:
            bst, train_s, counts = _train_timed(
                params, ds, OBJ_ITERS, valid_sets=[dv],
                valid_names=["test"], evals_result=res)
        finally:
            gbdt_mod.renew_leaf_outputs = probe.fn
        g = bst._gbdt
        cfg = g._grower_cfg
        # the recorded metric against the valid scores in float64, and
        # those scores (f32 sums near 2000) against K4's predictions
        raw = g.valid_scores(1)[0].double().cpu().numpy()
        pred = np.asarray(bst.predict(Xt))
        gap = float(np.abs(raw - pred).max())
        assert gap <= 1e-6 * float(np.abs(pred).max()), (objective, gap)
        err = (np.mean((raw - yt) ** 2) if metric == "l2"
               else np.mean(np.abs(raw - yt)))
        got = res["test"][metric][-1]
        assert abs(got - err) <= 1e-9 * err, (metric, got, err)
        line = (f"year {objective} ({smi}): {YEAR_TRAIN} x {YEAR_FEATURES} "
                f"train rows + {len(yt)} test rows as passengers, "
                f"{OBJ_ITERS} iterations of {OBJ_PARAMS['num_leaves']} "
                f"leaves, W={cfg.wave_size}: "
                f"{1e3 * train_s / OBJ_ITERS:.1f} ms an iteration; K1 "
                f"{counts['K1'] / OBJ_ITERS:.1f} a tree; test {metric} "
                f"{got:.4f}; the test rows' scores within {gap:.3g} of "
                f"K4's predictions")
        if objective == "regression":
            # hilo3: constant hessians
            assert cfg.wave_size == min(40, OBJ_PARAMS["num_leaves"] - 1), cfg
            assert not probe.ms
            out["year_l2"] = {"ms_per_iteration": 1e3 * train_s / OBJ_ITERS,
                              "W": cfg.wave_size, metric: got}
        else:
            assert len(probe.ms) == OBJ_ITERS and probe.changed > 0
            args, kw, card_out = probe.first
            cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in args]
            cpu_out = renew_mod.renew_leaf_outputs(*cpu_args, **kw)
            assert torch.equal(card_out.cpu(), cpu_out), \
                "renewal: card != CPU on the same leaf ids and residuals"
            med = float(np.median(probe.ms))
            line += (f"; renewal {med:.2f} ms a tree (median of "
                     f"{len(probe.ms)}, CUDA events; {probe.changed} trees "
                     f"renewed to other outputs), bit-equal to its CPU run "
                     f"on the same leaf ids and residuals")
            out["year_l1"] = {"ms_per_iteration": 1e3 * train_s / OBJ_ITERS,
                              "W": cfg.wave_size, metric: got,
                              "renew_ms": med, "renewed_trees":
                              probe.changed}
        print(line)
        del ds, dv, bst, g
    del X, y, Xt, yt
    walls["b"] = time.perf_counter() - t0

    # (c) lambdarank: MSLR-WEB10K Fold 1's shape, a 1,000-query holdout
    t0 = time.perf_counter()
    X, y, counts_q = make_mslr_like(MSLR_QUERIES, MSLR_ROWS, seed=63)
    Xt, yt, counts_t = make_mslr_like(
        MSLR_HOLDOUT_QUERIES, int(MSLR_ROWS * MSLR_HOLDOUT_QUERIES
                                  / MSLR_QUERIES), seed=64)
    ks = [1, 3, 5, 10]
    params = {**OBJ_PARAMS, "objective": "lambdarank", "metric": "ndcg",
              "eval_at": ",".join(map(str, ks))}
    ds = lgt.Dataset(X, label=y, group=counts_q, params=params).construct()
    dv = ds.create_valid(Xt, label=yt, group=counts_t).construct()
    res = {}
    bst, train_s, counts = _train_timed(
        params, ds, OBJ_ITERS, valid_sets=[dv], valid_names=["holdout"],
        evals_result=res)
    g = bst._gbdt
    obj = g.objective
    grad_ms = cuda_ms(lambda: obj.get_gradients(g._scores[0]), 3)
    widths = sorted({w for _, w in obj.chunks})
    raw = g.valid_scores(1)[0].double().cpu().numpy()
    want = ndcg_np(raw, yt, counts_t, ks)
    got = [res["holdout"][f"ndcg@{k}"][-1] for k in ks]
    gap = max(abs(a - b) for a, b in zip(got, want))
    assert gap <= NDCG_TOL, (got, want)
    print(f"mslr lambdarank ({smi}): {MSLR_ROWS} x {MSLR_FEATURES} rows in "
          f"{MSLR_QUERIES} queries (longest {int(counts_q.max())}) + the "
          f"{len(yt)}-row {MSLR_HOLDOUT_QUERIES}-query holdout as "
          f"passengers, {OBJ_ITERS} iterations of "
          f"{OBJ_PARAMS['num_leaves']} leaves: "
          f"{1e3 * train_s / OBJ_ITERS:.1f} ms an iteration; the gradient "
          f"step {grad_ms:.1f} ms (CUDA events) in {len(obj.chunks)} chunks "
          f"of queries, widths {widths[0]}-{widths[-1]}, under "
          f"{LAMBDARANK_CHUNK_BYTES / 2 ** 30:g} GiB of pair tensors a "
          f"chunk; holdout NDCG@"
          + ",".join(map(str, ks)) + " "
          + ", ".join(f"{v:.5f}" for v in got)
          + f", within {gap:.2g} of the host's float64 NDCG")
    out["mslr"] = {"ms_per_iteration": 1e3 * train_s / OBJ_ITERS,
                   "grad_ms": grad_ms, "chunks": len(obj.chunks),
                   "ndcg": dict(zip(ks, got)), "ndcg_gap": gap}
    del X, y, Xt, yt, ds, dv, bst, g, obj
    walls["c"] = time.perf_counter() - t0

    # (d) card against CPU at small sizes
    t0 = time.perf_counter()
    Xc, yc = make_covertype_like(OBJ_CPU_ROWS, seed=71)
    Xy, yy = make_year_like(OBJ_CPU_ROWS, seed=72)
    Xr, yr, cr = make_mslr_like(OBJ_CPU_QUERIES, int(
        MSLR_ROWS * OBJ_CPU_QUERIES / MSLR_QUERIES), seed=73)
    small = {"num_leaves": OBJ_CPU_LEAVES, "max_bin": 255, "verbose": -1}
    cases = [
        ("multiclass", Xc, yc, {"num_class": K}, {}),
        ("multiclassova", Xc, yc, {"num_class": K}, {}),
        ("regression", Xy, yy, {"boost_from_average": False}, {}),
        ("regression_l1", Xy, yy, {}, {}),
        ("huber", Xy, yy, {"alpha": 5.0}, {}),
        ("poisson", Xy, yy - 1900.0, {}, {}),
        ("lambdarank", Xr, yr, {}, {"group": cr}),
        ("fobj", Xy, yy, {"boost_from_average": False}, {})]
    texts = {}
    out["card_vs_cpu"] = {}
    for name, Xs, ys, extra, ds_kw in cases:
        objective = "regression" if name == "fobj" else name
        params = {**small, "objective": objective, **extra}
        runs = card_and_cpu(params, Xs, ys, OBJ_CPU_ITERS,
                            fobj=_l2_fobj if name == "fobj" else None,
                            **ds_kw)
        metric = next(iter(runs["cuda"][1]))
        _, where = judge_trees(runs, metric=metric, tol=OBJ_METRIC_TOL)
        texts[name] = runs["cuda"][0].model_to_string()
        print(f"{name} card vs CPU, {Xs.shape[0]} x {Xs.shape[1]} rows x "
              f"{OBJ_CPU_ITERS} iterations of {OBJ_CPU_LEAVES} leaves: "
              f"{where}; train {metric} {runs['cuda'][1][metric]:.6g} vs "
              f"{runs['cpu'][1][metric]:.6g}; {runs['cuda'][2]:.1f} s on "
              f"the card, {runs['cpu'][2]:.1f} s on the CPU")
        out["card_vs_cpu"][name] = where
    assert texts["fobj"] == texts["regression"], \
        "the fobj model text differs from the regression model's"
    print("fobj with L2's gradients: model text equal to the regression "
          "model's of this run")
    walls["d"] = time.perf_counter() - t0
    total = time.perf_counter() - t_phase
    print("phase 22 walls: " + ", ".join(f"({k}) {v:.1f} s"
                                        for k, v in walls.items())
          + f"; in all {total:.1f} s (budget {PHASE22_BUDGET_S:.0f} s)")
    assert total <= PHASE22_BUDGET_S, f"phase 22 took {total:.1f} s"
    out["walls"] = walls
    return out


def tree_blocks(text: str) -> list:
    """The ``Tree=i`` blocks of a model text, each without its header
    line."""
    body = text.split("end of trees")[0]
    return [b.split("\n", 1)[1].strip() for b in body.split("\nTree=")[1:]]


class _GossSpy:
    """Wraps ``models/boosting.goss_sample``: each sampled iteration's
    inputs and outputs copied to the host, the copies' seconds kept
    apart from the training's."""

    def __init__(self, fn):
        self.fn, self.calls, self.copy_s = fn, [], 0.0

    def __call__(self, g, h, mask, key, top_rate, other_rate):
        import torch
        out = self.fn(g, h, mask, key, top_rate, other_rate)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.calls.append((key, g.cpu(), h.cpu(), mask.cpu(),
                           [o.cpu() for o in out]))
        self.copy_s += time.perf_counter() - t0
        return out


def _goss_tier(name, params, ds, Xt, yt, higgs, smi, exact_auc=None) -> dict:
    """Phase 23(a) on one tier: GOSS_ITERS iterations through ``train``;
    each sampled iteration's kept mask and amplified g and h against the
    plain sampler run on the CPU on the same gradients, bit for bit. The
    exact tier's holdout AUC is held to phase 7's, the count-proxy
    tier's (``exact_auc`` given) to the exact tier's GOSS run."""
    import torch
    from lightgbm_tpu_torch.models import boosting as bm
    spy = _GossSpy(bm.goss_sample)
    bm.goss_sample = spy
    try:
        bst, train_s, counts = _train_timed(params, ds, GOSS_ITERS)
    finally:
        bm.goss_sample = spy.fn
    g = bst._gbdt
    n = g._n
    warm = int(1.0 / float(params["learning_rate"]))
    assert len(spy.calls) == GOSS_ITERS - warm, len(spy.calls)
    kept = []
    for key, gg, hh, mm, out in spy.calls:
        plain = bm.goss_sample(gg, hh, mm, key, params["top_rate"],
                               params["other_rate"])
        for a, b in zip(out, plain):
            assert torch.equal(a, b), f"goss {name}: card != plain sampler"
        kept.append(int(out[2][:n].sum()))
    want = (GOSS_RATES["top_rate"] + GOSS_RATES["other_rate"]) * n
    worst = max(abs(k - want) for k in kept)
    assert worst <= GOSS_KEPT_TOL * n, (kept, want)
    from lightgbm_tpu_torch.ops import forest as forest_ops
    forest_ops.launches.reset()
    prob = bst.predict(Xt)
    torch.cuda.synchronize()
    k4_launches = forest_ops.launches.value
    assert k4_launches > 0
    assert prob.shape == yt.shape and np.isfinite(prob).all()
    auc = auc_np(yt, prob)
    text = bst.model_to_string()
    blocks = tree_blocks(text)
    if g._grower_cfg.precision == "f32":
        # warm-up is gbdt: the first trees are phase 7's, bit for bit
        assert blocks[:warm] == tree_blocks(higgs["text"])[:warm], \
            "goss warm-up trees differ from phase 7's"
        lo, hi = GOSS_AUC_BAND
        assert lo <= auc - higgs["auc"] <= hi, (auc, higgs["auc"])
    else:
        assert abs(auc - exact_auc) <= PROXY_AUC_TOL, (auc, exact_auc)
    ms = 1e3 * (train_s - spy.copy_s) / GOSS_ITERS
    wall, busy = device_busy(bst.update, 1)
    cfg = g._grower_cfg
    print(f"goss {name} ({smi}): {n} x 28 rows, {GOSS_ITERS} iterations "
          f"({warm} of warm-up) of {cfg.num_leaves} leaves, {cfg.precision}"
          f"{' count-proxy' if cfg.count_proxy else ''}, W={cfg.wave_size}: "
          f"{ms:.1f} ms an iteration (the host copies of the check, "
          f"{spy.copy_s:.2f} s, taken out); profile of 1 sampled "
          f"iteration: wall {wall:.1f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%); per iteration K1 "
          f"{counts['K1'] / GOSS_ITERS:.1f}, K2 "
          f"{counts['K2'] / GOSS_ITERS:.1f}, K3 "
          f"{counts['K3'] / GOSS_ITERS:.1f}; kept rows of the sampled "
          f"iterations {kept} (0.3 n = {want:.0f}), each mask and its "
          f"amplified g and h bit-equal to the plain sampler on the CPU; "
          f"holdout auc {auc:.5f} against "
          + (f"phase 7's {higgs['auc']:.5f}; the warm-up trees equal phase "
             f"7's" if exact_auc is None else
             f"{exact_auc:.5f} on the exact tier"))
    return {"ms_per_iteration": ms, "busy": busy / wall, "auc": auc,
            "kept": kept, "k4_launches": k4_launches,
            "launches_per_iteration": {
                k: counts[k] / GOSS_ITERS for k in ("K1", "K2", "K3")}}


def variant_phases(dev, smi: str, higgs: dict, tmp: str) -> dict:
    """Phase 23 of the module docstring: GOSS, DART, RF, forced splits
    and continued training on the card, and card against CPU at small
    sizes. Returns the readings the kernels line keeps."""
    import types
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import capi
    from lightgbm_tpu_torch.ops import forest as forest_ops
    from lightgbm_tpu_torch.ops import stacked_predict as sp
    t_phase = time.perf_counter()
    out, walls = {}, {}

    # (a) GOSS at the HIGGS shape, exact and count-proxy
    t0 = time.perf_counter()
    params = {**HIGGS_PARAMS, "boosting": "goss", **GOSS_RATES}
    ds = lgt.Dataset(higgs["X"], label=higgs["y"], params=params).construct()
    exact = _goss_tier("exact", params, ds, higgs["Xt"], higgs["yt"], higgs,
                       smi)
    out["goss"] = {"exact": exact, "count-proxy": _goss_tier(
        "count-proxy", {**params, "tpu_quantized_hist": "true"}, ds,
        higgs["Xt"], higgs["yt"], higgs, smi, exact_auc=exact["auc"])}
    del ds
    walls["a"] = time.perf_counter() - t0

    # (b) DART at the LRB window through the C API
    t0 = time.perf_counter()
    X = make_lrb_rows(LRB_TRAIN_ROWS, seed=21)
    y = lrb_labels(X, seed=22)
    Xn = make_lrb_rows(LRB_NEXT_ROWS, seed=23)
    reset_counts()
    h = capi.LGBM_DatasetCreateFromMat(X, parameters=DART_PARAMS)
    capi.LGBM_DatasetSetField(h, "label", y)
    bst = capi.LGBM_BoosterCreate(h, DART_PARAMS)
    # K3 launches of the drops and of their normalisation, counted where
    # they are made: around the two DART steps of each iteration
    k3 = _counters()["K3"]
    drop_k3 = [0]

    def counted(step):
        def run():
            before = k3.value
            step()
            drop_k3[0] += k3.value - before
        return run
    dart = bst.gbdt
    dart._dropping_trees = counted(dart._dropping_trees)
    dart._normalize = counted(dart._normalize)
    iters, drops = [], 0
    for _ in range(int(DART_PARAMS["num_iterations"])):
        t1 = time.perf_counter()
        assert not capi.LGBM_BoosterUpdateOneIter(bst)
        torch.cuda.synchronize()
        iters.append(time.perf_counter() - t1)
        drops += len(bst.gbdt._drop_index)
    counts = read_counts()
    del dart._dropping_trees, dart._normalize
    n_it = len(iters)
    drop_k3 = drop_k3[0]
    # one K3 launch a tree, and two a dropped tree: its subtraction and
    # its rescaled return
    assert drop_k3 == 2 * drops and drops > 0, (drop_k3, drops)
    assert counts["K3"] == n_it + drop_k3, (counts, drop_k3)
    forest_ops.launches.reset()
    sp.fallbacks.reset()
    pred = np.asarray(capi.LGBM_BoosterPredictForMat(bst, Xn))
    torch.cuda.synchronize()
    dart_k4 = forest_ops.launches.value
    assert dart_k4 > 0 and sp.fallbacks.value == 0
    host = host_raw(bst.gbdt, Xn)[0]
    err_host = float(np.abs(pred - 1.0 / (1.0 + np.exp(-host))).max())
    assert err_host <= 1e-5, f"dart: {err_host} from the host walk"
    k4 = check_forest("dart", types.SimpleNamespace(_gbdt=bst.gbdt), Xn,
                      pred, dev, alternatives=False)
    ms = 1e3 * float(np.median(iters))
    wall, busy = device_busy(lambda: capi.LGBM_BoosterUpdateOneIter(bst), 1)
    print(f"lrb dart ({smi}): {LRB_TRAIN_ROWS} x {LRB_FEATURES}, {n_it} "
          f"iterations through the C API: median {ms:.1f} ms an iteration "
          f"(max {1e3 * max(iters):.1f}); {drops} trees dropped in all, "
          f"K3 {counts['K3']} launches, {drop_k3} of them counted in "
          f"the drops and their normalisation; per iteration "
          f"K1 {counts['K1'] / n_it:.1f}, K2 {counts['K2'] / n_it:.1f}; "
          f"profile of 1 iteration: wall {wall:.1f} ms, device busy "
          f"{busy:.2f} ms ({100 * busy / wall:.1f}%); the next "
          f"{LRB_NEXT_ROWS} rows through PredictForMat ({dart_k4} K4 "
          f"launches) bit-equal to the plain forest and within "
          f"{err_host:.2g} of the float64 host walk on the rescaled trees")
    out["dart"] = {"ms_per_iteration": ms, "busy": busy / wall,
                   "drops": drops, "k3_launches": counts["K3"],
                   "k3_drop_launches": drop_k3, "k4_launches": dart_k4,
                   "k4": k4, "host_err": err_host}
    capi.LGBM_BoosterFree(bst)
    walls["b"] = time.perf_counter() - t0

    # (d) forced splits at the LRB window (phase 6's rows)
    t0 = time.perf_counter()
    med = {f: float(np.median(X[:, f])) for f in (0, HISTFEATURES,
                                                   HISTFEATURES + 1)}
    spec = {"feature": HISTFEATURES, "threshold": med[HISTFEATURES],
            "left": {"feature": 0, "threshold": med[0],
                     # the cost column is constant: skipped, as unused
                     "left": {"feature": HISTFEATURES + 2,
                              "threshold": 1.0}},
            "right": {"feature": HISTFEATURES + 1,
                      "threshold": med[HISTFEATURES + 1]}}
    path = os.path.join(tmp, "forced.json")
    with open(path, "w") as fh:
        json.dump(spec, fh)
    params = {**TRAIN_PARAMS, "num_iterations": str(FORCED_ITERS),
              "forcedsplits_filename": path}
    ds = lgt.Dataset(X, label=y, params=params).construct()
    bst, train_s, counts = _train_timed(params, ds, FORCED_ITERS)
    g = bst._gbdt
    bst.model_to_string()
    want = [HISTFEATURES, 0, HISTFEATURES + 1]
    assert len(g._grower_cfg.forced) == 3, g._grower_cfg.forced
    for t in g.models:
        assert t.split_feature[:3] == want, t.split_feature[:3]
    wall, busy = device_busy(bst.update, 1)
    ms = 1e3 * train_s / FORCED_ITERS
    # the forced prefix's K2 launches: this run's less those of the same
    # rows and parameters without forced splits (the root passes)
    free = {k: v for k, v in params.items() if k != "forcedsplits_filename"}
    _, free_s, free_counts = _train_timed(free, ds, FORCED_ITERS)
    forced_k2 = counts["K2"] - free_counts["K2"]
    assert free_counts["K2"] == FORCED_ITERS, free_counts
    assert forced_k2 == 3 * FORCED_ITERS, (counts, free_counts)
    print(f"lrb forced splits ({smi}): {FORCED_ITERS} iterations, every "
          f"tree's first three splits the forced ones (features {want} at "
          f"their medians; the node on the constant column skipped): "
          f"{ms:.1f} ms an iteration ({1e3 * free_s / FORCED_ITERS:.1f} "
          f"without them); K2 {counts['K2']} launches, "
          f"{free_counts['K2']} without forced splits, so {forced_k2} "
          f"forced; K1 "
          f"{counts['K1'] / FORCED_ITERS:.1f} an iteration; profile of 1 "
          f"iteration: wall {wall:.1f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%)")
    out["forced"] = {"ms_per_iteration": ms, "busy": busy / wall,
                     "k2_launches": counts["K2"],
                     "k2_forced_launches": forced_k2,
                     "ms_per_iteration_unforced": 1e3 * free_s / FORCED_ITERS}
    del ds, bst, g
    walls["d"] = time.perf_counter() - t0

    # (e) continued training at the LRB window
    t0 = time.perf_counter()
    params = {**TRAIN_PARAMS, "num_iterations": str(CONTIN_ITERS)}
    first = lgt.train(params, lgt.Dataset(X, label=y), verbose_eval=False)
    path = os.path.join(tmp, "first.txt")
    first.save_model(path)
    first_text = first.model_to_string()
    stamps = []

    def stamp(env):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    bst, train_s, counts = _train_timed(params, lgt.Dataset(X, label=y),
                                        CONTIN_ITERS, init_model=path,
                                        callbacks=[stamp])
    g = bst._gbdt
    loaded = lgt.Booster(model_file=path)
    raw = np.asarray(loaded.predict(X, raw_score=True))
    start = g._initial_scores(g.train_data)[0].cpu()
    assert torch.equal(start, torch.from_numpy(raw.astype(np.float32))), \
        "continued: first scores != the loaded model's, folded into f32"
    cont_text = bst.model_to_string()
    assert bst.num_trees() == CONTIN_ITERS == len(stamps)
    # an iteration: between two callbacks; train()'s wall also bins the
    # rows and folds the init model's scores (a predict of every row)
    ms = 1e3 * float(np.median(np.diff(stamps)))
    wall, busy = device_busy(bst.update, 1)
    h1 = capi.LGBM_BoosterLoadModelFromString(first_text)
    h2 = capi.LGBM_BoosterLoadModelFromString(cont_text)
    raw_of = {k: np.asarray(capi.LGBM_BoosterPredictForMat(
        hh, Xn, predict_type=capi.C_API_PREDICT_RAW_SCORE))
        for k, hh in (("first", h1), ("continued", h2))}
    capi.LGBM_BoosterMerge(h1, h2)
    merged = np.asarray(capi.LGBM_BoosterPredictForMat(
        h1, Xn, predict_type=capi.C_API_PREDICT_RAW_SCORE))
    merge_err = float(np.abs(merged - raw_of["first"]
                             - raw_of["continued"]).max())
    assert merge_err <= 1e-5, f"merged predictions: {merge_err}"
    # ResetTrainingData on the next window: the merged trees replayed
    # into its scores, then training goes on
    Xw = make_lrb_rows(LRB_TRAIN_ROWS, seed=25)
    yw = lrb_labels(Xw, seed=26)
    hw_ = capi.LGBM_DatasetCreateFromMat(Xw, parameters=TRAIN_PARAMS)
    capi.LGBM_DatasetSetField(hw_, "label", yw)
    capi.LGBM_BoosterResetParameter(h1, TRAIN_PARAMS)
    reset_counts()
    t1 = time.perf_counter()
    capi.LGBM_BoosterResetTrainingData(h1, hw_)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t1
    # the trees' thresholds map to the new window's own bins, so its
    # replayed scores are the model's up to the rows between a threshold
    # and its new bin's bound (as in the JAX package; the CPU tests hold
    # the replay to it): the loss must fall as training goes on
    replay = capi.LGBM_BoosterGetPredict(h1, 0)
    assert replay.shape == (LRB_TRAIN_ROWS,) and np.isfinite(replay).all()
    loss0 = dict(capi.LGBM_BoosterGetEval(h1, 0))["binary_logloss"]
    t1 = time.perf_counter()
    for _ in range(RESET_ITERS):
        capi.LGBM_BoosterUpdateOneIter(h1)
    torch.cuda.synchronize()
    reset_ms = 1e3 * (time.perf_counter() - t1) / RESET_ITERS
    rcounts = read_counts()
    loss1 = dict(capi.LGBM_BoosterGetEval(h1, 0))["binary_logloss"]
    assert loss1 < loss0, (loss0, loss1)
    total = 2 * CONTIN_ITERS + RESET_ITERS
    assert capi.LGBM_BoosterGetCurrentIteration(h1) == total
    assert capi.LGBM_BoosterNumberOfTotalModel(h1) == total
    assert rcounts["K3"] == 2 * CONTIN_ITERS + RESET_ITERS, rcounts
    print(f"lrb continued ({smi}): {CONTIN_ITERS} iterations, saved, then "
          f"{CONTIN_ITERS} more with train(init_model=path) in "
          f"{train_s:.2f} s (binning and the init model's scores "
          f"included), {ms:.1f} ms an iteration (median between "
          f"callbacks); profile of 1 iteration: wall "
          f"{wall:.1f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%); K1 {counts['K1'] / CONTIN_ITERS:.1f}"
          f", K2 {counts['K2'] / CONTIN_ITERS:.1f}, K3 "
          f"{counts['K3'] / CONTIN_ITERS:.1f} an iteration; the first "
          f"scores equal the loaded model's predictions folded into f32; "
          f"LGBM_BoosterMerge's predictions within {merge_err:.2g} of the "
          f"sum of both; ResetTrainingData on the next window replayed "
          f"{2 * CONTIN_ITERS} trees in {reset_s:.2f} s "
          f"({2 * CONTIN_ITERS} K3 launches), then {RESET_ITERS} "
          f"iterations at {reset_ms:.1f} ms, train binary_logloss "
          f"{loss0:.5f} -> {loss1:.5f}")
    out["continued"] = {"ms_per_iteration": ms, "train_s": train_s,
                        "busy": busy / wall,
                        "merge_err": merge_err, "reset_s": reset_s,
                        "reset_logloss": [loss0, loss1],
                        "reset_ms_per_iteration": reset_ms}
    capi.LGBM_BoosterFree(h1)
    capi.LGBM_BoosterFree(h2)
    del X, y, Xn, Xw, yw, bst, g, first, loaded
    walls["e"] = time.perf_counter() - t0

    # (c) RF at Covertype's shape
    t0 = time.perf_counter()
    X, y = make_covertype_like(COVERTYPE_ROWS, seed=61)
    Xt, yt = X[COVERTYPE_TRAIN:], y[COVERTYPE_TRAIN:]
    X, y = X[:COVERTYPE_TRAIN], y[:COVERTYPE_TRAIN]
    K = COVERTYPE_CLASSES
    ds = lgt.Dataset(X, label=y, params=RF_PARAMS).construct()
    bst, train_s, counts = _train_timed(RF_PARAMS, ds, RF_ITERS)
    g = bst._gbdt
    assert len(g.models) == K * RF_ITERS and g.average_output
    assert "\naverage_output\n" in bst.model_to_string()
    forest_ops.launches.reset()
    sp.fallbacks.reset()
    prob = bst.predict(Xt)
    torch.cuda.synchronize()
    rf_k4 = forest_ops.launches.value
    assert rf_k4 > 0 and sp.fallbacks.value == 0
    assert prob.shape == (len(yt), K) and np.isfinite(prob).all()
    row_sum = float(np.abs(prob.sum(axis=1) - 1.0).max())
    assert row_sum <= 1e-6, f"rf: class probabilities sum {row_sum}"

    def averaged_softmax(raw):
        avg = np.ascontiguousarray((raw / RF_ITERS).T)
        return g.objective.convert_output(torch.from_numpy(avg)).numpy().T
    k4 = check_forest("covertype rf", bst, Xt, prob, dev,
                      convert=averaged_softmax, alternatives=False)
    acc = float((prob.argmax(axis=1) == yt).mean())
    ms = 1e3 * train_s / RF_ITERS
    wall, busy = device_busy(bst.update, 1)
    print(f"covertype rf ({smi}): {COVERTYPE_TRAIN} x 54 rows, {K} classes,"
          f" {RF_ITERS} iterations of {K} trees, bagging 0.632 every "
          f"iteration: {ms:.1f} ms an iteration; profile of 1 iteration: "
          f"wall {wall:.1f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%); per iteration K1 "
          f"{counts['K1'] / RF_ITERS:.1f}, K2 {counts['K2'] / RF_ITERS:.1f},"
          f" K3 {counts['K3'] / RF_ITERS:.1f}; holdout [{len(yt)}, {K}] "
          f"through K4 ({rf_k4} launches) with average_output, bit-equal "
          f"to plain, rows summing to 1 within {row_sum:.2g}, accuracy "
          f"{acc:.4f}")
    out["rf"] = {"ms_per_iteration": ms, "busy": busy / wall,
                 "k4_launches": rf_k4, "k4": k4, "accuracy": acc,
                 "launches_per_iteration": {
                     k: counts[k] / RF_ITERS for k in ("K1", "K2", "K3")}}
    del X, y, Xt, yt, ds, bst, g
    walls["c"] = time.perf_counter() - t0

    # (f) card against CPU at small sizes
    t0 = time.perf_counter()
    Xs = make_lrb_rows(VAR_CPU_ROWS, seed=81)
    ys = lrb_labels(Xs, seed=82)
    Xc, yc = make_covertype_like(VAR_CPU_ROWS, seed=83)
    small = {**TRAIN_PARAMS, "num_leaves": "31", "bagging_freq": "0",
             "feature_fraction": "1.0"}
    del small["num_iterations"]
    init_text = lgt.train(small, lgt.Dataset(Xs, label=ys), VAR_CPU_ITERS,
                          verbose_eval=False, device="cpu").model_to_string()
    path = os.path.join(tmp, "forced_small.json")
    with open(path, "w") as fh:
        json.dump(spec, fh)
    dart = {**small, "boosting": "dart", "drop_rate": "0.5",
            "skip_drop": "0.0"}
    cases = [
        ("goss", Xs, ys, {**small, "boosting": "goss",
                          "learning_rate": "0.5"}, None),
        ("dart", Xs, ys, dart, None),
        ("dart uniform", Xs, ys, {**dart, "uniform_drop": "true"}, None),
        ("dart xgboost", Xs, ys, {**dart, "xgboost_dart_mode": "true"},
         None),
        ("dart uniform xgboost", Xs, ys, {**dart, "uniform_drop": "true",
                                          "xgboost_dart_mode": "true"},
         None),
        ("rf binary", Xs, ys, {**small, "boosting": "rf",
                               "bagging_freq": "1",
                               "bagging_fraction": "0.632"}, None),
        ("rf multiclass", Xc, yc, {**RF_PARAMS, "num_leaves": 31}, None),
        ("forced", Xs, ys, {**small, "forcedsplits_filename": path}, None),
        ("continued", Xs, ys, small, init_text)]
    out["card_vs_cpu"] = {}
    for name, Xa, ya, params, init in cases:
        runs = card_and_cpu(params, Xa, ya, VAR_CPU_ITERS, init_model=init)
        metric = next(iter(runs["cuda"][1]))
        _, where = judge_trees(runs, metric=metric, tol=OBJ_METRIC_TOL)
        print(f"{name} card vs CPU, {Xa.shape[0]} x {Xa.shape[1]} rows x "
              f"{VAR_CPU_ITERS} iterations of 31 leaves: {where}; train "
              f"{metric} {runs['cuda'][1][metric]:.6g} vs "
              f"{runs['cpu'][1][metric]:.6g}; {runs['cuda'][2]:.1f} s on "
              f"the card, {runs['cpu'][2]:.1f} s on the CPU")
        out["card_vs_cpu"][name] = where
    walls["f"] = time.perf_counter() - t0
    total = time.perf_counter() - t_phase
    print("phase 23 walls: " + ", ".join(f"({k}) {v:.1f} s"
                                        for k, v in sorted(walls.items()))
          + f"; in all {total:.1f} s (budget {PHASE23_BUDGET_S:.0f} s)")
    assert total <= PHASE23_BUDGET_S, f"phase 23 took {total:.1f} s"
    out["walls"] = walls
    return out


def write_int_tsv(path: str, y: np.ndarray, X: np.ndarray,
                  chunk: int = 200_000) -> None:
    """Rows of non-negative integers, the label first, tab-separated, the
    digits made by numpy in bulk (``np.savetxt`` formats each value in
    Python): per value a field of the widest value's digits and a tab or
    newline, the leading zeros dropped by one mask."""
    M = np.column_stack([y, X])
    assert (M >= 0).all() and np.array_equal(M, np.round(M)), "integers"
    width = len(str(int(M.max())))
    pos = np.arange(width + 1)
    with open(path, "wb") as fh:
        for r0 in range(0, M.shape[0], chunk):
            v = M[r0:r0 + chunk].astype(np.int64)
            n, c = v.shape
            buf = np.empty((n, c, width + 1), np.uint8)
            ndig = np.ones((n, c), np.int64)
            for k in range(1, width):
                ndig += v >= 10 ** k
            rest = v.copy()
            for k in range(width - 1, -1, -1):
                buf[:, :, k] = 48 + rest % 10
                rest //= 10
            buf[:, :, width] = ord("\t")
            buf[:, -1, width] = ord("\n")
            keep = pos[None, None, :] >= (width - ndig)[:, :, None]
            fh.write(buf[keep].tobytes())


def refit_bound(leaf, g, h, plain_out, l1: float, l2: float, shrink: float,
                decay: float) -> np.ndarray:
    """Per leaf, a bound on |card - plain| of a refit tree's outputs on the
    same leaf ids, g and h: the two f32 sums of each leaf differ by at most
    ``ops/refit.py sum_bound`` (two orders of addition), which moves
    ``-sum_g / (sum_h + l2)`` by at most (dg + |q| dh) / (den - dh) (l1's
    threshold moves sum_g by no more); times shrink and (1 - decay), plus
    4 ulps of the output for the roundings after the sums."""
    from lightgbm_tpu_torch.ops.refit import sum_bound
    L = plain_out.shape[0]
    n = np.bincount(leaf, minlength=L)[:L]
    ag = np.bincount(leaf, np.abs(g.astype(np.float64)), minlength=L)[:L]
    sh = np.bincount(leaf, h.astype(np.float64), minlength=L)[:L]
    sg = np.bincount(leaf, g.astype(np.float64), minlength=L)[:L]
    dg, dh = sum_bound(n, ag), sum_bound(n, sh)
    den = sh + l2
    q = np.abs(np.sign(sg) * np.maximum(np.abs(sg) - l1, 0.0)) / np.maximum(
        den, 1e-300)
    dq = (dg + q * dh) / np.maximum(den - dh, 1e-300)
    return ((1.0 - decay) * shrink * dq
            + 4.0 * np.abs(plain_out.astype(np.float64)) * 2.0 ** -23)


def _tree_lines(text: str, keys) -> list:
    """Per tree, its lines starting with ``keys``."""
    return [[ln for ln in b.splitlines() if ln.split("=")[0] in keys]
            for b in tree_blocks(text)]


def file_phases(dev, smi: str, lrb: dict, tmp: str) -> dict:
    """Phase 24 of the module docstring: the file entry point on phase 6's
    window. Returns the kernels' launches of each part."""
    import types
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import application, capi
    from lightgbm_tpu_torch.obs import registry
    from lightgbm_tpu_torch.ops import refit as refit_ops
    from lightgbm_tpu_torch.utils import timing
    out, walls = {}, {}
    t_phase = time.perf_counter()
    X = make_lrb_rows(LRB_TRAIN_ROWS, seed=21)
    y = lrb_labels(X, seed=22)
    Xn = make_lrb_rows(LRB_NEXT_ROWS, seed=23)
    yn = lrb_labels(Xn, seed=24)
    train_path = os.path.join(tmp, "lrb_window.tsv")
    next_path = os.path.join(tmp, "lrb_next.tsv")
    t0 = time.perf_counter()
    write_int_tsv(train_path, y, X)
    write_int_tsv(next_path, yn, Xn)
    write_s = time.perf_counter() - t0
    assert write_s <= WRITE_LIMIT_S, f"writing the files took {write_s:.1f} s"
    conf = os.path.join(tmp, "train.conf")
    with open(conf, "w") as fh:
        fh.write("task = train\ndata = lrb_window.tsv\n"
                 + "".join(f"{k} = {v}\n" for k, v in TRAIN_PARAMS.items()))
    model_a = os.path.join(tmp, "model_a.txt")
    phases = {}
    log_report = timing.log_report

    def keep_phases(header="phase timings"):
        phases.update({n: (tot, cnt) for n, tot, cnt, _ in
                       registry.default_registry().timer_items()})
        log_report(header)

    timing.log_report = keep_phases
    try:
        # (a) train from the text file
        t0 = time.perf_counter()
        timing.reset()
        reset_counts()
        application.main([f"config={conf}", f"output_model={model_a}"])
        out["a"] = read_counts()
        walls["a"] = time.perf_counter() - t0
        text_a = open(model_a).read()
        assert _body(text_a) == _body(lrb["text"]), \
            "file training: model text differs from phase 6's"
        for k in ("K1", "K2", "K3"):
            assert out["a"][k] > 0, out["a"]
        it_s, n_it = phases["train/iteration"]
        print(f"file train: {LRB_TRAIN_ROWS} x {LRB_FEATURES} integer TSV "
              f"({os.path.getsize(train_path) / 1e6:.1f} MB, written untimed "
              f"in {write_s:.1f} s) through `python -m lightgbm_tpu_torch "
              f"config=...`: parse {phases['io/parse'][0]:.2f} s, binning "
              f"{phases['binning/find_bins'][0]:.2f} + "
              f"{phases['binning/bin_matrix'][0]:.2f} s, "
              f"{1e3 * it_s / n_it:.1f} ms an iteration ({n_it}), eval "
              f"{1e3 * phases['train/eval'][0] / n_it:.1f} ms an iteration; "
              f"model text equal to phase 6's; launches {out['a']}; "
              f"{walls['a']:.1f} s; {smi}")

        # (b) predict from the text file: the task and the C API
        t0 = time.perf_counter()
        res_task = os.path.join(tmp, "pred_task.txt")
        res_capi = os.path.join(tmp, "pred_capi.txt")
        reset_counts()
        application.main(["task=predict", f"data={next_path}",
                          f"input_model={model_a}",
                          f"output_result={res_task}", "verbose=-1"])
        h = capi.LGBM_BoosterCreateFromModelfile(model_a)
        capi.LGBM_BoosterPredictForFile(h, next_path,
                                        result_filename=res_capi)
        out["b"] = read_counts()
        walls["b"] = time.perf_counter() - t0
        want = [f"{v:g}" for v in lrb["pred"]]
        for path in (res_task, res_capi):
            assert open(path).read().splitlines() == want, \
                f"{os.path.basename(path)}: lines differ from phase 6's"
        assert out["b"]["K4"] >= 2, out["b"]
        print(f"file predict: {LRB_NEXT_ROWS} rows, task=predict and "
              f"LGBM_BoosterPredictForFile: both result files equal line "
              f"for line to phase 6's PredictForMat answers; launches "
              f"{out['b']}; {walls['b']:.1f} s")

        # (c) refit on the next window's file, three routes
        t0 = time.perf_counter()
        refit_task = os.path.join(tmp, "refit_task.txt")
        reset_counts()
        application.main([f"config={conf}", "task=refit",
                          f"data={next_path}", f"input_model={model_a}",
                          f"output_model={refit_task}"])
        out["c_task"] = read_counts()
        ds = capi.LGBM_DatasetCreateFromFile(next_path, TRAIN_PARAMS)
        hr = capi.LGBM_BoosterCreateFromModelfile(model_a)
        capi.LGBM_BoosterResetTrainingData(hr, ds)
        reset_counts()
        t1 = time.perf_counter()
        capi.LGBM_BoosterRefit(hr)
        torch.cuda.synchronize()
        refit_s = time.perf_counter() - t1
        out["c"] = read_counts()
        assert out["c"]["K3"] == len(hr.gbdt.models) == 50, out["c"]
        text_capi = capi.LGBM_BoosterSaveModelToString(hr)
        bst_a = lgt.Booster(params=TRAIN_PARAMS, model_file=model_a)
        seen = []
        refit_fn = refit_ops.refit_leaf_outputs

        def spy(*args):
            o = refit_fn(*args)
            seen.append(([t.cpu() for t in args[:4]], args[4:], o.cpu()))
            return o

        refit_ops.refit_leaf_outputs = spy
        try:
            r1 = bst_a.refit(Xn, yn).model_to_string()
        finally:
            refit_ops.refit_leaf_outputs = refit_fn
        r2 = bst_a.refit(Xn, yn).model_to_string()
        text_task = open(refit_task).read()
        assert _body(text_task) == _body(text_capi) == _body(r1), \
            "refit: task, C API and Booster.refit differ"
        assert r1 == r2, "refit: a second run on the card differs"
        shape = ("split_feature", "left_child", "right_child")
        assert _tree_lines(r1, shape) == _tree_lines(text_a, shape), \
            "refit changed a tree's structure"
        vals = ("leaf_value",)
        assert _tree_lines(r1, vals) != _tree_lines(text_a, vals)
        same = bst_a.refit(Xn, yn, decay_rate=1.0).model_to_string()
        assert _tree_lines(same, vals) == _tree_lines(text_a, vals), \
            "refit_decay_rate=1.0 changed a leaf value"
        worst, slack = 0.0, np.inf
        for (ids, g, hs, old), args, card in seen:
            plain = refit_fn(ids, g, hs, old, *args)
            l1, l2, _, shrink, decay = args
            b = refit_bound(ids.numpy(), g.numpy(), hs.numpy(),
                            plain.numpy(), l1, l2, shrink, decay)
            d = np.abs(card.numpy().astype(np.float64)
                       - plain.numpy().astype(np.float64))
            assert (d <= b).all(), f"refit: card beyond its bound {d.max()}"
            worst = max(worst, float(d.max()))
            slack = min(slack, float((b - d).min()))
        walls["c"] = time.perf_counter() - t0
        print(f"refit: task=refit, LGBM_BoosterRefit after "
              f"ResetTrainingData and Booster.refit on {LRB_NEXT_ROWS} rows "
              f"give equal models, the same bits on a second run, the trees' "
              f"structure of (a), decay 1.0 (a)'s leaf values; each tree's "
              f"outputs on the card within the f32 bound of the plain sums "
              f"on the CPU on its leaf ids, g and h (worst {worst:.3g}, "
              f"least slack {slack:.3g}); LGBM_BoosterRefit "
              f"{1e3 * refit_s:.1f} ms, launches {out['c']} (task=refit "
              f"{out['c_task']}, its replay of 50 trees included); "
              f"{walls['c']:.1f} s")

        # (d) SHAP contributions
        t0 = time.perf_counter()
        Xs = Xn[:SHAP_ROWS]
        bst = lgt.Booster(model_file=model_a)
        contrib = bst.predict(Xs, pred_contrib=True)
        c_api = capi.LGBM_BoosterPredictForMat(
            h, Xs, predict_type=capi.C_API_PREDICT_CONTRIB)
        assert contrib.shape == (SHAP_ROWS, LRB_FEATURES + 1)
        assert np.array_equal(contrib, c_api), "SHAP: predict != C API"
        host = host_raw(bst._gbdt, Xs)[0]
        reset_counts()
        raw = bst.predict(Xs, raw_score=True)
        out["d"] = read_counts()
        e_host = float(np.abs(contrib.sum(1) - host).max())
        e_k4 = float(np.abs(contrib.sum(1) - raw).max())
        assert e_host <= 1e-9 and e_k4 <= 1e-5, (e_host, e_k4)
        walls["d"] = time.perf_counter() - t0
        print(f"shap: {SHAP_ROWS} rows x {LRB_FEATURES + 1}, "
              f"predict(pred_contrib=True) == C_API_PREDICT_CONTRIB; rows "
              f"sum to the float64 host walk within {e_host:.3g}, to K4's "
              f"raw scores within {e_k4:.3g}; {walls['d']:.1f} s")

        # (e) the binary dataset
        t0 = time.perf_counter()
        bin_path = os.path.join(tmp, "lrb_window.bin")
        lgt.Dataset(train_path, params=TRAIN_PARAMS).save_binary(bin_path)
        save_s = time.perf_counter() - t0
        model_e = os.path.join(tmp, "model_e.txt")
        phases.clear()
        reset_counts()
        application.main([f"config={conf}", f"data={bin_path}",
                          f"output_model={model_e}"])
        out["e"] = read_counts()
        walls["e"] = time.perf_counter() - t0
        assert _body(open(model_e).read()) == _body(text_a), \
            "training from the .bin: model text differs from (a)'s"
        print(f"binary dataset: Dataset(path).save_binary "
              f"{os.path.getsize(bin_path) / 1e6:.1f} MB in {save_s:.2f} s "
              f"(parse and binning again); loaded in "
              f"{phases['io/load_binary'][0]:.3f} s; the model text equal "
              f"to (a)'s; launches {out['e']}; {walls['e']:.1f} s")
    finally:
        timing.log_report = log_report

    # (f) leaf edits and shuffles, K4 on the current tables (the
    # launches of the checks against plain are not counted)
    t0 = time.perf_counter()
    tree, leaf = LEAF_EDIT
    before = capi.LGBM_BoosterGetLeafValue(h, tree, leaf)
    value = before + 0.25
    capi.LGBM_BoosterSetLeafValue(h, tree, leaf, value)
    assert capi.LGBM_BoosterGetLeafValue(h, tree, leaf) == value
    handle = types.SimpleNamespace(_gbdt=h.gbdt)
    reset_counts()
    p_edit = np.asarray(capi.LGBM_BoosterPredictForMat(h, Xn))
    k4 = read_counts()["K4"]
    assert not np.array_equal(p_edit, lrb["pred"]), "edit not served"
    k4_edit = check_forest("leaf edit", handle, Xn, p_edit, dev,
                           alternatives=False)
    raw_edit = host_raw(h.gbdt, Xn)[0]
    capi.LGBM_BoosterShuffleModels(h, 0, -1)
    reset_counts()
    p_shuf = np.asarray(capi.LGBM_BoosterPredictForMat(h, Xn))
    k4 += read_counts()["K4"]
    out["f"] = {"K4": k4}
    assert k4 >= 2, k4
    check_forest("shuffled", handle, Xn, p_shuf, dev, alternatives=False)
    errs = [float(np.abs(p - 1.0 / (1.0 + np.exp(-raw))).max())
            for p, raw in ((p_edit, raw_edit),
                           (p_shuf, host_raw(h.gbdt, Xn)[0]))]
    assert max(errs) <= 1e-5, errs
    dump = json.loads(json.dumps(capi.LGBM_BoosterDumpModel(h)))
    assert len(dump["tree_info"]) == 50, len(dump["tree_info"])
    walls["f"] = time.perf_counter() - t0
    print(f"leaf edits: SetLeafValue(tree {tree}, leaf {leaf}) "
          f"{before:.6g} -> {value:.6g}, read back; then ShuffleModels: "
          f"K4 bit-equal to plain on all {LRB_NEXT_ROWS} rows each time, "
          f"within {max(errs):.3g} of the float64 host walk of the edited "
          f"trees; DumpModel parses as JSON with 50 trees; launches "
          f"{out['f']}; {walls['f']:.1f} s")
    total = time.perf_counter() - t_phase - write_s
    print("phase 24 walls: " + ", ".join(f"({k}) {v:.1f} s"
                                        for k, v in sorted(walls.items()))
          + f"; in all {total:.1f} s without the untimed writes (budget "
          f"{PHASE24_BUDGET_S:.0f} s); {smi}")
    assert total <= PHASE24_BUDGET_S, f"phase 24 took {total:.1f} s"
    out["k4_edit"] = {k: k4_edit[k] for k in ("rows", "ms", "plain_ms",
                                              "bound_ms", "bound_by",
                                              "max_abs_err")}
    out["walls"] = walls
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    if not os.path.isdir(os.path.join(ROOT, "lightgbm_tpu_torch")):
        print("chip_smoke: lightgbm_tpu_torch is not beside this script",
              file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    from lightgbm_tpu_torch import Booster, capi
    from lightgbm_tpu_torch.ops import forest as forest_ops
    from lightgbm_tpu_torch.ops import stacked_predict as sp
    from lightgbm_tpu_torch.testing import random_model_text
    from lightgbm_tpu_torch.utils import cuda_build

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    power_limit_w = float(smi.split(",")[-1].strip().split()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")

    # 2. build: every csrc/*.cu (nvcc) and the text parser (g++), one
    # compiler each, all at once
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    print(f"build: {len(built)} sources in {time.perf_counter() - t0:.2f} s")
    for name, b in built.items():
        cc = "g++" if name in cuda_build.HOST_SOURCES else "nvcc"
        print(f"  {name}: {cc} {b.seconds:.2f} s -> "
              f"{os.path.relpath(b.path, ROOT)}")
        for line in b.report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")

    # 3. golden corpus: host binning, then device binning
    worst = 0.0
    for name in GOLDEN_CASES + REVERSE_ONLY:
        src = "proxy" if name in REVERSE_ONLY else name
        X = np.fromfile(os.path.join(GOLDEN, f"g2_{src}_X.bin"),
                        np.float64).reshape(600, 8)
        pairs = [(f"g2_{name}_ours_model.txt",
                  f"g2_{name}_ours_refpred.bin")]
        if name in GOLDEN_CASES:
            pairs.append((f"g2_{name}_model.txt", f"g2_{name}_pred.bin"))
        for model, pred in pairs:
            bst = Booster(model_file=os.path.join(GOLDEN, model))
            ref = np.fromfile(os.path.join(GOLDEN, pred), np.float64)
            got = np.asarray(bst.predict(X)).reshape(-1)
            err = float(np.abs(got - ref).max())
            worst = max(worst, err)
            assert err <= 1e-5, f"{model}: {err} from the reference"
            sm = bst._gbdt._stacked_model()
            assert sm is not None, f"{model}: not stacked"
            if sm.edges is None:
                continue
            X32 = X.astype(np.float32)
            codes = sp.codes_from_x(torch.from_numpy(X32).to(dev),
                                    *sm.edges).cpu().numpy()
            want = sm._bin_rows(X32.astype(np.float64)).T
            assert np.array_equal(codes, want), f"{model}: device codes"
            raw = np.asarray(bst.predict(X32, raw_score=True))
            host = host_raw(bst._gbdt, X32.astype(np.float64))
            err32 = float(np.abs(raw.reshape(-1)
                                 - (host[0] if host.shape[0] == 1
                                    else host.T).reshape(-1)).max())
            assert err32 <= 1e-5, f"{model} f32: {err32} from host walk"
    torch.cuda.synchronize()
    print(f"golden: {len(GOLDEN_CASES) * 2 + len(REVERSE_ONLY)} models "
          f"within 1e-5 of the reference (worst {worst:.3g})")

    # 4. full width: HIGGS-shape model, 500k rows
    X, _ = make_higgs_like(HOLDOUT_ROWS)
    text = random_model_text(X[:100_000], HIGGS_TREES, HIGGS_LEAVES, 11)
    t0 = time.perf_counter()
    bst = Booster(model_str=text)
    sm = bst._gbdt._stacked_model()
    assert sm is not None and sm.edges is not None
    compact = sum(t.numel() * t.element_size() for t in sm.forest.walk[:6])
    print(f"higgs model: {HIGGS_TREES} trees x {HIGGS_LEAVES} leaves, "
          f"loaded and stacked in {time.perf_counter() - t0:.2f} s; "
          f"decision rows {sm.forest.dec.numel() / 1e6:.1f} MB on the "
          f"host, compact tables {compact / 1e6:.2f} MB on the device")
    torch.cuda.synchronize()
    forest_ops.launches.reset()
    sp.fallbacks.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prob = bst.predict(X)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = forest_ops.launches.value
    fallbacks = sp.fallbacks.value
    assert launches > 0 and fallbacks == 0, (launches, fallbacks)
    assert prob.shape == (HOLDOUT_ROWS,) and np.isfinite(prob).all()
    print(f"higgs predict: {HOLDOUT_ROWS} rows in {e2e:.3f} s end to end "
          f"({HOLDOUT_ROWS / e2e:.0f} rows/s), {launches} launches, "
          f"peak device memory {peak_gb:.3f} GB")

    # every row of the main path's launches: the kernel and its plain
    # version on the same device codes, chunk by chunk as predict cuts
    # them, scores and leaves; the main path's probabilities from the
    # plain scores; the kernel's time at the main path's chunk shape
    higgs = check_forest("higgs", bst, X, prob, dev)
    max_abs_err = higgs["max_abs_err"]
    # the float64 host walk on a subset
    fc = sm.forest
    T = HIGGS_TREES
    codes = sp.codes_from_x(torch.from_numpy(X[:SUBSET]).to(dev), *sm.edges)
    k_sub = forest_ops.forest_predict(codes, fc, 0, T).cpu().numpy()
    host = host_raw(bst._gbdt, X[:SUBSET].astype(np.float64))[0]
    err_host = float(np.abs(k_sub[:, 0] - host).max())
    assert err_host <= 1e-4, f"kernel vs host walk {err_host}"
    print(f"higgs host walk: {err_host:.3g} from the float64 host walk on "
          f"{SUBSET} rows")
    walls = wall_ms(lambda: bst.predict(X), 5)
    print(f"higgs predict, 5 more calls: median {np.median(walls):.1f} ms, "
          f"min {min(walls):.1f}, max {max(walls):.1f}")
    wall, busy = device_busy(lambda: bst.predict(X), 3)
    print(f"higgs predict profile, one window of 3 calls: wall {wall:.1f} "
          f"ms, device busy {busy:.2f} ms ({100 * busy / wall:.1f}%); "
          f"host f64 check and f32 cast, timed alone: "
          f"{host_prep_ms(X):.1f} ms")

    # 5. serving: LRB window model through the C API
    Xl = make_lrb_rows(70_000)
    ltext = random_model_text(Xl, LRB_TREES, LRB_LEAVES, 5)
    handle = capi.LGBM_BoosterLoadModelFromString(ltext)
    t0 = time.perf_counter()
    handle.gbdt._stacked_model()
    stack_ms = (time.perf_counter() - t0) * 1e3
    plain = Booster(model_str=ltext, device="cpu")
    torch.cuda.synchronize()
    forest_ops.launches.reset()
    served = []
    for rows in (1, 7, 1000, 65_536):
        Xr = make_lrb_rows(rows, seed=rows)
        t0 = time.perf_counter()
        out = np.asarray(capi.LGBM_BoosterPredictForMat(handle, Xr))
        served.append((rows, (time.perf_counter() - t0) * 1e3))
        assert np.array_equal(out, plain.predict(Xr)), f"lrb {rows} rows"
    torch.cuda.synchronize()
    serve_launches = forest_ops.launches.value
    assert serve_launches > 0 and sp.fallbacks.value == 0
    lsm = handle.gbdt._stacked_model()
    lrb = measure_kernel(handle.gbdt, sp.codes_from_x(
        torch.from_numpy(make_lrb_rows(65_536).astype(np.float32)).to(dev),
        *lsm.edges), dev)
    capi.LGBM_BoosterFree(handle)
    print(f"lrb serving: model stacked in {stack_ms:.1f} ms; "
          + ", ".join(f"{r} rows {t:.2f} ms" for r, t in served)
          + f"; {serve_launches} launches")
    print(kernel_line("lrb", lrb, LRB_TREES))

    # 19 and 20, before 6-18: the LRB loop on the card, then the fleet
    # scoring daemon on its trace and models (torch.profiler's records
    # are still whole this early in the run)
    with tempfile.TemporaryDirectory() as tmp:
        loop = lrb_loop_phase(dev, smi, tmp)
        fleet = fleet_phase(dev, smi, loop, text, X, tmp)

    # 6-9: training on the exact tier; 10-14: the int8 tiers, packed bins;
    # 21: valid sets, against phases 6, 7 and 11
    kid_of = {"wave_histogram": "K2", "fused_partition_histogram": "K1",
              "leaf_gather_add": "K3"}
    train, higgs_data = train_phases(dev)
    quant = quant_phases(dev, higgs_data, power_limit_w)
    valid = valid_phases(dev, smi, higgs_data, {
        kid_of[e["name"]]: e["lrb"] for e in train if e["name"] in (
            "wave_histogram", "fused_partition_histogram")})
    # 15-18: categorical features
    k1_ms = next(e["ms"] for e in train
                 if e["name"] == "fused_partition_histogram")
    cat, airline = cat_phases(dev, k1_ms, power_limit_w)
    # 22: every objective family, card against CPU
    objectives = objective_phases(dev, smi)
    # 23: GOSS (on phase 7's rows), DART, RF, forced splits, continued
    with tempfile.TemporaryDirectory() as tmp:
        variants = variant_phases(dev, smi, higgs_data, tmp)
    # 24: the file entry point on phase 6's window
    with tempfile.TemporaryDirectory() as tmp:
        files = file_phases(dev, smi, higgs_data["lrb"], tmp)
    del higgs_data

    # kernels line
    forest = {
        "name": "forest_predict", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/forest_predict.cu",
        "replaces": "lightgbm_tpu/ops/stacked_predict.py:1048",
        "launches": launches, "max_abs_err": max_abs_err,
        "vs_plain": "bitwise", "library_ms": None,
        "serve_launches": serve_launches}
    keys = ("rows", "ms", "queued_ms", "plain_ms", "bound_ms", "bound_by",
            "bound_ms_jax_layout", "visits", "lanes_busy", "compact_bytes",
            "host_us", "plan", "alternatives")
    forest.update({k: higgs[k] for k in keys})
    for key, r in (("lrb", lrb), ("airline", airline),
                   ("covertype", objectives["covertype"]["k4"])):
        forest[key] = {k: r[k] for k in keys}
    forest["covertype"]["launches"] = objectives["covertype"]["k4_launches"]
    forest["lrb_loop"] = {
        "launches": loop["counts"]["K4"],
        "launches_per_window": loop["k4_per_window"],
        "publish_warmups": loop["publish_warmups"],
        **{k: loop["k4"][k] for k in ("rows", "ms", "queued_ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "max_abs_err")}}
    forest["fleet"] = fleet
    # phase 24: predict task and PredictForFile, SHAP's raw check, leaf
    # edits and shuffles
    forest["file_entry"] = {"predict_from_file_launches": files["b"]["K4"],
                            "shap_raw_launches": files["d"]["K4"],
                            "leaf_edit_launches": files["f"]["K4"],
                            "leaf_edit": files["k4_edit"]}
    # phase 23: the boosting variants' models
    forest["variants"] = {
        "dart_launches": variants["dart"]["k4_launches"],
        "rf_launches": variants["rf"]["k4_launches"],
        "goss_launches": {t: r["k4_launches"]
                          for t, r in variants["goss"].items()},
        **{name: {k: variants[name]["k4"][k] for k in (
            "rows", "ms", "queued_ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err")} for name in ("dart", "rf")}}
    for e in train:
        kid = kid_of[e["name"]]
        e["lrb_loop"] = {
            "launches": loop["counts"][kid if kid == "K3" else f"{kid}/f32"],
            "launches_per_window": loop["per_window"][kid]}
        # phase 21: the same kernels with a valid set's passenger rows
        # phase 22: the multiclass, regression and ranking runs
        e["objectives"] = (
            {"covertype_launches_per_iteration":
             objectives["covertype"]["launches_per_iteration"][kid]}
            if kid != "K3" else
            {"covertype_launches_per_iteration":
             objectives["covertype"]["launches_per_iteration"]["K3"],
             "class_row_3": {k: objectives["covertype"]["k3_row3"][k]
                             for k in ("shape", "ms", "plain_ms",
                                       "library_ms", "bound_ms",
                                       "bound_by", "max_abs_err")}})
        goss = {t: r["launches_per_iteration"][kid]
                for t, r in variants["goss"].items()}
        e["variants"] = (
            {"goss_launches_per_iteration": goss,
             "rf_launches_per_iteration":
             variants["rf"]["launches_per_iteration"][kid],
             **({"forced_launches": variants["forced"]["k2_forced_launches"]}
                if kid == "K2" else {})}
            if kid != "K3" else
            {"goss_launches_per_iteration": goss,
             "dart_drop_normalise_launches":
             variants["dart"]["k3_drop_launches"],
             "dart_launches": variants["dart"]["k3_launches"]})
        # phase 24: CLI training from the text file and from its .bin;
        # K3 also in LGBM_BoosterRefit's score updates
        e["file_entry"] = {"train_from_text_launches": files["a"][kid],
                           "train_from_binary_launches": files["e"][kid],
                           **({"refit_launches": files["c"]["K3"]}
                              if kid == "K3" else {})}
        e["valid_sets"] = (valid[kid] if kid != "K3" else
                           {"higgs_launches_per_tree":
                            valid["higgs"]["k3_per_tree"],
                            "lrb_launches_per_tree":
                            valid["lrb"]["k3_per_tree"],
                            "higgs_launches": valid["higgs"]["k3_launches"],
                            "lrb_launches": valid["lrb"]["k3_launches"]})
    print(json.dumps({"kernels": [forest] + train + quant + cat}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
