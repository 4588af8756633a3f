#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (ultra_torchdrug_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py                # on a machine with the card
    python3 chip_smoke.py --device cpu   # rehearsal of phases 1b-55, small
    python3 chip_smoke.py --only-new     # the build and phases 49-51 alone
    python3 chip_smoke.py --only 46-48   # the build and phases 46-48 alone
    python3 chip_smoke.py --only 52-53   # several cards (a host with four)
    python3 chip_smoke.py --only 54-55   # the build and phases 54-55 alone

Phases, each of which raises on failure (the script then exits nonzero):

  0. build    every kernel source in ultra_torchdrug_tpu_torch/csrc/ with nvcc,
              all at once, and print the build time and ptxas' resource lines;
  1. kernels  hold K1 (the rspmm forward, csrc/rspmm_fwd.cu and
              rspmm_staged.cuh) against its plain PyTorch version in modes
              mul_rel and add_rel, at small and ragged shapes, on hub rows
              (10^3 and 10^4 edges, rows of 256 and 257, F = 10, 100, 1028,
              with and without the segments, bitwise across two calls) and
              with R = 2,000 (rel rows gathered), and at the eval and
              training shapes, and time it; hold K2 (the rspmm backward,
              csrc/rspmm_bwd.cu) against its plain version at small and
              ragged shapes, on the same hub and large-R graphs and at the
              training shape, check that two calls agree bitwise, and time
              it whole and by half; time K1 and K2 (by half) on bench.py's
              heavy-tailed KG (busiest destination row 107,150 edges,
              source row 107,336), hub sums held within K1's or K2's
              tolerance plus 8 fp32 ulps of each entry's absolute mass;
              log each timed shape's slice width and rel branch; hold K6 (the
              fused max+min, both modes, on K1's segments: exactly, bitwise
              across two calls, its planes through K6b within the mass
              tolerance of the plain round trip; also on hub rows of 10^3
              to 10^5 in-edges with 40 duplicated and weight-0 edges, F =
              10, 1028, 2048, and with R = 2,000, rel rows gathered, and
              timed on bench.py's KG) and K7 (the fused moments,
              csrc/rspmm_pna_fwd.cu, on the same segments; on the same hub
              rows and bench.py's KG within 1e-5 plus 8 fp32 ulps of each
              entry's absolute mass of the plain sums taken in fp64,
              bitwise across two calls) and K6b and K7b (their backward,
              csrc/rspmm_pna_bwd.cu, bitwise across two calls and by half)
              against their plain versions at ragged shapes and at F=512
              and F=2048, K6b and K7b also on hub rows (10^3 and 10^4
              edges both ways, 40 duplicated edges; F = 10, 1028) and with
              R = 2,000 (rel rows gathered) within the mass tolerance, and
              time each, K6b and K7b also by half beside each half's bound
              and on bench.py's heavy-tailed KG, with the share of K6b's
              g_mx and g_mn loads in which no feature passes its gate; hold
              K4 (one extremum, max and min, both modes,
              csrc/rspmm_pna_fwd.cu, on K1's segments) exactly, also on
              K6's hub rows and bench.py's KG, bitwise across two calls,
              its output through K5 to the plain gradients within the mass
              tolerance, K5 (its argext backward,
              csrc/rspmm_pna_bwd.cu, on K4's own output) and K3 (the transe
              backward, csrc/rspmm_transe_bwd.cu), both bitwise across two
              calls, against their plain versions at ragged shapes (K3 also
              on its segment and tile layouts: a 700-edge source row, a
              relation across three destination tiles, F = 10, 64, 1028,
              2048; K5, max and min, also on hub rows of 10^3 and 10^4
              edges both ways with 40 duplicated edges, F = 10, 1028, and
              with R = 2,000, within the mass tolerance and by half) and
              at F=2048 (K4 also F=512), time each, K5 also by half beside
              each half's bound and on bench.py's KG, and time K3
              whole and by half beside its function as two torch.sparse.mm
              calls, on the uniform KG and on bench.py's heavy-tailed KG
              (its busiest source row 107,336 edges); hold K8f and K8b (the
              rotate forward and backward, csrc/rspmm_rotate.cu; both
              bitwise across two calls) against their plain versions at
              ragged shapes (D/2 = 3,
              5 and 6 take the scalar path, 4 and 16 the float4 path), both
              also on hub rows of 10^3 to 10^5 edges (D = 32, 128 and 6;
              R = 7 and 2,000; 40 duplicated edges) within the mass
              tolerance, K8b by half, and
              at F=512 and F=2048 with D=32, shared and per-batch
              relations, and time each, K8b also by half, both on
              bench.py's KG; hold K1h and K2h (the bf16 operand
              mode, csrc/rspmm_fwd.cu and csrc/rspmm_bwd.cu, both bitwise
              across two calls) against their plain versions at ragged
              shapes (F not a multiple of 8 takes the scalar path), shared
              and per-batch relations, both also on hub rows of 10^3 to
              10^5 edges (R = 7 and 2,000; 40 duplicated edges) within the
              mass tolerance (K2h by half), and at F=1024 (K1h) and F=4096
              (both), and time each beside K1 and K2 on the same values,
              K2h also by half, both on bench.py's KG;
              hold K9 (the ring shift, csrc/ring_shift.cu) bitwise against
              its plain version at ragged shapes (misaligned blocks and
              byte tails; blocks of whole and of partial CTAs), fp32 and
              bf16, n = 1 to 4, and at the ring's eval and training
              shapes (n = 4, v_block = 3,636, F = 1024 and 4096), and
              time it queued ahead and at the host's pace
              beside its plain version, its library call torch.cat of the
              rotated blocks and torch.roll;
 1b. ladder   hold every variant of the K1 strip-down ladder
              (csrc/rspmm_ladder.cu, ops/rspmm_ladder_cuda.py) against its
              plain version at ragged shapes (F = 10, 64, 1028; empty
              rows; a row of 700 edges, longer than one split segment; eid
              not the identity), full bitwise against K1 on the rows of
              one segment (K1 at full's tolerance on the rest) and packed,
              ftile and nowrite against full; then run
              the ladder tools at their default, full sizes with every
              variant and the shipped K1 beside them, each between a reset
              and a read of the launch counts: P1
              (diagnostics/kernel_floor.py, 524,288 edges into 256 rows)
              and P2 (diagnostics/blocked_ladder.py, bench.py's
              heavy-tailed KG, 557,056 edges, its JSON under output/),
              one [ladder] line per workload and variant; every variant
              and K1 must launch and no other kernel; on the CPU a tiny
              size with the plain versions;
  2. slice    zero-shot evaluation of ULTRA (6x64 towers, seeded weights) on a
              synthetic KG of FB15k-237's size: 64 test triples in batches of
              16, through TransductiveKGTask.evaluate; K1 must launch 12 times
              per batch, the metrics must be finite; then one more batch under
              torch.profiler for device time by kernel;
  3. parity   the card's tail and head scores for 2 test queries against the
              port's own CPU run (plain versions) on the same graph and weights;
  4. train    training steps of the same model through Engine.train (batch 64,
              128 strict negatives, AdamW): one warm-up step, then timed steps;
              K1 and K2 must each launch 6 times per step, every loss and
              gradient norm must be finite; then one step under torch.profiler;
  5. train parity  one loss step (2 queries, 8 injected negatives, the full
              graph) on the card against the port's CPU run: the loss and
              every parameter's gradient;
  6. classic  evaluation of classic NBFNet (6x32, PNA aggregation, distmult,
              dependent relations, layer norm; seeded weights) on the same KG
              through ClassicNBFNetTask.evaluate, 64 test triples in batches of
              16: K6 and K7 must launch 12 times per batch and no other
              kernel; then one batch under torch.profiler;
  7. classic parity  as phase 3, for classic NBFNet, and a count of the PNA
              variances clipped on one device and not the other;
  8. classic train  Engine.train of classic NBFNet at batch 64, 32 strict
              negatives, Adam at lr 5e-3: one warm-up step, then timed steps;
              K6, K7, K6b and K7b must each launch 6 times per step and no
              other kernel; then one step under torch.profiler;
  9. classic train parity  as phase 5, for classic NBFNet.
 10-12. classic max  phases 6, 7 and 8-9 for classic NBFNet with
              aggregate_func="max" (distmult): K4 must launch 12 times per
              eval batch, K4 and K5 6 times each per step, and no other
              kernel;
 13-15. classic transe-pna  the same for message_func="transe" (pna): K1 24
              and K6 12 times per eval batch; K1 12, K6 6, K3 12 and K6b 6
              times per step, and no other kernel (K7 and K7b never: transe's
              moments are two sums).
 16-18. classic rotate  the same for message_func="rotate" with
              aggregate_func="sum": K8f 12 times per eval batch, K8f and K8b
              6 times each per step, and no other kernel;
 19-20. classic rotate-pna  phases 6 and 7 for message_func="rotate" (pna):
              K8f 12 times per eval batch (PNA's first moment) and no other
              kernel (max, min and the second moment take the O(E) route in
              plain PyTorch, as in the JAX package); no training phase: at
              F=2048 the O(E) route would keep about 220 GB for autograd.
 21-24. ultra bf16  ULTRA with config/transductive/inference.yaml's model and
              task sections and compute_dtype: bfloat16, built through
              build_dataset, build_task and build_engine on the same KG:
              evaluation (K1h 12 times per batch and no other kernel), its
              profile, card vs CPU scores (BF16_* limits), the bf16 - fp32
              score difference and both MRRs on the same weights; then
              Engine.train at batch 64, 128 strict negatives, AdamW (K1h and
              K2h 6 times each per step), its profile, and one loss step's
              gradients against the CPU.
    25. cli   run_full.main on config/synthetic/smoke.yaml (one epoch, its
              checkpoint and log) and on config/transductive/inference.yaml
              with --dataset SynthKG --epochs 0 --bpe 0 --gpus [0] --ckpt null.
 26-29. ultra ring  ULTRA (inference.yaml's model and task, fp32, the
              entity tower cut to RING_LAYERS = 3 layers) with
              parallel: {edge: 4}, rspmm_impl: ring, ring_exchange: rdma,
              built through build_dataset, mesh_scope, build_task and
              build_engine on the same KG, every edge shard on the card:
              evaluation (per batch K1 once per non-empty bucket, 16 at
              n = 4, for each layer and direction, and K9 2 x 3 x 3 = 18
              times, no K2), its profile, the ring's scores against the
              single-device model on the same weights on the card (1e-4);
              then Engine.train at batch 64, 128 strict negatives, AdamW
              (per step K1 and K2 3 x 16, K9 18), its profile, and one loss
              step's loss and gradients against the single-device step.
    30. ring cli  run_full.main on smoke.yaml rendered with the three keys
              (one epoch, its checkpoint and log, K9 on the card).
    31. checkpoint  (run after phase 3, on its task and model) phase 2's
              ULTRA exported to a reference .pth with the port's exporter,
              loaded through Engine.load into fresh engines of other seeds,
              as written and with DDP's module. prefix on every key: phase
              2's 64 test triples in batches of 16 must rank exactly as
              phase 2's model ranks them, K1 12 times per batch and no other
              kernel; with fix_reasoner every relation projection and
              relation embedding keeps the fresh model's value bitwise and
              every other weight is the file's; then run_full.main on
              config/transductive/inference.yaml with --dataset SynthKG
              --epochs 0 --bpe 0 --gpus [0] --ckpt <the .pth>.
 32-33. inductive  zero-shot evaluation of the .pth's weights on a
              generated inductive KG with the counts of ILPC 2022's large
              split (a training graph of 46,626 entities and 202,446
              triples, an inference graph of 29,246 and 77,044, 10,179 valid
              and 10,184 test triples, 65 relations), the task built through
              build_task from config/inductive/inference.yaml's model and
              task sections (its default metrics, hits@10_50 among them):
              512 test and 64 valid triples in batches of 16 over the
              inference graph, K1 12 times per batch and no other kernel,
              valid and test on one prepared graph, every metric finite; one
              batch profiled; the card's scores for 2 queries against the
              port's CPU run (1e-4); then run_full.main on
              config/inductive/inference.yaml with --dataset
              SynthInductiveKG --epochs 0 and the .pth.
 34-36. pretrain  a JointDataset of three generated graphs with the counts
              of FB15k-237 (14,541 entities, 237 relations, 272,115 / 17,535
              / 20,466 triples), WN18RR (40,943; 11; 86,835 / 3,034 / 3,134)
              and CoDEx-M (17,050; 51; 185,584 / 10,310 / 10,311), the task,
              optimizer and engine sections of pretrain_3g.yaml through
              build_task and build_engine (batch 64, 128 strict negatives,
              AdamW 5e-4): Engine.train draws 12 steps from the mixture,
              then each graph gets the steps it lacks of one warm-up and 3
              timed steps through the engine's step; K1 and K2 6 times each
              a step and no other kernel; per graph the ms a step, one
              step's device time under torch.profiler and its peak memory;
              evaluation with fast_test 64 (per_graph holds three finite
              sets, the mean mrr is their mean; K1 12 times per batch); one
              loss step on the graph with the fewest train triples against
              the port's CPU run; then run_full.run on pretrain_3g.yaml
              rendered for SynthJoint (3 graphs) with train.num_epoch 1 and
              batch_per_epoch 3 in place of the shipped 10 and 20,000.
    37. policies  ULTRA (UltraConfig.default, 6x64 towers) on the same KG:
              one train step (batch 64, 128 strict negatives) from one set
              of weights, batch and draw of negatives under remat none,
              save_rspmm, full, and full with micro_batch 16; each mode's
              loss and gradients against none's (1e-6 relative, 1e-5
              norm-wise; bitwise where they are), its ms, device ms, peak
              memory and launches (K1 6 / 6 / 12 and K2 6 for the first
              three, K1 72 and K2 24 with micro-batches: per chunk the
              forward, the chunk's recomputation and each layer's); one
              eval batch with score_chunk 4096 against the unchunked scores
              (1e-6).
    38. atomic  pretrain_3g.yaml's task (remat: auto), optimizer and engine
              sections through build_task and build_engine on one generated
              graph with ATOMIC's counts (304,388 entities, 610,536 train
              triples, 9 relations; 5,000 valid and 5,000 test triples, the
              phase's own): the resolved policy, one warm-up and 3 timed
              steps (ms, device ms, peak under the card's memory,
              launches as the policy gives them), one step's loss and
              gradients against the lowest tier pinned (full remat,
              micro_batch 8; 1e-5 relative, 1e-4 norm-wise), 256 test
              triples at the auto eval batch (ms a batch, peak), and the
              first 16 queries ranked at it and at a pinned 16 (equal but
              within a score tie of 1e-5).
    39. failsoft  in a process of its own (--failsoft), on the same seeded
              KG, capped at 0.6 of phase 37's keep-everything
              step peak (set_per_process_memory_fraction) while the budget
              reads the whole card: a fresh task (remat: auto) and engine's
              first step runs out of memory, demotes at least once and
              completes with phase 37's none-mode loss (1e-5), its peak
              within the cap; one evaluation under the cap at the auto eval
              batch; then the cap is lifted.
    40. classic paths  classic NBFNet (6x32, distmult, pna, layer norm,
              seeded weights) on the same KG: edge_gradients for 2 test
              triples (the O(E) route, no kernel), beam_search_paths
              (num_beam 10, path_topk 10) and visualize, each timed, against
              the port's CPU run (gradients 1e-4 norm-wise per layer, the
              top path equal, path weights 1e-4); one concat_hidden eval
              batch (K6, K7 12 times each) against the CPU run (1e-5).
    41. towers  ULTRA 6x64 with num_rel_models 7 (one relation tower per
              entity layer plus one) on the same KG: evaluation (K1 12 times
              per batch, the towers on cuBLAS), its device time and the
              relation towers' share, scores against the CPU (1e-4); one
              train step at batch 64 x 128 negatives (K1, K2 6 times), its
              device time, loss and gradients against the CPU (1e-5, 1e-4).
    42. options  phase 41's readings for the shared relation model
              (CustomNBFNet), the learned query and activation gelu, each
              alone with one relation tower.
    43. xla   rspmm_impl xla against the kernel route on the same card and
              weights: an ULTRA eval batch of 16 (1e-4) and a train step at
              batch 8 (loss 1e-5, gradients 1e-4), no kernel launched on
              xla; a classic distmult/max eval batch (1e-5, no K4); ms,
              device ms and peak memory of each beside the kernel route's.
    44. steps_per_call  8 steps with K = 4 against K = 1 from one seed
              (parameters within 1e-5; bitwise equality is logged), ms per
              step both ways; pre-training on three generated graphs with
              K = 3 and 5 batches an epoch takes 6 steps.
    45. towers .pth  phase 41's model exported and loaded into a fresh
              engine: bitwise the same scores; run_full.main on a copy of
              config/transductive/inference.yaml with num_rel_models 7 and
              the file as its checkpoint.
    46. catalog  files in the public downloads' formats at the catalog's
              canonical cache layouts in a temporary directory, generated
              from seeds with string tokens: FB15k237 (14,541 entities,
              237 relations, 272,115 / 17,535 / 20,466 triples), WN18RR
              (40,943; 11; 86,835 / 3,034 / 3,134), CoDExMedium (17,050;
              51; 185,584 / 10,310 / 10,311; codex-m/) and
              ILPC2022LargeInductive (phase 32's counts; ILPC's folders);
              each parsed by the port (host seconds; the counts must be
              those written); run_full.main on copies of the shipped
              configs with only path changed and the cuts logged:
              inference.yaml with --dataset FB15k237 (fast_test 64),
              pretrain_3g.yaml with its dataset section as shipped (1
              epoch of 3 batches), config/inductive/inference.yaml on
              ILPC2022LargeInductive (fast_test 64); run_many over
              FB15k237 and WN18RR with -reps 1 (its CSV checked); one
              engine with engine.logger: wandb (inert: wandb's import is
              blocked where it is installed).
    47. data parallel  2 ranks (child processes of this script,
              --dp-child, torchrun's environment) on card 0 over gloo,
              ULTRA 6x64 on the FB-size KG: 256 test triples ranked in
              round-robin shards at the initial weights and gathered
              (equal to one process's but within a score tie of 1e-5),
              then 3 AdamW steps at a global batch of 64 x 128 negatives,
              32 rows a rank, against one process on the same card
              (losses 1e-5 relative, parameters 1e-4 norm-wise); K1 12 an
              eval batch, K1 and K2 6 a step on each rank; ms a step a
              rank (two ranks share the card: no scaling figure). On a
              machine with 2 or more cards, also one rank a card over
              NCCL, as many ranks as cards (ms a step and peak memory a
              card against the one process on one card).
    48. composed  the same ranks with parallel: {data: 2, edge: 2},
              rspmm_impl: ring and rdma: one step's loss (1e-5) and
              gradients (1e-4 norm-wise) against the single-device step;
              K1 and K2 24 and K9 12 a step on each rank.
    49. partitioned  ULTRA (inference.yaml's model, 6x64) on the FB-size
              KG with parallel: {edge: 4} and rspmm_impl: auto, every shard
              on the card: one eval batch of 16 (K1 once a shard a layer,
              48) and one Engine.train step at batch 64 x 128 (K1, K2 24
              each; no K9), each against the single-device run on the same
              card and weights (scores 1e-5, loss 1e-5, gradients 1e-4
              norm-wise, at the seeded weights); then the same at 2 entity
              layers with compute_dtype: bfloat16 (K1h, K2h), with transe
              messages (K1 add_rel, K3), with max (off the ring the
              single-device K4, K5: 4 an eval batch, 2 each a step) and
              with rspmm_impl: xla (the sharded body, no kernel; its step
              at batch 8, as phase 43's).
    50. ring extrema  the entity tower with max and with pna on the ring
              (edge 4, rdma, the degree-balanced relabelling forced on,
              permuted IO): the ring's extremum, pair and moments
              schedules (plain PyTorch, no K1) with K9 between steps (max
              36 an eval batch and a step, pna 72), one eval batch and one
              step each against the single-device run (K4/K5; K6, K7,
              K6b, K7b): scores 1e-4, gradients 1e-4 (pna 2e-3:
              PNA_RING_GRAD_RTOL says why); pna's loss step again in
              fp64 against the single-device model in fp64 on the CPU
              (1e-9, pna_rounding), each fp32 route read against it.
    51. relation_edge  parallel.relation_edge: both towers on the
              partitioned kernels, then both on the ring (the relation
              graph's buckets neither balanced nor permuted), one eval
              batch each against the single-device run (1e-4); then
              run_full.main on smoke.yaml with relation_edge, one epoch of
              5 steps, its checkpoint and evaluation: partitioned (sum),
              and the ring with pna and ppermute (K1, K2 on the card).
              Phases 26-30 and 49-51 pin every shard to card 0 (the
              one-card mesh), also on a host with several cards.
    52. cards     where there are 2 or more cards: edge = min(4, cards)
              shards, each on a card of its own (the mesh's placement),
              home on card 0. K9 between cards exactly against its plain
              version (PyTorch's copies) at ragged and full shapes, 200
              shifts of distinct fills back to back read after one
              synchronize, and timed beside the plain version and a peer
              copy_ a block against NVLink's 450 GB/s (the "K9 cards"
              entry); then ULTRA 6x64 on the FB-size KG, one eval batch
              and one step a path against the single-device run on card
              0 with the same weights: partitioned (scores bitwise), the
              ring's sums with rdma and with ppermute, ring max and pna,
              and at 2 entity layers partitioned bf16, transe, max and
              xla (step at batch 8), relation_edge on both routes (eval);
              ms, peak memory and launches by card, every shard's
              kernels on its own card. The ring's entity tower keeps its
              states on the shards' cards: on each ring path's step card
              0 may peak at most 1.25 x the largest other card's + 0.5
              GiB (check_home_peak). On one card it logs that it is
              not run.
    53. data 2 x edge 2  where there are 4 or more cards: two NCCL ranks
              of two cards each (rank r at home on card 2r), the ring
              (rdma, the tower's states on each rank's two cards) and then
              the partitioned path, one step each against the
              single-device step (loss 1e-5 relative, gradients 1e-4
              norm-wise), launches and peak memory by rank and by card.
    54. learning  diagnostics/learning.py's check (the JAX repo's
              convergence_check.py): ULTRA 6x64 with remat auto on the
              offsets KG (1,000 entities, 8 compositional relations), 64
              strict negatives, batch 64, AdamW 5e-4; valid MRR on 200
              triples, 400 steps, MRR again, which must exceed max(10 x
              the first, 0.05): in fp32 (K1, K2 6 a step), bf16 (K1h, K2h
              6) and on the ring on the one-card mesh (edge 4, rdma: K1
              and K2 6 x the non-empty buckets, K9 36 a step); ms a step,
              launches a step, peak memory, each window's mean loss. Then
              the fp32 model's first 20 steps on the card against the
              port's CPU run from the same weights, batches and injected
              negatives: each step taken on the card from the CPU run's
              state within 1e-4 (loss, relative) and 1e-3 (parameters,
              norm-wise), the whole run within 1e-2 and 1e-1 (fp32
              rounding compounds step by step; in fp64 the two runs
              agree to about 1e-15, diagnostics/learning.py
              --trajectory --fp64).
    55. endurance  diagnostics/endurance.py's run in short form: the
              three-graph pre-training mixture (FB15k-237's, WN18RR's and
              CoDEx-M's counts), batch 64, 128 strict negatives, 300
              steps in windows of 50, a checkpoint and an evaluation
              (fast_test 64) at 150 and 300, and the resume check at 150
              (5 steps from the checkpoint with the kept random states:
              losses and parameters 1e-5); memory_allocated at each
              window's end within 64 MiB and VmRSS within 256 MiB of the
              second window's, every loss finite, each window's K1 and K2
              launches those of its graphs' steps.

Phases 49-55 log their seconds, ms a batch and a step and peak memory
beside the card's name and power limit. The phases that time evaluation
(2, 6-24, 26-29, 32-33, 49-51) pin the eval batch to 16; the CLI runs
and pre-training's evaluation take the auto eval batch, and every phase
that runs a shipped config logs the memory policies its remat: auto
resolves to.

The last lines are a JSON object with one entry per kernel (K1, K2, K6,
K7, K6b, K7b, K3, K4, K5, K8f, K8b, K1h, K2h, K9, and "K9 cards" where
phase 52 ran; launches summed over the measured runs of phases 2-55, by
path in ``launches_by_path``; the staged
backward kernels' layouts under ``plan``; P1 and P2 with full's numbers
and their launches in the tools' runs of phase 1b),
then {"ok": true, "device": {...}}. With no card the script prints no
result and exits nonzero; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
PACKAGE = "ultra_torchdrug_tpu_torch"
sys.path.insert(0, str(REPO))
try:
    # the timing and bound helpers, shared with the ladder tools and
    # diagnostics/redesign_times.py
    from ultra_torchdrug_tpu_torch.diagnostics.timing import (
        assert_bwd_close,
        assert_mass_close,
        cuda_time_ms,
        edge_bytes,
        gate_skip_share,
        gather_bound_ms,
        k1_bound_ms,
        k1_mass,
        k1h_sums64,
        k2_half_times,
        k2_mass,
        k8f_mass,
        k3_half_times,
        k9_times,
        pna_half_times,
        pna_mass,
        roofline_ms,
        rotate_mass,
        sparse_mm_halves,
    )
except ImportError as exc:
    raise SystemExit(f"{PACKAGE}/ is not beside {Path(__file__).name}: run "
                     f"the script from a checkout of the repository ({exc})")

# slice shape: FB15k-237's entity, triple and relation counts
FULL = dict(num_nodes=14541, num_edges=310116, num_relations=237)
REHEARSAL = dict(num_nodes=1500, num_edges=20000, num_relations=40)
EVAL_BATCH = 16
FAST_TEST = 64
K1_LAUNCHES_PER_BATCH = 12  # 6 entity layers x (tail + head scoring)
# training: config/transductive/pretrain_3g.yaml's engine batch and negatives
TRAIN = dict(batch=64, negatives=128, steps=5)
TRAIN_REHEARSAL = dict(batch=8, negatives=16, steps=2)
K_LAUNCHES_PER_STEP = 6  # 6 entity layers, one pass over the flipped batch
FEAT = 64  # the model's feature width
# classic NBFNet: the NBFNet paper's FB15k-237 setting (config/knowledge_graph/
# fb15k237.yaml of DeepGraphLearning/NBFNet): 6x32, pna, distmult, dependent
# relations, layer norm; training at batch 64 with 32 strict negatives and
# Adam at lr 5e-3
CLASSIC_FEAT = 32
CLASSIC_TRAIN = dict(batch=64, negatives=32, steps=5)
CLASSIC_TRAIN_REHEARSAL = dict(batch=8, negatives=8, steps=2)
# every kernel of the port, in the order of the kernels line; P1 and P2 are
# the ladder tools (diagnostics/kernel_floor.py, blocked_ladder.py), both on
# csrc/rspmm_ladder.cu, whose launches count under "ladder" and must stay 0
# on every model path
KERNEL_IDS = ("K1", "K2", "K6", "K7", "K6b", "K7b", "K3", "K4", "K5", "K8f",
              "K8b", "K1h", "K2h", "K9", "P1", "P2")
COUNTED = KERNEL_IDS[:-2] + ("ladder",)
# the ring path: ULTRA's entity tower on an edge mesh of RING_SHARDS shards,
# all on the card (parallel: {edge: 4}, rspmm_impl: ring, ring_exchange:
# rdma); ring vs single device on the same card and weights, as the
# single-device path is held against the CPU
RING_SHARDS = 4
# phases 26-29 run the ring's sums at this depth (the run's time budget;
# phases 50-51 run the ring at the full 6 layers)
RING_LAYERS = 3
RING_SCORE_ATOL = 1e-4
RING_GRAD_RTOL = 1e-4
# card vs CPU for classic NBFNet: about 10x the largest reading of five H100
# runs (scores 4.5e-7, gradients 5.8e-6 norm-wise); the CPU's plain K7 sums in
# another order, and std = sqrt(clip(sq_mean - mean², 1e-6)) amplifies that
# rounding up to 500x near the clip (phase 7 counts the entries clipped on
# one device only); the loss is held to ULTRA's 1e-5
CLASSIC_SCORE_ATOL = 1e-5
CLASSIC_GRAD_RTOL = 1e-4
# card vs CPU for ULTRA in bf16 operand mode: both round the same fp32
# operands to bf16, but a layer's fp32 output differs in its last bits
# between the two devices (sums in another order, ~1e-7 relative), and
# where that straddles a bf16 rounding boundary (a share of about
# 1e-7 / 2^-8 of the operands) the next layer's operand moves by 2^-8 of
# itself. The limits leave room for such moves and stay well below the
# bf16 - fp32 difference on the same weights, which is printed beside them
BF16_SCORE_ATOL = 5e-4
BF16_LOSS_RTOL = 2e-5
BF16_GRAD_RTOL = 5e-3


def log(*args):
    print(*args, flush=True)


def import_port():
    """Import the port from this checkout, and only from it."""
    if not (REPO / PACKAGE / "__init__.py").exists():
        raise SystemExit(f"{PACKAGE}/ is not beside {Path(__file__).name}: "
                         "run the script from a checkout of the repository")
    import ultra_torchdrug_tpu_torch as port

    if Path(port.__file__).resolve().parent != REPO / PACKAGE:
        raise SystemExit(f"imported {port.__file__}, not this checkout's")
    return port


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel id (the ladder's
    variants summed under "ladder")."""
    from ultra_torchdrug_tpu_torch.ops import (
        rspmm_bwd_cuda,
        rspmm_cuda,
        rspmm_ladder_cuda,
        rspmm_pna_cuda,
    )
    from ultra_torchdrug_tpu_torch.parallel import rdma

    counts = {"K1": rspmm_cuda.launches, "K8f": rspmm_cuda.rotate_launches,
              "K1h": rspmm_cuda.bf16_launches, "K9": rdma.launches,
              "ladder": sum(rspmm_ladder_cuda.launches.values()),
              **rspmm_bwd_cuda.launches, **rspmm_pna_cuda.launches}
    return {k: counts[k] for k in COUNTED}


def reset_launch_counts():
    from ultra_torchdrug_tpu_torch.ops import (
        rspmm_bwd_cuda,
        rspmm_cuda,
        rspmm_ladder_cuda,
        rspmm_pna_cuda,
    )
    from ultra_torchdrug_tpu_torch.parallel import rdma

    rspmm_cuda.launches = rspmm_cuda.rotate_launches = 0
    rspmm_cuda.bf16_launches = rdma.launches = rdma.peer_launches = 0
    CARD_LAUNCHES.clear()
    for counts in (rspmm_bwd_cuda.launches, rspmm_pna_cuda.launches,
                   rspmm_ladder_cuda.launches):
        for key in counts:
            counts[key] = 0


# phase 52-53's launches by (kernel id, card index) since the last
# reset_launch_counts, recorded by card_launch_spy
CARD_LAUNCHES = {}


@contextlib.contextmanager
def card_launch_spy():
    """Record the card of every launch that the edge paths make through
    their kernel wrappers (K1, K1h, K2, K2h, K3 in parallel/ring_rspmm.py
    and parallel/sharded_rspmm.py; K9 in parallel/rdma.py) in
    CARD_LAUNCHES; the wrappers' own counts are untouched."""
    from ultra_torchdrug_tpu_torch.parallel import rdma, ring_rspmm
    from ultra_torchdrug_tpu_torch.parallel import sharded_rspmm

    def spy(fn, kid_of, device_of):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            key = (kid_of(kwargs), device_of(args).index)
            CARD_LAUNCHES[key] = CARD_LAUNCHES.get(key, 0) + 1
            return out
        return wrapped

    def bwd_kid(kwargs):
        return "K3" if kwargs.get("mode") == "add_rel" else "K2"

    patches = [(rdma, "_launch", spy(rdma._launch, lambda kw: "K9",
                                     lambda a: a[0]))]
    for mod in (ring_rspmm, sharded_rspmm):
        patches += [
            (mod, "rspmm_fwd_cuda", spy(mod.rspmm_fwd_cuda,
                                        lambda kw: "K1",
                                        lambda a: a[6].device)),
            (mod, "rspmm_fwd_bf16_cuda", spy(mod.rspmm_fwd_bf16_cuda,
                                             lambda kw: "K1h",
                                             lambda a: a[6].device)),
            (mod, "rspmm_bwd_cuda", spy(mod.rspmm_bwd_cuda, bwd_kid,
                                        lambda a: a[4].device)),
            (mod, "rspmm_bwd_bf16_cuda", spy(mod.rspmm_bwd_bf16_cuda,
                                             lambda kw: "K2h",
                                             lambda a: a[4].device))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def reset_peaks(cards) -> None:
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)


def peaks_text(cards) -> str:
    return ", ".join(f"{c} {torch.cuda.max_memory_allocated(c) / 2**30:.3f}"
                     for c in cards if c.type == "cuda") + " GiB"


def check_launches(label: str, counts: dict, per_unit: dict, units: int,
                   device):
    """Each kernel in ``per_unit`` launched that many times per unit (eval
    batch or train step) and every other kernel never; on the CPU none."""
    want = {k: per_unit.get(k, 0) * units if device.type == "cuda" else 0
            for k in counts}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts} in {units} units, "
                             f"expected {want}")


def phase_build():
    from ultra_torchdrug_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    libs = cuda_build.build(cuda_build.sources())
    seconds = time.perf_counter() - t0
    log(f"[build] {len(libs)} kernel source(s) in {seconds:.1f} s: "
        f"{sorted(libs)}")
    for name, lib in sorted(libs.items()):
        logfile = lib.with_suffix(".so.log")
        lines = logfile.read_text().splitlines() if logfile.exists() else []
        for line in lines:
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def k1_operands(graph, feat: int, seed: int, device):
    """K1's operands on ``graph`` (with its CSR): x [V, F], rel [R, F]
    ~ N(0, 1) from a seeded generator, and edge weights in [0.5, 1.5] with a
    fifth of the edges masked to 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    V, R, E = graph.num_nodes, graph.num_relations, graph.num_edges
    x = torch.randn((V, feat), generator=gen, device=device)
    rel = torch.randn((R, feat), generator=gen, device=device)
    w = torch.rand((E,), generator=gen, device=device) + 0.5
    w = w * (torch.rand((E,), generator=gen, device=device) >= 0.2)
    csr = graph.csr.to(device)
    return (csr.rowptr, csr.src, csr.etype, csr.eid, w, rel, x)


def plan_text(plan: dict) -> str:
    """A K1 or K2 pass's layout (ops' k1_plan / k2_plan) in a log line."""
    return (f"slice {plan['slice_floats']} features, rel {plan['rel']}"
            + (f" ({plan['rel_smem_bytes']} B)" if plan["rel_smem_bytes"]
               else "")
            + f", {plan['slices']} slices x {plan['ctas_per_slice']} CTAs")


def check_k1_hub(csr, w, F: int, label: str, device) -> float:
    """K1 in both modes over ``csr`` at width F against its plain version:
    K1's tolerance plus 8
    fp32 ulps of each entry's absolute mass (the hub rows' partial sums run
    in another order), rows without edges 0, two calls bitwise equal.
    Returns the largest difference."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_cuda

    V, R = csr.rowptr.numel() - 1, csr.rel_chunk_ptr.numel() - 1
    gen = torch.Generator(device=device).manual_seed(F + R)
    rel = torch.randn((R, F), generator=gen, device=device)
    x = torch.randn((V, F), generator=gen, device=device)
    ops = (csr.rowptr, csr.src, csr.etype, csr.eid, w, rel, x)
    err = 0.0
    for mode in ("mul_rel", "add_rel"):
        want = rspmm_cuda.rspmm_fwd_plain(*ops, mode)
        mass = k1_mass(ops, mode)
        got = rspmm_cuda.rspmm_fwd_cuda(*ops, mode, segments=csr.segments)
        again = rspmm_cuda.rspmm_fwd_cuda(*ops, mode, segments=csr.segments)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"K1 {label}: two calls differ")
        err = max(err, assert_mass_close(got, want, mass, 1e-5, 1e-5,
                                         f"K1 {mode} {label}"))
        empty = (csr.rowptr[1:] == csr.rowptr[:-1]).nonzero()
        if not torch.all(got[empty] == 0):
            raise AssertionError(f"K1 {label}: rows without edges")
    plan = rspmm_cuda.k1_plan(R, F, V, csr.seg_ptr.numel() - 1)
    log(f"[kernels] K1 {label}: max_abs_err {err:.3g} within the mass "
        f"tolerance, bitwise equal across two calls; {plan_text(plan)}")
    return err


def phase_kernels(dataset, device):
    """K1 against its plain version; returns its kernels-line entry (without
    the main path's launch count)."""
    from ultra_torchdrug_tpu_torch.data.graph import Graph
    from ultra_torchdrug_tpu_torch.ops import rspmm_cuda

    tol = dict(rtol=1e-5, atol=1e-5)
    # (a) small and ragged shapes: F = 10 and 12 take the scalar path, 64 the
    # float4 path, 1028 several feature slices; rows 32.. of the first graph
    # and 45.. of the second receive no edge
    rng = np.random.default_rng(0)
    for V, E, R, F, empty in ((37, 300, 6, 10, 5), (37, 300, 6, 64, 5),
                              (37, 300, 6, 1028, 5), (50, 20, 3, 12, 5)):
        tri = np.stack([rng.integers(0, V, E), rng.integers(0, V - empty, E),
                        rng.integers(0, R, E)], 1)
        g = Graph.from_triplets(tri, V, R).prepare_csr()
        ops = k1_operands(g, F, seed=V + F, device=device)
        for mode in ("mul_rel", "add_rel"):
            got = rspmm_cuda.rspmm_fwd_cuda(*ops, mode,
                                            segments=g.csr.to(device).segments)
            want = rspmm_cuda.rspmm_fwd_plain(*ops, mode)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **tol)
            if not torch.all(got[V - empty:] == 0):
                raise AssertionError("K1 wrote nonzero rows without edges")
            err = (got - want).abs().max().item()
            log(f"[kernels] K1 {mode} V={V} E={E} R={R} F={F}: "
                f"max_abs_err {err:.3g}")
    # hub rows of 10^3 and 10^4 edges, rows of 256 and 257, empty rows: F =
    # 10 the scalar path, 100 a last slice it does not fill, 1028; then R =
    # 2,000 relations, whose rel slice exceeds the shared-memory budget, so
    # rel rows are gathered (F = 13 scalar, 132 float4)
    csr, w = rspmm_cuda.hub_operands(10, device)
    for F in (10, 100, 1028):
        check_k1_hub(csr, w, F, f"hub rows F={F}", device)
    csr, w = rspmm_cuda.hub_operands(11, device, R=2000)
    for F in (13, 132):
        check_k1_hub(csr, w, F, f"R=2000 F={F}", device)
    del csr, w

    # (b) the full-width shape of the slice: the undirected FB-sized fact
    # graph, F = 16 queries x 64 features
    fact, _ = dataset.fact_graph(None)
    und = fact.undirected_with_inverse().prepare_csr()
    F = EVAL_BATCH * 64
    ops = k1_operands(und, F, seed=1, device=device)
    segments = und.csr.to(device).segments
    log(f"[kernels] full-width shape V={und.num_nodes} E={und.num_edges} "
        f"R={und.num_relations} F={F}: "
        + plan_text(rspmm_cuda.k1_plan(und.num_relations, F, und.num_nodes,
                                       segments.num_segments)))
    entry = None
    for mode in ("mul_rel", "add_rel"):
        got = rspmm_cuda.rspmm_fwd_cuda(*ops, mode, segments=segments)
        want = rspmm_cuda.rspmm_fwd_plain(*ops, mode)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **tol)
        err = (got - want).abs().max().item()
        del got, want
        ms = cuda_time_ms(lambda: rspmm_cuda.rspmm_fwd_cuda(
            *ops, mode, segments=segments), 50)
        plain_ms = cuda_time_ms(
            lambda: rspmm_cuda.rspmm_fwd_plain(*ops, mode), 5, warmup=1)
        bound_ms, bound_by = k1_bound_ms(ops)
        log(f"[kernels] K1 {mode}: max_abs_err {err:.3g}, {ms:.4f} ms "
            f"(plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
            f"{bound_by}, {bound_ms / ms:.1%} of it), library_ms: null "
            "(no single PyTorch call computes this function)")
        if mode == "mul_rel":  # the main path's mode
            entry = dict(
                name="K1", route="cuda",
                source=f"{PACKAGE}/csrc/rspmm_fwd.cu",
                replaces="ultra_torchdrug_tpu/ops/rspmm_pallas.py:1681",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        else:
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            entry["ms_add_rel"] = ms
    log('[kernels] kernels ["K1"]')
    return entry


def k2_bound_ms(csr, w, rel, x, g) -> tuple:
    """Least time for K2's (or K2h's) work on this card: the edges, x, g and
    rel read once (4 B a feature, 2 B for bf16 operands) and the fp32 dx and
    dr written once over the memory rate, against 6 fp32 operations per
    edge and feature (3 for dx, 3 for dr) over the fp32 peak."""
    E, F = w.numel(), x.shape[1]
    nbytes = edge_bytes(E) + (x.numel() + g.numel() + rel.numel()) * (
        x.element_size())
    nbytes += (x.numel() + rel.numel()) * 4  # dx, dr
    return roofline_ms(nbytes, 6 * E * F)


def k2_operands(graph, feat: int, seed: int, device):
    """K2's operands on ``graph``: the layouts, masked weights (a fifth 0),
    rel [R, F], x and g [V, F] ~ N(0, 1)."""
    _, _, _, _, w, rel, x = k1_operands(graph, feat, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    g = torch.randn(x.shape, generator=gen, device=device)
    return graph.csr.to(device), w, rel, x, g


def phase_kernels_k2(und, device):
    """K2 against its plain version; returns its kernels-line entry, with
    each half's time and bound."""
    from ultra_torchdrug_tpu_torch.data.graph import Graph
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda, rspmm_cuda

    # dr rows sum up to ~1000 products of N(0, 1) values per relation in
    # another order than the plain version: 1e-4 absolute
    tol = dict(rtol=1e-5, atol=1e-4)

    def check(ops, label):
        dx, dr = rspmm_bwd_cuda.rspmm_bwd_cuda(*ops)
        torch.cuda.synchronize()
        dx2, dr2 = rspmm_bwd_cuda.rspmm_bwd_cuda(*ops)
        torch.cuda.synchronize()
        if not (torch.equal(dx, dx2) and torch.equal(dr, dr2)):
            raise AssertionError(f"K2 {label}: two calls differ")
        want_dx, want_dr = rspmm_bwd_cuda.rspmm_bwd_plain(*ops)
        torch.testing.assert_close(dx, want_dx, **tol)
        torch.testing.assert_close(dr, want_dr, **tol)
        err = max((dx - want_dx).abs().max().item(),
                  (dr - want_dr).abs().max().item())
        log(f"[kernels] K2 {label}: max_abs_err {err:.3g}, bitwise equal "
            "across two calls")
        return dx, dr, err

    # (a) small and ragged shapes: F = 10 and 12 scalar, 64 float4, 1028
    # several feature slices; the last 5 rows send no edge and the last
    # relation has none; the (60, 1400, 3) graph spreads ~700 edges over
    # each of two relations, three chunks each
    rng = np.random.default_rng(1)
    for V, E, R, F in ((37, 300, 6, 10), (37, 300, 6, 64), (37, 300, 6, 1028),
                       (50, 20, 3, 12), (60, 1400, 3, 64)):
        tri = np.stack([rng.integers(0, V - 5, E), rng.integers(0, V - 5, E),
                        rng.integers(0, R - 1, E)], 1)
        g = Graph.from_triplets(tri, V, R).prepare_csr(backward=True)
        dx, dr, _ = check(k2_operands(g, F, seed=V + F, device=device),
                          f"V={V} E={E} R={R} F={F}")
        if not (torch.all(dx[V - 5:] == 0) and torch.all(dr[R - 1] == 0)):
            raise AssertionError("K2 wrote nonzero rows without edges")
    # hub rows (10^3, 10^4, 256 and 257 edges; K2's tolerance plus 8 fp32
    # ulps of each entry's absolute mass), F = 10, 100, 1028; R = 2,000,
    # whose rel rows the dx pass gathers, F = 13 and 132
    for seed, R, feats in ((12, 7, (10, 100, 1028)), (13, 2000, (13, 132))):
        csr, w = rspmm_cuda.hub_operands(seed, device, R=R)
        for F in feats:
            check_k2_hub(csr, w, F, f"{'hub rows' if R == 7 else 'R=2000'} "
                         f"F={F}", device)
        del csr, w

    # (b) the training shape: F = 64 queries x 64 features
    F = TRAIN["batch"] * FEAT
    ops = k2_operands(und, F, seed=2, device=device)
    label = (f"training shape V={und.num_nodes} E={und.num_edges} "
             f"R={und.num_relations} F={F}")
    _, _, err = check(ops, label)
    torch.cuda.empty_cache()
    out = k2_times(ops, label)
    plain_ms = cuda_time_ms(lambda: rspmm_bwd_cuda.rspmm_bwd_plain(*ops), 3,
                            warmup=1)
    bound_ms, bound_by = k2_bound_ms(*ops)
    log(f"[kernels] K2 {label}: {out['ms']:.4f} ms (plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by}, {bound_ms / out['ms']:.1%} "
        "of it), library_ms: null (no single PyTorch call computes this "
        "function)")
    log('[kernels] kernels ["K2"]')
    return dict(name="K2", route="cuda",
                source=f"{PACKAGE}/csrc/rspmm_bwd.cu",
                replaces="ultra_torchdrug_tpu/ops/rspmm_pallas.py:2110",
                launches=None, max_abs_err=err, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None, **out)


def check_k2_hub(csr, w, F: int, label: str, device) -> float:
    """K2 over ``csr`` at width F against its plain version: K2's
    tolerance plus 8 fp32 ulps of each entry's absolute mass, rows and
    relations without edges 0, two calls bitwise equal, each half alone
    equal to the whole. Returns the largest difference."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda

    V, R = csr.src_rowptr.numel() - 1, csr.rel_chunk_ptr.numel() - 1
    gen = torch.Generator(device=device).manual_seed(F + R + 1)
    args = (csr, w, *(torch.randn(shape, generator=gen, device=device)
                      for shape in ((R, F), (V, F), (V, F))))
    dx, dr = rspmm_bwd_cuda.rspmm_bwd_cuda(*args)
    dx2, dr2 = rspmm_bwd_cuda.rspmm_bwd_cuda(*args)
    torch.cuda.synchronize()
    if not (torch.equal(dx, dx2) and torch.equal(dr, dr2)):
        raise AssertionError(f"K2 {label}: two calls differ")
    err = max(assert_mass_close(got, want, mass, 1e-5, 1e-4, f"K2 {label}")
              for got, want, mass in zip(
                  (dx, dr), rspmm_bwd_cuda.rspmm_bwd_plain(*args),
                  k2_mass(*args)))
    no_src = (csr.src_rowptr[1:] == csr.src_rowptr[:-1]).nonzero()
    no_rel = (csr.tile_rel_ptr[1:] == csr.tile_rel_ptr[:-1]).nonzero()
    if not (torch.all(dx[no_src] == 0) and torch.all(dr[no_rel] == 0)):
        raise AssertionError(f"K2 {label}: rows without edges")
    if not (torch.equal(rspmm_bwd_cuda.rspmm_bwd_cuda(
            *args, need_dr=False)[0], dx) and torch.equal(
            rspmm_bwd_cuda.rspmm_bwd_cuda(*args, need_dx=False)[1], dr)):
        raise AssertionError(f"K2 {label}: a half alone differs")
    plan = rspmm_bwd_cuda.k2_plan(csr, F)
    log(f"[kernels] K2 {label}: max_abs_err {err:.3g} within the mass "
        f"tolerance, bitwise equal across two calls and by half; dx pass "
        f"{plan_text(plan['dx'])}; dr pass {plan_text(plan['dr'])}")
    return err


def k2_times(ops, label: str) -> dict:
    """K2's time on ``ops`` (csr, w, rel, x, g), whole and each half alone
    (the other's output pointer null), with each half's bound; logs them
    with the passes' layouts."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda

    def k2(need_dx=True, need_dr=True):
        return rspmm_bwd_cuda.rspmm_bwd_cuda(*ops, need_dx, need_dr)

    out = dict(ms=cuda_time_ms(k2, 20), **k2_half_times(k2, ops))
    plan = rspmm_bwd_cuda.k2_plan(ops[0], ops[3].shape[1])
    log(f"[kernels] K2 {label}: {out['ms']:.4f} ms; dx half "
        f"{out['ms_dx']:.4f} ms (bound {out['bound_ms_dx']:.4f}; "
        f"{plan_text(plan['dx'])}), dr half {out['ms_dr']:.4f} ms (bound "
        f"{out['bound_ms_dr']:.4f}; {plan_text(plan['dr'])})")
    return out


def phase_k1_k2_hub(device) -> tuple:
    """K1 and K2 at F = 64 x 64 on bench.py's heavy-tailed KG
    (diagnostics/workloads.py::build_workload, edges head -> tail: its
    busiest destination row 107,150 edges, its busiest source row
    107,336), held against their plain versions within the mass tolerance
    (K2 bitwise across two calls) and timed, K2 whole and by half; returns
    the K1 and K2 entries' ``*_hub`` keys."""
    from ultra_torchdrug_tpu_torch.data.graph import build_csr
    from ultra_torchdrug_tpu_torch.diagnostics.workloads import build_workload
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda, rspmm_cuda

    tri, _, _ = build_workload(features=False)
    V, R, E = 15000, 474, len(tri)
    csr = build_csr(tri[:, 0], tri[:, 1], tri[:, 2], V, R,
                    backward=True).to(device)
    F = TRAIN["batch"] * FEAT
    gen = torch.Generator(device=device).manual_seed(F + 9)
    w = torch.rand((E,), generator=gen, device=device) + 0.5
    w = w * (torch.rand((E,), generator=gen, device=device) >= 0.2)
    rel, x, g = (torch.randn(shape, generator=gen, device=device)
                 for shape in ((R, F), (V, F), (V, F)))
    label = f"bench.py's KG V={V} E={E} R={R} F={F}"
    ops = (csr.rowptr, csr.src, csr.etype, csr.eid, w, rel, x)
    got = rspmm_cuda.rspmm_fwd_cuda(*ops, "mul_rel", segments=csr.segments)
    k1_err = assert_mass_close(got, rspmm_cuda.rspmm_fwd_plain(
        *ops, "mul_rel"), k1_mass(ops), 1e-5, 1e-5, f"K1 {label}")
    del got
    torch.cuda.empty_cache()
    k1_ms = cuda_time_ms(lambda: rspmm_cuda.rspmm_fwd_cuda(
        *ops, "mul_rel", segments=csr.segments), 20)
    k1_bound, _ = k1_bound_ms(ops)
    log(f"[kernels] K1 {label}: max_abs_err {k1_err:.3g} within the mass "
        f"tolerance, {k1_ms:.4f} ms (bound {k1_bound:.4f} ms); "
        + plan_text(rspmm_cuda.k1_plan(R, F, V, csr.seg_ptr.numel() - 1)))
    args = (csr, w, rel, x, g)
    k2_bound, _ = k2_bound_ms(*args)
    dx, dr = rspmm_bwd_cuda.rspmm_bwd_cuda(*args)
    dx2, dr2 = rspmm_bwd_cuda.rspmm_bwd_cuda(*args)
    if not (torch.equal(dx, dx2) and torch.equal(dr, dr2)):
        raise AssertionError(f"K2 {label}: two calls differ")
    del dx2, dr2
    k2_err = max(assert_mass_close(a, b, m, 1e-5, 1e-4, f"K2 {label}")
                 for a, b, m in zip((dx, dr), rspmm_bwd_cuda.rspmm_bwd_plain(
                     *args), k2_mass(*args)))
    del dx, dr
    torch.cuda.empty_cache()
    log(f"[kernels] K2 {label}: max_abs_err {k2_err:.3g} within the mass "
        "tolerance, bitwise equal across two calls")
    k2 = k2_times(args, label)
    del args, ops, csr, rel, x, g
    torch.cuda.empty_cache()
    return (dict(ms_hub=k1_ms, max_abs_err_hub=k1_err, bound_ms_hub=k1_bound),
            dict(max_abs_err_hub=k2_err, bound_ms_hub=k2_bound,
                 **{f"{k}_hub": v for k, v in k2.items()}))


def time_k1_train_shape(und, device) -> dict:
    """K1 (mul_rel) at the training shape, F = 64 x 64: time, plain time and
    bound, as extra keys of K1's kernels-line entry."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_cuda

    ops = k1_operands(und, TRAIN["batch"] * FEAT, seed=3, device=device)
    segments = und.csr.to(device).segments
    got = rspmm_cuda.rspmm_fwd_cuda(*ops, "mul_rel", segments=segments)
    want = rspmm_cuda.rspmm_fwd_plain(*ops, "mul_rel")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    err = (got - want).abs().max().item()
    del got, want
    torch.cuda.empty_cache()
    ms = cuda_time_ms(lambda: rspmm_cuda.rspmm_fwd_cuda(
        *ops, "mul_rel", segments=segments), 20)
    plain_ms = cuda_time_ms(
        lambda: rspmm_cuda.rspmm_fwd_plain(*ops, "mul_rel"), 3, warmup=1)
    bound_ms, bound_by = k1_bound_ms(ops)
    F = ops[-1].shape[1]
    plan = rspmm_cuda.k1_plan(und.num_relations, F, und.num_nodes,
                              segments.num_segments)
    log(f"[kernels] K1 mul_rel training shape F={F}: max_abs_err {err:.3g}, "
        f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
        f"{bound_by}, {bound_ms / ms:.1%} of it); {plan_text(plan)}")
    return dict(max_abs_err_train=err, ms_train=ms, plain_ms_train=plain_ms,
                bound_ms_train=bound_ms, bound_by_train=bound_by)


def pna_operands(graph, feat: int, seed: int, device):
    """K6/K7's operands on ``graph`` (with its CSR): x [V, F] as post-ReLU
    node states (about half the entries exactly 0, so messages tie), rel
    [R, F] ~ N(0, 1), and edge weights in [0.5, 1.5] with a fifth masked to
    0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    V, R, E = graph.num_nodes, graph.num_relations, graph.num_edges
    x = torch.randn((V, feat), generator=gen, device=device).clamp_(min=0)
    rel = torch.randn((R, feat), generator=gen, device=device)
    w = torch.rand((E,), generator=gen, device=device) + 0.5
    w = w * (torch.rand((E,), generator=gen, device=device) >= 0.2)
    return graph.csr.to(device), w, rel, x


def check_bwd_kernel(kid: str, run, plain, label: str,
                     dx_close=assert_bwd_close) -> tuple:
    """``run`` (a backward kernel's call) twice, bitwise equal, and within
    assert_bwd_close of ``plain`` (dx within ``dx_close``); returns (dx, dr,
    max_abs_err)."""
    dx, dr = run()
    torch.cuda.synchronize()
    dx2, dr2 = run()
    torch.cuda.synchronize()
    if not (torch.equal(dx, dx2) and torch.equal(dr, dr2)):
        raise AssertionError(f"{kid} {label}: two calls differ")
    want_dx, want_dr = plain()
    dx_close(dx, want_dx)
    assert_bwd_close(dr, want_dr)
    err = max((dx - want_dx).abs().max().item(),
              (dr - want_dr).abs().max().item())
    log(f"[kernels] {kid} {label}: max_abs_err {err:.3g}, bitwise equal "
        "across two calls")
    return dx, dr, err


def ragged_gather_cases(seed: int, device):
    """Small and ragged shapes for the gather kernels, as (label, V, R,
    seed, operands), the operands made from ``seed``: F = 10 and 12 scalar, 64 float4, 1028 two feature tiles; the
    last 5 rows neither send nor receive an edge and the last relation has
    none; 40 duplicated edges tie exactly."""
    from ultra_torchdrug_tpu_torch.data.graph import Graph

    rng = np.random.default_rng(seed)
    for V, E, R, F in ((37, 300, 6, 10), (37, 300, 6, 64), (37, 300, 6, 1028),
                       (50, 20, 3, 12), (60, 1400, 3, 64)):
        tri = np.stack([rng.integers(0, V - 5, E), rng.integers(0, V - 5, E),
                        rng.integers(0, R - 1, E)], 1)
        tri[-min(40, E // 2):] = tri[:min(40, E // 2)]
        g = Graph.from_triplets(tri, V, R).prepare_csr(backward=True)
        yield (f"V={V} E={E} R={R} F={F}", V, R, V + F,
               pna_operands(g, F, seed=V + F, device=device))


def phase_kernels_pna(und, device) -> dict:
    """K6, K7, K6b and K7b against their plain versions; returns their
    kernels-line entries by id (without the main path's launch counts)."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_pna_cuda as pna

    # K6 exactly (an extremum of the same fp32 products); K7 as K1; the
    # backward as assert_bwd_close says
    tol = dict(rtol=1e-5, atol=1e-5)

    fwd_kinds = (("K6", "maxmin", "mul_rel"), ("K6", "maxmin", "add_rel"),
                 ("K7", "addsq", "mul_rel"))
    bwd_kinds = (("K6b", "argext_pair", "mul_rel"),
                 ("K6b", "argext_pair", "add_rel"),
                 ("K7b", "moments", "mul_rel"))

    def check_fwd(kid, kind, mode, ops, label):
        if kid == "K6":  # exact: no difference to report
            return check_extrema_exact(kind, ops, mode, label), 0.0
        got = pna.pna_fwd_cuda(kind, *ops, mode)
        want = pna.pna_fwd_plain(kind, *ops, mode)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **tol)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        log(f"[kernels] {kid} {mode} {label}: max_abs_err {err:.3g}")
        return got, err

    def check_bwd(kid, kind, mode, ops, q, label):
        return check_bwd_kernel(
            kid, lambda: pna.pna_bwd_cuda(kind, *ops, q, mode),
            lambda: pna.pna_bwd_plain(kind, *ops, q, mode),
            f"{mode} {label}")

    # (a) small and ragged shapes
    for label, V, R, seed, ops in ragged_gather_cases(2, device):
        for kid, kind, mode in fwd_kinds:
            out, _ = check_fwd(kid, kind, mode, ops, label)
            if not all(torch.all(o[V - 5:] == 0) for o in out):
                raise AssertionError(f"{kid} wrote nonzero rows without "
                                     "edges")
        for i, (kid, kind, mode) in enumerate(bwd_kinds):
            q = pna_args(kind, mode, ops, seed + i, device)[5]
            dx, dr, _ = check_bwd(kid, kind, mode, ops, q, label)
            if not (torch.all(dx[V - 5:] == 0) and torch.all(dr[R - 1] == 0)):
                raise AssertionError(f"{kid} wrote nonzero rows without "
                                     "edges")

    # hub rows (10^3, 10^4, 256 and 257 edges both ways, 40 duplicated
    # edges) with the dx pass's rel slice in shared memory (R = 7), and
    # R = 2,000, whose rel rows it gathers
    for seed, R, feats in ((14, 7, (10, 1028)), (15, 2000, (132,))):
        for F in feats:
            for kid, kind, mode in bwd_kinds:
                check_pna_hub(kid, kind, mode, F, R, seed, device)
    # K6 and K7 on their hub rows (10^3 and 10^4 in-edges, 256 and 257, 40
    # duplicated edges, weight-0 edges, rows without edges): F = 10 the
    # scalar path, 1028 a ragged last slice, 2048 the training width; R =
    # 2,000 rel rows gathered (F = 13 scalar, 132 float4); a hub of 10^5
    for seed, R, feats in ((20, 7, (10, 1028, 2048)), (21, 2000, (13, 132))):
        for F in feats:
            check_fwd_hub(K6_K7_KINDS, F, R, seed, device)
    check_fwd_hub(K6_K7_KINDS, 64, 7, 22, device, hub=100000)

    # (b) the main path's shapes on the FB-sized graph: F = 16 x 32 (eval)
    # for the forwards, F = 64 x 32 (training) for all four
    entries = {}
    for F, which in ((EVAL_BATCH * CLASSIC_FEAT, "eval"),
                     (CLASSIC_TRAIN["batch"] * CLASSIC_FEAT, "train")):
        ops = pna_operands(und, F, seed=F, device=device)
        label = (f"{which} shape V={und.num_nodes} E={und.num_edges} "
                 f"R={und.num_relations} F={F}")
        timed = []
        for kid, kind, mode in fwd_kinds:
            out, err = check_fwd(kid, kind, mode, ops, label)
            del out
            timed.append((kid, mode, err,
                          lambda kind=kind, mode=mode: pna.pna_fwd_cuda(
                              kind, *ops, mode),
                          lambda kind=kind, mode=mode: pna.pna_fwd_plain(
                              kind, *ops, mode)))
        if which == "train":
            for i, (kid, kind, mode) in enumerate(bwd_kinds):
                q = pna_args(kind, mode, ops, F + i, device)[5]
                dx, dr, err = check_bwd(kid, kind, mode, ops, q, label)
                del dx, dr
                timed.append((kid, mode, err,
                              lambda kind=kind, mode=mode, q=q:
                              pna.pna_bwd_cuda(kind, *ops, q, mode),
                              lambda kind=kind, mode=mode, q=q:
                              pna.pna_bwd_plain(kind, *ops, q, mode)))
        torch.cuda.empty_cache()
        for kid, mode, err, kernel, plain in timed:
            ms = cuda_time_ms(kernel, 20)
            plain_ms = cuda_time_ms(plain, 3, warmup=1)
            bound_ms, bound_by = gather_bound_ms(kid, *ops[1:])
            log(f"[kernels] {kid} {mode} {label}: {ms:.4f} ms (plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}, "
                f"{bound_ms / ms:.1%} of it), library_ms: null (no single "
                "PyTorch call computes this function)")
            keys = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
            if kid in ("K6", "K7"):
                keys["plan"] = pna.pna_fwd_plan(
                    und.num_relations, F, und.num_nodes,
                    ops[0].seg_ptr.numel() - 1, mode,
                    "maxmin" if kid == "K6" else "addsq")
                log(f"[kernels] {kid} {mode} {label}: "
                    + plan_text(keys["plan"]))
            if mode != "mul_rel":  # the main path is distmult
                entries[kid].update({f"ms_{mode}_{which}": ms,
                                     f"max_abs_err_{mode}_{which}": err})
                continue
            if which == "train" and kid in ("K6b", "K7b") and (
                    mode == "mul_rel"):
                kind = "argext_pair" if kid == "K6b" else "moments"
                keys.update(pna_halves(kid, kind, mode, ops, label))
            if kid not in entries:
                source = ("rspmm_pna_fwd.cu" if kid in ("K6", "K7")
                          else "rspmm_pna_bwd.cu")
                entries[kid] = dict(
                    name=kid, route="cuda",
                    source=f"{PACKAGE}/csrc/{source}",
                    replaces="ultra_torchdrug_tpu/ops/rspmm_pallas.py:" + {
                        "K6": "1869", "K7": "1990", "K6b": "2453",
                        "K7b": "2453"}[kid],
                    launches=None, library_ms=None, **keys)
            elif which == "train":  # the forwards' second shape
                entries[kid].update({f"{k}_train": v for k, v in keys.items()})
        del ops
        torch.cuda.empty_cache()
    for kid, hub in phase_pna_hub(device).items():
        entries[kid].update(hub)
    F = CLASSIC_TRAIN["batch"] * CLASSIC_FEAT
    entries["K6"].update(phase_fwd_hub(device, K6_K7_KINDS[:2], F + 15))
    entries["K7"].update(phase_fwd_hub(device, K6_K7_KINDS[2:], F + 17))
    log('[kernels] kernels ["K6", "K7", "K6b", "K7b"]')
    return entries


# the forward kinds of csrc/rspmm_pna_fwd.cu and, for the extrema, the
# backward kind that gates on their planes
EXTREMA_BWD = {"maxmin": "argext_pair", "max": "argext", "min": "argext"}
FWD_ID = {"maxmin": "K6", "addsq": "K7", "max": "K4", "min": "K4"}
K4_KINDS = tuple((agg, mode) for agg in ("max", "min")
                 for mode in ("mul_rel", "add_rel"))
K6_K7_KINDS = (("maxmin", "mul_rel"), ("maxmin", "add_rel"),
               ("addsq", "mul_rel"))


def check_extrema_exact(kind: str, ops, mode: str, label: str) -> tuple:
    """K6 (``maxmin``) or K4 (``max``, ``min``) on ``ops`` (csr, w, rel, x)
    against its plain version: equal under == (a zero's sign may differ:
    fmaxf picks either of -0 and +0), two calls bitwise equal, rows without
    edges 0; then the round trip into its backward, K6b or K5: the card's
    planes through it give the plain backward's gradients on the plain
    planes within the backward's tolerance plus 8 fp32 ulps of each
    entry's absolute mass (the gate sees the same ties). Returns the
    planes."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_pna_cuda as pna

    kid, bwd = FWD_ID[kind], EXTREMA_BWD[kind]
    got = pna.pna_fwd_cuda(kind, *ops, mode)
    again = pna.pna_fwd_cuda(kind, *ops, mode)
    want = pna.pna_fwd_plain(kind, *ops, mode)
    torch.cuda.synchronize()
    csr = ops[0]
    no_dst = (csr.rowptr[1:] == csr.rowptr[:-1]).nonzero()
    name = f"{kid} {kind} {mode} {label}"
    for a, b, c in zip(got, again, want):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"{name}: two calls differ")
        if not torch.equal(a, c):
            raise AssertionError(f"{name}: differs from its plain version")
        if not torch.all(a[no_dst] == 0):
            raise AssertionError(f"{name}: rows without edges")
    del again
    gen = torch.Generator(device=ops[3].device).manual_seed(
        ops[3].shape[1] + 31)
    g = [torch.randn(ops[3].shape, generator=gen, device=ops[3].device)
         for _ in got]
    planes = tuple(t for pair in zip(g, got) for t in pair)
    plain = tuple(t for pair in zip(g, want) for t in pair)
    dx, dr = pna.pna_bwd_cuda(bwd, *ops, planes, mode)
    err = 0.0
    for a, b, mass in zip((dx, dr), pna.pna_bwd_plain(bwd, *ops, plain, mode),
                          pna_mass(bwd, *ops, plain, mode)):
        atol = max(1e-4, 1e-5 * b.abs().max().item())
        err = max(err, assert_mass_close(a, b, mass, 1e-5, atol,
                                         f"{name} -> {bwd}"))
    log(f"[kernels] {name}: equal to its plain version, bitwise equal "
        f"across two calls; -> {bwd} max_abs_err {err:.3g} within the mass "
        "tolerance")
    return got


def check_k7_mass(ops, label: str) -> float:
    """K7 on ``ops`` (csr, w, rel, x) against its plain sums taken in
    float64 (timing.py::k7_sums64; the fp32 plain version's index_add_ adds
    a hub row in atomics order on the card): K7's tolerance (1e-5) plus 8
    fp32 ulps of each entry's absolute mass (timing.py::k7_mass), two calls
    bitwise equal, rows without edges 0. Returns the largest difference."""
    from ultra_torchdrug_tpu_torch.diagnostics.timing import (
        k7_mass,
        k7_sums64,
    )
    from ultra_torchdrug_tpu_torch.ops import rspmm_pna_cuda as pna

    got = pna.pna_fwd_cuda("addsq", *ops, "mul_rel")
    again = pna.pna_fwd_cuda("addsq", *ops, "mul_rel")
    torch.cuda.synchronize()
    csr = ops[0]
    no_dst = (csr.rowptr[1:] == csr.rowptr[:-1]).nonzero()
    err = 0.0
    for a, b, want, mass, plane in zip(got, again, k7_sums64(*ops),
                                       k7_mass(*ops), ("s", "sq")):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"K7 {label}: two calls differ")
        err = max(err, assert_mass_close(a, want, mass, 1e-5, 1e-5,
                                         f"K7 {plane} {label}"))
        if not torch.all(a[no_dst] == 0):
            raise AssertionError(f"K7 {label}: rows without edges")
    log(f"[kernels] K7 {label}: max_abs_err {err:.3g} against the fp64 sums "
        "within the mass tolerance, bitwise equal across two calls")
    return err


def check_fwd_kind(kind: str, ops, mode: str, label: str) -> float:
    """K4 or K6 by check_extrema_exact (0 difference), K7 by
    check_k7_mass."""
    if kind == "addsq":
        return check_k7_mass(ops, label)
    check_extrema_exact(kind, ops, mode, label)
    return 0.0


def check_fwd_hub(kinds, F: int, R: int, seed: int, device,
                  hub: int = 10000):
    """K4, K6 or K7 (``kinds``: (kind, mode) pairs) on
    ops/rspmm_cuda.py::hub_operands' hub rows (destination hubs of ``hub``
    and 1,000 edges, rows of 256 and 257, 40 duplicated edges, weight-0
    edges, rows and a relation without edges, post-ReLU x) at width F with
    R relations, held by check_fwd_kind; logs each kind's layout."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_cuda, rspmm_pna_cuda

    csr, w = rspmm_cuda.hub_operands(seed, device, E=max(40000,
                                                         2 * hub + 20000),
                                     R=R, duplicated=40, hub=hub)
    V = csr.rowptr.numel() - 1
    gen = torch.Generator(device=device).manual_seed(seed + F)
    rel = torch.randn((R, F), generator=gen, device=device)
    x = torch.randn((V, F), generator=gen, device=device).clamp_(min=0)
    label = f"hub rows of {hub} edges R={R} F={F}"
    for kind, mode in kinds:
        check_fwd_kind(kind, (csr, w, rel, x), mode, label)
    for kind in dict(kinds):
        log(f"[kernels] {FWD_ID[kind]} {kind} {label}: "
            + plan_text(rspmm_pna_cuda.pna_fwd_plan(
                R, F, V, csr.seg_ptr.numel() - 1, kind=kind)))


def phase_fwd_hub(device, kinds, seed: int) -> dict:
    """K4, K6 or K7 (``kinds``, one kernel's (kind, mode) pairs, the main
    path's first) at F = 64 x 32 on bench.py's heavy-tailed KG
    (bench_kg_operands: its busiest destination row 107,150 edges), held
    by check_fwd_kind and timed; returns its entry's ``*_hub`` keys: the first
    pair's ms_hub, bound_ms_hub, bound_share_hub and plan_hub, the other
    pairs' ms and max_abs_err under their kind and mode."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_pna_cuda as pna

    F = CLASSIC_TRAIN["batch"] * CLASSIC_FEAT
    ops, label = bench_kg_operands(seed, device)
    csr, w, rel, x = ops
    out = {}
    for kind, mode in kinds:
        kid = FWD_ID[kind]
        err = check_fwd_kind(kind, ops, mode, label)
        torch.cuda.empty_cache()
        ms = cuda_time_ms(lambda: pna.pna_fwd_cuda(kind, *ops, mode), 20)
        bound_ms, _ = gather_bound_ms(kid, w, rel, x)
        plan = pna.pna_fwd_plan(rel.shape[0], F, x.shape[0],
                                csr.seg_ptr.numel() - 1, mode, kind)
        log(f"[kernels] {kid} {kind} {mode} {label}: {ms:.4f} ms (bound "
            f"{bound_ms:.4f} ms, {bound_ms / ms:.1%} of it); "
            f"{plan_text(plan)}")
        suffix = "".join(f"_{k}" for k in (kind, mode)
                         if k not in (kinds[0][0], "mul_rel")) + "_hub"
        out.update({f"ms{suffix}": ms, f"max_abs_err{suffix}": err})
        if (kind, mode) == kinds[0]:
            out.update(bound_ms_hub=bound_ms, bound_share_hub=bound_ms / ms,
                       plan_hub=plan)
    del ops, csr, w, rel, x
    torch.cuda.empty_cache()
    return out


def pna_args(kind: str, mode: str, ops, seed: int, device,
             agg: str = "max") -> tuple:
    """K6b's (``argext_pair``), K7b's (``moments``) or K5's (``argext``,
    of the extremum ``agg``) arguments on ``ops`` (csr, w, rel, x): the
    planes K6's or K4's own outputs (so that the gates fire on the card's
    bits) and seeded gradients."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_pna_cuda as pna

    csr, w, rel, x = ops
    gen = torch.Generator(device=device).manual_seed(seed)
    g = [torch.randn(x.shape, generator=gen, device=device) for _ in range(2)]
    if kind == "moments":
        planes = tuple(g)
    elif kind == "argext":
        planes = (g[0], *pna.pna_fwd_cuda(agg, csr, w, rel, x, mode))
    else:
        mx, mn = pna.pna_fwd_cuda("maxmin", csr, w, rel, x, mode)
        planes = (g[0], mx, g[1], mn)
    return (kind, csr, w, rel, x, planes, mode)


def check_pna_mass(kid: str, args, label: str) -> float:
    """K6b, K7b or K5 on ``args`` (pna_args) against its plain version: the
    backward's tolerance plus 8 fp32 ulps of each entry's absolute mass,
    two calls bitwise equal, each half alone equal to the whole, rows and
    relations without edges 0. Returns the largest difference."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_pna_cuda as pna

    dx, dr = pna.pna_bwd_cuda(*args)
    dx2, dr2 = pna.pna_bwd_cuda(*args)
    torch.cuda.synchronize()
    if not (torch.equal(dx, dx2) and torch.equal(dr, dr2)):
        raise AssertionError(f"{kid} {label}: two calls differ")
    del dx2, dr2
    err = 0.0
    for got, want, mass in zip((dx, dr), pna.pna_bwd_plain(*args),
                               pna_mass(*args)):
        atol = max(1e-4, 1e-5 * want.abs().max().item())
        err = max(err, assert_mass_close(got, want, mass, 1e-5, atol,
                                         f"{kid} {label}"))
    csr = args[1]
    no_src = (csr.src_rowptr[1:] == csr.src_rowptr[:-1]).nonzero()
    no_rel = (csr.tile_rel_ptr[1:] == csr.tile_rel_ptr[:-1]).nonzero()
    if not (torch.all(dx[no_src] == 0) and torch.all(dr[no_rel] == 0)):
        raise AssertionError(f"{kid} {label}: rows without edges")
    if not (torch.equal(pna.pna_bwd_cuda(*args, need_dr=False)[0], dx)
            and torch.equal(pna.pna_bwd_cuda(*args, need_dx=False)[1], dr)):
        raise AssertionError(f"{kid} {label}: a half alone differs")
    return err


def check_pna_hub(kid: str, kind: str, mode: str, F: int, R: int, seed: int,
                  device, agg: str = "max") -> float:
    """K6b, K7b or K5 (of ``agg``) on ops/rspmm_cuda.py::hub_operands' hub
    rows with 40 duplicated edges (post-ReLU x, so that messages tie) at
    width F with R relations, held by check_pna_mass; logs the passes'
    layouts."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_cuda, rspmm_pna_cuda

    csr, w = rspmm_cuda.hub_operands(seed, device, R=R, duplicated=40)
    V = csr.src_rowptr.numel() - 1
    gen = torch.Generator(device=device).manual_seed(seed + F)
    rel = torch.randn((R, F), generator=gen, device=device)
    x = torch.randn((V, F), generator=gen, device=device).clamp_(min=0)
    label = (f"{agg} " if kind == "argext" else "") + (
        f"{mode} hub rows R={R} F={F}")
    err = check_pna_mass(kid, pna_args(kind, mode, (csr, w, rel, x),
                                       seed + 1, device, agg), label)
    plan = rspmm_pna_cuda.pna_bwd_plan(kind, csr, F, mode)
    log(f"[kernels] {kid} {label}: max_abs_err {err:.3g} within the mass "
        f"tolerance, bitwise equal across two calls and by half; dx pass "
        f"{plan_text(plan['dx'])}; dr pass {plan_text(plan['dr'])}")
    return err


def pna_halves(kid: str, kind: str, mode: str, ops, label: str) -> dict:
    """K6b's, K7b's or K5's halves each alone on ``ops`` (csr, w, rel, x)
    with their bounds, the passes' layouts (key ``plan``) and, for K6b, the
    share of its g_mx and g_mn loads (a thread's 4 features) in which no
    feature passes its gate."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_pna_cuda as pna

    args = pna_args(kind, mode, ops, ops[3].shape[1] + 7, ops[1].device)
    out = pna_half_times(lambda need_dx, need_dr: pna.pna_bwd_cuda(
        *args, need_dx, need_dr), kid, *ops[1:])
    if kind == "argext_pair":
        out["gate_skip_share"] = gate_skip_share(*args[1:6], mode)
    plan = pna.pna_bwd_plan(kind, ops[0], ops[3].shape[1], mode)
    out["plan"] = plan
    log(f"[kernels] {kid} {mode} {label}: dx half {out['ms_dx']:.4f} ms "
        f"(bound {out['bound_ms_dx']:.4f}; {plan_text(plan['dx'])}), dr half "
        f"{out['ms_dr']:.4f} ms (bound {out['bound_ms_dr']:.4f}; "
        f"{plan_text(plan['dr'])})"
        + (f"; g_mx/g_mn loads no gate passes: {out['gate_skip_share']:.1%}"
           if "gate_skip_share" in out else ""))
    return out


def bench_kg_operands(seed: int, device, relu: bool = True):
    """Operands at F = 64 x 32 on bench.py's heavy-tailed KG
    (diagnostics/workloads.py::build_workload, its busiest source row
    107,336 edges, destination row 107,150): (csr with its backward
    layouts, weights in [0.5, 1.5] with a fifth masked to 0, rel [R, F],
    x [V, F], post-ReLU where ``relu``), and the KG's label."""
    from ultra_torchdrug_tpu_torch.data.graph import build_csr
    from ultra_torchdrug_tpu_torch.diagnostics.workloads import build_workload

    tri, _, _ = build_workload(features=False)
    V, R, E = 15000, 474, len(tri)
    csr = build_csr(tri[:, 0], tri[:, 1], tri[:, 2], V, R,
                    backward=True).to(device)
    F = CLASSIC_TRAIN["batch"] * CLASSIC_FEAT
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.rand((E,), generator=gen, device=device) + 0.5
    w = w * (torch.rand((E,), generator=gen, device=device) >= 0.2)
    rel = torch.randn((R, F), generator=gen, device=device)
    x = torch.randn((V, F), generator=gen, device=device)
    if relu:
        x.clamp_(min=0)
    return (csr, w, rel, x), f"bench.py's KG V={V} E={E} R={R} F={F}"


PNA_HUB_KINDS = (("K6b", "argext_pair", "mul_rel"),
                 ("K6b", "argext_pair", "add_rel"),
                 ("K7b", "moments", "mul_rel"))
K5_HUB_KINDS = (("K5", "argext", "mul_rel"), ("K5", "argext", "add_rel"))


def phase_pna_hub(device, kinds=PNA_HUB_KINDS) -> dict:
    """K6b (both modes) and K7b, or K5 (both modes, of K4's max), at
    F = 64 x 32 on bench.py's heavy-tailed KG (bench_kg_operands), held by
    check_pna_mass and timed, whole and by half; returns their entries'
    ``*_hub`` keys."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_pna_cuda as pna

    F = CLASSIC_TRAIN["batch"] * CLASSIC_FEAT
    ops, label = bench_kg_operands(F + 10, device)
    csr, w, rel, x = ops
    out = {kid: {} for kid, _, _ in kinds}
    for kid, kind, mode in kinds:
        args = pna_args(kind, mode, ops, F + 11, device)
        err = check_pna_mass(kid, args, f"{mode} {label}")
        torch.cuda.empty_cache()
        ms = cuda_time_ms(lambda: pna.pna_bwd_cuda(*args), 20)
        bound_ms, _ = gather_bound_ms(kid, w, rel, x)
        log(f"[kernels] {kid} {mode} {label}: max_abs_err {err:.3g} within "
            f"the mass tolerance, {ms:.4f} ms (bound {bound_ms:.4f} ms, "
            f"{bound_ms / ms:.1%} of it)")
        del args
        keys = dict(ms=ms, max_abs_err=err)
        if mode == "mul_rel":
            keys.update(bound_ms=bound_ms,
                        **pna_halves(kid, kind, mode, ops, label))
        suffix = "_hub" if mode == "mul_rel" else f"_{mode}_hub"
        out[kid].update({f"{k}{suffix}": v for k, v in keys.items()})
    del ops, csr, rel, x
    torch.cuda.empty_cache()
    return out


def k3_halves(args, label: str) -> dict:
    """K3's dx and dr halves each alone, beside torch.sparse.mm's halves on
    the same operands (each half checked against its library half)."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda

    csr, w, grad = args[0], args[1], args[4]
    at, t = sparse_mm_halves(csr, w)
    dx, dr = rspmm_bwd_cuda.rspmm_bwd_cuda(*args, mode="add_rel")
    assert_bwd_close(torch.sparse.mm(at, grad), dx)
    assert_bwd_close(torch.sparse.mm(t, grad), dr)
    del dx, dr
    out = k3_half_times(
        lambda need_dx, need_dr: rspmm_bwd_cuda.rspmm_bwd_cuda(
            *args, need_dx, need_dr, mode="add_rel"),
        at, t, grad, w.numel())
    log(f"[kernels] K3 {label}: dx half {out['ms_dx']:.4f} ms (bound "
        f"{out['bound_ms_dx']:.4f}), dr half {out['ms_dr']:.4f} ms (bound "
        f"{out['bound_ms_dr']:.4f}); library torch.sparse.mm (coalesced "
        f"CSR) dx half {out['library_ms_dx']:.4f} ms + dr half "
        f"{out['library_ms_dr']:.4f} ms = {out['library_ms']:.4f} ms")
    return out


def phase_k3_hub(device) -> dict:
    """K3 at F = 64 x 32 on bench.py's heavy-tailed KG
    (diagnostics/workloads.py::build_workload, edges head -> tail, its
    busiest source row 107,336 edges), held against its plain version
    (bitwise across two calls) and timed, whole and by half, beside
    torch.sparse.mm; returns the K3 entry's ``*_hub`` keys."""
    from ultra_torchdrug_tpu_torch.data.graph import build_csr
    from ultra_torchdrug_tpu_torch.diagnostics.workloads import build_workload
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda

    tri, _, _ = build_workload(features=False)
    V, R = 15000, 474
    csr = build_csr(tri[:, 0], tri[:, 1], tri[:, 2], V, R,
                    backward=True).to(device)
    F = CLASSIC_TRAIN["batch"] * CLASSIC_FEAT
    gen = torch.Generator(device=device).manual_seed(F + 8)
    w = torch.rand((len(tri),), generator=gen, device=device) + 0.5
    w = w * (torch.rand((len(tri),), generator=gen, device=device) >= 0.2)
    args = (csr, w, torch.zeros((R, F), device=device), None,
            torch.randn((V, F), generator=gen, device=device))
    label = f"bench.py's KG V={V} E={len(tri)} R={R} F={F}"
    _, _, err = check_bwd_kernel(
        "K3", lambda: rspmm_bwd_cuda.rspmm_bwd_cuda(*args, mode="add_rel"),
        lambda: rspmm_bwd_cuda.rspmm_bwd_plain(*args, mode="add_rel"), label)
    torch.cuda.empty_cache()
    ms = cuda_time_ms(lambda: rspmm_bwd_cuda.rspmm_bwd_cuda(
        *args, mode="add_rel"), 20)
    log(f"[kernels] K3 {label}: {ms:.4f} ms")
    halves = k3_halves(args, label)
    out = dict(ms_hub=ms, max_abs_err_hub=err,
               **{f"{k}_hub": v for k, v in halves.items()})
    del args, csr
    torch.cuda.empty_cache()
    return out


def phase_kernels_ext(und, device) -> dict:
    """K4 (one extremum), K5 (its argext backward) and K3 (the transe
    backward) against their plain versions; returns their kernels-line
    entries by id (without the main path's launch counts)."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda
    from ultra_torchdrug_tpu_torch.ops import rspmm_pna_cuda as pna

    def check_k4(agg, mode, ops, label):
        (got,) = pna.pna_fwd_cuda(agg, *ops, mode)
        (want,) = pna.pna_fwd_plain(agg, *ops, mode)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K4 {agg} {mode} {label}: differs from its "
                                 "plain version")
        err = (got - want).abs().max().item()
        log(f"[kernels] K4 {agg} {mode} {label}: equal to its plain version "
            f"(max_abs_err {err:.3g})")
        return got, err

    def k5_planes(agg, mode, ops, seed):
        """K5's planes: the card's own K4 output (so the gates fire on the
        card's bits, ties included) and a seeded gradient."""
        gen = torch.Generator(device=device).manual_seed(seed)
        g = torch.randn(ops[3].shape, generator=gen, device=device)
        return g, pna.pna_fwd_cuda(agg, *ops, mode)[0]

    def k3_args(ops, seed):
        csr, w, rel, x = ops
        gen = torch.Generator(device=device).manual_seed(seed)
        return csr, w, rel, None, torch.randn(x.shape, generator=gen,
                                              device=device)

    # (a) small and ragged shapes, as for the PNA kernels
    for label, V, R, seed, ops in ragged_gather_cases(3, device):
        for i, (agg, mode) in enumerate(
                (a, m) for a in ("max", "min") for m in ("mul_rel", "add_rel")):
            out, _ = check_k4(agg, mode, ops, label)
            q = k5_planes(agg, mode, ops, seed=seed + i)
            dx, dr, _ = check_bwd_kernel(
                "K5", lambda: pna.pna_bwd_cuda("argext", *ops, q, mode),
                lambda: pna.pna_bwd_plain("argext", *ops, q, mode),
                f"{agg} {mode} {label}")
            if not (torch.all(out[V - 5:] == 0) and torch.all(dx[V - 5:] == 0)
                    and torch.all(dr[R - 1] == 0)):
                raise AssertionError("K4/K5 wrote nonzero rows without edges")
        args = k3_args(ops, seed=seed)
        dx, dr, _ = check_bwd_kernel(
            "K3",
            lambda: rspmm_bwd_cuda.rspmm_bwd_cuda(*args, mode="add_rel"),
            lambda: rspmm_bwd_cuda.rspmm_bwd_plain(*args, mode="add_rel"),
            label)
        if not (torch.all(dx[V - 5:] == 0) and torch.all(dr[R - 1] == 0)):
            raise AssertionError("K3 wrote nonzero rows without edges")
    # K5 on hub rows (10^3, 10^4, 256 and 257 edges both ways, 40
    # duplicated edges) with the dx pass's rel slice in shared memory
    # (R = 7), and R = 2,000, whose rel rows it gathers
    for seed, R, feats in ((24, 7, (10, 1028)), (25, 2000, (132,))):
        for F in feats:
            for agg in ("max", "min"):
                for mode in ("mul_rel", "add_rel"):
                    check_pna_hub("K5", "argext", mode, F, R, seed, device,
                                  agg)
    # K4 (max and min, both modes) on its hub rows, as K6 on its: 10^3 and
    # 10^4 in-edges, 256 and 257, duplicated and weight-0 edges, rows
    # without edges; F = 10, 1028, 2048, and 13, 132 with R = 2,000 (rel
    # rows gathered); a hub of 10^5; each through K5 to the plain gradients
    for seed, R, feats in ((26, 7, (10, 1028, 2048)), (27, 2000, (13, 132))):
        for F in feats:
            check_fwd_hub(K4_KINDS, F, R, seed, device)
    check_fwd_hub(K4_KINDS, 64, 7, 28, device, hub=100000)
    # K3's segments (a 700-edge row) and its (destination tile, relation)
    # chunks across three tiles
    for F in (10, 64, 1028, 2048):
        args = rspmm_bwd_cuda.transe_ragged_operands(F, seed=F,
                                                     device=device)
        dx, dr, _ = check_bwd_kernel(
            "K3",
            lambda: rspmm_bwd_cuda.rspmm_bwd_cuda(*args, mode="add_rel"),
            lambda: rspmm_bwd_cuda.rspmm_bwd_plain(*args, mode="add_rel"),
            f"layouts V=5000 E=2700 R=4 F={F} (a 700-edge row)")
        halves = [rspmm_bwd_cuda.rspmm_bwd_cuda(*args, need_dr=False,
                                                mode="add_rel")[0],
                  rspmm_bwd_cuda.rspmm_bwd_cuda(*args, need_dx=False,
                                                mode="add_rel")[1]]
        if not (torch.all(dx[-5:] == 0) and torch.all(dr[-1] == 0)
                and torch.equal(halves[0], dx)
                and torch.equal(halves[1], dr)):
            raise AssertionError("K3: rows without edges nonzero, or a half "
                                 "alone differs from the whole")

    # (b) the main path's shapes on the FB-sized graph: K4 at F = 16 x 32
    # (eval) and 64 x 32 (training), K5 and K3 at the training width
    entries = {}

    def entry(kid, source, replaces, err, ms, plain_ms, bound, library_ms,
              **extra):
        entries[kid] = dict(
            name=kid, route="cuda", source=f"{PACKAGE}/csrc/{source}",
            replaces=f"ultra_torchdrug_tpu/ops/rspmm_pallas.py:{replaces}",
            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], library_ms=library_ms,
            **extra)

    def timed(kid, label, kernel, plain, ops, iters=20):
        ms = cuda_time_ms(kernel, iters)
        plain_ms = cuda_time_ms(plain, 3, warmup=1)
        bound = gather_bound_ms(kid, *ops[1:])
        log(f"[kernels] {kid} {label}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
            f"bound {bound[0]:.4f} ms by {bound[1]}, {bound[0] / ms:.1%} of "
            "it)")
        return ms, plain_ms, bound

    for F, which in ((EVAL_BATCH * CLASSIC_FEAT, "eval"),
                     (CLASSIC_TRAIN["batch"] * CLASSIC_FEAT, "train")):
        ops = pna_operands(und, F, seed=F + 7, device=device)
        label = (f"{which} shape V={und.num_nodes} E={und.num_edges} "
                 f"R={und.num_relations} F={F}")
        errs = {}
        for agg in ("max", "min"):
            for mode in ("mul_rel", "add_rel"):
                out, errs[agg, mode] = check_k4(agg, mode, ops, label)
                del out
        torch.cuda.empty_cache()
        for mode in ("mul_rel", "add_rel"):
            ms, plain_ms, bound = timed(
                "K4", f"max {mode} {label}",
                lambda mode=mode: pna.pna_fwd_cuda("max", *ops, mode),
                lambda mode=mode: pna.pna_fwd_plain("max", *ops, mode), ops)
            plan = pna.pna_fwd_plan(und.num_relations, F, und.num_nodes,
                                    ops[0].seg_ptr.numel() - 1, mode, "max")
            log(f"[kernels] K4 max {mode} {label}: {plan_text(plan)}")
            if mode != "mul_rel":  # the main path is distmult max
                entries["K4"][f"ms_{mode}_{which}"] = ms
            elif which == "eval":
                entry("K4", "rspmm_pna_fwd.cu", 1681, max(errs.values()), ms,
                      plain_ms, bound, None, plan=plan)
            else:
                entries["K4"].update(
                    max_abs_err_train=max(errs.values()), ms_train=ms,
                    plain_ms_train=plain_ms, bound_ms_train=bound[0],
                    bound_by_train=bound[1], plan_train=plan)
        if which == "eval":
            del ops
            torch.cuda.empty_cache()
            continue
        # K5 on the card's own K4 output, both modes
        for i, mode in enumerate(("mul_rel", "add_rel")):
            q = k5_planes("max", mode, ops, seed=F + i)
            dx, dr, err = check_bwd_kernel(
                "K5", lambda: pna.pna_bwd_cuda("argext", *ops, q, mode),
                lambda: pna.pna_bwd_plain("argext", *ops, q, mode),
                f"max {mode} {label}")
            del dx, dr
            torch.cuda.empty_cache()
            ms, plain_ms, bound = timed(
                "K5", f"max {mode} {label}",
                lambda: pna.pna_bwd_cuda("argext", *ops, q, mode),
                lambda: pna.pna_bwd_plain("argext", *ops, q, mode), ops)
            if mode == "mul_rel":
                entry("K5", "rspmm_pna_bwd.cu", 2316, err, ms, plain_ms,
                      bound, None, replaces_k5b="ultra_torchdrug_tpu/ops/"
                                                "rspmm_pallas.py:2453",
                      **pna_halves("K5", "argext", mode, ops, label))
            else:
                entries["K5"].update({f"ms_{mode}": ms,
                                      f"max_abs_err_{mode}": err})
            del q
        # K3, and its function as two torch.sparse.mm calls, each half
        # alone beside its library half
        args = k3_args(ops, seed=F + 5)
        dx, dr, err = check_bwd_kernel(
            "K3", lambda: rspmm_bwd_cuda.rspmm_bwd_cuda(*args, mode="add_rel"),
            lambda: rspmm_bwd_cuda.rspmm_bwd_plain(*args, mode="add_rel"),
            label)
        del dx, dr
        torch.cuda.empty_cache()
        ms, plain_ms, bound = timed(
            "K3", label,
            lambda: rspmm_bwd_cuda.rspmm_bwd_cuda(*args, mode="add_rel"),
            lambda: rspmm_bwd_cuda.rspmm_bwd_plain(*args, mode="add_rel"), ops)
        halves = k3_halves(args, label)
        entry("K3", "rspmm_transe_bwd.cu", 1681, err, ms, plain_ms, bound,
              halves["library_ms"], **{k: v for k, v in halves.items()
                                       if k != "library_ms"},
              library_call="torch.sparse.mm twice: dx = A^T g, dr = T g",
              mode="none, called by rspmm_bwd_pallas at :2816-2834")
        del ops, args
        torch.cuda.empty_cache()
    entries["K3"].update(phase_k3_hub(device))
    entries["K5"].update(phase_pna_hub(device, K5_HUB_KINDS)["K5"])
    entries["K4"].update(phase_fwd_hub(
        device, K4_KINDS, CLASSIC_TRAIN["batch"] * CLASSIC_FEAT + 16))
    log('[kernels] kernels ["K4", "K5", "K3"]')
    return entries


def rotate_operands(graph, batch: int, dim: int, shared: bool, seed: int,
                    device):
    """K8f's and K8b's operands on ``graph`` (with its backward layouts):
    x and g [V, batch·dim] ~ N(0, 1), rel [R, batch·dim] per batch or a
    shared [R, dim] broadcast to every query (broadcast_rel_flat), and edge
    weights in [0.5, 1.5] with a fifth masked to 0. Returns (csr, w, rel, x,
    g)."""
    from ultra_torchdrug_tpu_torch.ops.rspmm import broadcast_rel_flat

    gen = torch.Generator(device=device).manual_seed(seed)
    V, R, E = graph.num_nodes, graph.num_relations, graph.num_edges
    F = batch * dim
    x = torch.randn((V, F), generator=gen, device=device)
    rel = torch.randn((R, dim) if shared else (R, F), generator=gen,
                      device=device)
    rel = broadcast_rel_flat(rel, batch).contiguous() if shared else rel
    w = torch.rand((E,), generator=gen, device=device) + 0.5
    w = w * (torch.rand((E,), generator=gen, device=device) >= 0.2)
    g = torch.randn((V, F), generator=gen, device=device)
    return graph.csr.to(device), w, rel, x, g


def k8b_args(ops, dim: int, seed: int, device) -> tuple:
    """K8b's arguments on ``ops`` (csr, w, rel, x) with a seeded gradient g
    and blocks of ``dim``: (csr, w, rel, x, g, dim)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return (*ops, torch.randn(ops[3].shape, generator=gen, device=device),
            dim)


def check_k8b_mass(args, label: str) -> float:
    """K8b on ``args`` (k8b_args) against its plain version: dx within K2's
    tolerance, dr within K3's, each plus 8 fp32 ulps of each entry's
    absolute mass (timing.py::rotate_mass), two calls bitwise equal, each
    half alone equal to the whole, rows and relations without edges 0.
    Returns the largest difference."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda as bwd

    dx, dr = bwd.rotate_bwd_cuda(*args)
    dx2, dr2 = bwd.rotate_bwd_cuda(*args)
    torch.cuda.synchronize()
    if not (torch.equal(dx, dx2) and torch.equal(dr, dr2)):
        raise AssertionError(f"K8b {label}: two calls differ")
    del dx2, dr2
    err = 0.0
    want = bwd.rotate_bwd_plain(*args)
    for got, want_half, mass, atol in zip(
            (dx, dr), want, rotate_mass(*args),
            (1e-4, max(1e-4, 1e-5 * want[1].abs().max().item()))):
        err = max(err, assert_mass_close(got, want_half, mass, 1e-5, atol,
                                         f"K8b {label}"))
    del want
    csr = args[0]
    no_src = (csr.src_rowptr[1:] == csr.src_rowptr[:-1]).nonzero()
    no_rel = (csr.tile_rel_ptr[1:] == csr.tile_rel_ptr[:-1]).nonzero()
    if not (torch.all(dx[no_src] == 0) and torch.all(dr[no_rel] == 0)):
        raise AssertionError(f"K8b {label}: rows without edges")
    if not (torch.equal(bwd.rotate_bwd_cuda(*args, need_dr=False)[0], dx)
            and torch.equal(bwd.rotate_bwd_cuda(*args, need_dx=False)[1],
                            dr)):
        raise AssertionError(f"K8b {label}: a half alone differs")
    return err


def check_k8b_hub(F: int, dim: int, R: int, seed: int, device,
                  hub: int = 10000) -> float:
    """K8b on ops/rspmm_cuda.py::hub_operands' hub rows (source hubs of
    ``hub`` and 1,000 edges, 40 duplicated edges) at width F, blocks of
    ``dim``, R relations, held by check_k8b_mass; logs the passes'
    layouts."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda, rspmm_cuda

    E = max(40000, 2 * hub + 20000)
    csr, w = rspmm_cuda.hub_operands(seed, device, E=E, R=R, duplicated=40,
                                     hub=hub)
    V = csr.src_rowptr.numel() - 1
    gen = torch.Generator(device=device).manual_seed(seed + F)
    ops = (csr, w, torch.randn((R, F), generator=gen, device=device),
           torch.randn((V, F), generator=gen, device=device))
    label = f"hub rows of {hub} edges R={R} F={F} D={dim}"
    err = check_k8b_mass(k8b_args(ops, dim, seed + 1, device), label)
    plan = rspmm_bwd_cuda.k8b_plan(csr, F, dim)
    log(f"[kernels] K8b {label}: max_abs_err {err:.3g} within the mass "
        f"tolerance, bitwise equal across two calls and by half; dx pass "
        f"{plan_text(plan['dx'])}; dr pass {plan_text(plan['dr'])}")
    return err


def check_k8f_mass(ops, dim: int, label: str) -> float:
    """K8f on ``ops`` (csr, w, rel, x) with blocks of ``dim`` against its
    plain version: assert_fwd_close's tolerance plus 8 fp32 ulps of each
    entry's absolute mass (timing.py::k8f_mass), two calls bitwise equal,
    rows without in-edges 0. Returns the largest difference."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_cuda as fwd

    csr, w, rel, x = ops[:4]
    args = (*k1_operands_of(ops), rel, x)
    out = fwd.rotate_fwd_cuda(*args, dim, segments=csr.segments)
    out2 = fwd.rotate_fwd_cuda(*args, dim, segments=csr.segments)
    torch.cuda.synchronize()
    if not torch.equal(out, out2):
        raise AssertionError(f"K8f {label}: two calls differ")
    del out2
    want = fwd.rspmm_fwd_plain(*args, "rot_rel", dim)
    err = assert_mass_close(out, want, k8f_mass(args, dim), 1e-5,
                            1e-5 * max(1.0, want.abs().max().item()),
                            f"K8f {label}")
    no_dst = (csr.rowptr[1:] == csr.rowptr[:-1]).nonzero()
    if not torch.all(out[no_dst] == 0):
        raise AssertionError(f"K8f {label}: rows without edges")
    return err


def check_k8f_hub(F: int, dim: int, R: int, seed: int, device,
                  hub: int = 10000) -> float:
    """K8f on ops/rspmm_cuda.py::hub_operands' hub rows (destination hubs of
    ``hub`` and 1,000 edges, 40 duplicated edges) at width F, blocks of
    ``dim``, R relations, held by check_k8f_mass; logs the layout."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_cuda

    E = max(40000, 2 * hub + 20000)
    csr, w = rspmm_cuda.hub_operands(seed, device, E=E, R=R, duplicated=40,
                                     hub=hub)
    V = csr.rowptr.numel() - 1
    gen = torch.Generator(device=device).manual_seed(seed + F)
    ops = (csr, w, torch.randn((R, F), generator=gen, device=device),
           torch.randn((V, F), generator=gen, device=device))
    label = f"hub rows of {hub} edges R={R} F={F} D={dim}"
    err = check_k8f_mass(ops, dim, label)
    plan = rspmm_cuda.k8f_plan(R, F, V, csr.seg_ptr.numel() - 1, dim)
    log(f"[kernels] K8f {label}: max_abs_err {err:.3g} within the mass "
        f"tolerance, bitwise equal across two calls; {plan_text(plan)}")
    return err


def k8b_halves(args, label: str) -> dict:
    """K8b's halves each alone on ``args`` (k8b_args) with their bounds and
    the passes' layouts (key ``plan``)."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda as bwd

    csr, w, rel, x, _, dim = args
    out = pna_half_times(lambda need_dx, need_dr: bwd.rotate_bwd_cuda(
        *args, need_dx, need_dr), "K8b", w, rel, x)
    out["plan"] = plan = bwd.k8b_plan(csr, x.shape[1], dim)
    log(f"[kernels] K8b {label}: dx half {out['ms_dx']:.4f} ms (bound "
        f"{out['bound_ms_dx']:.4f}; {plan_text(plan['dx'])}), dr half "
        f"{out['ms_dr']:.4f} ms (bound {out['bound_ms_dr']:.4f}; "
        f"{plan_text(plan['dr'])})")
    return out


def phase_rotate_hub(device) -> tuple:
    """K8f and K8b at F = 64 x 32, D = 32 on bench.py's heavy-tailed KG
    (bench_kg_operands: its busiest destination row 107,150 edges, source
    row 107,336), held by check_k8f_mass and check_k8b_mass and timed, K8b
    whole and by half; returns their entries' ``*_hub`` keys."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda as bwd
    from ultra_torchdrug_tpu_torch.ops import rspmm_cuda as fwd

    F = CLASSIC_TRAIN["batch"] * CLASSIC_FEAT
    ops, label = bench_kg_operands(F + 12, device, relu=False)
    csr, w, rel, x = ops
    k8f_err = check_k8f_mass(ops, CLASSIC_FEAT, label)
    torch.cuda.empty_cache()
    k8f_ms = cuda_time_ms(lambda: fwd.rotate_fwd_cuda(
        *k1_operands_of(ops), rel, x, CLASSIC_FEAT, segments=csr.segments),
        20)
    k8f_bound, _ = gather_bound_ms("K8f", w, rel, x)
    plan = fwd.k8f_plan(rel.shape[0], F, x.shape[0],
                        csr.seg_ptr.numel() - 1, CLASSIC_FEAT)
    log(f"[kernels] K8f {label}: max_abs_err {k8f_err:.3g} within the mass "
        f"tolerance, bitwise equal across two calls, {k8f_ms:.4f} ms (bound "
        f"{k8f_bound:.4f} ms, {k8f_bound / k8f_ms:.1%} of it); "
        f"{plan_text(plan)}")
    args = k8b_args(ops, CLASSIC_FEAT, F + 13, device)
    err = check_k8b_mass(args, label)
    torch.cuda.empty_cache()
    ms = cuda_time_ms(lambda: bwd.rotate_bwd_cuda(*args), 20)
    bound_ms, _ = gather_bound_ms("K8b", *ops[1:])
    log(f"[kernels] K8b {label}: max_abs_err {err:.3g} within the mass "
        f"tolerance, {ms:.4f} ms (bound {bound_ms:.4f} ms, "
        f"{bound_ms / ms:.1%} of it)")
    keys = dict(ms=ms, max_abs_err=err, bound_ms=bound_ms,
                **k8b_halves(args, label))
    del args, ops, csr, w, rel, x
    torch.cuda.empty_cache()
    return (dict(ms_hub=k8f_ms, max_abs_err_hub=k8f_err,
                 bound_ms_hub=k8f_bound, plan_hub=plan),
            {f"{k}_hub": v for k, v in keys.items()})


def assert_fwd_close(got, want):
    """K1's tolerance, the absolute one 1e-5 of the result's largest entry:
    nvcc contracts the complex product's a·b − c·d into an FMA, which the
    plain version rounds twice."""
    atol = 1e-5 * max(1.0, want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


def phase_kernels_rotate(und, device) -> dict:
    """K8f (the rotate forward) and K8b (its backward) against their plain
    versions; returns their kernels-line entries by id (without the main
    path's launch counts)."""
    from ultra_torchdrug_tpu_torch.data.graph import Graph
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda as bwd
    from ultra_torchdrug_tpu_torch.ops import rspmm_cuda as fwd

    def k8f(ops, dim):
        csr, w, rel, x, _ = ops
        return (lambda: fwd.rotate_fwd_cuda(csr.rowptr, csr.src, csr.etype,
                                            csr.eid, w, rel, x, dim,
                                            segments=csr.segments),
                lambda: fwd.rspmm_fwd_plain(csr.rowptr, csr.src, csr.etype,
                                            csr.eid, w, rel, x, "rot_rel",
                                            dim))

    def k8b(ops, dim):
        return (lambda: bwd.rotate_bwd_cuda(*ops, dim),
                lambda: bwd.rotate_bwd_plain(*ops, dim))

    def check_fwd(ops, dim, label):
        kernel, plain = k8f(ops, dim)
        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"K8f {label}: two calls differ")
        assert_fwd_close(got, want)
        err = (got - want).abs().max().item()
        log(f"[kernels] K8f {label}: max_abs_err {err:.3g}, bitwise equal "
            "across two calls")
        return got, err

    def check_bwd(ops, dim, label):
        kernel, plain = k8b(ops, dim)
        return check_bwd_kernel(
            "K8b", kernel, plain, label,
            dx_close=lambda a, b: torch.testing.assert_close(
                a, b, rtol=1e-5, atol=1e-4))

    # (a) small and ragged shapes, (V, E, R, B, D): D/2 = 3, 5 and 6 take
    # the scalar path, 4 and 16 the float4 path; B·D = 600 and 2080 need two
    # feature tiles; the last 5 rows neither send nor receive an edge, the
    # last relation has none; the (60, 1400, 3) graph has three chunks per
    # relation; odd cases share one relation across the batch
    rng = np.random.default_rng(5)
    for i, (V, E, R, B, D) in enumerate(
            ((37, 300, 6, 3, 6), (37, 300, 6, 2, 32), (37, 300, 6, 60, 10),
             (37, 300, 6, 65, 32), (50, 20, 3, 2, 12), (60, 1400, 3, 4, 8))):
        tri = np.stack([rng.integers(0, V - 5, E), rng.integers(0, V - 5, E),
                        rng.integers(0, R - 1, E)], 1)
        g = Graph.from_triplets(tri, V, R).prepare_csr(backward=True)
        shared = i % 2 == 1
        ops = rotate_operands(g, B, D, shared, seed=V + B * D, device=device)
        label = (f"V={V} E={E} R={R} B={B} D={D} "
                 f"{'shared' if shared else 'per-batch'} relation")
        out, _ = check_fwd(ops, D, label)
        dx, dr, _ = check_bwd(ops, D, label)
        if not (torch.all(out[V - 5:] == 0) and torch.all(dx[V - 5:] == 0)
                and torch.all(dr[R - 1] == 0)):
            raise AssertionError("K8f/K8b wrote nonzero rows without edges")
    # K8f and K8b on hub rows (10^3, 10^4, 256 and 257 edges both ways, 40
    # duplicated edges) with the rel slice in shared memory (R = 7) and
    # R = 2,000, whose rel rows they gather: D = 32 (a slice two blocks),
    # 128 (half a block's real and imaginary parts), 6 (the scalar path;
    # slices across blocks); then hubs of 10^5 edges
    for seed, R, cases in ((34, 7, ((64, 32), (2048, 32), (1024, 128),
                                    (66, 6))),
                           (35, 2000, ((128, 32), (1026, 6)))):
        for F, dim in cases:
            check_k8f_hub(F, dim, R, seed, device)
            check_k8b_hub(F, dim, R, seed, device)
    check_k8f_hub(64, 32, 7, 36, device, hub=100000)
    check_k8b_hub(64, 32, 7, 36, device, hub=100000)

    # (b) the main path's shapes on the FB-sized graph, D = 32: F = 16 x 32
    # (eval) for K8f, F = 64 x 32 (training) for both; per-batch relations
    # (classic NBFNet's dependent mode) are timed, shared ones checked
    entries = {}
    for B, which in ((EVAL_BATCH, "eval"), (CLASSIC_TRAIN["batch"], "train")):
        for shared in (True, False):
            ops = rotate_operands(und, B, CLASSIC_FEAT, shared, seed=B + shared,
                                  device=device)
            label = (f"{which} shape V={und.num_nodes} E={und.num_edges} "
                     f"R={und.num_relations} F={B * CLASSIC_FEAT} "
                     f"{'shared' if shared else 'per-batch'} relation")
            out, err_f = check_fwd(ops, CLASSIC_FEAT, label)
            del out
            if which == "train":
                dx, dr, err_b = check_bwd(ops, CLASSIC_FEAT, label)
                del dx, dr
            torch.cuda.empty_cache()
            if shared:
                continue
            timed = [("K8f", err_f, *k8f(ops, CLASSIC_FEAT))]
            plan = fwd.k8f_plan(und.num_relations, B * CLASSIC_FEAT,
                                und.num_nodes,
                                ops[0].seg_ptr.numel() - 1, CLASSIC_FEAT)
            log(f"[kernels] K8f {label}: {plan_text(plan)}")
            if which == "train":
                timed.append(("K8b", err_b, *k8b(ops, CLASSIC_FEAT)))
            for kid, err, kernel, plain in timed:
                ms = cuda_time_ms(kernel, 20)
                plain_ms = cuda_time_ms(plain, 3, warmup=1)
                bound_ms, bound_by = gather_bound_ms(kid, *ops[1:4])
                log(f"[kernels] {kid} {label}: {ms:.4f} ms (plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
                    f"{bound_by}, {bound_ms / ms:.1%} of it), library_ms: "
                    "null (no single PyTorch call computes this function)")
                keys = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
                if kid in entries:  # K8f's second shape
                    entries[kid].update(
                        {f"{k}_train": v for k, v in keys.items()})
                    continue
                if kid == "K8b":
                    keys.update(k8b_halves((*ops, CLASSIC_FEAT), label))
                entries[kid] = dict(
                    name=kid, route="cuda",
                    source=f"{PACKAGE}/csrc/rspmm_rotate.cu",
                    replaces="ultra_torchdrug_tpu/ops/rspmm_pallas.py:"
                             + {"K8f": "1681", "K8b": "2110"}[kid],
                    mode={"K8f": "rot_rel", "K8b": "rotate"}[kid],
                    launches=None, library_ms=None, **keys)
            del ops, timed
            torch.cuda.empty_cache()
    k8f_hub, k8b_hub = phase_rotate_hub(device)
    entries["K8f"].update(k8f_hub)
    entries["K8b"].update(k8b_hub)
    log('[kernels] kernels ["K8f", "K8b"]')
    return entries


def bf16_operands(graph, batch: int, dim: int, shared: bool, seed: int,
                  device):
    """K1h's and K2h's operands on ``graph`` (with its backward layouts), as
    the wrappers receive them after their cast: rotate_operands' x, g and
    rel (shared [R, dim] broadcast to every query, or per batch) in bf16,
    and its masked fp32 weights. Returns (csr, w, rel, x, g)."""
    csr, w, rel, x, g = rotate_operands(graph, batch, dim, shared, seed,
                                        device)
    return (csr, w, *(t.to(torch.bfloat16) for t in (rel, x, g)))


def check_k2h_mass(args, label: str) -> float:
    """K2h on ``args`` (csr, w and bf16 rel, x, g) against its plain version:
    dx within K2's tolerance, dr within K3's (1e-5 of its largest entry
    where that is more), each plus 8 fp32 ulps of each entry's absolute
    mass (timing.py::k2_mass on the widened values), two calls bitwise
    equal, each half alone equal to the whole, rows and relations without
    edges 0. Returns the largest difference."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda as bwd

    dx, dr = bwd.rspmm_bwd_bf16_cuda(*args)
    dx2, dr2 = bwd.rspmm_bwd_bf16_cuda(*args)
    torch.cuda.synchronize()
    if not (torch.equal(dx, dx2) and torch.equal(dr, dr2)):
        raise AssertionError(f"K2h {label}: two calls differ")
    del dx2, dr2
    csr, w = args[:2]
    want = bwd.rspmm_bwd_bf16_plain(*args)
    masses = k2_mass(csr, w, *(t.float() for t in args[2:]))
    err = max(assert_mass_close(got, want_half, mass, 1e-5, atol,
                                f"K2h {label}")
              for got, want_half, mass, atol in zip(
                  (dx, dr), want, masses,
                  (1e-4, max(1e-4, 1e-5 * want[1].abs().max().item()))))
    del want, masses
    no_src = (csr.src_rowptr[1:] == csr.src_rowptr[:-1]).nonzero()
    no_rel = (csr.tile_rel_ptr[1:] == csr.tile_rel_ptr[:-1]).nonzero()
    if not (torch.all(dx[no_src] == 0) and torch.all(dr[no_rel] == 0)):
        raise AssertionError(f"K2h {label}: rows without edges")
    if not (torch.equal(bwd.rspmm_bwd_bf16_cuda(*args, need_dr=False)[0], dx)
            and torch.equal(bwd.rspmm_bwd_bf16_cuda(*args,
                                                    need_dx=False)[1], dr)):
        raise AssertionError(f"K2h {label}: a half alone differs")
    return err


def check_k2h_hub(F: int, R: int, seed: int, device,
                  hub: int = 10000) -> float:
    """K2h on ops/rspmm_cuda.py::hub_operands' hub rows (hubs of ``hub``
    and 1,000 edges both ways, 40 duplicated edges) at width F, R
    relations, N(0, 1) operands in bf16, held by check_k2h_mass; logs the
    passes' layouts."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda, rspmm_cuda

    E = max(40000, 2 * hub + 20000)
    csr, w = rspmm_cuda.hub_operands(seed, device, E=E, R=R, duplicated=40,
                                     hub=hub)
    V = csr.src_rowptr.numel() - 1
    gen = torch.Generator(device=device).manual_seed(seed + F)
    args = (csr, w, *(torch.randn(s, generator=gen, device=device).bfloat16()
                      for s in ((R, F), (V, F), (V, F))))
    label = f"hub rows of {hub} edges R={R} F={F}"
    err = check_k2h_mass(args, label)
    plan = rspmm_bwd_cuda.k2h_plan(csr, F)
    log(f"[kernels] K2h {label}: max_abs_err {err:.3g} within the mass "
        f"tolerance, bitwise equal across two calls and by half; dx pass "
        f"{plan_text(plan['dx'])}; dr pass {plan_text(plan['dr'])}")
    return err


def k2h_halves(ops, label: str) -> dict:
    """K2h's halves each alone on ``ops`` (csr, w and bf16 rel, x, g) with
    their bounds and the passes' layouts (key ``plan``)."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda as bwd

    out = k2_half_times(lambda need_dx, need_dr: bwd.rspmm_bwd_bf16_cuda(
        *ops, need_dx, need_dr), ops)
    out["plan"] = plan = bwd.k2h_plan(ops[0], ops[3].shape[1])
    log(f"[kernels] K2h {label}: dx half {out['ms_dx']:.4f} ms (bound "
        f"{out['bound_ms_dx']:.4f}; {plan_text(plan['dx'])}), dr half "
        f"{out['ms_dr']:.4f} ms (bound {out['bound_ms_dr']:.4f}; "
        f"{plan_text(plan['dr'])})")
    return out


def phase_k2h_hub(device) -> dict:
    """K2h at F = 64 x 64 (ULTRA's bf16 training width) on bench.py's
    heavy-tailed KG (its busiest source row 107,336 edges), held by
    check_k2h_mass and timed, whole and by half; returns its entry's
    ``*_hub`` keys."""
    from ultra_torchdrug_tpu_torch.data.graph import build_csr
    from ultra_torchdrug_tpu_torch.diagnostics.workloads import build_workload
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda as bwd

    tri, _, _ = build_workload(features=False)
    V, R, E = 15000, 474, len(tri)
    csr = build_csr(tri[:, 0], tri[:, 1], tri[:, 2], V, R,
                    backward=True).to(device)
    F = TRAIN["batch"] * FEAT
    gen = torch.Generator(device=device).manual_seed(F + 14)
    w = torch.rand((E,), generator=gen, device=device) + 0.5
    w = w * (torch.rand((E,), generator=gen, device=device) >= 0.2)
    args = (csr, w, *(torch.randn(s, generator=gen, device=device).bfloat16()
                      for s in ((R, F), (V, F), (V, F))))
    label = f"bench.py's KG V={V} E={E} R={R} F={F}"
    err = check_k2h_mass(args, label)
    torch.cuda.empty_cache()
    ms = cuda_time_ms(lambda: bwd.rspmm_bwd_bf16_cuda(*args), 20)
    bound_ms, _ = k2_bound_ms(*args)
    log(f"[kernels] K2h {label}: max_abs_err {err:.3g} within the mass "
        f"tolerance, bitwise equal across two calls, {ms:.4f} ms (bound "
        f"{bound_ms:.4f} ms, {bound_ms / ms:.1%} of it)")
    keys = dict(ms=ms, max_abs_err=err, bound_ms=bound_ms,
                **k2h_halves(args, label))
    del args, csr, w
    torch.cuda.empty_cache()
    return {f"{k}_hub": v for k, v in keys.items()}


def phase_kernels_bf16(und, device) -> dict:
    """K1h (the bf16 forward, csrc/rspmm_fwd.cu) and K2h (its backward,
    csrc/rspmm_bwd.cu) against their plain versions; returns their
    kernels-line entries by id (without the main path's launch counts).
    Both get bf16 operands, so the wrappers' casts are no-ops and the
    times are the kernels'. K1 and K2 run beside them on the same operands
    in fp32, for the ratio the prediction names."""
    from ultra_torchdrug_tpu_torch.data.graph import Graph
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda as bwd
    from ultra_torchdrug_tpu_torch.ops import rspmm_cuda as fwd

    # K1h as K1: both round each message to bf16 from the same bits (the
    # product of two bf16 values is exact in fp32), so only the order of
    # the fp32 sums differs; K2h as assert_bwd_close says
    tol = dict(rtol=1e-5, atol=1e-5)

    def k1h(ops, mode):
        csr, w, rel, x, _ = ops
        args = (csr.rowptr, csr.src, csr.etype, csr.eid, w, rel, x, mode)
        f32 = (*args[:5], rel.float(), x.float(), mode)
        return (lambda: fwd.rspmm_fwd_bf16_cuda(*args,
                                                segments=csr.segments),
                lambda: fwd.rspmm_fwd_bf16_plain(*args),
                lambda: fwd.rspmm_fwd_cuda(*f32, segments=csr.segments))

    def k2h(ops):
        return (lambda: bwd.rspmm_bwd_bf16_cuda(*ops),
                lambda: bwd.rspmm_bwd_bf16_plain(*ops))

    def check_fwd(ops, mode, label):
        kernel, plain, _ = k1h(ops, mode)
        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"K1h {mode} {label}: two calls differ")
        torch.testing.assert_close(got, want, **tol)
        err = (got - want).abs().max().item()
        log(f"[kernels] K1h {mode} {label}: max_abs_err {err:.3g}, bitwise "
            "equal across two calls")
        return got, err

    # (a) small and ragged shapes, (V, E, R, B, D): B·D = 18, 20, 12 and
    # 1028 are not multiples of 8 and take the scalar path, 64 and 2056 the
    # 16-byte path (2056 in two feature tiles); the last 5 rows neither send
    # nor receive an edge, the last relation has none; the (60, 1400, 3)
    # graph has three chunks per relation; odd cases share one relation
    # across the batch
    rng = np.random.default_rng(6)
    for i, (V, E, R, B, D) in enumerate(
            ((37, 300, 6, 3, 6), (37, 300, 6, 2, 10), (37, 300, 6, 2, 32),
             (37, 300, 6, 4, 257), (37, 300, 6, 8, 257), (50, 20, 3, 2, 6),
             (60, 1400, 3, 4, 16))):
        tri = np.stack([rng.integers(0, V - 5, E), rng.integers(0, V - 5, E),
                        rng.integers(0, R - 1, E)], 1)
        g = Graph.from_triplets(tri, V, R).prepare_csr(backward=True)
        shared = i % 2 == 1
        ops = bf16_operands(g, B, D, shared, seed=V + B * D, device=device)
        label = (f"V={V} E={E} R={R} F={B * D} "
                 f"{'shared' if shared else 'per-batch'} relation")
        for mode in ("mul_rel", "add_rel"):
            out, _ = check_fwd(ops, mode, label)
            if not torch.all(out[V - 5:] == 0):
                raise AssertionError("K1h wrote nonzero rows without edges")
        dx, dr, _ = check_bwd_kernel("K2h", *k2h(ops), label)
        if not (torch.all(dx[V - 5:] == 0) and torch.all(dr[R - 1] == 0)):
            raise AssertionError("K2h wrote nonzero rows without edges")
    # K2h on hub rows (10^3, 10^4, 256 and 257 edges both ways, 40
    # duplicated edges): F = 10 and 1028 the scalar path, 64 one slice,
    # 2056 a ragged last slice; R = 2,000, whose rel rows the dx pass
    # gathers on the 16-byte path; then hubs of 10^5 edges
    for seed, R, feats in ((16, 7, (10, 64, 1028, 2056)),
                           (17, 2000, (16, 1032, 132))):
        for F in feats:
            check_k2h_hub(F, R, seed, device)
    check_k2h_hub(64, 7, 18, device, hub=100000)
    # K1h on its hub rows (10^3 and 10^4 in-edges, 256 and 257, 40
    # duplicated edges): F = 10 and 1028 the scalar path, 64 one slice,
    # 2056 a ragged last slice, 4096 the training width; R = 2,000 rel rows
    # gathered; a hub of 10^5
    for seed, R, feats in ((23, 7, (10, 64, 1028, 2056, 4096)),
                           (24, 2000, (16, 1032, 132))):
        for F in feats:
            check_k1h_hub(F, R, seed, device)
    check_k1h_hub(64, 7, 25, device, hub=100000)

    # (b) the main path's shapes on the FB-sized graph: F = 16 x 64 (eval)
    # for K1h, F = 64 x 64 (training) for both; ULTRA's injected relations
    # are per query; shared ones are checked too
    entries = {}
    for B, which in ((EVAL_BATCH, "eval"), (TRAIN["batch"], "train")):
        for shared in (True, False):
            ops = bf16_operands(und, B, FEAT, shared, seed=B + 2 * shared,
                                device=device)
            label = (f"{which} shape V={und.num_nodes} E={und.num_edges} "
                     f"R={und.num_relations} F={B * FEAT} "
                     f"{'shared' if shared else 'per-batch'} relation")
            out, err_f = check_fwd(ops, "mul_rel", label)
            del out
            if which == "train":
                dx, dr, err_b = check_bwd_kernel("K2h", *k2h(ops), label)
                del dx, dr
            torch.cuda.empty_cache()
            if shared:
                continue
            kernel, plain, fp32 = k1h(ops, "mul_rel")
            timed = [("K1h", err_f, kernel, plain, fp32,
                      k1_bound_ms((*k1_operands_of(ops), ops[2], ops[3])))]
            if which == "train":
                csr, w, rel, x, g = ops
                f32 = (csr, w, rel.float(), x.float(), g.float())
                timed.append(("K2h", err_b, *k2h(ops),
                              lambda: bwd.rspmm_bwd_cuda(*f32),
                              k2_bound_ms(*ops)))
            for kid, err, kernel, plain, fp32, (bound_ms, bound_by) in timed:
                ms = cuda_time_ms(kernel, 50 if which == "eval" else 20)
                fp32_ms = cuda_time_ms(fp32, 50 if which == "eval" else 20)
                plain_ms = cuda_time_ms(plain, 3, warmup=1)
                log(f"[kernels] {kid} {label}: {ms:.4f} ms (fp32 "
                    f"{'K1' if kid == 'K1h' else 'K2'} on the same values "
                    f"{fp32_ms:.4f} ms, ratio {ms / fp32_ms:.3f}; plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
                    f"{bound_by}, {bound_ms / ms:.1%} of it), library_ms: "
                    "null (no single PyTorch call computes this function)")
                keys = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            fp32_kernel_ms=fp32_ms)
                if kid == "K1h":
                    keys["plan"] = fwd.k1h_plan(
                        und.num_relations, B * FEAT, und.num_nodes,
                        ops[0].seg_ptr.numel() - 1)
                    log(f"[kernels] K1h {label}: " + plan_text(keys["plan"]))
                if kid in entries:  # K1h's second shape
                    entries[kid].update(
                        {f"{k}_train": v for k, v in keys.items()})
                    continue
                if kid == "K2h":
                    keys.update(k2h_halves(ops, label))
                entries[kid] = dict(
                    name=kid, route="cuda",
                    source=f"{PACKAGE}/csrc/"
                           + {"K1h": "rspmm_fwd.cu", "K2h": "rspmm_bwd.cu"}[kid],
                    replaces="ultra_torchdrug_tpu/ops/rspmm_pallas.py:"
                             + {"K1h": "1681", "K2h": "2110"}[kid],
                    mode="compute_dtype=bfloat16",
                    launches=None, library_ms=None, **keys)
            del ops, timed
            torch.cuda.empty_cache()
    entries["K2h"].update(phase_k2h_hub(device))
    entries["K1h"].update(phase_k1h_hub(device))
    log('[kernels] kernels ["K1h", "K2h"]')
    return entries


def check_k1h_mass(ops, mode: str, label: str) -> float:
    """K1h on ``ops`` (csr, w and bf16 rel, x) against its plain version's
    sums taken in float64 (timing.py::k1h_sums64; the fp32 plain version's
    own rounding on a row of 10^5 edges reaches the tolerance): K1h's
    tolerance plus 8 fp32 ulps of each entry's absolute mass
    (timing.py::k1_mass on the widened values), two calls bitwise equal,
    rows without in-edges 0. Returns the largest difference."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_cuda as fwd

    csr, w, rel, x = ops
    args = (*k1_operands_of(ops), rel, x, mode)
    got = fwd.rspmm_fwd_bf16_cuda(*args, segments=csr.segments)
    again = fwd.rspmm_fwd_bf16_cuda(*args, segments=csr.segments)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"K1h {mode} {label}: two calls differ")
    del again
    want = k1h_sums64(args[:7], mode)
    mass = k1_mass((*args[:5], rel.float(), x.float()), mode)
    err = assert_mass_close(got, want, mass, 1e-5, 1e-5,
                            f"K1h {mode} {label}")
    no_dst = (csr.rowptr[1:] == csr.rowptr[:-1]).nonzero()
    if not torch.all(got[no_dst] == 0):
        raise AssertionError(f"K1h {mode} {label}: rows without edges")
    return err


def check_k1h_hub(F: int, R: int, seed: int, device,
                  hub: int = 10000) -> float:
    """K1h in both modes on ops/rspmm_cuda.py::hub_operands' hub rows
    (destination hubs of ``hub`` and 1,000 edges, 40 duplicated edges) at
    width F, R relations, N(0, 1) operands in bf16, held by
    check_k1h_mass; logs the layout."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_cuda

    csr, w = rspmm_cuda.hub_operands(seed, device, E=max(40000,
                                                         2 * hub + 20000),
                                     R=R, duplicated=40, hub=hub)
    V = csr.rowptr.numel() - 1
    gen = torch.Generator(device=device).manual_seed(seed + F)
    ops = (csr, w, *(torch.randn(s, generator=gen, device=device).bfloat16()
                     for s in ((R, F), (V, F))))
    label = f"hub rows of {hub} edges R={R} F={F}"
    err = max(check_k1h_mass(ops, mode, label)
              for mode in ("mul_rel", "add_rel"))
    plan = rspmm_cuda.k1h_plan(R, F, V, csr.seg_ptr.numel() - 1)
    log(f"[kernels] K1h {label}: max_abs_err {err:.3g} within the mass "
        f"tolerance, bitwise equal across two calls; {plan_text(plan)}")
    return err


def phase_k1h_hub(device) -> dict:
    """K1h at F = 64 x 64 (ULTRA's bf16 training width) on bench.py's
    heavy-tailed KG (its busiest destination row 107,150 edges), held by
    check_k1h_mass and timed; returns its entry's ``*_hub`` keys."""
    from ultra_torchdrug_tpu_torch.data.graph import build_csr
    from ultra_torchdrug_tpu_torch.diagnostics.workloads import build_workload
    from ultra_torchdrug_tpu_torch.ops import rspmm_cuda as fwd

    tri, _, _ = build_workload(features=False)
    V, R, E = 15000, 474, len(tri)
    csr = build_csr(tri[:, 0], tri[:, 1], tri[:, 2], V, R).to(device)
    F = TRAIN["batch"] * FEAT
    gen = torch.Generator(device=device).manual_seed(F + 16)
    w = torch.rand((E,), generator=gen, device=device) + 0.5
    w = w * (torch.rand((E,), generator=gen, device=device) >= 0.2)
    ops = (csr, w, *(torch.randn(s, generator=gen, device=device).bfloat16()
                     for s in ((R, F), (V, F))))
    label = f"bench.py's KG V={V} E={E} R={R} F={F}"
    err = check_k1h_mass(ops, "mul_rel", label)
    torch.cuda.empty_cache()
    args = (*k1_operands_of(ops), *ops[2:])
    ms = cuda_time_ms(lambda: fwd.rspmm_fwd_bf16_cuda(
        *args, "mul_rel", segments=csr.segments), 20)
    bound_ms, _ = k1_bound_ms(args)
    plan = fwd.k1h_plan(R, F, V, csr.seg_ptr.numel() - 1)
    log(f"[kernels] K1h {label}: max_abs_err {err:.3g} within the mass "
        f"tolerance, bitwise equal across two calls, {ms:.4f} ms (bound "
        f"{bound_ms:.4f} ms, {bound_ms / ms:.1%} of it); {plan_text(plan)}")
    del ops, args, csr, w
    torch.cuda.empty_cache()
    return dict(ms_hub=ms, max_abs_err_hub=err, bound_ms_hub=bound_ms,
                plan_hub=plan)


def phase_kernels_ring(device) -> dict:
    """K9 through the wrapper the ring calls (parallel/rdma.py::
    shift_blocks, the n row blocks of one tensor, every shard on this
    card) against its plain version (``shift_blocks_plain``), bitwise, at
    ragged shapes and at the ring's shapes (n = 4 shards of v_block =
    3,636 rows, F = 1024 and 4096 fp32 features), timed queued ahead and
    at the host's pace beside its plain version, torch.cat of the rotated
    blocks (its library call) and torch.roll; returns its kernels-line
    entry."""
    from ultra_torchdrug_tpu_torch.parallel import rdma

    def shift(x, n, wrapper):
        return wrapper(list(x.chunk(n)), [x.device] * n)

    def check(n, vb, F, dtype, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        x = torch.randn((n * vb, F), generator=gen, device=device).to(dtype)
        got = torch.cat(shift(x, n, rdma.shift_blocks))
        want = torch.cat(shift(x, n, rdma.shift_blocks_plain))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K9 n={n} v_block={vb} F={F} {dtype}: "
                                 "differs from its plain version")
        return x

    # ragged: 7 x 5 fp32 (140 B) and 7 x 5 bf16 (70 B) blocks are not
    # multiples of 16 bytes, so blocks after the first are misaligned and
    # the first has a byte tail; 1 x 3 bf16 is 6 bytes; 8 x 1,024 fp32 rows
    # fill whole 256-thread CTAs, 9 x 1,000 fp32 rows leave the last one
    # partly idle
    for n in (1, 2, 3, 4):
        for vb, F in ((7, 5), (1, 3), (64, 256), (3636, 1024), (8, 1024),
                      (9, 1000)):
            for dtype in (torch.float32, torch.bfloat16):
                check(n, vb, F, dtype, seed=n * vb + F)
    log("[kernels] K9 ragged, CTA-sized and full shapes, fp32 and bf16, "
        "n = 1, 2, 3, 4: bitwise equal to its plain version")
    n, vb = RING_SHARDS, -(-FULL["num_nodes"] // RING_SHARDS)
    entry = None
    for F, which in ((EVAL_BATCH * FEAT, "eval"),
                     (TRAIN["batch"] * FEAT, "train")):
        x = check(n, vb, F, torch.float32, seed=F)
        # queued ahead of the device (the wrapper's host side can outlast
        # the copy) and at the host's pace; every time the lesser of two
        # readings in turns (diagnostics/timing.py::k9_times)
        times = k9_times(lambda: shift(x, n, rdma.shift_blocks),
                         lambda: shift(x, n, rdma.shift_blocks_plain), x, n)
        log(f"[kernels] K9 {which} shape n={n} v_block={vb} F={F}: bitwise "
            f"equal, {times['ms']:.4f} ms queued ahead, "
            f"{times['host_paced_ms']:.4f} ms at the host's pace (plain "
            f"{times['plain_ms']:.4f} ms, library torch.cat "
            f"{times['library_ms']:.4f} ms, torch.roll "
            f"{times['roll_ms']:.4f} ms, all queued ahead; torch.cat "
            f"{times['library_host_paced_ms']:.4f} ms at the host's pace; "
            f"bound {times['bound_ms']:.4f} ms by {times['bound_by']}, "
            f"{times['bound_ms'] / times['ms']:.1%} of it; each the lesser "
            "of two readings in turns)")
        if entry is None:
            entry = dict(name="K9", route="cuda",
                         source=f"{PACKAGE}/csrc/ring_shift.cu",
                         replaces="ultra_torchdrug_tpu/parallel/rdma.py:83",
                         launches=None, max_abs_err=0.0,
                         library_call="torch.cat of the rotated blocks",
                         **times)
        else:
            entry.update({f"{k}_train": v for k, v in times.items()})
        del x
    log('[kernels] kernels ["K9"]')
    return entry


def phase_ladder_kernels(device):
    """Every ladder variant (csrc/rspmm_ladder.cu) held to
    ops/rspmm_ladder_cuda.py::check_ragged at ragged shapes: 40 rows, the
    last 5 without edges, a row of 700 of 1,200 in-edges (three split
    segments), eid not the identity; F = 10 (scalar path), 64 (float4 path)
    and 1028 (2 feature tiles of 256 threads, 5 of ftile's 64). Each
    against its plain version, full bitwise against K1 on the rows of one
    segment (K1 at full's tolerance on the 700-edge row), packed, ftile and
    nowrite with write=True bitwise against full, nowrite with write=False
    leaving its output as filled, rows without edges 0. On the CPU the
    wrappers run the plain versions: a rehearsal of this Python."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_ladder_cuda as ladder

    for F in (10, 64, 1028):
        ops = ladder.ragged_operands(F, seed=8 + F, device=device)
        errs = {name: float(f"{ladder.check_ragged(name, ops):.3g}")
                for name in ladder.VARIANTS}
        log(f"[ladder] ragged V={ops.num_rows} E={ops.num_edges} F={F} "
            f"(a row of 700 edges, 5 empty rows, eid not the identity): "
            f"max_abs_err {json.dumps(errs)}; full == K1 on rows of one "
            "segment, packed, ftile, nowrite == full bitwise")
    log('[ladder] kernels ["P1", "P2"] against their plain versions '
        f"({'card' if device.type == 'cuda' else 'cpu rehearsal'})")


def phase_ladder_tools(device) -> tuple:
    """The ladder tools at their default, full sizes with every variant
    (P1: diagnostics/kernel_floor.py, P2: diagnostics/blocked_ladder.py,
    its JSON under output/), each run between a reset and a read of
    the launch counts: every variant and the shipped K1 (timed beside
    them) must launch, no other model kernel may.
    On the CPU a tiny size with the plain versions. Returns (the kernels
    line's P1 and P2 entries, their launch counts by tool)."""
    from ultra_torchdrug_tpu_torch.diagnostics import (
        blocked_ladder,
        kernel_floor,
    )
    from ultra_torchdrug_tpu_torch.ops import rspmm_ladder_cuda as ladder

    cuda = device.type == "cuda"
    out = REPO / "output" / blocked_ladder.DEFAULT_OUT
    small_floor = {} if cuda else dict(edges=128, te=64, tv=8, vrows=64,
                                       feat=256, relations=8, runlen=8)
    small_blocked = {} if cuda else dict(nodes=300, edges=4000, relations=12,
                                         feat=64)
    entries, runs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tools = (
            ("P1", "kernel_floor", "script/diagnostics/kernel_floor.py:299",
             lambda: kernel_floor.run(variants="all", device=device,
                                      **small_floor)),
            ("P2", "blocked_ladder",
             "script/diagnostics/blocked_ladder.py:47",
             lambda: blocked_ladder.run(
                 variants="all", device=device,
                 out=str(out if cuda else Path(tmp) / out.name),
                 **small_blocked)))
        for kid, label, replaces, run in tools:
            reset_launch_counts()
            t0 = time.perf_counter()
            res = run()
            seconds = time.perf_counter() - t0
            counts = launch_counts()
            per_variant = dict(ladder.launches)
            # the tools time the shipped K1 beside the variants
            model = {k: v for k, v in counts.items()
                     if k not in ("ladder", "K1") and v}
            if model or (cuda and not (all(per_variant.values())
                                       and counts["K1"])) or (
                    not cuda and (counts["ladder"] or counts["K1"])):
                raise AssertionError(f"{label}: launches {counts}, by "
                                     f"variant {per_variant}")
            full = res["variants"]["full"]
            entries[kid] = dict(
                name=kid, route="cuda", source=f"{PACKAGE}/csrc/"
                "rspmm_ladder.cu", replaces=replaces, launches=None,
                max_abs_err=full["max_abs_err"], ms=full["ms"],
                plain_ms=full.get("plain_ms"), bound_ms=res["bound_ms"],
                bound_by=res["bound_by"], library_ms=None,
                shipped_k1_ms=res["k1"]["ms"],
                variant_ms={k: v["ms"] for k, v in res["variants"].items()},
                variant_max_abs_err={k: v["max_abs_err"]
                                     for k, v in res["variants"].items()})
            runs[label] = {"tool": {kid: counts["ladder"]}}
            log(f"[ladder] {label}: {seconds:.1f} s, launches by variant "
                f"{per_variant}, shipped K1 {counts['K1']}; library_ms: null "
                "(no single PyTorch call computes K1's function)")
    if cuda:
        torch.cuda.empty_cache()
    return entries, runs


def k1_operands_of(ops) -> tuple:
    """K1's CSR arrays and weights from a (csr, w, ...) operand tuple."""
    csr, w = ops[:2]
    return csr.rowptr, csr.src, csr.etype, csr.eid, w


def phase_slice(task, model, device, per_batch: dict, label: str = "slice",
                split: str = "test", triples: int = FAST_TEST, cards=None):
    """Evaluation of ``triples`` triples of ``split`` through the task's
    entry point; returns the launch counts of the measured run, which must
    be ``per_batch`` per eval batch. ``cards``: the cards whose peak
    memory it logs beside the device's (an edge mesh on several cards)."""
    # one batch first: cuBLAS handles, allocator pools and the kernel library
    # load are set-up, not evaluation
    task.evaluate(model, split, batch_size=EVAL_BATCH, fast_test=EVAL_BATCH)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_peaks(cards or [])
    batches = math.ceil(triples / EVAL_BATCH)
    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = task.evaluate(model, split, batch_size=EVAL_BATCH,
                            fast_test=triples)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    check_launches(label, counts, per_batch, batches, device)
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metrics {metrics}")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if device.type == "cuda" else float("nan"))
    log(f"[{label}] {triples} {split} triples in {batches} batches of "
        f"{EVAL_BATCH}: {seconds * 1e3 / batches:.2f} ms per eval batch, "
        f"{triples / seconds:.1f} triples/s, peak device memory "
        f"{peak:.3f} GiB ({device})"
        + (f"; peak by card {peaks_text(cards)}" if cards else ""))
    log(f"[{label}] launches {counts} ({batches} batches)")
    log(f"[{label}] metrics {json.dumps(metrics)}")
    return counts


def profile_device_time(label: str, fn):
    """Device time by kernel over one call of fn (torch.profiler), and the
    device's busy share of that call's wall time under the profiler;
    returns the device ms (None where the profiler recorded none)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a host op's entry repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        log(f"[profile] {label}: the profiler recorded no device time: not "
            "measured")
        return None
    log(f"[profile] {label}: device busy {device_ms:.3f} ms of "
        f"{wall_ms:.3f} ms wall under the profiler "
        f"({device_ms / wall_ms:.1%} busy)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3
        log(f"[profile] {ms:9.3f} ms {ms / device_ms:6.1%} x{e.count:<5d} "
            f"{e.key[:90]}")
    return device_ms


def phase_parity(task, model, device, atol: float = 1e-4,
                 label: str = "parity", ref_task=None, ref_device="cpu",
                 mesh=None, queries: int = 2, split_graphs=None,
                 ref_model=None):
    """Card scores for ``queries`` test queries against the port's CPU run
    (or ``ref_task`` with ``ref_model``, by default the same model, on
    ``ref_device``), through the task's scoring hook on the graphs its eval
    path uses: ``split_graphs`` (the test split's fact and relation graph)
    or the task's fact and relation graph; ``task`` runs under ``mesh``."""
    from ultra_torchdrug_tpu_torch.parallel.mesh import use_mesh

    batch = torch.from_numpy(task.dataset.test[:queries].astype(np.int64))
    ref_device = torch.device(ref_device)
    if ref_model is None:
        ref_model = (model if ref_device == device
                     else copy.deepcopy(model).to(ref_device))
    results = []
    for t, m, dev, scope in ((task, model, device, use_mesh(mesh)),
                             (ref_task or task, ref_model, ref_device,
                              contextlib.nullcontext())):
        fact, rel = split_graphs or (t.fact_graph, t.rel_graph)
        with scope, torch.inference_mode():
            g_und, g_rel = (g.to(dev) for g in t._prepare_graphs(fact, rel))
            b = batch.to(dev)
            s_t, s_h = t._eval_scores(m, fact, g_rel, b[:, 0], b[:, 1],
                                      b[:, 2], g_und)
            results.append((s_t.cpu(), s_h.cpu()))
    (t_dev, h_dev), (t_ref, h_ref) = results
    ref = "single device" if ref_task is not None else str(ref_device)
    for name, a, b in (("tail", t_dev, t_ref), ("head", h_dev, h_ref)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite {name} scores on {device}")
        torch.testing.assert_close(a, b, rtol=0, atol=atol)
        log(f"[{label}] {name} scores {tuple(a.shape)} {device} vs {ref}: "
            f"max_abs_err {(a - b).abs().max().item():.3g} (limit {atol:g})")


def phase_clip_crossings(task, model, device, label: str):
    """PNA's std = sqrt(clip(sq_mean - mean², EPS)) on the card and on the
    CPU for 2 test queries, tail and head scoring: per layer, the entries
    clipped on each device and those clipped on one and not the other,
    where the two runs' gradients and scores can part by more than
    rounding."""
    from ultra_torchdrug_tpu_torch.models.layers import (
        _MESSAGES,
        EPS,
        _relation_input,
        pna_moments,
        pna_sums,
    )

    def clipped(m, dev):
        masks = []

        def hook(layer, args, kwargs):
            graph, x, boundary = args
            rel = _relation_input(layer, kwargs.get("query"), None)
            sums = pna_sums(layer.cfg, graph, rel, x,
                            _MESSAGES[layer.cfg.message_func])
            mean, sq_mean, _ = pna_moments(layer.cfg, graph, *sums, boundary)
            masks.append((sq_mean - mean ** 2 <= EPS).cpu())

        handles = [layer.register_forward_pre_hook(hook, with_kwargs=True)
                   for layer in m.layers]
        und, _ = task._prepare_graphs(task.fact_graph, task.rel_graph)
        b = torch.from_numpy(task.dataset.test[:2].astype(np.int64)).to(dev)
        try:
            with torch.inference_mode():
                task._eval_scores(m, task.fact_graph, None, b[:, 0], b[:, 1],
                                  b[:, 2], und.to(dev))
        finally:
            for h in handles:
                h.remove()
        return masks

    cpu = torch.device("cpu")
    layers = len(model.layers)
    for i, (a, b) in enumerate(zip(clipped(model, device),
                                   clipped(copy.deepcopy(model).to(cpu), cpu))):
        log(f"[{label}] {('tail', 'head')[i // layers]} layer "
            f"{i % layers}: {int(a.sum())} of {a.numel()} "
            f"(node, query, feature) variances clipped on {device}, "
            f"{int(b.sum())} on cpu, {int((a != b).sum())} on one only")


def release_device_memory() -> None:
    """Collect the Python garbage that holds device tensors (tasks'
    closures hold them in cycles) and return the cache's free segments."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def make_engine(task, size: dict, label: str, **opt):
    """An Engine over ``task`` at ``size``'s batch, logging nowhere."""
    from ultra_torchdrug_tpu_torch.engine.engine import Engine
    from ultra_torchdrug_tpu_torch.utils.logging import get_root_logger

    engine = Engine(task, batch_size=size["batch"], seed=0,
                    log_interval=10**9, logger=get_root_logger(None), **opt)
    log(f"[{label}] batch {size['batch']}, {size['negatives']} negatives, "
        f"{opt}")
    return engine


def phase_train(engine, size: dict, device, per_step: dict,
                label: str = "train", cards=None):
    """Training steps through Engine.train; returns the launch counts of
    the timed run, which must be ``per_step`` per step. ``cards`` as in
    ``phase_slice``."""
    # one step first: allocator pools and cuBLAS handles are set-up
    engine.train(batch_per_epoch=1)
    if device.type == "cuda":
        for c in cards or [device]:
            torch.cuda.synchronize(c)
        torch.cuda.reset_peak_memory_stats()
        reset_peaks(cards or [])
    held = (", ".join(f"{c} {torch.cuda.memory_allocated(c) / 2**30:.3f}"
                      for c in cards) + " GiB" if cards and device.type
            == "cuda" else "")
    steps = size["steps"]
    reset_launch_counts()
    t0 = time.perf_counter()
    engine.train(batch_per_epoch=steps)
    if device.type == "cuda":
        for c in cards or [device]:
            torch.cuda.synchronize(c)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    check_launches(label, counts, per_step, steps, device)
    window = engine.meter.last_window
    if len(window) != steps or not all(
            math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
            for m in window):
        raise AssertionError(f"non-finite or missing step metrics {window}")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if device.type == "cuda" else float("nan"))
    log(f"[{label}] {steps} steps of {size['batch']} triples: "
        f"{seconds * 1e3 / steps:.2f} ms per step, "
        f"{steps * size['batch'] / seconds:.1f} triples/s, peak device "
        f"memory {peak:.3f} GiB ({device})"
        + (f"; peak by card {peaks_text(cards)}, held at the start "
           f"{held}" if cards else ""))
    log(f"[{label}] launches {counts} ({steps} steps)")
    for i, m in enumerate(window):
        log(f"[{label}] step {i}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in sorted(m.items())))
    return counts


def phase_train_parity(engine, cpu_task, device, grad_rtol: float = 1e-4,
                       loss_rtol: float = 1e-5, label: str = "train parity",
                       ref_device="cpu", graph_id=None, ref_model=None):
    """One loss step on the card (under the engine's mesh) against the
    port's CPU run (``cpu_task``, the same task on the CPU; or another task
    on ``ref_device``, with ``ref_model`` when given, else a copy of the
    engine's model): the same weights, the same 2 train triples and 8
    injected negatives, on the full graph (of a multi-graph task, graph
    ``graph_id``). Gradients are compared
    norm-wise per parameter: each is a sum over ~500k edges and V*B rows,
    taken in another order on the card, so single small entries may differ
    in relative terms where the tensor as a whole agrees to fp32 rounding."""
    task = engine.task
    if graph_id is None:
        batch, num_nodes, step = (task.train_triples[:2],
                                  task.dataset.num_entities, ())
    else:
        batch, num_nodes, step = (task.train_triples[graph_id][:2],
                                  task.fact_graphs[graph_id].num_nodes,
                                  (graph_id,))
    neg = torch.from_numpy(np.random.default_rng(5).integers(
        0, num_nodes, (2, 8)))
    cpu = torch.device(ref_device)
    results = []
    if ref_model is None:
        ref_model = copy.deepcopy(engine.model).to(cpu)
    for t, m, dev, scope in ((task, engine.model, device, engine._mesh_scope()),
                             (cpu_task, ref_model, cpu,
                              contextlib.nullcontext())):
        m.zero_grad(set_to_none=True)
        with scope:
            loss, _ = t.loss_step(m, None, batch, *step, neg=neg.to(dev))
            loss.backward()
        results.append((loss.item(), {k: p.grad.detach().cpu()
                                      for k, p in m.named_parameters()}))
        m.zero_grad(set_to_none=True)
    (loss_dev, g_dev), (loss_cpu, g_cpu) = results
    if not math.isfinite(loss_dev) or abs(loss_dev - loss_cpu) > loss_rtol * max(
            1.0, abs(loss_cpu)):
        raise AssertionError(f"loss {device} {loss_dev} vs cpu {loss_cpu}")
    worst, worst_abs = 0.0, 0.0
    for k in g_cpu:
        a, b = g_dev[k], g_cpu[k]
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite gradient {k} on {device}")
        rel = ((a - b).norm() / b.norm().clamp(min=1e-12)).item()
        if rel > grad_rtol:
            raise AssertionError(f"gradient {k}: relative error {rel:.3g}")
        worst = max(worst, rel)
        worst_abs = max(worst_abs, (a - b).abs().max().item())
    log(f"[{label}] loss {device} {loss_dev:.8g} vs {ref_device} "
        f"{loss_cpu:.8g}; "
        f"{len(g_cpu)} gradients: worst norm-wise relative error "
        f"{worst:.3g} (limit {grad_rtol:g}), max_abs_err {worst_abs:.3g}")


def finish_entries(entries: dict, runs: dict, counted_as: dict) -> None:
    """Each kernels-line entry's launches on the main path, by path and in
    all, from the runs' launch counts (``counted_as`` maps an entry to the
    count it reads, its name by default); raises for a kernel that never
    launched."""
    for key, e in entries.items():
        kid = counted_as.get(key, e["name"])
        by_path = {f"{path} {half}": counts[kid]
                   for path, halves in runs.items()
                   for half, counts in halves.items()
                   if counts.get(kid)}
        e.update(launches=sum(by_path.values()), launches_by_path=by_path)
        if not e["launches"]:
            raise AssertionError(f"{e['name']} never launched on the main "
                                 "path")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="cpu rehearses phases 1b-55 at a reduced size with the plain "
             "versions and reports no result")
    parser.add_argument("--failsoft", nargs=3, help=argparse.SUPPRESS,
                        metavar=("LOSS", "PEAK_GIB", "OUT"))
    parser.add_argument("--dp-child", nargs=2, help=argparse.SUPPRESS,
                        metavar=("OUT", "CASES"))
    parser.add_argument(
        "--only", choices=("46-48", "49-51", "52-53", "54-55"),
        help="run the build and these phases alone and report no result "
             "(52-53 print their kernels line)")
    parser.add_argument(
        "--only-new", action="store_const", const="49-51", dest="only",
        help="the same as --only 49-51, the newest phases")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script checks the port on "
              "the card (--device cpu rehearses without one)",
              file=sys.stderr)
        return 1
    import_port()
    if args.failsoft:
        loss, peak, out = args.failsoft
        return failsoft_child(float(loss), float(peak), Path(out))
    if args.dp_child:
        out, cases = args.dp_child
        return dp_child(Path(out), cases.split(","), args.device)
    from ultra_torchdrug_tpu_torch.data.datasets import synthetic_transductive
    from ultra_torchdrug_tpu_torch.models.classic_nbfnet import (
        classic_nbfnet_config,
    )
    from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig
    from ultra_torchdrug_tpu_torch.tasks.task import (
        TaskConfig,
        TransductiveKGTask,
    )

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    size = FULL if cuda else REHEARSAL
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    entries, runs = {}, {}  # kernels-line entries; launch counts by path
    if cuda:
        log(nvidia_smi_line())
        log(f"[env] device {torch.cuda.get_device_name(0)}, "
            f"count {torch.cuda.device_count()}")
        phase_build()
    if args.only:
        entry = None
        if args.only == "52-53":
            ran, entry = run_card_phases(device)
        else:
            ran = {"46-48": run_new_phases, "49-51": run_edge_phases,
                   "54-55": run_training_phases}[args.only](device)
        used = {path: {half: {k: v for k, v in c.items() if v}
                       for half, c in halves.items()}
                for path, halves in ran.items()}
        log(f"[only] phases {args.only} passed; launches by path {used}")
        if entry is not None:
            finish_entries({"K9 cards": entry}, ran, {"K9 cards": "K9x"})
            print(json.dumps({"kernels": [entry]}))
        return 0

    t0 = time.perf_counter()
    dataset = synthetic_transductive("SynthFB15k237", seed=0, **size)
    log(f"[data] synthetic KG {size}: {len(dataset.train)} train / "
        f"{len(dataset.valid)} valid / {len(dataset.test)} test triples "
        f"({time.perf_counter() - t0:.1f} s)")
    if cuda:
        entries["K1"] = phase_kernels(dataset, device)
        und = dataset.fact_graph(None)[0].undirected_with_inverse()
        und = und.prepare_csr(backward=True)
        entries["K1"].update(time_k1_train_shape(und, device))
        entries["K2"] = phase_kernels_k2(und, device)
        k1_hub, k2_hub = phase_k1_k2_hub(device)
        entries["K1"].update(k1_hub)
        entries["K2"].update(k2_hub)
        entries.update(phase_kernels_pna(und, device))
        entries.update(phase_kernels_ext(und, device))
        entries.update(phase_kernels_rotate(und, device))
        entries.update(phase_kernels_bf16(und, device))
        entries["K9"] = phase_kernels_ring(device)
        del und
        torch.cuda.empty_cache()
    # the K1 strip-down ladder (P1, P2): its variants at ragged shapes, then
    # both tools at full size (on the CPU, the rehearsal's plain versions)
    phase_ladder_kernels(device)
    ladder_entries, ladder_runs = phase_ladder_tools(device)
    entries.update(ladder_entries)
    runs.update(ladder_runs)

    # ULTRA: zero-shot evaluation and training (K1, K2)
    t0 = time.perf_counter()
    task = TransductiveKGTask(dataset, UltraConfig.default(
        dataset.num_relations), TaskConfig(eval_batch_size=EVAL_BATCH),
        device=device)
    model = task.init_params(seed=0)
    log(f"[slice] task set-up (relation graph {task.rel_graph.num_nodes} "
        f"nodes / {task.rel_graph.num_edges} edges, CSR, dense adjacency) "
        f"{time.perf_counter() - t0:.1f} s")
    ultra_eval = phase_slice(task, model, device,
                             {"K1": K1_LAUNCHES_PER_BATCH}, label="ultra")
    if cuda:
        profile_device_time("one ultra eval batch", lambda: task.evaluate(
            model, "test", batch_size=EVAL_BATCH, fast_test=EVAL_BATCH))
    phase_parity(task, model, device, label="ultra parity")
    # phase 31 on phase 2's task and model; the .pth it writes serves phase
    # 33 too
    scratch = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    runs["checkpoint"], pth = phase_checkpoint(task, model, device,
                                               Path(scratch.name))
    del task, model

    train_size = TRAIN if cuda else TRAIN_REHEARSAL
    model_cfg = UltraConfig.default(dataset.num_relations)
    engine = make_engine(
        TransductiveKGTask(dataset, model_cfg, TaskConfig(
            num_negative=train_size["negatives"]), device=device),
        train_size, "ultra train", lr=5e-4)
    ultra_train = phase_train(engine, train_size, device,
                              {"K1": K_LAUNCHES_PER_STEP,
                               "K2": K_LAUNCHES_PER_STEP},
                              label="ultra train")
    if cuda:
        profile_device_time("one ultra train step",
                            lambda: engine.train(batch_per_epoch=1))
    phase_train_parity(engine, TransductiveKGTask(
        dataset, model_cfg, TaskConfig(num_negative=8), device="cpu"), device,
        label="ultra train parity")
    del engine
    runs["ultra"] = {"eval": ultra_eval, "train": ultra_train}

    # classic NBFNet, the NBFNet paper's FB15k-237 setting (distmult, pna)
    # and two rows of its ablation of message and aggregation functions:
    # (distmult, max) and (transe, pna)
    layers = len(classic_nbfnet_config().hidden_dims)
    runs["classic"] = run_classic(
        dataset, device, "classic", dict(),
        eval_per_pass={"K6": layers, "K7": layers},
        train_per_step={"K6": layers, "K7": layers, "K6b": layers,
                        "K7b": layers})
    runs["classic max"] = run_classic(
        dataset, device, "classic max", dict(aggregate_func="max"),
        eval_per_pass={"K4": layers},
        train_per_step={"K4": layers, "K5": layers})
    # transe's pna moments are two K1 sums per layer (its second moment sums
    # rel² + x², which does not factor through the message)
    runs["classic transe-pna"] = run_classic(
        dataset, device, "classic transe-pna", dict(message_func="transe"),
        eval_per_pass={"K1": 2 * layers, "K6": layers},
        train_per_step={"K1": 2 * layers, "K6": layers, "K3": 2 * layers,
                        "K6b": layers})
    # rotate: its sums run K8f (K8b backward); pna's max, min and second
    # moment take the O(E) route, which at the training width would keep
    # about 220 GB for autograd: (rotate, pna) evaluates only
    runs["classic rotate"] = run_classic(
        dataset, device, "classic rotate",
        dict(message_func="rotate", aggregate_func="sum"),
        eval_per_pass={"K8f": layers},
        train_per_step={"K8f": layers, "K8b": layers})
    runs["classic rotate-pna"] = run_classic(
        dataset, device, "classic rotate-pna", dict(message_func="rotate"),
        eval_per_pass={"K8f": layers}, train_per_step=None)

    # ULTRA with compute_dtype: bfloat16 (K1h, K2h), built from a config
    # dict through the port's builders, then the CLI on two shipped configs
    runs["ultra bf16"] = run_ultra_bf16(size, device)
    runs["cli"] = phase_cli(device)
    # ULTRA on the edge-partitioned ring (K1, K2 per bucket, K9), then the
    # CLI with the ring keys
    runs["ultra ring"] = run_ultra_ring(size, one_card(device))
    runs["ring cli"] = phase_ring_cli(one_card(device))
    # zero-shot inductive evaluation (K1), then multi-graph pre-training
    # (K1, K2): the other two shipped configs
    runs["inductive"] = run_inductive(device, pth)
    runs["pretrain"] = run_pretrain(device)
    scratch.cleanup()
    # the memory policies on the FB-size KG, training an ATOMIC-sized graph
    # with pretrain_3g.yaml's remat: auto, fail-soft demotion under a memory
    # cap, and classic NBFNet's path tools (K6, K7 under concat_hidden)
    runs["policies"], none_step = run_policies(dataset, device)
    runs["atomic"] = run_atomic(device)
    runs["failsoft"] = run_failsoft_fresh(dataset, device, none_step)
    runs["classic paths"] = run_classic_paths(dataset, device)
    # ULTRA's remaining options (several towers, the shared relation model,
    # the learned query, an activation), the xla route, steps_per_call and
    # a multi-tower .pth
    option_runs, towers_task, towers_model = run_options(dataset, device)
    runs.update(option_runs)
    runs["xla"] = run_xla(dataset, device)
    runs["steps_per_call"] = run_steps_per_call(dataset, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        runs["towers .pth"] = run_towers_pth(towers_task, towers_model,
                                             device, Path(tmp))
    del towers_task, towers_model
    # the dataset catalog's parsers on files in the public formats, then
    # data parallelism over two ranks (K1, K2 on each; K9 composed)
    if cuda:
        release_device_memory()
    runs.update(run_new_phases(device))
    # the partitioned path, the ring's extremum, pair and moments
    # schedules and the edge-sharded relation tower (K1, K1h, K2, K2h, K3
    # a shard; K9 on the ring)
    if cuda:
        release_device_memory()
    runs.update(run_edge_phases(device))
    # edge shards on several cards and data 2 x edge 2 on four (each logs
    # that it is not run on a host with too few cards)
    if cuda:
        release_device_memory()
    card_runs, k9_cards = run_card_phases(device)
    runs.update(card_runs)
    # training at length: the learning check on three paths with the card
    # vs CPU trajectory, and the endurance run's short form (K1, K2; K1h,
    # K2h; K9)
    if cuda:
        release_device_memory()
    runs.update(run_training_phases(device))
    ids = list(KERNEL_IDS)
    if k9_cards is not None:
        entries["K9 cards"] = k9_cards
        ids.append("K9 cards")

    if not cuda:
        log("[rehearsal] phases 1b-55 ran on the CPU; no kernel ran and no "
            "result is reported")
        return 1
    finish_entries(entries, runs, {"K9 cards": "K9x"})
    log(nvidia_smi_line())
    print(json.dumps({"kernels": [entries[k] for k in ids]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def inference_config(dataset: dict, compute_dtype: str) -> dict:
    """config/transductive/inference.yaml as run_full.main loads it (no
    checkpoint, no training), with ``dataset`` and the entity tower's
    ``compute_dtype`` set, and the eval batch pinned to EVAL_BATCH (the
    timed batches of the phases that build from it)."""
    from ultra_torchdrug_tpu_torch.utils.config import load_config

    cfg = load_config(str(REPO / "config/transductive/inference.yaml"),
                      context=dict(dataset=dataset["class"], gpus=[0],
                                   epochs=0, bpe=0, ckpt=None))[0]
    cfg["dataset"] = dict(dataset)
    cfg["task"]["model"]["compute_dtype"] = compute_dtype
    cfg["task"]["eval_batch_size"] = EVAL_BATCH
    return cfg


def run_ultra_bf16(size: dict, device) -> dict:
    """ULTRA (config/transductive/inference.yaml's model and task: 6x64,
    distmult, sum, layer norm, short-cut, project) with compute_dtype:
    bfloat16, on chip_smoke's KG through build_dataset, build_task and
    build_engine: evaluation (K1h 12 times per batch of 16, the relation
    tower on its dense fp32 route), its profile, card vs CPU scores, the
    bf16 − fp32 score difference and both MRRs on the same weights; then
    Engine.train at batch 64 with 128 strict negatives and AdamW (K1h and
    K2h 6 times each per step), its profile, and one loss step's gradients
    against the CPU. Returns the launch counts by half."""
    from ultra_torchdrug_tpu_torch.engine.build import (
        build_dataset,
        build_engine,
        build_task,
    )

    cuda = device.type == "cuda"
    spec = {"class": "SynthKG", **size}
    cfg = inference_config(spec, "bfloat16")
    t0 = time.perf_counter()
    dataset = build_dataset(cfg["dataset"])
    task = build_task(cfg["task"], dataset, device=device)
    model = task.init_params(seed=0)
    log(f"[ultra bf16] {spec}, model {cfg['task']['model']}: set-up "
        f"{time.perf_counter() - t0:.1f} s; dense relation graph: "
        f"{task.rel_graph.prepare_dense().dense_adj is not None}")
    log_policies("ultra bf16", task, TRAIN["batch"])
    eval_counts = phase_slice(task, model, device,
                              {"K1h": K1_LAUNCHES_PER_BATCH},
                              label="ultra bf16")
    if cuda:
        profile_device_time("one ultra bf16 eval batch", lambda: task.evaluate(
            model, "test", batch_size=EVAL_BATCH, fast_test=EVAL_BATCH))
    phase_parity(task, model, device, atol=BF16_SCORE_ATOL,
                 label="ultra bf16 parity")
    f32_task = build_task(inference_config(spec, "float32")["task"], dataset,
                          device=device)
    compare_dtypes(task, f32_task, model, device)
    del task, f32_task, model

    train_size = TRAIN if cuda else TRAIN_REHEARSAL
    cfg["task"]["num_negative"] = train_size["negatives"]
    cfg["engine"].update(batch_size=train_size["batch"], log_interval=10**9)
    with tempfile.TemporaryDirectory() as work_dir:
        engine = build_engine(cfg, build_task(cfg["task"], dataset,
                                              device=device),
                              work_dir=work_dir, seed=0)
        log(f"[ultra bf16 train] batch {train_size['batch']}, "
            f"{train_size['negatives']} negatives, {cfg['optimizer']}")
        train_counts = phase_train(engine, train_size, device,
                                   {"K1h": K_LAUNCHES_PER_STEP,
                                    "K2h": K_LAUNCHES_PER_STEP},
                                   label="ultra bf16 train")
        if cuda:
            profile_device_time("one ultra bf16 train step",
                                lambda: engine.train(batch_per_epoch=1))
        cpu_cfg = dict(cfg["task"], num_negative=8)
        phase_train_parity(engine, build_task(cpu_cfg, dataset, device="cpu"),
                           device, grad_rtol=BF16_GRAD_RTOL,
                           loss_rtol=BF16_LOSS_RTOL,
                           label="ultra bf16 train parity")
    return {"eval": eval_counts, "train": train_counts}


def ring_config(spec: dict) -> dict:
    """inference.yaml's model and task (fp32) with the ring keys:
    parallel: {edge: RING_SHARDS}, rspmm_impl: ring, ring_exchange: rdma,
    the entity tower cut to RING_LAYERS layers."""
    cfg = inference_config(spec, "float32")
    cfg["parallel"] = {"edge": RING_SHARDS}
    cfg["rspmm_impl"] = "ring"
    cfg["task"]["model"]["ring_exchange"] = "rdma"
    cfg["task"]["model"]["hidden_dims"] = (
        cfg["task"]["model"]["hidden_dims"][:RING_LAYERS])
    return cfg


def run_ultra_ring(size: dict, device) -> dict:
    """ULTRA on the ring (``ring_config``) on chip_smoke's KG through
    build_dataset, mesh_scope, build_task and build_engine: evaluation, its
    profile and its scores against the single-device model on the same
    weights on the same device; then Engine.train at batch 64 with 128
    strict negatives and AdamW, its profile, and one loss step against the
    single-device step. Returns the launch counts by half."""
    from ultra_torchdrug_tpu_torch.engine.build import (
        build_dataset,
        build_engine,
        build_task,
        mesh_scope,
    )
    from ultra_torchdrug_tpu_torch.parallel.mesh import use_mesh
    from ultra_torchdrug_tpu_torch.parallel.ring_rspmm import (
        build_ring_rspmm_inputs,
    )

    cuda = device.type == "cuda"
    spec = {"class": "SynthKG", **size}
    cfg = ring_config(spec)
    dataset = build_dataset(cfg["dataset"])

    def ring_task(cfg_task):
        with mesh_scope(cfg, device) as (mesh, edge_axis, rel_edge_axis):
            return mesh, build_task(cfg_task, dataset,
                                    rspmm_impl=cfg["rspmm_impl"],
                                    device=device, edge_axis=edge_axis,
                                    rel_edge_axis=rel_edge_axis)

    t0 = time.perf_counter()
    mesh, task = ring_task(cfg["task"])
    model = task.init_params(seed=0)
    seconds = time.perf_counter() - t0
    # the buckets the task built (balance "auto"), for the launch counts
    und = task.fact_graph.undirected_with_inverse()
    ri = build_ring_rspmm_inputs(und.edge_index.numpy(),
                                 und.edge_type.numpy(), und.num_nodes,
                                 RING_SHARDS, balance="auto")
    buckets, steps = ri.nonempty_buckets, RING_SHARDS - 1
    layers = len(task.model_cfg.entity.hidden_dims)
    log(f"[ultra ring] {spec}, mesh {mesh.shape} on {mesh.device}, "
        f"entity tower rspmm_impl={task.model_cfg.entity.rspmm_impl} "
        f"edge_axis={task.model_cfg.entity.edge_axis!r} ring_exchange="
        f"{task.model_cfg.entity.ring_exchange}: set-up {seconds:.1f} s; "
        f"v_block {ri.v_block}, {buckets} of {RING_SHARDS ** 2} buckets "
        f"with edges (min {ri.edge_counts.min()}, max "
        f"{ri.edge_counts.max()} edges), relabelled: "
        f"{ri.to_new is not None}")
    log_policies("ultra ring", task, TRAIN["batch"])
    with use_mesh(mesh):
        eval_counts = phase_slice(
            task, model, device, {"K1": 2 * layers * buckets,
                                  "K9": 2 * layers * steps},
            label="ultra ring")
        if cuda:
            profile_device_time("one ultra ring eval batch",
                                lambda: task.evaluate(
                                    model, "test", batch_size=EVAL_BATCH,
                                    fast_test=EVAL_BATCH))
    single = build_task(cfg["task"], dataset, device=device)
    phase_parity(task, model, device, atol=RING_SCORE_ATOL,
                 label="ultra ring parity", ref_task=single,
                 ref_device=device, mesh=mesh, queries=EVAL_BATCH)
    del task, model, single

    train_size = TRAIN if cuda else TRAIN_REHEARSAL
    cfg["task"]["num_negative"] = train_size["negatives"]
    cfg["engine"].update(batch_size=train_size["batch"], log_interval=10**9)
    with tempfile.TemporaryDirectory() as work_dir:
        mesh, task = ring_task(cfg["task"])
        engine = build_engine(cfg, task, work_dir=work_dir, seed=0, mesh=mesh)
        log(f"[ultra ring train] batch {train_size['batch']}, "
            f"{train_size['negatives']} negatives, {cfg['optimizer']}, "
            f"engine mesh {engine.mesh.shape}")
        train_counts = phase_train(engine, train_size, device,
                                   {"K1": layers * buckets,
                                    "K2": layers * buckets,
                                    "K9": 2 * layers * steps},
                                   label="ultra ring train")
        if cuda:
            profile_device_time("one ultra ring train step",
                                lambda: engine.train(batch_per_epoch=1))
        single = build_task(dict(cfg["task"], num_negative=8), dataset,
                            device=device)
        phase_train_parity(engine, single, device, grad_rtol=RING_GRAD_RTOL,
                           label="ultra ring train parity",
                           ref_device=device)
    return {"eval": eval_counts, "train": train_counts}


def phase_ring_cli(device) -> dict:
    """``run_full.main`` on config/synthetic/smoke.yaml rendered with the
    ring keys (``ring_config``'s three): one epoch of 5 steps, a checkpoint,
    a log and anomaly mode on an edge mesh of RING_SHARDS shards. Returns
    its launch counts; K1, K2 and K9 must launch on the card."""
    import yaml

    from ultra_torchdrug_tpu_torch import run_full

    with tempfile.TemporaryDirectory() as tmp:
        text = (REPO / "config/synthetic/smoke.yaml").read_text()
        cfg = yaml.safe_load(text.replace("{{ outdir }}", tmp))
        cfg.update(parallel={"edge": RING_SHARDS}, rspmm_impl="ring")
        cfg["task"]["model"]["ring_exchange"] = "rdma"
        path = Path(tmp) / "smoke_ring.yaml"
        path.write_text(yaml.safe_dump(cfg))
        reset_launch_counts()
        t0 = time.perf_counter()
        engine = run_full.main(["-c", str(path), "--device", str(device)])
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        files = os.listdir(engine.work_dir)
        metrics = engine.metrics["test"]
        entity = engine.task.model_cfg.entity
        if (engine.epoch != 1 or engine.mesh is None
                or engine.mesh.edge != RING_SHARDS
                or entity.edge_axis != "edge"
                or engine.task.model_cfg.relation.edge_axis != ""
                or "log.txt" not in files
                or not any(f.endswith(".ckpt") for f in files)
                or not all(math.isfinite(v) for v in metrics.values())):
            raise AssertionError(f"ring cli: epoch {engine.epoch}, mesh "
                                 f"{engine.mesh}, files {files}, metrics "
                                 f"{metrics}")
        used = {k: v for k, v in counts.items() if v}
        if device.type == "cuda" and not all(used.get(k)
                                             for k in ("K1", "K2", "K9")):
            raise AssertionError(f"ring cli: launches {used}")
        log(f"[ring cli] smoke.yaml with parallel {cfg['parallel']}, "
            f"rspmm_impl ring, ring_exchange rdma: {seconds:.1f} s on "
            f"{device}, epoch {engine.epoch}, mesh {engine.mesh.shape}, "
            f"files {sorted(files)}, test mrr {metrics['mrr']:.6f}, "
            f"launches {used}")
    return {"ring smoke": counts}


def rankings_of(task, model, triples) -> np.ndarray:
    """The filtered rankings [N, 2] of ``triples`` through the task's eval
    function in batches of EVAL_BATCH."""
    return task._run_eval(task._eval_fn, model, triples, EVAL_BATCH)[0]


def phase_checkpoint(task, model, device, pth_dir: Path) -> tuple:
    """Phase 31: the reference .pth route. The seeded ULTRA of phase 2
    exported with the port's exporter, loaded by Engine.load into fresh
    engines of other seeds (the file as written, and with DDP's module.
    prefix on every key): phase 2's FAST_TEST test triples must rank
    exactly as phase 2's model ranks them, with K1 12 times per batch and
    no other kernel; with fix_reasoner every relation projection and
    relation embedding keeps the fresh model's value bitwise and every
    other weight is the file's; then run_full.main on
    config/transductive/inference.yaml with the file as its checkpoint.
    Returns (launch counts by half, the .pth path)."""
    from ultra_torchdrug_tpu_torch.engine.engine import Engine
    from ultra_torchdrug_tpu_torch.utils.checkpoint import (
        export_torch_checkpoint,
        is_reasoner_key,
    )
    from ultra_torchdrug_tpu_torch.utils.logging import get_root_logger

    def fresh_engine(seed):
        engine = Engine(task, batch_size=EVAL_BATCH, seed=seed,
                        log_interval=10**9, logger=get_root_logger(None))
        if all(torch.equal(a, b) for a, b in zip(engine.model.parameters(),
                                                 model.parameters())):
            raise AssertionError(f"seed {seed} gave phase 2's weights")
        return engine

    path = pth_dir / "ultra_seeded.pth"
    export_torch_checkpoint(str(path), model)
    state = torch.load(path, weights_only=True)
    prefixed = pth_dir / "ultra_seeded_ddp.pth"
    torch.save({"model": {f"module.{k}": v for k, v in state["model"].items()},
                "optimizer": {}}, prefixed)
    log(f"[checkpoint] exported {len(state['model'])} tensors to "
        f"{path.name} ({path.stat().st_size / 2**20:.2f} MiB), and with the "
        "module. prefix")
    triples = task._fast_subset(task.dataset.test, FAST_TEST)
    want = rankings_of(task, model, triples)
    batches = math.ceil(len(triples) / EVAL_BATCH)
    counts = {}
    for seed, file in ((1, path), (2, prefixed)):
        engine = fresh_engine(seed)
        engine.load(str(file))
        reset_launch_counts()
        got = rankings_of(task, engine.model, triples)
        if device.type == "cuda":
            torch.cuda.synchronize()
        half = f"eval {file.name}"
        counts[half] = launch_counts()
        check_launches(f"checkpoint {file.name}", counts[half],
                       {"K1": K1_LAUNCHES_PER_BATCH}, batches, device)
        if not np.array_equal(got, want):
            raise AssertionError(f"{file.name}: rankings differ from phase "
                                 f"2's in {int((got != want).sum())} entries")
        log(f"[checkpoint] {file.name} into a fresh engine (seed {seed}): "
            f"{len(triples)} test triples rank exactly as phase 2's; "
            f"launches {counts[half]}")
    engine = fresh_engine(3)
    current = {k: v.clone() for k, v in engine.model.state_dict().items()}
    engine.load(str(path), fix_reasoner=True)
    kept = 0
    for k, v in engine.model.state_dict().items():
        want_v = current[k] if is_reasoner_key(k) else state["model"][k]
        kept += is_reasoner_key(k)
        if not torch.equal(v.cpu(), want_v.cpu()):
            raise AssertionError(f"fix_reasoner: {k}")
    log(f"[checkpoint] fix_reasoner: {kept} reasoner tensors kept bitwise, "
        f"{len(current) - kept} loaded from the file")
    del engine
    with tempfile.TemporaryDirectory() as tmp, in_directory(tmp):
        counts["cli"], engine = cli_run(
            "inference .pth",
            ["-c", str(REPO / "config/transductive/inference.yaml"),
             "--dataset", "SynthKG", "--epochs", "0", "--bpe", "0", "--gpus",
             "[0]", "--ckpt", str(path)], device, 0)
        for k, v in engine.model.state_dict().items():
            if not torch.equal(v.cpu(), state["model"][k]):
                raise AssertionError(f"cli inference .pth: {k} not loaded")
    return counts, path


# ILPC 2022's "large" split (Galkin et al., 2022): the training graph's
# entities and triples, the inference graph's, its validation and test
# triples, and the relations both share
ILPC_LARGE = dict(train_entities=46626, train_triples=202446,
                  inference_entities=29246, inference_triples=77044,
                  valid=10179, test=10184, relations=65)
ILPC_REHEARSAL = dict(train_entities=1500, train_triples=8000,
                      inference_entities=1000, inference_triples=4000,
                      valid=300, test=600, relations=20)
INDUCTIVE_TEST, INDUCTIVE_VALID = 512, 64


def inductive_dataset(counts: dict):
    """An inductive KG with ``counts``, from two synthetic_transductive
    draws as synthetic_inductive makes its small one: the training graph's
    triples (the train split and the transductive filter graph), and the
    inference graph's, cut into its propagation edges, validation and test
    triples (use_inductive_valid: valid and test on the inference graph)."""
    from ultra_torchdrug_tpu_torch.data.datasets import (
        InductiveDataset,
        synthetic_transductive,
    )
    from ultra_torchdrug_tpu_torch.data.graph import Graph

    R = counts["relations"]
    trans = synthetic_transductive(
        "ILPC-large-train", counts["train_entities"], counts["train_triples"],
        R, seed=0, valid_frac=0.0, test_frac=0.0)
    total = (counts["inference_triples"] + counts["valid"] + counts["test"])
    ind = synthetic_transductive(
        "ILPC-large-inference", counts["inference_entities"], total, R,
        seed=1, valid_frac=counts["valid"] / total,
        test_frac=counts["test"] / total)
    inference = Graph.from_triplets(ind.train, ind.num_entities, R)
    return InductiveDataset(
        name="ILPC-large-synthetic",
        train_graph=Graph.from_triplets(trans.train, trans.num_entities, R),
        valid_graph=inference, test_graph=inference, graph=trans.graph,
        inductive_graph=ind.graph, train=trans.train, valid=ind.valid,
        test=ind.test)


def inductive_config(ckpt) -> dict:
    """config/inductive/inference.yaml as run_full.main loads it for
    SynthInductiveKG with --epochs 0 and ``ckpt``."""
    from ultra_torchdrug_tpu_torch.utils.config import load_config

    return load_config(str(REPO / "config/inductive/inference.yaml"),
                       context=dict(dataset="SynthInductiveKG", version="v1",
                                    gpus=[0], epochs=0, bpe=0, ckpt=ckpt))[0]


def run_inductive(device, pth: Path) -> dict:
    """Phases 32-33: zero-shot inductive evaluation. The task of
    config/inductive/inference.yaml's model and task sections (its default
    metrics: hits@10_50 among them) through build_task on a generated KG
    with ILPC 2022 large's counts, the weights of phase 31's .pth:
    INDUCTIVE_TEST test and INDUCTIVE_VALID valid triples in batches of 16
    over the inference graph (K1 12 times per batch and no other kernel,
    every metric finite), one batch profiled, the card's scores for 2
    queries against the port's CPU run; then run_full.main on the config
    rendered for SynthInductiveKG with --epochs 0 and the .pth. Returns the
    launch counts by half."""
    from ultra_torchdrug_tpu_torch.engine.build import build_task
    from ultra_torchdrug_tpu_torch.utils.checkpoint import (
        import_torch_checkpoint,
    )

    cuda = device.type == "cuda"
    counts = ILPC_LARGE if cuda else ILPC_REHEARSAL
    t0 = time.perf_counter()
    dataset = inductive_dataset(counts)
    cfg = inductive_config(None)
    cfg["task"]["eval_batch_size"] = EVAL_BATCH
    task = build_task(cfg["task"], dataset, device=device)
    model = task.init_params(seed=3)
    model.load_state_dict(import_torch_checkpoint(str(pth),
                                                  model.state_dict()))
    graph = task.graphs["test"]
    log(f"[inductive] {counts}: train graph {dataset.train_graph.num_nodes} "
        f"entities / {dataset.train_graph.num_edges} triples, inference "
        f"graph {graph.num_nodes} / {graph.num_edges}, {len(dataset.valid)} "
        f"valid / {len(dataset.test)} test triples, {task.num_relations} "
        f"relations; valid graph is the test graph: "
        f"{task.graphs['valid'] is graph}; metrics {task.cfg.metrics}; "
        f"set-up {time.perf_counter() - t0:.1f} s")
    log_policies("inductive", task, TRAIN["batch"])
    per_batch = {"K1": K1_LAUNCHES_PER_BATCH}
    runs = {"eval test": phase_slice(task, model, device, per_batch,
                                     label="inductive", split="test",
                                     triples=INDUCTIVE_TEST),
            "eval valid": phase_slice(task, model, device, per_batch,
                                      label="inductive", split="valid",
                                      triples=INDUCTIVE_VALID)}
    if len(task._eval_fns) != 1:
        raise AssertionError("valid and test, one graph, were prepared "
                             f"{len(task._eval_fns)} times")
    if cuda:
        profile_device_time("one inductive eval batch", lambda: task.evaluate(
            model, "test", batch_size=EVAL_BATCH, fast_test=EVAL_BATCH))
    phase_parity(task, model, device, label="inductive parity",
                 split_graphs=(graph, task.rel_graphs["test"]))
    del task, model
    with tempfile.TemporaryDirectory() as tmp, in_directory(tmp):
        runs["cli"], engine = cli_run(
            "inductive inference .pth",
            ["-c", str(REPO / "config/inductive/inference.yaml"),
             "--dataset", "SynthInductiveKG", "--version", "v1", "--epochs",
             "0", "--bpe", "0", "--gpus", "[0]", "--ckpt", str(pth)],
            device, 0)
        if "hits@10_50" not in engine.metrics["test"]:
            raise AssertionError(f"inductive cli: {engine.metrics['test']}")
    return runs


# the pre-training mixture of config/transductive/pretrain_3g.yaml at the
# public datasets' counts: (name, entities, relations, train, valid, test)
PRETRAIN_GRAPHS = (("FB15k-237", 14541, 237, 272115, 17535, 20466),
                   ("WN18RR", 40943, 11, 86835, 3034, 3134),
                   ("CoDEx-M", 17050, 51, 185584, 10310, 10311))
PRETRAIN_REHEARSAL = (("FB15k-237", 1500, 40, 12000, 500, 500),
                      ("WN18RR", 3000, 11, 5000, 300, 300),
                      ("CoDEx-M", 1200, 20, 9000, 400, 400))
PRETRAIN_MIX_STEPS = 12  # steps drawn from the mixture
PRETRAIN_TIMED = 3  # timed steps a graph, after its warm-up step


def pretrain_dataset(graphs):
    """A JointDataset of generated graphs with ``graphs``' counts, each
    from synthetic_transductive with its valid and test shares."""
    from ultra_torchdrug_tpu_torch.data.datasets import (
        JointDataset,
        synthetic_transductive,
    )

    parts = []
    for seed, (name, V, R, train, valid, test) in enumerate(graphs):
        total = train + valid + test
        parts.append(synthetic_transductive(
            name, V, total, R, seed=seed, valid_frac=valid / total,
            test_frac=test / total))
    return JointDataset("pretrain-3g-synthetic", parts)


def pretrain_config(size=None) -> dict:
    """config/transductive/pretrain_3g.yaml as run_full loads it, logging
    no step window; ``size`` (the CPU rehearsal's) replaces its batch and
    negatives."""
    from ultra_torchdrug_tpu_torch.utils.config import load_config

    cfg = load_config(str(REPO / "config/transductive/pretrain_3g.yaml"),
                      context=dict(gpus=[0]))[0]
    if size is not None:
        cfg["task"]["num_negative"] = size["negatives"]
        cfg["engine"]["batch_size"] = size["batch"]
    cfg["engine"]["log_interval"] = 10**9
    return cfg


def run_pretrain(device) -> dict:
    """Phases 34-36: multi-graph pre-training. A JointDataset of three
    generated graphs with FB15k-237's, WN18RR's and CoDEx-M's counts, the
    task, optimizer and engine sections of pretrain_3g.yaml through
    build_task and build_engine (batch 64, 128 strict negatives, AdamW 5e-4):
    Engine.train draws PRETRAIN_MIX_STEPS steps from the mixture, then any
    graph with fewer than a warm-up step and PRETRAIN_TIMED timed steps gets
    its missing steps through the engine's step; K1 and K2 6 times each a
    step and no other kernel; per graph the ms a step, one step's device
    time under torch.profiler and its peak memory. Then evaluation with
    fast_test 64 (three finite per_graph sets, the mean mrr), one loss step
    on the graph with the fewest train triples against the port's CPU run,
    and run_full.run on pretrain_3g.yaml rendered for SynthJoint with one
    epoch of 3 batches. Returns the launch counts by half."""
    from ultra_torchdrug_tpu_torch.engine.build import (
        build_engine,
        build_task,
    )

    cuda = device.type == "cuda"
    cfg = pretrain_config(None if cuda else TRAIN_REHEARSAL)
    t0 = time.perf_counter()
    dataset = pretrain_dataset(PRETRAIN_GRAPHS if cuda
                               else PRETRAIN_REHEARSAL)
    with tempfile.TemporaryDirectory() as work_dir:
        engine = build_engine(cfg, build_task(cfg["task"], dataset,
                                              device=device),
                              work_dir=work_dir, seed=0)
        task = engine.task
        names = [d.name for d in dataset.datasets]
        log(f"[pretrain] " + "; ".join(
            f"{d.name}: {d.num_entities} entities, {d.num_relations} "
            f"relations, {len(d.train)} / {len(d.valid)} / {len(d.test)} "
            f"triples" for d in dataset.datasets)
            + f"; mixture {np.round(task._graph_probs, 4).tolist()}, "
            f"relation count {task.num_relations}; batch "
            f"{engine.batch_size}, {task.cfg.num_negative} negatives, "
            f"{cfg['optimizer']}; set-up {time.perf_counter() - t0:.1f} s")
        log_policies("pretrain", task, engine.batch_size)
        step_ms = {gid: [] for gid in range(task.num_graphs)}
        run_step = engine._run_step

        def timed_step(gid, batch):
            if cuda:
                torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = run_step(gid, batch)
            if cuda:
                torch.cuda.synchronize()
            step_ms[gid].append((time.perf_counter() - t) * 1e3)
            if not all(math.isfinite(float(v)) for v in metrics.values()):
                raise AssertionError(f"pretrain {names[gid]}: {metrics}")
            return metrics

        def graph_batch(gid):
            edges = task.train_triples[gid]
            return engine._full_batch(
                edges, engine.rng.permutation(len(edges))[:engine.batch_size])

        engine._run_step = timed_step
        reset_launch_counts()
        engine.train(batch_per_epoch=PRETRAIN_MIX_STEPS)
        drawn = {names[g]: len(v) for g, v in step_ms.items()}
        for gid in step_ms:
            while len(step_ms[gid]) < 1 + PRETRAIN_TIMED:
                timed_step(gid, graph_batch(gid))
        steps = sum(len(v) for v in step_ms.values())
        counts = {"train": launch_counts()}
        check_launches("pretrain train", counts["train"],
                       {"K1": K_LAUNCHES_PER_STEP, "K2": K_LAUNCHES_PER_STEP},
                       steps, device)
        engine._run_step = run_step
        log(f"[pretrain] {steps} steps: {drawn} drawn from the mixture in "
            f"{PRETRAIN_MIX_STEPS}, the rest forced; launches "
            f"{counts['train']}")
        for gid, name in enumerate(names):
            timed = step_ms[gid][1:]
            peak, device_ms = float("nan"), None
            if cuda:
                batch = graph_batch(gid)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                device_ms = profile_device_time(
                    f"one pretrain step on {name}",
                    lambda: run_step(gid, batch))
                peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"[pretrain] {name}: {sum(timed) / len(timed):.2f} ms per "
                f"step over {len(timed)} timed steps (warm-up "
                f"{step_ms[gid][0]:.1f} ms), device "
                f"{'not measured' if device_ms is None else f'{device_ms:.3f} ms'}"
                f" a step, peak device memory {peak:.3f} GiB ({device})")

        reset_launch_counts()
        metrics = engine.evaluate("test", fast_test=FAST_TEST)
        counts["eval"] = launch_counts()
        eval_batches = [task._resolve_eval_batch(engine.batch_size,
                                                 g.num_nodes)
                        for g in task.fact_graphs]
        batches = sum(math.ceil(min(FAST_TEST, len(d.test)) / b)
                      for d, b in zip(dataset.datasets, eval_batches))
        check_launches("pretrain eval", counts["eval"],
                       {"K1": K1_LAUNCHES_PER_BATCH}, batches, device)
        per_graph = metrics["per_graph"]
        mean = float(np.mean([m["mrr"] for m in per_graph.values()]))
        if (set(per_graph) != set(names) or not finite_metrics(metrics)
                or abs(metrics["mrr"] - mean) > 1e-12):
            raise AssertionError(f"pretrain eval: {metrics}")
        log(f"[pretrain eval] fast_test {FAST_TEST} a graph, auto eval "
            f"batches {eval_batches}: mrr {metrics['mrr']:.6f} = mean of "
            + ", ".join(f"{n} {m['mrr']:.6f}" for n, m in per_graph.items())
            + f"; launches {counts['eval']}")
        smallest = int(np.argmin([len(t) for t in task.train_triples]))
        cpu_task = build_task(dict(cfg["task"], num_negative=8), dataset,
                              device="cpu")
        phase_train_parity(engine, cpu_task, device,
                           label=f"pretrain train parity {names[smallest]}",
                           graph_id=smallest)
        del engine, task, cpu_task

    cli_cfg = pretrain_config()
    cli_cfg["dataset"] = {"class": "SynthJoint", "num_graphs": 3}
    cli_cfg["train"].update(num_epoch=1, batch_per_epoch=3)
    with tempfile.TemporaryDirectory() as tmp:
        cli_cfg["output_dir"] = tmp
        counts["cli"], engine = cli_run(
            "pretrain_3g.yaml on SynthJoint (train.num_epoch 10 -> 1, "
            "train.batch_per_epoch 20000 -> 3)", None, device, 1, cfg=cli_cfg)
        if (engine.meter.global_step != 3
                or len(engine.metrics["test"]["per_graph"]) != 3):
            raise AssertionError(f"pretrain cli: {engine.metrics['test']}")
    return counts


def compare_dtypes(task, f32_task, model, device):
    """The bf16 and the fp32 model (the conv layers carry the compute
    dtype) on the same weights: their score difference for 2 test queries
    and both MRRs on FAST_TEST test triples."""
    batch = torch.from_numpy(task.dataset.test[:2].astype(np.int64)).to(device)
    f32_model = f32_task.init_params(seed=1)
    f32_model.load_state_dict(model.state_dict())
    scores, mrr = [], []
    for t, model in ((task, model), (f32_task, f32_model)):
        und, rel_graph = t._prepare_graphs(t.fact_graph, t.rel_graph)
        with torch.inference_mode():
            scores.append(torch.cat(t._eval_scores(
                model, t.fact_graph, rel_graph, batch[:, 0], batch[:, 1],
                batch[:, 2], und)))
        mrr.append(t.evaluate(model, "test", batch_size=EVAL_BATCH,
                              fast_test=FAST_TEST)["mrr"])
    diff = (scores[0] - scores[1]).abs()
    log(f"[ultra bf16 vs fp32] same weights, 2 queries, tail and head "
        f"scores: max |bf16 - fp32| {diff.max().item():.4g}, mean "
        f"{diff.mean().item():.4g} (scores' spread {scores[1].std().item():.4g}"
        f"); MRR on {FAST_TEST} test triples: bf16 {mrr[0]:.6f}, fp32 "
        f"{mrr[1]:.6f}")


def finite_metrics(metrics: dict) -> bool:
    """Every metric finite, a multi-graph run's ``per_graph`` ones too."""
    return all(finite_metrics(v) if isinstance(v, dict) else math.isfinite(v)
               for v in metrics.values())


def cli_run(label: str, argv, device, want_epoch: int, cfg=None) -> tuple:
    """``run_full.main(argv)`` (``run_full.run(cfg)`` when ``cfg`` is given)
    on the device between a reset and a read of the launch counts: the
    engine's epoch must be ``want_epoch``, its work dir must hold log.txt
    (and a checkpoint after training), its test metrics must be finite, and
    K1 (and K2 after training) must launch on the card. Returns (launch
    counts, engine)."""
    from ultra_torchdrug_tpu_torch import run_full

    reset_launch_counts()
    t0 = time.perf_counter()
    if cfg is None:
        engine = run_full.main(list(argv) + ["--device", device.type])
    else:
        engine = run_full.run(cfg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    files = os.listdir(engine.work_dir)
    metrics = engine.metrics["test"]
    if (engine.epoch != want_epoch or "log.txt" not in files
            or (want_epoch and not any(f.endswith(".ckpt") for f in files))
            or not finite_metrics(metrics)):
        raise AssertionError(f"cli {label}: epoch {engine.epoch}, files "
                             f"{files}, metrics {metrics}")
    used = {k: v for k, v in counts.items() if v}
    if device.type == "cuda" and not (
            used.get("K1") and (not want_epoch or used.get("K2"))):
        raise AssertionError(f"cli {label}: launches {used}")
    log(f"[cli] {label}: {seconds:.1f} s on {device}, epoch {engine.epoch}, "
        f"files {sorted(files)}, test mrr {metrics['mrr']:.6f}, launches "
        f"{used}")
    log_policies(f"cli {label}", engine.task, engine.batch_size)
    return counts, engine


@contextlib.contextmanager
def in_directory(path):
    """Run the scope in ``path`` (the shipped inference and pre-training
    configs write under ./output)."""
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


def phase_cli(device) -> dict:
    """The CLI on the device: ``run_full.main`` on
    config/synthetic/smoke.yaml (one epoch of 5 steps, a checkpoint, a log,
    anomaly mode on), then on config/transductive/inference.yaml with
    ``--dataset SynthKG --epochs 0 --bpe 0 --gpus [0] --ckpt null`` in a
    temporary directory. Returns the launch counts of each run; K1 and K2
    must launch on the card."""
    counts = {}
    with tempfile.TemporaryDirectory() as tmp, in_directory(tmp):
        runs = (("smoke", ["-c", str(REPO / "config/synthetic/smoke.yaml"),
                           "--outdir", tmp], 1),
                ("inference", ["-c", str(REPO / "config/transductive/"
                                         "inference.yaml"),
                               "--dataset", "SynthKG", "--epochs", "0",
                               "--bpe", "0", "--gpus", "[0]", "--ckpt",
                               "null"], 0))
        for label, argv, want_epoch in runs:
            counts[label], engine = cli_run(label, argv, device, want_epoch)
            del engine
    return counts


def run_classic(dataset, device, label: str, variant: dict,
                eval_per_pass: dict, train_per_step) -> tuple:
    """Classic NBFNet (6x32, dependent relations, layer norm, seeded
    weights; ``variant`` sets the message and aggregation) on the dataset:
    evaluation through ClassicNBFNetTask.evaluate (``eval_per_pass``
    launches per scoring direction, two per batch), its profile and its
    card-vs-CPU scores, then, unless ``train_per_step`` is None,
    Engine.train at batch 64, 32 strict negatives and Adam at lr 5e-3
    (``train_per_step`` launches per step), its profile and one loss step's
    gradients against the CPU. Returns the launch counts of the measured
    eval run and, with training, of the train run, by half."""
    from ultra_torchdrug_tpu_torch.models.classic_nbfnet import (
        classic_nbfnet_config,
    )
    from ultra_torchdrug_tpu_torch.tasks.task import (
        ClassicNBFNetTask,
        TaskConfig,
    )

    cuda = device.type == "cuda"
    nbf_cfg = classic_nbfnet_config(num_relations=dataset.num_relations,
                                    layer_norm=True, **variant)
    t0 = time.perf_counter()
    task = ClassicNBFNetTask(dataset, nbf_cfg, TaskConfig(
        eval_batch_size=EVAL_BATCH), device=device)
    model = task.init_params(seed=0)
    log(f"[{label}] {nbf_cfg.message_func}, {nbf_cfg.aggregate_func}: task "
        f"set-up {time.perf_counter() - t0:.1f} s; "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    eval_counts = phase_slice(task, model, device,
                              {k: 2 * v for k, v in eval_per_pass.items()},
                              label=label)
    if cuda:
        profile_device_time(f"one {label} eval batch", lambda: task.evaluate(
            model, "test", batch_size=EVAL_BATCH, fast_test=EVAL_BATCH))
    phase_parity(task, model, device, atol=CLASSIC_SCORE_ATOL,
                 label=f"{label} parity")
    if nbf_cfg.aggregate_func.startswith("pna"):
        phase_clip_crossings(task, model, device, label=f"{label} parity")
    del task, model
    if train_per_step is None:
        return {"eval": eval_counts}

    train_size = CLASSIC_TRAIN if cuda else CLASSIC_TRAIN_REHEARSAL
    engine = make_engine(
        ClassicNBFNetTask(dataset, nbf_cfg, TaskConfig(
            num_negative=train_size["negatives"], strict_negative=True,
            adversarial_temperature=1), device=device),
        train_size, f"{label} train", optimizer="Adam", lr=5e-3)
    train_counts = phase_train(engine, train_size, device, train_per_step,
                               label=f"{label} train")
    if cuda:
        profile_device_time(f"one {label} train step",
                            lambda: engine.train(batch_per_epoch=1))
    phase_train_parity(
        engine, ClassicNBFNetTask(dataset, nbf_cfg, TaskConfig(num_negative=8),
                                  device="cpu"), device,
        grad_rtol=CLASSIC_GRAD_RTOL, label=f"{label} train parity")
    return {"eval": eval_counts, "train": train_counts}


def log_policies(label: str, task, batch: int):
    """Log the memory policies that a task built from a shipped config
    (remat: auto) resolves on each of its propagation graphs."""
    if hasattr(task, "fact_graphs"):
        graphs = task.fact_graphs
    elif hasattr(task, "fact_graph"):
        graphs = [task.fact_graph]
    else:  # inductive: the train graph and the test split's
        graphs = [task.graphs["train"], task.graphs["test"]]
    for g in graphs:
        log(f"[{label}] policies on {g.num_nodes} entities at batch {batch}: "
            + policy_line(task, g, batch, batch))


def policy_line(task, fact_graph, batch: int, requested: int) -> str:
    """The memory policies a task resolves for a train step of ``batch``
    queries on ``fact_graph`` and its eval batch for a ``requested`` one."""
    cfg = task._train_model_cfg(fact_graph, batch)
    return (f"entity remat={cfg.entity.remat!r} micro_batch="
            f"{cfg.entity.micro_batch} stack={cfg.entity.stack!r}, relation "
            f"remat={cfg.relation.remat!r}; eval batch "
            f"{task._resolve_eval_batch(requested, fact_graph.num_nodes)} "
            f"(budget {task._budget_bytes() / 2**30:.2f} GiB, demotion level "
            f"{task._policy_demotion})")


def grad_step(task, model, generator, state, batch, *step):
    """One loss step's loss and gradients (no optimizer), with the negatives
    drawn from ``generator`` restored to ``state``."""
    generator.set_state(state)
    loss, _ = task.loss_step(model, generator, batch, *step)
    params = [p for p in model.parameters() if p.requires_grad]
    return loss.detach(), torch.autograd.grad(loss, params)


def compare_steps(label: str, got, want, loss_rtol: float,
                  grad_rtol: float) -> bool:
    """Raise unless ``got`` (loss, grads) matches ``want`` within the limits;
    returns whether they are bitwise equal."""
    (loss, grads), (want_loss, want_grads) = got, want
    if abs(loss.item() - want_loss.item()) > loss_rtol * max(
            1.0, abs(want_loss.item())):
        raise AssertionError(f"{label}: loss {loss.item()} vs "
                             f"{want_loss.item()}")
    worst = 0.0
    for a, b in zip(grads, want_grads):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{label}: non-finite gradient")
        worst = max(worst, ((a - b).norm() / b.norm().clamp(min=1e-12)).item())
    if worst > grad_rtol:
        raise AssertionError(f"{label}: gradient norm-wise error {worst:.3g}")
    bitwise = torch.equal(loss, want_loss) and all(
        torch.equal(a, b) for a, b in zip(grads, want_grads))
    log(f"[{label}] loss {loss.item():.8g} vs {want_loss.item():.8g}, "
        f"{len(grads)} gradients: worst norm-wise error {worst:.3g} (limits "
        f"{loss_rtol:g}, {grad_rtol:g}); bitwise: {bitwise}")
    return bitwise


def timed_grad_step(label: str, fn, device) -> dict:
    """fn once to warm up, then once timed (host clock around a synchronised
    call, its launches and peak memory), then once under the profiler."""
    cuda = device.type == "cuda"
    fn()
    base = math.nan
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2**30
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else math.nan
    device_ms = profile_device_time(label, fn) if cuda else None
    used = {k: v for k, v in counts.items() if v}
    log(f"[{label}] {ms:.2f} ms a step, device "
        f"{'not measured' if device_ms is None else f'{device_ms:.3f} ms'}, "
        f"peak device memory {peak:.3f} GiB, {peak - base:.3f} above the "
        f"{base:.3f} resident ({device}); launches {used}")
    return dict(out=out, counts=counts, ms=ms, peak=peak,
                step_peak=peak - base)


def step_launches(cfg, batch: int) -> dict:
    """K1 and K2 launches of one ULTRA train step under the entity tower's
    resolved policies (fp32 sums): per chunk of the batch L K1 forward and L
    K2, plus L K1 when the chunk is recomputed (micro-batches) and L when
    each layer is (full remat)."""
    from ultra_torchdrug_tpu_torch.models.nbfnet import remat_mode

    ent = cfg.entity
    return policy_step_launches(
        {"remat": remat_mode(ent.remat), "micro_batch": ent.micro_batch},
        batch, len(ent.hidden_dims))


def run_policies(dataset, device) -> tuple:
    """Phase 37: ULTRA (UltraConfig.default, 6x64 towers) on the smoke KG,
    one train step (batch 64, 128 strict negatives) from one set of weights,
    one batch and one draw of negatives under remat none, save_rspmm, full,
    and full with micro_batch 16: each mode's loss and gradients against
    none's (1e-6 relative, 1e-5 norm-wise), its ms, device ms, peak memory
    and launches (K1 6 / 6 / 12 and K2 6 a step for the first three). Then
    one eval batch with score_chunk 4096 against the unchunked scores
    (1e-6). Returns (launch counts by mode, none's (loss, peak GiB))."""
    from ultra_torchdrug_tpu_torch.engine.engine import Engine
    from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig
    from ultra_torchdrug_tpu_torch.tasks.task import (
        TaskConfig,
        TransductiveKGTask,
    )
    from ultra_torchdrug_tpu_torch.utils.logging import get_root_logger

    cuda = device.type == "cuda"
    size = TRAIN if cuda else TRAIN_REHEARSAL
    base = UltraConfig.default(dataset.num_relations)
    task = TransductiveKGTask(dataset, base, TaskConfig(
        num_negative=size["negatives"]), device=device)
    engine = Engine(task, batch_size=size["batch"], seed=0,
                    log_interval=10**9, logger=get_root_logger(None))
    _, (batch,) = next(engine._epoch_chunks(1))
    state = engine.generator.get_state()
    mb = size["batch"] // 4
    modes = (("none", False, 0), ("save_rspmm", "save_rspmm", 0),
             ("full", True, 0), (f"full micro_batch {mb}", True, mb))
    counts, results = {}, {}
    for name, remat, micro in modes:
        task.model_cfg = dataclasses.replace(
            base, entity=dataclasses.replace(base.entity, remat=remat,
                                             micro_batch=micro),
            relation=dataclasses.replace(base.relation, remat=remat))
        reading = timed_grad_step(
            f"policies {name}",
            lambda: grad_step(task, engine.model, engine.generator, state,
                              batch), device)
        results[name] = reading
        counts[f"step {name}"] = reading["counts"]
        check_launches(f"policies {name}", reading["counts"],
                       step_launches(task.model_cfg, size["batch"]), 1,
                       device)
    for name, reading in results.items():
        if name != "none":
            compare_steps(f"policies {name} vs none", reading["out"],
                          results["none"]["out"], 1e-6, 1e-5)

    task.model_cfg = base
    und, rel_graph = task._prepare_graphs(task.fact_graph, task.rel_graph)
    q = torch.from_numpy(dataset.test[:EVAL_BATCH].astype(np.int64)).to(device)
    chunked = dataclasses.replace(base, entity=dataclasses.replace(
        base.entity, score_chunk=4096))
    with torch.inference_mode():
        whole, parts = (torch.cat(task._eval_scores(
            engine.model, task.fact_graph, rel_graph, q[:, 0], q[:, 1],
            q[:, 2], und, model_cfg=cfg)) for cfg in (base, chunked))
    torch.testing.assert_close(parts, whole, rtol=1e-6, atol=1e-6)
    log(f"[policies] eval batch of {EVAL_BATCH} with score_chunk 4096 over "
        f"{task.fact_graph.num_nodes} entities: max_abs_err "
        f"{(parts - whole).abs().max().item():.3g} against the unchunked "
        f"scores (limit 1e-6); bitwise: {torch.equal(parts, whole)}")
    none = results["none"]
    return counts, (none["out"][0].item(), none["step_peak"])


# ATOMIC (Sap et al., 2019) at the counts the JAX package calibrates its
# memory policies on (script/diagnostics/train_memory.py): entities,
# relations, train triples; the valid and test splits are this phase's own
ATOMIC = dict(entities=304388, relations=9, train=610536, valid=5000,
              test=5000)
ATOMIC_REHEARSAL = dict(entities=3000, relations=9, train=12000, valid=300,
                        test=300)
ATOMIC_EVAL = 256  # test triples evaluated at the auto eval batch
ATOMIC_TIMED = 3  # timed steps after the warm-up step


def rank_ties(task, model, gid: int, triples: np.ndarray, band: float):
    """Per query and direction, the allowed candidates whose score lies
    within ``band`` of the target's ([N, 2]), from one scoring at a batch
    of len(triples)."""
    from ultra_torchdrug_tpu_torch.ops.match import (
        head_truth_mask,
        tail_truth_mask,
    )

    fact = task.fact_graphs[gid]
    und, rel_graph = task._prepare_graphs(fact, task.rel_graphs[gid])
    edges = task.graphs[gid].edge_list.to(task.device)
    b = torch.from_numpy(triples.astype(np.int64)).to(task.device)
    h, t, r = b[:, 0], b[:, 1], b[:, 2]
    with torch.inference_mode():
        t_scores, h_scores = task._eval_scores(model, fact, rel_graph, h, t,
                                               r, und)
    out = []
    for scores, target, truth in (
            (t_scores, t, tail_truth_mask(edges, h, r, fact.num_nodes)),
            (h_scores, h, head_truth_mask(edges, t, r, fact.num_nodes))):
        pos = scores.gather(1, target[:, None])
        out.append(((scores - pos).abs() <= band) & ~truth)
    return torch.stack([m.sum(-1) for m in out], 1).cpu().numpy()


def run_atomic(device) -> dict:
    """Phase 38: pretrain_3g.yaml's task (remat: auto), optimizer and engine
    sections through build_task and build_engine on one generated graph
    with ATOMIC's counts: the resolved policy, one warm-up and ATOMIC_TIMED
    timed steps (ms, device ms, peak, launches; the peak under the card's
    memory), one step's loss and gradients against the lowest tier pinned
    (full remat, micro_batch 8: 1e-5 relative, 1e-4 norm-wise), then
    ATOMIC_EVAL test triples at the auto eval batch, and the first 16
    queries ranked at it and at a pinned 16 (equal but within a score tie
    of 1e-5). Returns the launch counts by half."""
    from ultra_torchdrug_tpu_torch.data.datasets import (
        JointDataset,
        synthetic_transductive,
    )
    from ultra_torchdrug_tpu_torch.engine.build import (
        build_engine,
        build_task,
    )

    cuda = device.type == "cuda"
    counts = ATOMIC if cuda else ATOMIC_REHEARSAL
    t0 = time.perf_counter()
    total = counts["train"] + counts["valid"] + counts["test"]
    graph = synthetic_transductive(
        "ATOMIC-sized", counts["entities"], total, counts["relations"],
        seed=0, valid_frac=counts["valid"] / total,
        test_frac=counts["test"] / total)
    dataset = JointDataset("atomic-synthetic", [graph])
    cfg = pretrain_config(None if cuda else TRAIN_REHEARSAL)
    runs = {}
    with tempfile.TemporaryDirectory() as work_dir:
        engine = build_engine(cfg, build_task(cfg["task"], dataset,
                                              device=device),
                              work_dir=work_dir, seed=0)
        task, fact = engine.task, engine.task.fact_graphs[0]
        log(f"[atomic] {counts}: {fact.num_nodes} entities, "
            f"{fact.num_edges} train triples ({2 * fact.num_edges} "
            f"undirected edges), {len(graph.valid)} valid / "
            f"{len(graph.test)} test (this phase's own splits); batch "
            f"{engine.batch_size}, {task.cfg.num_negative} negatives, "
            f"{cfg['optimizer']}, remat {cfg['task']['remat']!r}; set-up "
            f"{time.perf_counter() - t0:.1f} s")
        log(f"[atomic] resolved: " + policy_line(task, fact, engine.batch_size,
                                                 engine.batch_size))
        edges = task.train_triples[0]

        def next_batch():
            return engine._full_batch(
                edges, engine.rng.permutation(len(edges))[:engine.batch_size])

        step_ms = []
        for i in range(1 + ATOMIC_TIMED):
            b = next_batch()
            if i == 1:
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
                reset_launch_counts()
            if cuda:
                torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = engine._run_step(0, b)
            if cuda:
                torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            if not all(math.isfinite(float(v)) for v in metrics.values()):
                raise AssertionError(f"atomic step {i}: {metrics}")
        runs["train"] = launch_counts()
        check_launches("atomic train", runs["train"], step_launches(
            task._train_model_cfg(fact, engine.batch_size),
            engine.batch_size), ATOMIC_TIMED, device)
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else math.nan
        used = {k: v for k, v in runs["train"].items() if v}
        if cuda:
            total_gib = torch.cuda.get_device_properties(
                device).total_memory / 2**30
            if peak >= total_gib:
                raise AssertionError(f"atomic: peak {peak:.2f} of "
                                     f"{total_gib:.2f} GiB")
        b = next_batch()
        device_ms = (profile_device_time("one atomic step",
                                         lambda: engine._run_step(0, b))
                     if cuda else None)
        log(f"[atomic] {ATOMIC_TIMED} timed steps: "
            f"{sum(step_ms[1:]) / ATOMIC_TIMED:.2f} ms a step ("
            + ", ".join(f"{ms:.1f}" for ms in step_ms[1:])
            + f"; warm-up {step_ms[0]:.1f}), device "
            f"{'not measured' if device_ms is None else f'{device_ms:.3f} ms'}"
            f" a step, peak device memory {peak:.3f} GiB ({device}); "
            f"launches {used} in {ATOMIC_TIMED} steps")

        # the resolved tier against the lowest (full remat, micro_batch 8)
        state = engine.generator.get_state()
        b = next_batch()
        auto_cfg = task.model_cfg
        resolved = grad_step(task, engine.model, engine.generator, state, b,
                             0)
        task.model_cfg = dataclasses.replace(
            auto_cfg, entity=dataclasses.replace(auto_cfg.entity, remat=True,
                                                 micro_batch=8))
        lowest = grad_step(task, engine.model, engine.generator, state, b, 0)
        task.model_cfg = auto_cfg
        compare_steps("atomic resolved vs full remat micro_batch 8", resolved,
                      lowest, 1e-5, 1e-4)
        del resolved, lowest

        # evaluation at the auto eval batch
        auto_batch = task._resolve_eval_batch(engine.batch_size,
                                              fact.num_nodes)
        task.evaluate(engine.model, "test", engine.batch_size,
                      fast_test=auto_batch)  # set-up
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t = time.perf_counter()
        metrics = task.evaluate(engine.model, "test", engine.batch_size,
                                fast_test=ATOMIC_EVAL)
        if cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        runs["eval"] = launch_counts()
        batches = math.ceil(ATOMIC_EVAL / auto_batch)
        check_launches("atomic eval", runs["eval"],
                       {"K1": K1_LAUNCHES_PER_BATCH}, batches, device)
        if not finite_metrics(metrics):
            raise AssertionError(f"atomic eval: {metrics}")
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else math.nan
        log(f"[atomic eval] {ATOMIC_EVAL} test triples at the auto eval "
            f"batch {auto_batch}: {batches} batches, "
            f"{seconds * 1e3 / batches:.2f} ms a batch, peak device memory "
            f"{peak:.3f} GiB; mrr {metrics['mrr']:.6f}")
        first = graph.test[:EVAL_BATCH]
        fn = task._eval_fns[0]
        got = task._run_eval(fn, engine.model, first, auto_batch)[0]
        want = task._run_eval(fn, engine.model, first, EVAL_BATCH)[0]
        diff = np.abs(got - want)
        if diff.any():
            ties = rank_ties(task, engine.model, 0, first, 1e-5)
            if (diff > ties).any():
                raise AssertionError(f"atomic ranks at batch {auto_batch} vs "
                                     f"{EVAL_BATCH}: {got} vs {want}")
        log(f"[atomic eval] the first {EVAL_BATCH} queries rank at batch "
            f"{auto_batch} as at {EVAL_BATCH}: {int((diff == 0).sum())} of "
            f"{diff.size} ranks equal, the rest within a score tie of 1e-5")
    return runs


def run_failsoft_fresh(dataset, device, none_step) -> dict:
    """Phase 39 on the card in a process of its own (``--failsoft``): its
    cap counts the bytes the caching allocator holds, and in this process
    those depend on the earlier phases' history (a few long-lived tensors
    placed in their cached segments pin GiBs that no empty_cache returns).
    The child rebuilds the same seeded KG and reports its launch counts;
    on the CPU the phase runs here."""
    if device.type != "cuda":
        return run_failsoft(dataset, device, none_step)
    release_device_memory()  # the child needs the card's memory
    log(f"[failsoft] this process keeps "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        out = Path(tmp) / "failsoft.json"
        loss, peak = none_step
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--failsoft", repr(float(loss)), repr(float(peak)),
                        str(out)], check=True, timeout=600)
        return json.loads(out.read_text())


def failsoft_child(none_loss: float, none_peak: float, out: Path) -> int:
    """``--failsoft``: phase 39 on the smoke KG in a fresh process; its
    launch counts by half are written to ``out``."""
    from ultra_torchdrug_tpu_torch.data.datasets import synthetic_transductive

    dataset = synthetic_transductive("SynthFB15k237", seed=0, **FULL)
    runs = run_failsoft(dataset, torch.device("cuda"), (none_loss, none_peak))
    out.write_text(json.dumps(runs))
    return 0


def run_failsoft(dataset, device, none_step) -> dict:
    """Phase 39: with the process capped below phase 37's keep-everything
    peak (torch.cuda.set_per_process_memory_fraction) while the budget still
    reads the whole card, a fresh task (remat: auto) and engine on the smoke
    KG: the first step must run out of memory, demote at least once and
    complete with phase 37's none-mode loss (1e-5 relative), the peak
    within the cap; then one evaluation under the cap at the auto eval
    batch, and the cap is lifted. On the CPU the same steps run uncapped.
    Returns the launch counts by half."""
    from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig
    from ultra_torchdrug_tpu_torch.tasks.task import (
        TaskConfig,
        TransductiveKGTask,
    )

    cuda = device.type == "cuda"
    size = TRAIN if cuda else TRAIN_REHEARSAL
    none_loss, none_peak = none_step
    base = UltraConfig.default(dataset.num_relations)
    model_cfg = dataclasses.replace(base, entity=dataclasses.replace(
        base.entity, remat="auto"))
    engine = make_engine(TransductiveKGTask(dataset, model_cfg, TaskConfig(
        num_negative=size["negatives"]), device=device), size, "failsoft",
        lr=5e-4)
    task = engine.task
    log(f"[failsoft] before: " + policy_line(task, task.fact_graph,
                                             size["batch"], size["batch"]))
    runs = {}
    cap = math.nan
    index = torch.cuda.current_device() if cuda else None
    if cuda:
        release_device_memory()
        total = torch.cuda.get_device_properties(index).total_memory
        resident = torch.cuda.memory_allocated()
        reserved = torch.cuda.memory_reserved()
        cap = resident + 0.6 * none_peak * 2**30
        log(f"[failsoft] resident {resident / 2**30:.3f} GiB allocated, "
            f"{reserved / 2**30:.3f} GiB reserved by the caching allocator")
        torch.cuda.set_per_process_memory_fraction(cap / total, index)
        torch.cuda.reset_peak_memory_stats()
    try:
        reset_launch_counts()
        engine.train(batch_per_epoch=1)
        if cuda:
            torch.cuda.synchronize()
        runs["train"] = launch_counts()
        peak = torch.cuda.max_memory_allocated() if cuda else math.nan
        loss = engine.meter.last_window[0]["loss"]
        level = task._policy_demotion
        log(f"[failsoft] cap {cap / 2**30:.3f} GiB (0.6 of phase 37's "
            f"keep-everything peak {none_peak:.3f} GiB above what was "
            f"resident); the first step completed at demotion level {level}: "
            + policy_line(task, task.fact_graph, size["batch"], size["batch"])
            + f"; peak {peak / 2**30:.3f} GiB; loss {loss:.8g} vs phase 37's "
            f"{none_loss:.8g}")
        if cuda and (level < 1 or peak > cap):
            raise AssertionError(f"failsoft: level {level}, peak {peak}, cap "
                                 f"{cap}")
        if abs(loss - none_loss) > 1e-5 * max(1.0, abs(none_loss)):
            raise AssertionError(f"failsoft: loss {loss} vs {none_loss}")
        reset_launch_counts()
        metrics = engine.evaluate("test", fast_test=128)
        runs["eval"] = launch_counts()
        if not finite_metrics(metrics):
            raise AssertionError(f"failsoft eval: {metrics}")
        log(f"[failsoft eval] 128 test triples under the cap at eval batch "
            f"{task._resolve_eval_batch(engine.batch_size, task.fact_graph.num_nodes)}"
            f", demotion level {task._policy_demotion}: mrr "
            f"{metrics['mrr']:.6f}; launches "
            f"{ {k: v for k, v in runs['eval'].items() if v} }")
    finally:
        if cuda:
            torch.cuda.set_per_process_memory_fraction(1.0, index)
    return runs


def run_classic_paths(dataset, device) -> dict:
    """Phase 40: classic NBFNet (6x32, distmult, pna, layer norm, seeded
    weights) on the smoke KG: edge_gradients for 2 test triples, then
    beam_search_paths (num_beam 10, path_topk 10) and visualize, against the
    port's CPU run (edge gradients 1e-4 norm-wise per layer, the top path
    equal, path weights 1e-4), with their ms; then one concat_hidden eval
    batch's scores against the CPU run (1e-5). Returns the launch counts by
    half."""
    from ultra_torchdrug_tpu_torch.models.classic_nbfnet import (
        beam_search_paths,
        classic_nbfnet_config,
        classic_nbfnet_init,
        edge_gradients,
        visualize,
    )
    from ultra_torchdrug_tpu_torch.tasks.task import (
        ClassicNBFNetTask,
        TaskConfig,
    )

    cuda = device.type == "cuda"
    cpu = torch.device("cpu")
    nbf_cfg = classic_nbfnet_config(num_relations=dataset.num_relations,
                                    layer_norm=True)
    model = classic_nbfnet_init(nbf_cfg, seed=0, device=device)
    cpu_model = copy.deepcopy(model).to(cpu)
    fact = dataset.fact_graph(None)[0]
    und = fact.undirected_with_inverse()
    graphs = {device: und.to(device), cpu: und}

    def timed(fn):
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    runs = {}
    reset_launch_counts()
    for h, t, r in dataset.test[:2]:
        h, t, r = int(h), int(t), int(r)
        (grads, ms) = timed(lambda: edge_gradients(model, graphs[device], h,
                                                   t, r))
        cpu_grads = edge_gradients(cpu_model, graphs[cpu], h, t, r)
        worst = max(((a.cpu() - b).norm() / b.norm().clamp(min=1e-12)).item()
                    for a, b in zip(grads, cpu_grads))
        if worst > 1e-4:
            raise AssertionError(f"classic paths ({h}, {r}, {t}): edge "
                                 f"gradients {worst:.3g} norm-wise")
        (paths, beam_ms) = timed(lambda: beam_search_paths(
            graphs[device], grads, h, t, num_beam=10, path_topk=10))
        (vis, vis_ms) = timed(lambda: visualize(model, fact.to(device), h, t,
                                                r, num_beam=10, path_topk=10))
        cpu_paths = beam_search_paths(graphs[cpu], cpu_grads, h, t,
                                      num_beam=10, path_topk=10)
        for label, (p, w) in (("beam", paths), ("visualize", vis)):
            if p[:1] != cpu_paths[0][:1] or not np.allclose(
                    w, cpu_paths[1][:len(w)], rtol=1e-4, atol=1e-6) \
                    or len(w) != len(cpu_paths[1]):
                raise AssertionError(f"classic paths {label} ({h}, {r}, {t}):"
                                     f" {p[:1]} {w} vs cpu {cpu_paths}")
        log(f"[classic paths] ({h}, {r}, {t}): edge_gradients {ms:.1f} ms "
            f"({len(grads)} layers x {und.num_edges} edges, worst norm-wise "
            f"error vs cpu {worst:.3g}), beam_search_paths {beam_ms:.1f} ms, "
            f"visualize {vis_ms:.1f} ms; {len(paths[0])} paths, the top "
            f"{paths[0][:1]} with mean gradient "
            f"{paths[1][0] if paths[1] else float('nan'):.6g} (cpu "
            f"{cpu_paths[1][0] if cpu_paths[1] else float('nan'):.6g})")
    runs["paths"] = launch_counts()
    if any(runs["paths"].values()):
        raise AssertionError(f"classic paths launched kernels: "
                             f"{runs['paths']}")

    concat_cfg = dataclasses.replace(nbf_cfg, concat_hidden=True)
    task = ClassicNBFNetTask(dataset, concat_cfg, TaskConfig(
        eval_batch_size=EVAL_BATCH), device=device)
    concat_model = task.init_params(seed=0)
    layers = len(concat_cfg.hidden_dims)
    reset_launch_counts()
    task.evaluate(concat_model, "test", EVAL_BATCH, fast_test=EVAL_BATCH)
    runs["eval concat"] = launch_counts()
    check_launches("classic concat eval", runs["eval concat"],
                   {"K6": 2 * layers, "K7": 2 * layers}, 1, device)
    phase_parity(task, concat_model, device, atol=CLASSIC_SCORE_ATOL,
                 label="classic concat_hidden parity", queries=EVAL_BATCH)
    return runs


# phases 41-45: ULTRA's remaining model options on the FB-size KG at 6x64:
# several relation towers (one per entity layer plus one), the shared
# relation model, the learned query and an activation; the xla route; the
# steps_per_call schedule; a multi-tower .pth
TOWERS = 7  # num_rel_models: 6 entity layers + 1
XLA_TRAIN_BATCH = 8  # the xla route's [E, B, D] messages: ~1 GB a tensor
STEPS_PER_CALL = 4
SPC_STEPS = 8


def option_config(num_relations: int, activation=None, **ultra):
    """UltraConfig.default with ``ultra``'s fields, ``learn_query`` on the
    relation tower when given, and ``activation`` on both towers."""
    from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig

    cfg = UltraConfig.default(num_relations)
    relation = dataclasses.replace(
        cfg.relation, learn_query=ultra.pop("learn_query", False))
    entity = cfg.entity
    if activation is not None:
        entity = dataclasses.replace(entity, activation=activation)
        relation = dataclasses.replace(relation, activation=activation)
    return dataclasses.replace(cfg, entity=entity, relation=relation, **ultra)


def run_ultra_option(dataset, device, label: str, model_cfg, cpu_task,
                     relation_share: bool = False) -> tuple:
    """One ULTRA option at full width: evaluation through the task (K1 12
    times per batch, the relation towers on cuBLAS), its device time (and
    with ``relation_share`` the relation towers' share of it) and its card
    scores against the CPU (1e-4); then Engine.train at batch 64, 128
    strict negatives (K1 and K2 6 times per step), its device time and one
    loss step's loss and gradients against ``cpu_task``, which carries the
    base config (the options live in the model) (1e-5, 1e-4). Returns
    (launch counts by half, task, model)."""
    from ultra_torchdrug_tpu_torch.models.ultra import _rel_queries
    from ultra_torchdrug_tpu_torch.tasks.task import (
        TaskConfig,
        TransductiveKGTask,
    )

    cuda = device.type == "cuda"
    train_size = dict(TRAIN if cuda else TRAIN_REHEARSAL, steps=1)
    t0 = time.perf_counter()
    task = TransductiveKGTask(dataset, model_cfg, TaskConfig(
        eval_batch_size=EVAL_BATCH, num_negative=train_size["negatives"]),
        device=device)
    model = task.init_params(seed=0)
    log(f"[{label}] towers {model_cfg.num_rel_models}, shared "
        f"{model_cfg.rel_shared}, learn_query "
        f"{model_cfg.relation.learn_query}, activation "
        f"{model_cfg.entity.activation!r}: task set-up "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    counts = {"eval": phase_slice(task, model, device,
                                  {"K1": K1_LAUNCHES_PER_BATCH}, label=label)}
    if cuda:
        eval_ms = profile_device_time(
            f"one {label} eval batch", lambda: task.evaluate(
                model, "test", batch_size=EVAL_BATCH, fast_test=EVAL_BATCH))
        if relation_share:
            _, rel_graph = task._prepare_graphs(task.fact_graph,
                                                task.rel_graph)
            r = torch.from_numpy(dataset.test[:EVAL_BATCH, 2].astype(
                np.int64)).to(device)

            def towers():
                with torch.inference_mode():
                    _rel_queries(model, rel_graph, r, model_cfg.relation)

            rel_ms = profile_device_time(f"{label} relation towers", towers)
            if eval_ms and rel_ms:
                log(f"[{label}] relation towers {rel_ms:.3f} ms of the eval "
                    f"batch's {eval_ms:.3f} ms device time "
                    f"({rel_ms / eval_ms:.1%})")
    phase_parity(task, model, device, label=f"{label} parity")
    engine = make_engine(task, train_size, f"{label} train", lr=5e-4)
    counts["train"] = phase_train(
        engine, train_size, device,
        {"K1": K_LAUNCHES_PER_STEP, "K2": K_LAUNCHES_PER_STEP},
        label=f"{label} train")
    if cuda:
        profile_device_time(f"one {label} train step",
                            lambda: engine.train(batch_per_epoch=1))
    phase_train_parity(engine, cpu_task, device,
                       label=f"{label} train parity")
    return counts, task, engine.model


def run_options(dataset, device) -> tuple:
    """Phases 41-42: several relation towers (num_rel_models 7 at 6x64),
    then the shared relation model, the learned query and activation gelu,
    each alone (run_ultra_option). Returns (launch counts by path, phase
    41's task and model)."""
    from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig
    from ultra_torchdrug_tpu_torch.tasks.task import (
        TaskConfig,
        TransductiveKGTask,
    )

    R = dataset.num_relations
    cpu_task = TransductiveKGTask(dataset, UltraConfig.default(R),
                                  TaskConfig(num_negative=8), device="cpu")
    runs = {}
    runs["towers"], task, model = run_ultra_option(
        dataset, device, "towers", option_config(R, num_rel_models=TOWERS),
        cpu_task, relation_share=True)
    for label, option in (("shared", dict(rel_shared=True)),
                          ("learn_query", dict(learn_query=True)),
                          ("gelu", dict(activation="gelu"))):
        runs[label], _, _ = run_ultra_option(
            dataset, device, label, option_config(R, **option), cpu_task)
    return runs, task, model


def loss_and_grads(task, model, batch, neg):
    """One loss step's loss and gradients with injected negatives."""
    loss, _ = task.loss_step(model, None, batch, neg=neg)
    params = [p for p in model.parameters() if p.requires_grad]
    return loss.detach(), torch.autograd.grad(loss, params)


def run_xla(dataset, device) -> dict:
    """Phase 43: rspmm_impl xla, the O(E) route, against the kernel route
    on the same card, weights and inputs: one ULTRA eval batch of 16
    (scores within 1e-4, no kernel launched), one train step at batch
    XLA_TRAIN_BATCH with 128 injected negatives (loss 1e-5, gradients 1e-4
    norm-wise, no kernel launched), each with its ms, device ms and peak
    memory beside the kernel route's; then a classic NBFNet distmult/max
    eval batch (6x32) both ways (1e-5, no K4 on xla). The xla models carry
    the kernel models' weights and run on the same prepared graphs (the
    route is the model's config; the task's CSR goes unread). Returns the
    launch counts by half."""
    from ultra_torchdrug_tpu_torch.models.classic_nbfnet import (
        ClassicNBFNet,
        classic_nbfnet_config,
    )
    from ultra_torchdrug_tpu_torch.models.ultra import Ultra, UltraConfig
    from ultra_torchdrug_tpu_torch.tasks.task import (
        ClassicNBFNetTask,
        TaskConfig,
        TransductiveKGTask,
    )

    cuda = device.type == "cuda"
    R = dataset.num_relations
    runs = {}
    task = TransductiveKGTask(dataset, UltraConfig.default(R), TaskConfig(
        eval_batch_size=EVAL_BATCH), device=device)
    model = task.init_params(seed=0)
    xla = Ultra(UltraConfig.default(R, rspmm_impl="xla")).to(device)
    xla.load_state_dict(model.state_dict())
    und, rel_graph = task._prepare_graphs(task.fact_graph, task.rel_graph,
                                          backward=True)
    q = torch.from_numpy(dataset.test[:EVAL_BATCH].astype(np.int64)).to(
        device)

    def eval_scores(m):
        with torch.inference_mode():
            return torch.cat(task._eval_scores(
                m, task.fact_graph, rel_graph, q[:, 0], q[:, 1], q[:, 2],
                und))

    readings = {}
    for name, m in (("kernels", model), ("xla", xla)):
        readings[name] = timed_grad_step(f"xla eval {name}",
                                         lambda: eval_scores(m), device)
        want = ({"K1": K1_LAUNCHES_PER_BATCH} if name == "kernels" else {})
        check_launches(f"xla eval {name}", readings[name]["counts"], want, 1,
                       device)
    runs["eval"] = readings["xla"]["counts"]
    got, want = readings["xla"]["out"], readings["kernels"]["out"]
    if not torch.isfinite(got).all():
        raise AssertionError("xla: non-finite scores")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    log(f"[xla] eval batch of {EVAL_BATCH}: scores {tuple(got.shape)} vs the "
        f"kernel route: max_abs_err {(got - want).abs().max().item():.3g} "
        f"(limit 1e-4)")

    rng = np.random.default_rng(6)
    B = XLA_TRAIN_BATCH if cuda else 2
    negatives = TRAIN["negatives"] if cuda else 8
    batch = task.train_triples[:B]
    neg = torch.from_numpy(rng.integers(0, dataset.num_entities,
                                        (B, negatives))).to(device)
    steps = {}
    for name, m in (("kernels", model), ("xla", xla)):
        steps[name] = timed_grad_step(
            f"xla step {name} batch {B}",
            lambda: loss_and_grads(task, m, batch, neg), device)
        want = ({"K1": K_LAUNCHES_PER_STEP, "K2": K_LAUNCHES_PER_STEP}
                if name == "kernels" else {})
        check_launches(f"xla step {name}", steps[name]["counts"], want, 1,
                       device)
    runs["train"] = steps["xla"]["counts"]
    compare_steps("xla step vs kernels", steps["xla"]["out"],
                  steps["kernels"]["out"], 1e-5, 1e-4)
    del task, model, xla, und, rel_graph, readings, steps
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    nbf_cfg = classic_nbfnet_config(num_relations=R, layer_norm=True,
                                    aggregate_func="max")
    ctask = ClassicNBFNetTask(dataset, nbf_cfg, TaskConfig(
        eval_batch_size=EVAL_BATCH), device=device)
    cmodel = ctask.init_params(seed=0)
    cxla = ClassicNBFNet(dataclasses.replace(nbf_cfg, rspmm_impl="xla")).to(
        device)
    cxla.load_state_dict(cmodel.state_dict())
    cund, _ = ctask._prepare_graphs(ctask.fact_graph, ctask.rel_graph)
    layers = len(nbf_cfg.hidden_dims)
    classic = {}
    for name, m in (("kernels", cmodel), ("xla", cxla)):
        classic[name] = timed_grad_step(
            f"xla classic max eval {name}", lambda: torch.cat(
                _classic_eval(ctask, m, cund, q)), device)
        want = {"K4": 2 * layers} if name == "kernels" else {}
        check_launches(f"xla classic max {name}", classic[name]["counts"],
                       want, 1, device)
    runs["classic max eval"] = classic["xla"]["counts"]
    got, want = classic["xla"]["out"], classic["kernels"]["out"]
    torch.testing.assert_close(got, want, rtol=0, atol=CLASSIC_SCORE_ATOL)
    log(f"[xla] classic distmult/max eval batch of {EVAL_BATCH}: "
        f"max_abs_err {(got - want).abs().max().item():.3g} vs the kernel "
        f"route (limit {CLASSIC_SCORE_ATOL:g})")
    return runs


def _classic_eval(task, model, und, q):
    with torch.inference_mode():
        return task._eval_scores(model, task.fact_graph, None, q[:, 0],
                                 q[:, 1], q[:, 2], und)


def run_steps_per_call(dataset, device) -> dict:
    """Phase 44: steps_per_call. SPC_STEPS steps of ULTRA (batch 64, 128
    strict negatives, AdamW) on the FB-size KG with K = STEPS_PER_CALL and
    with K = 1 from one seed: the parameters (equal expected; the largest
    difference is logged), ms per step both ways, K1 and K2 6 times a step.
    Then pre-training on three generated graphs (PRETRAIN_REHEARSAL's
    counts, pretrain_3g.yaml's sections, steps_per_call 3, 5 batches an
    epoch): 6 steps, each chunk on one graph. Returns the launch counts by
    half."""
    from ultra_torchdrug_tpu_torch.engine import build
    from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig
    from ultra_torchdrug_tpu_torch.tasks.task import (
        TaskConfig,
        TransductiveKGTask,
    )

    cuda = device.type == "cuda"
    size = dict(TRAIN if cuda else TRAIN_REHEARSAL, steps=SPC_STEPS)
    task = TransductiveKGTask(dataset, UltraConfig.default(
        dataset.num_relations), TaskConfig(num_negative=size["negatives"]),
        device=device)
    runs, params = {}, {}
    for K in (1, STEPS_PER_CALL):
        engine = make_engine(task, size, f"steps_per_call {K}", lr=5e-4,
                             steps_per_call=K)
        if cuda:
            torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        engine.train(batch_per_epoch=SPC_STEPS)
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / SPC_STEPS
        runs[f"train K={K}"] = launch_counts()
        check_launches(f"steps_per_call {K}", runs[f"train K={K}"],
                       {"K1": K_LAUNCHES_PER_STEP, "K2": K_LAUNCHES_PER_STEP},
                       SPC_STEPS, device)
        if engine.meter.global_step != SPC_STEPS:
            raise AssertionError(f"steps_per_call {K}: "
                                 f"{engine.meter.global_step} steps")
        params[K] = [p.detach() for p in engine.model.parameters()]
        log(f"[steps_per_call] K={K}: {SPC_STEPS} steps, {ms:.2f} ms per "
            f"step (the first step of the engine included), loss of the "
            f"last step {engine.meter.last_window[-1]['loss']:.6g}")
    worst = max((a - b).abs().max().item()
                for a, b in zip(params[1], params[STEPS_PER_CALL]))
    equal = all(torch.equal(a, b)
                for a, b in zip(params[1], params[STEPS_PER_CALL]))
    if worst > 1e-5:
        raise AssertionError(f"steps_per_call: parameters differ by {worst}")
    log(f"[steps_per_call] K={STEPS_PER_CALL} vs K=1 after {SPC_STEPS} "
        f"steps: parameters bitwise equal: {equal}, max_abs_err {worst:.3g}")
    del task, engine, params

    cfg = pretrain_config(None if cuda else TRAIN_REHEARSAL)
    cfg["engine"]["steps_per_call"] = 3
    ptask = build.build_task(cfg["task"], pretrain_dataset(PRETRAIN_REHEARSAL),
                             device=device)
    with tempfile.TemporaryDirectory() as tmp:
        engine = build.build_engine(cfg, ptask, work_dir=tmp)
    rng = copy.deepcopy(engine.rng)
    gids = [gid for gid, _ in engine._epoch_chunks(5)]
    engine.rng = rng
    batch = engine.batch_size
    want = {k: 0 for k in ("K1", "K2")}
    for gid in gids:
        per = step_launches(ptask._train_model_cfg(ptask.fact_graphs[gid],
                                                   batch), batch)
        for k in want:
            want[k] += 3 * per[k]
    reset_launch_counts()
    engine.train(batch_per_epoch=5)
    if cuda:
        torch.cuda.synchronize()
    runs["pretrain K=3"] = launch_counts()
    check_launches("steps_per_call pretrain", runs["pretrain K=3"], want, 1,
                   device)
    window = engine.meter.last_window
    if engine.meter.global_step != 6 or not all(
            math.isfinite(m["loss"]) for m in window):
        raise AssertionError(f"pretrain K=3: {engine.meter.global_step} "
                             f"steps, {window}")
    log(f"[steps_per_call] pre-training on 3 graphs, K=3, 5 batches an "
        f"epoch: {engine.meter.global_step} steps, chunks on graphs {gids}, "
        f"launches {runs['pretrain K=3']}")
    return runs


def run_towers_pth(task, model, device, pth_dir: Path) -> dict:
    """Phase 45: phase 41's 7-tower model exported to a .pth, loaded by
    Engine.load into a fresh engine (another seed): the eval batch's scores
    bitwise equal to phase 41's model's; then run_full.main on a copy of
    config/transductive/inference.yaml with num_rel_models 7 and the file
    as its checkpoint (every tensor loaded). Returns the launch counts by
    half."""
    from ultra_torchdrug_tpu_torch.engine.engine import Engine
    from ultra_torchdrug_tpu_torch.utils.checkpoint import (
        export_torch_checkpoint,
    )
    from ultra_torchdrug_tpu_torch.utils.logging import get_root_logger

    path = pth_dir / "ultra_7_towers.pth"
    export_torch_checkpoint(str(path), model)
    state = torch.load(path, weights_only=True)["model"]
    towers = {k.split(".")[1] for k in state if k.startswith("rel_models.")}
    engine = Engine(task, batch_size=EVAL_BATCH, seed=1, log_interval=10**9,
                    logger=get_root_logger(None))
    engine.load(str(path))
    und, rel_graph = task._prepare_graphs(task.fact_graph, task.rel_graph)
    q = torch.from_numpy(task.dataset.test[:EVAL_BATCH].astype(
        np.int64)).to(device)
    runs = {}
    scores = []
    for m in (model, engine.model):
        reset_launch_counts()
        with torch.inference_mode():
            scores.append(torch.cat(task._eval_scores(
                m, task.fact_graph, rel_graph, q[:, 0], q[:, 1], q[:, 2],
                und)))
        runs["eval .pth"] = launch_counts()
    check_launches("towers .pth", runs["eval .pth"],
                   {"K1": K1_LAUNCHES_PER_BATCH}, 1, device)
    if not torch.equal(*scores):
        raise AssertionError("towers .pth: scores differ from phase 41's")
    log(f"[towers .pth] {len(state)} tensors, {len(towers)} relation towers "
        f"({path.stat().st_size / 2**20:.2f} MiB): the loaded model's "
        f"{tuple(scores[0].shape)} scores are bitwise phase 41's")
    del engine, und, rel_graph
    text = (REPO / "config/transductive/inference.yaml").read_text()
    if text.count("num_rel_models: 1") != 1:
        raise AssertionError("inference.yaml: no num_rel_models: 1")
    with tempfile.TemporaryDirectory() as tmp, in_directory(tmp):
        cfg_path = Path(tmp) / "inference_7_towers.yaml"
        cfg_path.write_text(text.replace("num_rel_models: 1",
                                         f"num_rel_models: {TOWERS}"))
        runs["cli"], cli_engine = cli_run(
            "inference 7 towers .pth",
            ["-c", str(cfg_path), "--dataset", "SynthKG", "--epochs", "0",
             "--bpe", "0", "--gpus", "[0]", "--ckpt", str(path)], device, 0)
        if len(cli_engine.model.rel_models) != TOWERS:
            raise AssertionError("cli: not 7 relation towers")
        for k, v in cli_engine.model.state_dict().items():
            if not torch.equal(v.cpu(), state[k]):
                raise AssertionError(f"cli 7 towers .pth: {k} not loaded")
    return runs



# ---------------------------------------------------------------------------
# phases 46-48: the dataset catalog's parsers and data parallelism
# ---------------------------------------------------------------------------

# the public counts of the pre-training graphs, each at the catalog's
# canonical cache layout with its own token style:
# (name, file pattern, entity format, relation format, entities, relations,
# train, valid, test)
CATALOG_GRAPHS = (
    ("FB15k237", "fb15k237_{s}.txt", "/m/0{:05x}", "/film/rel_{}/type",
     14541, 237, 272115, 17535, 20466),
    ("WN18RR", "wn18rr_{s}.txt", "{:08d}", "_rel_{}", 40943, 11, 86835,
     3034, 3134),
    ("CoDExMedium", "codex-m/{s}.txt", "Q{}", "P{}", 17050, 51, 185584,
     10310, 10311),
)
CATALOG_REHEARSAL = (
    ("FB15k237", "fb15k237_{s}.txt", "/m/0{:05x}", "/film/rel_{}/type",
     600, 20, 4000, 200, 200),
    ("WN18RR", "wn18rr_{s}.txt", "{:08d}", "_rel_{}", 900, 11, 3000, 150,
     150),
    ("CoDExMedium", "codex-m/{s}.txt", "Q{}", "P{}", 500, 15, 3500, 150,
     150),
)
ILPC_DIR = "ilpc-large/pykeen-ilpc2022-c5ea003/data/large"
# the cuts of phase 46: the shipped configs evaluate every valid and test
# triple (the inference configs) or fast_test 500 a graph (pretrain_3g)
CATALOG_FAST_TEST = 64
CATALOG_FAST_TEST_REHEARSAL = 16
# phases 47-48: data parallelism over 2 ranks on one card (gloo), the
# FB-size KG, batch 64 x 128 negatives (32 rows a rank), eval batch 16
DP_RANKS = 2
DP_STEPS = 3
DP_EVAL_TRIPLES = 256
DP_LOSS_RTOL = 1e-5
DP_PARAM_RTOL = 1e-4
DP_TIE = 1e-5
DP_CHILD_TIMEOUT = 600


def catalog_rows(rng, V: int, R: int, n: int) -> np.ndarray:
    """n (h, r, t) id rows over V entities and R relations; the first rows'
    heads run through every entity and their relations through every
    relation, so that a file set of n >= V rows names each."""
    rows = np.stack([rng.integers(0, V, n), rng.integers(0, R, n),
                     rng.integers(0, V, n)], 1)
    k = min(V, n)
    rows[:k, 0] = rng.permutation(V)[:k]
    rows[:min(R, n), 1] = np.arange(min(R, n))
    return rows


def write_triples(path: Path, rows: np.ndarray, ent: list, rel: list,
                  offset: int = 0) -> None:
    """One triple file in the public downloads' format: h, r, t tokens
    separated by tabs, one row a line."""
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(
        f"{ent[h + offset]}\t{rel[r]}\t{ent[t + offset]}\n"
        for h, r, t in rows.tolist()))


def write_catalog(root: Path, graphs, ilpc: dict) -> dict:
    """Write the three pre-training graphs and ILPC 2022 large at their
    canonical cache layouts under ``root`` from seeded draws with
    ``graphs``' and ``ilpc``'s counts; returns the counts written by
    dataset name."""
    written = {}
    for seed, (name, pattern, ent_fmt, rel_fmt, V, R, *splits) in enumerate(
            graphs):
        rng = np.random.default_rng(100 + seed)
        ent = [ent_fmt.format(i) for i in range(V)]
        rel = [rel_fmt.format(i) for i in range(R)]
        rows = catalog_rows(rng, V, R, sum(splits))
        lo = 0
        for split, n in zip(("train", "valid", "test"), splits):
            write_triples(root / pattern.format(s=split), rows[lo:lo + n],
                          ent, rel)
            lo += n
        written[name] = dict(entities=V, relations=R,
                             **dict(zip(("train", "valid", "test"), splits)))
    rng = np.random.default_rng(200)
    R = ilpc["relations"]
    Vt, Vi = ilpc["train_entities"], ilpc["inference_entities"]
    ent = [f"Q{i}" for i in range(Vt + Vi)]  # inference entities after
    rel = [f"P{i}" for i in range(R)]
    base = root / ILPC_DIR
    write_triples(base / "train.txt",
                  catalog_rows(rng, Vt, R, ilpc["train_triples"]), ent, rel)
    inference = catalog_rows(
        rng, Vi, R, ilpc["inference_triples"] + ilpc["valid"] + ilpc["test"])
    n_inf = ilpc["inference_triples"]
    for f, part in (("inference", inference[:n_inf]),
                    ("inference_validation",
                     inference[n_inf:n_inf + ilpc["valid"]]),
                    ("inference_test", inference[n_inf + ilpc["valid"]:])):
        write_triples(base / f"{f}.txt", part, ent, rel, offset=Vt)
    written["ILPC2022LargeInductive"] = dict(ilpc)
    return written


def parse_catalog(root: Path, written: dict) -> dict:
    """Parse every written dataset with the port's catalog; the counts
    must be those written. Returns the host seconds of each parse."""
    from ultra_torchdrug_tpu_torch.utils.config import lookup

    seconds = {}
    for name, want in written.items():
        t0 = time.perf_counter()
        ds = lookup(name)(path=str(root))
        seconds[name] = time.perf_counter() - t0
        if name == "ILPC2022LargeInductive":
            got = dict(train_entities=ds.train_graph.num_nodes,
                       train_triples=ds.train_graph.num_edges,
                       inference_entities=ds.test_graph.num_nodes,
                       inference_triples=ds.test_graph.num_edges,
                       valid=len(ds.valid), test=len(ds.test),
                       relations=ds.num_relations)
        else:
            got = dict(entities=ds.num_entities, relations=ds.num_relations,
                       train=len(ds.train), valid=len(ds.valid),
                       test=len(ds.test))
        if got != want:
            raise AssertionError(f"catalog {name}: parsed {got}, wrote "
                                 f"{want}")
        log(f"[catalog] {name}: {got} parsed in {seconds[name]:.3f} s of "
            f"host time")
    return seconds


def catalog_config(src: str, root: Path, out: Path, edits: dict) -> Path:
    """A copy of a shipped config with ``path`` set to ``root`` and the
    text edits ``edits`` (old -> new) applied, each of which must match."""
    text = (REPO / src).read_text()
    edits = {"path: ~/kg-datasets/": f"path: {root}/", **edits}
    for old, new in edits.items():
        if text.count(old) != 1:
            raise AssertionError(f"{src}: {old!r} is not in it once")
        text = text.replace(old, new)
    out.write_text(text)
    return out


def run_catalog(device) -> dict:
    """Phase 46: the dataset catalog's parsers on files written in the
    public downloads' formats (module docstring). Returns the launch
    counts of each run."""
    from ultra_torchdrug_tpu_torch import run_many
    from ultra_torchdrug_tpu_torch.engine.build import (
        build_dataset,
        build_engine,
        build_task,
    )
    from ultra_torchdrug_tpu_torch.utils.config import load_config

    cuda = device.type == "cuda"
    graphs = CATALOG_GRAPHS if cuda else CATALOG_REHEARSAL
    ilpc = ILPC_LARGE if cuda else ILPC_REHEARSAL
    fast = CATALOG_FAST_TEST if cuda else CATALOG_FAST_TEST_REHEARSAL
    counts = {}
    # where wandb is installed its run stays offline: no network call
    os.environ["WANDB_MODE"] = "disabled"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kg_") as tmp, \
            in_directory(tmp):
        root = Path(tmp) / "kg-datasets"
        t0 = time.perf_counter()
        written = write_catalog(root, graphs, ilpc)
        log(f"[catalog] wrote {len(written)} datasets in the public "
            f"formats in {time.perf_counter() - t0:.1f} s")
        parse_catalog(root, written)
        cuts = [f"fast_test {fast} on the inference configs (shipped: every "
                "valid and test triple)"]
        inference = catalog_config(
            "config/transductive/inference.yaml", root,
            Path(tmp) / "inference.yaml",
            {"metric: mrr": f"metric: mrr\nfast_test: {fast}"})
        counts["inference FB15k237"], engine = cli_run(
            "inference.yaml on FB15k237 files", [
                "-c", str(inference), "--dataset", "FB15k237", "--epochs",
                "0", "--bpe", "0", "--gpus", "[0]", "--ckpt", "null"],
            device, 0)
        check_launches("catalog inference", counts["inference FB15k237"],
                       {"K1": K1_LAUNCHES_PER_BATCH},
                       counts["inference FB15k237"]["K1"]
                       // K1_LAUNCHES_PER_BATCH, device)
        del engine
        pretrain_edits = {"num_epoch: 10": "num_epoch: 1",
                          "batch_per_epoch: 20000": "batch_per_epoch: 3"}
        cuts.append("pretrain_3g.yaml: train.num_epoch 10 -> 1, "
                    "batch_per_epoch 20000 -> 3")
        if not cuda:
            pretrain_edits["fast_test: 500"] = f"fast_test: {fast}"
            cuts.append(f"pretrain_3g.yaml: fast_test 500 -> {fast} (CPU)")
            pretrain_edits["batch_size: 64"] = "batch_size: 8"
            pretrain_edits["num_negative: 128"] = "num_negative: 16"
        pretrain = catalog_config(
            "config/transductive/pretrain_3g.yaml", root,
            Path(tmp) / "pretrain_3g.yaml", pretrain_edits)
        counts["pretrain_3g"], engine = cli_run(
            "pretrain_3g.yaml on FB15k237, WN18RR, CoDExMedium files",
            ["-c", str(pretrain), "--gpus", "[0]"], device, 1)
        names = [d.name for d in engine.task.dataset.datasets]
        if (engine.meter.global_step != 3
                or len(engine.metrics["test"]["per_graph"]) != 3
                or names != ["FB15k237", "WN18RR", "CoDExM"]):
            raise AssertionError(f"catalog pretrain: {names}, "
                                 f"{engine.meter.global_step} steps, "
                                 f"{engine.metrics['test']}")
        del engine
        inductive = catalog_config(
            "config/inductive/inference.yaml", root,
            Path(tmp) / "inductive.yaml",
            {"metric: mrr": f"metric: mrr\nfast_test: {fast}"})
        counts["inductive ILPC large"], engine = cli_run(
            "inductive inference.yaml on ILPC2022LargeInductive files", [
                "-c", str(inductive), "--dataset", "ILPC2022LargeInductive",
                "--version", "v1", "--epochs", "0", "--bpe", "0", "--gpus",
                "[0]", "--ckpt", "null"], device, 0)
        if engine.task.dataset.test_graph.num_nodes != \
                ilpc["inference_entities"]:
            raise AssertionError("catalog inductive: not the inference graph")
        del engine
        reset_launch_counts()
        t0 = time.perf_counter()
        csv_path = run_many.main([
            "-c", str(inference), "-d", "FB15k237,WN18RR", "-reps", "1",
            "--epochs", "0", "--bpe", "0", "--gpus", "[0]", "--device",
            device.type])
        counts["run_many"] = launch_counts()
        with open(csv_path, newline="") as f:
            rows = list(csv.DictReader(f))
        if ([(r["dataset"], r["seed"]) for r in rows]
                != [("FB15k237", "1024"), ("WN18RR", "1024")]
                or not all(math.isfinite(float(r["mrr"])) for r in rows)):
            raise AssertionError(f"run_many csv: {rows}")
        log(f"[catalog] run_many over FB15k237, WN18RR (-reps 1, epochs 0): "
            f"{time.perf_counter() - t0:.1f} s, {Path(csv_path).name} with "
            f"{len(rows)} rows, columns {sorted(rows[0])}, mrr "
            f"{[round(float(r['mrr']), 6) for r in rows]}; launches "
            f"{ {k: v for k, v in counts['run_many'].items() if v} }")
        cfg = load_config(str(inference), context=dict(
            dataset="WN18RR", gpus=[0], epochs=0, bpe=0, ckpt=None))[0]
        cfg["engine"].update(logger="wandb", log_interval=1)
        task = build_task(cfg["task"], build_dataset(cfg["dataset"]),
                          device=device)
        # the logger runs as it does without wandb: its import is blocked
        # for the scope, so no run starts where wandb is installed
        installed = importlib.util.find_spec("wandb") is not None
        saved = sys.modules.get("wandb")
        sys.modules["wandb"] = None
        try:
            engine = build_engine(cfg, task, work_dir=tmp)
        finally:
            if saved is None:
                del sys.modules["wandb"]
            else:
                sys.modules["wandb"] = saved
        reset_launch_counts()
        engine.train(batch_per_epoch=1)
        counts["wandb"] = launch_counts()
        sink = engine.meter.sink
        if type(sink).__name__ != "WandbLogger" or sink._run is not None:
            raise AssertionError(f"engine.logger: wandb built {sink!r}")
        check_launches("catalog wandb", counts["wandb"],
                       {"K1": K_LAUNCHES_PER_STEP, "K2": K_LAUNCHES_PER_STEP},
                       1, device)
        how = "installed, its import blocked" if installed else "absent"
        log(f"[catalog] engine.logger: wandb on WN18RR: an inert WandbLogger "
            f"(wandb {how}); one step, loss "
            f"{engine.meter.last_window[0]['loss']:.6g}")
        del engine, task
        for cut in cuts:
            log(f"[catalog] cut: {cut}")
    return counts


def run_new_phases(device) -> dict:
    """Phases 46-48, each timed; returns their launch counts by path."""
    runs = {}
    t0 = time.perf_counter()
    runs["catalog"] = run_catalog(device)
    t1 = time.perf_counter()
    runs["data parallel"], runs["composed"] = run_data_parallel(device)
    log(f"[timing] phase 46 {t1 - t0:.1f} s, phases 47-48 "
        f"{time.perf_counter() - t1:.1f} s")
    return runs


def dp_config(data: int, edge: int, size: dict, impl: str = "ring") -> dict:
    """inference.yaml's model and task sections (ULTRA 6x64) at ``size``'s
    batch and negatives, eval batch EVAL_BATCH, on a mesh of ``data`` rows
    x ``edge`` shards (``impl`` when edge > 1: the ring with rdma, or the
    partitioned kernels with "auto")."""
    cfg = inference_config({"class": "SynthKG"}, "float32")
    cfg["task"]["num_negative"] = size["negatives"]
    cfg["engine"].update(batch_size=size["batch"], log_interval=10**9)
    if data > 1 or edge > 1:
        cfg["parallel"] = {"data": data, "edge": edge}
    if edge > 1:
        cfg["rspmm_impl"] = impl
        cfg["task"]["model"]["ring_exchange"] = "rdma"
    return cfg


def dp_run(dataset, device, data: int, edge: int, steps: int,
           eval_triples: int, impl: str = "ring") -> dict:
    """One process's part of phases 47-48 (every rank's, or the single
    process's reference): the test rankings of ``eval_triples`` triples at
    the initial weights (round-robin shards under a data axis, gathered),
    then ``steps`` AdamW steps through Engine.train; returns the rankings,
    the reference's near-tie counts, the logged losses, the first step's
    gradients as the optimizer applies them, the parameters, the ms of
    each step, the peak memory and the launch counts (of the steps also
    by card, where card_launch_spy records them, and K9's stores to
    another card)."""
    from ultra_torchdrug_tpu_torch.engine.build import (
        build_engine,
        build_task,
        mesh_scope,
    )
    from ultra_torchdrug_tpu_torch.ops.match import (
        head_truth_mask,
        tail_truth_mask,
    )
    from ultra_torchdrug_tpu_torch.parallel import distributed

    cuda = device.type == "cuda"
    size = TRAIN if cuda else TRAIN_REHEARSAL
    cfg = dp_config(data, edge, size, impl)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as work_dir, \
            mesh_scope(cfg, device) as (mesh, edge_axis, rel_edge_axis):
        task = build_task(cfg["task"], dataset,
                          rspmm_impl=cfg.get("rspmm_impl", "auto"), seed=0,
                          device=device, edge_axis=edge_axis,
                          rel_edge_axis=rel_edge_axis)
        engine = build_engine(cfg, task, work_dir=work_dir, seed=0,
                              mesh=mesh)
        if eval_triples:
            triples = dataset.test[:eval_triples]
            reset_launch_counts()
            ranking, _ = task._run_eval(task._eval_fn, engine.model, triples,
                                        EVAL_BATCH)
            out.update(ranking=ranking, eval_counts=launch_counts())
            if data == 1 and edge == 1:
                # per query and direction: the allowed candidates whose
                # score lies within DP_TIE of the target's
                b = torch.from_numpy(triples.astype(np.int64)).to(device)
                fact_und, rel_graph = task._prepare_graphs(task.fact_graph,
                                                           task.rel_graph)
                filter_edges = task.graph.edge_list.to(device)
                V = task.fact_graph.num_nodes
                ties = []
                with torch.inference_mode():
                    for lo in range(0, len(b), EVAL_BATCH):
                        c = b[lo:lo + EVAL_BATCH]
                        ts, hs = task._eval_scores(
                            engine.model, task.fact_graph, rel_graph, c[:, 0],
                            c[:, 1], c[:, 2], fact_und)
                        cols = []
                        for s, target, truth in (
                                (ts, c[:, 1], tail_truth_mask(
                                    filter_edges, c[:, 0], c[:, 2], V)),
                                (hs, c[:, 0], head_truth_mask(
                                    filter_edges, c[:, 1], c[:, 2], V))):
                            gap = (s - s.gather(1, target[:, None])).abs()
                            cols.append(((gap <= DP_TIE) & ~truth).sum(1))
                        ties.append(torch.stack(cols, 1).cpu())
                out["ties"] = torch.cat(ties).numpy()
                del fact_und, rel_graph
        applied, reduce = [], distributed.all_reduce_mean

        def recording(flat):
            flat = reduce(flat)
            if not applied:
                applied.append([flat.detach().cpu()])
            return flat

        distributed.all_reduce_mean = recording
        step_ms, run_step = [], engine._run_step

        def timed_step(gid, batch):
            if cuda:
                torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = run_step(gid, batch)
            if cuda:
                torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            return metrics

        engine._run_step = timed_step
        cards = list(dict.fromkeys(mesh.devices if mesh is not None
                                   else [device]))
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            reset_peaks(cards)
        reset_launch_counts()
        try:
            engine.train(batch_per_epoch=steps)
        finally:
            distributed.all_reduce_mean = reduce
        from ultra_torchdrug_tpu_torch.parallel import rdma

        out.update(
            train_counts=launch_counts(), step_ms=step_ms,
            card_counts=dict(CARD_LAUNCHES), peer_k9=rdma.peer_launches,
            home=str(mesh.device if mesh is not None else device),
            shards=[str(d) for d in mesh.devices] if mesh is not None
            else [str(device)],
            losses=[m["loss"] for m in engine.meter.last_window],
            grads=applied[0],
            params={k: v.detach().cpu()
                    for k, v in engine.model.state_dict().items()},
            peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                      if cuda else float("nan")),
            card_peaks_gib={str(c): (torch.cuda.max_memory_allocated(c)
                                     / 2**30 if cuda else float("nan"))
                            for c in cards})
    del engine, task
    if cuda:
        release_device_memory()
    return out


def dp_child(out_dir: Path, cases: list, device_type: str) -> int:
    """``--dp-child``: one rank of phases 47-48, launched by
    ``spawn_ranks`` with torchrun's environment variables; writes its
    results to out_dir/rank{RANK}.pt."""
    from ultra_torchdrug_tpu_torch import run_full
    from ultra_torchdrug_tpu_torch.data.datasets import synthetic_transductive
    from ultra_torchdrug_tpu_torch.parallel import distributed

    cards = [c for c in cases if c.startswith("cards")]
    device = run_full.setup_process(device_type, edge=2 if cards else 1)
    world, rank = distributed.process_count(), distributed.process_index()
    cuda = device.type == "cuda"
    dataset = synthetic_transductive("SynthFB15k237", seed=0,
                                     **(FULL if cuda else REHEARSAL))
    result = {"backend": torch.distributed.get_backend(),
              "device": str(device)}
    if "dp" in cases:
        result["dp"] = dp_run(dataset, device, world, 1, DP_STEPS,
                              DP_EVAL_TRIPLES)
    if "composed" in cases:
        result["composed"] = dp_run(dataset, device, world, 2, 1, 0)
    for case in cards:  # "cards ring", "cards partitioned"
        impl = "ring" if case.endswith("ring") else "auto"
        with card_launch_spy():
            result[case] = dp_run(dataset, device, world, 2, 1, 0, impl=impl)
    torch.save(result, out_dir / f"rank{rank}.pt")
    distributed.shutdown()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(cases: list, device, share_card: bool, world: int) -> list:
    """Run ``cases`` on ``world`` child processes of this script (torchrun's
    environment variables, a localhost rendezvous): on card 0 alone, over
    gloo, with ``share_card``, else one rank a card. Returns each rank's
    results; a rank that fails or outlasts DP_CHILD_TIMEOUT fails the
    phase, and every child is stopped."""
    port = free_port()
    procs = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        for r in range(world):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(world),
                       LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       OMP_NUM_THREADS="2")
            if share_card and device.type == "cuda":
                env["CUDA_VISIBLE_DEVICES"] = "0"
            logfile = open(Path(tmp) / f"rank{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--dp-child",
                 tmp, ",".join(cases), "--device", device.type],
                env=env, stdout=logfile, stderr=subprocess.STDOUT),
                logfile))
        try:
            deadline = time.monotonic() + DP_CHILD_TIMEOUT
            for p, _ in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p, logfile in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                logfile.close()
        failed = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
        if failed:
            tails = "\n".join(
                f"--- rank {r} ---\n" + "\n".join(
                    (Path(tmp) / f"rank{r}.log").read_text()
                    .splitlines()[-40:]) for r in failed)
            raise AssertionError(f"ranks {failed} failed:\n{tails}")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]


def compare_to_single(label: str, got: dict, single: dict,
                      first_step_only: bool = False) -> str:
    """A rank's losses within DP_LOSS_RTOL and its gradients (the first
    step's) or parameters within DP_PARAM_RTOL norm-wise of the single
    process's; returns a summary."""
    losses = got["losses"]
    want = single["losses"][:len(losses)]
    loss_err = max(abs(a - b) / max(abs(b), 1e-12)
                   for a, b in zip(losses, want))
    if not losses or loss_err > DP_LOSS_RTOL:
        raise AssertionError(f"{label}: losses {losses} vs one process "
                             f"{want}")
    pairs = (zip(got["grads"], single["grads"]) if first_step_only
             else ((got["params"][k], v) for k, v in single["params"].items()))
    worst = 0.0
    for a, b in pairs:
        if not torch.isfinite(a).all():
            raise AssertionError(f"{label}: non-finite values")
        worst = max(worst, ((a - b).norm() / b.norm().clamp(min=1e-12))
                    .item())
    what = "first step's gradients" if first_step_only else "parameters"
    if worst > DP_PARAM_RTOL:
        raise AssertionError(f"{label}: {what} differ by {worst:.3g} "
                             "norm-wise")
    return (f"losses within {loss_err:.3g} relative (limit "
            f"{DP_LOSS_RTOL:g}), {what} within {worst:.3g} norm-wise "
            f"(limit {DP_PARAM_RTOL:g})")


def check_dp_rankings(label: str, got: np.ndarray, single: dict) -> int:
    """Rankings equal to the single process's but where candidates tie the
    target within DP_TIE; returns how many entries differ."""
    want, ties = single["ranking"], single["ties"]
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    bad = diff > ties
    if got.shape != want.shape or bad.any():
        raise AssertionError(f"{label}: rankings differ beyond ties at "
                             f"{np.argwhere(bad)[:5].tolist()}")
    return int((diff > 0).sum())


def run_data_parallel(device) -> tuple:
    """Phases 47-48: data parallelism (module docstring). Returns the
    launch counts by half, of phase 47 and of phase 48."""
    from ultra_torchdrug_tpu_torch.data.datasets import synthetic_transductive

    cuda = device.type == "cuda"
    size = TRAIN if cuda else TRAIN_REHEARSAL
    dataset = synthetic_transductive("SynthFB15k237", seed=0,
                                     **(FULL if cuda else REHEARSAL))
    batches = DP_EVAL_TRIPLES // EVAL_BATCH
    single = dp_run(dataset, device, 1, 1, DP_STEPS, DP_EVAL_TRIPLES)
    check_launches("dp single eval", single["eval_counts"],
                   {"K1": K1_LAUNCHES_PER_BATCH}, batches, device)
    check_launches("dp single train", single["train_counts"],
                   {"K1": K_LAUNCHES_PER_STEP, "K2": K_LAUNCHES_PER_STEP},
                   DP_STEPS, device)
    log(f"[dp] one process: {DP_EVAL_TRIPLES} test triples ranked, "
        f"{DP_STEPS} steps at batch {size['batch']} x {size['negatives']}: "
        f"{[round(t, 2) for t in single['step_ms']]} ms, losses "
        f"{[round(x, 8) for x in single['losses']]}, peak "
        f"{single['peak_gib']:.3f} GiB")
    dp_runs = {"single eval": single["eval_counts"],
               "single train": single["train_counts"]}
    composed_runs = {}
    # with several cards, the NCCL variant takes one rank a card
    variants = [("gloo, one card", True, DP_RANKS)]
    if cuda and torch.cuda.device_count() >= 2:
        variants.append(("nccl, a card a rank", False,
                         torch.cuda.device_count()))
    for name, share, world in variants:
        cases = ["dp", "composed"] if share else ["dp"]
        t0 = time.perf_counter()
        ranks = spawn_ranks(cases, device, share, world)
        log(f"[dp {name}] {world} ranks ({[r['backend'] for r in ranks]}"
            f" on {[r['device'] for r in ranks]}) in "
            f"{time.perf_counter() - t0:.1f} s with their start-up")
        for r, res in enumerate(ranks):
            got = res["dp"]
            check_launches(f"dp {name} rank {r} eval", got["eval_counts"],
                           {"K1": K1_LAUNCHES_PER_BATCH},
                           batches // world, device)
            check_launches(f"dp {name} rank {r} train", got["train_counts"],
                           {"K1": K_LAUNCHES_PER_STEP,
                            "K2": K_LAUNCHES_PER_STEP}, DP_STEPS, device)
            differ = check_dp_rankings(f"dp {name} rank {r}",
                                       got["ranking"], single)
            summary = compare_to_single(f"dp {name} rank {r}", got, single)
            timed = got["step_ms"][1:]
            log(f"[dp {name}] rank {r}: {summary}; gathered rankings of "
                f"{DP_EVAL_TRIPLES} triples equal one process's but "
                f"{differ} entries within ties of {DP_TIE:g}; "
                f"{size['batch'] // world} rows a rank, "
                f"{sum(timed) / len(timed):.2f} ms per step after a "
                f"{got['step_ms'][0]:.1f} ms first step ("
                + ("two ranks share one card: no scaling figure"
                   if share else "one rank a card")
                + f"), peak {got['peak_gib']:.3f} GiB; launches eval "
                f"{ {k: v for k, v in got['eval_counts'].items() if v} }, "
                f"train "
                f"{ {k: v for k, v in got['train_counts'].items() if v} }")
            dp_runs[f"{name} rank{r} eval"] = got["eval_counts"]
            dp_runs[f"{name} rank{r} train"] = got["train_counts"]
            if "composed" not in res:
                continue
            got = res["composed"]
            counts = got["train_counts"]
            # a step: K1 and K2 once a non-empty bucket (4 on 2 shards) a
            # layer, K9 once a layer each way
            check_launches(f"composed rank {r}", counts,
                           {"K1": 4 * K_LAUNCHES_PER_STEP,
                            "K2": 4 * K_LAUNCHES_PER_STEP,
                            "K9": 2 * K_LAUNCHES_PER_STEP}, 1, device)
            summary = compare_to_single(f"composed rank {r}", got, single,
                                        first_step_only=True)
            log(f"[composed] rank {r}: data {world} x edge 2 (ring, "
                f"rdma) one step vs one process on one device: {summary}; "
                f"{got['step_ms'][0]:.1f} ms; launches "
                f"{ {k: v for k, v in counts.items() if v} }")
            composed_runs[f"rank{r} train"] = counts
    return dp_runs, composed_runs


def run_data_edge_cards(device) -> dict:
    """Phase 53: data 2 x edge 2 on four cards, two NCCL ranks of two
    cards each (rank r at home on card 2r), the ring with rdma and then
    the partitioned kernels: one step each against the single-device step
    on card 0 (loss DP_LOSS_RTOL relative, the first step's gradients
    DP_PARAM_RTOL norm-wise), with the launches by rank and by card. On
    fewer cards it logs that it is not run."""
    from ultra_torchdrug_tpu_torch.data.datasets import synthetic_transductive

    count = torch.cuda.device_count() if device.type == "cuda" else 1
    if count < 4:
        log(f"[phase 53] not run: {count} card(s) ({device}); data 2 x edge "
            "2 needs four")
        return {}
    t0 = time.perf_counter()
    dataset = synthetic_transductive("SynthFB15k237", seed=0, **FULL)
    single = dp_run(dataset, one_card(device), 1, 1, 1, 0)
    cases = ["cards ring", "cards partitioned"]
    ranks = spawn_ranks(cases, device, False, 2)
    runs = {}
    # a step: the ring's K1 and K2 once a non-empty bucket (4 on 2 shards)
    # a layer, 2 a card, K9 once a source card a shift (one shift a layer
    # each way), every launch storing to the other card; the partitioned
    # K1 and K2 once a shard a layer
    L = K_LAUNCHES_PER_STEP
    want = {"cards ring": ({"K1": 4 * L, "K2": 4 * L, "K9": 4 * L},
                           {"K1": 2 * L, "K2": 2 * L, "K9": 2 * L}),
            "cards partitioned": ({"K1": 2 * L, "K2": 2 * L},
                                  {"K1": L, "K2": L})}
    for r, res in enumerate(ranks):
        if (res["backend"], res["device"]) != ("nccl", f"cuda:{2 * r}"):
            raise AssertionError(f"phase 53 rank {r}: {res['backend']} on "
                                 f"{res['device']}, expected nccl on "
                                 f"cuda:{2 * r}")
        for case in cases:
            got = res[case]
            total, per_card = want[case]
            check_launches(f"{case} rank {r}", got["train_counts"], total, 1,
                           device)
            cards = [2 * r, 2 * r + 1]
            expect = {(k, c): v for k, v in per_card.items() for c in cards}
            k9x = total.get("K9", 0)
            if got["card_counts"] != expect or got["peer_k9"] != k9x:
                raise AssertionError(
                    f"{case} rank {r}: launches by card {got['card_counts']}"
                    f", K9 to another card {got['peer_k9']}; expected "
                    f"{expect}, {k9x}")
            summary = compare_to_single(f"{case} rank {r}", got, single,
                                        first_step_only=True)
            log(f"[phase 53] {case} rank {r} (home {got['home']}, shards "
                f"{got['shards']}): data 2 x edge 2 one step vs one card: "
                f"{summary}; {got['step_ms'][0]:.1f} ms (the first step), "
                f"peak {got['peak_gib']:.3f} GiB on its home, by card "
                + ", ".join(f"{c} {v:.3f}" for c, v in
                            got["card_peaks_gib"].items())
                + " GiB; launches by "
                f"card {dict(sorted(got['card_counts'].items()))}, K9 to "
                f"another card {got['peer_k9']}")
            runs[f"{case} rank{r} train"] = dict(got["train_counts"],
                                                 K9x=got["peer_k9"])
    log(f"[timing] phase 53 {time.perf_counter() - t0:.1f} s "
        f"({nvidia_smi_line()})")
    return {"data 2 x edge 2": runs}


def run_card_phases(device) -> tuple:
    """Phases 52-53 (several cards); each logs that it is not run where
    the host has too few. Returns (launch counts by path, the "K9 cards"
    kernels-line entry or None)."""
    runs, entry = run_cards(device)
    if device.type == "cuda":
        release_device_memory()
    runs.update(run_data_edge_cards(device))
    return runs, entry


# phases 49-51: ULTRA 6x64 on the FB-size KG under an edge mesh of
# EDGE_SHARDS shards, every shard on the card, each path held against the
# single-device run on the same card and weights; the 2-layer variants and
# xla's train batch are cut as the module docstring says
EDGE_SHARDS = 4
EDGE_STEP = dict(batch=64, negatives=128, steps=1)
EDGE_STEP_REHEARSAL = dict(batch=8, negatives=16, steps=1)
EDGE_SCORE_ATOL = 1e-5  # the partitioned sums: each row's edges in order
EDGE_GRAD_RTOL = 1e-4
# pna on the ring against the single device: the moments are summed in
# another order (ring steps with atomic index_add_, then the fused K7), and
# std = sqrt(clip(sq_mean - mean², 1e-6)) amplifies that rounding where the
# variance nears the clip (the constant states of unreached nodes send
# equal messages). pna_rounding holds it to be rounding alone: in fp64 the
# ring on the card and the single-device model on the CPU agree within
# PNA_FP64_GRAD_RTOL, and it reads each fp32 route against that result. On an H100 the
# fp32 ring read 1.93e-4 to 8.05e-4 from the single device in six runs on
# the same weights and inputs (its atomic sums differ run to run);
# PNA_RING_GRAD_RTOL is 2.5 times the worst
PNA_RING_GRAD_RTOL = 2e-3
PNA_FP64_GRAD_RTOL = 1e-9


def edge_config(spec: dict, impl: str, layers: int = 6,
                relation_edge: bool = False, compute_dtype="float32",
                shards: int = EDGE_SHARDS, **model) -> dict:
    """inference.yaml's model and task with ``parallel: {edge: shards}``
    (and ``relation_edge``), ``rspmm_impl``, rdma for the ring (unless
    ``model`` names the exchange), the entity tower cut to ``layers``
    layers and ``model``'s keys set."""
    cfg = inference_config(spec, compute_dtype)
    cfg["parallel"] = {"edge": shards, "relation_edge": relation_edge}
    cfg["rspmm_impl"] = impl
    m = cfg["task"]["model"]
    m.update({"ring_exchange": "rdma", **model})
    m["hidden_dims"] = m["hidden_dims"][:layers]
    return cfg


@contextlib.contextmanager
def forced_balance():
    """The ring's degree-balanced relabelling forced on: the uniform KG
    does not need it, and phase 50 holds the relabelled block domain."""
    from ultra_torchdrug_tpu_torch.parallel import ring_rspmm

    real = ring_rspmm.resolve_balance
    ring_rspmm.resolve_balance = lambda *args: True
    try:
        yield
    finally:
        ring_rspmm.resolve_balance = real


def k9_shift_launches(devices) -> dict:
    """K9's launches a shift of a ring whose shard s lies on
    ``devices[s]``: {card index: (launches, of them storing to another
    card)}, one launch a source card (parallel/rdma.py::shift_blocks)."""
    n = len(devices)
    return {a.index: (1, int(any(devices[(s + 1) % n] != a for s in range(n)
                                 if devices[s] == a)))
            for a in dict.fromkeys(devices)}


def edge_launches(und, rel_graph, entity, relation, kernels: dict,
                  by_card: bool = False) -> tuple:
    """(per eval batch, per train step) launches of an edge-mesh run, by
    kernel id (``kernels`` names the sums' forward and backward kernels on
    the partitioned path): the partitioned sums once a shard with edges a
    layer, its max K4 (K5 backward) once a layer; the ring's sums K1 (K2)
    once a bucket with edges a layer; K9 once a source card a shift, n - 1
    shifts a rotation with the rdma exchange (one rotation a layer each
    way, two for pna's pair and moments); "K9x" the K9 launches that store
    to another card; the entity tower runs twice an eval batch (tail and
    head), the relation tower once. With ``by_card`` the keys are (kernel
    id, card index) of the shards' kernels and K9, as card_launch_spy
    records them (K4, K5 and K9x left out)."""
    def tower(g, cfg):  # a layer's (forward, backward) launches, K9 each way
        base = cfg.aggregate_func.replace("_nobound", "")
        fwd, bwd, k9 = {}, {}, {}

        def add_to(counts, kid, card, times):
            key = (kid, card) if by_card else kid
            if times:
                counts[key] = counts.get(key, 0) + times

        if g.part_layouts is not None:
            if base == "max":
                return ({}, {}, {}) if by_card else ({"K4": 1}, {"K5": 1}, {})
            lay = g.part_layouts
            for s, d in enumerate(lay.devices):
                add_to(fwd, kernels["fwd"], d.index, int(lay.fwd_counts[s] > 0))
                add_to(bwd, kernels["bwd"], d.index, int(lay.rev_counts[s] > 0))
            return fwd, bwd, k9
        ri = g.ring_inputs
        if ri is None:
            return fwd, bwd, k9
        sums = base in ("sum", "mean") and ri.csr is not None
        if sums:
            for s, d in enumerate(ri.devices):
                add_to(fwd, "K1", d.index,
                       int(np.count_nonzero(ri.edge_counts[s])))
                add_to(bwd, "K2", d.index,
                       int(np.count_nonzero(ri.edge_counts[:, s])))
        if cfg.ring_exchange == "rdma":
            shifts = (ri.n_shards - 1) * (2 if base == "pna" else 1)
            for card, (n, remote) in k9_shift_launches(ri.devices).items():
                # CPU blocks take K9's plain version, which launches nothing
                add_to(k9, "K9", card, n * shifts * (card is not None))
                if not by_card:
                    add_to(k9, "K9x", card, remote * shifts)
        return fwd, bwd, k9

    def add(total, counts, times):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v * times

    (ef, eb, ek9), (rf, rb, rk9) = tower(und, entity), tower(rel_graph,
                                                              relation)
    L, Lr = len(entity.hidden_dims), len(relation.hidden_dims)
    per_batch, per_step = {}, {}
    for counts, times in ((ek9, 2 * L), (ef, 2 * L), (rk9, Lr), (rf, Lr)):
        add(per_batch, counts, times)
    for counts, times in ((ek9, 2 * L), (rk9, 2 * Lr), (ef, L), (eb, L),
                          (rf, Lr), (rb, Lr)):
        add(per_step, counts, times)
    return per_batch, per_step


def parity_batch(task):
    """The 2 train triples and 8 seeded negatives that phase_train_parity
    steps on, the negatives on the task's device."""
    neg = torch.from_numpy(np.random.default_rng(5).integers(
        0, task.dataset.num_entities, (2, 8)))
    return task.train_triples[:2], neg.to(task.device)


def step_grads(task, model, batch, neg, mesh=None, fp64: bool = False):
    """One loss step of ``task`` (under ``mesh`` when given): its
    gradients by name, on the CPU. With ``fp64`` a double copy of
    ``model`` steps through diagnostics/learning.py's ``fp64_loss`` (double
    copies of the task's graphs, scored and reduced as the task's loss
    function does)."""
    from ultra_torchdrug_tpu_torch.diagnostics.learning import fp64_loss
    from ultra_torchdrug_tpu_torch.parallel.mesh import use_mesh

    scope = use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    m = copy.deepcopy(model).double() if fp64 else model
    m.zero_grad(set_to_none=True)
    with scope:
        if fp64:
            loss = fp64_loss(task)(m, batch, neg)
        else:
            loss, _ = task.loss_step(m, None, batch, neg=neg)
        loss.backward()
    grads = {k: p.grad.detach().cpu() for k, p in m.named_parameters()}
    m.zero_grad(set_to_none=True)
    return grads


def grad_gap(got: dict, want: dict) -> float:
    """The worst norm-wise relative difference of two gradient sets."""
    return max(((got[k].double() - w.double()).norm()
                / w.double().norm().clamp(min=1e-30)).item()
               for k, w in want.items())


def pna_rounding(dataset, cfg: dict, task, mesh, model, single,
                 single_model, label: str) -> dict:
    """Whether the edge run's PNA gradients differ from the single
    device's by rounding alone, on phase_train_parity's loss step at the
    seeded weights. The edge path on the card in fp64 must agree within
    PNA_FP64_GRAD_RTOL with the single-device model in fp64 on the CPU
    (the kernels' plain versions, which share their convention at ties:
    every tied edge takes all of the gradient; the O(E) route splits it
    and so computes another gradient where messages tie). Then each fp32
    route on the card (the edge path, the single device's fused pairs and
    the unfused ones that an edge axis takes off the mesh) is read against
    that fp64 result. Raises past the limit; returns the readings."""
    from ultra_torchdrug_tpu_torch.engine.build import build_task

    batch, neg = parity_batch(task)
    cpu = build_task(cfg["task"], dataset, rspmm_impl=cfg["rspmm_impl"],
                     device="cpu")
    truth = step_grads(cpu, copy.deepcopy(single_model).to("cpu"), batch,
                       neg.cpu(), fp64=True)
    got = {"edge fp64": step_grads(task, model, batch, neg, mesh, fp64=True),
           "edge": step_grads(task, model, batch, neg, mesh),
           "single fused": step_grads(single, single_model, batch, neg),
           "single unfused": step_grads(single, model, batch, neg)}
    gaps = {k: grad_gap(g, truth) for k, g in got.items()}
    gaps["edge vs single fused"] = grad_gap(got["edge"], got["single fused"])
    gaps["single unfused vs fused"] = grad_gap(got["single unfused"],
                                               got["single fused"])
    log(f"[{label}] PNA gradients, worst norm-wise relative difference "
        f"from the single-device model in fp64 on the CPU: "
        + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items()))
    if not gaps["edge fp64"] <= PNA_FP64_GRAD_RTOL:
        raise AssertionError(f"{label}: the fp64 edge run's gradients differ "
                             f"by {gaps['edge fp64']:.3g} (limit "
                             f"{PNA_FP64_GRAD_RTOL:g})")
    return gaps


def check_partitioned_kernels(part, whole, kernels: dict,
                              num_relations: int, label: str, device):
    """Each shard's forward and backward kernel (``kernels``' ids) against
    its plain version on the card at the eval width, F = EVAL_BATCH x FEAT,
    in the shard's two row spaces: its forward CSR gathers x [V, F] into
    v_block rows, its reverse CSR takes x [v_block, F] and the gradient
    [V, F] (ops/rspmm_bwd_cuda.py::check_bwd_operands); logs K2's plan on
    a shard's reverse CSR beside the one on ``whole`` (the graph's own
    CSR). Launches made here precede the counted runs."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda as bwd
    from ultra_torchdrug_tpu_torch.ops import rspmm_cuda as fwd

    F, V, vb = EVAL_BATCH * FEAT, part.num_nodes, part.v_block
    gen = torch.Generator(device=device).manual_seed(49)
    w = torch.rand(int(part.fwd_counts.sum()), generator=gen, device=device)
    rel = torch.randn((num_relations, F), generator=gen, device=device)
    x, g = (torch.randn((V, F), generator=gen, device=device)
            for _ in range(2))
    x_loc = torch.randn((vb, F), generator=gen, device=device)
    mode = "add_rel" if kernels["bwd"] == "K3" else "mul_rel"
    bf16 = kernels["fwd"] == "K1h"
    errs = []
    for s in range(part.n_shards):
        c = part.fwd[s]
        # the operands on the shard's card (phase 52: a card of its own)
        w, rel, x, g, x_loc = (t.to(c.rowptr.device)
                               for t in (w, rel, x, g, x_loc))
        args = (c.rowptr, c.src, c.etype, c.eid, w, rel, x, mode)
        pairs = [(fwd.rspmm_fwd_bf16_cuda if bf16 else fwd.rspmm_fwd_cuda)(
                      *args, segments=c.segments),
                  (fwd.rspmm_fwd_bf16_plain if bf16 else fwd.rspmm_fwd_plain)(
                      *args)]
        assert_fwd_close(*pairs)
        if part.rev is not None:  # the reverse CSRs of a backward's graph
            r = part.rev[s]
            if bf16:
                got = bwd.rspmm_bwd_bf16_cuda(r, w, rel, x_loc, g)
                want = bwd.rspmm_bwd_bf16_plain(r, w, rel, x_loc, g)
            else:
                got = bwd.rspmm_bwd_cuda(r, w, rel, x_loc, g, mode=mode)
                want = bwd.rspmm_bwd_plain(r, w, rel, x_loc, g, mode=mode)
            for a, b in zip(got, want):
                assert_bwd_close(a, b)
                pairs += [a, b]
        errs.append(max((a - b).abs().max().item()
                        for a, b in zip(pairs[::2], pairs[1::2])))
    checked = kernels["fwd"] + (f" and {kernels['bwd']}"
                                if part.rev is not None else "")
    log(f"[{label}] {checked} on each shard's CSRs (out {vb} of {V} rows, "
        f"F={F}) against their plain versions: max_abs_err "
        f"{[f'{e:.3g}' for e in errs]}")
    if part.rev is not None and kernels["bwd"] == "K2":
        # a shard's K2 sizes its CTA plan from the whole graph's rows
        # (ops/rspmm_bwd_cuda.py::_plan_rows), as the single device's does
        for name, csr in (("shard 0", part.rev[0]), ("whole graph", whole)):
            plan = bwd.k2_plan(csr, F)
            log(f"[{label}] K2 plan on the {name}'s reverse CSR: dx pass "
                f"{plan_text(plan['dx'])}; dr pass {plan_text(plan['dr'])}")


def run_edge_path(dataset, device, label: str, cfg: dict, kernels: dict,
                  train: bool = True, train_size=None, score_atol=None,
                  grad_rtol=None, cards=None, pna_fp64: bool = True):
    """One path of phases 49-52 on ``dataset`` (a built dataset of
    ``cfg``): the edge task through mesh_scope and build_task, one eval
    batch of EVAL_BATCH (with its launches; ``kernels`` names the path's
    forward and backward kernel ids, see ``edge_launches``), the scores of
    EVAL_BATCH queries against the single-device task on the same card and
    weights; with ``train`` one Engine.train step at ``train_size`` and
    one loss step's loss and gradients against the single-device step.
    ``device`` with an index pins every shard to it (phases 49-51);
    "cuda" spreads them over the cards (phase 52), and ``cards`` then
    names the cards whose peak memory is logged and whose launches by
    card (card_launch_spy) must be each shard's on its own card.
    ``pna_fp64`` runs ``pna_rounding`` on a pna tower. Returns the launch
    counts by half, with "K9x" (K9's stores to another card)."""
    from ultra_torchdrug_tpu_torch.engine.build import (
        build_engine,
        build_task,
        mesh_scope,
    )
    from ultra_torchdrug_tpu_torch.parallel.mesh import use_mesh

    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    with mesh_scope(cfg, device) as (mesh, edge_axis, rel_edge_axis):
        task = build_task(cfg["task"], dataset, rspmm_impl=cfg["rspmm_impl"],
                          device=device, edge_axis=edge_axis,
                          rel_edge_axis=rel_edge_axis)
    model = task.init_params(seed=0)
    # the single-device run: the same model without the edge axis, so that
    # its convs take their single-device routes (fused PNA pairs, the
    # relation tower's dense matmuls)
    single = build_task(cfg["task"], dataset, rspmm_impl=cfg["rspmm_impl"],
                        device=device)
    single_model = single.init_params(seed=0)
    single_model.load_state_dict(model.state_dict())
    with use_mesh(mesh):
        und, rel_graph = task._prepare_graphs(task.fact_graph, task.rel_graph,
                                              backward=train)
    entity, relation = task.model_cfg.entity, task.model_cfg.relation
    per_batch, per_step = edge_launches(und, rel_graph, entity, relation,
                                        kernels)
    by_card = edge_launches(und, rel_graph, entity, relation, kernels,
                            by_card=True)
    part = und.part_layouts
    ring = und.ring_inputs
    log(f"[{label}] entity {entity.aggregate_func}/{entity.message_func} "
        f"{len(entity.hidden_dims)} layers rspmm_impl={entity.rspmm_impl} "
        f"compute_dtype={entity.compute_dtype}, relation tower edge_axis="
        f"{relation.edge_axis!r}; mesh {mesh.shape}, home {mesh.device}, "
        f"shards on {[str(d) for d in mesh.devices]}; "
        f"set-up {time.perf_counter() - t0:.1f} s; "
        + (f"v_block {part.v_block}, shard edges in "
           f"{part.fwd_counts.tolist()}"
           + (f", out {part.rev_counts.tolist()}" if part.rev is not None
              else "")
           + f", relabelled {part.to_new is not None}"
           if part is not None else "")
        + (f"v_block {ring.v_block}, {ring.nonempty_buckets} of "
           f"{ring.n_shards ** 2} buckets with edges, relabelled "
           f"{ring.to_new is not None}" if ring is not None else "")
        + (f"; layouts by card {layout_gib(und, rel_graph)}" if cards
           else "")
        + (f"; of them the second copies of off-diagonal bucket CSRs "
           f"{ring_copy_gib(ring):.4f} GiB on all cards together" if cards
           and ring is not None
           and ring.csr is not None else ""))
    if (cuda and part is not None
            and entity.aggregate_func.replace("_nobound", "")
            in ("sum", "mean")):
        check_partitioned_kernels(part, und.csr, kernels, und.num_relations,
                                  label, device)
    with use_mesh(mesh):
        eval_counts = phase_slice(task, model, device, per_batch,
                                  label=label, triples=EVAL_BATCH,
                                  cards=cards)
    check_by_card(label, eval_counts, per_batch, by_card[0], cards)
    phase_parity(task, model, device,
                 atol=EDGE_SCORE_ATOL if score_atol is None else score_atol,
                 label=f"{label} parity", ref_task=single, ref_device=device,
                 mesh=mesh, queries=EVAL_BATCH, ref_model=single_model)
    counts = {"eval": eval_counts}
    if train:
        size = train_size or (EDGE_STEP if cuda else EDGE_STEP_REHEARSAL)
        cfg["task"]["num_negative"] = size["negatives"]
        cfg["engine"].update(batch_size=size["batch"], log_interval=10**9)
        with tempfile.TemporaryDirectory() as work_dir:
            engine = build_engine(cfg, task, work_dir=work_dir, seed=0,
                                  mesh=mesh)
            engine.model.load_state_dict(model.state_dict())
            # at the seeded weights, before the timed step moves them
            phase_train_parity(engine, single, device,
                               grad_rtol=grad_rtol or EDGE_GRAD_RTOL,
                               label=f"{label} train parity",
                               ref_device=device, ref_model=single_model)
            if pna_fp64 and entity.aggregate_func.startswith("pna"):
                pna_rounding(dataset, cfg, task, mesh, model, single,
                             single_model, label)
            if cards and cuda:
                # the single-device reference leaves the home card before
                # the step whose peak a card phase 52 holds
                single = single_model = None
                release_device_memory()
            counts["train"] = phase_train(engine, size, device, per_step,
                                          label=f"{label} train",
                                          cards=cards)
            check_by_card(f"{label} train", counts["train"], per_step,
                          by_card[1], cards, size["steps"])
    del task, single, model, single_model
    if cuda:
        release_device_memory()
    return counts


def check_by_card(label: str, counts: dict, per_unit: dict, by_card: dict,
                  cards, units: int = 1) -> None:
    """Add "K9x" (K9 launches that stored to another card, read from
    parallel/rdma.py) to ``counts`` and hold it to ``per_unit``'s; with
    ``cards``, hold card_launch_spy's launches by (kernel, card) to
    ``by_card`` (each shard's kernels on its own card) and log them."""
    from ultra_torchdrug_tpu_torch.parallel import rdma

    counts["K9x"] = rdma.peer_launches
    want = per_unit.get("K9x", 0) * units
    if counts["K9x"] != want:
        raise AssertionError(f"{label}: {counts['K9x']} K9 launches stored "
                             f"to another card, expected {want}")
    if not cards:
        return
    want_cards = {k: v * units for k, v in by_card.items() if v}
    got = {k: v for k, v in CARD_LAUNCHES.items() if v}
    if got != want_cards:
        raise AssertionError(f"{label}: launches by (kernel, card) {got}, "
                             f"expected {want_cards}")
    log(f"[{label}] launches by (kernel, card) {dict(sorted(got.items()))}, "
        f"each shard's on its own card; K9 stores to another card "
        f"{counts['K9x']}")


def ring_copy_gib(ri) -> float:
    """The GiB of the ring's backward-bucket CSRs that its placement
    copied to a second card (``RingRspmmInputs.csr_rev`` entries whose
    forward pair lies on another card)."""
    return sum(t.numel() * t.element_size()
               for s, row in enumerate(ri.csr_rev) for b, c in enumerate(row)
               if ri.devices[s] != ri.devices[b]
               for t in vars(c).values() if torch.is_tensor(t)) / 2**30


def layout_gib(*graphs) -> str:
    """The GiB of the graphs' placed edge layouts on each device."""
    sizes = {}

    def add(t):
        if torch.is_tensor(t):
            sizes[t.device] = sizes.get(t.device, 0) + t.numel() * (
                t.element_size())

    seen = set()
    for g in graphs:
        for lay in (g.ring_inputs, g.part_layouts):
            if lay is None:
                continue
            csrs = []
            if getattr(lay, "csr", None) is not None:
                csrs += [c for row in lay.csr for c in row]
                csrs += [c for row in lay.csr_rev or () for c in row]
            for family in ("fwd", "rev"):
                fam = getattr(lay, family)
                if isinstance(fam, tuple):
                    csrs += [c for c in fam if c is not None]
                elif fam is not None:
                    for f in dataclasses.fields(fam):
                        for t in getattr(fam, f.name):
                            add(t)
            for c in csrs:
                for t in vars(c).values():
                    if torch.is_tensor(t) and id(t) not in seen:
                        seen.add(id(t))
                        add(t)
    return ", ".join(f"{d} {b / 2**30:.4f}" for d, b in sorted(
        sizes.items(), key=lambda kv: str(kv[0]))) + " GiB"


def run_partitioned(dataset, spec, device) -> dict:
    """Phase 49: the partitioned path (rspmm_impl auto under the edge
    mesh): 6x64 fp32 (K1 and K2 once a shard a layer, no K9), then at 2
    entity layers bf16 operands (K1h, K2h), transe (K1 add_rel, K3), max
    (off the ring the single-device K4 and K5) and the xla body
    (sharded_rspmm: no kernel; trained at XLA_TRAIN_BATCH)."""
    cuda = device.type == "cuda"
    runs = {}
    paths = (
        ("partitioned", edge_config(spec, "auto"),
         dict(fwd="K1", bwd="K2"), None),
        ("partitioned bf16", edge_config(spec, "auto", 2,
                                         compute_dtype="bfloat16"),
         dict(fwd="K1h", bwd="K2h"), None),
        ("partitioned transe", edge_config(spec, "auto", 2,
                                           message_func="transe"),
         dict(fwd="K1", bwd="K3"), None),
        ("partitioned max", edge_config(spec, "auto", 2,
                                        aggregate_func="max"),
         dict(fwd="K1", bwd="K2"), None),
        ("partitioned xla", edge_config(spec, "xla", 2), {},
         dict(batch=XLA_TRAIN_BATCH if cuda else 4,
              negatives=128 if cuda else 16, steps=1)),
    )
    for label, cfg, kernels, size in paths:
        runs[label] = run_edge_path(dataset, device, label, cfg, kernels,
                                    train_size=size)
    return runs


def run_ring_extrema(dataset, spec, device) -> dict:
    """Phase 50: the entity tower with max and with pna on the ring
    (rdma), balance forced on and permuted IO: the ring's extremum, pair
    and moments schedules (plain PyTorch, no K1) with K9 between steps;
    one eval batch and one step each against the single-device run
    (K4/K5, K6/K7)."""
    runs = {}
    with forced_balance():
        for agg in ("max", "pna"):
            label = f"ring {agg}"
            cfg = edge_config(spec, "ring", aggregate_func=agg)
            counts = run_edge_path(
                dataset, device, label, cfg, dict(fwd="K1", bwd="K2"),
                score_atol=RING_SCORE_ATOL,
                grad_rtol=PNA_RING_GRAD_RTOL if agg == "pna" else None)
            log(f"[{label}] K9 launches: eval batch {counts['eval']['K9']},"
                f" train step {counts['train']['K9']}")
            runs[label] = counts
    return runs


def run_relation_edge(dataset, spec, device) -> dict:
    """Phase 51: ``parallel.relation_edge`` on each route, one eval batch
    against the single-device run (1e-4: its relation tower takes the
    dense matmuls): both towers on the partitioned kernels, and both on
    the ring (the relation graph's buckets neither balanced nor
    permuted)."""
    runs = {}
    for impl in ("auto", "ring"):
        label = f"relation_edge {impl}"
        cfg = edge_config(spec, impl, relation_edge=True)
        # the single-device relation tower takes its dense matmuls
        runs[label] = run_edge_path(
            dataset, device, label, cfg, dict(fwd="K1", bwd="K2"),
            train=False, score_atol=RING_SCORE_ATOL)
    for impl, aggregate, exchange in (("auto", "sum", "rdma"),
                                      ("ring", "pna", "ppermute")):
        label = f"relation_edge cli {impl} {aggregate} {exchange}"
        runs[label] = run_edge_cli(device, label, impl, aggregate, exchange)
    return runs


def run_edge_cli(device, label: str, impl: str, aggregate: str,
                 exchange: str) -> dict:
    """``run_full.main`` on config/synthetic/smoke.yaml with ``parallel:
    {edge: 4, relation_edge: true}``, ``rspmm_impl``, the entity tower's
    aggregation and exchange: one epoch of 5 steps (both towers' backward
    on their edge layouts), its checkpoint and log, and evaluation.
    Returns its launch counts; K1 and K2 must launch on the card."""
    import yaml

    from ultra_torchdrug_tpu_torch import run_full

    with tempfile.TemporaryDirectory() as tmp:
        text = (REPO / "config/synthetic/smoke.yaml").read_text()
        cfg = yaml.safe_load(text.replace("{{ outdir }}", tmp))
        cfg.update(parallel={"edge": EDGE_SHARDS, "relation_edge": True},
                   rspmm_impl=impl)
        cfg["task"]["model"].update(aggregate_func=aggregate,
                                    ring_exchange=exchange)
        path = Path(tmp) / "smoke_edge.yaml"
        path.write_text(yaml.safe_dump(cfg))
        reset_launch_counts()
        t0 = time.perf_counter()
        engine = run_full.main(["-c", str(path), "--device", str(device)])
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        files = os.listdir(engine.work_dir)
        metrics = engine.metrics["test"]
        towers = (engine.task.model_cfg.entity, engine.task.model_cfg.relation)
        if (engine.epoch != 1 or engine.mesh.edge != EDGE_SHARDS
                or any(t.edge_axis != "edge" or t.rspmm_impl != impl
                       for t in towers)
                or not any(f.endswith(".ckpt") for f in files)
                or not all(math.isfinite(v) for v in metrics.values())):
            raise AssertionError(f"{label}: epoch {engine.epoch}, towers "
                                 f"{towers}, files {files}, metrics "
                                 f"{metrics}")
        used = {k: v for k, v in counts.items() if v}
        if device.type == "cuda" and not (used.get("K1") and used.get("K2")):
            raise AssertionError(f"{label}: launches {used}")
        log(f"[{label}] smoke.yaml with parallel {cfg['parallel']}: "
            f"{seconds:.1f} s on {device}, epoch {engine.epoch}, files "
            f"{sorted(files)}, test mrr {metrics['mrr']:.6f}, launches "
            f"{used}")
    return {"smoke": counts}


def one_card(device) -> torch.device:
    """The device that pins every edge shard to card 0 (phases 26-30 and
    49-51 run on the one-card mesh, also on a host with several cards)."""
    return torch.device("cuda", 0) if device.type == "cuda" else device


def run_edge_phases(device) -> dict:
    """Phases 49-51 on the one-card mesh, each timed beside the card's
    name and power limit; returns their launch counts by path."""
    from ultra_torchdrug_tpu_torch.engine.build import build_dataset

    cuda = device.type == "cuda"
    spec = {"class": "SynthKG", **(FULL if cuda else REHEARSAL)}
    dataset = build_dataset(dict(spec))
    card = nvidia_smi_line() if cuda else str(device)
    runs = {}
    for phase, fn in ((49, run_partitioned), (50, run_ring_extrema),
                      (51, run_relation_edge)):
        t0 = time.perf_counter()
        runs.update(fn(dataset, spec, one_card(device)))
        log(f"[timing] phase {phase} {time.perf_counter() - t0:.1f} s "
            f"({card})")
    return runs


# phase 52: the edge paths with each shard on a card of its own; the K9
# bound between cards: a block over NVLink's 450 GB/s each way (every card
# pushes one block on its own link at once)
NVLINK_BYTES_PER_S = 450e9
# the ring's entity tower keeps its states on the shards' cards: a ring
# path's step peaks on card 0 (the home) at most HOME_PEAK_FACTOR times the
# largest other card's plus HOME_PEAK_SLACK_GIB, which covers what only the
# home holds (the parameters, the relation tower, the optimizer, the loss
# and the targets' gathered rows)
HOME_PEAK_FACTOR = 1.25
HOME_PEAK_SLACK_GIB = 0.5
# the step peaks (GiB, card 0 and the largest of cards 1-3) of the ring
# paths with the tower's states on the home card, each ring op cutting
# them to the cards and bringing its result home (four NVIDIA H100 80GB
# HBM3 at 700 W, edge 4, the same weights and batch)
HOME_STATE_PEAKS = {"cards ring rdma": (6.908, 0.321),
                    "cards ring ppermute": (6.929, 0.344),
                    "cards ring max": (12.859, 4.611),
                    "cards ring pna": (31.950, 5.674)}
K9_STRESS_SHIFTS = 200
RING_OP_ITERS = 3


def sync_cards(cards) -> None:
    for c in cards:
        torch.cuda.synchronize(c)


def topology() -> str:
    """``nvidia-smi topo -m``, and each card's NVLink links and their
    rates (``nvidia-smi nvlink --status``, summed), or why either could
    not be read."""
    lines = []
    for args in (["topo", "-m"], ["nvlink", "--status"]):
        try:
            out = subprocess.run(["nvidia-smi", *args], check=True,
                                 capture_output=True, text=True,
                                 timeout=60).stdout
        except (OSError, subprocess.SubprocessError) as exc:
            lines.append(f"(nvidia-smi {' '.join(args)} failed: {exc})")
            continue
        if args[0] == "topo":
            lines.append(out.rstrip())
            continue
        card, rates = None, {}
        for line in out.splitlines():
            if line.startswith("GPU "):
                card = line.split(":")[0]
                rates[card] = []
            elif card and "GB/s" in line:
                rates[card].append(float(line.split(":")[-1].split()[0]))
        lines += [f"{c}: {len(r)} NVLink links at "
                  f"{', '.join(sorted({f'{x:g}' for x in r}))} GB/s, "
                  f"{sum(r):.1f} GB/s in all (nvidia-smi nvlink --status)"
                  for c, r in rates.items()]
    return "\n".join(lines)


def phase_k9_cards(cards) -> dict:
    """K9 between cards (the ring's n = len(cards) shards, one a card):
    exactly equal to its plain version (PyTorch's copies between cards) at
    ragged and at the ring's shapes, fp32 and bf16; timed at v_block =
    3,636 and F = 1024 and 4096 beside its plain version and its library
    call (one peer ``dst.copy_(src, non_blocking=True)`` a block into
    preallocated blocks) against the NVLink bound, each queued ahead and
    at the host's pace (the ``*host_paced_ms`` keys); then K9_STRESS_SHIFTS
    shifts back to back of distinct fills, each result dropped at once but
    every twentieth, read after one synchronize. Returns the kernels-line
    entry "K9 cards"."""
    from ultra_torchdrug_tpu_torch.diagnostics.timing import cards_time_ms
    from ultra_torchdrug_tpu_torch.parallel import rdma

    n = len(cards)
    peers = {f"{a.index}->{b.index}": torch.cuda.can_device_access_peer(a, b)
             for a in cards for b in cards if a != b}
    log(f"[cards] peer access {peers}")
    log("[cards] nvidia-smi topo -m:\n" + topology())

    def blocks_of(vb, F, dtype, seed):
        gen = torch.Generator().manual_seed(seed)
        return [torch.randn((vb, F), generator=gen).to(dtype).to(c)
                for c in cards]

    def check(blocks):
        got = rdma.shift_blocks(blocks, cards)
        want = rdma.shift_blocks_plain(blocks, cards)
        sync_cards(cards)
        for s in range(n):
            if got[s].device != cards[s] or not torch.equal(got[s], want[s]):
                raise AssertionError(f"K9 between cards differs from its "
                                     f"plain version at shard {s} "
                                     f"{tuple(blocks[s].shape)} "
                                     f"{blocks[s].dtype}")

    for vb, F in ((7, 5), (1, 3), (64, 256), (9, 1000), (3636, 1024)):
        for dtype in (torch.float32, torch.bfloat16):
            check(blocks_of(vb, F, dtype, vb * F))
    log(f"[cards] K9 between {n} cards at ragged and full shapes, fp32 and "
        "bf16: exactly equal to its plain version")

    # ordering and the allocator: distinct fills, results dropped at once
    src = [torch.empty((3636, 1024), device=c) for c in cards]
    kept = {}
    t0 = time.perf_counter()
    for i in range(K9_STRESS_SHIFTS):
        for s, b in enumerate(src):
            b.fill_(float(i * 8 + s))
        out = rdma.shift_blocks(src, cards)
        if i % 20 == 19:
            kept[i] = out
    sync_cards(cards)
    for i, out in kept.items():
        for s in range(n):
            if not bool((out[s] == float(i * 8 + (s - 1) % n)).all()):
                raise AssertionError(f"K9 stress: shift {i} shard {s} holds "
                                     "another shift's fill")
    log(f"[cards] K9 stress: {K9_STRESS_SHIFTS} shifts of distinct fills "
        f"between {n} cards back to back, every 20th kept and read after "
        f"one synchronize, all exact ({time.perf_counter() - t0:.2f} s)")
    del src, kept, out

    entry = None
    vb = -(-FULL["num_nodes"] // 4)
    for F, which in ((EVAL_BATCH * FEAT, "eval"),
                     (TRAIN["batch"] * FEAT, "train")):
        blocks = blocks_of(vb, F, torch.float32, F)
        check(blocks)
        dst = [torch.empty_like(blocks[(s - 1) % n], device=cards[s])
               for s in range(n)]

        def library():
            for s in range(n):
                dst[s].copy_(blocks[(s - 1) % n], non_blocking=True)

        fns = dict(ms=lambda: rdma.shift_blocks(blocks, cards),
                   plain_ms=lambda: rdma.shift_blocks_plain(blocks, cards),
                   library_ms=library)
        reads = {}
        for queued in (True, False):
            for name in list(fns) + list(fns)[::-1]:
                key = name if queued else name.replace("ms", "host_paced_ms")
                reads.setdefault(key, []).append(cards_time_ms(
                    fns[name], cards, 50, queue_ahead=queued))
        times = {k: min(v) for k, v in reads.items()}
        nbytes = blocks[0].numel() * blocks[0].element_size()
        bound = nbytes / NVLINK_BYTES_PER_S * 1e3
        log(f"[cards] K9 between {n} cards, {which} shape v_block={vb} "
            f"F={F} ({nbytes:,} B a block): {times['ms']:.4f} ms a shift "
            f"(plain {times['plain_ms']:.4f}, library peer copy_ "
            f"{times['library_ms']:.4f}); bound {bound:.4f} ms a block over "
            f"450 GB/s, {bound / times['ms']:.1%} of it; each the lesser of "
            "two readings in turns, queued ahead on every card; at the "
            f"host's pace {times['host_paced_ms']:.4f} ms (plain "
            f"{times['plain_host_paced_ms']:.4f}, library "
            f"{times['library_host_paced_ms']:.4f})")
        if entry is None:
            entry = dict(name="K9 cards", route="cuda",
                         source=f"{PACKAGE}/csrc/ring_shift.cu",
                         replaces="ultra_torchdrug_tpu/parallel/rdma.py:83",
                         launches=None, max_abs_err=0.0, **times,
                         bound_ms=bound, bound_by="bytes",
                         library_call="peer dst.copy_(src, non_blocking=True)"
                                      " a block")
        else:
            entry.update({f"{k}_train": v for k, v in times.items()},
                         bound_ms_train=bound)
        del blocks, dst
    return entry


def check_home_peak(label: str, cards) -> None:
    """The ring's tower keeps its activations on the shards' cards: the
    train step's peak on card 0 (run_edge_path's timed step, the last one
    that reset the peaks) at most HOME_PEAK_FACTOR times the largest other
    card's plus HOME_PEAK_SLACK_GIB. Logs every card's peak beside the
    peaks with the states on the home."""
    peaks = [torch.cuda.max_memory_allocated(c) / 2**30 for c in cards]
    limit = HOME_PEAK_FACTOR * max(peaks[1:]) + HOME_PEAK_SLACK_GIB
    home, others = HOME_STATE_PEAKS[label]
    log(f"[{label} train] step peak by card "
        + ", ".join(f"{c} {p:.3f}" for c, p in zip(cards, peaks))
        + f" GiB; card 0's limit {limit:.3f} GiB; with the states on the "
        f"home card {home:.3f} on card 0, {others:.3f} on each other")
    if peaks[0] > limit:
        raise AssertionError(f"{label}: card 0's step peak {peaks[0]:.3f} "
                             f"GiB exceeds {HOME_PEAK_FACTOR} x the largest "
                             f"other card's + {HOME_PEAK_SLACK_GIB} GiB = "
                             f"{limit:.3f}: the tower's states sit on the "
                             "home")


def ring_op_times(dataset, cards) -> dict:
    """One ring sum alone (parallel/ring_rspmm.py::ring_rspmm, forward, K1
    a bucket) on the FB-size KG's entity graph at the eval width, a shard
    a card, with each exchange, queued ahead (the cards' work) and at the
    host's pace: where the two exchanges differ only at the host's pace,
    the host's work a shift, not the cards', separates them end to end.
    Each the lesser of two readings in turns; returns them with the
    shifts an op. Three ops a reading, so that the host queues them all
    within the cards' spin (about 25 ms) while an op's host side takes
    under 8 ms; the log says whether it did."""
    from ultra_torchdrug_tpu_torch.diagnostics.timing import cards_time_ms
    from ultra_torchdrug_tpu_torch.parallel.ring_rspmm import (
        build_ring_rspmm_inputs,
        ring_rspmm,
    )

    und = dataset.fact_graph(None)[0].undirected_with_inverse()
    V, R, n = und.num_nodes, und.num_relations, len(cards)
    ri = build_ring_rspmm_inputs(
        und.edge_index.numpy(), und.edge_type.numpy(), V, n,
        num_relations=R, pallas=True, balance=True).to_mesh(cards)
    gen = torch.Generator().manual_seed(52)
    F = EVAL_BATCH * FEAT
    w = torch.ones(und.num_edges).to(cards[0])
    rel, x = (torch.randn(s, generator=gen).to(cards[0])
              for s in ((R, F), (V, F)))
    reads = {}
    with torch.no_grad():
        for queued in (True, False):
            order = ("rdma", "ppermute", "ppermute", "rdma")
            for exchange in order:
                key = f"{exchange}_{'ms' if queued else 'host_paced_ms'}"
                reads.setdefault(key, []).append(cards_time_ms(
                    lambda: ring_rspmm(w, ri, rel, x, msg="mul",
                                       exchange=exchange),
                    cards, RING_OP_ITERS, queue_ahead=queued))
    times = {k: min(v) for k, v in reads.items()}
    # the spin covers the host's queueing when the calls at the host's
    # pace take less than it in all
    within = RING_OP_ITERS * max(times["rdma_host_paced_ms"],
                                 times["ppermute_host_paced_ms"]) < 25.0
    log(f"[cards] one ring sum alone (V={V}, E={und.num_edges}, F={F}, "
        f"{n} shards a card, {n - 1} shifts, K1 a non-empty bucket): rdma "
        f"{times['rdma_ms']:.4f} ms queued ahead, "
        f"{times['rdma_host_paced_ms']:.4f} ms at the host's pace; "
        f"ppermute {times['ppermute_ms']:.4f} / "
        f"{times['ppermute_host_paced_ms']:.4f} ms; each the lesser of two "
        "readings in turns; the host queued every op within the spin: "
        f"{within}")
    del ri, w, rel, x
    torch.cuda.empty_cache()
    return dict(times, shifts=n - 1, F=F, queued_within_spin=within)


def run_cards(device) -> tuple:
    """Phase 52: the edge paths with edge = min(4, cards) shards, each on a
    card of its own (the mesh's placement), against the single-device run
    on card 0 with the same weights: one eval batch and one Engine.train
    step each (module docstring's list); logs ms, peak memory by card and
    launches by card. Returns (launch counts by path, the "K9 cards"
    entry); on one card it logs that it is not run."""
    from ultra_torchdrug_tpu_torch.engine.build import build_dataset

    count = torch.cuda.device_count() if device.type == "cuda" else 1
    if count < 2:
        log(f"[phase 52] not run: {count} card ({device}); edge shards on "
            "several cards need two or more")
        return {}, None
    edge = min(4, count)
    cards = [torch.device("cuda", i) for i in range(edge)]
    log(f"[phase 52] edge {edge} on {[str(c) for c in cards]}: "
        f"{nvidia_smi_line()}")
    entry = phase_k9_cards(cards)
    spec = {"class": "SynthKG", **FULL}
    dataset = build_dataset(dict(spec))
    home = torch.device("cuda")
    runs = {}
    paths = (
        ("cards partitioned", edge_config(spec, "auto", shards=edge),
         dict(fwd="K1", bwd="K2"), {}),
        ("cards ring rdma", edge_config(spec, "ring", shards=edge),
         dict(fwd="K1", bwd="K2"), dict(score_atol=RING_SCORE_ATOL)),
        ("cards ring ppermute", edge_config(spec, "ring", shards=edge,
                                            ring_exchange="ppermute"),
         dict(fwd="K1", bwd="K2"), dict(score_atol=RING_SCORE_ATOL)),
        ("cards ring max", edge_config(spec, "ring", shards=edge,
                                       aggregate_func="max"),
         dict(fwd="K1", bwd="K2"), dict(score_atol=RING_SCORE_ATOL)),
        ("cards ring pna", edge_config(spec, "ring", shards=edge,
                                       aggregate_func="pna"),
         dict(fwd="K1", bwd="K2"),
         dict(score_atol=RING_SCORE_ATOL, grad_rtol=PNA_RING_GRAD_RTOL)),
        ("cards partitioned bf16", edge_config(
            spec, "auto", 2, compute_dtype="bfloat16", shards=edge),
         dict(fwd="K1h", bwd="K2h"), {}),
        ("cards partitioned transe", edge_config(
            spec, "auto", 2, message_func="transe", shards=edge),
         dict(fwd="K1", bwd="K3"), {}),
        ("cards partitioned max", edge_config(
            spec, "auto", 2, aggregate_func="max", shards=edge),
         dict(fwd="K1", bwd="K2"), {}),
        ("cards partitioned xla", edge_config(spec, "xla", 2, shards=edge),
         {}, dict(train_size=dict(batch=XLA_TRAIN_BATCH, negatives=128,
                                  steps=1))),
        ("cards relation_edge auto", edge_config(
            spec, "auto", relation_edge=True, shards=edge),
         dict(fwd="K1", bwd="K2"), dict(train=False,
                                        score_atol=RING_SCORE_ATOL)),
        ("cards relation_edge ring", edge_config(
            spec, "ring", relation_edge=True, shards=edge),
         dict(fwd="K1", bwd="K2"), dict(train=False,
                                        score_atol=RING_SCORE_ATOL)),
    )
    entry["ring_op"] = ring_op_times(dataset, cards)
    t0 = time.perf_counter()
    with card_launch_spy():
        for label, cfg, kernels, opt in paths:
            if label == "cards partitioned":
                opt = dict(opt, score_atol=0.0)  # scores bitwise
            balance = (forced_balance() if label.endswith(("ring max",
                                                           "ring pna"))
                       else contextlib.nullcontext())
            # the previous path's task and engine (held in cycles) leave
            # the cards first
            release_device_memory()
            with balance:
                runs[label] = run_edge_path(dataset, home, label, cfg,
                                            kernels, cards=cards,
                                            pna_fp64=False, **opt)
            if label in HOME_STATE_PEAKS:
                check_home_peak(label, cards)
    log(f"[timing] phase 52 {time.perf_counter() - t0:.1f} s "
        f"({nvidia_smi_line()})")
    return runs, entry


# phases 54-55: training at length. The learning check's runs (400 steps on
# the card; a few on the CPU, where the verdict is logged, not held) and
# the card vs CPU trajectory from injected draws
LEARNING_STEPS = 400
LEARNING_REHEARSAL = dict(steps=4, window=2)
LEARNING_RUNS = (("fp32", {}), ("bf16", dict(compute_dtype="bfloat16")),
                 ("ring", dict(ring=True)))
TRAJECTORY_STEPS = 20
TRAJECTORY_REHEARSAL_STEPS = 3
# the endurance run's short form, and its CPU rehearsal
ENDURANCE = dict(steps=300, window=50, eval_every=150, ckpt_every=150,
                 resume_check_at=150)
ENDURANCE_REHEARSAL = dict(steps=4, window=2, eval_every=4, ckpt_every=4,
                           resume_check_at=2)


def policy_step_launches(policy: dict, batch: int, layers: int = 6,
                         fwd: str = "K1", bwd: str = "K2") -> dict:
    """``step_launches`` for a resolved policy {"remat", "micro_batch"}
    (as diagnostics/learning.py's ``entity_policy`` reports it), counted
    under ``fwd`` and ``bwd``."""
    mb = policy["micro_batch"]
    chunks = batch // mb if mb and batch > mb else 1
    full = policy["remat"] == "full"
    return {fwd: layers * chunks * (1 + (chunks > 1) + full),
            bwd: layers * chunks}


def learning_launches(label: str, readings: dict, buckets: int) -> dict:
    """The launches a step of phase 54's run ``label``: those of phases 2-3
    (fp32), the bf16 phase (K1h, K2h) and phases 26-29 (the ring: K1 and
    K2 once a non-empty bucket a layer, K9 between the ring's steps,
    forward and transposed)."""
    layers = 6
    if label == "ring":
        if readings["policy"] != {"remat": "none", "micro_batch": 0}:
            raise AssertionError(f"learning ring: policy "
                                 f"{readings['policy']}, expected none")
        steps = RING_SHARDS - 1
        return {"K1": layers * buckets, "K2": layers * buckets,
                "K9": 2 * layers * steps}
    if label == "bf16":
        return policy_step_launches(readings["policy"], readings["batch"],
                                    layers, "K1h", "K2h")
    return policy_step_launches(readings["policy"], readings["batch"],
                                layers)


def learning_trajectory(device) -> None:
    """Phase 54's trajectory (diagnostics/learning.py's ``trajectory``):
    the fp32 learning model's first TRAJECTORY_STEPS steps on the card
    against the port's CPU run from the same weights, batches and injected
    negatives, whole and step by step from the CPU run's states, each held
    to ``learning.TRAJECTORY_LIMITS``."""
    from ultra_torchdrug_tpu_torch.diagnostics import learning

    cuda = device.type == "cuda"
    size = learning.FULL if cuda else learning.REHEARSAL
    steps = TRAJECTORY_STEPS if cuda else TRAJECTORY_REHEARSAL_STEPS
    out = learning.trajectory(device, steps=steps, batch=size["batch"],
                              negatives=size["negatives"], log=log)
    failed = learning.trajectory_failures(out)
    if failed:
        raise AssertionError(f"learning trajectory: {failed}")


def run_learning(device) -> dict:
    """Phase 54: diagnostics/learning.py's check on the card (fp32, bf16,
    the ring on the one-card mesh), LEARNING_STEPS steps each, each held to
    the reference's criterion and to the launches a step its path expects;
    then ``learning_trajectory``. Returns the launch counts by path."""
    from ultra_torchdrug_tpu_torch.diagnostics import learning
    from ultra_torchdrug_tpu_torch.parallel.ring_rspmm import (
        build_ring_rspmm_inputs,
    )

    cuda = device.type == "cuda"
    size = learning.FULL if cuda else learning.REHEARSAL
    sched = dict(steps=LEARNING_STEPS) if cuda else LEARNING_REHEARSAL
    und = learning.offsets_dataset().fact_graph(None)[0]
    und = und.undirected_with_inverse()
    buckets = build_ring_rspmm_inputs(
        und.edge_index.numpy(), und.edge_type.numpy(), und.num_nodes,
        learning.RING_SHARDS, balance="auto").nonempty_buckets
    runs = {}
    for label, kwargs in LEARNING_RUNS:
        if cuda:
            release_device_memory()
        readings = learning.run(device=device, log=log, **kwargs, **sched,
                                **size)
        check_launches(f"learning {label}", readings["launches"],
                       learning_launches(label, readings, buckets),
                       sched["steps"], device)
        log(f"[learning {label}] MRR {readings['mrr_before']:.6f} -> "
            f"{readings['mrr_after']:.6f} [{readings['verdict']}], "
            f"{readings['ms_per_step']:.2f} ms a step, launches a step "
            f"{readings['launches_per_step']}, max_memory_allocated "
            + ("not measured" if readings["max_memory_allocated"] is None
               else f"{readings['max_memory_allocated'] / 2**20:.1f} MiB")
            + f" ({readings['card']})")
        if not all(w["finite"] for w in readings["windows"]):
            raise AssertionError(f"learning {label}: {readings['windows']}")
        if cuda and not readings["ok"]:
            raise AssertionError(f"learning {label}: {readings['verdict']} "
                                 f"under {readings['criterion']}")
        runs[f"learning {label}"] = {"train": readings["launches"]}
    if cuda:
        release_device_memory()
    learning_trajectory(device)
    return runs


def run_endurance(device) -> dict:
    """Phase 55: diagnostics/endurance.py's run in its short form
    (ENDURANCE): every loss finite, the resume check within its limits,
    memory_allocated at each window's end within 64 MiB and VmRSS within
    256 MiB of the second window's from the second window on
    (``endurance.failures``), each window's K1 and K2 launches those of its
    graphs' steps under their resolved policies. Returns the launch counts
    of the windows' steps."""
    from ultra_torchdrug_tpu_torch.diagnostics import endurance

    cuda = device.type == "cuda"
    summary = endurance.run(device=device, log=log,
                            **(ENDURANCE if cuda else ENDURANCE_REHEARSAL),
                            **(endurance.FULL if cuda
                               else endurance.REHEARSAL))
    batch = summary["batch"]
    for w in summary["windows"]:
        want = {k: 0 for k in w["launches"]}
        for name, n in w["graphs"].items():
            for k, v in policy_step_launches(summary["policies"][name],
                                             batch).items():
                want[k] += v * n
        check_launches(f"endurance window {w['step']}", w["launches"],
                       want, 1, device)
    failed = endurance.failures(summary)
    log(f"[endurance] {summary['steps']} steps (+ the resume check's "
        f"{endurance.RESUME_STEPS}): steady "
        f"{summary['steady_ms_per_step']:.2f} ms a step, drift {summary['drift_second_half_vs_first']:+.4f}, "
        f"rss {summary['rss_start_bytes']} -> {summary['rss_end_bytes']} B "
        f"(creep {summary['host_creep_bytes']} B), allocated "
        f"{summary['allocated_start_bytes']} -> "
        f"{summary['allocated_end_bytes']} B (creep "
        f"{summary['device_creep_bytes']} B), projected 200k steps "
        f"{summary['projected_200k_steps_hours']:.2f} h; resume check "
        f"{summary['resume_check']['ok']}; failures {failed} "
        f"({summary['card']})")
    if failed:
        raise AssertionError(f"endurance: {failed}")
    return {"endurance": {"train": summary["launches"]}}


def run_training_phases(device) -> dict:
    """Phases 54-55, each timed; returns their launch counts by path."""
    card = nvidia_smi_line() if device.type == "cuda" else str(device)
    runs = {}
    for phase, fn in ((54, run_learning), (55, run_endurance)):
        t0 = time.perf_counter()
        runs.update(fn(device))
        log(f"[timing] phase {phase} {time.perf_counter() - t0:.1f} s "
            f"({card})")
    return runs


if __name__ == "__main__":
    sys.exit(main())
