"""Smoke run of the PyTorch / CUDA port (det3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --conv-timing [--path second lyft kitti_all]
                          [--prec bf16|fp32] [--tree DIR]
    python3 chip_smoke.py --bwd-timing [--path second cbgs lyft]
                          [--tree DIR]
    python3 chip_smoke.py --nms-timing [--tree DIR]
    python3 chip_smoke.py --build-timing PATH [PATH ...] [--tree DIR]
    python3 chip_smoke.py --only points|train|data|nusc|dist|variants
    python3 chip_smoke.py --only experiments

The second form runs phase 1 and, for each path named (SECOND's by
default), its host plan and the window-conv timing of phase 11 (30, 35)
on it: bf16 on SECOND's plan and fp32 on Lyft's and KITTI-all's unless
--prec says otherwise. The third runs phase 1 and, for each path named
(SECOND's, CBGS's and Lyft's by default), its host training plan and
phase 58 on it (bwd_timing_main): the window conv's backward kernels
against their twins, their times, bounds and shares of the bound, and
the im2col+mm yardsticks. The fourth runs phases 1 and 13 without the
steps' inputs (the NMS kernel at the flagship's N=8 K=1000 at 0.5,
SECOND's N=2 K=1000 at 0.01 and one cluster: a call from Python, the
device time by graph_ms, each of the tree's NMS kernels by name under
torch.profiler). The fifth runs phase 1 and phase 47's timing of the
device voxels and plan on the named paths' bench batches (second,
kitti_all, cbgs, lyft), with their kernels' device time by name under
torch.profiler. They import det3d_tpu_torch from the checkout at DIR
(by default this one): run them on two checkouts in turns on one card
(parent, change, change, parent) to compare two versions of a kernel on
the same yardsticks. The sixth runs phases 1 and 2 and only phases
51-52 (Lyft and KITTI-all from points and under TTA), only the training
phases 53-62, only the data, trainer and evaluation phases 63-66, only
the nuScenes, Lyft and CLI phases 67-70, only the ranks' phases 71-72,
only the variants' phases 73-76 or (the seventh form) only the last
modules' phases 77-80 (these two forms end with the JSON lines too).

The first form drives the port's seven serving paths through the entry
points a user calls (the flagship PointPillars step and SECOND from host
plans, both at KITTI-car scale, then CBGS from host plans at nuScenes
scale, then PointPillars as shipped for KITTI car and nuScenes, then the
two configs whose middles serve in fp32, Lyft CBGS and KITTI 3-class
SECOND, from host plans, all at full widths), then the steps fed points
alone (SECOND and CBGS with device voxels and plans, CBGS and nuScenes
PointPillars under double-flip TTA) and prints one line per phase, in
the order 1 to 11, 39, 40, 14 to 18, 41, 20 to 24, 42, 43, 26 to 30, 44,
31 to 35, 45, 38, 47 to 50, then the profiles 12, 19, 25, 36, 37 each
with its captured step's (46), then 13; then, with every serving stack
freed, Lyft and KITTI-all from points and under TTA (51, 52), and the
pillar path's training (53 to 57: targets, one step card vs CPU, timing,
overfit, validation loss) for KITTI car PointPillars (bf16, B=2) and
the flagship (fp32, B=8), then the sparse middles' training (58 to 62)
for SECOND (B=4) and CBGS (B=2), then training and evaluating from a
KITTI dataset through the public API (63 to 66: the data pipeline's
native point ops, the loader, train_detector / resume / eval_detector on
the shipped KITTI car configs, and the two learning-quality gates),
then from nuScenes and Lyft trees and through the command line (67 to
70: multi-sweep loading and CBGS resampling, train_detector / resume /
eval_detector on the shipped CBGS, Lyft and nuScenes PointPillars
configs, the 6-channel stem's window conv, the three CLIs), then
training and evaluating over torch.distributed ranks (71 and 72: two
gloo ranks sharing the card against one process, and one NCCL rank whose
collectives are captured), then the modules no shipped config names
(73 to 76: the original VoxelNet, SpMiddleFHDNobn and RCNNSpMiddleFHD at
SECOND's full grid, the two-stage crop-and-refine path, a grid deeper
than 64, and utils/flops.py's count of every captured step with its
share of peak), then the last modules, each at a published width (77 to
80: PointRCNN's PointNet++ backbone, the temporal align-and-aggregate
block on the flagship's neck output, ResNet-50 + FPN, SENet-50 and
SSD300, and visualization). It prints its running time at the end.

make_predict_step returns the step a user calls: on the card a
CapturedStep (parallel/graph.py), one CUDA graph per batch signature.
The phases that count a step's kernel launches, catch what it feeds the
NMS kernel, time it against earlier PRs or profile it (4, 6, 9, 11, 12,
16, 18, 19, 20, 22, 24, 25, 28, 30, 33, 35, 36, 37) call its eager form,
``step.eager``: a captured step's Python counters move only while it is
captured. Phases 39-46 drive the captured step itself.

  1. device: the card, as nvidia-smi names it, and its power limit;
  2. build: nvcc builds csrc/rotated_nms.cu and csrc/window_conv.cu
     (sm_90a) and g++ csrc/hostplan.cc (the host-plan builders) from the
     checkout, one process each, in parallel; prints each kernel's
     registers and spills (-Xptxas -v) and the HMMA instructions in
     window_conv's SASS (cuobjdump, where the toolkit has it: a bf16
     kernel without one fails);
  3. NMS kernel against plain: the rotated-NMS keep masks of the CUDA
     kernel and of its plain PyTorch twin, on the card, must be equal at
     thresholds 0.01, 0.2, 0.5, 0.7 and -0.1 (no cull), at the flagship
     shape (N=8 samples, K=1000 boxes), SECOND's (N=2) and CBGS's (N=12),
     K=333, K at the block edges 1, 63, 64, 65, 128, K=4096 and K at the
     wrapper's limit, one cluster, near-touching pairs, all invalid,
     duplicated boxes and zero-size boxes; each line counts the pairs
     past the kernel's cull (near_pairs);
  4. flagship predict: build_stack from the flagship config (full widths,
     fp32, 12000 pillars of 32 points), random weights from
     torch.Generator().manual_seed(0), B=8 structured scans of 16384
     points; detections must be finite, (8, 100, 7), at least one valid,
     and the NMS kernel must have been launched;
  5. the same weights on the CPU at B=1: head outputs agree with the card's
     within the stated tolerance, and the CPU post-processing (plain NMS)
     fed the card's head outputs gives the card's detections (valid masks
     and labels equal, boxes and scores within DET_TOL or DET_REL:
     check_decode);
  6. flagship timing with CUDA events (5 warm-up runs, median of 20):
     predict ms per scan at B=8, its stages, and the NMS kernel (a call
     from Python) against its plain twin;
  7. SECOND host plan: configs/kitti_car_second.py as shipped (0.05 m
     voxels, 20000 voxels of 5 points, bf16 middle; random weights from
     torch.Generator().manual_seed(0), BatchNorm statistics calibrated on
     one scan), host_plan_fn builds the rulebooks and voxels of B=2
     structured scans of 16384 points with the native builders
     (csrc/hostplan.cc), which must equal host_plan_ref_fn's numpy build
     in every key (dtype, shape, values); both builds' ms/scan on one
     thread with the host's CPU model (host_build_vs_numpy; phases 14,
     21, 26 and 31 do the same on their batches);
  8. window-conv kernel against plain: on those plans, at every
     (Cin, Cout, center_shift) the middle launches, with random features
     and weights, in fp32 (rtol = atol = 1e-4) and bf16 (against the plain
     version in fp32 on the same bf16-rounded operands, rtol = atol =
     1e-3), and an all-absent plan (exact zeros);
  9. SECOND predict at B=2: boxes (2, 100, 7), finite, some valid, exactly
     14 window-conv launches (10 sparse, 4 of the dense tail) and at least
     one NMS launch;
 10. SECOND card vs CPU at B=1 with the middle in fp32: host plans and
     voxels equal, head outputs within the stated tolerance, the CPU
     post-processing of the card's heads gives the card's detections;
 11. SECOND timing: predict ms per scan at B=2 (device step; the host plan
     build printed apart), its stages, peak memory; each conv shape's and
     the forward's 14 launches' kernel time, a call from Python and on the
     device (20 calls replayed from one CUDA graph, without the host's
     launch overhead) with the achieved TB/s, TFLOP/s and share of the
     bound, against the plain version and the bound, in both precisions,
     and the blocks of the kernel an SM holds; the yardstick
     im2col+matmul (an im2col gather and one torch.matmul, which the port
     never calls), held to the kernel and timed both ways; in fp32 the
     executed / useful products of the kernel's schedule (f32_schedule);
 14. CBGS host plan: configs/nusc_cbgs_voxelnet.py as shipped (0.1 x 0.1 x
     0.2 m voxels over +-51.2 m, 60000 voxels of 10 points, 5 point
     features, SpMiddleResNetFHD with dense_from=2, bf16 middle, 6-task
     9-dim head; random weights from torch.Generator().manual_seed(0),
     BatchNorm statistics calibrated in fp32 on the card on one scan), the
     rulebooks and voxels of B=2 structured scans of 300000 points and
     their build time;
 15. window-conv kernel against plain on those plans at CBGS's 5 (Cin,
     Cout, center_shift), fp32 and bf16, as phase 8;
 16. CBGS predict at B=2: boxes (2, 498, 9), finite, some valid, exactly
     21 window-conv launches (11 sparse, 10 of the dense tail), the NMS
     kernel launched and fed N=12 K=1000 at thr 0.2;
 17. CBGS card vs CPU at B=1 on the range cut to +-12.8 m (8000 voxels,
     full widths, fp32 middle): host plans and voxels equal, the 6 tasks'
     head outputs within the stated tolerance, the CPU post-processing of
     the card's heads gives the card's detections; then the CPU
     post-processing of the full-size card heads (scan 0 of phase 16's
     batch) against the card's;
 18. CBGS timing: predict ms per scan at B=2, its stages, peak memory, the
     host plan apart; the bf16 window conv at each CBGS shape and the
     forward's 21 launches, as phase 11 does in bf16; the NMS kernel on
     the step's own inputs against its plain twin (a call);
 20. KITTI car PointPillars predict: configs/kitti_car_pointpillars.py as
     shipped (bf16 reader and neck, 12000 pillars of 100 points, hashed
     order, the device voxelizer; random weights from
     torch.Generator().manual_seed(0), BatchNorm statistics calibrated on
     the card on one scan, box regression scaled as for SECOND), on the
     flagship's B=8 structured scans: boxes (8, 100, 7), finite, some
     valid, the NMS kernel launched once and fed N=8 K=1000 at thr 0.5;
 21. nuScenes PointPillars host voxels: configs/nusc_pointpillars.py as
     shipped (0.2 m pillars over +-51.2 m, 30000 pillars of 20 points,
     appearance order, 5 point features), CBGS's B=2 scans of 300000
     points: the host voxelization's time, the pillars before and after
     the cap; the device voxelizer on the card must give the host's
     voxels, coords, counts and num_voxels exactly;
 22. nuScenes PointPillars predict at B=2 from those host voxels (bf16
     reader and neck, weights as phase 20's): boxes (2, 498, 9), finite,
     some valid with more than one label, the NMS kernel launched once and
     fed N=12 K=1000 at thr 0.2;
 23. PointPillars card vs CPU at B=1, both configs at full widths on cut
     ranges (nuScenes +-12.8 m, KITTI car x 0 to 25.6 m, y +-12.8 m; 8000
     pillars), weights as phase 20's: in bf16 the reader and each conv of
     the RPN and head, on the CPU's own inputs, within PP_LAYER_REL; with
     the reader and neck in fp32 on both sides the heads within HEAD_TOL;
     the bf16 heads closer to the CPU's than the CPU's bf16 heads are to
     its fp32 heads; the CPU post-processing of the card's bf16 heads
     gives the card's detections;
 24. PointPillars timing, both configs: predict ms per scan and scans/s,
     peak memory, the stages (the device voxelizer, reader + scatter, RPN +
     head, decode + NMS); for nuScenes the host voxelization apart and
     the device-voxelized route of the same step; each conv shape of the
     RPN and head alone (ms, TFLOP/s, share of the peak); the NMS kernel
     on the step's own inputs against its plain twin (a call);
 26. Lyft host plan: configs/lyft_cbgs_voxelnet.py as shipped (0.1 x 0.1 x
     0.15 m voxels over +-100.8 m, 80000 voxels of 10 points, 5 point
     features, SpMiddleResNetFHD with dense_from=2 and no serve_precision:
     an fp32 middle; 5 tasks, 7 classes, 9-dim head; random weights from
     torch.Generator().manual_seed(0), BatchNorm statistics calibrated in
     fp32 on the card on one scan), the rulebooks and voxels of B=2
     structured scans of 300000 points over the whole range, their build
     time, and the voxels each scan occupies before the cap;
 27. window-conv kernel against plain on those plans in fp32 at each of
     the middle's 21 layers (the dense tail's on the rulebooks it builds,
     tail_plan), each on its own rows (rtol = atol = 1e-4);
 28. Lyft predict at B=2: boxes (2, 415, 9), finite, some valid with more
     than one label, exactly 21 window-conv launches and 1 NMS launch, fed
     N=10 K=1000 at thr 0.2; the tail's last rows scattered to the BEV
     map, (2, 2, 252, 252, 128) fp32, gathered back at their coords on the
     card give the rows exactly and hold no other nonzero;
 29. Lyft card vs CPU at B=1 on the range cut to +-12.8 m (8000 voxels,
     full widths), as phase 17; then the CPU post-processing of the
     full-size card heads (scan 0 of phase 28's batch) against the card's;
 30. Lyft timing: predict ms per scan at B=2, its stages, the middle split
     into its sparse part and its dense tail, peak memory, the host plan
     apart; each 2-D conv of the RPN and head alone (ms, TFLOP/s, share of
     the peak); each RPN stage conv as one cuDNN call, as 128-channel
     chunks (more input channels), one map at a time (B > 1) and as the
     port runs it (models/necks.py::stage_conv); the fp32 window conv at
     each of Lyft's shapes and the
     forward's 21 launches, a call from Python and on the device, against
     the plain version and the bound; the NMS kernel on the step's own
     inputs against its plain twin (a call);
 31. KITTI-all host plan: configs/kitti_all_second.py as shipped (SECOND's
     grid, 20000 voxels of 5 points, yxz order, SpMiddleFHD with no
     serve_precision: an fp32 middle; 3 tasks with a direction classifier
     each; weights as phase 26's), on SECOND's B=2 x 16384-point scans;
 32. window-conv kernel against plain on those plans in fp32 at each of
     the middle's 14 layers, as phase 27;
 33. KITTI-all predict at B=2: boxes (2, 100, 7), finite, some valid with
     more than one label, exactly 14 window-conv launches and 1 NMS
     launch, fed N=6 K=1000 at thr 0.01; the BEV scatter checked as phase
     28's;
 34. KITTI-all card vs CPU at B=1 over the full range, as phase 10;
 35. KITTI-all timing, as phase 30;
 38. CBGS's middle with dense_from=3 and with dense_tail=False, whose
     sparse layers reach 128 channels: on the host plans of phase 14's
     scans, the window-conv kernel against plain at every 128-channel
     layer in fp32 and bf16 (as phase 8), each timed on the device; on the
     range cut to +-12.8 m (8000 voxels, full widths, weights calibrated on
     the card in fp32), the middle through build_stack on the card
     against the CPU's, in fp32 within the stated tolerance and in bf16
     closer to the CPU's bf16 middle than that is to the CPU's fp32 one,
     the card's window conv launched once per sparse layer (16 and 21);
 39-45. the captured step of each path (phase_captured): the flagship
     (39), SECOND (40), CBGS (41), KITTI car PointPillars (42), nuScenes
     PointPillars (43), Lyft (44), KITTI-all (45), each on its bench batch:
     one eager step on device inputs under
     torch.cuda.set_sync_debug_mode("error"); the kernel launches counted
     while the step is captured, equal to the eager step's; the captured
     detections against the eager step's on the same batch (labels and
     valid equal, boxes and scores within DET_TOL or DET_REL, the worst element
     named); a second call replayed without a new capture; ms/batch eager
     and captured from the numpy batch in turns (e c c e), the copy to the
     card included and printed apart;
 12. SECOND profile: torch.profiler over 5 eager predict steps, device
     time by kernel (the window-conv kernels summed) and the device's
     busy share;
 19. CBGS profile, the same over 3 steps;
 25. nuScenes PointPillars profile, the same over 5 steps;
 36. Lyft profile, the same over 3 steps;
 37. KITTI-all profile, the same over 5 steps;
 47. device voxels and plans: on the bench batches of SECOND, KITTI-all,
     CBGS and Lyft, the device voxelizer (yxz or hashed order, fused
     mean) and models/backbones.py::build_plan_device on the card give
     host_plan_fn's coords, counts and num_voxels and every plan key
     exactly, the fused means within rtol = atol = 1e-5; their time a
     batch launched from Python and on the device (one CUDA graph),
     beside the native host build's ms/scan of phases 7, 14, 26 and 31;
 48. SECOND and CBGS from points alone at B=2, full widths: the middle
     builds its plan on the card and computes in fp32 (``precision``; the
     configs serve bf16 from host plans); the eager step's checks as
     phases 9 and 16 (14 / 21 window-conv launches, 1 NMS launch fed N=2
     / 12, K=1000), then the captured step as phases 40 and 41
     (phase_captured); card vs CPU at B=1 from points (SECOND over its
     full range, CBGS on phase 17's cut): device voxels and plans equal,
     heads within the stated tolerance, the CPU post-processing of the
     card's heads gives the card's detections; the fp32 window conv on
     the step's device plan against the plain version at every layer,
     timed as phase 11; the NMS kernel on the step's inputs;
 49. double-flip TTA on CBGS at B=2 (4B = 8 scans through the fp32
     middle): as phase 48, the card vs CPU run on the four flips of a cut
     scan with the CPU's predict_tta, and the CPU's predict_tta of the
     card's full-size heads (scan 0) against the card's; 21 window-conv
     launches at 4B rows and 1 NMS launch over the merged candidates
     (N=12, K=1000);
 50. double-flip TTA on nuScenes PointPillars at B=2 (the device
     appearance voxelizer on 8 scans): as phase 49 without a window conv,
     card vs CPU with the reader and neck in fp32 on both sides;
 51. Lyft (configs/lyft_cbgs_voxelnet.py, fp32 middle) at the shipped B=2
     x 300000 points, fed points alone and under double-flip TTA (8 scans,
     the dense tail on the rows of 8 samples): the eager step's checks
     (boxes, exactly 21 window-conv launches and 1 NMS launch fed N=10
     K=1000 at 0.2, also at 4B rows), its peak memory, then the captured
     step (phase_captured, 2 warm-ups, median of 5) where twice the eager
     peak and what is resident fit in 0.9 of the card (capture_fits,
     printed on its own line; else eagerly only), its peak memory; card
     vs CPU at B=1 from points on the +-12.8 m cut (four flips under TTA);
 52. KITTI-all (configs/kitti_all_second.py) the same on SECOND's B=2 x
     16384-point scans (10 window convs, NMS N=6 K=1000 at 0.01), card vs
     CPU over the full range;
 53. targets (train_scene: points in 6 rotated car boxes a scan, gt padded
     to 16) on the card against the CPU: labels and reg weights equal but
     for anchors within 1e-5 of a threshold or a tie (at most 16), reg
     targets within 1e-5; the anchor-area masks of a pos_area_threshold
     copy equal;
 54. one train step (make_train_step, eager) on the card against the CPU
     from the same calibrated weights: loss within 1e-4 relative, each
     gradient within TRAIN_GRAD_REL (the worst named), BN running
     statistics, the parameters after the step where the clipped
     gradients are clear of zero; no window-conv or NMS launch;
 55. ms/step eager and captured (e c c e, 5 warm-ups, median of 20) from
     numpy and from the card, the split into target assignment, forward,
     backward and optimizer, the captured step's busy share, peak memory;
 56. 30 captured steps on one scene with OneCycle over 30: every loss
     printed and finite, the last 5 below the first 5;
 57. make_loss_eval_step captured on the card against the CPU (bf16
     models also with an fp32 reader and neck);
 58. the window conv's backward kernels against their plain twins at
     every conv of SECOND's (B=4 x 16384 points) and CBGS's (B=2 x
     300000) middles, on their host training plans (the dense tail's on
     the rulebooks it builds, tail_plan): dW
     (csrc/window_conv_bwd.cu) within 1e-4 and bit-equal on a second
     call, the subm dX (the forward kernel, mirrored and transposed
     weights) within 1e-4, the strided dX over the inverse rulebook
     within 1e-4 and bit-equal on a second call; each one's time a call,
     on the device, the twin's, its bound (each input read once, each
     output written once) and share of it, and the im2col+mm yardstick's
     device time; the backward kernels' registers and spills once;
 59. training plans: host_plan_fn(train=True) equal to the numpy build
     and to the device voxels and build_plan_device(train=True) on the
     card, key for key (the inverse rulebooks inv{i} among them);
 60. SECOND's train step (configs/kitti_car_second.py as shipped, fp32 in
     training, B=4) from host training plans: one eager step card vs CPU
     (the loss, the head's gradients within SPARSE_HEAD_REL, every other
     within SPARSE_GRAD_REL), the window-conv launches of an eager step
     (14 forward, 9 subm dX, 4 inverse dX, 14 dW), 4 captured steps
     against 4 eager ones (cuDNN deterministic), timing as 55, a 30-step
     captured overfit;
 61. SECOND fed points alone (the training plan built on the card in the
     step) against the host-fed step, and one captured step;
 62. CBGS (configs/nusc_cbgs_voxelnet.py, fp32 in training; B=2, cut from
     its samples_per_gpu=16 to keep this script inside its time limit):
     card vs CPU on the +-12.8 m cut, launches (21 / 16 / 4 / 21), captured
     vs eager, from points, timing; each with its convolutions' device
     time by input shape (conv_shape_table);
 63. pointops: csrc/pointops.cc (built by g++ in phase 2) against its
     numpy twins (core/augment.py) on the inputs GT-AUG gives it in the
     synthetic tree of phase 64 (a train scene's points in its 6 boxes
     and 15 from the gt database, the 21 boxes' BEV collisions, the
     paired intersection areas of the scene's boxes with every database
     box and of noise_per_object's 100 tries of one box with the other
     20): masks and collisions array-equal, areas within 1e-6; ms a call
     of each and of its twin, with the host's CPU;
 64. the data path: utils/mini_kitti.py writes the 16-scene tree (the
     learning gates'); the train pipelines of mini_config and
     mini_second_config (its HostPlan stage injected) through the
     loader's 2 fork workers over two epochs equal their in-process
     replay (datasets/loader/loader.py::replay: each worker's share from
     its seed and its copy of the dataset); SECOND's batches carry the
     training plans, equal to host_plan_ref_fn(train=True) of their
     points; the loader's ms/batch with 2 workers and the pipeline's
     ms/example in-process, with the host's CPU;
 65. the public API at full width: configs/kitti_car_pointpillars.py
     (bf16 reader and neck) and configs/kitti_car_second.py (fp32 in
     training, the HostPlan stage injected) as shipped, KITTI_DATA at a
     64-scene tree (16 / 8 steps an epoch): train_detector for one epoch
     with a work_dir, resume_from it for a second, eval_detector on val;
     the official result holds Car_3d_easy and every val token, the
     optimizer's count on the card equals the trainer's iter after the
     resume; the kernels a call launches: twice one step's (the captured
     step's eager warm-up and its capture; replays count nothing), so
     2 x (14 forward, 9 subm dX, 4 inverse dX, 14 dW) for SECOND's
     train_detector, none for PointPillars', 2 NMS (and SECOND's 2 x 14
     window convs) for eval_detector, one NMS a batch; the trainer's
     ms/step fed by the loader beside phase 55's / 60's captured step,
     the device's busy share over the resumed epoch (runtime/hooks.py's
     ProfilerHook), eval ms/frame;
 66. tests/test_learning_quality.py's two gates on the card, their recipe
     (mini_config / mini_second_config, 16 scenes, 150 epochs, B=2, 2
     workers, scale_batch_by_devices=False) and thresholds: PointPillars
     Car_3d_easy_loose > 70 and Car_bbox_easy > 40, SECOND > 60 and > 40;
     both APs, the steps, wall seconds and steps/s, the launches held as
     phase 65's; a miss fails the run.
 67. nuScenes data: utils/mini_nuscenes.py writes a nuScenes tree and a
     Lyft tree at nuScenes' scan size (10 scenes of 4 keyframes, 9 sweeps
     between keyframes, 29820 clutter points a sweep: 300000 points a
     10-sweep scan), prepared by cli.py's data preparation (10-sweep
     infos, the nuScenes gt database); the infos (9 past sweeps each, a
     scene's first keyframe padded with itself, 9-dim boxes); CBGS's
     train pipeline as shipped with the HostPlan stage through the
     loader's 2 fork workers over two epochs equal to their in-process
     replay; the examples 6 wide (xyz, intensity, ring, time lag) and
     the stack's stem (27, 6, 16); the pipeline's ms/example and the
     loader's ms/batch, with the host's CPU;
 68. configs/nusc_cbgs_voxelnet.py as shipped (samples_per_gpu cut from
     16 to 2, workers from 6 to 2), NUSC_DATA at the tree: train_detector
     one epoch (4 steps) with a work_dir, resumed for a second under
     ProfilerHook, eval_detector on val with the NDS over every val
     token; launches 2 x (11 / 8 / 2 / 11) a train_detector call, 2 NMS
     and 2 x 11 bf16 window convs an eval_detector call; the trainer's
     ms/step fed by the loader beside phase 62's captured step, the
     device's busy share, eval ms/frame; then the window conv at Cin 6
     (the stem on a nuScenes batch) against its plain twin in fp32 and
     bf16, and its dW (fp32);
 69. configs/lyft_cbgs_voxelnet.py (samples_per_gpu cut from 6 to 2,
     workers from 4 to 2) over the Lyft tree and
     configs/nusc_pointpillars.py (B=4 as shipped) over the nuScenes
     tree: train_detector one epoch and eval_detector, launches exact
     (Lyft as CBGS, its window convs fp32; PointPillars 2 NMS an eval);
     Lyft's ms/step and peak memory;
 70. the CLIs, each a process of its own: ``python -m
     det3d_tpu_torch.cli create_data nuscenes_data_prep`` on a fresh
     tree, ``train`` on configs/smoke_kitti_pointpillars.py (total_epochs
     cut to 1 in a copy) over a 16-scene mini-KITTI tree and ``test`` on
     its work dir; each exits with 0 and ``test`` prints the official
     KITTI result.
 71. two ranks under gloo, processes of their own sharing this card
     (NCCL refuses two ranks on one GPU), at full width: SECOND as
     shipped (B=4 as 2 + 2 from host training plans) and the flagship
     (fp32, B=8 as 4 + 4), one train step a rank against the
     one-process eager step on the whole batch: the loss within 1e-4
     relative, the head's gradients within 1e-4 and every other within
     5e-2 relative L2, the BN running statistics as phase 54 holds
     them; both ranks' gradients and parameters after the update
     bit-equal; each rank's window-conv launches exact (SECOND 10 / 6 /
     3 / 10, the flagship none); the 2-rank eager step's ms/step beside
     the one-process captured step's (phases 55, 60), and the host time
     of its all-reduces; then configs/kitti_car_pointpillars.py over a
     16-scene mini-KITTI tree: train_detector one epoch over the ranks
     (rank 1 with a work dir of its own, in which nothing may appear)
     against one process (half the steps at twice the global batch, the
     ranks' parameters bit-equal), and eval_detector of rank 0's
     checkpoint over the ranks against one process: detections equal
     token by token and the official result equal;
 72. one NCCL rank (a world-size-1 group): SECOND's train step (B=4,
     host training plans) through its collectives, captured: two eager
     steps bit-equal and the captured step bit-equal to them (cuDNN
     deterministic), launches exact, captured ms/step beside phase 60's.
 73. the modules no shipped config names at SECOND's full grid
     (configs/kitti_car_second.py, B=2 x 16384 points, host plans):
     (a) the original VoxelNet (VoxelFeatureExtractor (32, 128) before
     SpMiddleFHD(num_input_features=128)) and (b) SpMiddleFHDNobn in
     SECOND's stack, each through build_stack and make_predict_step
     (bf16 middle as shipped; BN statistics calibrated on the card):
     exactly 14 window-conv launches, the NMS kernel's keep equal to its
     twin's on the step's inputs, the window conv at each layer against
     its twin (times, bound), phase_captured, card vs CPU at B=1 (heads,
     decode) and Nobn's middle card vs CPU by relative L2; (c)
     RCNNSpMiddleFHD alone on its training plan (B=4, fp32): the
     forward, dW, inverse-dX and subm-dX kernels against their twins
     at every conv with times and bounds, one forward and backward card
     vs CPU with the launches exact; (d) VFEV3_ablation and SimpleVoxel
     on the VoxelNet step's voxels, card vs CPU;
 74. SECOND as shipped, captured (the NMS kernel inside the graph),
     feeds its detections to crop_detections (512 points a RoI),
     PointModule (1536 -> 1024 -> 128) and RegHead: crop indices and
     empty card vs CPU equal, RegHead within 1e-4, crop + refine timed;
     the refiner trained 300 Adam steps on tests/test_second_stage_e2e.
     py's scene (B=2, 30 boxes a scan) to below a tenth of its first
     loss; the six new losses and the five metrics card vs CPU;
 75. SECOND with 0.05 m z voxels, a (81, 1600, 1408) grid (the dense
     table and flat rulebooks at res0, windows after): the predict step
     from points at B=2 (11 window-conv launches, captured, peak
     memory), card vs CPU at B=1; the middle's training forward and
     backward on a +-6.4 m cut card vs CPU (the flat per-tap
     backward); a k3/s1 strided window conv's backward (3 candidates a
     dim: the flat per-tap dX) card vs CPU;
 76. utils/flops.py's count (GFLOP, GB, GFLOP in the port's kernels) of
     every step an earlier phase of this run captured and timed, and its
     share of peak and of HBM at that phase's captured ms; the
     flagship's count at B=8 on the card and on the CPU, stage by stage.
 77. PointRCNN's RPN backbone (cfgs/default.yaml's SA_CONFIG and
     FP_MLPS: 4 MSG set abstractions to 4096 / 1024 / 256 / 64 points, 4
     feature propagations; PointNet2Rpn) on B=2 scans of 16384 points
     (xyz, 1000 padded rows): FPS card vs CPU equal (else the first step
     that differs and its top-two gap, which must be a tie within
     rounding), level 0's ball queries card vs CPU equal but in rows with
     a candidate within 1e-5 r^2 of the radius, the eval forward card vs
     CPU (POINT_REL), eager and captured ms of FPS alone and of the
     forward, peak memory, the FLOP count and share, one training step's
     gradients card vs CPU (POINT_GRAD_REL);
 78. AlignFeatureAndAggregation(384, 9) on the flagship RPN's output of
     two B=2 frames, (2, 248, 216, 384): card vs CPU (TEMPORAL_REL),
     eager and captured ms, peak memory, the convolutions' FLOP count
     beside the window sums';
 79. faster_rcnn_r50_fpn_1x.py's ResNet-50 (frozen_stages 1, norm_eval)
     + FPN (5 outputs) and SENet-50 on a (2, 384, 1248, 3) image, SSD300
     at B=8: ms, peak memory, output shapes, sample 0 card vs CPU
     (IMAGE_REL), FLOP count and share; one ResNet-50 + FPN training
     step: no gradient in the stem and stage 1, no running statistic
     moved;
 80. the flagship's captured predict step at B=8, its detections drawn
     by simplevis.kitti_vis (cv2 where the host has it, and the numpy
     rasterizer), the scan and boxes written by viewer3d.export_ply, and
     netviz.summarize of the detector (its total equal to the
     parameters' count); the NMS kernel on the step's inputs against its
     plain twin. Phases 77-79 launch neither kernel.
 46. each path's captured step under torch.profiler (replays, after the
     eager profile where there is one): the device's busy share; then
     REPLAY_WINDOWS profiles of one replay each, after a warm-up replay
     in the same session, whose window-conv and NMS kernels counted by
     name must reach, and never pass, the launches counted during the
     capture (replay_counts: the profiler now and then loses a kernel's
     record, and never adds one);
 13. the NMS kernel alone at the flagship's and SECOND's shapes, on one
     cluster, and on the inputs the flagship, SECOND, CBGS, both
     PointPillars, Lyft and KITTI-all predict steps feed it: the share of
     the pairs past its cull, a call from Python, the device time by
     graph_ms (the JSON line's device_ms), its two kernels under
     torch.profiler. Last, so that no profiler session runs before a step
     is timed.

TF32 is off throughout (cuDNN and matmul), so the card computes in full
fp32 like the CPU, and cuBLAS's bf16 GEMMs reduce in fp32
(allow_bf16_reduced_precision_reduction off), as the CPU's do. Any failed
check raises and the script exits non-zero; without a CUDA device it
exits 1 before printing anything. The last two lines are a JSON object of
the kernels (one entry per kernel over every path, with the flagship's
NMS and SECOND's window-conv times and the launches of each path, then
one per kernel with ``"path": "cbgs"`` at CBGS's shapes, then the NMS
kernel with ``"path": "nusc_pp"`` on the nuScenes PointPillars step's
inputs, then the fp32 window conv and the NMS kernel with ``"path":
"lyft"`` and ``"path": "kitti_all"``, then those of the steps fed points
alone, ``"path"`` ``"second_points"``, ``"cbgs_points"``, ``"cbgs_tta"``
(the fp32 window conv on each step's device plan and the NMS kernel on
its inputs) and ``"nusc_pp_tta"`` (the NMS kernel), then the training
paths' backward kernels, then the ranks' paths of phases 71-72,
``"second_dist"``, ``"second_nccl"`` and ``"kitti_pp_dist_eval"``
(dist_entries: launches counted on the path, times measured on its
nearest path), then phases 73-75's ``"voxelnet"``, ``"nobn"``,
``"second_two_stage"``, ``"deep_points"`` and ``"rcnn_train"``
(variant_entries), then phase 80's ``"flagship_vis"`` (the NMS kernel,
its launches counted during the captured step's first call: the warm-up
and the capture); ``ms``: a call from
Python,
interleaved with the plain version; ``device_ms``: graph_ms) and the JSON
result line. The NMS bound counts
the work these inputs need (a distance test for every valid pair, a full
IoU for the pairs past the cull); the all-pairs bound of earlier PRs is
printed beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import gc
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from det3d_tpu_torch.utils import flops as flop_counts
from det3d_tpu_torch.utils.flops import (BF16_FLOPS, FP32_FLOPS, bound,
                                         conv_taps, conv_work, nms_bound,
                                         tap_rows)

B, POINTS, SEED = 8, 16384, 3
IOU_THR = 0.5
IOU_MARGIN = 1e-4
# phase 3's thresholds: SECOND's, nuScenes / Lyft's, the flagship's, a
# stricter one, and a negative one, where the kernel culls nothing
NMS_THRESHOLDS = (0.01, 0.2, 0.5, 0.7, -0.1)
SECOND_NMS_THR = 0.01
HEAD_TOL = dict(rtol=1e-3, atol=1e-3)   # card vs CPU fp32: sum order only
DET_TOL = 1e-5                          # CPU vs card decode: last-bit exp/sin
# ... or this share of the value where that is larger: 4 fp32 epsilons,
# 2-4 ulps (CUDA's expf is within 2 ulps, the CPU's within 1), which a
# decoded size of 107 m exceeds 1e-5 by
DET_REL = 4 * 2.0 ** -23
BOX_FIELDS = ("x", "y", "z", "w", "l", "h", "yaw")
WARMUP, REPEAT = 5, 20
GRAPH_REPS = 20                         # calls per CUDA graph (graph_ms)

SECOND_CFG = Path(__file__).resolve().parent / "configs" / "kitti_car_second.py"
SECOND_B = 2
CONV_TOL = {"fp32": dict(rtol=1e-4, atol=1e-4),
            "bf16": dict(rtol=1e-3, atol=1e-3)}
# bf16 im2col+matmul against the kernel, max abs: the matmul rounds its
# output to bf16 (|out| < 8 here, half an ulp 2^-6)
YARD_TOL = 3e-2
SECOND_HEAD_TOL = dict(rtol=1e-3, atol=1e-3)
BOX_GAIN = 0.1          # random box-regression weights, scaled (second_state)
# the window convs of each sparse middle in forward order: (plan key, Cin,
# Cout, center_shift). The sparse part's run on the plan's rulebooks; the
# dense tail's (models/backbones.py::_RowsTail) on those the tail builds,
# which tail_plan builds the same way: tsubm<i> at resolution i, tdown<i>
# the strided conv to it (every output kept), tinv<i> its inverse
SECOND_SPARSE = (("s0", 4, 16, True), ("s0", 16, 16, True),
                 ("down1", 16, 32, False), ("subm1", 32, 32, True),
                 ("subm1", 32, 32, True), ("down2", 32, 64, False),
                 ("subm2", 64, 64, True), ("subm2", 64, 64, True),
                 ("subm2", 64, 64, True), ("down3", 64, 64, False))
SECOND_TAIL = (("tsubm3", 64, 64, True),) * 3 + (("tdown4", 64, 64, False),)
SECOND_LAYERS = SECOND_SPARSE + SECOND_TAIL
SECOND_LAUNCHES = len(SECOND_LAYERS)    # window-conv launches a forward: 14
CBGS_SPARSE = ((("s0", 5, 16, True),) + (("s0", 16, 16, True),) * 4
               + (("down1", 16, 32, False),) + (("subm1", 32, 32, True),) * 4
               + (("down2", 32, 64, False),))
CBGS_TAIL = ((("tsubm2", 64, 64, True),) * 4 + (("tdown3", 64, 128, False),)
             + (("tsubm3", 128, 128, True),) * 4
             + (("tdown4", 128, 128, False),))
CBGS_LAYERS = CBGS_SPARSE + CBGS_TAIL

CBGS_CFG = (Path(__file__).resolve().parent / "configs"
            / "nusc_cbgs_voxelnet.py")
CBGS_B, CBGS_POINTS = 2, 300000         # bench.py's cbgs_nusc_predict row
CBGS_LAUNCHES = len(CBGS_LAYERS)        # window-conv launches a forward: 21
CBGS_NMS_THR = 0.2
CBGS_DETS = 6 * 83                      # 6 tasks x nms_post_max_size
# card vs CPU (phase 17): the range cut to +-CBGS_CUT m and its voxels and
# points scaled down with it; every width as shipped
CBGS_CUT, CBGS_CUT_VOXELS, CBGS_CUT_POINTS = 12.8, 8000, 40000
BOX_FIELDS_9 = ("x", "y", "z", "w", "l", "h", "vx", "vy", "yaw")

KITTI_PP_CFG = (Path(__file__).resolve().parent / "configs"
                / "kitti_car_pointpillars.py")
NUSC_PP_CFG = (Path(__file__).resolve().parent / "configs"
               / "nusc_pointpillars.py")
NUSC_PP_DETS = 6 * 83                   # 6 tasks x nms_post_max_size
NUSC_PP_NMS_THR = 0.2
# card vs CPU in bf16 (phase 23), one layer on the same bf16 inputs,
# relative L2: cuDNN and oneDNN sum in other orders and flip a few bf16
# roundings (read up to 1.1e-4); a conv whose output the card did not
# round to bf16 would read ~1.7e-3 (the rounding itself). The ranges are
# cut around PP_CUT m, PP_CUT_VOXELS pillars of PP_CUT_POINTS-point scans,
# every width as shipped
PP_LAYER_REL = 5e-4
PP_CUT, PP_CUT_VOXELS, PP_CUT_POINTS = 12.8, 8000, 40000

# the two configs whose middles serve in fp32 (no serve_precision): Lyft
# CBGS (CBGS's middle and window convs on a (41, 2016, 2016) grid, 80000
# voxels; 5 tasks) and KITTI 3-class SECOND (SECOND's middle; 3 tasks with
# direction classifiers)
LYFT_CFG = (Path(__file__).resolve().parent / "configs"
            / "lyft_cbgs_voxelnet.py")
KITTI_ALL_CFG = (Path(__file__).resolve().parent / "configs"
                 / "kitti_all_second.py")

# the H100's published peaks (HBM bytes/s, fp32 CUDA-core FLOP/s, bf16
# dense tensor-core FLOP/s) and the bound rules of the port's kernels live
# in det3d_tpu_torch/utils/flops.py (imported at the top)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# NMS cases (also used by tests/test_torch_kernels_cuda.py)
# ---------------------------------------------------------------------------

def clustered_boxes(n, k, seed, n_objects=60):
    """(n, k, 5) car-sized BEV boxes [x, y, w, l, r] clustered around
    n_objects objects per sample, as a detector's candidates are."""
    r = np.random.RandomState(seed)
    out = np.empty((n, k, 5), np.float32)
    for s in range(n):
        obj = r.randint(0, n_objects, k)
        ctr = r.uniform([0, -40], [70, 40], (n_objects, 2))
        yaw = r.uniform(-np.pi, np.pi, n_objects)
        out[s, :, :2] = ctr[obj] + r.normal(0, 0.6, (k, 2))
        out[s, :, 2] = r.uniform(1.4, 1.9, k)
        out[s, :, 3] = r.uniform(3.4, 4.4, k)
        out[s, :, 4] = yaw[obj] + r.normal(0, 0.3, k)
    return out


def nms_inputs(boxes, valid, device):
    """(N, K, 5) boxes -> the kernel's (corners, area, valid) on device."""
    from det3d_tpu_torch.core.geometry import _ccw, box_to_corners, \
        polygon_area
    b = torch.as_tensor(boxes, device=device)
    corners = _ccw(box_to_corners(b))
    n, k = b.shape[:2]
    return (corners.reshape(n, k, 8).contiguous(),
            polygon_area(corners).contiguous(),
            torch.as_tensor(valid, device=device).contiguous())


def clear_of_threshold(corners, area, valid, thr=IOU_THR):
    """Invalidate the later box of each valid pair whose plain IoU lies
    within IOU_MARGIN of ``thr``; returns the new valid mask."""
    from det3d_tpu_torch.ops.nms_cuda import pairwise_iou_from_corners
    iou = pairwise_iou_from_corners(corners, area)
    close = (iou - thr).abs() < IOU_MARGIN
    close = torch.triu(close, diagonal=1) & valid[:, :, None] \
        & valid[:, None, :]
    valid = valid & ~close.any(dim=1)
    live = torch.triu(valid[:, :, None] & valid[:, None, :], diagonal=1)
    assert bool(((iou - thr).abs()[live] >= IOU_MARGIN).all())
    return valid


def touching_pairs(n, seed, gaps=(1e-5, 1e-2)):
    """(n, 2, 5) pairs of boxes [x, y, w, l, r], each car- or
    pedestrian-sized at random yaw, the pairs across KITTI's range: half
    with circumcircles just apart (a gap log-uniform in ``gaps``, metres),
    half overlapping by as much."""
    r = np.random.RandomState(seed)
    car = r.uniform(size=(n, 2, 1)) < 0.5
    dims = np.where(car, r.uniform([1.4, 3.4], [1.9, 4.4], (n, 2, 2)),
                    r.uniform([0.4, 0.5], [0.9, 1.0], (n, 2, 2)))
    radius = 0.5 * np.hypot(dims[..., 0], dims[..., 1])          # (n, 2)
    gap = np.exp(r.uniform(*np.log(gaps), n)) * np.where(
        r.uniform(size=n) < 0.5, 1.0, -1.0)
    ang = r.uniform(-np.pi, np.pi, n)
    boxes = np.empty((n, 2, 5))
    boxes[:, 0, :2] = r.uniform([0.0, -40.0], [70.4, 40.0], (n, 2))
    boxes[:, 1, :2] = boxes[:, 0, :2] + (radius.sum(1) + gap)[:, None] \
        * np.stack([np.cos(ang), np.sin(ang)], -1)
    boxes[..., 2:4] = dims
    boxes[..., 4] = r.uniform(-np.pi, np.pi, (n, 2))
    return boxes.astype(np.float32)


def nms_cases(device, thr=IOU_THR):
    """name -> (corners, area, valid) on device, every valid pair's IoU at
    least IOU_MARGIN from ``thr`` where it decides anything (the
    duplicate, zero-size and all-invalid cases as they are)."""
    cases = {}
    for name, (n, k, seed, objs) in {
            "flagship N=8 K=1000": (8, 1000, 0, 60),
            "K=333": (3, 333, 1, 60),
            "SECOND N=2 K=1000": (2, 1000, 5, 60),
            "CBGS N=12 K=1000": (12, 1000, 6, 60),
            "one cluster": (1, 1000, 7, 1),
            **{f"K={k}": (2, k, k, 4) for k in (1, 63, 64, 65, 128)},
    }.items():
        boxes = clustered_boxes(n, k, seed, n_objects=objs)
        valid = np.random.RandomState(seed).uniform(size=(n, k)) > 0.05
        c, a, v = nms_inputs(boxes, valid, device)
        cases[name] = (c, a, clear_of_threshold(c, a, v, thr))
    c, a, v = nms_inputs(touching_pairs(500, 8).reshape(1, 1000, 5),
                         np.ones((1, 1000), bool), device)
    cases["touching"] = (c, a, clear_of_threshold(c, a, v, thr))
    boxes = clustered_boxes(2, 1000, 2)
    cases["all invalid"] = nms_inputs(boxes, np.zeros((2, 1000), bool),
                                      device)
    dup = np.repeat(clustered_boxes(1, 100, 3), 10, axis=1)   # 100 x 10
    dup[0, :, :2] += np.repeat(np.arange(100)[:, None] * 100.0, 10, 0)
    cases["duplicates"] = nms_inputs(dup, np.ones((1, 1000), bool), device)
    zero = clustered_boxes(2, 500, 4)
    zero[:, ::4, 2:4] = 0.0                       # points among the boxes
    c, a, v = nms_inputs(zero, np.ones((2, 500), bool), device)
    cases["zero-size"] = (c, a, v)
    return cases


def nms_large_cases(device, thr=IOU_THR):
    """K=4096 and K at the wrapper's limit, one sample each, on device
    only: the plain twin's (K, K) intermediates take gigabytes there."""
    from det3d_tpu_torch.ops.nms_cuda import MAX_K
    cases = {}
    for k, objs in ((4096, 400), (MAX_K, 1200)):
        c, a, v = nms_inputs(clustered_boxes(1, k, k, n_objects=objs),
                             np.ones((1, k), bool), device)
        cases[f"K={k}"] = (c, a, clear_of_threshold(c, a, v, thr))
    return cases


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_ms(fn, warmup=WARMUP, repeat=REPEAT):
    """Median milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeat):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, reps=GRAPH_REPS, repeat=5):
    """Device milliseconds of one fn(): ``reps`` calls captured in one CUDA
    graph, the median replay by CUDA events over ``reps``. The host's
    launch overhead, which paces a small kernel called eagerly from Python,
    is left out. The capture is relaxed, so that a kernel version which
    sets a function attribute at each launch can be captured too."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                 # warm-up off the default stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    ms = cuda_ms(graph.replay, warmup=1, repeat=repeat) / reps
    del graph
    return ms


def kernel_split_ms(fn, calls=REPEAT):
    """{kernel name: device ms per call} of the CUDA kernels fn() launches,
    under torch.profiler over ``calls`` calls; {} if the profiler sees no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            if t > 0:
                split[name] = split.get(name, 0.0) + t / 1e3 / calls
    return split


def interleaved_ms(fns, rounds=REPEAT, warmup=WARMUP):
    """Median ms of each fn, timed in turns (a, b, b, a, ...) so that both
    see the same clocks, after ``warmup`` calls of each."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    names = list(fns)
    times = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            times[n].append(cuda_ms(fns[n], warmup=0, repeat=1))
    return {n: statistics.median(t) for n, t in times.items()}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        sys.exit(1)
    import det3d_tpu_torch  # noqa: F401  (fails here, before any output,
    #                         when the script runs outside the checkout)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log("phase 1 device (nvidia-smi name, power.limit):")
    log(smi)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}; TF32 off, bf16 GEMMs reduce "
        f"in fp32")
    return smi


def ptxas_report(text):
    """{kernel: (registers, spill store bytes, spill load bytes)} from the
    output of ``nvcc -Xptxas -v``; names demangled by c++filt where the
    host has it."""
    found, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            found[cur] = [None, None, None]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            found[cur][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            found[cur][0] = int(m.group(1))
    return {short_name(k): tuple(v) for k, v in found.items()}


def short_name(mangled):
    """c++filt's name of a kernel, without its namespace and arguments."""
    try:
        name = subprocess.run(["c++filt", mangled], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    except OSError:
        return mangled
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.removeprefix("void ").strip() or mangled


def sass_mma_counts(lib):
    """{kernel: number of HMMA instructions} in ``lib``'s SASS, by
    cuobjdump beside nvcc; None where the toolkit has no cuobjdump."""
    from det3d_tpu_torch import csrc
    tool = Path(csrc.find_nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = short_name(line.split("Function :")[1].strip())
            counts[cur] = 0
        elif cur and "HMMA" in line:
            counts[cur] += 1
    return counts


def phase_build():
    from det3d_tpu_torch import csrc
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(csrc.SOURCES)) as pool:
        list(pool.map(csrc.load, csrc.SOURCES))          # one nvcc each
    names = ", ".join(csrc.library_path(n).name for n in csrc.SOURCES)
    log(f"phase 2 build: {names} in "
        f"{(time.perf_counter() - t0) * 1e3:.0f} ms (one nvcc or g++ each, "
        f"in parallel)")
    for src in csrc.CUDA_SOURCES:
        logf = csrc.build_log(src)
        report = ptxas_report(logf.read_text()) if logf.is_file() else {}
        for kern, (regs, st, ld) in sorted(report.items()):
            log(f"phase 2 ptxas {src}: {kern}: {regs} registers, spill "
                f"stores {st} B, spill loads {ld} B")
        if not report:
            log(f"phase 2 ptxas {src}: no -Xptxas -v output kept")
    counts = sass_mma_counts(csrc.library_path("window_conv"))
    if counts is None:
        log("phase 2 SASS of window_conv: not checked (no cuobjdump)")
        return
    bf16 = {k: n for k, n in counts.items() if "bf16" in k}
    log("phase 2 SASS of window_conv, HMMA instructions per kernel: "
        + ", ".join(f"{k} {n}" for k, n in sorted(counts.items())))
    if not bf16 or not all(bf16.values()):
        raise AssertionError(f"a bf16 window-conv kernel has no HMMA in its "
                             f"SASS: {counts}")


def phase_kernel(dev):
    from det3d_tpu_torch.ops.nms_cuda import (near_pairs, rotated_nms_keep,
                                              rotated_nms_keep_ref)
    worst = 0
    for thr in NMS_THRESHOLDS:
        cases = dict(nms_cases(dev, thr), **nms_large_cases(dev, thr))
        for name, (c, a, v) in cases.items():
            keep = rotated_nms_keep(c, a, v, thr)
            ref = rotated_nms_keep_ref(c, a, v, thr)
            torch.cuda.synchronize()
            diff = int((keep != ref).sum())
            worst = max(worst, int((keep.int() - ref.int()).abs().max()))
            near = int(near_pairs(c, a, v).sum()) if thr >= 0 else "all"
            log(f"phase 3 kernel vs plain [{name}, thr {thr}] "
                f"N={c.shape[0]} K={c.shape[1]}: kept {int(keep.sum())} of "
                f"{int(v.sum())} valid, pairs past the cull {near}, "
                f"mismatches {diff}")
            if diff:
                raise AssertionError(f"keep masks differ on {name}, "
                                     f"thr {thr}")
            if name == "all invalid" and keep.any():
                raise AssertionError("all-invalid input kept a box")
            if (name == "duplicates" and thr >= 0
                    and int(keep.sum()) != 100):
                raise AssertionError("duplicates: expected one box per group")
    return worst


def flagship_stack(device, state=None):
    from det3d_tpu_torch.apis.flagship import flagship_config
    from det3d_tpu_torch.apis.train import build_stack
    from det3d_tpu_torch.models.builder import init_weights
    model, vg, asg, cids, test_cfg = build_stack(flagship_config(),
                                                 device="cpu")
    if state is None:
        init_weights(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(state)
    return model.to(device), vg, asg, cids, test_cfg


def out_pillars(vg, batch, dev):
    pts = torch.as_tensor(batch["points"], device=dev)
    n = torch.as_tensor(batch["num_points"], device=dev)
    return vg.generate_batch(pts, n)["num_voxels"].tolist()


def phase_predict(dev, batch):
    from det3d_tpu_torch.ops.nms_cuda import rotated_nms_keep
    from det3d_tpu_torch.ops.window_conv_cuda import window_conv
    from det3d_tpu_torch.parallel.predict import make_predict_step
    model, vg, asg, cids, test_cfg = flagship_stack("cpu")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    model = model.to(dev)
    step = make_predict_step(model, vg, asg, cids, test_cfg)
    rotated_nms_keep.launches = window_conv.launches = 0
    out = step.eager(batch)
    torch.cuda.synchronize()
    launches = {"rotated_nms_keep": rotated_nms_keep.launches,
                "window_conv": window_conv.launches}
    shape = tuple(out["box3d_lidar"].shape)
    n_valid = out["valid"].sum(dim=1).tolist()
    log(f"phase 4 flagship predict B={B} P={POINTS}: boxes {shape}, valid "
        f"per scan {n_valid}, kernel launches {launches}, pillars per "
        f"scan {out_pillars(vg, batch, dev)}")
    if shape != (B, 100, 7):
        raise AssertionError(f"box3d_lidar shape {shape}")
    for k in ("box3d_lidar", "scores"):
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"{k} not finite")
    if sum(n_valid) < 1:
        raise AssertionError("no valid detection")
    if launches["rotated_nms_keep"] < 1:
        raise AssertionError("the NMS kernel was not launched")
    return (model, vg, asg, test_cfg, step), state, launches


def check_decode(det_d, det_c, what):
    """The card's post-processing (``det_d``) against the CPU's of the same
    head outputs: valid masks and labels equal, boxes and scores within
    DET_TOL absolute or DET_REL of the value, the larger. Returns the text
    to log: each field's largest error over its tolerance, where it lies
    and its size. Past the tolerance it raises with both
    values and the CPU slot whose box is nearest the card's there (another
    slot: the two selections differ; the same slot: the arithmetic)."""
    for k in ("valid", "label_preds"):
        if not torch.equal(det_d[k].cpu(), det_c[k]):
            raise AssertionError(f"{what} post-processing {k} differs")
    parts = []
    for k in ("box3d_lidar", "scores"):
        d, c = det_d[k].cpu(), det_c[k]
        err = (d - c).abs()
        over = err / (c.abs() * DET_REL).clamp(min=DET_TOL)
        at = tuple(int(i) for i in np.unravel_index(int(over.argmax()),
                                                    err.shape))
        fields = BOX_FIELDS if d.shape[-1] == 7 else BOX_FIELDS_9
        field = fields[at[2]] if len(at) == 3 else "score"
        parts.append(f"{k} max err {float(err[at]):.2e} ({field} of sample "
                     f"{at[0]} slot {at[1]}, |value| {abs(float(c[at])):.4g})")
        if float(over[at]) > 1:
            near = (c[at[0]] - d[at[:2]]).abs().reshape(c.shape[1], -1)
            near = near.amax(dim=1)
            slot = int(near.argmin())
            raise AssertionError(
                f"{what} post-processing {k} differs: {parts[-1]}, card "
                f"{float(d[at])!r} CPU {float(c[at])!r}; the CPU box nearest "
                f"the card's is slot {slot}, {float(near[slot]):.3e} away")
    return (f"valid mask and labels equal ({int(det_c['valid'].sum())} "
            f"valid), " + ", ".join(parts) + f" (tolerance {DET_TOL}, or "
            f"{DET_REL:.3g} of the value)")


def phase_cpu(dev, model, state, batch):
    from det3d_tpu_torch.parallel.predict import build_example
    cpu_model, vg, asg, cids, test_cfg = flagship_stack("cpu", state)
    one = {k: v[:1] for k, v in batch.items()}
    with torch.no_grad():
        ex_d = build_example({k: torch.as_tensor(v, device=dev)
                              for k, v in one.items()}, vg, asg)
        ex_c = build_example({k: torch.as_tensor(v) for k, v in one.items()},
                             vg, asg)
        for k in ("voxels", "coordinates", "num_points_per_voxel"):
            if not torch.equal(ex_d[k].cpu(), ex_c[k]):
                raise AssertionError(f"voxelizer {k} differs card vs CPU")
        heads_d = model(ex_d["voxels"], ex_d["num_points_per_voxel"],
                        ex_d["coordinates"])
        heads_c = cpu_model(ex_c["voxels"], ex_c["num_points_per_voxel"],
                            ex_c["coordinates"])
        worst = 0.0
        for k in heads_c[0]:
            d, c = heads_d[0][k].cpu(), heads_c[0][k]
            err = float((d - c).abs().max())
            worst = max(worst, err)
            if not torch.allclose(d, c, **HEAD_TOL):
                raise AssertionError(f"head {k}: card vs CPU max err {err}")
        log(f"phase 5 card vs CPU B=1: voxelizer equal; head outputs max "
            f"abs err {worst:.3e} (tolerance rtol={HEAD_TOL['rtol']} "
            f"atol={HEAD_TOL['atol']})")
        det_d = model.predict(ex_d, heads_d, test_cfg)
        det_c = cpu_model.predict(
            ex_c, [{k: v.cpu() for k, v in h.items()} for h in heads_d],
            test_cfg)
    log(f"phase 5 CPU post-processing of the card's heads: "
        f"{check_decode(det_d, det_c, 'flagship')}")


# the flagship's and SECOND's shapes and thresholds, and a sample whose
# boxes all overlap, where the cull drops almost nothing
NMS_TIMING_CASES = (("flagship N=8 K=1000", IOU_THR),
                    ("SECOND N=2 K=1000", SECOND_NMS_THR),
                    ("one cluster", IOU_THR))


def step_nms_inputs(run):
    """(corners, area, valid, thr): what one ``run()`` of a predict step
    passes to the NMS kernel's wrapper, taken at its caller, ops/nms.py."""
    from det3d_tpu_torch.ops import nms
    seen, wrapper = [], nms.rotated_nms_keep

    def spy(corners, area, valid, thr):
        seen.append((corners, area, valid, thr))
        return wrapper(corners, area, valid, thr)
    nms.rotated_nms_keep = spy
    try:
        run()
    finally:
        nms.rotated_nms_keep = wrapper
    (case,) = seen
    return case


def nms_timing(dev, smi, label, extra=()):
    """The NMS kernel on NMS_TIMING_CASES, then on ``extra`` ((name,
    (corners, area, valid, thr)) pairs): the share of the valid pairs past
    the cull (near_pairs), a call from Python (cuda_ms), the device time
    (graph_ms) and each of its kernels' device time under torch.profiler.
    Returns {case: times}."""
    from det3d_tpu_torch.ops.nms_cuda import rotated_nms_keep
    try:
        from det3d_tpu_torch.ops.nms_cuda import near_pairs
    except ImportError:         # --tree: a version from before the cull
        near_pairs = None
    cases = [(name, (*nms_cases(dev, thr)[name], thr))
             for name, thr in NMS_TIMING_CASES] + list(extra)
    out = {}
    for name, (c, a, v, thr) in cases:
        n_valid = v.sum(dim=1).double()
        pairs = int((n_valid * (n_valid - 1) / 2).sum())
        if near_pairs is None:
            past = f"all {pairs} valid (no cull)"
        else:
            near = int(near_pairs(c, a, v).sum())
            past = (f"{near} of {pairs} valid "
                    f"({100 * near / max(pairs, 1):.2f}%)")

        def fn():
            return rotated_nms_keep(c, a, v, thr)
        t = {"call": cuda_ms(fn), "device": graph_ms(fn),
             "split": kernel_split_ms(fn)}
        split = ", ".join(f"{k} {ms:.4f}" for k, ms in t["split"].items()) \
            or "not measured (the profiler saw no device time)"
        log(f"{label} NMS kernel [{name}, thr {thr}] N={c.shape[0]} "
            f"K={c.shape[1]}: pairs past the cull {past}; {t['call']:.4f} "
            f"ms a call from Python, {t['device']:.4f} ms on the device "
            f"(graph_ms); by kernel under torch.profiler (ms a call): "
            f"{split} [{smi}]")
        out[name] = t
    return out


def phase_timing(dev, stack, batch, smi):
    from det3d_tpu_torch.ops.nms_cuda import (rotated_nms_keep,
                                              rotated_nms_keep_ref)
    from det3d_tpu_torch.parallel.predict import build_example
    model, vg, asg, test_cfg, step = stack
    batch_d = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    torch.cuda.reset_peak_memory_stats()
    predict_ms = cuda_ms(lambda: step.eager(batch_d))
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"phase 6 predict B={B}: {predict_ms:.3f} ms/batch, "
        f"{predict_ms / B:.3f} ms/scan, {B * 1e3 / predict_ms:.1f} scans/s, "
        f"peak memory {peak:.0f} MiB [{smi}]")

    with torch.no_grad():
        ex = build_example(batch_d, vg, asg)
        heads = model(ex["voxels"], ex["num_points_per_voxel"],
                      ex["coordinates"])
        stages = {
            "voxelize": lambda: build_example(batch_d, vg, asg),
            "network": lambda: model(ex["voxels"], ex["num_points_per_voxel"],
                                     ex["coordinates"]),
            "decode+nms": lambda: model.predict(ex, heads, test_cfg),
        }
        parts = {k: cuda_ms(fn) for k, fn in stages.items()}
    log(f"phase 6 stages B={B} (ms/batch): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))

    c, a, v = nms_cases(dev)["flagship N=8 K=1000"]
    nms_ms = interleaved_ms({
        "plain": lambda: rotated_nms_keep_ref(c, a, v, IOU_THR),
        "kernel": lambda: rotated_nms_keep(c, a, v, IOU_THR)})
    log(f"phase 6 rotated NMS keep N=8 K=1000: kernel "
        f"{nms_ms['kernel']:.4f} ms a call from Python interleaved with "
        f"the plain twin (device time: phase 13), plain "
        f"{nms_ms['plain']:.4f} ms [{smi}]")

    torch.backends.cudnn.allow_tf32 = True
    tf32_ms = cuda_ms(lambda: step.eager(batch_d))
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase 6 predict B={B} with cuDNN TF32 on (PyTorch's default): "
        f"{tf32_ms:.3f} ms/batch, {tf32_ms / B:.3f} ms/scan")
    return nms_ms


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same work
# ---------------------------------------------------------------------------

def im2col_matmul(features, packed, weights, center_shift):
    """Phase 11's yardstick, which the port never calls: the same conv as a
    gather of every output row's kz*K taps into an im2col matrix
    (B*O, kz*K*Cin), a zero row where a tap reads none, and one
    torch.matmul with the (kz*K*Cin, Cout) weights, in the operands' type.
    Returns fn() -> (B, O, Cout). The gather index and the features with
    their zero row are made once, outside fn, as a plan would hold them.
    Where a row is a multiple of 16 bytes, the rows and the weights get 8
    bytes of zero channels: index_select of such rows takes a path that is
    an order of magnitude slower on the H100 whatever the width
    (gather_ms; phase 11 prints both)."""
    b, v, cin = features.shape
    o, k = packed.shape[1:]
    kvol, _, cout = weights.shape
    rows, sel = tap_rows(packed, v, center_shift)          # (B, O, K, kz)
    base = torch.arange(b, device=rows.device).view(b, 1, 1, 1) * (v + 1)
    idx = torch.where(sel, base + rows, base + v)          # row v is zero
    idx = idx.transpose(2, 3).reshape(-1)                  # tap j*K + k
    elt = features.element_size()
    width = cin + (8 // elt if cin * elt % 16 == 0 else 0)
    xpad = features.new_zeros(b, v + 1, width)
    xpad[:, :v, :cin] = features
    xpad = xpad.reshape(b * (v + 1), width)
    wmat = weights.new_zeros(kvol, width, cout)
    wmat[:, :cin] = weights
    wmat = wmat.reshape(kvol * width, cout)

    def fn():
        cols = xpad.index_select(0, idx).view(b * o, kvol * width)
        return torch.matmul(cols, wmat).view(b, o, cout)
    return fn


def gather_ms(features, pad):
    """Device ms (graph_ms) of index_select of 27 random rows per row of
    ``features`` (B, V, C), its rows widened by ``pad`` zero channels."""
    flat = torch.nn.functional.pad(features, (0, pad))
    flat = flat.reshape(-1, flat.shape[-1])
    g = torch.Generator(device=flat.device).manual_seed(0)
    idx = torch.randint(0, flat.shape[0], (27 * flat.shape[0],),
                        generator=g, device=flat.device)
    return graph_ms(lambda: flat.index_select(0, idx))


# ---------------------------------------------------------------------------
# SECOND
# ---------------------------------------------------------------------------

def sparse_config(path, precision=None, cut=None):
    """A sparse-middle config as a dict; ``precision`` overrides the
    middle's serve_precision; ``cut`` = (extent, voxels): the range cut to
    +-extent m in x and y (its z kept), every anchor generator's range
    likewise, and the voxel cap cut to ``voxels``."""
    from det3d_tpu_torch.utils.config import Config
    cfg = Config.fromfile(path)
    c = {k: copy.deepcopy(cfg[k]) for k in cfg.keys()}
    if precision is not None:
        c["model"]["backbone"]["serve_precision"] = precision
    if cut is not None:
        e, voxels = cut
        rng = c["voxel_generator"]["range"]
        c["voxel_generator"].update(range=[-e, -e, rng[2], e, e, rng[5]],
                                    max_voxel_num=voxels)
        for g in c["assigner"]["target_assigner"]["anchor_generators"]:
            z = g["anchor_ranges"][2]
            g["anchor_ranges"] = [-e, -e, z, e, e, z]
    return c


def second_config(precision=None):
    """configs/kitti_car_second.py as a dict; ``precision`` overrides the
    middle's serve_precision."""
    return sparse_config(SECOND_CFG, precision)


def calibrate_norms(model, run):
    """Set every BatchNorm's running statistics to those of its input in
    one forward ``run()``, layer after layer, so that each layer sees its
    predecessors' normalized outputs. Random weights through SECOND's 14
    sparse and dense layers otherwise shrink the head outputs to ~1e-10,
    every score ties at 0.5, and the detections are an artefact of how a
    sort breaks ties. All-zero rows (padding) are left out."""
    from det3d_tpu_torch.models.norm import MaskedBatchNorm

    def hook(m, args):
        x = args[0].float().reshape(-1, args[0].shape[-1])
        live = x[x.abs().sum(dim=1) > 0]
        x = live if live.shape[0] > 1 else x
        m.mean.copy_(x.mean(dim=0))
        m.var.copy_(x.var(dim=0, unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, MaskedBatchNorm)]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in handles:
            h.remove()


def calibrated_state(cfg, scan, device):
    """A model's weights: random from torch.Generator().manual_seed(0)
    (models/builder.py::init_weights), BatchNorm statistics calibrated in
    the config's precision on ``device`` on ``scan`` (its host voxels, and
    the host plan of a sparse middle), and the box-regression convs scaled
    by BOX_GAIN
    (every channel: sizes, and CBGS's velocities and vector angles). At unit
    scale the size deltas go through exp() to boxes of 1e8 m and more,
    whose IoUs are rounding noise; scaled, the boxes stay within a car's
    size of their anchors, as a trained head's do. Returns the state dict
    on the CPU."""
    from det3d_tpu_torch.apis.train import build_stack, host_plan_fn
    from det3d_tpu_torch.models.builder import init_weights
    model, vg = build_stack(cfg, device="cpu")[:2]
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(device)
    ex = {k: torch.as_tensor(v, device=device) for k, v in host_plan_fn(
        model, vg, voxelize=True)(scan["points"], scan["num_points"]).items()}
    plan = {k[5:]: v for k, v in ex.items() if k.startswith("plan_")}
    kw = {"plan": plan} if plan else {}
    calibrate_norms(model, lambda: model(
        ex["voxels"], ex["num_points_per_voxel"], ex["coordinates"], **kw))
    with torch.no_grad():
        for name, w in model.named_parameters():
            if name.endswith("conv_box.weight"):
                w.mul_(BOX_GAIN)
    return {k: v.cpu() for k, v in model.state_dict().items()}


@functools.lru_cache(maxsize=None)
def second_state():
    """SECOND's weights (calibrated_state), calibrated on the CPU on the
    first structured scan. Every SECOND model of this script loads these
    weights, whatever its device and precision."""
    from det3d_tpu_torch.utils.synth import structured_batch
    cfg = second_config("fp32")
    scan = structured_batch(1, POINTS, cfg["voxel_generator"]["range"],
                            seed=SEED)
    return calibrated_state(cfg, scan, "cpu")


def load_stack(cfg, state, device):
    """build_stack(cfg) on ``device`` with ``state`` loaded, and the host
    plan builder of its sparse middle."""
    from det3d_tpu_torch.apis.train import build_stack, host_plan_fn
    model, vg, asg, cids, test_cfg = build_stack(cfg, device=device)
    model.load_state_dict(state)
    plan_fn = host_plan_fn(model, vg, train=False, voxelize=True)
    return model, vg, asg, cids, test_cfg, plan_fn


def second_stack(device, precision=None):
    return load_stack(second_config(precision), second_state(), device)


def tail_plan(model, plan, dev, train=False):
    """The rulebooks of ``model``'s dense tail on ``plan`` (its sparse
    middle's plan_* keys, host or device), built on ``dev`` as the
    middle's forward builds them (models/backbones.py::_RowsTail), from
    the plan's transition rows, every conv stubbed to zeros of its output
    shape: {"plan_tsubm<i>": the submanifold rulebook of the tail's rows at
    resolution i, "plan_tdown<i>": the strided conv's to resolution i};
    with ``train`` (a training plan) also "plan_tinv<i>", its packed
    inverse. {} for a middle without a tail, and for a tree (--tree) whose
    tail runs dense."""
    from det3d_tpu_torch.models import backbones as bb
    from det3d_tpu_torch.ops import sparse as sp
    middle = model.backbone
    if not (hasattr(bb, "_RowsTail") and any(
            isinstance(m, bb.DenseConvBN) for m in middle.modules())):
        return {}
    p = {k[5:]: torch.as_tensor(v, device=dev) if isinstance(v, np.ndarray)
         else v for k, v in plan.items() if k.startswith("plan_")}
    def rows_of(packed):
        return packed.idx if isinstance(packed, sp.Flat) else packed

    b, v = rows_of(p["s0"]).shape[:2]
    cin = next(m for m in middle.modules()
               if isinstance(m, bb.SparseConvBN)).weight.shape[1]
    out, res = {}, [middle.start]

    def zeros(x, packed, cout):
        return x.new_zeros(x.shape[0], rows_of(packed).shape[1], cout)

    def sparse(layer, x, packed, *args, **kw):
        return zeros(x, packed, layer.weight.shape[-1])

    def rows(layer, x, packed, dtype=None, valid=None, inverse=None):
        if layer.stride == (1, 1, 1):
            out[f"plan_tsubm{res[0]}"] = packed
        else:
            res[0] += 1
            out[f"plan_tdown{res[0]}"] = packed
            if inverse is not None:
                out[f"plan_tinv{res[0]}"] = inverse[0]
        return zeros(x, packed, layer.weight.shape[0])

    real = bb.SparseConvBN.forward, bb.DenseConvBN.rows
    was = middle.training
    bb.SparseConvBN.forward, bb.DenseConvBN.rows = sparse, rows
    try:
        middle.train(train)
        with torch.no_grad():
            middle(torch.zeros(b, v, cin, device=dev),
                   torch.zeros(b, v, 3, dtype=torch.int32, device=dev),
                   model.grid_size, plan=p)
    finally:
        bb.SparseConvBN.forward, bb.DenseConvBN.rows = real
        middle.train(was)
    return out


def with_plan(layers, plan):
    """The layers of ``layers`` whose rulebooks ``plan`` holds: the sparse
    part's alone on a tree (--tree) whose tail runs dense."""
    return tuple(layer for layer in layers if f"plan_{layer[0]}" in plan)


def detector_of(cfg):
    """The detector of ``cfg`` on the CPU (for tail_plan: its weights play
    no part)."""
    from det3d_tpu_torch.apis.train import build_stack
    return build_stack(cfg, device="cpu")[0]


def conv_cases(plan, dev, dtype, layers=SECOND_LAYERS):
    """The window convs of a sparse middle (``layers``: SECOND_LAYERS,
    CBGS_LAYERS or a CBGS variant's) on its host plan (with its tail's
    rulebooks where ``layers`` has the tail's: tail_plan), in forward order:
    (name, features, packed, weights, center_shift) on ``dev``, random
    features and weights (kz = 3 taps a column, std 1/sqrt(3 K Cin)) in
    ``dtype``. The cases of one (Cin, Cout, center_shift) repeat with the
    forward."""
    g = torch.Generator().manual_seed(0)
    b, v = plan[f"plan_{layers[0][0]}"].shape[:2]

    def feats(cin, rows):
        return torch.randn(b, rows, cin, generator=g).to(dev, dtype)

    def weights(kvol, cin, cout):
        return (torch.randn(kvol, cin, cout, generator=g)
                / (kvol * cin) ** 0.5).to(dev, dtype)

    def packed(key):
        return torch.as_tensor(plan[key], device=dev).contiguous()

    out, rows = [], v
    for key, cin, cout, subm in layers:
        pk = packed(f"plan_{key}")
        if subm:                        # a subm conv's rows are its outputs
            rows = pk.shape[1]
        name = f"{'subm' if subm else 'strided'} ({cin},{cout}) {key}"
        out.append((name, feats(cin, rows), pk,
                    weights(3 * pk.shape[-1], cin, cout), subm))
        rows = pk.shape[1]
    return out


@functools.lru_cache(maxsize=None)
def cpu_model():
    """The host CPU as /proc/cpuinfo describes it: its model name, or,
    where the kernel reports none ("unknown"), its vendor, family and
    model numbers; its logical CPUs and clock."""
    info, cpus = {}, 0
    for line in Path("/proc/cpuinfo").read_text().splitlines():
        key, _, val = (part.strip() for part in line.partition(":"))
        if key == "processor":
            cpus += 1
        info.setdefault(key, val)
    name = info.get("model name", "unknown")
    if name in ("", "unknown"):
        name = (f"{info.get('vendor_id', '?')} family "
                f"{info.get('cpu family', '?')} model "
                f"{info.get('model', '?')} (no model name reported)")
    return f"{name}, {cpus} logical CPUs at {info.get('cpu MHz', '?')} MHz"


def host_build_vs_numpy(cfg, batch, label, rounds=3):
    """The host build of ``batch`` as the serving path runs it
    (apis/train.py::host_plan_fn: csrc/hostplan.cc's native builders)
    against the numpy plain versions (host_plan_ref_fn): every key equal
    in dtype, shape and values. Both builds timed warm, in turns, on one
    thread (median of ``rounds``), printed in ms/scan with the host's CPU
    model. Returns (the native build, its ms/scan)."""
    from det3d_tpu_torch.apis.train import (build_stack, host_plan_fn,
                                            host_plan_ref_fn)
    model, vg = build_stack(cfg, device="cpu")[:2]
    fns = {"native": host_plan_fn(model, vg, voxelize=True),
           "numpy": host_plan_ref_fn(model, vg, voxelize=True)}
    pts, n = batch["points"], batch["num_points"]
    out, times = {}, {name: [] for name in fns}
    for name, fn in fns.items():
        fn(pts[:1], n[:1])                                  # warm
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            t0 = time.perf_counter()
            out[name] = fns[name](pts, n)
            times[name].append((time.perf_counter() - t0) * 1e3
                               / pts.shape[0])
    ms = {name: statistics.median(t) for name, t in times.items()}
    nat, ref = out["native"], out["numpy"]
    if sorted(nat) != sorted(ref):
        raise AssertionError(f"{label}: native keys {sorted(nat)}, numpy "
                             f"{sorted(ref)}")
    for k in ref:
        if (nat[k].dtype != ref[k].dtype
                or not np.array_equal(nat[k], ref[k])):
            raise AssertionError(f"{label}: the native host build's {k} "
                                 f"differs from numpy's")
    log(f"{label} host build B={pts.shape[0]} P={pts.shape[1]}: native "
        f"(csrc/hostplan.cc) {ms['native']:.1f} ms/scan, numpy "
        f"{ms['numpy']:.1f} ms/scan ({ms['numpy'] / ms['native']:.2f}x), "
        f"warm, one thread, median of {rounds} in turns, on the host's "
        f"{cpu_model()}; all {len(ref)} keys equal (dtype, shape, values): "
        + ", ".join(f"{k} {tuple(v.shape)}" for k, v in ref.items()))
    return nat, ms["native"]


def plan_builder(cfg):
    """A sparse-middle config's host plan builder (voxels and rulebooks),
    on the CPU; the weights play no part in it."""
    from det3d_tpu_torch.apis.train import build_stack, host_plan_fn
    model, vg = build_stack(cfg, device="cpu")[:2]
    return host_plan_fn(model, vg, train=False, voxelize=True)


def phase_second_plan(batch):
    """The host plan and voxels of B=2 scans, native against numpy
    (host_build_vs_numpy), and the native build's time."""
    plan, plan_ms = host_build_vs_numpy(second_config(), batch,
                                        "phase 7 SECOND")
    log(f"phase 7 SECOND host plan B={SECOND_B} P={POINTS}: "
        f"{plan_ms:.1f} ms/scan on the host (native); voxels "
        f"per scan {plan['num_voxels'].tolist()}, stage rows "
        + ", ".join(f"{k} {tuple(v.shape)}" for k, v in plan.items()
                    if k.startswith("plan_")))
    return plan, plan_ms


def conv_vs_plain(case, prec, label):
    """The window-conv kernel against its plain twin on one case of
    conv_cases, on the card, within CONV_TOL[prec] (bf16: the plain version
    in fp32 on the same bf16-rounded operands). Returns the max abs
    error."""
    from det3d_tpu_torch.ops.sparse import unpack_windows
    from det3d_tpu_torch.ops.window_conv_cuda import (window_conv,
                                                      window_conv_ref)
    name, x, pk, w, subm = case
    out = window_conv(x, pk, w, subm)
    r0, pres = unpack_windows(pk, 3)
    ref = window_conv_ref(x.float(), r0, pres, w.float(), subm)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    log(f"{label} window conv vs plain [{prec} {name}] B={x.shape[0]} "
        f"V={x.shape[1]} O={pk.shape[1]} K={pk.shape[2]}: max abs err "
        f"{err:.3e}, |ref| max {float(ref.abs().max()):.3f} (tolerance "
        f"{CONV_TOL[prec]})")
    if not torch.allclose(out, ref, **CONV_TOL[prec]):
        raise AssertionError(f"window conv {prec} {name} differs")
    return err


DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def phase_conv_kernel(dev, plan, layers=SECOND_LAYERS, label="phase 8",
                      precisions=("fp32", "bf16"), every_layer=False):
    """The window-conv kernel against its plain twin at every (Cin, Cout,
    center_shift) of ``layers`` on ``plan`` (``every_layer``: at every
    layer, each on its own rows), in ``precisions`` (conv_vs_plain);
    SECOND's phase also runs an all-absent plan. Returns the largest
    error."""
    from det3d_tpu_torch.ops.window_conv_cuda import window_conv
    worst = 0.0
    n_shapes = len(layers) if every_layer else len({layer[1:]
                                                    for layer in layers})
    for prec in precisions:
        seen = set()
        for i, case in enumerate(conv_cases(plan, dev, DTYPES[prec],
                                            layers)):
            shape = i if every_layer else case[0].split(" ")[1] + str(case[4])
            if shape in seen:
                continue
            seen.add(shape)
            worst = max(worst, conv_vs_plain(case, prec, label))
        if len(seen) != n_shapes:
            raise AssertionError(f"expected {n_shapes} conv shapes, got "
                                 f"{seen}")
    if label != "phase 8":
        return worst
    x = torch.randn(SECOND_B, 20000, 16, device=dev)
    w = torch.randn(27, 16, 32, device=dev)
    for subm in (True, False):
        out = window_conv(x, torch.zeros(SECOND_B, 20000, 9,
                                         dtype=torch.int32, device=dev),
                          w, subm)
        if not bool((out == 0).all()):
            raise AssertionError("all-absent plan gave a nonzero output")
    log("phase 8 window conv all-absent plan: exact zeros (both modes)")
    return worst


def sparse_predict(dev, stack, batch, plan, shape_expected,
                   launches_expected, label, min_labels=1):
    """One predict step of a ``stack`` (second_stack, cbgs_stack or
    pp_stack) on ``batch`` and its host ``plan`` (host voxels, and the
    rulebooks of a sparse middle), the kernel launch counts set to 0 just
    before it and read just after. Checks: finite boxes of
    ``shape_expected``, some valid with at least ``min_labels`` labels,
    exactly ``launches_expected`` window-conv launches, the NMS kernel
    launched. Returns ((model, vg, asg, test_cfg, step, data), launches)."""
    from det3d_tpu_torch.ops.nms_cuda import rotated_nms_keep
    from det3d_tpu_torch.ops.window_conv_cuda import window_conv
    from det3d_tpu_torch.parallel.predict import make_predict_step
    model, vg, asg, cids, test_cfg, _ = stack
    step = make_predict_step(model, vg, asg, cids, test_cfg)
    data = dict(batch, **plan)
    window_conv.launches = rotated_nms_keep.launches = 0
    out = step.eager(data)
    torch.cuda.synchronize()
    launches = {"window_conv": window_conv.launches,
                "rotated_nms_keep": rotated_nms_keep.launches}
    shape = tuple(out["box3d_lidar"].shape)
    b = batch["points"].shape[0]
    n_valid = out["valid"].sum(dim=1).tolist()
    labels = sorted(set(out["label_preds"][out["valid"]].tolist()))
    log(f"{label} predict B={b} P={batch['points'].shape[1]}: boxes "
        f"{shape}, valid per scan {n_valid}, labels {labels}, kernel "
        f"launches {launches}")
    if shape != shape_expected:
        raise AssertionError(f"box3d_lidar shape {shape}, expected "
                             f"{shape_expected}")
    for k in ("box3d_lidar", "scores"):
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"{k} not finite")
    if sum(n_valid) < 1:
        raise AssertionError("no valid detection")
    if len(labels) < min_labels:
        raise AssertionError(f"labels {labels}: fewer than {min_labels}")
    if launches["window_conv"] != launches_expected:
        raise AssertionError(f"{launches['window_conv']} window-conv "
                             f"launches, expected {launches_expected}")
    if launches["rotated_nms_keep"] < 1:
        raise AssertionError("the NMS kernel was not launched")
    return (model, vg, asg, test_cfg, step, data), launches


def phase_second_predict(dev, batch, plan):
    return sparse_predict(dev, second_stack(dev), batch, plan,
                          (SECOND_B, 100, 7), SECOND_LAUNCHES,
                          "phase 9 SECOND (bf16 middle)")


def heads_on(model, vg, asg, data, device):
    """(example, head outputs) of ``model`` on ``data`` (scans with their
    host voxels, and the host plan of a sparse middle), on ``device``."""
    from det3d_tpu_torch.parallel.predict import build_example
    t = {k: torch.as_tensor(v, device=device) for k, v in data.items()}
    ex = build_example(t, vg, asg)
    plan = {k[5:]: v for k, v in t.items() if k.startswith("plan_")}
    kw = {"plan": plan} if plan else {}
    return ex, model(ex["voxels"], ex["num_points_per_voxel"],
                     ex["coordinates"], **kw)


def card_vs_cpu(dev, card_stack, cpu_stack, one, label):
    """Card against CPU on the scan ``one`` (B=1) of one sparse-middle
    config, both stacks fp32: host plans and voxels equal, every task's
    head outputs within SECOND_HEAD_TOL, class logits not degenerate, and
    the CPU post-processing of the card's heads gives the card's
    detections (check_decode)."""
    card, vg, asg, _, test_cfg, plan_fn = card_stack
    cpu, *_, plan_fn_c = cpu_stack
    plan_d = plan_fn(one["points"], one["num_points"])
    plan_c = plan_fn_c(one["points"], one["num_points"])
    for k in plan_c:
        if not np.array_equal(plan_d[k], plan_c[k]):
            raise AssertionError(f"host plan {k} differs")
    with torch.no_grad():
        ex_d, heads_d = heads_on(card, vg, asg, dict(one, **plan_d), dev)
        ex_c, heads_c = heads_on(cpu, vg, asg, dict(one, **plan_c), "cpu")
        worst = 0.0
        for t, (hd, hc) in enumerate(zip(heads_d, heads_c)):
            for k in hc:
                err = float((hd[k].cpu() - hc[k]).abs().max())
                worst = max(worst, err)
                if not torch.allclose(hd[k].cpu(), hc[k], **SECOND_HEAD_TOL):
                    raise AssertionError(f"{label} task {t} head {k}: card "
                                         f"vs CPU max err {err}")
        spread = min(float(h["cls_preds"].std()) for h in heads_c)
        log(f"{label} card vs CPU B=1 (fp32 middle): host plans and voxels "
            f"equal ({int(plan_c['num_voxels'][0])} voxels); "
            f"{len(heads_c)} task(s)' head outputs max abs err {worst:.3e} "
            f"(tolerance rtol={SECOND_HEAD_TOL['rtol']} "
            f"atol={SECOND_HEAD_TOL['atol']}), class logits std >= "
            f"{spread:.3f}")
        if spread < 0.1:
            raise AssertionError(f"degenerate head outputs (class logits std "
                                 f"{spread})")
        det_d = card.predict(ex_d, heads_d, test_cfg)
        det_c = cpu.predict(
            ex_c, [{k: v.cpu() for k, v in h.items()} for h in heads_d],
            test_cfg)
    log(f"{label} CPU post-processing of the card's heads: "
        f"{check_decode(det_d, det_c, label)}")


def phase_second_cpu(dev, batch):
    card_vs_cpu(dev, second_stack(dev, "fp32"), second_stack("cpu", "fp32"),
                {k: v[:1] for k, v in batch.items()}, "phase 10 SECOND")


def step_timing(dev, stack, plan_ms, smi, label):
    """A sparse-middle predict step's time (CUDA events, WARMUP warm-ups,
    median of REPEAT), scans/s, peak memory, the host plan build printed
    apart, and its stages: middle, rpn+head, decode+nms. Returns the
    middle's output and the device batch."""
    from det3d_tpu_torch.parallel.predict import build_example
    model, vg, asg, test_cfg, step, data = stack
    data_d = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
    b = data_d["points"].shape[0]
    torch.cuda.reset_peak_memory_stats()
    predict_ms = cuda_ms(lambda: step.eager(data_d))
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"{label} predict B={b}: {predict_ms:.3f} ms/batch, "
        f"{predict_ms / b:.3f} ms/scan device step, "
        f"{b * 1e3 / predict_ms:.1f} scans/s, peak memory "
        f"{peak:.0f} MiB; host plan build {plan_ms:.1f} ms/scan apart "
        f"[{smi}]")

    plan = {k[5:]: v for k, v in data_d.items() if k.startswith("plan_")}
    with torch.no_grad():
        ex = build_example(data_d, vg, asg)
        feats = model.reader(ex["voxels"], ex["num_points_per_voxel"])
        mid = model.backbone(feats, ex["coordinates"], model.grid_size,
                             plan=plan)
        heads = model.bbox_head(model.neck(mid))
        stages = {
            "middle": lambda: model.backbone(feats, ex["coordinates"],
                                             model.grid_size, plan=plan),
            "rpn+head": lambda: model.bbox_head(model.neck(mid)),
            "decode+nms": lambda: model.predict(ex, heads, test_cfg),
        }
        parts = {k: cuda_ms(fn) for k, fn in stages.items()}
    log(f"{label} stages B={b} (ms/batch): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()) + f" [{smi}]")
    return mid


def phase_second_timing(dev, stack, plan_ms, smi):
    step_timing(dev, stack, plan_ms, smi, "phase 11 SECOND")
    host_plan = {k: v for k, v in stack[5].items() if k.startswith("plan_")}
    host_plan.update(tail_plan(stack[0], host_plan, dev))
    fwd = {prec: conv_timing(dev, host_plan, smi, prec)
           for prec in ("bf16", "fp32")}
    return fwd["bf16"]


def kernel_model():
    """(f32_schedule, blocks_per_sm) of the det3d_tpu_torch in use, or
    (None, None) for a checkout from before them (--tree)."""
    from det3d_tpu_torch.ops import window_conv_cuda as wc
    return (getattr(wc, "f32_schedule", None),
            getattr(wc, "blocks_per_sm", None))


def conv_timing(dev, host_plan, smi, prec, layers=SECOND_LAYERS,
                label="phase 11"):
    """The window-conv timing on a middle's host plan in ``prec`` (phase
    11: SECOND's; phase 18: CBGS's; phases 30 and 35: Lyft's and
    KITTI-all's, fp32): at each (Cin, Cout, center_shift) of ``layers`` and
    for the forward's launches, a call from Python interleaved with the
    plain version and the yardstick im2col+matmul (im2col_matmul, held to
    the kernel: YARD_TOL in bf16, CONV_TOL in fp32), the device time
    (graph_ms) of the kernel and the yardstick with the achieved rates and
    share of the bound, and the bound; the blocks an SM holds, and in fp32
    the fp32 kernel's executed / useful products (f32_schedule). Returns
    the forward's times (``kernel``: a call; ``device``: graph_ms;
    ``yard_device``: the yardstick's graph_ms) and bound."""
    from det3d_tpu_torch.ops.sparse import unpack_windows
    from det3d_tpu_torch.ops.window_conv_cuda import (window_conv,
                                                      window_conv_ref)
    bf16 = prec == "bf16"
    schedule, blocks = kernel_model()
    cases = conv_cases(host_plan, dev, DTYPES[prec], layers)
    unpacked = [unpack_windows(pk, 3) for _, _, pk, _, _ in cases]
    yard = [im2col_matmul(x, pk, w, subm) for _, x, pk, w, subm in cases]
    products = [0, 0]                       # executed, useful (fp32)
    seen = set()
    for (name, x, pk, w, subm), (r0, pres), ys in zip(cases, unpacked, yard):
        cin, cout = w.shape[1:]
        if not bf16 and schedule is not None:
            sch = schedule(pk, x.shape[1], subm, cout)
            products[0] += sch["executed"] * cin * cout
            products[1] += sch["useful"] * cin * cout
        if name in seen:
            continue
        seen.add(name)
        fns = {"plain": lambda: window_conv_ref(x, r0, pres, w, subm),
               "kernel": lambda: window_conv(x, pk, w, subm),
               "im2col+matmul": ys}
        t = interleaved_ms(fns)
        work = conv_work(x, pk, w, subm)
        b_ms, b_by = bound(*work)
        taps, rows = conv_taps(pk, x.shape[1], subm)
        occ = ("not in this tree" if blocks is None else
               blocks(cin, cout, pk.shape[-1], 3, bf16))
        log(f"{label} window conv [{prec} {name}]: kernel "
            f"{t['kernel']:.4f} ms a call from Python, plain "
            f"{t['plain']:.4f} ms, bound {b_ms:.7f} ms ({b_by}; {rows} of "
            f"{x.shape[0] * x.shape[1]} input rows read, {taps} taps); "
            f"blocks an SM holds: {occ} [{smi}]")
        if not bf16 and schedule is not None:
            useful = max(sch["useful"], 1)
            log(f"{label}   fp32 schedule ({sch['tile']}-row tiles, "
                f"{sch['band']}-row warp bands): {sch['executed']} rows "
                f"multiplied for {sch['useful']} taps that read a row, "
                f"executed / useful products "
                f"{sch['executed'] / useful:.3f}; with the whole tile "
                f"multiplying each listed tap "
                f"{int(sch['listed'].sum()) * sch['tile'] / useful:.3f}")
        dev_ms = graph_ms(fns["kernel"])
        log(f"{label}   kernel on the device {dev_ms:.4f} ms: achieved "
            f"{work[0] / dev_ms / 1e9:.3f} TB/s, "
            f"{work[1] / dev_ms / 1e9:.3f} TFLOP/s, "
            f"{b_ms / dev_ms:.4f} of the bound [{smi}]")
        ref = window_conv(x, pk, w, subm)
        got = ys().float()
        err = float((got - ref).abs().max())
        if (err > YARD_TOL if bf16
                else not torch.allclose(got, ref, **CONV_TOL["fp32"])):
            raise AssertionError(f"im2col+matmul [{prec} {name}] differs "
                                 f"from the kernel by {err}")
        log(f"{label}   im2col+matmul (yardstick, never called by the "
            f"port): {t['im2col+matmul']:.4f} ms a call from Python, "
            f"{graph_ms(ys):.4f} ms on the device; max abs diff from the "
            f"kernel {err:.3e}")
    fns = {"plain": lambda: [window_conv_ref(x, r0, pres, w, subm)
                             for (_, x, _, w, subm), (r0, pres)
                             in zip(cases, unpacked)],
           "kernel": lambda: [window_conv(x, pk, w, subm)
                              for _, x, pk, w, subm in cases],
           "im2col+matmul": lambda: [ys() for ys in yard]}
    t = interleaved_ms(fns)
    work = [conv_work(x, pk, w, subm) for _, x, pk, w, subm in cases]
    fwd = dict(kernel=t["kernel"], plain=t["plain"],
               bound_ms=sum(bound(*wk)[0] for wk in work),
               bound_by="bytes" if all(bound(*wk)[1] == "bytes"
                                       for wk in work) else "operations")
    fwd["device"] = graph_ms(fns["kernel"])
    fwd["yard_device"] = graph_ms(fns["im2col+matmul"])
    line = (f"{label} window conv, the forward's {len(cases)} launches "
            f"[{prec}]: kernel {t['kernel']:.4f} ms called from Python "
            f"({fwd['device']:.4f} ms on the device, "
            f"{fwd['bound_ms'] / fwd['device']:.4f} of the bound)")
    line += (f", plain {t['plain']:.4f} ms, bound {fwd['bound_ms']:.7f} ms "
             f"({fwd['bound_by']})")
    line += (f", im2col+matmul {t['im2col+matmul']:.4f} ms called from "
             f"Python ({fwd['yard_device']:.4f} ms on the device)")
    if products[1]:
        line += (f"; fp32 schedule: executed / useful products "
                 f"{products[0] / products[1]:.3f}")
    log(f"{line} [{smi}]")
    if bf16:
        x = cases[-1][1]
        log(f"{label} why im2col+matmul pads its rows: index_select of "
            f"{27 * x.shape[0] * x.shape[1]} random rows of {x.shape[-1]} "
            f"bf16 takes {gather_ms(x, 0):.4f} ms on the device, of "
            f"{x.shape[-1] + 4} (8 bytes of zeros) {gather_ms(x, 4):.4f} ms")
    return fwd


# phase 76: utils/flops.py's count of each step an earlier phase of this
# run captured and timed, by label: (FlopCounter, captured ms from the
# card, B)
STEP_COUNTS = {}


def count_step(label, run, ms, b):
    """Count one eager ``run()`` of a step (utils/flops.py) and keep it with
    the captured step's ms from the card for phase 76."""
    counter = flop_counts.count_step(run)
    STEP_COUNTS[label] = (counter, ms, b)
    t = counter.totals()
    log(f"{label} count of one step: {t['flops'] / 1e9:.3f} GFLOP, "
        f"{t['bytes'] / 1e9:.3f} GB, {t['kernel_flops'] / 1e9:.3f} GFLOP in "
        f"the port's kernels {dict(sorted(counter.by_kernel.items()))}")


def phase_captured(dev, step, data, launches, smi, label, warmup=WARMUP,
                   rounds=REPEAT):
    """The predict step as a user calls it: ``step`` (make_predict_step's
    CapturedStep) on ``data`` (numpy scans, with their host voxels and
    plan). In order:
      - one eager step on the batch's device copy under
        torch.cuda.set_sync_debug_mode("error"): the step waits for the
        card nowhere (any synchronizing call raises);
      - the capture (after step.warm_up), the kernels' launch counts set to
        0 just before it and read just after: the eager step's ``launches``
        exactly;
      - the captured step's detections against the eager step's on the
        same batch: valid masks and labels equal, boxes and scores within
        DET_TOL or DET_REL, the worst element named (check_decode); a second
        call replays without a new capture;
      - ms/batch of the eager and the captured step from the numpy batch,
        the copy to the card included, in turns (e c c e: interleaved_ms,
        ``warmup`` warm-ups, median of ``rounds``, CUDA events), and each step's
        copy alone (the eager step's pageable .to(), the captured step's
        pinned staging, _Graph.stage).
    Returns {"launches", "eager", "captured", "copy"}."""
    from det3d_tpu_torch.ops.nms_cuda import rotated_nms_keep
    from det3d_tpu_torch.ops.window_conv_cuda import window_conv
    data_d = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
    step.eager(data_d)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step.eager(data_d)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"{label} eager step on device inputs under "
        f"set_sync_debug_mode('error'): no synchronizing call")

    step.warm_up(data)
    window_conv.launches = rotated_nms_keep.launches = 0
    entry = step.capture(data)
    torch.cuda.synchronize()
    captured = {"window_conv": window_conv.launches,
                "rotated_nms_keep": rotated_nms_keep.launches}
    if captured != launches:
        raise AssertionError(f"{label}: the capture launched {captured}, "
                             f"the eager step {launches}")
    out = step(data)
    ref = {k: v.cpu() for k, v in step.eager(data).items()}
    agree = check_decode(out, ref, f"{label} captured vs eager")
    step(data)
    if len(step.graphs) != 1:
        raise AssertionError(f"{label}: {len(step.graphs)} graphs for one "
                             f"batch signature")
    log(f"{label} captured step (one CUDA graph, captured once): kernel "
        f"launches counted during the capture {captured}; against the "
        f"eager step on the same batch: {agree}; a second call replayed "
        f"without a new capture")

    timing = dict(rounds=rounds, warmup=warmup)
    ms = interleaved_ms({"eager": lambda: step.eager(data),
                         "captured": lambda: step(data)}, **timing)
    on_card = interleaved_ms({"eager": lambda: step.eager(data_d),
                              "captured": lambda: step(data_d)}, **timing)
    tensors = step.tensors(data)
    copy = interleaved_ms({
        "eager": lambda: {k: v.to(dev) for k, v in tensors.items()},
        "captured": lambda: entry.stage(tensors)}, **timing)
    mib = sum(t.numel() * t.element_size() for t in tensors.values()) / 2**20
    b = data["points"].shape[0]
    log(f"{label} ms/batch B={b} from the numpy batch, copy to the card "
        f"included, in turns (e c c e): eager {ms['eager']:.3f}, captured "
        f"{ms['captured']:.3f} ({ms['eager'] / ms['captured']:.2f}x; "
        f"{ms['captured'] / b:.3f} ms/scan, "
        f"{b * 1e3 / ms['captured']:.1f} scans/s); the copy of the "
        f"batch's {mib:.1f} MiB alone: eager (pageable) "
        f"{copy['eager']:.3f} ms, captured (pinned staging) "
        f"{copy['captured']:.3f} ms [{smi}]")
    log(f"{label} ms/batch B={b} from the batch already on the card, in "
        f"turns: eager {on_card['eager']:.3f}, captured "
        f"{on_card['captured']:.3f} "
        f"({on_card['eager'] / on_card['captured']:.2f}x); device memory "
        f"reserved {torch.cuda.memory_reserved() / 2**20:.0f} MiB [{smi}]")
    count_step(label, lambda: step.eager(data_d), on_card["captured"], b)
    return {"launches": captured, "eager": ms["eager"],
            "captured": ms["captured"], "copy": copy, "on_card": on_card}


def profile_steps(run, steps):
    """torch.profiler over ``steps`` calls of ``run()`` after one outside
    it: (ms a step on the host's clock, [(device ms a step, launches a
    step, kernel name)])."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
            # rounded: the profiler loses a kernel's record now and then
            kernels.append((t / 1e3 / steps, round(e.count / steps), e.key))
    return wall / steps, kernels


def log_profile(label, wall, kernels, steps, batch, smi, top=12):
    """Log a profile_steps result: the device's busy share of the window,
    the ``top`` kernels by device time, the window-conv kernels summed.
    Returns the busy ms a step (None: the profiler saw no device time)."""
    busy = sum(k[0] for k in kernels)
    if busy <= 0:
        log(f"{label} profile: the profiler saw no device time "
            "(not measured)")
        return None
    log(f"{label} profile, {steps} steps B={batch} under "
        f"torch.profiler: {wall:.3f} ms/step, device busy "
        f"{busy:.3f} ms/step ({busy / wall:.2f} of the window), "
        f"{sum(k[1] for k in kernels)} kernels/step [{smi}]")
    for t, n, name in sorted(kernels, reverse=True)[:top]:
        log(f"{label}   {t:8.3f} ms/step  x{n:<4d} {name[:90]}")
    conv = [k for k in kernels if "window_conv" in k[2]]
    if conv:
        log(f"{label} window-conv kernels: {sum(k[0] for k in conv):.3f} "
            f"ms/step over {sum(k[1] for k in conv)} launches")
    return busy


def phase_profile(stack, dev, smi, steps=5, top=12, label="phase 12 SECOND",
                  batch=SECOND_B):
    """torch.profiler over ``steps`` eager predict steps of a sparse-middle
    stack (phase 12: SECOND's; phase 19: CBGS's): device time by kernel
    and the device's busy share of the window."""
    step, data = stack[4], stack[5]
    data_d = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
    wall, kernels = profile_steps(lambda: step.eager(data_d), steps)
    log_profile(label, wall, kernels, steps, batch, smi, top)


# single-replay profiles a captured step's kernel count is confirmed over
REPLAY_WINDOWS = 5


def replay_counts(run, windows=REPLAY_WINDOWS):
    """The window-conv, NMS mask and NMS scan kernels, and all kernels, by
    name in ``windows`` torch.profiler sessions of one ``run()`` each,
    after one warm-up ``run()`` in the same session (the profiler's
    schedule traces it and drops its records). A list of dicts, one a
    session."""
    from torch.profiler import ProfilerActivity, profile, schedule
    out = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                run()
                torch.cuda.synchronize()
                prof.step()
        c = dict.fromkeys(("window_conv", "rotated_nms_keep", "nms_scan",
                           "all"), 0)
        for e in prof.key_averages():
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                continue
            c["all"] += e.count
            if "window_conv" in e.key:
                c["window_conv"] += e.count
            elif "nms_mask_kernel" in e.key:
                c["rotated_nms_keep"] += e.count
            elif "nms_scan_kernel" in e.key:
                c["nms_scan"] += e.count
        out.append(c)
    return out


def phase_captured_profile(dev, step, data, launches, smi, label, steps=5):
    """torch.profiler over ``steps`` replays of the captured step
    (phase_captured) on its batch's device copy: the device's busy share
    and the kernels by name. Then the window-conv and NMS kernels of a
    replay by name (replay_counts) against the launches counted during
    the capture (the Python counters do not move on replay): in each
    single-replay profile at most those, and in some profile exactly
    those, per kernel."""
    data_d = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
    b = data_d["points"].shape[0]
    wall, kernels = profile_steps(lambda: step(data_d), steps)
    busy = log_profile(f"{label} captured", wall, kernels, steps, b, smi)
    if busy is None:
        return None
    windows = replay_counts(lambda: step(data_d))
    want = dict(launches, nms_scan=launches["rotated_nms_keep"])
    seen = {k: max(w[k] for w in windows) for k in want}
    log(f"{label} captured: kernels of one replay by name in "
        f"{len(windows)} single-replay profiles (window conv, NMS mask, NMS "
        f"scan, all): "
        + ", ".join(f"({w['window_conv']}, {w['rotated_nms_keep']}, "
                    f"{w['nms_scan']}, {w['all']})" for w in windows)
        + f"; counted during the capture {launches}; profiles with every "
        f"kernel of a replay recorded: "
        f"{sum(w['all'] == max(x['all'] for x in windows) for w in windows)}"
        f" of {len(windows)}")
    if seen != want:
        raise AssertionError(f"{label}: one replay ran at most {seen} by "
                             f"name, the capture counted {want}")
    return {"busy": busy, "wall": wall}


# ---------------------------------------------------------------------------
# CBGS
# ---------------------------------------------------------------------------

def cbgs_config(precision=None, cut=False):
    """configs/nusc_cbgs_voxelnet.py as a dict; ``precision`` overrides the
    middle's serve_precision; ``cut``: the range, every anchor generator's
    range, the voxel cap cut for phase 17 (CBGS_CUT, CBGS_CUT_VOXELS)."""
    return sparse_config(CBGS_CFG, precision,
                         (CBGS_CUT, CBGS_CUT_VOXELS) if cut else None)


def cbgs_batch(batch, points, pc_range, seed=SEED):
    """Structured scans with nuScenes' 5 point features, the fifth (the
    sweep time) zero, as bench.py's cbgs_nusc_predict row feeds CBGS."""
    from det3d_tpu_torch.utils.synth import structured_batch
    d = structured_batch(batch, points, pc_range, seed=seed)
    d["points"] = np.concatenate(
        [d["points"], np.zeros_like(d["points"][..., :1])], -1)
    return d


@functools.lru_cache(maxsize=None)
def cbgs_state():
    """CBGS's weights (calibrated_state), calibrated on the card in fp32
    (TF32 off) on the first structured scan of CBGS_POINTS points: on the
    host CPU the middle at full size is slow. Every CBGS model
    of this script loads these weights, whatever its device, precision and
    range (the widths do not depend on the range)."""
    cfg = cbgs_config("fp32")
    scan = cbgs_batch(1, CBGS_POINTS, cfg["voxel_generator"]["range"])
    return calibrated_state(cfg, scan, "cuda")


def cbgs_stack(device, precision=None, cut=False):
    return load_stack(cbgs_config(precision, cut), cbgs_state(), device)


def phase_cbgs_plan(batch):
    """The host plan and voxels of CBGS_B scans of CBGS_POINTS points,
    native against numpy (host_build_vs_numpy), and the native build's
    time."""
    plan, plan_ms = host_build_vs_numpy(cbgs_config(), batch,
                                        "phase 14 CBGS")
    log(f"phase 14 CBGS host plan B={CBGS_B} P={CBGS_POINTS}: "
        f"{plan_ms:.1f} ms/scan on the host (native); voxels "
        f"per scan {plan['num_voxels'].tolist()}, stage rows "
        + ", ".join(f"{k} {tuple(v.shape)}" for k, v in plan.items()
                    if k.startswith("plan_")))
    return plan, plan_ms


def phase_cbgs_predict(dev, batch, plan):
    """CBGS predict at B=2 through build_stack + host_plan_fn +
    make_predict_step (sparse_predict); returns the stack, the launches,
    and what the step passes to the NMS kernel, which must be N = B x 6
    samples of K=1000 at CBGS_NMS_THR."""
    stack, launches = sparse_predict(
        dev, cbgs_stack(dev), batch, plan, (CBGS_B, CBGS_DETS, 9),
        CBGS_LAUNCHES, "phase 16 CBGS (bf16 middle)")
    nms_in = nms_fed(stack, (CBGS_B * 6, 1000, CBGS_NMS_THR), "phase 16 CBGS")
    return stack, launches, nms_in


def nms_fed(stack, expected, label):
    """What one step of ``stack`` passes to the NMS kernel (step_nms_inputs),
    which must be ``expected`` = (N, K, thr)."""
    step, data = stack[4], stack[5]
    nms_in = step_nms_inputs(lambda: step.eager(data))
    fed = (*nms_in[0].shape[:2], nms_in[3])
    log(f"{label} NMS kernel fed N={fed[0]} K={fed[1]} thr {fed[2]}")
    if fed != tuple(expected):
        raise AssertionError(f"NMS fed N, K, thr = {fed}, expected "
                             f"{expected}")
    return nms_in


def phase_cbgs_cpu(dev, stack):
    """Card against CPU on the range cut to +-CBGS_CUT m at full widths
    (card_vs_cpu), then the CPU post-processing of the full-size card
    heads (the bf16 middle as served, scan 0 of the B=2 step's batch)
    against the card's."""
    cut = cbgs_config(cut=True)["voxel_generator"]["range"]
    cpu_stack = cbgs_stack("cpu", "fp32", cut=True)
    card_vs_cpu(dev, cbgs_stack(dev, "fp32", cut=True), cpu_stack,
                cbgs_batch(1, CBGS_CUT_POINTS, cut),
                f"phase 17 CBGS at +-{CBGS_CUT} m, {CBGS_CUT_VOXELS} voxels,")
    full_size_decode(dev, stack, cpu_stack[0], "phase 17 CBGS",
                     "scan 0, bf16 middle")


def full_size_decode(dev, stack, cpu_model, label, what):
    """The CPU post-processing of the card's full-size heads on scan 0 of
    ``stack``'s batch against the card's (check_decode)."""
    from det3d_tpu_torch.parallel.predict import build_example
    model, vg, asg, test_cfg, _, data = stack
    data = {k: v[:1] for k, v in data.items()}
    with torch.no_grad():
        ex_d, heads_d = heads_on(model, vg, asg, data, dev)
        det_d = model.predict(ex_d, heads_d, test_cfg)
        ex_c = build_example({k: torch.as_tensor(v) for k, v in
                              data.items()}, vg, asg)
        det_c = cpu_model.predict(
            ex_c, [{k: v.cpu() for k, v in h.items()} for h in heads_d],
            test_cfg)
    log(f"{label} CPU post-processing of the full-size card heads ({what}):"
        f" {check_decode(det_d, det_c, label + ' full')}")


def step_nms_timing(nms_in, smi, label):
    """The NMS kernel on a step's own inputs against its plain twin, a call
    from Python each, in turns (the device time: phase 13)."""
    from det3d_tpu_torch.ops.nms_cuda import (rotated_nms_keep,
                                              rotated_nms_keep_ref)
    c, a, v, thr = nms_in
    nms = interleaved_ms({
        "plain": lambda: rotated_nms_keep_ref(c, a, v, thr),
        "kernel": lambda: rotated_nms_keep(c, a, v, thr)})
    log(f"{label} rotated NMS keep on the step's inputs N={c.shape[0]} "
        f"K={c.shape[1]} thr {thr}: kernel {nms['kernel']:.4f} ms a call "
        f"from Python interleaved with the plain twin (device time: phase "
        f"13), plain {nms['plain']:.4f} ms [{smi}]")
    return nms


def phase_cbgs_timing(dev, stack, plan_ms, nms_in, smi):
    """CBGS predict at B=2 and its stages (step_timing); the RPN's first
    conv as one cuDNN call and as the port runs it; the window conv at
    CBGS's shapes in bf16; the NMS kernel on the step's own inputs against
    its plain twin (a call)."""
    from det3d_tpu_torch.models.necks import CIN_CHUNK, stage_conv
    mid = step_timing(dev, stack, plan_ms, smi, "phase 18 CBGS")
    # the RPN's first conv, fp32 256 -> 128 channels on 128 x 128: one
    # cuDNN call against the 128-channel chunks the port runs
    conv0 = stack[0].neck.block0_down_conv
    with torch.no_grad():
        x0 = mid.float().permute(0, 3, 1, 2)
        diff = float((conv0(x0) - stage_conv(conv0, x0)).abs().max())
        rpn0 = interleaved_ms({"one cuDNN call": lambda: conv0(x0),
                               "chunks": lambda: stage_conv(conv0, x0)},
                              rounds=4)
    log(f"phase 18 CBGS RPN first conv {tuple(x0.shape)} -> "
        f"{conv0.out_channels} channels, fp32: one cuDNN call "
        f"{rpn0['one cuDNN call']:.3f} ms, over {CIN_CHUNK}-channel chunks "
        f"(models/necks.py::stage_conv, what the port runs) "
        f"{rpn0['chunks']:.3f} ms, max abs diff {diff:.3e} [{smi}]")

    host_plan = {k: v for k, v in stack[5].items() if k.startswith("plan_")}
    host_plan.update(tail_plan(stack[0], host_plan, dev))
    conv = conv_timing(dev, host_plan, smi, "bf16", CBGS_LAYERS, "phase 18")
    return conv, step_nms_timing(nms_in, smi, "phase 18 CBGS")


# ---------------------------------------------------------------------------
# PointPillars as shipped: KITTI car and nuScenes, bf16 reader and neck
# ---------------------------------------------------------------------------

def pp_config(path, cut=False, precision=None):
    """A PointPillars config as a dict; ``precision`` overrides the reader's
    and the neck's; ``cut``: the range (nuScenes: +-PP_CUT m; KITTI car,
    whose range starts at x = 0: x in [0, 2 PP_CUT], y in +-PP_CUT), the
    reader's, every anchor generator's and the post-center range, and the
    pillar cap cut for phase 23 (PP_CUT_VOXELS)."""
    from det3d_tpu_torch.utils.config import Config
    cfg = Config.fromfile(path)
    c = {k: copy.deepcopy(cfg[k]) for k in cfg.keys()}
    if precision is not None:
        c["model"]["reader"]["precision"] = precision
        c["model"]["neck"]["precision"] = precision
    if cut:
        rng = c["voxel_generator"]["range"]
        x0 = 0.0 if rng[0] == 0 else -PP_CUT
        pc = [x0, -PP_CUT, rng[2], x0 + 2 * PP_CUT, PP_CUT, rng[5]]
        c["voxel_generator"].update(range=pc, max_voxel_num=PP_CUT_VOXELS)
        c["model"]["reader"]["pc_range"] = pc
        for g in c["assigner"]["target_assigner"]["anchor_generators"]:
            z = g["anchor_ranges"][2]
            g["anchor_ranges"] = pc[:2] + [z] + pc[3:5] + [z]
        c["test_cfg"]["post_center_limit_range"] = [
            pc[0] - 5, pc[1] - 5, -10.0, pc[3] + 5, pc[4] + 5, 10.0]
    return c


def pp_scans(cfg, batch, points):
    """Structured scans over the config's range (seed SEED); nuScenes' with
    5 point features (cbgs_batch)."""
    from det3d_tpu_torch.utils.synth import structured_batch
    pc = cfg["voxel_generator"]["range"]
    if cfg["model"]["reader"].get("num_input_features", 4) == 5:
        return cbgs_batch(batch, points, pc)
    return structured_batch(batch, points, pc, seed=SEED)


@functools.lru_cache(maxsize=None)
def pp_state(path):
    """The weights of a PointPillars config (calibrated_state), calibrated
    on the card in its bf16 on the first scan of its bench batch. Every
    model of the config loads them, whatever its device and range."""
    cfg = pp_config(path)
    points = CBGS_POINTS if path == NUSC_PP_CFG else POINTS
    return calibrated_state(cfg, pp_scans(cfg, 1, points), "cuda")


def pp_stack(path, device, cut=False, precision=None):
    return load_stack(pp_config(path, cut, precision), pp_state(path),
                      device)


def pp_predict(dev, path, batch, vox, shape, fed, label, min_labels=1):
    """A PointPillars predict step through build_stack + make_predict_step
    (sparse_predict: no window-conv launch), from the host voxels ``vox``
    or, when it is empty, the device voxelizer. The NMS kernel must be
    launched once, fed ``fed`` = (N, K, thr), and the valid detections
    carry at least ``min_labels`` labels."""
    stack, launches = sparse_predict(dev, pp_stack(path, dev), batch, vox,
                                     shape, 0, label, min_labels)
    if launches["rotated_nms_keep"] != 1:
        raise AssertionError(f"{launches['rotated_nms_keep']} NMS launches, "
                             f"expected 1")
    return stack, launches, nms_fed(stack, fed, label)


def phase_nusc_pp_voxels(dev, batch):
    """nuScenes PointPillars' host voxels of the bench batch (appearance
    order), native against numpy (host_build_vs_numpy), the native
    build's time, the pillars before and after the cap, and the device
    voxelizer on the card against them, array for array."""
    from det3d_tpu_torch.apis.train import build_stack
    from det3d_tpu_torch.ops import sparse_host as sph
    vg = build_stack(pp_config(NUSC_PP_CFG), device="cpu")[1]
    vox, host_ms = host_build_vs_numpy(pp_config(NUSC_PP_CFG), batch,
                                       "phase 21 nuScenes PointPillars")
    occupied = []
    for pts, n in zip(batch["points"], batch["num_points"]):
        lin = sph.point_lin(pts, n, vg.voxel_size, vg.point_cloud_range,
                            vg.grid_size)
        occupied.append(len(np.unique(lin[lin != sph.SENTINEL])))
    log(f"phase 21 nuScenes PointPillars host voxels B={CBGS_B} "
        f"P={CBGS_POINTS} ({vg.order} order): {host_ms:.1f} ms/scan on the "
        f"host (native); pillars per scan {occupied} occupied, "
        f"{vox['num_voxels'].tolist()} kept under the cap of "
        f"{vg.max_voxels}; points per pillar capped at {vg.max_num_points} "
        f"in {int((vox['num_points_per_voxel'] == vg.max_num_points).sum())}"
        f" pillars")
    with torch.no_grad():
        out = vg.generate_batch(torch.as_tensor(batch["points"], device=dev),
                                torch.as_tensor(batch["num_points"],
                                                device=dev))
    torch.cuda.synchronize()
    for k, hk in (("voxels", "voxels"), ("coords", "coordinates"),
                  ("num_points_per_voxel", "num_points_per_voxel"),
                  ("num_voxels", "num_voxels")):
        if not np.array_equal(out[k].cpu().numpy(), vox[hk]):
            raise AssertionError(f"device voxelizer {k} differs from the "
                                 f"host's")
    log("phase 21 nuScenes PointPillars device voxelizer on the card "
        "(appearance order): voxels, coords, counts and num_voxels equal "
        "the host's")
    return vox, host_ms


def rel_l2(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).norm() / b.norm())


def pp_card_vs_cpu(dev, path, label):
    """Card against CPU at B=1 on one config's cut range (pp_config), full
    widths, the same host voxels and weights on both sides:

    - bf16 rounds at the same places: the reader, and each conv of the RPN
      and head on the CPU's own bf16 inputs, within PP_LAYER_REL relative
      L2 of the CPU's;
    - the same function: with the reader and neck in fp32 on both sides,
      every head within HEAD_TOL;
    - the bf16 heads closer to the CPU's bf16 heads than those are to the
      CPU's fp32 heads (their relative L2 printed: a rounding that one
      side flips moves every later layer, so the whole model cannot be
      held to one layer's limit);
    - the CPU post-processing of the card's bf16 heads gives the card's
      detections (check_decode)."""
    one = pp_scans(pp_config(path, cut=True), 1, PP_CUT_POINTS)
    card, vg, asg, _, test_cfg, vox_fn = pp_stack(path, dev, cut=True)
    cpu = pp_stack(path, "cpu", cut=True)[0]
    data = dict(one, **vox_fn(one["points"], one["num_points"]))
    with torch.no_grad():
        ex_d, heads_d = heads_on(card, vg, asg, data, dev)
        ex_c, heads_c = heads_on(cpu, vg, asg, data, "cpu")
        args = [ex_c[k] for k in ("voxels", "num_points_per_voxel",
                                  "coordinates")]
        feats = cpu.reader(*args)
        layer = {"reader": rel_l2(card.reader(*[a.to(dev) for a in args]),
                                  feats)}
        canvas = cpu.backbone(feats, args[2], cpu.grid_size)
        for i, (fn, x, w, a, kw) in enumerate(conv_calls(
                lambda: cpu.bbox_head(cpu.neck(canvas)))):
            a_d = [t.to(dev) if torch.is_tensor(t) else t for t in a]
            layer[f"conv {i} {tuple(w.shape)}"] = rel_l2(
                fn(x.to(dev), w.to(dev), *a_d, **kw), fn(x, w, *a, **kw))
        worst = max(layer, key=layer.get)
        log(f"{label} card vs CPU, each layer on the CPU's bf16 inputs: "
            f"{len(layer)} layers, the largest relative L2 {layer[worst]:.3e}"
            f" ({worst}; limit {PP_LAYER_REL})")
        if layer[worst] >= PP_LAYER_REL:
            raise AssertionError(f"{label} {worst}: card vs CPU relative L2 "
                                 f"{layer[worst]}")
        fp32_d = heads_on(pp_stack(path, dev, True, "fp32")[0], vg, asg,
                          data, dev)[1]
        fp32_c = heads_on(pp_stack(path, "cpu", True, "fp32")[0], vg, asg,
                          data, "cpu")[1]
    err32, bf16, scale = 0.0, 0.0, float("inf")
    for hd, hc, fd, fc in zip(heads_d, heads_c, fp32_d, fp32_c):
        for k in hc:
            err32 = max(err32, float((fd[k].cpu() - fc[k]).abs().max()))
            if not torch.allclose(fd[k].cpu(), fc[k], **HEAD_TOL):
                raise AssertionError(f"{label} fp32 head {k}: card vs CPU "
                                     f"max err {err32}")
            bf16 = max(bf16, rel_l2(hd[k], hc[k]))
            scale = min(scale, rel_l2(hc[k], fc[k]))
    log(f"{label} card vs CPU B=1 ({int(data['num_voxels'][0])} pillars): "
        f"the fp32 trunk's heads max abs err {err32:.3e} (tolerance "
        f"rtol={HEAD_TOL['rtol']} atol={HEAD_TOL['atol']}); the bf16 heads "
        f"relative L2 {bf16:.3e}, below the CPU's bf16 heads' smallest "
        f"distance from its fp32 heads, {scale:.3e}")
    if bf16 >= scale:
        raise AssertionError(f"{label} bf16 heads: card vs CPU {bf16}, "
                             f"CPU bf16 vs fp32 {scale}")
    with torch.no_grad():
        det_d = card.predict(ex_d, heads_d, test_cfg)
        det_c = cpu.predict(ex_c, [{k: v.cpu() for k, v in h.items()}
                                   for h in heads_d], test_cfg)
    log(f"{label} CPU post-processing of the card's bf16 heads: "
        f"{check_decode(det_d, det_c, label)}")


def phase_pp_cpu(dev):
    """Phase 23: pp_card_vs_cpu for both configs."""
    for path, name in ((KITTI_PP_CFG, "KITTI car"), (NUSC_PP_CFG,
                                                     "nuScenes")):
        rng = pp_config(path, cut=True)["voxel_generator"]["range"]
        pp_card_vs_cpu(dev, path, f"phase 23 {name} PointPillars over x "
                       f"{rng[0]:g}..{rng[3]:g}, y {rng[1]:g}..{rng[4]:g} m,")


def conv_calls(run):
    """The convolutions one ``run()`` issues: [(fn, x, weight, args,
    kwargs)], caught at torch.nn.functional (the RPN's and the heads' 2-D
    convs; a conv3d, which no middle of the port runs)."""
    F = torch.nn.functional
    seen, real = [], {n: getattr(F, n) for n in ("conv2d",
                                                 "conv_transpose2d",
                                                 "conv3d")}

    def spy(name):
        def fn(x, w, *args, **kw):
            seen.append((real[name], x, w, args, kw))
            return real[name](x, w, *args, **kw)
        return fn
    try:
        for name in real:
            setattr(F, name, spy(name))
        run()
    finally:
        for name, fn in real.items():
            setattr(F, name, fn)
    return seen


def conv_table(run, smi, label, what="convs of the RPN and head"):
    """Each distinct conv shape of ``run()`` timed alone (cuda_ms), its
    count, achieved TFLOP/s and share of the dtype's peak; the sum."""
    def plain(v):
        return tuple(v.shape) if torch.is_tensor(v) else v

    shapes = {}
    with torch.no_grad():
        calls = conv_calls(run)
    for fn, x, w, args, kw in calls:
        key = (fn.__name__, tuple(x.shape), tuple(w.shape), str(x.dtype),
               tuple(map(plain, args)), tuple(sorted(kw.items())))
        shapes.setdefault(key, [fn, x, w, args, kw, 0])[5] += 1
    total = 0.0
    for (name, xs, ws, dt, _, _), (fn, x, w, args, kw, n) in shapes.items():
        with torch.no_grad():
            y = fn(x, w, *args, **kw)
            ms = cuda_ms(lambda: fn(x, w, *args, **kw))
        macs = (x.numel() * w.shape[1] * w[0, 0].numel()
                if name == "conv_transpose2d"
                else y.numel() * w.shape[1] * w[0, 0].numel())
        peak = BF16_FLOPS if x.dtype == torch.bfloat16 else FP32_FLOPS
        total += n * ms
        log(f"{label} conv {name} {dt.split('.')[-1]} x{n}: in {xs} weight "
            f"{ws} out {tuple(y.shape)}: {ms:.4f} ms, "
            f"{2 * macs / ms / 1e9:.2f} TFLOP/s, "
            f"{2 * macs / ms / 1e9 / (peak / 1e12):.4f} of peak [{smi}]")
    log(f"{label} {what}: {total:.3f} ms summed over "
        f"{sum(v[5] for v in shapes.values())} calls")


def pp_timing(dev, stack, host_ms, nms_in, smi, label):
    """A PointPillars predict step's time (CUDA events, WARMUP warm-ups,
    median of REPEAT), scans/s, peak memory; its stages (the device
    voxelizer, reader + scatter, RPN + head, decode + NMS); with host
    voxels (``host_ms``) the host voxelization apart and the
    device-voxelized route of the same step; each conv shape of the RPN
    and head; the NMS kernel on the step's own inputs against its plain
    twin (a call). Returns the NMS times."""
    from det3d_tpu_torch.parallel.predict import build_example
    model, vg, asg, test_cfg, step, data = stack
    data_d = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
    pts = {k: data_d[k] for k in ("points", "num_points")}
    b = pts["points"].shape[0]
    torch.cuda.reset_peak_memory_stats()
    predict_ms = cuda_ms(lambda: step.eager(data_d))
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    host = (f"; host voxelization {host_ms:.1f} ms/scan apart"
            if host_ms else " (the device voxelizer inside)")
    log(f"{label} predict B={b}: {predict_ms:.3f} ms/batch, "
        f"{predict_ms / b:.3f} ms/scan, {b * 1e3 / predict_ms:.1f} scans/s, "
        f"peak memory {peak:.0f} MiB{host} [{smi}]")
    if host_ms:
        dev_ms = cuda_ms(lambda: step.eager(pts))
        log(f"{label} predict B={b}, the device-voxelized route of the same "
            f"step: {dev_ms:.3f} ms/batch, {dev_ms / b:.3f} ms/scan")
    with torch.no_grad():
        ex = build_example(data_d, vg, asg)
        args = (ex["voxels"], ex["num_points_per_voxel"], ex["coordinates"])
        canvas = model.backbone(model.reader(*args), ex["coordinates"],
                                model.grid_size)
        heads = model.bbox_head(model.neck(canvas))
        stages = {
            "voxelize (device)": lambda: vg.generate_batch(
                pts["points"], pts["num_points"]),
            "reader+scatter": lambda: model.backbone(
                model.reader(*args), ex["coordinates"], model.grid_size),
            "rpn+head": lambda: model.bbox_head(model.neck(canvas)),
            "decode+nms": lambda: model.predict(ex, heads, test_cfg),
        }
        parts = {k: cuda_ms(fn) for k, fn in stages.items()}
    log(f"{label} stages B={b} (ms/batch): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))
    conv_table(lambda: model.bbox_head(model.neck(canvas)), smi, label)
    return step_nms_timing(nms_in, smi, label)


# ---------------------------------------------------------------------------
# Lyft CBGS and KITTI 3-class SECOND: fp32 middles
# ---------------------------------------------------------------------------

class Fp32Path:
    """One of the two configs whose middle serves in fp32, as chip_smoke
    drives it: its bench batch (``b`` scans of ``points`` points over the
    config's range, ``five`` features), the window convs of its middle
    (``layers``), the detections a step gives (``dets`` a scan), what the
    step feeds the NMS kernel (``nms``: N, K, thr), the card-vs-CPU cut
    (``cut``: extent, voxels, points; None: the full range at B=1), and
    the numbers of its phases (plan, kernels, predict, card vs CPU,
    timing, profile, captured step)."""

    def __init__(self, key, name, cfg, points, five, layers, dets, nms, cut,
                 phases, b=2):
        self.key, self.name, self.cfg = key, name, cfg
        self.points, self.five, self.layers = points, five, layers
        self.dets, self.nms, self.cut, self.phases, self.b = (
            dets, nms, cut, phases, b)

    def label(self, i):
        return f"phase {self.phases[i]} {self.name}"

    def config(self, cut=False):
        return sparse_config(self.cfg, cut=self.cut[:2] if cut else None)

    def scans(self, batch, points, cut=False):
        """Structured scans over the (cut) range (seed SEED), with the
        config's point features (cbgs_batch's fifth, zero)."""
        from det3d_tpu_torch.utils.synth import structured_batch
        pc = self.config(cut)["voxel_generator"]["range"]
        if self.five:
            return cbgs_batch(batch, points, pc)
        return structured_batch(batch, points, pc, seed=SEED)


LYFT = Fp32Path("lyft", "Lyft CBGS", LYFT_CFG, 300000, True, CBGS_LAYERS,
                5 * 83, (2 * 5, 1000, 0.2), (12.8, 8000, 40000),
                (26, 27, 28, 29, 30, 36, 44))
KITTI_ALL = Fp32Path("kitti_all", "KITTI-all SECOND", KITTI_ALL_CFG, POINTS,
                     False, SECOND_LAYERS, 100, (2 * 3, 1000, 0.01), None,
                     (31, 32, 33, 34, 35, 37, 45))
FP32_PATHS = {p.key: p for p in (LYFT, KITTI_ALL)}
# the predict steps as chip_smoke captures them (phases 39-45 from host
# data, 48-50 from points alone), in the order of their profiles (phase 46)
CAPTURED_PATHS = (("flagship", "flagship"), ("second", "SECOND"),
                  ("cbgs", "CBGS"), ("kitti_pp", "KITTI car PointPillars"),
                  ("nusc_pp", "nuScenes PointPillars"),
                  ("lyft", "Lyft CBGS"), ("kitti_all", "KITTI-all SECOND"),
                  ("second_points", "SECOND from points"),
                  ("cbgs_points", "CBGS from points"),
                  ("cbgs_tta", "CBGS double-flip TTA"),
                  ("nusc_pp_tta", "nuScenes PointPillars double-flip TTA"))


@functools.lru_cache(maxsize=None)
def fp32_state(path):
    """The weights of ``path``'s config (calibrated_state), calibrated on
    the card in fp32 (TF32 off) on the first scan of its bench batch. Every
    model of the config loads them, whatever its device and range."""
    return calibrated_state(path.config(), path.scans(1, path.points),
                            "cuda")


def fp32_stack(path, device, cut=False):
    return load_stack(path.config(cut), fp32_state(path), device)


def phase_fp32_plan(path, batch):
    """The host plan and voxels of the bench batch, native against numpy
    (host_build_vs_numpy), the native build's time, and the voxels each
    scan occupies before the cap."""
    from det3d_tpu_torch.apis.train import build_stack
    from det3d_tpu_torch.ops import sparse_host as sph
    vg = build_stack(path.config(), device="cpu")[1]
    plan, plan_ms = host_build_vs_numpy(path.config(), batch, path.label(0))
    occupied = []
    for pts, n in zip(batch["points"], batch["num_points"]):
        lin = sph.point_lin(pts, n, vg.voxel_size, vg.point_cloud_range,
                            vg.grid_size)
        occupied.append(len(np.unique(lin[lin != sph.SENTINEL])))
    log(f"{path.label(0)} host plan B={path.b} P={path.points}: "
        f"{plan_ms:.1f} ms/scan on the host (native); voxels "
        f"per scan {occupied} occupied, {plan['num_voxels'].tolist()} kept "
        f"under the cap of {vg.max_voxels}; stage rows "
        + ", ".join(f"{k} {tuple(v.shape)}" for k, v in plan.items()
                    if k.startswith("plan_")))
    return plan, plan_ms


def dense_scatter_check(run, label):
    """The middle's one scatter to a dense canvas on the card, the dense
    tail's last rows to the BEV map, caught at ops/sparse.py::to_dense
    during ``run()``: gathered back at its coords, the canvas gives the
    rows exactly, and it holds no other nonzero (so no linear index
    wrapped on the way)."""
    from det3d_tpu_torch.ops import sparse as sp
    seen, real = [], sp.to_dense

    def spy(features, coords, shape):
        out = real(features, coords, shape)
        seen.append((features, coords, out))
        return out
    sp.to_dense = spy
    try:
        run()
    finally:
        sp.to_dense = real
    (features, coords, dense), = seen
    keep = (coords >= 0).all(dim=-1)
    bi = torch.arange(coords.shape[0], device=coords.device)[:, None]
    bi = bi.expand(coords.shape[:2])[keep]
    z, y, x = coords[keep].long().unbind(-1)
    back = dense[bi, z, y, x]
    nonzero = int((dense != 0).sum())
    log(f"{label} BEV canvas {tuple(dense.shape)} "
        f"{str(dense.dtype).split('.')[-1]} ({dense.numel()} elements): "
        f"{int(keep.sum())} rows scattered and gathered back exactly, "
        f"{nonzero} nonzero elements, the rows' own")
    if not torch.equal(back, features[keep].to(dense.dtype)):
        raise AssertionError(f"{label} dense scatter: rows differ")
    if nonzero != int((features[keep] != 0).sum()):
        raise AssertionError(f"{label} dense scatter: stray nonzeros")


def phase_fp32_predict(dev, path, batch, plan):
    """The predict step at B=2 through build_stack + host_plan_fn +
    make_predict_step (sparse_predict): the window conv launched once per
    layer of ``path.layers``, the NMS kernel once, fed ``path.nms``; and
    the scatter to the BEV map checked on the card
    (dense_scatter_check)."""
    label = path.label(2)
    stack, launches = sparse_predict(
        dev, fp32_stack(path, dev), batch, plan,
        (path.b, path.dets, 9 if path.five else 7), len(path.layers),
        f"{label} (fp32 middle)", min_labels=2)
    if launches["rotated_nms_keep"] != 1:
        raise AssertionError(f"{launches['rotated_nms_keep']} NMS launches, "
                             f"expected 1")
    nms_in = nms_fed(stack, path.nms, label)
    model, vg, asg, _, _, data = stack
    with torch.no_grad():
        dense_scatter_check(lambda: heads_on(model, vg, asg, data, dev),
                            label)
    return stack, launches, nms_in


def phase_fp32_cpu(dev, path, stack):
    """Card against CPU (card_vs_cpu): Lyft on the range cut to +-12.8 m,
    KITTI-all at B=1 over the full range; then Lyft's CPU post-processing
    of the full-size card heads (scan 0 of the B=2 step's batch) against
    the card's."""
    label = path.label(3)
    if path.cut is None:
        card_vs_cpu(dev, fp32_stack(path, dev), fp32_stack(path, "cpu"),
                    {k: stack[5][k][:1] for k in ("points", "num_points")},
                    label)
        return
    extent, voxels, points = path.cut
    cpu_stack = fp32_stack(path, "cpu", cut=True)
    card_vs_cpu(dev, fp32_stack(path, dev, cut=True), cpu_stack,
                path.scans(1, points, cut=True),
                f"{label} at +-{extent} m, {voxels} voxels,")
    full_size_decode(dev, stack, cpu_stack[0], label, "scan 0")


def middle_split_ms(model, run):
    """(sparse, dense) ms of the middle's ``run()``: CUDA events at its
    start, where its dense tail starts (models/backbones.py::_RowsTail, its
    rulebooks first), and at its end; medians of REPEAT runs after
    WARMUP."""
    from det3d_tpu_torch.models import backbones
    marks = []
    real = backbones._RowsTail

    class Marked(real):
        def __init__(self, *args):
            if len(marks) == 1:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            super().__init__(*args)
    backbones._RowsTail = Marked
    sparse, dense = [], []
    try:
        for i in range(WARMUP + REPEAT):
            marks[:] = [torch.cuda.Event(enable_timing=True)]
            marks[0].record()
            run()
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            if i >= WARMUP:
                sparse.append(marks[0].elapsed_time(marks[1]))
                dense.append(marks[1].elapsed_time(end))
    finally:
        backbones._RowsTail = real
    return statistics.median(sparse), statistics.median(dense)


def cin_chunked_conv2d(x, w, c, **kw):
    """conv2d as the sum of the convs of ``c``-channel input slices."""
    return sum(torch.nn.functional.conv2d(x[:, i:i + c], w[:, i:i + c], **kw)
               for i in range(0, x.shape[1], c))


def per_map_conv2d(x, w, **kw):
    """conv2d one map of the batch at a time."""
    return torch.cat([torch.nn.functional.conv2d(x[i:i + 1], w, **kw)
                      for i in range(x.shape[0])])


def stage_conv_routes(neck, mid):
    """{RPN stage conv: {route: fn}} for each distinct stage conv of the RPN
    on ``mid`` (caught at models/necks.py::stage_conv): one cuDNN call;
    over CIN_CHUNK-channel input slices, summed, where it has more input
    channels; one map at a time, where it has more than one; and
    stage_conv, what the port runs."""
    from det3d_tpu_torch.models import necks
    F = torch.nn.functional
    seen, real = {}, necks.stage_conv

    def spy(conv, x):
        key = (f"RPN conv in {tuple(x.shape)} weight "
               f"{tuple(conv.weight.shape)} stride {tuple(conv.stride)}")
        seen.setdefault(key, (conv, x))
        return real(conv, x)
    necks.stage_conv = spy
    try:
        with torch.no_grad():
            neck(mid)
    finally:
        necks.stage_conv = real
    out = {}
    for key, (conv, x) in seen.items():
        w = conv.weight.to(x.dtype)
        kw = dict(stride=conv.stride, padding=conv.padding)
        c = necks.CIN_CHUNK
        routes = {"one cuDNN call": functools.partial(F.conv2d, x, w, **kw)}
        if x.shape[1] > c:
            routes[f"{c}-channel chunks"] = functools.partial(
                cin_chunked_conv2d, x, w, c, **kw)
        if x.shape[0] > 1:
            routes["one map at a time"] = functools.partial(
                per_map_conv2d, x, w, **kw)
        routes["the port (stage_conv)"] = functools.partial(real, conv, x)
        out[key] = routes
    return out


def route_table(cases, smi, label):
    """Each conv of ``cases`` ({conv: {route: fn}}) timed in turns by each
    route, with its TFLOP/s and its largest difference from the first."""
    for key, routes in cases.items():
        with torch.no_grad():
            ref = next(iter(routes.values()))()
            diff = {k: float((fn() - ref).abs().max())
                    for k, fn in routes.items()}
            t = interleaved_ms(routes, rounds=4)
        x, w = next(iter(routes.values())).args[:2]
        flops = 2 * ref.numel() * w[0].numel()
        log(f"{label} {key}, {str(x.dtype).split('.')[-1]}: " + ", ".join(
            f"{k} {t[k]:.3f} ms ({flops / t[k] / 1e9:.2f} TFLOP/s, max abs "
            f"diff {diff[k]:.2e})" for k in routes) + f" [{smi}]")


def phase_fp32_timing(dev, path, stack, plan_ms, nms_in, smi):
    """The predict step at B=2 and its stages (step_timing), the middle
    split into its sparse part and its dense tail (middle_split_ms); each
    2-D conv of the RPN and head alone (conv_table), each RPN stage conv
    by each route (route_table); the fp32 window conv at each of the
    middle's shapes and the forward's launches, with its device time
    (conv_timing); the
    NMS kernel on the step's own inputs against its plain twin (a call)."""
    from det3d_tpu_torch.parallel.predict import build_example
    label = path.label(4)
    mid = step_timing(dev, stack, plan_ms, smi, label)
    model, vg, asg, _, _, data = stack
    data_d = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
    plan = {k[5:]: v for k, v in data_d.items() if k.startswith("plan_")}
    with torch.no_grad():
        ex = build_example(data_d, vg, asg)
        feats = model.reader(ex["voxels"], ex["num_points_per_voxel"])

        def middle():
            return model.backbone(feats, ex["coordinates"], model.grid_size,
                                  plan=plan)
        sparse_ms, dense_ms = middle_split_ms(model, middle)
        log(f"{label} middle B={path.b} (ms/batch): sparse part (window "
            f"convs, BN, up to the transition) {sparse_ms:.3f}, dense "
            f"tail (its rulebooks and window convs) {dense_ms:.3f} [{smi}]")
        conv_table(lambda: model.bbox_head(model.neck(mid)), smi, label)
        route_table(stage_conv_routes(model.neck, mid), smi, label)
    host_plan = {k: v for k, v in data.items() if k.startswith("plan_")}
    host_plan.update(tail_plan(model, host_plan, dev))
    conv = conv_timing(dev, host_plan, smi, "fp32", path.layers, label)
    return conv, step_nms_timing(nms_in, smi, label)


def run_fp32_path(dev, path, smi):
    """Phases plan, kernels, predict, card vs CPU, timing and the captured
    step of one fp32 path. Returns what main() reports: (stack, launches,
    NMS inputs, the window conv's worst error, its timing, the NMS timing,
    the captured step's phase_captured result, the host build's
    ms/scan)."""
    batch = path.scans(path.b, path.points)
    plan, plan_ms = phase_fp32_plan(path, batch)
    conv_err = phase_conv_kernel(
        dev, dict(plan, **tail_plan(detector_of(path.config()), plan, dev)),
        path.layers, path.label(1), precisions=("fp32",), every_layer=True)
    stack, launches, nms_in = phase_fp32_predict(dev, path, batch, plan)
    phase_fp32_cpu(dev, path, stack)
    conv, nms = phase_fp32_timing(dev, path, stack, plan_ms, nms_in, smi)
    cap = phase_captured(dev, stack[4], stack[5], launches, smi,
                         path.label(6))
    return stack, launches, nms_in, conv_err, conv, nms, cap, plan_ms


# ---------------------------------------------------------------------------
# Points alone: device voxels and plans (47), the sparse steps from points
# (48), double-flip TTA (49, 50)
# ---------------------------------------------------------------------------

MEAN_TOL = dict(rtol=1e-5, atol=1e-5)   # fused means, card vs host


def tta_config(cfg):
    """``cfg`` with double-flip TTA switched on."""
    return dict(cfg, test_cfg=dict(cfg["test_cfg"], double_flip=True))


def device_build(model, vg):
    """fn(points, num_points) -> (voxels, plan): the device voxelizer and
    models/backbones.py::build_plan_device, as a sparse middle runs them
    without a host plan."""
    from det3d_tpu_torch.models.backbones import (build_plan_device,
                                                  middle_plan_spec)
    spec = middle_plan_spec(model.backbone, vg.grid_size, vg.max_voxels)

    def fn(points, num_points):
        vox = vg.generate_batch(points, num_points)
        return vox, build_plan_device(vox["coords"], spec)
    return fn, spec


def check_voxels(vox, host, label):
    """Device voxels against host ones: coords, counts and num_voxels
    equal, (fused-mean) voxels within MEAN_TOL. Returns the voxels' max
    abs difference."""
    for k, hk in (("coords", "coordinates"),
                  ("num_points_per_voxel", "num_points_per_voxel"),
                  ("num_voxels", "num_voxels")):
        if not np.array_equal(vox[k].cpu().numpy(), np.asarray(host[hk])):
            raise AssertionError(f"{label}: device {k} differs from the "
                                 f"host's")
    got = vox["voxels"].cpu()
    ref = torch.as_tensor(np.asarray(host["voxels"]))
    if not torch.allclose(got, ref, **MEAN_TOL):
        raise AssertionError(f"{label}: device voxels differ from the "
                             f"host's by {float((got - ref).abs().max())}")
    return float((got - ref).abs().max())


def build_times(vg, fn, spec, pts, n):
    """The device voxels and plan of (pts, n) timed: voxelizer, plan and
    both launched from Python (cuda_ms), both on the device (graph_ms,
    one CUDA graph). ms a batch."""
    from det3d_tpu_torch.models.backbones import build_plan_device
    coords = vg.generate_batch(pts, n)["coords"]
    return {"voxelize": cuda_ms(lambda: vg.generate_batch(pts, n)),
            "plan": cuda_ms(lambda: build_plan_device(coords, spec)),
            "both": cuda_ms(lambda: fn(pts, n)),
            "device": graph_ms(lambda: fn(pts, n), reps=1)}


def phase_device_plans(dev, paths, smi):
    """Phase 47: on each sparse path's bench batch (``paths``: key -> (label,
    config, the batch with its host voxels and plan, the native host
    build's ms/scan)), the device voxelizer and build_plan_device on the
    card: coords, counts and num_voxels equal to host_plan_fn's, the fused
    means within MEAN_TOL, every plan key equal (int32, shape, values).
    Then their time a batch by CUDA events (cuda_ms: launched from Python,
    as the eager step runs them) and on the device (graph_ms: as the
    captured step replays them), voxelizer and plan apart, beside the host
    build. Returns {key: {"voxelize", "plan", "both", "device"} ms}."""
    from det3d_tpu_torch.apis.train import build_stack
    out = {}
    for key, (label, cfg, data, host_ms) in paths.items():
        model, vg = build_stack(cfg, device="cpu")[:2]
        fn, spec = device_build(model, vg)
        pts = torch.as_tensor(data["points"], device=dev)
        n = torch.as_tensor(data["num_points"], device=dev)
        vox, plan = fn(pts, n)
        torch.cuda.synchronize()
        err = check_voxels(vox, data, label)
        want = sorted(k[5:] for k in data if k.startswith("plan_"))
        if sorted(plan) != want:
            raise AssertionError(f"{label}: device plan keys {sorted(plan)}"
                                 f", host {want}")
        for k, v in plan.items():
            if (v.dtype != torch.int32 or not np.array_equal(
                    v.cpu().numpy(), data[f"plan_{k}"])):
                raise AssertionError(f"{label}: device plan {k} differs "
                                     f"from the host's")
        t = build_times(vg, fn, spec, pts, n)
        b = pts.shape[0]
        log(f"{label} device voxels and plan B={b} P={pts.shape[1]}: "
            f"coords, counts and num_voxels equal to the host's, voxels "
            f"within {err:.2e} (tolerance {MEAN_TOL}), all {len(plan)} plan "
            f"keys equal; {t['both']:.3f} ms/batch launched from Python "
            f"(voxelize {t['voxelize']:.3f}, plan {t['plan']:.3f}), "
            f"{t['device']:.3f} ms/batch on the device (one CUDA graph), "
            f"{t['device'] / b:.3f} ms/scan, against the native host build's "
            f"{host_ms:.1f} ms/scan on one thread of the host's "
            f"{cpu_model()} ({host_ms * b / t['device']:.1f}x) [{smi}]")
        out[key] = t
    return out


def card_vs_cpu_points(dev, card_stack, cpu_stack, one, label, tta=False):
    """Card against CPU on the scan ``one`` (B=1) from points alone, with
    ``tta`` its four flips: the device voxels equal (means within
    MEAN_TOL), for a sparse middle the device plans equal, every task's
    head outputs within SECOND_HEAD_TOL, class logits not degenerate, and
    the CPU post-processing (``predict``, or with ``tta`` ``predict_tta``)
    of the card's heads gives the card's detections (check_decode)."""
    from det3d_tpu_torch.models.backbones import (build_plan_device,
                                                  middle_plan_spec)
    from det3d_tpu_torch.parallel.predict import double_flip_batch
    card, vg, asg, _, test_cfg, _ = card_stack
    cpu = cpu_stack[0]
    data = {k: torch.as_tensor(v) for k, v in one.items()}
    if tta:
        data = double_flip_batch(data)
    with torch.no_grad():
        ex_d, heads_d = heads_on(card, vg, asg, data, dev)
        ex_c, heads_c = heads_on(cpu, vg, asg, data, "cpu")
        check_voxels(dict(ex_d, coords=ex_d["coordinates"]),
                     {k: v.numpy() for k, v in ex_c.items()
                      if k != "anchors"}, label)
        planned = ""
        if "SpMiddle" in type(card.backbone).__name__:
            spec = middle_plan_spec(card.backbone, vg.grid_size,
                                    vg.max_voxels, host=False)
            plan_d = build_plan_device(ex_d["coordinates"], spec)
            plan_c = build_plan_device(ex_c["coordinates"], spec)
            for k in plan_c:
                # a deep grid's flat rulebooks are (idx, mask) pairs
                pairs = (zip(plan_d[k], plan_c[k])
                         if isinstance(plan_c[k], tuple)
                         else [(plan_d[k], plan_c[k])])
                if not all(torch.equal(a.cpu(), c) for a, c in pairs):
                    raise AssertionError(f"{label}: device plan {k}, card "
                                         f"vs CPU, differs")
            planned = f", the {len(plan_c)} device plan keys equal"
        worst = 0.0
        for t, (hd, hc) in enumerate(zip(heads_d, heads_c)):
            for k in hc:
                err = float((hd[k].cpu() - hc[k]).abs().max())
                worst = max(worst, err)
                if not torch.allclose(hd[k].cpu(), hc[k], **SECOND_HEAD_TOL):
                    raise AssertionError(f"{label} task {t} head {k}: card "
                                         f"vs CPU max err {err}")
        spread = min(float(h["cls_preds"].std()) for h in heads_c)
        if spread < 0.1:
            raise AssertionError(f"degenerate head outputs (class logits std "
                                 f"{spread})")
        predict = "predict_tta" if tta else "predict"
        det_d = getattr(card, predict)(ex_d, heads_d, test_cfg)
        det_c = getattr(cpu, predict)(
            ex_c, [{k: v.cpu() for k, v in h.items()} for h in heads_d],
            test_cfg)
    log(f"{label} card vs CPU B=1{' (4 flips)' if tta else ''} from points "
        f"alone: device voxels equal ({int(ex_c['num_voxels'][0])} "
        f"voxels){planned}; {len(heads_c)} task(s)' head outputs max abs "
        f"err {worst:.3e} (tolerance rtol={SECOND_HEAD_TOL['rtol']} "
        f"atol={SECOND_HEAD_TOL['atol']}), class logits std >= "
        f"{spread:.3f}; the CPU's {predict} of the card's heads: "
        f"{check_decode(det_d, det_c, label)}")


def points_step(dev, stack, batch, shape, launches_expected, nms_expected,
                label, smi, min_labels=1):
    """A predict step fed points alone (no host voxels, no plan): the eager
    step's checks of sparse_predict, exactly one NMS launch fed
    ``nms_expected`` = (N, K, thr), then phase_captured. Returns (stack,
    launches, NMS inputs, phase_captured's result)."""
    data = {k: batch[k] for k in ("points", "num_points")}
    st, launches = sparse_predict(dev, stack, data, {}, shape,
                                  launches_expected, label, min_labels)
    if launches["rotated_nms_keep"] != 1:
        raise AssertionError(f"{label}: {launches['rotated_nms_keep']} NMS "
                             f"launches, expected 1")
    nms_in = nms_fed(st, nms_expected, label)
    cap = phase_captured(dev, st[4], st[5], launches, smi, label)
    return st, launches, nms_in, cap


def device_plan_kernels(dev, stack, layers, label, smi):
    """The fp32 window conv on the plan the card builds from the step's own
    voxels (4B scans under TTA): against the plain version at every layer
    (phase_conv_kernel), then timed (conv_timing). Returns (worst error,
    conv_timing's forward)."""
    from det3d_tpu_torch.parallel.predict import double_flip_batch
    model, vg, _, test_cfg, _, data = stack
    d = {k: torch.as_tensor(data[k], device=dev)
         for k in ("points", "num_points")}
    if test_cfg.get("double_flip"):
        d = double_flip_batch(d)
    fn, _ = device_build(model, vg)
    with torch.no_grad():
        plan = {f"plan_{k}": v for k, v in fn(d["points"],
                                              d["num_points"])[1].items()}
    plan.update(tail_plan(model, plan, dev))
    err = phase_conv_kernel(dev, plan, layers, label, precisions=("fp32",),
                            every_layer=True)
    return err, conv_timing(dev, plan, smi, "fp32", layers, label)


def phase_points_and_tta(dev, sec_batch, cbgs_data, smi):
    """Phases 48-50: SECOND and CBGS from points alone (48), CBGS (49) and
    nuScenes PointPillars (50) under double-flip TTA, each at B=2 at full
    widths through build_stack and make_predict_step: the eager step's
    checks and the captured step (points_step), card vs CPU at B=1
    (card_vs_cpu_points: SECOND over its full range as phase 10, CBGS and
    nuScenes PointPillars on the cut ranges of phases 17 and 23, the
    PointPillars reader and neck in fp32 on both sides), under TTA the
    CPU's predict_tta of the card's full-size heads (full_size_tta); the
    fp32 window conv on each sparse step's device plan
    (device_plan_kernels), and the NMS kernel on each step's inputs.
    Returns {key: (stack, launches, NMS inputs, captured, conv (err,
    timing) or None, NMS timing)}."""
    cut = cbgs_config(cut=True)["voxel_generator"]["range"]
    cbgs_one = cbgs_batch(1, CBGS_CUT_POINTS, cut)
    pp_cut = tta_config(pp_config(NUSC_PP_CFG, cut=True, precision="fp32"))
    cbgs_cut = tta_config(cbgs_config(cut=True))
    second = (SECOND_B, 100, 7), (SECOND_B, 1000, SECOND_NMS_THR)
    nusc = (CBGS_B, CBGS_DETS, 9), (CBGS_B * 6, 1000, CBGS_NMS_THR)
    # (key, label, the step's stack, its batch, its outputs and NMS inputs,
    # window-conv launches and layers, the card's and the CPU's B=1
    # stacks and scan, TTA)
    paths = (
        ("second_points", "phase 48 SECOND from points (fp32 middle)",
         second_stack(dev), sec_batch, second, SECOND_LAUNCHES,
         SECOND_LAYERS, second_stack(dev), second_stack("cpu"),
         {k: v[:1] for k, v in sec_batch.items()}, False),
        ("cbgs_points", "phase 48 CBGS from points (fp32 middle)",
         cbgs_stack(dev), cbgs_data, nusc, CBGS_LAUNCHES, CBGS_LAYERS,
         cbgs_stack(dev, cut=True), cbgs_stack("cpu", cut=True), cbgs_one,
         False),
        ("cbgs_tta", "phase 49 CBGS double-flip TTA (fp32 middle)",
         load_stack(tta_config(cbgs_config()), cbgs_state(), dev),
         cbgs_data, nusc, CBGS_LAUNCHES, CBGS_LAYERS,
         load_stack(cbgs_cut, cbgs_state(), dev),
         load_stack(cbgs_cut, cbgs_state(), "cpu"), cbgs_one, True),
        ("nusc_pp_tta", "phase 50 nuScenes PointPillars double-flip TTA",
         load_stack(tta_config(pp_config(NUSC_PP_CFG)),
                    pp_state(NUSC_PP_CFG), dev),
         cbgs_data, nusc, 0, None,
         load_stack(pp_cut, pp_state(NUSC_PP_CFG), dev),
         load_stack(pp_cut, pp_state(NUSC_PP_CFG), "cpu"),
         pp_scans(pp_cut, 1, PP_CUT_POINTS), True))
    out = {}
    for (key, label, stack, batch, (shape, nms), n_conv, layers, card, cpu,
         one, tta) in paths:
        st, launches, nms_in, cap = points_step(
            dev, stack, batch, shape, n_conv, nms, label, smi,
            min_labels=2 if tta else 1)
        card_vs_cpu_points(dev, card, cpu, one, label, tta)
        if tta:
            full_size_tta(dev, st, cpu[0], label)
        conv = (device_plan_kernels(dev, st, layers, label, smi)
                if layers else None)
        out[key] = (st, launches, nms_in, cap, conv,
                    step_nms_timing(nms_in, smi, label))
    return out


def full_size_tta(dev, stack, cpu_model, label):
    """The CPU's predict_tta of the card's full-size heads of scan 0's four
    flips against the card's (check_decode)."""
    from det3d_tpu_torch.parallel.predict import double_flip_batch
    model, vg, asg, test_cfg, _, data = stack
    one = double_flip_batch({k: torch.as_tensor(data[k][:1]) for k in
                             ("points", "num_points")})
    with torch.no_grad():
        ex_d, heads_d = heads_on(model, vg, asg, one, dev)
        det_d = model.predict_tta(ex_d, heads_d, test_cfg)
        anchors = [a.anchors_on("cpu")[None].expand(4, *a.anchors_flat.shape)
                   for a in asg]
        det_c = cpu_model.predict_tta(
            {"anchors": anchors},
            [{k: v.cpu() for k, v in h.items()} for h in heads_d], test_cfg)
    log(f"{label} the CPU's predict_tta of the full-size card heads (scan "
        f"0, 4 flips): {check_decode(det_d, det_c, label + ' full')}")


# ---------------------------------------------------------------------------
# CBGS's middle with 128-channel sparse layers
# ---------------------------------------------------------------------------

# SpMiddleResNetFHD variants whose sparse layers reach 128 channels, as
# (dense_from, dense_tail); the shipped config has (2, True)
CBGS_VARIANTS = ((3, True), (2, False))


def cbgs_variant(variant, precision=None, cut=False):
    """cbgs_config with the middle's (dense_from, dense_tail) = variant."""
    c = cbgs_config(precision, cut)
    c["model"]["backbone"].update(dense_from=variant[0],
                                  dense_tail=variant[1])
    return c


def cbgs_variant_layers(variant):
    """The window convs of SpMiddleResNetFHD at ``variant`` in forward order,
    as CBGS_LAYERS: with dense_from=3, stage 2's blocks and stage 3's
    strided conv to 128 channels are sparse too, and the tail is stage 3's
    two blocks and the (3, 1, 1) z conv (one column, K=1); without the
    dense tail, those are sparse too."""
    layers = (CBGS_SPARSE + (("subm2", 64, 64, True),) * 4
              + (("down3", 64, 128, False),))
    tail = CBGS_TAIL[5:]
    if not variant[1]:
        tail = tuple((key[1:], *rest) for key, *rest in tail)
    return layers + tail


def middle_on(stack, scan, device):
    """The middle's output of ``stack`` (load_stack) on ``scan``, from its
    host voxels and plan, on ``device``."""
    from det3d_tpu_torch.parallel.predict import build_example
    model, vg, asg, _, _, plan_fn = stack
    data = dict(scan, **plan_fn(scan["points"], scan["num_points"]))
    t = {k: torch.as_tensor(v, device=device) for k, v in data.items()}
    with torch.no_grad():
        ex = build_example(t, vg, asg)
        feats = model.reader(ex["voxels"], ex["num_points_per_voxel"])
        plan = {k[5:]: v for k, v in t.items() if k.startswith("plan_")}
        return model.backbone(feats, ex["coordinates"], model.grid_size,
                              plan=plan)


def phase_cbgs_variants(dev, batch, smi):
    """Phase 38, each variant of CBGS_VARIANTS: on the host plans of CBGS's
    B=2 scans ``batch``, the kernel against its plain twin at every
    128-channel layer in fp32 and bf16 (conv_vs_plain), each also timed on
    the device; on the range cut to +-CBGS_CUT m (CBGS_CUT_VOXELS voxels,
    every width as shipped; weights calibrated on the card in fp32), the
    card's middle through build_stack against the CPU's: in fp32 within
    HEAD_TOL, in bf16 closer to the CPU's bf16 middle than that is to the
    CPU's fp32 middle; each card middle launches the window conv once per
    layer, the tail's included. Returns the largest kernel error."""
    from det3d_tpu_torch.ops.window_conv_cuda import window_conv
    worst = 0.0
    for variant in CBGS_VARIANTS:
        label = (f"phase 38 CBGS dense_from={variant[0]}" if variant[1]
                 else "phase 38 CBGS dense_tail=False")
        layers = cbgs_variant_layers(variant)
        plan = plan_builder(cbgs_variant(variant))(batch["points"],
                                                   batch["num_points"])
        plan.update(tail_plan(detector_of(cbgs_variant(variant)), plan,
                              dev))
        for prec in ("fp32", "bf16"):
            for case, layer in zip(conv_cases(plan, dev, DTYPES[prec],
                                              layers), layers):
                if layer[2] != 128:
                    continue
                worst = max(worst, conv_vs_plain(case, prec, label))
                _, x, pk, w, subm = case
                ms = graph_ms(lambda: window_conv(x, pk, w, subm))
                log(f"{label}   kernel on the device {ms:.4f} ms [{smi}]")
        scan = cbgs_batch(1, CBGS_CUT_POINTS, cbgs_variant(
            variant, cut=True)["voxel_generator"]["range"])
        state = calibrated_state(cbgs_variant(variant, "fp32", cut=True),
                                 scan, dev)
        mids = {}
        for prec in ("fp32", "bf16"):
            for device in (dev, "cpu"):
                stack = load_stack(cbgs_variant(variant, prec, cut=True),
                                   state, device)
                window_conv.launches = 0
                mids[prec, str(device)] = middle_on(stack, scan, device)
                if device != "cpu" and window_conv.launches != len(layers):
                    raise AssertionError(
                        f"{label}: {window_conv.launches} window-conv "
                        f"launches in the {prec} middle, expected "
                        f"{len(layers)}")
        card, cpu = mids["fp32", str(dev)].cpu(), mids["fp32", "cpu"]
        err = float((card - cpu).abs().max())
        card16 = rel_l2(mids["bf16", str(dev)], mids["bf16", "cpu"])
        cpu16 = rel_l2(mids["bf16", "cpu"], cpu)
        log(f"{label} card vs CPU at +-{CBGS_CUT} m, {CBGS_CUT_VOXELS} "
            f"voxels: the middle {tuple(cpu.shape)}, {len(layers)} "
            f"window-conv launches; fp32 max abs err {err:.3e} (|CPU| max "
            f"{float(cpu.abs().max()):.3f}, tolerance {HEAD_TOL}); bf16 "
            f"card vs CPU relative L2 {card16:.3e}, CPU bf16 vs fp32 "
            f"{cpu16:.3e}")
        if not torch.allclose(card, cpu, **HEAD_TOL):
            raise AssertionError(f"{label}: fp32 middle card vs CPU {err}")
        if not (card16 < cpu16 and float(cpu.abs().max()) > 0.1):
            raise AssertionError(f"{label}: bf16 middle card vs CPU "
                                 f"{card16}, bf16 vs fp32 {cpu16}")
    return worst


# ---------------------------------------------------------------------------
# Lyft and KITTI-all from points alone and under TTA (phases 51, 52)
# ---------------------------------------------------------------------------

FP32_TIMING = dict(warmup=2, rounds=5)   # these steps take up to ~1 s
# a captured step's graph pool holds about the eager step's peak, and the
# eager step's blocks stay cached beside it while the two are timed in
# turns: capture only when twice the eager peak and what is resident fit
# in this share of the card's memory
CAPTURE_MEMORY_SHARE = 0.9


def capture_fits(peak, label):
    """Whether the captured step can be run beside the eager one: the byte
    count 2 x ``peak`` (the eager step's peak allocation above what was
    resident) + what is allocated now, against CAPTURE_MEMORY_SHARE of the
    card's memory, printed on a line of its own."""
    total = torch.cuda.get_device_properties(0).total_memory
    resident = torch.cuda.memory_allocated()
    need = 2 * peak + resident
    fits = need <= CAPTURE_MEMORY_SHARE * total
    log(f"{label} memory: eager peak {peak / 2**30:.2f} GiB, resident "
        f"{resident / 2**30:.2f} GiB; eager and captured side by side "
        f"need 2 x peak + resident = {need / 2**30:.2f} GiB of "
        f"{CAPTURE_MEMORY_SHARE} x {total / 2**30:.2f} GiB: "
        + ("the captured step runs" if fits else
           "THE CAPTURED STEP DOES NOT FIT and is not run; the step runs "
           "eagerly only"))
    return fits


def phase_fp32_points(dev, path, phase, smi):
    """Phase 51 (Lyft) / 52 (KITTI-all): the fp32 path's step fed points
    alone and under double-flip TTA at the shipped B=2, full widths,
    through build_stack and make_predict_step: the eager step's checks
    (points_step's: boxes, exactly len(path.layers) window-conv launches
    and 1 NMS launch fed path.nms, at 4B rows under TTA); its peak memory;
    then, where capture_fits, the captured step (phase_captured, timed
    with FP32_TIMING: 2 warm-ups, median of 5) and its peak memory, else
    the eager step alone timed so; card vs CPU at B=1 from points
    (card_vs_cpu_points: Lyft on its +-12.8 m cut, KITTI-all over its full
    range; under TTA the four flips and predict_tta). The CPU's
    predict_tta of Lyft's full-size card heads is not held to the card's:
    with random weights they decode boxes of 460 m, where one ulp of exp is
    3e-5, past check_decode's absolute 1e-5."""
    batch = path.scans(path.b, path.points)
    data = {k: batch[k] for k in ("points", "num_points")}
    shape = (path.b, path.dets, 9 if path.five else 7)
    if path.cut is None:
        one_cfg = path.config()
        one = {k: v[:1] for k, v in data.items()}
    else:
        one_cfg = path.config(cut=True)
        one = path.scans(1, path.cut[2], cut=True)
    for tta in (False, True):
        label = (f"phase {phase} {path.name} "
                 + ("double-flip TTA" if tta else "from points")
                 + " (fp32 middle)")
        cfg = tta_config(path.config()) if tta else path.config()
        stack = load_stack(cfg, fp32_state(path), dev)
        st, launches = sparse_predict(dev, stack, data, {}, shape,
                                      len(path.layers), label, min_labels=2)
        if launches["rotated_nms_keep"] != 1:
            raise AssertionError(f"{label}: {launches['rotated_nms_keep']} "
                                 f"NMS launches, expected 1")
        nms_fed(st, path.nms, label)
        step = st[4]
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step.eager(data)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - resident
        if capture_fits(peak, label):
            cap = phase_captured(dev, step, data, launches, smi, label,
                                 **FP32_TIMING)
            log(f"{label} memory: the eager step's peak allocation "
                f"{peak / 2**30:.2f} GiB above the resident "
                f"{resident / 2**30:.2f}; reserved after the eager and "
                f"captured steps were timed in turns (the graph's pool "
                f"beside the eager step's cached blocks) "
                f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB "
                f"[{smi}]")
            cap_ms = f"captured {cap['captured']:.3f}"
        else:
            ms = cuda_ms(lambda: step.eager(data),
                         warmup=FP32_TIMING["warmup"],
                         repeat=FP32_TIMING["rounds"])
            log(f"{label} eager step only: {ms:.3f} ms/batch B={path.b} "
                f"from the numpy batch, peak memory {peak / 2**30:.2f} GiB "
                f"[{smi}]")
            cap_ms = "captured not run"
        del st, stack, step
        gc.collect()
        torch.cuda.empty_cache()
        c = tta_config(one_cfg) if tta else one_cfg
        cpu = load_stack(c, fp32_state(path), "cpu")
        card_vs_cpu_points(dev, load_stack(c, fp32_state(path), dev), cpu,
                           one, label, tta)
        log(f"{label}: done ({cap_ms}) [{smi}]")
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Training: the pillar path's train step (phases 53-57)
# ---------------------------------------------------------------------------

def train_scene(batch, points, pc_range, n_gt=6, max_gt=16, seed=SEED):
    """Training scans: dense point clusters inside ``n_gt`` car boxes a
    scan at random yaws, uniform clutter elsewhere, and the gt padded to
    ``max_gt`` rows (gt_boxes, gt_classes = 1, gt_valid), seeded numpy, as
    tests/test_e2e_pointpillars.py::_synth_scene builds its scene. A
    third of the points fall in the boxes."""
    rng = np.random.RandomState(seed)
    x0, y0, _, x1, y1, _ = (float(v) for v in pc_range)
    pts = np.zeros((batch, points, 4), np.float32)
    gt = np.zeros((batch, max_gt, 7), np.float32)
    valid = np.zeros((batch, max_gt), bool)
    k = points // (3 * n_gt)
    for b in range(batch):
        cursor = 0
        for g in range(n_gt):
            cx = rng.uniform(x0 + 3, x1 - 3)
            cy = rng.uniform(y0 + 3, y1 - 3)
            theta = rng.uniform(-np.pi, np.pi)
            gt[b, g] = [cx, cy, -1.0, 1.6, 3.9, 1.56, theta]
            valid[b, g] = True
            local = rng.uniform(-0.5, 0.5, (k, 3)) * [1.5, 3.5, 1.4]
            c, s = np.cos(theta), np.sin(theta)
            sl = slice(cursor, cursor + k)
            pts[b, sl, 0] = local[:, 0] * c + local[:, 1] * s + cx
            pts[b, sl, 1] = -local[:, 0] * s + local[:, 1] * c + cy
            pts[b, sl, 2] = -1.0 + local[:, 2]
            pts[b, sl, 3] = rng.uniform(0, 1, k)
            cursor += k
        rest = points - cursor
        pts[b, cursor:, 0] = rng.uniform(x0, x1, rest)
        pts[b, cursor:, 1] = rng.uniform(y0, y1, rest)
        pts[b, cursor:, 2] = rng.uniform(-2.5, 0.5, rest)
        pts[b, cursor:, 3] = rng.uniform(0, 1, rest)
    return {"points": pts, "num_points": np.full((batch,), points, np.int32),
            "gt_boxes": gt, "gt_classes": valid.astype(np.int32),
            "gt_valid": valid}


# the two trained models: kitti_car_pointpillars.py as shipped (bf16
# reader and RPN) at its samples_per_gpu, and the flagship (fp32) at the
# serving batch, trained with kitti_car_pointpillars.py's optimizer and lr
TRAIN_PATHS = (("kitti_pp", "KITTI car PointPillars (bf16)", 2),
               ("flagship", "flagship (fp32)", B))
TRAIN_POINTS = POINTS
TRAIN_GT, TRAIN_MAX_GT = 6, 16
TRAIN_TOTAL = 100                        # the schedules' total steps
OVERFIT_STEPS = 30
TARGET_MARGIN = 1e-5     # anchors this near a threshold or a tie may tip
TARGET_TIPPED_MAX = 16   # ... and at most this many a batch may differ
TRAIN_LOSS_REL = 1e-4
TRAIN_EVAL_BF16_REL = 1e-3
# one step card vs CPU, relative L2 of each gradient. fp32: the batch
# statistics come from sums, var = E[x²] - mean² as in the JAX package,
# which loses digits where a channel's mean dwarfs its spread (the pillar
# reader's features carry coordinates in metres); summed over 3M rows in
# another order, the reader's weight gradient moves 8.1e-3 and the median
# tensor 2.8e-3 (the flagship at B=8 on an H100 80GB HBM3 at 700 W; see
# PERF.md), well above the 1e-3 of sums in another order alone. bf16:
# training-mode BN's backward
# leaves gradients of the size of the roundings above the head
# (tests/test_torch_train_step.py: JAX's own jitted and op-by-op steps lie
# 0.3-0.6 apart)
TRAIN_GRAD_REL = {"fp32": 2e-2, "bf16": 0.75}
TRAIN_STATS_TOL = {"fp32": dict(rtol=1e-4, atol=1e-5),
                   "bf16": dict(rtol=1e-2, atol=1e-3)}
TRAIN_PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
# gradient elements whose step is compared: clear of zero relative to the
# tensor's largest and absolutely (1000 x Adam's eps of 1e-8, where its
# first step g / (|g| + eps) is the sign within 1e-3)
TRAIN_CLEAR, TRAIN_CLEAR_ABS = 1e-3, 1e-5


def train_config(key):
    """The config dict of a trained model: KITTI car PointPillars, SECOND
    or CBGS as shipped, or the flagship with kitti_car_pointpillars.py's
    optimizer, lr_config and optimizer_config."""
    if key == "second":
        return second_config()
    if key == "cbgs":
        return cbgs_config()
    kitti = pp_config(KITTI_PP_CFG)
    if key == "kitti_pp":
        return kitti
    from det3d_tpu_torch.apis.flagship import flagship_config
    return dict(flagship_config(), **{k: kitti[k] for k in (
        "optimizer", "lr_config", "optimizer_config")})


@functools.lru_cache(maxsize=None)
def train_weights(key):
    """Calibrated random weights (calibrated_state): KITTI car
    PointPillars' of phase 20, SECOND's and CBGS's of phases 7 and 14, the
    flagship's calibrated on the card on its first structured scan."""
    if key == "kitti_pp":
        return pp_state(KITTI_PP_CFG)
    if key == "second":
        return second_state()
    if key == "cbgs":
        return cbgs_state()
    from det3d_tpu_torch.utils.synth import structured_batch
    cfg = train_config(key)
    return calibrated_state(cfg, structured_batch(
        1, POINTS, cfg["voxel_generator"]["range"], seed=SEED), "cuda")


def train_stack(key, device, total_steps=TRAIN_TOTAL, cfg=None):
    """(model, voxel_gen, assigners, class ids, TrainState) of a trained
    model on ``device`` from train_weights, through build_stack and
    init_state."""
    from det3d_tpu_torch.apis.train import build_stack, init_state
    cfg = cfg or train_config(key)
    model, vg, asg, cids, _ = build_stack(cfg, device=device)
    model.load_state_dict(train_weights(key))
    return (model, vg, asg, cids, init_state(cfg, model, total_steps)[0])


def train_batch(key, b):
    pc = train_config(key)["voxel_generator"]["range"]
    return train_scene(b, TRAIN_POINTS, pc, TRAIN_GT, TRAIN_MAX_GT)


def spy_grads(state):
    """Record the gradients a train step hands its optimizer."""
    seen = []
    update = state.tx.update

    def spy(grads):
        grads = list(grads)
        seen.append([g.detach().clone() for g in grads])
        return update(grads)
    state.tx.update = spy
    return seen


def phase_train_targets(dev, key, name, batch):
    """Phase 53: each task's targets of ``batch``'s gt on the card against
    the CPU: labels and reg weights equal except at anchors whose CPU IoU
    lies within TARGET_MARGIN of a threshold or of its gt's best overlap
    (a force-match tie), at most TARGET_TIPPED_MAX of them; reg targets
    within 1e-5 absolute; then, on a copy of the config with
    pos_area_threshold = 1, the anchor-area masks of the step's own
    voxels equal."""
    from det3d_tpu_torch.apis.train import build_stack
    from det3d_tpu_torch.core.target import _bev, nearest_iou_similarity
    from det3d_tpu_torch.parallel.train import build_example
    label = f"phase 53 {name}"
    cfg = train_config(key)
    _, vg, asg, cids, _ = build_stack(cfg, device="cpu")
    gt = {k: batch[k] for k in ("gt_boxes", "gt_classes", "gt_valid")}
    for t, (a, ids) in enumerate(zip(asg, cids)):
        out = {}
        for device in (dev, "cpu"):
            g = {k: torch.as_tensor(v, device=device) for k, v in gt.items()}
            out[str(device)] = [x.cpu() for x in a.assign(
                g["gt_boxes"], g["gt_classes"], g["gt_valid"], ids)]
        (ld, td, wd), (lc, tc, wc) = out[str(dev)], out["cpu"]
        valid = torch.as_tensor(gt["gt_valid"])
        sim = nearest_iou_similarity(_bev(a.anchors_on("cpu")),
                                     _bev(torch.as_tensor(gt["gt_boxes"])))
        sim = torch.where(valid[:, None, :], sim, -1.0)
        best = sim.amax(dim=2)
        near = torch.zeros_like(best, dtype=torch.bool)
        for g_id, (mt, ut) in zip(ids, a._thresholds):
            near |= ((best - mt).abs() < TARGET_MARGIN) | (
                (best - ut).abs() < TARGET_MARGIN)
        gt_best = sim.amax(dim=1)
        near |= (((sim - gt_best[:, None, :]).abs() < TARGET_MARGIN)
                 & valid[:, None, :]).any(2) & (best > 0)
        differ = (ld != lc) | (wd != wc)
        n_diff, n_near = int(differ.sum()), int(near.sum())
        tipped = int((differ & near).sum())
        err = float((td - tc).abs().max())
        log(f"{label} task {t} targets card vs CPU, B={ld.shape[0]} x "
            f"{ld.shape[1]} anchors, {int(valid.sum())} gt: labels / reg "
            f"weights differ at {n_diff} anchors, all within "
            f"{TARGET_MARGIN} of a threshold or a tie ({n_near} anchors "
            f"are); positives {int((lc > 0).sum())}, reg targets max abs "
            f"err {err:.2e}")
        if bool((differ & ~near).any()) or tipped > TARGET_TIPPED_MAX:
            raise AssertionError(f"{label}: {n_diff} anchors differ, "
                                 f"{n_diff - tipped} clear of the "
                                 f"thresholds")
        if err > 1e-5:
            raise AssertionError(f"{label}: reg targets card vs CPU {err}")
        if int((lc > 0).sum()) < 1:
            raise AssertionError(f"{label}: no positive anchor")
    cfg = copy.deepcopy(cfg)
    cfg["assigner"]["target_assigner"]["pos_area_threshold"] = 1
    _, vg, asg, cids, _ = build_stack(cfg, device="cpu")
    masks = []
    for device in (dev, "cpu"):
        d = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        with torch.no_grad():
            masks.append(build_example(d, vg, asg, cids)[
                "anchors_mask"][0].cpu())
    if not torch.equal(*masks):
        raise AssertionError(f"{label}: anchor-area masks differ")
    log(f"{label} anchor-area mask (pos_area_threshold 1) card vs CPU "
        f"equal, {float(masks[1].float().mean()):.3f} of the anchors kept")


def phase_train_step(dev, key, name, batch, smi):
    """Phase 54: one train step (make_train_step) on the card (eager) and
    on the CPU from the same weights: the loss within TRAIN_LOSS_REL; each
    gradient (caught on its way to the optimizer) within TRAIN_GRAD_REL
    relative L2, the worst named; the BatchNorm running statistics after
    the step within TRAIN_STATS_TOL; the parameters after the step within
    TRAIN_PARAM_TOL where both gradients, clipped at the global norm of 35
    as the optimizer clips them, are clear of zero (TRAIN_CLEAR of the
    tensor's largest and TRAIN_CLEAR_ABS) and of one sign (Adam's
    first step turns a gradient into its sign); no window-conv or NMS
    launch."""
    from det3d_tpu_torch.ops.nms_cuda import rotated_nms_keep
    from det3d_tpu_torch.ops.window_conv_cuda import window_conv
    from det3d_tpu_torch.parallel.train import make_train_step
    label = f"phase 54 {name}"
    prec = "bf16" if key == "kitti_pp" else "fp32"
    runs = {}
    for device in (dev, "cpu"):
        model, vg, asg, cids, state = train_stack(key, device)
        seen = spy_grads(state)
        step = make_train_step(state, vg, asg, cids)
        window_conv.launches = rotated_nms_keep.launches = 0
        t = time.perf_counter()
        metrics = step.eager(batch)
        if device != "cpu":
            torch.cuda.synchronize()
        t = time.perf_counter() - t
        runs[str(device)] = (metrics, seen[0], model, t, (
            window_conv.launches, rotated_nms_keep.launches))
    (md, gd, model_d, t_d, launches), (mc, gc_, model_c, t_c, _) = (
        runs[str(dev)], runs["cpu"])
    if launches != (0, 0):
        raise AssertionError(f"{label}: kernel launches {launches}")
    loss_d, loss_c = float(md["loss"]), float(mc["loss"])
    loss_err = abs(loss_d - loss_c) / abs(loss_c)
    names = [n for n, _ in model_c.named_parameters()]
    errs = {n: rel_l2(a, b) for n, a, b in zip(names, gd, gc_)}
    worst = max(errs, key=errs.get)
    sd_d = {k: v.cpu() for k, v in model_d.state_dict().items()}
    sd_c = model_c.state_dict()
    stat_err = max((float((sd_d[k] - sd_c[k]).abs().max()), k)
                   for k in sd_c if k.endswith((".mean", ".var")))
    checked, off = 0, []
    # Adam sees the clipped gradients
    clip = [min(1.0, 35.0 / float(m["grad_norm"])) for m in (md, mc)]
    for n, a, b in zip(names, gd, gc_):
        a = a.cpu() * clip[0]
        b = b * clip[1]
        clear = ((a.abs() > TRAIN_CLEAR * float(a.abs().max()))
                 & (b.abs() > TRAIN_CLEAR * float(b.abs().max()))
                 & (a.abs() > TRAIN_CLEAR_ABS) & (b.abs() > TRAIN_CLEAR_ABS)
                 & (torch.sign(a) == torch.sign(b)))
        checked += int(clear.sum())
        if not torch.allclose(sd_d[n][clear], sd_c[n][clear],
                              **TRAIN_PARAM_TOL):
            off.append((float((sd_d[n][clear] - sd_c[n][clear]).abs().max()),
                        n))
    log(f"{label} one train step B={batch['points'].shape[0]} card (eager, "
        f"{t_d * 1e3:.1f} ms with its first call's set-up) vs CPU "
        f"({t_c:.2f} s): loss {loss_d:.6f} / {loss_c:.6f} (rel err "
        f"{loss_err:.2e}, tolerance {TRAIN_LOSS_REL}); gradients relative "
        f"L2 worst {errs[worst]:.3e} ({worst}), median "
        f"{statistics.median(errs.values()):.3e} (tolerance "
        f"{TRAIN_GRAD_REL[prec]}, {prec}); BN running stats max abs err "
        f"{stat_err[0]:.2e} ({stat_err[1]}); {checked} parameter elements "
        f"with clear gradients of one sign equal after the step within "
        f"{TRAIN_PARAM_TOL}; num_pos {int(md['num_pos_task0'])}; window-conv "
        f"and NMS launches {launches} [{smi}]")
    if loss_err > TRAIN_LOSS_REL:
        raise AssertionError(f"{label}: loss card vs CPU {loss_err}")
    if off:
        raise AssertionError(f"{label}: parameters after the step, card vs "
                             f"CPU, worst {max(off)}")
    if errs[worst] > TRAIN_GRAD_REL[prec]:
        raise AssertionError(f"{label}: gradient {worst} card vs CPU "
                             f"{errs[worst]}")
    for k in sd_c:
        if k.endswith((".mean", ".var")) and not torch.allclose(
                sd_d[k], sd_c[k], **TRAIN_STATS_TOL[prec]):
            raise AssertionError(f"{label}: BN statistic {k} card vs CPU")
    if sorted(md) != sorted(mc):
        raise AssertionError(f"{label}: metric keys differ")


def phase_train_timing(dev, key, name, batch, smi, label=None,
                       warmup=WARMUP, repeat=REPEAT):
    """Phase 55: ms/step of the train step at full width, eager and
    captured, from the numpy batch and from the card (interleaved_ms: e c c
    e, ``warmup`` warm-ups, median of ``repeat``); the split into target
    assignment, forward (and loss), backward and optimizer, each timed
    alone by CUDA events; the captured step's device busy share
    (torch.profiler over 5 replays); peak memory of the eager step and of
    the capture (its warm-up included). Every call is a step: the weights
    move on. Returns {"eager", "captured", "on_card", "split", "busy",
    "peak"}."""
    from det3d_tpu_torch.parallel.train import (build_example,
                                                make_train_step,
                                                network_loss)
    label = label or f"phase 55 {name}"
    model, vg, asg, cids, state = train_stack(key, dev)
    step = make_train_step(state, vg, asg, cids)
    data_d = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step.eager(batch)
    torch.cuda.synchronize()
    peak_e = torch.cuda.max_memory_allocated() - resident
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    step(batch)
    torch.cuda.synchronize()
    peak_c = torch.cuda.memory_reserved() - reserved
    ms = interleaved_ms({"eager": lambda: step.eager(batch),
                         "captured": lambda: step(batch)}, repeat, warmup)
    on_card = interleaved_ms({"eager": lambda: step.eager(data_d),
                              "captured": lambda: step(data_d)}, repeat,
                             warmup)
    params = list(model.parameters())

    def example():
        with torch.no_grad():
            return build_example(data_d, vg, asg, cids, with_targets=True)

    ex = example()
    model.train()
    try:
        fwd = cuda_ms(lambda: network_loss(model, ex), warmup, repeat)
        fwd_bwd = cuda_ms(lambda: torch.autograd.grad(
            network_loss(model, ex)[0], params), warmup, repeat)
        grads = torch.autograd.grad(network_loss(model, ex)[0], params)
    finally:
        model.eval()
    split = {"targets": cuda_ms(example, warmup, repeat), "forward": fwd,
             "backward": fwd_bwd - fwd,
             "optimizer": cuda_ms(lambda: state.tx.update(grads), warmup,
                                  repeat)}
    wall, kernels = profile_steps(lambda: step(data_d), 5)
    busy = log_profile(f"{label} captured", wall, kernels, 5,
                       batch["points"].shape[0], smi)
    b = batch["points"].shape[0]
    count_step(f"{label} train step", lambda: step.eager(data_d),
               on_card["captured"], b)
    log(f"{label} train step B={b} ms/step from the numpy batch, in turns "
        f"(e c c e): eager {ms['eager']:.3f}, captured {ms['captured']:.3f} "
        f"({ms['eager'] / ms['captured']:.2f}x; "
        f"{b * 1e3 / ms['captured']:.1f} scans/s); from the card: eager "
        f"{on_card['eager']:.3f}, captured {on_card['captured']:.3f} "
        f"[{smi}]")
    log(f"{label} split, each part alone (CUDA events, median of "
        f"{repeat}): target assignment {split['targets']:.3f} ms, forward "
        f"and loss {split['forward']:.3f}, backward {split['backward']:.3f}, "
        f"optimizer {split['optimizer']:.3f} (sum "
        f"{sum(split.values()):.3f}); device busy in the captured step "
        + (f"{busy:.3f} ms/step ({busy / wall:.2f} of the window)"
           if busy else "not measured")
        + f"; memory: the eager step's peak allocation {peak_e / 2**30:.2f} "
        f"GiB above the resident {resident / 2**30:.2f}, the captured "
        f"step's first call (warm-up, capture) reserved "
        f"{peak_c / 2**30:.2f} GiB more [{smi}]")
    return {"eager": ms["eager"], "captured": ms["captured"],
            "on_card": on_card, "split": split, "busy": busy,
            "peak": (peak_e, peak_c)}


def phase_overfit(dev, key, name, smi, label=None):
    """Phase 56: OVERFIT_STEPS captured steps on one fixed scene
    (train_batch, seed SEED + 1; a sparse path's SPARSE_TRAIN scene with
    its host training plan) with the OneCycle schedule over those steps;
    the loss of every step printed. Passes when every loss is finite and
    the mean of the last 5 lies below the mean of the first 5."""
    from det3d_tpu_torch.parallel.graph import CapturedStep
    from det3d_tpu_torch.parallel.train import make_train_step
    label = label or f"phase 56 {name}"
    model, vg, asg, cids, state = train_stack(key, dev, OVERFIT_STEPS)
    step = make_train_step(state, vg, asg, cids)
    if not isinstance(step, CapturedStep):
        raise AssertionError(f"{label}: the step is not captured")
    pc = train_config(key)["voxel_generator"]["range"]
    sparse = {k: (b, p) for k, _, b, p in SPARSE_TRAIN}
    if key in sparse:
        scene = with_train_plan(key, sparse_train_scene(
            key, sparse[key][0], pc, sparse[key][1], seed=SEED + 1))
    else:
        scene = train_scene(B if key == "flagship" else 2, TRAIN_POINTS, pc,
                            TRAIN_GT, TRAIN_MAX_GT, seed=SEED + 1)
    losses = [float(step(scene)["loss"]) for _ in range(OVERFIT_STEPS)]
    first, last = (statistics.mean(losses[:5]),
                   statistics.mean(losses[-5:]))
    log(f"{label} {OVERFIT_STEPS} captured steps on one scene, OneCycle "
        f"over {OVERFIT_STEPS}: losses "
        + " ".join(f"{v:.4f}" for v in losses)
        + f"; mean of the first 5 {first:.4f}, of the last 5 {last:.4f}; "
        f"{len(step.graphs)} graph, step count {int(state.step)} [{smi}]")
    if not all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"{label}: the loss did not fall")
    if int(state.step) != OVERFIT_STEPS or len(step.graphs) != 1:
        raise AssertionError(f"{label}: {int(state.step)} steps, "
                             f"{len(step.graphs)} graphs")


def phase_loss_eval(dev, key, name, batch):
    """Phase 57: make_loss_eval_step, captured on the card, against the
    CPU's from the same weights: within TRAIN_LOSS_REL in fp32 (a bf16
    model also with its reader and neck in fp32 on both sides), and a bf16
    model as shipped within TRAIN_EVAL_BF16_REL (cuDNN's and oneDNN's bf16
    convs round apart; phase 23 holds the bf16 heads layer by layer)."""
    from det3d_tpu_torch.parallel.train import make_loss_eval_step
    label = f"phase 57 {name}"
    cfg = train_config(key)
    variants = [("as shipped", cfg, TRAIN_LOSS_REL)]
    if cfg["model"]["reader"].get("precision") == "bf16":
        fp32 = copy.deepcopy(cfg)
        fp32["model"]["reader"]["precision"] = "fp32"
        fp32["model"]["neck"]["precision"] = "fp32"
        variants = [("as shipped (bf16)", cfg, TRAIN_EVAL_BF16_REL),
                    ("reader and neck in fp32", fp32, TRAIN_LOSS_REL)]
    for what, c, tol in variants:
        out = {}
        for device in (dev, "cpu"):
            model, vg, asg, cids, _ = train_stack(key, device, cfg=c)
            out[str(device)] = float(make_loss_eval_step(
                model, vg, asg, cids)(batch)["loss"])
        err = abs(out[str(dev)] - out["cpu"]) / abs(out["cpu"])
        log(f"{label} validation loss {what}, captured on the card "
            f"{out[str(dev)]:.6f} vs CPU {out['cpu']:.6f} (rel err "
            f"{err:.2e}, tolerance {tol})")
        if err > tol:
            raise AssertionError(f"{label}: loss {what} card vs CPU {err}")


def training_phases(dev, smi):
    """Phases 53-57 for each of TRAIN_PATHS, then the timing summary, then
    the sparse middles' phases 58-62. Returns the kernels' JSON entries of
    the sparse train steps."""
    times = {}
    for key, name, b in TRAIN_PATHS:
        batch = train_batch(key, b)
        phase_train_targets(dev, key, name, batch)
        phase_train_step(dev, key, name, batch, smi)
        times[key] = phase_train_timing(dev, key, name, batch, smi)
        CAPTURED_MS[key] = times[key]["captured"]
        phase_overfit(dev, key, name, smi)
        phase_loss_eval(dev, key, name, batch)
        gc.collect()
        torch.cuda.empty_cache()
    for key, name, b in TRAIN_PATHS:
        t = times[key]
        log(f"train steps: {name} B={b}: eager {t['eager']:.3f} ms/step, "
            f"captured {t['captured']:.3f}; from the card eager "
            f"{t['on_card']['eager']:.3f}, captured "
            f"{t['on_card']['captured']:.3f}; memory: eager peak "
            f"{t['peak'][0] / 2**30:.2f} GiB, captured pool reserved "
            f"{t['peak'][1] / 2**30:.2f} GiB; "
            f"window-conv and NMS launches on the train step: 0 [{smi}]")
    gc.collect()
    torch.cuda.empty_cache()
    return sparse_training_phases(dev, smi)


# ---------------------------------------------------------------------------
# Training the sparse middles (phases 58-62)
# ---------------------------------------------------------------------------

# the sparse train steps: kitti_car_second.py as shipped at its
# samples_per_gpu=4, and nusc_cbgs_voxelnet.py as shipped at B=2 (its
# samples_per_gpu is 16: cut to 2 to keep this script inside its time
# limit), both on train_scene scans, fed host training plans
SPARSE_TRAIN = (("second", "SECOND", 4, POINTS),
                ("cbgs", "CBGS", CBGS_B, CBGS_POINTS))
# the window-conv kernels' launches in one eager train step: forward,
# subm dX (the forward kernel; the stem's input needs no gradient), the
# strided convs' dX over the inverse rulebook, dW
TRAIN_LAUNCHES = {"second": {"window_conv": 14, "window_conv_subm_dx": 9,
                             "window_conv_inv": 4, "window_conv_dw": 14},
                  "cbgs": {"window_conv": 21, "window_conv_subm_dx": 16,
                           "window_conv_inv": 4, "window_conv_dw": 21}}
BWD_TOL = dict(rtol=1e-4, atol=1e-4)    # backward kernels vs plain, fp32
CAPTURED_REL = 1e-4                     # captured vs eager train steps
# one sparse train step card vs CPU (and from points vs from host plans),
# relative L2 of each gradient. The head's gradients agree within 1.9e-5;
# below it the RPN's and the middle's training BN backward amplifies any
# change of a conv's rounding: on the card alone, cuDNN off against on
# moves CBGS's gradients up to 1.6e-2 (median 9e-3), two runs of one
# setting 2e-6 (H100 80GB HBM3 at 700 W, see PERF.md). So the head is held
# at SPARSE_HEAD_REL, every other gradient at SPARSE_GRAD_REL.
SPARSE_HEAD_REL = 1e-4
SPARSE_GRAD_REL = 5e-2
# from points against from host plans on the card, relative L2 of each
# gradient: the plans are equal and the device's fused voxel means within
# MEAN_TOL of the host's; measured 2.7e-7 (SECOND) and 2.7e-6 (CBGS),
# where two runs of one step differ by up to 2e-6 (cuDNN's wgrad_alg1_nd
# sums with atomics)
POINTS_REL = 1e-4
EAGER_STEPS = 4
# the sparse steps' timing (phase_train_timing): 200-470 ms a step, so
# fewer rounds than the pillar steps' WARMUP / REPEAT
SPARSE_WARMUP, SPARSE_REPEAT = 2, 8


def bwd_counters():
    """The launch counters of the window conv's four kernel paths."""
    from det3d_tpu_torch.ops import window_conv_cuda as wc
    return {n: getattr(wc, n) for n in TRAIN_LAUNCHES["second"]}


def launch_counts():
    return {n: f.launches for n, f in bwd_counters().items()}


def reset_launches():
    for f in bwd_counters().values():
        f.launches = 0


def sparse_train_scene(key, b, pc_range, points, seed=SEED):
    """train_scene scans for a sparse path: CBGS's with a fifth point
    feature (the sweep time, zero) and 9-dim gt boxes (velocities zero)."""
    scene = train_scene(b, points, pc_range, TRAIN_GT, TRAIN_MAX_GT,
                        seed=seed)
    if key == "cbgs":
        scene["points"] = np.concatenate(
            [scene["points"], np.zeros_like(scene["points"][..., :1])], -1)
        gt = np.zeros(scene["gt_boxes"].shape[:2] + (9,), np.float32)
        gt[..., :7] = scene["gt_boxes"]
        scene["gt_boxes"] = gt
    return scene


def with_train_plan(key, scene, cfg=None, ref=False):
    """The scene with the host training plan and host voxels of
    host_plan_fn(train=True, voxelize=True) (host_plan_ref_fn with
    ``ref``), as a trainer's input pipeline builds them."""
    from det3d_tpu_torch.apis.train import (build_stack, host_plan_fn,
                                            host_plan_ref_fn)
    model, vg = build_stack(cfg or train_config(key), device="cpu")[:2]
    fn = (host_plan_ref_fn if ref else host_plan_fn)(model, vg, train=True,
                                                     voxelize=True)
    return dict(scene, **fn(scene["points"], scene["num_points"]))


def bwd_cases(plan, dev, layers):
    """conv_cases of a sparse middle's training plan, each with its
    inverse rulebook (strided convs), a random dy and the kernel's
    (kz, ky, kx) and stride."""
    g = torch.Generator().manual_seed(1)
    out = []
    for (name, x, pk, w, subm), (key, *_) in zip(
            conv_cases(plan, dev, torch.float32, layers), layers):
        inv = (None if subm else torch.as_tensor(
            plan[f"plan_{key.replace('down', 'inv')}"],
            device=dev).contiguous())
        dy = torch.randn(pk.shape[0], pk.shape[1], w.shape[-1],
                         generator=g).to(dev)
        out.append((name, x, pk, w, subm, inv, dy))
    return out


def bwd_work(x, pk, w, subm, dy, words):
    """(bytes, flops) of each backward path at one layer: the forward's
    products (conv_work) over the same (row, tap) pairs; bytes, each input
    read once and each output written once, whatever the kernel keeps
    between its passes: dW reads the rows the taps reach, the plan and dy
    (the forward's output size) and writes dW (the weights' size):
    conv_work's bytes; dX reads dy, its rulebook's ``words`` (the
    inverse's for a strided conv) and the weights and writes dX."""
    nbytes, flops, _ = conv_work(x, pk, w, subm)
    dx = (dy.numel() * 4 + words.numel() * 4 + w.numel() * 4
          + x.numel() * 4)
    return {"dw": (nbytes, flops), "dx": (dx, flops)}


def _gather_width(c):
    """Row width of an im2col gather of c fp32 channels: 2 zero channels
    more where a row is a multiple of 16 bytes (im2col_matmul, gather_ms:
    index_select of such rows is an order of magnitude slower)."""
    return c + (2 if c % 4 == 0 else 0)


def dw_im2col_mm(x, pk, dy, subm):
    """Phase 58's dW yardstick, which the port never calls: every output
    row's kz*K taps gathered into an im2col matrix (B*O, kvol*Cin), a zero
    row where a tap reads none, and one torch.mm of its transpose with dY
    (B*O, Cout), fp32. Returns fn() -> (kvol, Cin, Cout); the gather index
    is made once, outside fn, as a plan would hold it."""
    b, v, cin = x.shape
    o = pk.shape[1]
    cout = dy.shape[-1]
    rows, sel = tap_rows(pk, v, subm)                  # (B, O, K, kz)
    kvol = rows.shape[2] * rows.shape[3]
    base = torch.arange(b, device=rows.device).view(b, 1, 1, 1) * (v + 1)
    idx = torch.where(sel, base + rows, base + v).transpose(2, 3).reshape(-1)
    width = _gather_width(cin)
    xpad = x.new_zeros(b, v + 1, width)
    xpad[:, :v, :cin] = x
    xpad = xpad.reshape(b * (v + 1), width)
    dyf = dy.reshape(b * o, cout)

    def fn():
        cols = xpad.index_select(0, idx).view(b * o, kvol * width)
        return torch.mm(cols.t(), dyf).view(kvol, width, cout)[:, :cin]
    return fn


def inv_im2col_mm(dy, inv, w, kernel, stride):
    """Phase 58's inverse-dX yardstick, which the port never calls: every
    input row's kvol taps' dY rows gathered into (B*V, kvol*Cout), a zero
    row where the tap's parity does not match the row's or its candidate
    is absent (window_conv_inv_ref's rules), and one torch.mm with the
    stacked W^T (kvol*Cout, Cin), fp32. Returns fn() -> (B, V, Cin)."""
    from det3d_tpu_torch.ops.sparse import ncand_of, unpack_inverse
    b, o, cout = dy.shape
    kvol, cin, _ = w.shape
    v = inv.shape[1]
    nc = ncand_of(kernel, stride)
    r0i, presi, par = unpack_inverse(inv, nc[0])
    r0c = torch.clamp(r0i, max=max(o - 1, 0))
    base = torch.arange(b, device=inv.device).view(b, 1) * (o + 1)
    ky, kx = kernel[1], kernel[2]
    idx = []
    for kk in range(kvol):
        j = (kk // (ky * kx), (kk // kx) % ky, kk % kx)
        cz, cy, cx = (j[d] // stride[d] for d in range(3))
        ci, m = cy * nc[2] + cx, nc[0] - 1 - cz
        row = r0c[..., ci] + presi[..., ci, :m].sum(-1)
        ok = presi[..., ci, m] & (row < o)
        for d in range(3):
            ok = ok & (par[..., d] == j[d] % stride[d])
        idx.append(torch.where(ok, base + row, base + o))
    idx = torch.stack(idx, -1).reshape(-1)
    width = _gather_width(cout)
    dypad = dy.new_zeros(b, o + 1, width)
    dypad[:, :o, :cout] = dy
    dypad = dypad.reshape(b * (o + 1), width)
    wst = w.new_zeros(kvol, width, cin)
    wst[:, :cout] = w.transpose(1, 2)
    wst = wst.reshape(kvol * width, cin)

    def fn():
        cols = dypad.index_select(0, idx).view(b * v, kvol * width)
        return torch.mm(cols, wst).view(b, v, cin)
    return fn


_BWD_PTXAS = []       # phase 58 prints the backward kernels' ptxas once


def bwd_ptxas(label):
    """The backward kernels' registers and spills (nvcc -Xptxas -v, kept
    beside the library), once a process."""
    from det3d_tpu_torch import csrc
    if _BWD_PTXAS:
        return
    _BWD_PTXAS.append(label)
    csrc.load("window_conv_bwd")                   # builds it, with its log
    logf = csrc.build_log("window_conv_bwd")
    report = ptxas_report(logf.read_text()) if logf.is_file() else {}
    for kern, (regs, st, ld) in sorted(report.items()):
        log(f"{label} ptxas window_conv_bwd: {kern}: {regs} registers, "
            f"spill stores {st} B, spill loads {ld} B")
    if not report:
        log(f"{label} ptxas window_conv_bwd: no -Xptxas -v output kept")


def phase_bwd_kernels(dev, plan, layers, label, smi, yard=False):
    """Phase 58: the backward kernels against their plain twins on a
    training plan, at every conv of a sparse middle: dW (window_conv_dw,
    both conv kinds) within BWD_TOL of window_conv_dw_ref (dy scaled by
    1/sqrt(B*O), so that dW is of order one) and bit-equal on a second
    call; dX of the subm convs after the stem (window_conv_subm_dx, the
    forward kernel) within BWD_TOL of window_conv_ref with mirrored,
    transposed weights; dX of the strided convs (window_conv_inv) within
    BWD_TOL of window_conv_inv_ref and bit-equal on a second call. Each
    kernel's time: a call from Python (cuda_ms), on the device (graph_ms),
    the twin's, the bound and the share of it; with ``yard`` also the
    im2col + torch.mm yardstick's device time (dw_im2col_mm,
    inv_im2col_mm; held to the twin within BWD_TOL). The backward kernels'
    registers and spills once (bwd_ptxas). Returns {kernel: {"err", "ms",
    "device", "plain", "yard", "bound_ms", "bound_by"}} summed over the
    layers."""
    from det3d_tpu_torch.ops import sparse as sp
    from det3d_tpu_torch.ops.window_conv_cuda import (
        window_conv_dw, window_conv_inv, window_conv_subm_dx)
    bwd_ptxas(label)
    tot = {k: {"err": 0.0, "ms": 0.0, "device": 0.0, "plain": 0.0,
               "yard": 0.0, "bytes": 0, "flops": 0}
           for k in ("dw", "subm_dx", "inv")}
    for name, x, pk, w, subm, inv, dy in bwd_cases(plan, dev, layers):
        b, o, k = pk.shape
        r0, pres = sp.unpack_windows(pk, 3)
        dys = dy / (b * o) ** 0.5
        work = bwd_work(x, pk, w, subm, dy, pk if subm else inv)
        got = window_conv_dw(x, pk, dys, subm)
        again = window_conv_dw(x, pk, dys, subm)
        ref = sp.window_conv_dw_ref(x, r0, pres, dys, subm)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if not torch.allclose(got, ref, **BWD_TOL):
            raise AssertionError(f"{label} {name}: dW kernel vs plain {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"{label} {name}: dW differs between two "
                                 f"calls")
        runs = [("dw", lambda: window_conv_dw(x, pk, dys, subm),
                 lambda: sp.window_conv_dw_ref(x, r0, pres, dys, subm),
                 (lambda: dw_im2col_mm(x, pk, dys, subm)) if yard else None,
                 err, ref, work["dw"])]
        if subm and w.shape[1] >= 16:
            wt = w.flip(0).transpose(1, 2).contiguous()
            got = window_conv_subm_dx(dy, pk, w)
            ref = sp.window_conv_ref(dy, r0, pres, wt, True)
            kind = "subm_dx"
            plain = (lambda: sp.window_conv_ref(dy, r0, pres, wt, True))
            fn = (lambda: window_conv_subm_dx(dy, pk, w))
            make_yard = None
        elif not subm:
            v = x.shape[1]
            geo = ((3, 3, 3) if k == 9 else (3, 1, 1),
                   (2, 2, 2) if k == 9 else (2, 1, 1))
            r0i, presi, par = sp.unpack_inverse(inv, 2)
            got = window_conv_inv(dy, inv, w, *geo, v)
            again = window_conv_inv(dy, inv, w, *geo, v)
            ref = sp.window_conv_inv_ref(dy, r0i, presi, par, w, *geo)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{label} {name}: inverse dX differs "
                                     f"between two calls")
            kind = "inv"
            plain = (lambda: sp.window_conv_inv_ref(dy, r0i, presi, par, w,
                                                    *geo))
            fn = (lambda: window_conv_inv(dy, inv, w, *geo, v))
            make_yard = ((lambda: inv_im2col_mm(dy, inv, w, *geo))
                         if yard else None)
        else:
            kind = None
        if kind:
            torch.cuda.synchronize()
            if not bool(ref.abs().max() > 0):
                raise AssertionError(f"{label} {name}: {kind} is all zero")
            e = float((got - ref).abs().max())
            if not torch.allclose(got, ref, **BWD_TOL):
                raise AssertionError(f"{label} {name}: {kind} kernel vs "
                                     f"plain {e}")
            runs.append((kind, fn, plain, make_yard, e, ref, work["dx"]))
        for kind, fn, plain, make_yard, e, ref, (nbytes, flops) in runs:
            t = tot[kind]
            ms, dev_ms = cuda_ms(fn), graph_ms(fn)
            p_ms = cuda_ms(plain, warmup=1, repeat=3)
            b_ms, b_by = bound(nbytes, flops, FP32_FLOPS)
            y_txt = ""
            if make_yard is not None:
                yfn = make_yard()
                y_err = float((yfn() - ref).abs().max())
                if not torch.allclose(yfn(), ref, **BWD_TOL):
                    raise AssertionError(f"{label} {name}: {kind} im2col+mm "
                                         f"vs plain {y_err}")
                y_ms = graph_ms(yfn)
                t["yard"] += y_ms
                y_txt = (f", im2col+mm {y_ms:.4f} ms on the device (max abs "
                         f"err {y_err:.2e}; never called by the port)")
                del yfn
            t["err"] = max(t["err"], e)
            t["ms"] += ms
            t["device"] += dev_ms
            t["plain"] += p_ms
            t["bytes"] += nbytes
            t["flops"] += flops
            log(f"{label} {kind} {name} B={b} O={o}: kernel vs plain max "
                f"abs err {e:.2e} (tolerance {BWD_TOL})"
                + (", bit-equal on a second call" if kind != "subm_dx"
                   else "")
                + f"; a call {ms:.4f} ms, on the device {dev_ms:.4f} ms, "
                f"plain {p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
                f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB), "
                f"{b_ms / dev_ms:.3f} of the bound" + y_txt + f" [{smi}]")
    for kind, t in tot.items():
        ran = t["bytes"] > 0            # the stem alone runs dW only
        t["bound_ms"], t["bound_by"] = bound(t.pop("bytes"), t.pop("flops"),
                                             FP32_FLOPS)
        if not ran:
            continue
        log(f"{label} {kind} over the middle's layers: a call {t['ms']:.4f} "
            f"ms, device {t['device']:.4f} ms, plain {t['plain']:.3f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
            f"{t['bound_ms'] / t['device']:.3f} of the bound, max abs err "
            f"{t['err']:.2e}"
            + (f", im2col+mm {t['yard']:.4f} ms on the device"
               if t["yard"] else "") + f" [{smi}]")
    return tot


def phase_train_plans(dev, key, name, scene, data):
    """Phase 59: the training plans of a sparse path's scene: the native
    host build (host_plan_fn(train=True), in ``data``) equal to the numpy
    build (host_plan_ref_fn) in every key, and the device voxels and
    build_plan_device(train=True) on the card equal to the host's, the
    inverse rulebooks inv{i} among the keys."""
    from det3d_tpu_torch.apis.train import build_stack
    from det3d_tpu_torch.models.backbones import (build_plan_device,
                                                  middle_plan_spec)
    label = f"phase 59 {name}"
    t = time.perf_counter()
    ref = with_train_plan(key, scene, ref=True)
    t = time.perf_counter() - t
    for k in data:
        if not np.array_equal(np.asarray(data[k]), np.asarray(ref[k])):
            raise AssertionError(f"{label}: native {k} differs from numpy's")
    inv = sorted(k for k in data if k.startswith("plan_inv"))
    model, vg = build_stack(train_config(key), device="cpu")[:2]
    spec = middle_plan_spec(model.backbone, vg.grid_size, vg.max_voxels)
    pts = torch.as_tensor(scene["points"], device=dev)
    n = torch.as_tensor(scene["num_points"], device=dev)
    vox = vg.generate_batch(pts, n)
    plan = build_plan_device(vox["coords"], spec, train=True)
    check_voxels(vox, data, label)
    want = sorted(k[5:] for k in data if k.startswith("plan_"))
    if sorted(plan) != want:
        raise AssertionError(f"{label}: device plan keys {sorted(plan)}, "
                             f"host {want}")
    for k, v in plan.items():
        if not np.array_equal(v.cpu().numpy(), data[f"plan_{k}"]):
            raise AssertionError(f"{label}: device plan {k} differs")
    log(f"{label} training plans B={pts.shape[0]}: native host build equal "
        f"to numpy's in all {len(data)} keys (numpy {t:.1f} s), device "
        f"voxels and build_plan_device(train=True) equal to the host's in "
        f"all {len(plan)} plan keys, inverse rulebooks {inv}")


def grads_rel(gd, gc_, names):
    """{name: relative L2 of the card's gradient against the CPU's}."""
    return {n: rel_l2(a, b) for n, a, b in zip(names, gd, gc_)}


def zero_grad_bias(names):
    """Conv biases that feed a training-mode BN: their gradient is zero in
    exact arithmetic (the BN subtracts the batch mean), so what either
    side computes is rounding, compared by its size alone."""
    return {n for n in names if n.endswith(".bias") and ".norm." not in n
            and "Conv" in n and "backbone" in n}


def step_card_vs_cpu(dev, label, stacks, batch, smi):
    """One eager train step on the card and on the CPU from the same
    weights and batch (``stacks(device)``: the (model, voxel_gen,
    assigners, class ids, TrainState) on ``device``): the loss within
    TRAIN_LOSS_REL, every gradient within SPARSE_GRAD_REL relative L2 (the
    head's within SPARSE_HEAD_REL) but the conv biases before a training
    BN (zero_grad_bias), which must be below 1e-4 of their layer's weight
    gradient; the stem's figure printed."""
    from det3d_tpu_torch.parallel.train import make_train_step
    runs = {}
    for device in (dev, "cpu"):
        model, vg, asg, cids, state = stacks(device)
        seen = spy_grads(state)
        t = time.perf_counter()
        m = make_train_step(state, vg, asg, cids).eager(batch)
        if device != "cpu":
            torch.cuda.synchronize()
        runs[str(device)] = (m, seen[0], model, time.perf_counter() - t)
    (md, gd, model_d, t_d), (mc, gc_, model_c, t_c) = (runs[str(dev)],
                                                       runs["cpu"])
    names = [n for n, _ in model_c.named_parameters()]
    errs = grads_rel(gd, gc_, names)
    zb = zero_grad_bias(names)
    norms = {n: float(g.norm()) for n, g in zip(names, gc_)}
    bias_worst = max((max(float(a.norm()), float(b.norm()))
                      / max(norms[n.rsplit(".", 1)[0] + ".weight"], 1e-30), n)
                     for n, a, b in zip(names, gd, gc_) if n in zb) \
        if zb else (0.0, None)
    checked = {n: e for n, e in errs.items() if n not in zb}
    worst = max(checked, key=checked.get)
    head = {n: e for n, e in checked.items() if n.startswith("bbox_head")}
    head_worst = max(head, key=head.get)
    stem = [n for n in names if "SparseConvBN_0.weight" in n][0]
    loss_err = abs(float(md["loss"]) - float(mc["loss"])) / abs(
        float(mc["loss"]))
    log(f"{label} one train step B={batch['points'].shape[0]} card (eager, "
        f"{t_d * 1e3:.1f} ms with its first call's set-up) vs CPU "
        f"({t_c:.2f} s): loss {float(md['loss']):.6f} / "
        f"{float(mc['loss']):.6f} (rel err {loss_err:.2e}, tolerance "
        f"{TRAIN_LOSS_REL}); gradients relative L2 worst "
        f"{checked[worst]:.3e} ({worst}), median "
        f"{statistics.median(checked.values()):.3e}, the sparse stem's "
        f"weight {errs[stem]:.3e} (tolerance {SPARSE_GRAD_REL}); the head's "
        f"worst {head[head_worst]:.3e} ({head_worst}; tolerance "
        f"{SPARSE_HEAD_REL}); "
        f"{len(zb)} conv biases before a training BN at most "
        f"{bias_worst[0]:.2e} of their weight gradient's norm [{smi}]")
    if loss_err > TRAIN_LOSS_REL:
        raise AssertionError(f"{label}: loss card vs CPU {loss_err}")
    if checked[worst] > SPARSE_GRAD_REL:
        raise AssertionError(f"{label}: gradient {worst} card vs CPU "
                             f"{checked[worst]}")
    if head[head_worst] > SPARSE_HEAD_REL:
        raise AssertionError(f"{label}: head gradient {head_worst} card vs "
                             f"CPU {head[head_worst]}")
    if bias_worst[0] > 1e-4:
        raise AssertionError(f"{label}: gradient of {bias_worst[1]} is not "
                             f"zero: {bias_worst[0]}")


def phase_sparse_step(dev, key, name, data, smi, cut=None):
    """Phase 60 (62 CBGS): one eager train step on the card and on the
    CPU from the same weights and host training plan (step_card_vs_cpu;
    ``cut``: the comparison on that (config, batch) instead). Then on the
    full batch the window-conv kernels' launches of one eager step
    (TRAIN_LAUNCHES). Returns the launch counts."""
    from det3d_tpu_torch.parallel.train import make_train_step
    label = f"phase {60 if key == 'second' else 62} {name}"
    cfg, batch = cut or (train_config(key), data)
    step_card_vs_cpu(dev, label, lambda d: train_stack(key, d, cfg=cfg),
                     batch, smi)
    if cut is not None:
        model, vg, asg, cids, state = train_stack(key, dev)
        make_train_step(state, vg, asg, cids).eager(data)
    reset_launches()
    model, vg, asg, cids, state = train_stack(key, dev)
    m = make_train_step(state, vg, asg, cids).eager(data)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"{label} launches of one eager train step B="
        f"{data['points'].shape[0]}: {counts} (expected "
        f"{TRAIN_LAUNCHES[key]}); loss {float(m['loss']):.4f}")
    if counts != TRAIN_LAUNCHES[key]:
        raise AssertionError(f"{label}: launches {counts}, expected "
                             f"{TRAIN_LAUNCHES[key]}")
    if not bool(torch.isfinite(m["loss"])):
        raise AssertionError(f"{label}: loss not finite")
    return counts


def phase_captured_train(dev, key, name, data, smi):
    """Phase 60 (62): EAGER_STEPS captured steps (make_train_step as a user
    calls it) against as many eager steps from the same weights: loss and
    grad_norm of every step within CAPTURED_REL. Both run with cuDNN's
    deterministic algorithms: a default weight-gradient algorithm may sum
    with atomics in an order that changes from run to run (the conv3d
    tail's wgrad_alg1_nd did, before the tail ran as window convs), and
    Adam turns the near-zero gradients that moves into steps of the
    learning rate (two eager runs drift apart as far)."""
    from det3d_tpu_torch.parallel.graph import CapturedStep
    from det3d_tpu_torch.parallel.train import make_train_step
    label = f"phase {60 if key == 'second' else 62} {name}"
    out = {}
    torch.backends.cudnn.deterministic = True
    for how in ("eager", "captured"):
        model, vg, asg, cids, state = train_stack(key, dev)
        step = make_train_step(state, vg, asg, cids)
        if not isinstance(step, CapturedStep):
            raise AssertionError(f"{label}: the step is not captured")
        run = step.eager if how == "eager" else step
        out[how] = [{k: float(v) for k, v in run(data).items()
                     if k in ("loss", "grad_norm")}
                    for _ in range(EAGER_STEPS)]
        del model, state, step
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    worst = max(abs(c[k] - e[k]) / max(abs(e[k]), 1e-12)
                for e, c in zip(out["eager"], out["captured"])
                for k in ("loss", "grad_norm"))
    log(f"{label} captured vs eager over {EAGER_STEPS} steps: losses "
        + " / ".join(f"{e['loss']:.6f} {c['loss']:.6f}"
                     for e, c in zip(out["eager"], out["captured"]))
        + f"; loss and grad_norm worst rel err {worst:.2e} (tolerance "
        f"{CAPTURED_REL}; cuDNN deterministic) [{smi}]")
    if worst > CAPTURED_REL:
        raise AssertionError(f"{label}: captured vs eager {worst}")


def phase_points_train(dev, key, name, scene, data, smi):
    """Phase 61 (62): the train step fed points alone (device voxels and
    build_plan_device(train=True) inside the step) against the step fed
    the host plan, one eager step each from the same weights: the loss
    within TRAIN_LOSS_REL and every gradient within POINTS_REL (the plans
    are equal, phase 59); then one captured step from points."""
    from det3d_tpu_torch.parallel.train import make_train_step
    label = f"phase {61 if key == 'second' else 62} {name} from points"
    grads, losses = [], []
    for batch in (data, scene):
        model, vg, asg, cids, state = train_stack(key, dev)
        seen = spy_grads(state)
        losses.append(float(make_train_step(state, vg, asg, cids).eager(
            batch)["loss"]))
        grads.append(seen[0])
        names = [n for n, _ in model.named_parameters()]
    zb = zero_grad_bias(names)
    errs = {n: e for n, e in grads_rel(grads[1], grads[0], names).items()
            if n not in zb}
    worst = max(errs, key=errs.get)
    loss_err = abs(losses[1] - losses[0]) / abs(losses[0])
    model, vg, asg, cids, state = train_stack(key, dev)
    step = make_train_step(state, vg, asg, cids)
    cap = float(step(scene)["loss"])
    log(f"{label}: one eager step from points vs from the host plan, loss "
        f"{losses[1]:.6f} / {losses[0]:.6f} (rel err {loss_err:.2e}), "
        f"gradients worst relative L2 {errs[worst]:.2e} ({worst}), median "
        f"{statistics.median(errs.values()):.2e} (tolerance "
        f"{POINTS_REL}); a captured step from points: loss {cap:.6f} "
        f"[{smi}]")
    if loss_err > TRAIN_LOSS_REL or errs[worst] > POINTS_REL:
        raise AssertionError(f"{label}: from points vs host plan: loss "
                             f"{loss_err}, {worst} {errs[worst]}")
    if not np.isfinite(cap):
        raise AssertionError(f"{label}: captured loss not finite")


def conv_shape_table(run, label, smi, top=10):
    """The convolutions of one eager step by input shapes under
    torch.profiler (record_shapes): the forward (aten::convolution) and
    the backward (aten::convolution_backward: dgrad and wgrad in one op)
    of each cuDNN conv, device ms a step, largest first. It names the
    shapes at which cuDNN's fp32 algorithms (TF32 off) take the step's
    time; routes around them are a later change."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        run()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key in ("aten::convolution", "aten::convolution_backward"):
            t = getattr(e, "device_time_total",
                        getattr(e, "cuda_time_total", 0.0)) / 1e3
            rows.append((t, e.count, e.key, str(e.input_shapes)[:110]))
    total = sum(r[0] for r in rows)
    log(f"{label} convolutions of one eager step by input shape "
        f"(torch.profiler): {total:.3f} ms in all [{smi}]")
    for t, n, key, shapes in sorted(rows, reverse=True)[:top]:
        log(f"{label}   {t:8.3f} ms x{n:<3d} {key[6:]:22s} {shapes}")


def sparse_training_phases(dev, smi):
    """Phases 58-62: the backward kernels against their twins (58) and
    the training plans (59) of SECOND and CBGS, SECOND's train step from
    host plans (60: card vs CPU, launches, captured vs eager, timing, the
    overfit) and from points (61), CBGS's step (62: card vs CPU on the
    +-CBGS_CUT m cut, launches, captured vs eager, from points, timing).
    Returns the kernels' JSON entries."""
    from det3d_tpu_torch.parallel.train import make_train_step
    layers = {"second": SECOND_LAYERS, "cbgs": CBGS_LAYERS}
    kern, launches, times = {}, {}, {}
    for key, name, b, points in SPARSE_TRAIN:
        pc = train_config(key)["voxel_generator"]["range"]
        scene = sparse_train_scene(key, b, pc, points)
        data = with_train_plan(key, scene)
        tail = tail_plan(detector_of(train_config(key)), data, dev,
                         train=True)
        kern[key] = phase_bwd_kernels(dev, dict(data, **tail), layers[key],
                                      f"phase 58 {name}", smi, yard=True)
        del tail
        phase_train_plans(dev, key, name, scene, data)
        cut = None
        if key == "cbgs":
            ccfg = cbgs_config(cut=True)
            cscene = sparse_train_scene(key, b, ccfg["voxel_generator"][
                "range"], 60000)
            cut = (ccfg, with_train_plan(key, cscene, cfg=ccfg))
        launches[key] = phase_sparse_step(dev, key, name, data, smi, cut)
        phase_captured_train(dev, key, name, data, smi)
        phase_points_train(dev, key, name, scene, data, smi)
        label = f"phase {60 if key == 'second' else 62} {name}"
        times[key] = phase_train_timing(dev, key, name, data, smi,
                                        label=label, warmup=SPARSE_WARMUP,
                                        repeat=SPARSE_REPEAT)
        CAPTURED_MS[key] = times[key]["captured"]
        model, vg, asg, cids, state = train_stack(key, dev)
        step = make_train_step(state, vg, asg, cids)
        conv_shape_table(lambda: step.eager(data), label, smi)
        del model, state, step
        if key == "second":
            phase_overfit(dev, key, name, smi, label=f"phase 60 {name}")
        gc.collect()
        torch.cuda.empty_cache()
    for key, name, b, _ in SPARSE_TRAIN:
        t = times[key]
        log(f"sparse train steps: {name} B={b} from host plans: eager "
            f"{t['eager']:.3f} ms/step, captured {t['captured']:.3f}; from "
            f"the card eager {t['on_card']['eager']:.3f}, captured "
            f"{t['on_card']['captured']:.3f}; split {t['split']}; memory: "
            f"eager peak {t['peak'][0] / 2**30:.2f} GiB, captured pool "
            f"reserved {t['peak'][1] / 2**30:.2f} GiB; window-conv launches "
            f"a step {launches[key]} [{smi}]")
    return [e for key, _, _, _ in SPARSE_TRAIN
            for e in bwd_entries(f"{key}_train", kern[key], launches[key])]


def bwd_entries(path, kern, launches):
    """The JSON line's entries of a train path's backward kernels: dW and
    the inverse dX (window_conv_bwd.cu) and the subm dX (the forward
    kernel), from phase_bwd_kernels' sums ``kern`` and the path's launch
    counts ``launches``."""
    from det3d_tpu_torch.ops.window_conv_cuda import (window_conv_dw,
                                                      window_conv_inv)
    src = dict(route="cuda", source="det3d_tpu_torch/csrc/window_conv_bwd.cu",
               library_ms=None)
    out = []
    for kind, fn, rep in (("dw", window_conv_dw,
                           "det3d_tpu/ops/sparse.py:883"),
                          ("inv", window_conv_inv,
                           "det3d_tpu/ops/sparse.py:1033")):
        t = kern[kind]
        out.append(dict(
            src, name=fn.__name__, replaces=rep, path=path, dtype="fp32",
            launches=launches[fn.__name__], max_abs_err=t["err"], ms=t["ms"],
            device_ms=t["device"], plain_ms=t["plain"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"]))
    t = kern["subm_dx"]
    out.append(dict(
        name="window_conv", route="cuda",
        source="det3d_tpu_torch/csrc/window_conv.cu",
        replaces="det3d_tpu/ops/band_conv.py:216", path=f"{path}_subm_dx",
        dtype="fp32", launches=launches["window_conv_subm_dx"],
        max_abs_err=t["err"], ms=t["ms"], device_ms=t["device"],
        plain_ms=t["plain"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=None))
    return out


# ---------------------------------------------------------------------------
# The data path, the trainer and the KITTI evaluation (phases 63-66)
# ---------------------------------------------------------------------------

DATA_SCENES = 16        # phase 64's tree, the learning gates' (16 scenes)
# phase 65's tree: 32 train scans, so that an epoch of the shipped configs
# runs 16 (KITTI car PointPillars, B=2) or 8 (SECOND, B=4) steps
API_SCENES = 64
AREA_TOL = 1e-6         # pointops.cc's areas against the numpy twin
HOST_REPS = 20          # host timings: median of 20 calls
LOADER_EPOCHS = 4       # phase 64's loader timing, after two epochs
# phase 65: the shipped configs through train_detector / eval_detector
API_PATHS = (("kitti_pp", "KITTI car PointPillars", KITTI_PP_CFG),
             ("second", "SECOND", SECOND_CFG))
# the learning gates of tests/test_learning_quality.py: the recipe and
# the thresholds (Car_3d_easy_loose, Car_bbox_easy)
GATE_EPOCHS = 150
GATES = (("pp", "PointPillars", "mini_config", (70.0, 40.0)),
         ("second", "SECOND", "mini_second_config", (60.0, 40.0)))
# phases 55 and 60: the captured train step's ms/step from numpy, by key
CAPTURED_MS = {}


def host_ms(fn, reps=HOST_REPS):
    """Median ms of ``reps`` calls of ``fn()`` on the host's clock."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def same_tree(a, b):
    """Equal nested dicts / lists / arrays (dtypes included) / scalars."""
    if isinstance(b, dict):
        return (isinstance(a, dict) and sorted(a) == sorted(b)
                and all(same_tree(a[k], b[k]) for k in b))
    if isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(map(same_tree, a, b))
    if isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def same_batches(ours, ref, label):
    """Batches equal key for key (dtypes, values, metadata)."""
    if len(ours) != len(ref):
        raise AssertionError(f"{label}: {len(ours)} batches, {len(ref)}")
    for i, (a, b) in enumerate(zip(ours, ref)):
        bad = [k for k in set(a) | set(b)
               if k not in a or k not in b or not same_tree(a[k], b[k])]
        if bad:
            raise AssertionError(f"{label}: batch {i} differs in {bad}")


def phase_pointops(root):
    """Phase 63: csrc/pointops.cc (built with the rest in phase 2) against
    its numpy twins (core/augment.py) on GT-AUG's inputs from the tree at
    ``root``: a train scene's points in its 6 boxes and the 15 pasted
    from the gt database; the 21 boxes' BEV collisions; the scene's boxes
    against every database box, and noise_per_object's 100 tries of one
    box against the other 20, as paired intersection areas."""
    import pickle
    from det3d_tpu_torch.core import augment as aug
    from det3d_tpu_torch.datasets import build_dataset
    with open(root / "dbinfos_train.pkl", "rb") as f:
        db = np.stack([d["box3d_lidar"] for d in pickle.load(f)["Car"]])
    scene = build_dataset(dict(
        type="KittiDataset", root_path=str(root), test_mode=True,
        info_path=str(root / "kitti_infos_train.pkl"),
        pipeline=[dict(type="LoadPointCloudFromFile"),
                  dict(type="LoadPointCloudAnnotations")]))[0]["lidar"]
    pts = scene["points"]
    rng = np.random.RandomState(SEED)
    boxes = np.concatenate([scene["annotations"]["boxes"],
                            db[rng.choice(len(db), 15, replace=False)]])
    bev = boxes[:, [0, 1, 3, 4, 6]]
    tries = np.repeat(bev[:1], 100, 0)
    tries[:, :2] += rng.normal(0, 0.25, (100, 2))
    tries[:, 4] += rng.uniform(-0.15, 0.15, 100)
    others = aug.corners_bev(bev[1:])
    scene_c = aug.corners_bev(bev[:6])
    db_c = aug.corners_bev(db[:, [0, 1, 3, 4, 6]])
    ca = np.concatenate([np.repeat(aug.corners_bev(tries), 20, 0),
                         np.repeat(scene_c, len(db_c), 0)])
    cb = np.concatenate([np.tile(others, (100, 1, 1)),
                         np.tile(db_c, (6, 1, 1))])
    cases = (("points_in_rbbox", f"{len(pts)} points x {len(boxes)} boxes",
              lambda: aug.points_in_rbbox(pts, boxes),
              lambda: aug.points_in_rbbox_ref(pts, boxes)),
             ("box_collision", f"{len(bev)} x {len(bev)} BEV boxes",
              lambda: aug.box_collision(bev, bev),
              lambda: aug.box_collision_ref(bev, bev)),
             ("intersection_area", f"{len(ca)} pairs",
              lambda: aug.intersection_area(ca, cb),
              lambda: aug.intersection_area_corners(ca, cb)))
    cpu = cpu_model()
    for name, shape, native, twin in cases:
        a, b = native(), twin()
        if name == "intersection_area":
            err = float(np.abs(a - b).max())
            if err > AREA_TOL:
                raise AssertionError(f"phase 63 {name}: {err} from the "
                                     f"numpy twin (limit {AREA_TOL})")
            what = f"max abs {err:.3g} from the twin, {(a > 0).sum()} > 0"
        else:
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"phase 63 {name}: the native result "
                                     "differs from the numpy twin")
            what = f"array-equal to the twin, {int(a.sum())} true"
        log(f"phase 63 pointops {name} ({shape}): {what}; native "
            f"{host_ms(native):.4f} ms a call, numpy twin "
            f"{host_ms(twin):.4f} ms [host: {cpu}]")


def mini_dataset(root, config, split, host_plan=False, seed=0):
    """A split of utils/mini_kitti.py's ``config`` (its name) over the
    tree at ``root``, built under np.random.seed(seed), and the config;
    with ``host_plan`` the HostPlan stage injected from the model's spec
    (the model built on the CPU: only its shapes are read). Returns
    (dataset, config)."""
    from det3d_tpu_torch.apis.train import build_stack, inject_host_plan
    from det3d_tpu_torch.datasets import build_dataset
    from det3d_tpu_torch.utils import mini_kitti as mk
    cfg = getattr(mk, config)(str(root), workers=2)
    if host_plan:
        model, vg = build_stack(cfg, device="cpu")[:2]
        if not inject_host_plan(cfg, model, vg, split=split,
                                train=split == "train"):
            raise AssertionError(f"{config}: no HostPlan stage injected")
    np.random.seed(seed)
    return build_dataset(cfg["data"][split]), cfg


def phase_data_path(root, smi):
    """Phase 64: the train pipelines of the gates' configs (mini_config,
    mini_second_config with the HostPlan stage) on the tree at ``root``
    through the loader's 2 fork workers, two epochs: equal to replay (each
    worker's share in-process, from its seed and its copy of the dataset);
    SECOND's batches carry the training plans, equal to the numpy build
    of their points; the loader's ms/batch with 2 workers over
    LOADER_EPOCHS more epochs, and the pipeline's ms/example in-process."""
    from det3d_tpu_torch.apis.train import build_stack, host_plan_ref_fn
    from det3d_tpu_torch.datasets import build_dataloader
    from det3d_tpu_torch.datasets.loader.loader import replay
    cpu = cpu_model()
    for key, config in (("pp", "mini_config"),
                        ("second", "mini_second_config")):
        ds, cfg = mini_dataset(root, config, "train",
                               host_plan=key == "second")
        loader = build_dataloader(ds, 2, workers_per_gpu=2, seed=0)
        try:
            got = []
            for e in (0, 1):
                loader.set_epoch(e)
                got += list(loader)
            t0 = time.perf_counter()
            n = 0
            for e in range(2, 2 + LOADER_EPOCHS):
                loader.set_epoch(e)
                n += sum(1 for _ in loader)
            batch_ms = (time.perf_counter() - t0) * 1e3 / n
        finally:
            loader.close()
        same_batches(got, replay(loader, (0, 1)), f"phase 64 {key}")
        plans = sorted(k for k in got[0] if k.startswith("plan_"))
        if key == "second":
            model, vg = build_stack(cfg, device="cpu")[:2]
            ref = host_plan_ref_fn(model, vg, train=True)
            for b in got:
                want = ref(b["points"], b["num_points"])
                same_batches([{k: b[k] for k in want}], [want],
                             "phase 64 second plans")
            if not any(k.startswith("plan_inv") for k in plans):
                raise AssertionError("phase 64: no inverse rulebooks")
        elif plans:
            raise AssertionError(f"phase 64 pp: plan keys {plans}")
        np.random.seed(0)
        one = host_ms(lambda: ds[0], reps=8)
        log(f"phase 64 data {key} ({config}): {len(got)} batches of 2 over "
            f"2 epochs on 2 workers equal to their in-process replay; "
            f"{len(plans)} plan keys a batch"
            + (" (equal to host_plan_ref_fn(train=True) of their points)"
               if plans else "")
            + f"; loader {batch_ms:.2f} ms/batch with 2 workers over "
            f"{n} batches, the pipeline {one:.2f} ms/example in-process "
            f"[host: {cpu}]")


def epoch_timer():
    """A runtime hook (runtime/hooks.py): the wall time of an epoch's
    steps after its first (the call's first captures the step; an epoch's
    first waits for its loader's workers), the card synchronized at both
    ends: ``ms`` a step over ``steps`` and ``wall`` over every epoch timed,
    ``epochs`` the ms a step of each (between two synchronizations the
    host may run a step ahead, so a single step's interval says nothing:
    an epoch's mean is the sample)."""
    from det3d_tpu_torch.runtime.hooks import Hook

    class EpochTimer(Hook):
        t0 = ms = steps = wall = None

        def __init__(self):
            self.epochs, self.walls = [], []

        def after_train_iter(self, trainer):
            if trainer.inner_iter == 0:
                torch.cuda.synchronize()
                self.t0 = time.perf_counter()
            elif self.end_of_epoch(trainer):
                torch.cuda.synchronize()
                wall = (time.perf_counter() - self.t0) * 1e3
                self.walls.append((wall, trainer.inner_iter))
                self.epochs.append(wall / trainer.inner_iter)
                self.wall = sum(w for w, _ in self.walls)
                self.steps = sum(n for _, n in self.walls)
                self.ms = self.wall / self.steps

    return EpochTimer()


def device_ms(prof):
    """The CUDA kernels' device time in a torch.profiler profile, ms."""
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")) / 1e3


def api_launches():
    """The NMS kernel's and the window conv's four paths' counters."""
    from det3d_tpu_torch.ops.nms_cuda import rotated_nms_keep
    return dict(launch_counts(), rotated_nms_keep=rotated_nms_keep.launches)


def reset_api_launches():
    from det3d_tpu_torch.ops.nms_cuda import rotated_nms_keep
    reset_launches()
    rotated_nms_keep.launches = 0


def check_launches(label, want):
    got = api_launches()
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    return got


def warm_profiler(dev):
    """A process's first torch.profiler session sets CUPTI up, which takes
    seconds (about 10 s on the H100's host): run one here, outside the
    measured epochs (--only data and --only nusc run no profile before
    phases 65 and 68)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)
    torch.cuda.synchronize()


def phase_api(dev, root, smi):
    """Phase 65: configs/kitti_car_pointpillars.py (bf16 reader and neck)
    and configs/kitti_car_second.py (fp32 in training, the HostPlan stage
    injected) as shipped, KITTI_DATA at the tree at ``root``, through the
    public API: train_detector for one epoch with a work_dir, then
    resume_from it for a second, then eval_detector on val. The official
    result holds Car_3d_easy and every val token; the trainer's step
    count equals the optimizer's on the card after the resume; the
    kernels launched: a train_detector call runs its captured step's
    warm-up (eager) and its capture once, so twice one step's launches
    (TRAIN_LAUNCHES: 14 forward / 9 subm dX / 4 inverse dX / 14 dW for
    SECOND, none for PointPillars), and an eval_detector call twice one
    predict step's (1 NMS, SECOND's 14 window convs), whatever the
    batches (replays count nothing); the trainer's ms/step fed by the
    loader (the first epoch's steps after its first) beside phase 55's /
    60's captured step, the device's busy share over the resumed epoch's
    steps (runtime/hooks.py's ProfilerHook), eval ms/frame."""
    import os
    import tempfile
    from det3d_tpu_torch.apis.train import train_detector
    from det3d_tpu_torch.runtime.hooks import ProfilerHook
    os.environ["KITTI_DATA"] = str(root)
    zero = dict.fromkeys(api_launches(), 0)
    warm_profiler(dev)
    for key, name, path in API_PATHS:
        label = f"phase 65 {name}"
        cfg = (second_config() if key == "second" else pp_config(path))
        cfg["total_epochs"] = 1
        cfg["log_interval"] = 1000
        per_step = TRAIN_LAUNCHES.get(key, dict.fromkeys(
            TRAIN_LAUNCHES["second"], 0))
        train_want = dict(zero, **{k: 2 * v for k, v in per_step.items()})
        with tempfile.TemporaryDirectory() as work:
            reset_api_launches()
            timer = epoch_timer()
            t0 = time.perf_counter()
            tr = train_detector(cfg, work_dir=work, hooks=[timer])
            first_s = time.perf_counter() - t0
            check_launches(f"{label} train_detector", train_want)
            stages = [s["type"] for s in cfg["data"]["train"]["pipeline"]]
            if (key == "second") != (stages[-1] == "HostPlan"):
                raise AssertionError(f"{label}: train stages {stages}")
            steps = tr.iter
            cfg["total_epochs"] = 2
            reset_api_launches()
            # the resumed epoch's steps after its first under
            # runtime/hooks.py's ProfilerHook, timed by a second timer
            # (which stops before the profiler writes its trace)
            timed = epoch_timer()
            prof = ProfilerHook(start=steps + 1, steps=steps - 1,
                                log_dir=str(Path(work) / "profile"))
            tr = train_detector(cfg, work_dir=work, resume_from=work,
                                hooks=[timed, prof])
            check_launches(f"{label} resumed train_detector", train_want)
            count = int(tr.state.step)
            if not (tr.epoch == 2 and tr.iter == count == 2 * steps):
                raise AssertionError(f"{label}: after the resume epoch "
                                     f"{tr.epoch}, iter {tr.iter}, the "
                                     f"optimizer's count {count}")
            reset_api_launches()
            t0 = time.perf_counter()
            results, dets, per_frame = eval_printed(cfg, tr.state, work)
            eval_s = time.perf_counter() - t0
            eval_want = dict(zero, rotated_nms_keep=2, window_conv=(
                2 * SECOND_LAUNCHES if key == "second" else 0))
            check_launches(f"{label} eval_detector", eval_want)
        official = results["detail"]["eval.kitti"]["official"]
        tokens = [str(i) for i in range(API_SCENES // 2, API_SCENES)]
        if "Car_3d_easy" not in official or sorted(dets) != sorted(tokens):
            raise AssertionError(f"{label}: result keys {sorted(official)}"
                                 f"[:5], {len(dets)} val tokens")
        for d in dets.values():
            if not np.isfinite(d["box3d_lidar"]).all():
                raise AssertionError(f"{label}: a detection is not finite")
        captured = CAPTURED_MS.get(key)
        beside = (f"phase {60 if key == 'second' else 55}'s captured step "
                  f"from numpy {captured:.3f} ms/step" if captured else
                  f"phase {60 if key == 'second' else 55} not run")
        share = device_ms(prof.profile) / timed.wall
        busy = (f"{share:.2f} busy ({1 - share:.2f} idle)" if share else
                "not measured (no device time seen)")
        log(f"{label}: train_detector {steps} steps an epoch on {API_SCENES}"
            f" scenes ({first_s:.1f} s the first epoch, the build and "
            f"capture included), resume to epoch {tr.epoch}, optimizer "
            f"count {count} = the trainer's iter; Car_3d_easy "
            f"{official['Car_3d_easy']:.2f} over {len(dets)} val tokens "
            f"(random-init training, 2 epochs); launches a train_detector "
            f"call {train_want}, an eval_detector call {eval_want}")
        log(f"{label}: the trainer fed by the loader (2 workers) "
            f"{timer.ms:.3f} ms/step over {timer.steps} steps beside "
            f"{beside}; the resumed epoch under ProfilerHook "
            f"{timed.ms:.3f} ms/step, the device {busy}; eval_detector "
            f"{eval_s * 1e3 / len(dets):.2f} ms/frame over {len(dets)} "
            f"frames, the build, the capture and the evaluation included, "
            f"its own \"Total time per frame\" {per_frame} ms (the predict "
            f"step and the read-back, the middle third of the batches) "
            f"[{smi}]")
        gc.collect()
        torch.cuda.empty_cache()


def eval_printed(cfg, state, work):
    """eval_detector(cfg, state, work_dir=work), what it prints passed on;
    returns (results, detections, its "Total time per frame" in ms or
    None)."""
    import contextlib
    import io
    from det3d_tpu_torch.apis.train import eval_detector
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results, dets = eval_detector(cfg, state, work_dir=work)
    print(out.getvalue(), end="", flush=True)
    m = re.search(r"Total time per frame: ([0-9.]+) ms", out.getvalue())
    return results, dets, float(m.group(1)) if m else None


def phase_gates(root, smi):
    """Phase 66: tests/test_learning_quality.py's two gates on the card,
    their recipe and thresholds: utils/mini_kitti.py's mini_config and
    mini_second_config over the 16-scene tree at ``root``, 150 epochs,
    B=2, 2 workers, scale_batch_by_devices=False, checkpoint_interval=150,
    then eval_detector on val; PointPillars must reach Car_3d_easy_loose
    > 70 and Car_bbox_easy > 40, SECOND > 60 and > 40. A miss raises. The
    kernels' launches are held as phase 65 holds them."""
    import tempfile
    from det3d_tpu_torch.apis.train import train_detector
    from det3d_tpu_torch.utils import mini_kitti as mk
    for key, name, config, (need_3d, need_bbox) in GATES:
        cfg = getattr(mk, config)(str(root), total_epochs=GATE_EPOCHS,
                                  workers=2)
        cfg["checkpoint_interval"] = GATE_EPOCHS
        cfg["log_interval"] = 100
        cfg["scale_batch_by_devices"] = False
        per_step = (TRAIN_LAUNCHES["second"] if key == "second" else
                    dict.fromkeys(TRAIN_LAUNCHES["second"], 0))
        zero = dict.fromkeys(api_launches(), 0)
        with tempfile.TemporaryDirectory() as work:
            reset_api_launches()
            t0 = time.perf_counter()
            tr = train_detector(cfg, work_dir=work)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check_launches(f"phase 66 {name} train_detector", dict(
                zero, **{k: 2 * v for k, v in per_step.items()}))
            reset_api_launches()
            results, _, per_frame = eval_printed(cfg, tr.state, work)
            check_launches(f"phase 66 {name} eval_detector", dict(
                zero, rotated_nms_keep=2, window_conv=(
                    2 * SECOND_LAUNCHES if key == "second" else 0)))
        d = results["detail"]["eval.kitti"]["official"]
        ap3d, apbbox = d["Car_3d_easy_loose"], d["Car_bbox_easy"]
        log(f"phase 66 learning gate {name}: Car_3d_easy_loose {ap3d:.2f} "
            f"(gate > {need_3d}), Car_bbox_easy {apbbox:.2f} (gate > "
            f"{need_bbox}), Car_3d_easy {d['Car_3d_easy']:.2f}, "
            f"Car_bev_easy_loose {d['Car_bev_easy_loose']:.2f}; {tr.iter} "
            f"steps in {wall:.1f} s ({tr.iter / wall:.1f} steps/s, the "
            f"build, the workers' start and the capture included; the "
            f"window-conv and NMS launches twice one step's); eval "
            f"{per_frame} ms/frame [{smi}]")
        if not (ap3d > need_3d and apbbox > need_bbox):
            raise AssertionError(f"phase 66 {name}: the learning gate "
                                 f"missed: {ap3d:.2f}, {apbbox:.2f}")
        gc.collect()
        torch.cuda.empty_cache()


def data_phases(dev, smi):
    """Phases 63-66 on two synthetic trees written under TMPDIR by
    utils/mini_kitti.py: DATA_SCENES scenes (63, 64, 66) and API_SCENES
    (65)."""
    import tempfile
    from det3d_tpu_torch.utils import mini_kitti as mk
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "gate"
        mk.make_tree(root, n_scenes=DATA_SCENES)
        log(f"phase 64 tree: {DATA_SCENES} scenes, infos and gt database "
            f"written in {time.perf_counter() - t0:.2f} s")
        for phase, run in ((63, lambda: phase_pointops(root)),
                           (64, lambda: phase_data_path(root, smi)),
                           (65, lambda: phase_api(dev, api_tree(tmp), smi)),
                           (66, lambda: phase_gates(root, smi))):
            t = time.perf_counter()
            run()
            log(f"phase {phase} took {time.perf_counter() - t:.1f} s")


def api_tree(tmp):
    from det3d_tpu_torch.utils import mini_kitti as mk
    root = Path(tmp) / "api"
    mk.make_tree(root, n_scenes=API_SCENES)
    return root


# ---------------------------------------------------------------------------
# nuScenes and Lyft data, their evaluations and the CLIs (phases 67-70)
# ---------------------------------------------------------------------------

# phase 67's trees (utils/mini_nuscenes.py): NUSC_SCENES scenes of 4
# keyframes with 9 sweeps between keyframes, so that a keyframe past a
# scene's first has its 9 past sweeps; each sweep 180 object points and
# NUSC_CLUTTER clutter points, so that a 10-sweep scan holds exactly the
# 300000 points of the shipped Reformat(max_points=300000). Half the
# scenes are the train split: 20 train and 20 val keyframes. CBGS keeps
# int(20 x 0.2) = 4 infos of each of the 2 classes present of its 10 (8
# examples, 4 steps of B=2 an epoch), Lyft int(20 x 2/7) = 5 of 2 of 7
# (5 steps), nuScenes PointPillars 8 (2 steps of its shipped B=4). The
# cuts: scenes (a real split holds 28130 train keyframes) and epochs
# (one, and one more resumed for CBGS; NUSC_PP_EPOCHS for nuScenes
# PointPillars, whose trainer-fed step is timed at the second step of each
# epoch; 20 shipped); CBGS's and Lyft's samples_per_gpu (16 and 6) cut to
# NUSC_B, their workers_per_gpu (6, 4) to NUSC_WORKERS.
NUSC_SCENES = 10
NUSC_SWEEPS_BETWEEN = 9
NUSC_CLUTTER = 29820
NUSC_MAX_POINTS = 300000                # the shipped Reformat's
NUSC_B = 2
NUSC_WORKERS = 2
NUSC_PP_EPOCHS = 6
# the shipped nuScenes and Lyft configs, the data root's variable and the
# dataset's result key
NUSC_PATHS = {"cbgs": ("CBGS", CBGS_CFG, "NUSC_DATA", "nusc"),
              "lyft": ("Lyft CBGS", LYFT_CFG, "LYFT_DATA", "lyft"),
              "nusc_pp": ("nuScenes PointPillars", NUSC_PP_CFG, "NUSC_DATA",
                          "nusc")}
# the 6-channel stem of the CBGS and Lyft middles on a nuScenes batch,
# and Lyft's middle (CBGS's) behind it
STEM_6 = (("s0", 6, 16, True),)
LYFT_TRAIN_LAYERS = STEM_6 + CBGS_LAYERS[1:]


def nusc_tree(root, lyft=False):
    """A mini tree at nuScenes' scan size at ``root``, prepared as a user
    prepares one (cli.py's data preparation: 10-sweep infos and, for
    nuScenes, the gt database; Lyft's categories renamed first)."""
    from det3d_tpu_torch import cli
    from det3d_tpu_torch.utils import mini_nuscenes as mn
    t0 = time.perf_counter()
    mn.make_tree(root, n_scenes=NUSC_SCENES,
                 sweeps_between=NUSC_SWEEPS_BETWEEN, clutter=NUSC_CLUTTER)
    if lyft:
        mn.lyft_categories(root)
        cli._lyft_data_prep(str(root), mn.VERSION)
    else:
        cli._nuscenes_data_prep(str(root), mn.VERSION)
    return time.perf_counter() - t0


def nusc_config(key, root, cut=None):
    """A shipped nuScenes or Lyft config as a dict, its data root at
    ``root``, with the cuts of NUSC_B and NUSC_WORKERS (nuScenes
    PointPillars keeps its shipped batch of 4); ``cut``: sparse_config's
    range and voxel cut."""
    import os
    _, path, env, _ = NUSC_PATHS[key]
    os.environ[env] = str(root)
    cfg = sparse_config(path, cut=cut)
    if key != "nusc_pp":
        cfg["data"]["samples_per_gpu"] = NUSC_B
    cfg["data"]["workers_per_gpu"] = NUSC_WORKERS
    cfg["total_epochs"] = 1
    cfg["log_interval"] = 1000
    cfg["tensorboard"] = False
    return cfg


def phase_nusc_data(root, smi):
    """Phase 67: the tree's infos (20 train and 20 val keyframes, 9 past
    sweeps each, the first keyframe of a scene padded with itself, 9-dim
    boxes), CBGS's train pipeline as shipped with the HostPlan stage
    (training plans) through the loader's 2 fork workers over two epochs
    equal to their in-process replay, the examples' width (6: xyz,
    intensity, ring, time lag) against the stack's stem, a scan's points
    (10 sweeps of 180 + NUSC_CLUTTER); the pipeline's ms/example
    in-process and the loader's ms/batch with 2 workers. Returns a loader
    batch (with its plan)."""
    import pickle
    from det3d_tpu_torch.apis.train import (build_stack, example_width,
                                            inject_host_plan)
    from det3d_tpu_torch.datasets import build_dataloader, build_dataset
    from det3d_tpu_torch.datasets.loader.loader import replay
    cpu = cpu_model()
    label = "phase 67 nuScenes data"
    keyframes = NUSC_SCENES // 2 * 4
    for split in ("train", "val"):
        infos = pickle.load(open(root / f"infos_{split}_10sweeps_withvelo"
                                 ".pkl", "rb"))
        bad = [i["token"] for i in infos
               if len(i["sweeps"]) != 9 or i["gt_boxes"].shape[1:] != (9,)
               or not np.isfinite(i["gt_boxes"]).all()]
        if len(infos) != keyframes or bad:
            raise AssertionError(f"{label}: {len(infos)} {split} infos, bad "
                                 f"{bad[:3]}")
    first = infos[0]["sweeps"]
    if first[0]["transform_matrix"] is not None or any(
            s["sample_data_token"] != first[0]["sample_data_token"]
            for s in first):
        raise AssertionError(f"{label}: a scene's first keyframe is not "
                             f"padded with itself")
    cfg = nusc_config("cbgs", root)
    width = example_width(cfg["data"]["train"])
    model, vg = build_stack(cfg, device="cpu", point_width=width)[:2]
    stem_w = tuple(model.backbone.SparseConvBN_0.weight.shape)
    if width != 6 or stem_w != (27, 6, 16):
        raise AssertionError(f"{label}: examples {width} wide, the stem "
                             f"{stem_w}")
    if not inject_host_plan(cfg, model, vg, split="train", train=True):
        raise AssertionError(f"{label}: no HostPlan stage injected")
    np.random.seed(0)
    ds = build_dataset(cfg["data"]["train"])
    loader = build_dataloader(ds, NUSC_B, workers_per_gpu=NUSC_WORKERS,
                              seed=0)
    try:
        got = []
        for e in (0, 1):
            loader.set_epoch(e)
            got += list(loader)
        t0 = time.perf_counter()
        loader.set_epoch(2)
        n = sum(1 for _ in loader)
        batch_ms = (time.perf_counter() - t0) * 1e3 / n
    finally:
        loader.close()
    same_batches(got, replay(loader, (0, 1)), label)
    b = got[0]
    scan = [int(k) for k in b["num_points"]]
    plans = sorted(k for k in b if k.startswith("plan_"))
    want = 10 * (3 * 60 + NUSC_CLUTTER)         # 10 sweeps of a keyframe
    if (b["points"].shape[1:] != (NUSC_MAX_POINTS, 6)
            or scan != [want] * NUSC_B
            or not any(k.startswith("plan_inv") for k in plans)):
        raise AssertionError(f"{label}: points {b['points'].shape}, scans "
                             f"{scan}, plan keys {plans}")
    np.random.seed(0)
    one = host_ms(lambda: ds[0], reps=4)
    log(f"{label}: {len(ds)} CBGS-resampled train examples of "
        f"{keyframes} keyframes a split, 9 past sweeps each; {len(got)} "
        f"batches "
        f"of {NUSC_B} over 2 epochs on {NUSC_WORKERS} workers equal to "
        f"their in-process replay; {len(plans)} plan keys a batch "
        f"(training plans); examples {width} wide (xyz, intensity, ring, "
        f"time lag), the stem {stem_w}; {scan[0]} points a scan; the "
        f"pipeline {one:.1f} ms/example in-process (10 sweeps read, "
        f"augmented, the training plan built), the loader {batch_ms:.1f} "
        f"ms/batch with {NUSC_WORKERS} workers [host: {cpu}]")
    return b


def phase_stem_6(dev, batch, smi):
    """Phase 68's stem check: the window conv at Cin 6 (the stem of CBGS's
    and Lyft's middles on a nuScenes batch: bf16 rows of 12 bytes, fp32
    of 24) on the batch's plan, forward in fp32 and bf16 against its plain
    twin (conv_vs_plain), and dW (fp32, the backward kernels' one
    precision: training runs fp32) against window_conv_dw_ref
    (phase_bwd_kernels)."""
    for prec in ("fp32", "bf16"):
        case = conv_cases(batch, dev, DTYPES[prec], STEM_6)[0]
        conv_vs_plain(case, prec, "phase 68 stem Cin 6")
    phase_bwd_kernels(dev, batch, STEM_6, "phase 68 stem Cin 6", smi)


def lyft_batch(root):
    """NUSC_B Lyft train examples as train_detector's loader gives them
    (configs/lyft_cbgs_voxelnet.py's pipeline over the tree, 6 columns,
    the HostPlan stage: training plans), built and collated in-process."""
    from det3d_tpu_torch.apis.train import (build_stack, example_width,
                                            inject_host_plan)
    from det3d_tpu_torch.datasets import build_dataset
    from det3d_tpu_torch.datasets.loader.loader import collate
    cfg = nusc_config("lyft", root)
    model, vg = build_stack(cfg, device="cpu", point_width=example_width(
        cfg["data"]["train"]))[:2]
    inject_host_plan(cfg, model, vg, split="train", train=True)
    np.random.seed(0)
    ds = build_dataset(cfg["data"]["train"])
    return collate([ds[i] for i in range(NUSC_B)])


def phase_lyft_kernels(dev, root, smi):
    """Phase 69's checks of Lyft's train step at its own shapes, on a batch
    of the tree (lyft_batch): the window conv's forward (fp32, within
    CONV_TOL) and backward kernels (phase_bwd_kernels, within BWD_TOL)
    against their plain twins at every conv of Lyft's middle, the Cin-6
    stem included (LYFT_TRAIN_LAYERS; the (41, 2016, 2016) grid's training
    plan); then one eager train step card vs CPU (step_card_vs_cpu) from
    the same random weights (models/builder.py::init_weights, seed 0, as
    train_detector draws them) on the range cut to +-CBGS_CUT m and
    CBGS_CUT_VOXELS voxels, the batch's points planned anew for the cut.
    Returns phase_bwd_kernels' sums."""
    from det3d_tpu_torch.apis.train import TRAIN_KEYS, build_stack, init_state
    from det3d_tpu_torch.models.builder import init_weights
    label = "phase 69 Lyft"
    batch = lyft_batch(root)
    if not any(k.startswith("plan_inv") for k in batch):
        raise AssertionError(f"{label}: no inverse rulebooks in the batch")
    model = build_stack(nusc_config("lyft", root), device="cpu",
                        point_width=batch["points"].shape[-1])[0]
    planned = dict(batch, **tail_plan(model, batch, dev, train=True))
    del model
    for case in conv_cases(planned, dev, torch.float32, LYFT_TRAIN_LAYERS):
        conv_vs_plain(case, "fp32", label)
    kern = phase_bwd_kernels(dev, planned, LYFT_TRAIN_LAYERS, label, smi)
    del planned
    cut = nusc_config("lyft", root, cut=(CBGS_CUT, CBGS_CUT_VOXELS))
    data = with_train_plan(None, {k: batch[k] for k in TRAIN_KEYS}, cfg=cut)
    width = batch["points"].shape[-1]
    init = build_stack(cut, "cpu", point_width=width)[0]
    init_weights(init, torch.Generator().manual_seed(0))
    weights = init.state_dict()

    def stacks(device):
        model, vg, asg, cids, _ = build_stack(cut, device, point_width=width)
        model.load_state_dict(weights)
        return model, vg, asg, cids, init_state(cut, model, TRAIN_TOTAL)[0]

    step_card_vs_cpu(dev, f"{label} at +-{CBGS_CUT} m ({CBGS_CUT_VOXELS} "
                     f"voxels)", stacks, data, smi)
    return kern


def fed_ms(timer):
    """An epoch_timer's reading: ms a step over its steps, and over two
    epochs or more the median and spread of the epochs' means."""
    out = f"{timer.ms:.3f} ms/step over {timer.steps} steps"
    e = timer.epochs
    if len(e) > 1:
        out += (f" (the epochs' means: median {statistics.median(e):.3f}, "
                f"{min(e):.3f}-{max(e):.3f} over {len(e)} epochs)")
    return out


def nusc_train(dev, key, cfg, work, want, hooks=(), resume=False):
    """train_detector(cfg) on the card (resumed from ``work`` with
    ``resume``), its launches held to ``want``; returns (trainer, wall
    seconds, peak GiB)."""
    from det3d_tpu_torch.apis.train import train_detector
    reset_api_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = train_detector(cfg, work_dir=work,
                        resume_from=work if resume else None, hooks=hooks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_launches(f"{NUSC_PATHS[key][0]} train_detector", want)
    return tr, wall, torch.cuda.max_memory_allocated() / 2**30


def nusc_eval(key, cfg, state, work, root, want):
    """eval_detector(cfg, state) on val: its launches held to ``want``,
    detections for every val token, 9-dim boxes whose centers are finite
    and inside the post-center range, scores in [0, 1], the result's NDS
    (nuScenes) or mAP (Lyft) line. (The sizes are exp of the head's
    output: a head trained a few steps from random weights, with its
    BatchNorms' running statistics still near their initial values,
    decodes sizes that may overflow fp32, on the card as on the CPU.)
    Returns (results, detections, seconds, its "Total time per frame",
    the boxes whose sizes are not finite)."""
    import pickle
    name, _, _, result = NUSC_PATHS[key]
    reset_api_launches()
    t0 = time.perf_counter()
    results, dets, per_frame = eval_printed(cfg, state, work)
    secs = time.perf_counter() - t0
    check_launches(f"{name} eval_detector", want)
    prefix = "lyft_" if key == "lyft" else ""
    suffix = "" if key == "lyft" else "_withvelo"
    val = pickle.load(open(root / f"{prefix}infos_val_10sweeps{suffix}.pkl",
                           "rb"))
    text = results["results"][result]
    if sorted(dets) != sorted(i["token"] for i in val) or (
            ("NDS:" if result == "nusc" else "mAP") not in text):
        raise AssertionError(f"{name}: {len(dets)} val tokens, result "
                             f"{text[:80]!r}")
    lo, hi = (np.asarray(r) for r in np.split(np.asarray(
        cfg["test_cfg"]["post_center_limit_range"]), 2))
    overflow = 0
    for d in dets.values():
        box, scores = d["box3d_lidar"], d["scores"]
        centers = box[:, :3]
        if (box.shape[1:] != (9,) or not np.isfinite(centers).all()
                or (centers < lo).any() or (centers > hi).any()
                or not ((scores >= 0) & (scores <= 1)).all()):
            raise AssertionError(f"{name}: detections {box[:4]}, scores "
                                 f"{scores[:4]}")
        overflow += int((~np.isfinite(box)).any(1).sum())
    return results, dets, secs, per_frame, overflow


def api_want(zero, per_step=None, nms=0, convs=0):
    """The launches of an API call: twice one step's (the captured step's
    eager warm-up and its capture). ``per_step``: a train step's window-
    conv launches by kernel path; ``nms`` and ``convs``: a predict step's
    NMS and window-conv launches."""
    step = dict(per_step or {}, rotated_nms_keep=nms)
    step["window_conv"] = convs or step.get("window_conv", 0)
    return dict(zero, **{k: 2 * v for k, v in step.items()})


def phase_nusc_cbgs(dev, root, batch, smi):
    """Phase 68: configs/nusc_cbgs_voxelnet.py as shipped (but NUSC_B and
    NUSC_WORKERS) over the tree: train_detector one epoch with a work dir
    (launches 2 x (11 / 8 / 2 / 11)), resumed for a second under
    ProfilerHook (the device's busy share), eval_detector on val (1 NMS
    and 11 bf16 window convs a predict step, twice: its warm-up and
    capture) with the NDS over every val token; the trainer's ms/step fed
    by the loader beside phase 62's captured step; then the stem at Cin 6
    (phase_stem_6)."""
    import tempfile
    from det3d_tpu_torch.runtime.hooks import ProfilerHook
    label = "phase 68 CBGS"
    cfg = nusc_config("cbgs", root)
    zero = dict.fromkeys(api_launches(), 0)
    warm_profiler(dev)
    train_want = api_want(zero, TRAIN_LAUNCHES["cbgs"])
    with tempfile.TemporaryDirectory() as work:
        timer = epoch_timer()
        tr, first_s, peak = nusc_train(dev, "cbgs", cfg, work, train_want,
                                       hooks=[timer])
        steps = tr.iter
        stem = tuple(tr.state.model.backbone.SparseConvBN_0.weight.shape)
        cfg["total_epochs"] = 2
        timed = epoch_timer()
        prof = ProfilerHook(start=steps + 1, steps=steps - 1,
                            log_dir=str(Path(work) / "profile"))
        tr, _, _ = nusc_train(dev, "cbgs", cfg, work, train_want,
                              hooks=[timed, prof], resume=True)
        count = int(tr.state.step)
        if not (tr.epoch == 2 and tr.iter == count == 2 * steps):
            raise AssertionError(f"{label}: after the resume epoch "
                                 f"{tr.epoch}, iter {tr.iter}, the "
                                 f"optimizer's count {count}")
        eval_want = api_want(zero, nms=1, convs=CBGS_LAUNCHES)
        results, dets, eval_s, per_frame, overflow = nusc_eval(
            "cbgs", cfg, tr.state, work, root, eval_want)
    nds = results["detail"]["eval.nusc"]["nd_score"]
    captured = CAPTURED_MS.get("cbgs")
    beside = (f"phase 62's captured step from numpy {captured:.3f} ms/step"
              if captured else "phase 62 not run")
    share = device_ms(prof.profile) / timed.wall
    busy = (f"{share:.2f} busy ({1 - share:.2f} idle)" if share else
            "not measured (no device time seen)")
    log(f"{label}: train_detector {steps} steps an epoch at B={NUSC_B} "
        f"({first_s:.1f} s the first epoch, the build, the workers' start "
        f"and the capture included; peak {peak:.2f} GiB), the stem "
        f"{stem}; resume to epoch {tr.epoch}, optimizer count {count} = "
        f"the trainer's iter; NDS {nds:.4f} over {len(dets)} val tokens "
        f"(random-init training, 2 epochs; {overflow} boxes of "
        f"{sum(len(d['scores']) for d in dets.values())} with sizes past "
        f"fp32); launches a train_detector call "
        f"{train_want}, an eval_detector call {eval_want}")
    log(f"{label}: the trainer fed by the loader ({NUSC_WORKERS} workers) "
        f"{fed_ms(timer)} beside {beside}; the resumed epoch under "
        f"ProfilerHook {fed_ms(timed)}, the "
        f"device {busy}; eval_detector {eval_s * 1e3 / len(dets):.2f} "
        f"ms/frame over {len(dets)} frames (the build, the capture, the "
        f"loading and the evaluation included), its own \"Total time per "
        f"frame\" {per_frame} ms [{smi}]")
    phase_stem_6(dev, batch, smi)
    gc.collect()
    torch.cuda.empty_cache()


def phase_nusc_others(dev, roots, smi):
    """Phase 69: configs/lyft_cbgs_voxelnet.py (fp32 middle; NUSC_B,
    NUSC_WORKERS) over the Lyft tree and configs/nusc_pointpillars.py
    (bf16 reader and neck, B=4 as shipped, GT-AUG from the tree's gt
    database; NUSC_PP_EPOCHS epochs) over the nuScenes tree: first Lyft's
    kernels and one step card vs CPU (phase_lyft_kernels), then
    train_detector (launches: Lyft 2 x (11 / 8 / 2 / 11), PointPillars
    none), eval_detector on val (Lyft 2 x (1 NMS, 11 fp32 window convs),
    PointPillars 2 NMS); Lyft's ms/step fed by the loader and its peak
    memory. Returns the JSON line's entries of Lyft's backward kernels."""
    import tempfile
    zero = dict.fromkeys(api_launches(), 0)
    kern = phase_lyft_kernels(dev, roots["lyft"], smi)
    gc.collect()
    torch.cuda.empty_cache()
    entries = []
    for key in ("lyft", "nusc_pp"):
        name = NUSC_PATHS[key][0]
        label = f"phase 69 {name}"
        root = roots[key]
        cfg = nusc_config(key, root)
        if key == "nusc_pp":
            cfg["total_epochs"] = NUSC_PP_EPOCHS
        b = cfg["data"]["samples_per_gpu"]
        per_step = TRAIN_LAUNCHES["cbgs"] if key == "lyft" else None
        train_want = api_want(zero, per_step)
        eval_want = api_want(zero, nms=1,
                             convs=CBGS_LAUNCHES if key == "lyft" else 0)
        with tempfile.TemporaryDirectory() as work:
            timer = epoch_timer()
            tr, wall, peak = nusc_train(dev, key, cfg, work, train_want,
                                        hooks=[timer])
            results, dets, eval_s, per_frame, overflow = nusc_eval(
                key, cfg, tr.state, work, root, eval_want)
        if key == "lyft":
            entries = bwd_entries("lyft_train", kern, train_want)
        detail = results["detail"]
        metric = (f"mAP {detail['eval.lyft']['mAP']:.4f}" if key == "lyft"
                  else f"NDS {detail['eval.nusc']['nd_score']:.4f}")
        log(f"{label}: train_detector {tr.iter} steps ({tr.epoch} "
            f"epoch{'s' if tr.epoch > 1 else ''}) at B={b} in {wall:.1f} s "
            f"(the build, the workers' start and the capture included), fed "
            f"by the loader {fed_ms(timer)}, peak {peak:.2f} GiB; {metric} "
            f"over {len(dets)} val tokens (random-init training; "
            f"{overflow} boxes with sizes past fp32); "
            f"eval_detector {eval_s * 1e3 / len(dets):.2f} ms/frame, its "
            f"own \"Total time per frame\" {per_frame} ms; launches a "
            f"train_detector call {train_want}, an eval_detector call "
            f"{eval_want} [{smi}]")
        gc.collect()
        torch.cuda.empty_cache()
    return entries


def run_cli(args, label, env, must=()):
    """``python -m det3d_tpu_torch.cli ARGS`` from the checkout, in a
    process of its own: it must exit with 0 and print each of ``must``.
    Returns (its output, seconds)."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "det3d_tpu_torch.cli"]
                         + args, capture_output=True, text=True, env=env,
                         cwd=str(root), timeout=600)
    secs = time.perf_counter() - t0
    if run.returncode != 0 or any(m not in run.stdout for m in must):
        raise AssertionError(f"{label}: exit {run.returncode}\n"
                             f"{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    return run.stdout, secs


def phase_cli(tmp, smi):
    """Phase 70: the command-line entry points, each a process of its own
    on the card (the default --device cuda), the kernels from phase 2's
    build: ``create_data nuscenes_data_prep`` on a fresh default mini
    tree (2 scenes), then ``train`` on configs/smoke_kitti_pointpillars.py
    (in a copy: total_epochs cut from 150 to 1, and a checkpoint at every
    epoch, where it saves every 50) over a 16-scene
    mini-KITTI tree (utils/mini_kitti.py) and ``test`` on its work dir,
    which prints the official KITTI result."""
    import os
    from det3d_tpu_torch.utils import mini_kitti as mk
    from det3d_tpu_torch.utils import mini_nuscenes as mn
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    fresh = tmp / "cli_nusc"
    mn.make_tree(fresh)
    _, prep_s = run_cli(["create_data", "nuscenes_data_prep", "--root_path",
                         str(fresh), "--version", mn.VERSION], "phase 70 "
                        "create_data", env, must=("train infos: 4, val: 4",))
    for f in ("infos_train_10sweeps_withvelo.pkl",
              "dbinfos_train_10sweeps.pkl"):
        if not (fresh / f).is_file():
            raise AssertionError(f"phase 70 create_data: no {f}")
    kitti = tmp / "cli_kitti"
    mk.make_tree(kitti, n_scenes=DATA_SCENES)
    conf = tmp / "smoke_kitti_pointpillars_1epoch.py"
    conf.write_text((root / "configs" / "smoke_kitti_pointpillars.py")
                    .read_text()
                    + "\ntotal_epochs = 1\ncheckpoint_interval = 1\n")
    work = tmp / "cli_work"
    env["KITTI_DATA"] = str(kitti)
    _, train_s = run_cli(["train", str(conf), "--work_dir", str(work)],
                         "phase 70 train", env, must=("trained to epoch 1",))
    out, test_s = run_cli(["test", str(conf), str(work)], "phase 70 test",
                          env, must=("restored checkpoint @ epoch 1",
                                     "Car"))
    official = [ln for ln in out.splitlines() if "Car" in ln][:2]
    log(f"phase 70 CLIs: create_data nuscenes_data_prep {prep_s:.1f} s, "
        f"train (1 epoch of {DATA_SCENES // 2} scenes at B=2) "
        f"{train_s:.1f} s, test {test_s:.1f} s, each a process of its own "
        f"with its start and imports, exit 0; test printed {official} "
        f"[{smi}]")


def nusc_phases(dev, smi):
    """Phases 67-70 on synthetic trees written under TMPDIR by
    utils/mini_nuscenes.py (nuScenes and Lyft, NUSC_SCENES scenes each)
    and utils/mini_kitti.py (phase 70). Returns the JSON line's entries
    of Lyft's backward kernels (phase 69)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        roots = {"cbgs": tmp / "nusc", "lyft": tmp / "lyft"}
        roots["nusc_pp"] = roots["cbgs"]
        for key in ("cbgs", "lyft"):
            secs = nusc_tree(roots[key], lyft=key == "lyft")
            log(f"phase 67 tree ({'Lyft' if key == 'lyft' else 'nuScenes'}"
                f"): {NUSC_SCENES} scenes of 4 keyframes, "
                f"{NUSC_SWEEPS_BETWEEN} sweeps between keyframes, "
                f"{NUSC_CLUTTER} clutter points a sweep, 10-sweep infos"
                + ("" if key == "lyft" else " and the gt database")
                + f" written in {secs:.1f} s [host: {cpu_model()}]")
        t = time.perf_counter()
        batch = phase_nusc_data(roots["cbgs"], smi)
        log(f"phase 67 took {time.perf_counter() - t:.1f} s")
        out = {}
        for phase, run in (
                (68, lambda: phase_nusc_cbgs(dev, roots["cbgs"], batch,
                                             smi)),
                (69, lambda: phase_nusc_others(dev, roots, smi)),
                (70, lambda: phase_cli(tmp, smi))):
            t = time.perf_counter()
            out[phase] = run()
            log(f"phase {phase} took {time.perf_counter() - t:.1f} s")
    return out[69]


# ---------------------------------------------------------------------------
# Ranks over torch.distributed (phases 71-72)
# ---------------------------------------------------------------------------

# phase 71: two ranks share the one card under gloo (NCCL refuses two ranks
# on one GPU). Its train steps, each (key, name, global batch), a rank
# taking half: SECOND as shipped (fp32 in training, host training plans)
# at phase 60's B=4, the flagship (fp32) at phase 54's B=8
DIST_WORLD = 2
DIST_STEPS = (("second", "SECOND", 4), ("flagship", "flagship (fp32)", B))
DIST_TIMED = 5           # the 2-rank eager step: ms/step over 5, after one
DIST_SCENES = DATA_SCENES   # train_detector's tree: 8 train, 8 val scans
DIST_TIMEOUT = 600          # seconds a rank may take
NCCL_STEPS = 8              # phase 72's captured steps timed, after 2


def free_port():
    """A TCP port on localhost that nothing listens on now."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def dist_rank(port, rank, world, inputs, out):
    """One rank of phase 71, a process of its own (``python -c "import
    chip_smoke; chip_smoke.dist_rank(...)"``): TF32 off as phase 1 sets
    it, the gloo group over localhost:``port``, then on ``inputs``' device
    each train step of ``inputs["steps"]`` on this rank's half of its
    batch (dist_step), then train_detector and eval_detector
    (dist_api); writes what it computed to ``out.<rank>``."""
    from det3d_tpu_torch.parallel import dist_utils
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dist_utils.initialize_distributed(f"localhost:{port}", world, rank,
                                      backend="gloo")
    case = torch.load(inputs, weights_only=False)
    dev = torch.device(case["device"])
    res = {"steps": {}}
    for key, c in case["steps"].items():
        res["steps"][key] = dist_step(dev, c, rank, world)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    res["api"] = dist_api(dev, case["api"], rank)
    torch.save(res, f"{out}.{rank}")
    torch.distributed.destroy_process_group()


def dist_step(dev, c, rank, world):
    """One rank's train step (make_train_step as a user calls it: eager
    under gloo) from ``c["weights"]`` on rows rank*b .. rank*b+b-1 of
    ``c["batch"]``: its metrics, the gradients its optimizer got, the
    state dict after, the kernels' launches; then ms/step over DIST_TIMED
    more steps (the card synchronized at both ends), and the host time of
    the step's all-reduces (each ``c10d::allreduce_`` waits for its
    collective) under torch.profiler (CPU activity only)."""
    from det3d_tpu_torch.apis.train import build_stack, init_state
    from det3d_tpu_torch.parallel.graph import CapturedStep
    from det3d_tpu_torch.parallel.train import make_train_step
    model, vg, asg, cids, _ = build_stack(c["cfg"], device=dev)
    model.load_state_dict(c["weights"])
    state, _ = init_state(c["cfg"], model, c["total_steps"])
    seen = spy_grads(state)
    step = make_train_step(state, vg, asg, cids)
    if isinstance(step, CapturedStep):
        raise AssertionError("phase 71: a gloo rank's train step was "
                             "captured")
    b = c["batch"]["points"].shape[0] // world
    part = {k: v[rank * b:(rank + 1) * b] for k, v in c["batch"].items()}
    reset_api_launches()
    metrics = step(part)
    sync(dev)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": [g.cpu() for g in seen[0]],
           "names": [n for n, _ in model.named_parameters()],
           "state": {k: v.to("cpu", copy=True)
                     for k, v in model.state_dict().items()},
           "launches": api_launches()}
    seen.clear()
    t = time.perf_counter()
    for _ in range(DIST_TIMED):
        step(part)
    sync(dev)
    out["ms"] = (time.perf_counter() - t) * 1e3 / DIST_TIMED
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(part)
        sync(dev)
    reduces = [e for e in prof.key_averages()
               if e.key.startswith("c10d::allreduce")]
    out["allreduce"] = (sum(e.count for e in reduces),
                        sum(e.cpu_time_total for e in reduces) / 1e3)
    return out


def dist_api(dev, api, rank):
    """One rank's train_detector over ``api["cfg"]`` with the work dir
    ``api["works"][rank]`` (the step eager, rank 0 alone writing), then
    eval_detector of rank 0's checkpoint sharded over the ranks: the
    trainer's counts, the state dict after, the detections and results,
    each call's launches."""
    from det3d_tpu_torch.apis.train import (build_stack, eval_detector,
                                            example_width, init_state,
                                            train_detector)
    from det3d_tpu_torch.runtime.checkpoint import CheckpointManager
    cfg = api["cfg"]
    reset_api_launches()
    tr = train_detector(copy.deepcopy(cfg), work_dir=api["works"][rank],
                        device=dev)
    sync(dev)
    out = {"iter": tr.iter, "count": int(tr.state.step),
           "state": {k: v.to("cpu", copy=True) for k, v in
                     tr.state.model.state_dict().items()},
           "train_launches": api_launches()}
    del tr
    model = build_stack(cfg, dev, point_width=example_width(
        cfg["data"]["val"]))[0]
    state, _ = init_state(cfg, model, total_steps=1)
    CheckpointManager(api["ckpt"]).restore(state)
    reset_api_launches()
    results, dets = eval_detector(copy.deepcopy(cfg), state, device=dev)
    out.update(results=results["results"], detections=dets,
               eval_launches=api_launches())
    return out


def one_process_step(dev, c):
    """The one-process train step (eager) on the whole batch: metrics,
    gradients, state after (as dist_step records them)."""
    from det3d_tpu_torch.apis.train import build_stack, init_state
    from det3d_tpu_torch.parallel.train import make_train_step
    model, vg, asg, cids, _ = build_stack(c["cfg"], device=dev)
    model.load_state_dict(c["weights"])
    state, _ = init_state(c["cfg"], model, c["total_steps"])
    seen = spy_grads(state)
    metrics = make_train_step(state, vg, asg, cids).eager(c["batch"])
    sync(dev)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": [g.cpu() for g in seen[0]],
            "names": [n for n, _ in model.named_parameters()],
            "state": {k: v.to("cpu", copy=True)
                     for k, v in model.state_dict().items()}}


def dist_batch(key, b):
    """phase 71's global batch: SECOND's train scene with its host
    training plan (phase 60's), the flagship's train_batch."""
    if key == "second":
        pc = train_config(key)["voxel_generator"]["range"]
        return with_train_plan(key, sparse_train_scene(key, b, pc, POINTS))
    return train_batch(key, b)


def check_dist_step(label, ranks, ref, want, smi):
    """2 ranks against one process: the metrics (the loss within
    TRAIN_LOSS_REL; num_pos / num_neg equal), the head's gradients within
    SPARSE_HEAD_REL and every other within SPARSE_GRAD_REL (relative L2;
    the conv biases before a training BN by size, as step_card_vs_cpu
    holds them), the BN running statistics within TRAIN_STATS_TOL; the
    two ranks' gradients, metrics and state after the update bit-equal;
    each rank's launches ``want``."""
    a, b = ranks
    names = ref["names"]
    for k in a["state"]:
        if not torch.equal(a["state"][k], b["state"][k]):
            raise AssertionError(f"{label}: the ranks' {k} differ after the "
                                 f"update")
    if a["metrics"] != b["metrics"] or not all(
            torch.equal(x, y) for x, y in zip(a["grads"], b["grads"])):
        raise AssertionError(f"{label}: the ranks' gradients or metrics "
                             f"differ")
    loss_err = abs(a["metrics"]["loss"] - ref["metrics"]["loss"]) / abs(
        ref["metrics"]["loss"])
    counts = {k: (a["metrics"][k], ref["metrics"][k]) for k in ref["metrics"]
              if k.startswith(("num_pos", "num_neg"))}
    zb = zero_grad_bias(names)
    errs = {n: e for n, e in grads_rel(a["grads"], ref["grads"],
                                       names).items() if n not in zb}
    worst = max(errs, key=errs.get)
    head = {n: e for n, e in errs.items() if n.startswith("bbox_head")}
    head_worst = max(head, key=head.get)
    bias = max((float(g.norm()) / max(float(ref["grads"][names.index(
        n.rsplit(".", 1)[0] + ".weight")].norm()), 1e-30), n)
        for n, g in zip(names, a["grads"]) if n in zb) if zb else (0.0, None)
    stats = max((float((a["state"][k] - ref["state"][k]).abs().max()), k)
                for k in ref["state"] if k.endswith((".mean", ".var")))
    log(f"{label}: 2 ranks (gloo, one card) against one process: loss "
        f"{a['metrics']['loss']:.6f} / {ref['metrics']['loss']:.6f} (rel "
        f"err {loss_err:.2e}, tolerance {TRAIN_LOSS_REL}); num_pos / num_neg "
        f"{counts}; gradients relative L2 worst {errs[worst]:.3e} ({worst}),"
        f" median {statistics.median(errs.values()):.3e} (tolerance "
        f"{SPARSE_GRAD_REL}), the head's worst {head[head_worst]:.3e} "
        f"(tolerance {SPARSE_HEAD_REL}), {len(zb)} conv biases before a "
        f"training BN at most {bias[0]:.2e} of their weight gradient; BN "
        f"running statistics max abs err {stats[0]:.2e} ({stats[1]}); the "
        f"ranks' gradients and parameters after the update bit-equal; "
        f"launches a rank {a['launches']} [{smi}]")
    if loss_err > TRAIN_LOSS_REL or any(x != y for x, y in counts.values()):
        raise AssertionError(f"{label}: loss {loss_err}, counts {counts}")
    if errs[worst] > SPARSE_GRAD_REL or head[head_worst] > SPARSE_HEAD_REL:
        raise AssertionError(f"{label}: gradient {worst} {errs[worst]}, "
                             f"head {head_worst} {head[head_worst]}")
    if bias[0] > 1e-4:
        raise AssertionError(f"{label}: gradient of {bias[1]} is not zero: "
                             f"{bias[0]}")
    for k in ref["state"]:
        if k.endswith((".mean", ".var")) and not torch.allclose(
                a["state"][k], ref["state"][k], **TRAIN_STATS_TOL["fp32"]):
            raise AssertionError(f"{label}: BN statistic {k}")
    for r in ranks:
        if r["launches"] != want:
            raise AssertionError(f"{label}: launches {r['launches']}, "
                                 f"expected {want}")


def phase_dist(dev, smi):
    """Phase 71: DIST_WORLD ranks under gloo, processes of their own
    (dist_rank) on this one card, at full width. The train steps of
    DIST_STEPS, each rank on half the global batch from the same
    calibrated weights (train_weights), against the one-process eager step
    on the whole batch (check_dist_step; launches a rank: SECOND's
    TRAIN_LAUNCHES, none for the flagship); each rank's ms/step (eager)
    beside phase 60's / 55's captured step, and its all-reduces' host
    time. Then configs/kitti_car_pointpillars.py as shipped over a
    DIST_SCENES-scene mini-KITTI tree: train_detector one epoch over the
    ranks (rank 1 given a work dir of its own, where nothing may appear)
    against one process (half the steps at twice the global batch, the
    ranks' parameters bit-equal, the optimizer's count the trainer's
    iter), and eval_detector of rank 0's checkpoint sharded over the
    ranks against one process: the merged detections equal token by
    token, the official result equal; 2 NMS launches a rank's eval (its
    predict step's warm-up and capture). Returns rank 0's launches on
    each path."""
    import os
    import tempfile
    from det3d_tpu_torch.apis.train import (build_stack, eval_detector,
                                            example_width, init_state,
                                            train_detector)
    from det3d_tpu_torch.runtime.checkpoint import CheckpointManager
    from det3d_tpu_torch.utils import mini_kitti as mk
    zero = dict.fromkeys(api_launches(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        steps, refs = {}, {}
        for key, name, b in DIST_STEPS:
            steps[key] = {"cfg": train_config(key),
                          "weights": train_weights(key),
                          "batch": dist_batch(key, b),
                          "total_steps": TRAIN_TOTAL}
            refs[key] = one_process_step(dev, steps[key])
            gc.collect()
            torch.cuda.empty_cache()
        root = tmp / "kitti"
        mk.make_tree(root, n_scenes=DIST_SCENES)
        os.environ["KITTI_DATA"] = str(root)
        cfg = pp_config(KITTI_PP_CFG)
        cfg.update(total_epochs=1, log_interval=1000)
        works = [tmp / f"work{r}" for r in range(DIST_WORLD)]
        api = {"cfg": cfg, "works": [str(w) for w in works],
               "ckpt": str(works[0] / "ckpt")}
        inputs = tmp / "inputs.pt"
        torch.save({"device": "cuda", "steps": steps, "api": api}, inputs)
        t0 = time.perf_counter()
        ranks = dist_spawn(inputs, tmp / "rank")
        ranks_s = time.perf_counter() - t0
        label = "phase 71"
        for key, name, b in DIST_STEPS:
            want = dict(zero, **TRAIN_LAUNCHES.get(key, {}))
            check_dist_step(f"{label} {name} B={b} as {DIST_WORLD} x "
                            f"{b // DIST_WORLD}", [r["steps"][key]
                                                   for r in ranks],
                            refs[key], want, smi)
            r0 = ranks[0]["steps"][key]
            n, secs = r0["allreduce"]
            captured = CAPTURED_MS.get(key)
            beside = (f"the one-process captured step {captured:.3f} "
                      f"ms/step (phase {60 if key == 'second' else 55})"
                      if captured else "the one-process captured step "
                      "not timed in this run (phases 55 and 60 not run)")
            log(f"{label} {name}: the 2-rank eager step {r0['ms']:.3f} "
                f"ms/step (rank 0, {DIST_TIMED} steps, both ranks on one "
                f"card) beside {beside}; its {n} all-reduces took "
                f"{secs:.3f} ms of host time in one step [{smi}]")
        # train_detector and eval_detector: the ranks against one process
        a, b_ = (r["api"] for r in ranks)
        for k in a["state"]:
            if not torch.equal(a["state"][k], b_["state"][k]):
                raise AssertionError(f"{label} train_detector: the ranks' "
                                     f"{k} differ")
        written = [p for p in works[1].rglob("*") if p.is_file()]
        ckpts = sorted(p.name for p in (works[0] / "ckpt").glob("*.pt"))
        if written or ckpts != ["epoch_1.pt"]:
            raise AssertionError(f"{label}: rank 1 wrote {written}; rank 0's "
                                 f"checkpoints {ckpts}")
        one_work = tmp / "one"
        reset_api_launches()
        tr = train_detector(copy.deepcopy(cfg), work_dir=str(one_work),
                            device=dev)
        one_iter, one_count = tr.iter, int(tr.state.step)
        del tr
        if not (a["iter"] == a["count"] and one_iter == one_count
                and one_iter == DIST_WORLD * a["iter"]):
            raise AssertionError(f"{label} train_detector: {a['iter']} steps "
                                 f"(count {a['count']}) over the ranks, "
                                 f"{one_iter} ({one_count}) in one process")
        for r in ranks:
            if r["api"]["train_launches"] != zero:
                raise AssertionError(f"{label} train_detector: launches "
                                     f"{r['api']['train_launches']}")
        model = build_stack(cfg, dev, point_width=example_width(
            cfg["data"]["val"]))[0]
        state, _ = init_state(cfg, model, total_steps=1)
        CheckpointManager(api["ckpt"]).restore(state)
        results, dets = eval_detector(copy.deepcopy(cfg), state, device=dev)
        for r in ranks:
            got = r["api"]
            if got["eval_launches"] != dict(zero, rotated_nms_keep=2):
                raise AssertionError(f"{label} eval_detector: launches "
                                     f"{got['eval_launches']}")
            if list(got["detections"]) != list(dets) or got["results"] != \
                    results["results"]:
                raise AssertionError(f"{label} eval_detector: tokens or "
                                     f"results differ from one process")
            for tok, d in dets.items():
                g = got["detections"][tok]
                for k in ("box3d_lidar", "scores", "label_preds"):
                    if not np.array_equal(g[k], d[k]):
                        raise AssertionError(f"{label} eval_detector: {tok} "
                                             f"{k} differs")
    official = results["detail"]["eval.kitti"]["official"]
    log(f"{label} train_detector (configs/kitti_car_pointpillars.py, "
        f"{DIST_SCENES} scenes): {a['iter']} steps at a global B="
        f"{DIST_WORLD * cfg['data']['samples_per_gpu']} over {DIST_WORLD} "
        f"ranks, {one_iter} at B={cfg['data']['samples_per_gpu']} in one "
        f"process; the ranks' parameters bit-equal after training; rank 1 "
        f"wrote nothing, rank 0 {ckpts}; eval_detector of rank 0's "
        f"checkpoint sharded over the ranks: {len(dets)} tokens' detections "
        f"equal to one process's, Car_3d_easy {official['Car_3d_easy']:.2f} "
        f"on both; the ranks took {ranks_s:.1f} s with their start [{smi}]")
    return {"second": ranks[0]["steps"]["second"]["launches"],
            "eval": ranks[0]["api"]["eval_launches"]}


def dist_spawn(inputs, out):
    """DIST_WORLD processes of dist_rank on ``inputs``, from this
    checkout; waits for them (each within DIST_TIMEOUT), fails on any exit
    code but 0 with the rank's output, and returns their results."""
    import os
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    port = free_port()
    logs = [Path(f"{out}.log{r}") for r in range(DIST_WORLD)]
    procs = []
    for r in range(DIST_WORLD):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", f"import chip_smoke; chip_smoke."
                 f"dist_rank({port}, {r}, {DIST_WORLD}, {str(inputs)!r}, "
                 f"{str(out)!r})"],
                cwd=str(root), env=env, stdout=f, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=DIST_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"phase 71 rank {r}: exit {p.returncode}\n"
                                 f"{logs[r].read_text()[-4000:]}")
    return [torch.load(f"{out}.{r}", weights_only=False)
            for r in range(DIST_WORLD)]


def phase_nccl(dev, smi):
    """Phase 72: a world-size-1 NCCL group on the card, where SECOND's
    train step (configs/kitti_car_second.py, B=4, host training plans)
    runs its collectives (the BN sums, the gradients' and the metrics'
    all-reduces): make_train_step gives a CapturedStep under NCCL
    (parallel/graph.py::stepper). From the same weights, under cuDNN's
    deterministic algorithms: two eager steps equal to the bit (the step
    is reproducible), then the captured step equal to them to the bit
    (metrics, parameters, BN statistics, the optimizer's moments and
    count); the launches of its first call twice one eager step's
    (TRAIN_LAUNCHES: the warm-up and the capture); then ms/step of the
    captured step over NCCL_STEPS beside phase 60's. Returns the captured
    call's launches."""
    from det3d_tpu_torch.parallel.graph import CapturedStep
    from det3d_tpu_torch.parallel.train import make_train_step
    label = "phase 72 SECOND over one NCCL rank"
    key = "second"
    data = dist_batch(key, 4)
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
        rank=0)
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for how in ("eager", "eager again", "captured"):
            model, vg, asg, cids, state = train_stack(key, dev)
            step = make_train_step(state, vg, asg, cids)
            if not isinstance(step, CapturedStep):
                raise AssertionError(f"{label}: the step is not captured")
            reset_launches()
            m = (step if how == "captured" else step.eager)(data)
            sync(dev)
            runs[how] = ({k: float(v) for k, v in m.items()},
                         [t.detach().clone() for t in state.tensors()],
                         launch_counts())
            if how == "captured":
                for _ in range(2):
                    step(data)
                sync(dev)
                t = time.perf_counter()
                for _ in range(NCCL_STEPS):
                    step(data)
                sync(dev)
                ms = (time.perf_counter() - t) * 1e3 / NCCL_STEPS
            del model, state, step
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
        torch.distributed.destroy_process_group()
    (me, te, le), (ma, ta, _), (mc, tc, lc) = (
        runs["eager"], runs["eager again"], runs["captured"])
    for other, what in (((ma, ta), "a second eager step"),
                        ((mc, tc), "the captured step")):
        if other[0] != me or not all(torch.equal(x, y)
                                     for x, y in zip(other[1], te)):
            raise AssertionError(f"{label}: {what} is not the eager step's "
                                 f"to the bit: {other[0]} against {me}")
    want = {k: 2 * v for k, v in TRAIN_LAUNCHES[key].items()}
    if le != TRAIN_LAUNCHES[key] or lc != want:
        raise AssertionError(f"{label}: launches eager {le}, captured {lc}")
    captured = CAPTURED_MS.get(key)
    log(f"{label}: the captured step (the collectives in its graph) equal "
        f"to the eager step to the bit in every metric and each of "
        f"{len(te)} state tensors after one step, as two eager steps are "
        f"(cuDNN deterministic); loss {mc['loss']:.6f}; launches: eager "
        f"{le}, the captured step's first call {lc}; captured "
        f"{ms:.3f} ms/step over {NCCL_STEPS} beside "
        + (f"phase 60's captured step without a group {captured:.3f}"
           if captured else "phase 60 not run")
        + f" [{smi}]")
    return lc


# ---------------------------------------------------------------------------
# phases 73-76: the modules no shipped config uses, and whole-step counts
# ---------------------------------------------------------------------------

# RCNNSpMiddleFHD's window convs in forward order on its plan
RCNN_LAYERS = (("s0", 4, 16, True), ("s0", 16, 16, True),
               ("down1", 16, 32, False), ("subm1", 32, 32, True),
               ("down2", 32, 64, False), ("subm2", 64, 64, True),
               ("down3", 64, 64, False), ("subm3", 64, 64, True),
               ("down4", 64, 64, False))
RCNN_B = 4                              # SECOND's training batch
# the window conv's launches in one RCNN forward and backward: 9 convs,
# subm dX past the stem, 4 strided dX over inverse rulebooks, 9 dW
RCNN_LAUNCHES = {"window_conv": 9, "window_conv_subm_dx": 4,
                 "window_conv_dw": 9, "window_conv_inv": 4}
VARIANT_OUT_REL = 1e-4      # a middle's output card vs CPU, relative L2
READER_TOL = dict(rtol=1e-5, atol=1e-6)
REFINE_SAMPLED, REFINE_LAYERS = 512, (1024, 128)
REFINE_STEPS, REFINE_LR = 300, 3e-3
REFINE_BOXES = 30                       # the refiner's scene: boxes a scan
REFINE_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
DEEP_VOXEL = [0.05, 0.05, 0.05]         # SECOND's z size halved: depth 81
DEEP_RPN_IN = 256                       # 64 channels x 4 depths
# the deep grid's window convs a forward from points: res0's two convs
# and stage 1's down conv are flat; stage 1's 2 subm, stage 2's down and
# 3 subm and stage 3's transition down conv are windows, and the dense
# tail's 3 subm and z conv at depth 10
DEEP_LAUNCHES = 11
DEEP_TRAIN_LAUNCHES = {"window_conv": 11, "window_conv_subm_dx": 8,
                       "window_conv_dw": 11, "window_conv_inv": 3}
DEEP_CUT = (6.4, 512)
# the window convs of the VoxelNet and Nobn middles on SECOND's host plan
VARIANT_LAYERS = {"voxelnet": (("s0", 128, 16, True),) + SECOND_LAYERS[1:],
                  "nobn": SECOND_LAYERS}
# the deep grid's window convs on its device plan (after the flat ones)
DEEP_LAYERS = (("subm1", 32, 32, True),) * 2 + (("down2", 32, 64, False),) \
    + (("subm2", 64, 64, True),) * 3 + (("down3", 64, 64, False),) \
    + SECOND_TAIL
VARIANT_NAMES = {"voxelnet": "the original VoxelNet (VoxelFeatureExtractor "
                             "(32, 128) + SpMiddleFHD(128))",
                 "nobn": "SpMiddleFHDNobn in SECOND's stack"}


def variant_config(kind, precision=None, cut=None):
    """configs/kitti_car_second.py with a variant the repo ships no config
    for: "voxelnet" (the original VoxelNet reader, VoxelFeatureExtractor
    with num_filters (32, 128), before SpMiddleFHD(num_input_features=
    128)), "nobn" (SpMiddleFHDNobn), "rcnn" (RCNNSpMiddleFHD) or "deep"
    (the voxel's z size halved: a (81, 1600, 1408) grid, the RPN
    DEEP_RPN_IN wide); ``precision`` and ``cut`` as sparse_config's."""
    cfg = sparse_config(SECOND_CFG, precision, cut)
    m = cfg["model"]
    bbc = m["backbone"]
    norm = bbc.get("norm_cfg")
    if kind == "voxelnet":
        m["reader"] = dict(type="VoxelFeatureExtractor", num_input_features=4,
                           num_filters=(32, 128), norm_cfg=norm)
        bbc["num_input_features"] = 128
    elif kind == "nobn":
        m["backbone"] = dict(type="SpMiddleFHDNobn", num_input_features=4,
                             norm_cfg=norm, serve_band=bbc.get("serve_band"),
                             serve_precision=bbc.get("serve_precision"))
    elif kind == "rcnn":
        m["backbone"] = dict(type="RCNNSpMiddleFHD", num_input_features=4,
                             norm_cfg=norm)
    elif kind == "deep":
        cfg["voxel_generator"]["voxel_size"] = list(DEEP_VOXEL)
        m["neck"]["num_input_features"] = DEEP_RPN_IN
    return cfg


def phase_variant_stacks(dev, sec_batch, smi):
    """Phase 73 (a), (b), (d): the original VoxelNet and SpMiddleFHDNobn
    in SECOND's stack at its full grid from host plans (random weights,
    BN statistics calibrated on the card in fp32 on one scan): the
    predict step (bf16 middle as shipped) with exactly 14 window-conv
    launches, the NMS kernel's keep equal to the plain twin's on what the
    step feeds it, the captured step (phase_captured), card vs CPU at B=1
    in fp32 (card_vs_cpu: heads within SECOND_HEAD_TOL, the decode within
    DET_TOL) and, for Nobn, the middle's output within VARIANT_OUT_REL
    relative L2; then VFEV3_ablation and SimpleVoxel on the VoxelNet
    step's per-point voxels, card vs CPU within READER_TOL. Returns
    {kind: {"nms", "conv", "launches"}}."""
    from det3d_tpu_torch.models.registry import READERS
    from det3d_tpu_torch.parallel.predict import build_example
    one = {k: v[:1] for k, v in sec_batch.items()}
    caps = {}
    for kind, sub in (("voxelnet", "a"), ("nobn", "b")):
        label = f"phase 73 ({sub}) {VARIANT_NAMES[kind]}"
        cfg32 = variant_config(kind, "fp32")
        state = calibrated_state(cfg32, one, dev)
        stack = load_stack(variant_config(kind), state, dev)
        plan = stack[5](sec_batch["points"], sec_batch["num_points"])
        st, launches = sparse_predict(dev, stack, sec_batch, plan,
                                      (SECOND_B, 100, 7), SECOND_LAUNCHES,
                                      label)
        res = {"nms": nms_entry(step_nms_inputs(lambda: st[4].eager(st[5])),
                                label, smi),
               "conv": conv_entry(
                   dev, dict(plan, **tail_plan(stack[0], plan, dev)),
                   VARIANT_LAYERS[kind], "bf16", label, smi)}
        res["launches"] = phase_captured(dev, st[4], st[5], launches, smi,
                                         label)["launches"]
        caps[kind] = res
        card32 = load_stack(cfg32, state, dev)
        cpu32 = load_stack(cfg32, state, "cpu")
        card_vs_cpu(dev, card32, cpu32, one, label)
        if kind == "nobn":
            err = rel_l2(middle_on(card32, one, dev), middle_on(cpu32, one,
                                                                "cpu"))
            log(f"{label} middle output card vs CPU (fp32, no BN): relative "
                f"L2 {err:.3e} (limit {VARIANT_OUT_REL})")
            if not err <= VARIANT_OUT_REL:
                raise AssertionError(f"{label}: middle card vs CPU {err}")
        if kind == "voxelnet":
            t = {k: torch.as_tensor(v, device=dev)
                 for k, v in dict(sec_batch, **plan).items()}
            with torch.no_grad():
                ex = build_example(t, stack[1], stack[2])
            vox, npts = ex["voxels"], ex["num_points_per_voxel"]
            for name in ("VFEV3_ablation", "SimpleVoxel"):
                reader = READERS.get(name)(num_input_features=4)
                got = reader(vox, npts).cpu()
                ref = reader(vox.cpu(), npts.cpu())
                err = float((got - ref).abs().max())
                log(f"phase 73 (d) {name} on the VoxelNet step's voxels "
                    f"{tuple(vox.shape)}: card vs CPU max abs err {err:.3e} "
                    f"(tolerance {READER_TOL})")
                if not torch.allclose(got, ref, **READER_TOL):
                    raise AssertionError(f"phase 73 (d) {name}: {err}")
        del stack, st, card32, cpu32
        gc.collect()
        torch.cuda.empty_cache()
    return caps


def conv_entry(dev, plan, layers, prec, label, smi):
    """The forward window-conv kernel at every layer of ``layers`` on
    ``plan`` in ``prec``: against its plain twin (conv_vs_plain), a call
    (cuda_ms), the device time (graph_ms), the twin's time and the bound
    (conv_work), summed over the layers."""
    from det3d_tpu_torch.ops.sparse import unpack_windows, window_conv_ref
    from det3d_tpu_torch.ops.window_conv_cuda import window_conv
    t = {"err": 0.0, "ms": 0.0, "device": 0.0, "plain": 0.0, "bytes": 0,
         "flops": 0, "dtype": prec}
    for case in conv_cases(plan, dev, DTYPES[prec], layers):
        name, x, pk, w, subm = case
        t["err"] = max(t["err"], conv_vs_plain(case, prec, label))
        r0, pres = unpack_windows(pk, 3)
        nbytes, fl, _ = conv_work(x, pk, w, subm)
        t["ms"] += cuda_ms(lambda: window_conv(x, pk, w, subm))
        t["device"] += graph_ms(lambda: window_conv(x, pk, w, subm))
        t["plain"] += cuda_ms(lambda: window_conv_ref(x, r0, pres, w, subm),
                              warmup=1, repeat=3)
        t["bytes"] += nbytes
        t["flops"] += fl
    t["bound_ms"], t["bound_by"] = bound(
        t.pop("bytes"), t.pop("flops"),
        BF16_FLOPS if prec == "bf16" else FP32_FLOPS)
    log(f"{label} forward window conv ({prec}) over the {len(layers)} "
        f"layers: a call {t['ms']:.4f} ms, device {t['device']:.4f} ms, "
        f"plain {t['plain']:.3f} ms, bound {t['bound_ms']:.6f} ms "
        f"({t['bound_by']}), max abs err {t['err']:.2e} [{smi}]")
    return t


def nms_entry(nms_in, label, smi):
    """The NMS kernel on a step's inputs: its keep equal to the plain
    twin's, a call, the device time, the twin's and the bound."""
    from det3d_tpu_torch.ops.nms_cuda import (rotated_nms_keep,
                                              rotated_nms_keep_ref)
    corners, area, valid, thr = nms_in
    keep = rotated_nms_keep(corners, area, valid, thr)
    if not torch.equal(keep, rotated_nms_keep_ref(corners, area, valid,
                                                  thr)):
        raise AssertionError(f"{label}: NMS kernel keep differs from plain")
    b_ms, b_by, _ = nms_bound(corners, area, valid)
    t = {"ms": cuda_ms(lambda: rotated_nms_keep(corners, area, valid, thr)),
         "device": graph_ms(lambda: rotated_nms_keep(corners, area, valid,
                                                     thr)),
         "plain": cuda_ms(lambda: rotated_nms_keep_ref(corners, area, valid,
                                                       thr),
                          warmup=1, repeat=3),
         "bound_ms": b_ms, "bound_by": b_by}
    log(f"{label} NMS fed N={corners.shape[0]} K={corners.shape[1]} thr "
        f"{thr}: the kernel's keep equals the plain twin's "
        f"({int(keep.sum())} kept of {int(valid.sum())} valid); a call "
        f"{t['ms']:.4f} ms, device {t['device']:.4f} ms, plain "
        f"{t['plain']:.3f} ms, bound {b_ms:.7f} ms ({b_by}) [{smi}]")
    return t


def middle_fwd_bwd(model, data, device, grid):
    """One training forward and backward of a middle alone on ``data``'s
    host voxel means, coords and (training) plan, or the device plan
    without plan keys, the cotangent seeded: (output, gradients by name,
    the window conv's launches)."""
    t = {k: torch.as_tensor(v, device=device) for k, v in data.items()}
    plan = {k[5:]: v for k, v in t.items() if k.startswith("plan_")}
    kw = {"plan": plan} if plan else {}
    reset_launches()
    model.train()
    out = model(t["voxels"], t["coordinates"], grid, **kw)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    (out * cot.to(device)).sum().backward()
    if device != "cpu":
        torch.cuda.synchronize()
    launches = launch_counts()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return out.detach().cpu(), grads, launches


def check_fwd_bwd(label, card, cpu, launches_want):
    """A middle's forward and backward, card against CPU: the output within
    VARIANT_OUT_REL, each gradient within SPARSE_GRAD_REL relative L2
    (training BN amplifies rounding), the window conv's launches exact."""
    (out_d, g_d, n_d), (out_c, g_c, _) = card, cpu
    err = rel_l2(out_d, out_c)
    errs = {n: rel_l2(g_d[n], g_c[n]) for n in g_c
            if float(g_c[n].norm()) > 0}
    worst = max(errs, key=errs.get)
    log(f"{label} forward and backward, card vs CPU (plain twins): output "
        f"relative L2 {err:.3e} (limit {VARIANT_OUT_REL}); {len(errs)} "
        f"gradients worst {errs[worst]:.3e} ({worst}), median "
        f"{statistics.median(errs.values()):.3e} (limit {SPARSE_GRAD_REL}); "
        f"the card's launches {n_d}")
    if not err <= VARIANT_OUT_REL:
        raise AssertionError(f"{label}: output card vs CPU {err}")
    if not errs[worst] <= SPARSE_GRAD_REL:
        raise AssertionError(f"{label}: gradient {worst} {errs[worst]}")
    if n_d != launches_want:
        raise AssertionError(f"{label}: launches {n_d}, expected "
                             f"{launches_want}")


def phase_rcnn_middle(dev, smi):
    """Phase 73 (c): RCNNSpMiddleFHD alone on SECOND's training plan (B=
    RCNN_B structured training scans at its full grid; the plan
    host_plan_fn(train=True) builds for RCNN's stages), fp32: the forward
    kernel and the backward kernels against their twins at every conv,
    with a call's ms, the device ms, the plain twin's and the bound
    (utils/flops.py); one forward and backward card vs CPU with the
    launches exact. Returns {"forward", "dw", "subm_dx", "inv"} timings
    and the launches."""
    from det3d_tpu_torch.apis.train import build_stack
    from det3d_tpu_torch.models.builder import init_weights
    label = "phase 73 (c) RCNNSpMiddleFHD"
    cfg = variant_config("rcnn", "fp32")
    pc = cfg["voxel_generator"]["range"]
    data = with_train_plan("second", sparse_train_scene(
        "second", RCNN_B, pc, POINTS), cfg=cfg)
    plan = {k: v for k, v in data.items() if k.startswith("plan_")}
    times = {"forward": conv_entry(dev, plan, RCNN_LAYERS, "fp32", label,
                                   smi)}
    times.update(phase_bwd_kernels(dev, plan, RCNN_LAYERS, label, smi))
    model, vg = build_stack(cfg, device="cpu")[:2]
    init_weights(model, torch.Generator().manual_seed(0))
    mid = model.backbone
    keys = [k for k in data if k.startswith("plan_")] + ["voxels",
                                                          "coordinates"]
    sub = {k: data[k] for k in keys}
    cpu = middle_fwd_bwd(mid, sub, "cpu", vg.grid_size)
    card = middle_fwd_bwd(copy.deepcopy(mid).to(dev), sub, dev, vg.grid_size)
    check_fwd_bwd(label, card, cpu, RCNN_LAUNCHES)
    return times, card[2]


def refine_scene(rng, b=SECOND_B, m=REFINE_BOXES, n=POINTS):
    """tests/test_second_stage_e2e.py::_scene in numpy: ``m`` boxes a scan
    at the anchor's size, each holding n // m points inside its true z and
    height, the first stage's boxes with the true x, y and the anchor's z,
    h; returns (points, those boxes, the (dz, dh) residuals)."""
    pts = np.zeros((b, n, 3), np.float32)
    noisy = np.zeros((b, m, 7), np.float32)
    resid = np.zeros((b, m, 2), np.float32)
    for i in range(b):
        for j in range(m):
            cx, cy = rng.uniform(-8, 8, 2)
            dz = rng.uniform(-0.3, 0.3)
            dh = rng.uniform(-0.2, 0.2)
            true_z, true_h = -1.0 + dz, 1.56 + dh
            noisy[i, j] = [cx, cy, -1.0, 1.6, 3.9, 1.56, 0.0]
            resid[i, j] = [dz, dh]
            k = n // m
            local = rng.uniform([-1.8, -0.7, -true_h / 2],
                                [1.8, 0.7, true_h / 2], (k, 3))
            pts[i, j * k:(j + 1) * k] = local + [cx, cy, true_z]
    return pts, noisy, resid


class Refiner(torch.nn.Module):
    """The second stage of tests/test_second_stage_e2e.py::Refiner at the
    JAX package's default widths: crop_detections (REFINE_SAMPLED points a
    RoI), PointModule(3 * REFINE_SAMPLED, REFINE_LAYERS), RegHead."""

    def __init__(self, extra_width=1.0):
        from det3d_tpu_torch.models.necks import PointModule
        from det3d_tpu_torch.models.second_stage import RegHead
        super().__init__()
        self.extra_width = extra_width
        self.point = PointModule(3 * REFINE_SAMPLED, REFINE_LAYERS)
        self.head = RegHead(tasks=[dict(num_class=1, class_names=["Car"])],
                            in_channels=REFINE_LAYERS[-1])

    def forward(self, points, boxes):
        from det3d_tpu_torch.models.second_stage import crop_detections
        crops, empty = crop_detections(points, None, boxes,
                                       pool_extra_width=self.extra_width,
                                       sampled_pt_num=REFINE_SAMPLED)
        b, m = crops.shape[:2]
        preds = self.head(self.point(crops.reshape(b * m, -1)))
        return [p.reshape(b, m, 2) for p in preds], empty


def loss_metric_cases(rng):
    """Seeded inputs of the six losses no shipped config uses and of the
    five streaming metrics: (kind, name, object, numpy args)."""
    from det3d_tpu_torch.models import losses as L
    from det3d_tpu_torch.models import metrics as M
    logits = rng.normal(0, 2, (2, 64, 3)).astype(np.float32)
    target = (rng.uniform(size=(2, 64, 3)) > 0.7).astype(np.float32)
    reg = rng.normal(0, 1, (2, 64, 7)).astype(np.float32)
    reg_t = rng.normal(0, 1, (2, 64, 7)).astype(np.float32)
    w = rng.uniform(0, 1, (2, 64)).astype(np.float32)
    x1 = rng.uniform(0, 20, (64, 2))
    boxes = np.concatenate([x1, x1 + rng.uniform(1, 10, (64, 2))],
                           -1).astype(np.float32)
    boxes_t = boxes + rng.uniform(-2, 2, boxes.shape).astype(np.float32)
    labels = rng.randint(-1, 2, (2, 64)).astype(np.int64)
    return [
        ("loss", "GHMCLoss", L.GHMCLoss(), (logits, target, w)),
        ("loss", "GHMRLoss", L.GHMRLoss(), (reg, reg_t, w)),
        ("loss", "BalancedL1Loss", L.BalancedL1Loss(), (reg, reg_t, w)),
        ("loss", "IoULoss", L.IoULoss(), (boxes, boxes_t, w[0])),
        ("loss", "BoundedIoULoss", L.BoundedIoULoss(), (boxes, boxes_t,
                                                        w[0])),
        ("loss", "BootstrappedSigmoidClassificationLoss",
         L.BootstrappedSigmoidClassificationLoss(), (logits, target, w)),
        ("metric", "Scalar", M.Scalar(), (np.float32(2.5),)),
        ("metric", "Accuracy", M.Accuracy(), (labels, logits[..., :1])),
        ("metric", "Precision", M.Precision(), (labels, logits[..., :1])),
        ("metric", "Recall", M.Recall(), (labels, logits[..., :2])),
        ("metric", "PrecisionRecall",
         M.PrecisionRecall(thresholds=(0.2, 0.5, 0.8)),
         (labels, logits[..., :1])),
    ]


def capture_launches(step, data):
    """Capture a CapturedStep on ``data`` (after its warm-up) and return
    the kernels' launches counted during the capture."""
    from det3d_tpu_torch.ops.nms_cuda import rotated_nms_keep
    from det3d_tpu_torch.ops.window_conv_cuda import window_conv
    step.warm_up(data)
    window_conv.launches = rotated_nms_keep.launches = 0
    step.capture(data)
    torch.cuda.synchronize()
    return {"window_conv": window_conv.launches,
            "rotated_nms_keep": rotated_nms_keep.launches}


def phase_two_stage(dev, sec_batch, smi):
    """Phase 74: SECOND as shipped, captured, feeds its detections (up to
    max_per_img = 100 a scan, the NMS kernel launched inside the graph)
    to the second stage at the JAX package's widths: crop_detections
    (REFINE_SAMPLED points a RoI) over the scans' points, PointModule
    (1536 -> 1024 -> 128), RegHead. Card vs CPU: the crop indices and
    ``empty`` equal, RegHead's outputs within REFINE_TOL; crop + refine
    timed alone. Then the refiner trained REFINE_STEPS Adam steps on
    refine_scene (B=2, REFINE_BOXES boxes a scan): the last loss below a
    tenth of the first, the JAX test's threshold. Then the six losses
    and the five metrics on card tensors against the CPU. Returns
    {"crop_refine_ms", "launches", "nms"}."""
    from det3d_tpu_torch.models.builder import init_weights
    from det3d_tpu_torch.ops import roi
    from det3d_tpu_torch.parallel.predict import make_predict_step
    label = "phase 74 two-stage"
    model, vg, asg, cids, test_cfg, plan_fn = second_stack(dev)
    step = make_predict_step(model, vg, asg, cids, test_cfg)
    data = dict(sec_batch, **plan_fn(sec_batch["points"],
                                     sec_batch["num_points"]))
    launched = capture_launches(step, data)
    if launched != {"window_conv": SECOND_LAUNCHES, "rotated_nms_keep": 1}:
        raise AssertionError(f"{label}: first stage captured {launched}")
    det = step(data)
    boxes, valid = det["box3d_lidar"], det["valid"]
    nms = nms_entry(step_nms_inputs(lambda: step.eager(data)), label, smi)
    pts = torch.as_tensor(sec_batch["points"][..., :3], device=dev)
    with torch.no_grad():
        masks = [roi.points_in_boxes3d(p, b, 1.0) for p, b in
                 ((pts, boxes), (pts.cpu(), boxes.cpu()))]
        (i_d, f_d), (i_c, f_c) = (roi._first_k_indices(m, REFINE_SAMPLED)
                                  for m in masks)
        if not (torch.equal(i_d.cpu(), i_c) and torch.equal(f_d.cpu(), f_c)):
            raise AssertionError(f"{label}: crop indices card vs CPU differ")
        ref = Refiner()
        init_weights(ref, torch.Generator().manual_seed(0))
        ref_d = copy.deepcopy(ref).to(dev).eval()
        (p_d,), e_d = ref_d(pts, boxes)
        (p_c,), e_c = ref.eval()(pts.cpu(), boxes.cpu())
        err = float((p_d.cpu() - p_c).abs().max())
        if not torch.equal(e_d.cpu(), e_c):
            raise AssertionError(f"{label}: empty card vs CPU differs")
        if not torch.allclose(p_d.cpu(), p_c, **REFINE_TOL):
            raise AssertionError(f"{label}: RegHead card vs CPU {err}")
        ms = cuda_ms(lambda: ref_d(pts, boxes))
    log(f"{label} first stage: SECOND captured (window conv "
        f"{launched['window_conv']}, NMS {launched['rotated_nms_keep']} "
        f"launch inside the graph), {int(valid.sum())} valid of "
        f"{tuple(boxes.shape[:2])} detections; second stage on all: crop "
        f"indices ({int(f_c.sum())} points in {int((~e_c).sum())} RoIs) and "
        f"empty equal card vs CPU, RegHead (z, h) max abs err {err:.3e} "
        f"(tolerance {REFINE_TOL}); crop + refine alone {ms:.3f} ms for "
        f"{boxes.shape[0] * boxes.shape[1]} RoIs [{smi}]")
    del step, model
    # the refiner trained on the JAX test's scene at full widths
    pts_s, noisy, resid = (torch.as_tensor(a, device=dev) for a in
                           refine_scene(np.random.RandomState(SEED)))
    net = Refiner(extra_width=0.5)
    init_weights(net, torch.Generator().manual_seed(1))
    net = net.to(dev).train()
    opt = torch.optim.Adam(net.parameters(), lr=REFINE_LR)
    losses = []
    t0 = time.perf_counter()
    for _ in range(REFINE_STEPS):
        (pred,), _ = net(pts_s, noisy)
        loss = torch.mean((pred - resid) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    losses = [float(v) for v in losses]
    wall = (time.perf_counter() - t0) / REFINE_STEPS * 1e3
    with torch.no_grad():
        (pred,), empty = net.eval()(pts_s, noisy)
    mae = float((pred - resid).abs().mean())
    log(f"{label} refiner trained {REFINE_STEPS} Adam steps (lr {REFINE_LR})"
        f" on B={noisy.shape[0]} x {noisy.shape[1]} boxes: loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f} ({losses[-1] / losses[0]:.4f} "
        f"of the first; the JAX test's threshold 0.1), every 50th "
        f"{[round(v, 5) for v in losses[::50]]}; empty crops "
        f"{int(empty.sum())}, residual error {mae:.4f} (mean abs); "
        f"{wall:.2f} ms a step (host clock) [{smi}]")
    if not (np.isfinite(losses).all() and losses[-1] < 0.1 * losses[0]):
        raise AssertionError(f"{label}: refiner loss {losses[0]} -> "
                             f"{losses[-1]}")
    for kind, name, obj, args in loss_metric_cases(np.random.RandomState(0)):
        on = [[torch.as_tensor(a, device=d) for a in args]
              for d in (dev, "cpu")]
        if kind == "loss":
            got, want = (obj(*a) for a in on)
            err = float((got.cpu() - want).abs().max())
            ok = torch.allclose(got.cpu(), want, **LOSS_TOL)
        else:
            (s_d, _), (s_c, _) = (obj.update(obj.init(d), *a)
                                  for a, d in zip(on, (dev, "cpu")))
            err = max(float((s_d[k].cpu() - s_c[k]).abs().max())
                      for k in s_c)
            ok = all(torch.equal(s_d[k].cpu(), s_c[k]) for k in s_c)
        log(f"{label} {kind} {name} card vs CPU: max abs err {err:.3e}"
            + (f" (tolerance {LOSS_TOL})" if kind == "loss"
               else " (states equal)"))
        if not ok:
            raise AssertionError(f"{label}: {name} card vs CPU {err}")
    return {"crop_refine_ms": ms, "launches": launched, "nms": nms}


def deep_state(cfg, scan, dev):
    """calibrated_state for a deep grid, which no host plan holds: the BN
    statistics calibrated on the card in fp32 through the device voxels
    and the device plan."""
    from det3d_tpu_torch.apis.train import build_stack
    from det3d_tpu_torch.models.builder import init_weights
    from det3d_tpu_torch.parallel.predict import build_example
    model, vg, asg = build_stack(cfg, device="cpu")[:3]
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(dev)
    with torch.no_grad():
        ex = build_example({k: torch.as_tensor(v, device=dev)
                            for k, v in scan.items()}, vg, asg)
    calibrate_norms(model, lambda: model(
        ex["voxels"], ex["num_points_per_voxel"], ex["coordinates"]))
    with torch.no_grad():
        for name, w in model.named_parameters():
            if name.endswith("conv_box.weight"):
                w.mul_(BOX_GAIN)
    return {k: v.cpu() for k, v in model.state_dict().items()}


def deep_stack(cfg, state, device):
    """load_stack without a host plan builder (host plans refuse the
    grid)."""
    from det3d_tpu_torch.apis.train import build_stack
    model, vg, asg, cids, test_cfg = build_stack(cfg, device=device)
    model.load_state_dict(state)
    return model, vg, asg, cids, test_cfg, None


def phase_deep_grid(dev, smi):
    """Phase 75: SECOND with its voxels' z size halved to 0.05 m, a (81,
    1600, 1408) grid: res0 takes the dense table (182.5 M cells) and flat
    rulebooks, the later resolutions windows. The predict step from points
    alone at B=2 x 16384 (fp32, as every points-fed step): exactly
    DEEP_LAUNCHES window-conv launches and one NMS launch, captured
    (phase_captured), its peak memory; card vs CPU at B=1
    (card_vs_cpu_points: device voxels and plans equal, heads, decode).
    Then one training forward and backward of the middle alone on a cut
    (+-6.4 m, 512 voxels; flat per-tap backward at res0 and into stage
    1) card vs CPU, and a k3 / s1 strided window conv (3 output
    candidates a dim, no inverse rulebook: the flat per-tap dX) card vs
    CPU. Returns {"launches", "nms", "conv"}: the window conv at the
    layers of the device plan that take windows, the NMS kernel on the
    step's inputs."""
    from det3d_tpu_torch.apis.train import build_stack
    from det3d_tpu_torch.models.backbones import (build_plan_device,
                                                  middle_plan_spec)
    from det3d_tpu_torch.models.builder import init_weights
    from det3d_tpu_torch.ops import sparse as sp
    from det3d_tpu_torch.ops.window_conv_cuda import window_conv
    from det3d_tpu_torch.parallel.predict import build_example
    from det3d_tpu_torch.utils.synth import structured_batch
    label = "phase 75 deep grid"
    cfg = variant_config("deep", "fp32")
    batch = structured_batch(SECOND_B, POINTS,
                             cfg["voxel_generator"]["range"], seed=SEED)
    one = {k: v[:1] for k, v in batch.items()}
    state = deep_state(cfg, one, dev)
    stack = deep_stack(cfg, state, dev)
    grid = stack[1].grid_size
    log(f"{label} grid (nx, ny, nz) {tuple(grid)}: res0 depth {grid[2] + 1},"
        f" {(grid[2] + 1) * grid[1] * grid[0] / 1e6:.1f} M cells")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    st, launches, nms_in, cap = points_step(
        dev, stack, batch, (SECOND_B, 100, 7), DEEP_LAUNCHES,
        (SECOND_B, 1000, SECOND_NMS_THR), label, smi)
    peak = torch.cuda.max_memory_allocated() - resident
    log(f"{label} predict from points: launches {launches}, peak memory "
        f"{peak / 2**30:.2f} GiB above the resident "
        f"{resident / 2**30:.2f} GiB (eager steps and the capture) [{smi}]")
    card_vs_cpu_points(dev, stack, deep_stack(cfg, state, "cpu"), one, label)
    with torch.no_grad():
        ex = build_example({k: torch.as_tensor(v, device=dev)
                            for k, v in batch.items()}, stack[1], stack[2])
    spec = middle_plan_spec(stack[0].backbone, grid, stack[1].max_voxels,
                            host=False)
    dplan = {f"plan_{k}": v for k, v in build_plan_device(
        ex["coordinates"], spec).items()}
    dplan.update(tail_plan(stack[0], dplan, dev))
    res = {"launches": cap["launches"], "nms": nms_entry(nms_in, label, smi),
           "conv": conv_entry(dev, {k: v for k, v in dplan.items()
                                    if torch.is_tensor(v)},
                              DEEP_LAYERS, "fp32", label, smi)}
    del st, stack, dplan
    gc.collect()
    torch.cuda.empty_cache()

    cut = variant_config("deep", "fp32", cut=DEEP_CUT)
    model, vg, asg = build_stack(cut, device="cpu")[:3]
    init_weights(model, torch.Generator().manual_seed(0))
    scene = sparse_train_scene("second", SECOND_B,
                               cut["voxel_generator"]["range"], POINTS)
    with torch.no_grad():
        ex = build_example({k: torch.as_tensor(scene[k]) for k in (
            "points", "num_points")}, vg, asg)
    sub = {"voxels": ex["voxels"], "coordinates": ex["coordinates"]}
    mid = model.backbone
    cpu = middle_fwd_bwd(mid, sub, "cpu", vg.grid_size)
    card = middle_fwd_bwd(copy.deepcopy(mid).to(dev), sub, dev,
                          vg.grid_size)
    check_fwd_bwd(f"{label} training middle on a +-{DEEP_CUT[0]} m cut "
                  f"({DEEP_CUT[1]} voxels)", card, cpu,
                  DEEP_TRAIN_LAUNCHES)

    # a strided window conv with 3 output candidates a dim
    shape = (41, vg.grid_size[1] // 2, vg.grid_size[0] // 2)
    g = torch.Generator().manual_seed(4)
    co = torch.stack([torch.randint(0, s, (SECOND_B, 2000), generator=g)
                      for s in shape], -1).to(torch.int32)
    _, co, lookup = sp.stage_lookup_batch(co, shape)
    out_co, _ = sp.conv_out_coords(co, shape, 3, 1, 1, 4000)
    packed = sp.pack_windows(*sp.conv_window_rulebook_batch(
        shape, out_co, 3, 1, 1, lookup))
    x = torch.randn(SECOND_B, 2000, 32, generator=g)
    w = torch.randn(27, 32, 64, generator=g) / 27 ** 0.5
    dy = torch.randn(SECOND_B, packed.shape[1], 64, generator=g)
    runs = []
    for device in ("cpu", dev):
        xd = x.detach().to(device).requires_grad_(True)
        wd = w.detach().to(device).requires_grad_(True)
        out = window_conv(xd, packed.to(device), wd, False)
        (out * dy.to(device)).sum().backward()
        runs.append([t.detach().cpu() for t in (out, xd.grad, wd.grad)])
    errs = [rel_l2(a, b) for a, b in zip(runs[1], runs[0])]
    log(f"{label} k3/s1 strided window conv (ncand 3, no inverse rulebook) "
        f"B={SECOND_B} V=2000 O={packed.shape[1]}: card vs CPU relative L2 "
        f"out {errs[0]:.3e}, dX (flat per-tap scatter-add) {errs[1]:.3e}, "
        f"dW (the dW kernel) {errs[2]:.3e} (limit {VARIANT_OUT_REL})")
    if not max(errs) <= VARIANT_OUT_REL:
        raise AssertionError(f"{label}: k3/s1 conv card vs CPU {errs}")
    return res


def phase_counts(dev, smi):
    """Phase 76: utils/flops.py's count of every step an earlier phase of
    this run captured and timed (STEP_COUNTS: GFLOP, GB, GFLOP in the
    port's kernels) and its share of the card's peak and of its HBM rate
    at that phase's captured ms from the card (not timed again); then the
    flagship's predict step at B=8 counted on the card and on the CPU:
    every stage's convolutions and products equal, and the NMS kernel's
    count (data-dependent: what the step feeds it) equal to its rule on
    the CPU on the card step's own NMS inputs."""
    from det3d_tpu_torch.parallel.predict import make_predict_step
    from det3d_tpu_torch.utils.synth import structured_batch
    from det3d_tpu_torch.apis.flagship import PC_RANGE
    label = "phase 76"
    for lbl, (counter, ms, b) in STEP_COUNTS.items():
        t = counter.totals()
        peak, hbm = flop_counts.share(counter, ms)
        log(f"{label} {lbl} B={b}: {t['flops'] / 1e9:.3f} GFLOP, "
            f"{t['bytes'] / 1e9:.3f} GB, {t['kernel_flops'] / 1e9:.4f} GFLOP "
            f"in the port's kernels; captured {ms:.3f} ms from the card: "
            f"{peak:.4f} of peak, {hbm:.4f} of HBM [{smi}]")
    batch = structured_batch(B, POINTS, PC_RANGE, seed=SEED)
    counts, nms_in = {}, None
    for device in (dev, "cpu"):
        model, vg, asg, cids, test_cfg = flagship_stack(device)
        step = make_predict_step(model, vg, asg, cids, test_cfg)
        data = {k: torch.as_tensor(v, device=device)
                for k, v in batch.items()}
        counts[str(device)] = flop_counts.count_step(
            lambda: step.eager(data), model)
        if device == dev:
            nms_in = step_nms_inputs(lambda: step.eager(data))
    card, cpu = counts[str(dev)], counts["cpu"]
    for name in flop_counts.STAGES:
        sc, sp_ = card.stages[name], cpu.stages[name]
        aten = (sc["flops"] - sc["kernel_flops"], sc["bytes"])
        if name != "decode+nms" and (sc["flops"], sc["bytes"]) != (
                sp_["flops"], sp_["bytes"]):
            raise AssertionError(f"{label}: flagship {name} count card "
                                 f"{sc} vs CPU {sp_}")
        if name == "decode+nms" and aten[0] != sp_["flops"] - sp_[
                "kernel_flops"]:
            raise AssertionError(f"{label}: flagship decode count differs")
        log(f"{label} flagship B={B} {name}: card {sc['flops'] / 1e9:.4f} "
            f"GFLOP {sc['bytes'] / 1e9:.4f} GB ({sc['kernel_flops'] / 1e9:.6f}"
            f" in kernels), CPU {sp_['flops'] / 1e9:.4f} GFLOP "
            f"{sp_['bytes'] / 1e9:.4f} GB ({sp_['kernel_flops'] / 1e9:.6f} in "
            f"kernels)")
    _, rule = flop_counts.nms_work(*(t.cpu() for t in nms_in[:3]))
    if rule != card.stages["decode+nms"]["kernel_flops"]:
        raise AssertionError(f"{label}: the card's NMS count "
                             f"{card.stages['decode+nms']['kernel_flops']} vs"
                             f" its rule on the CPU {rule}")
    tc, tp = card.totals(), cpu.totals()
    log(f"{label} flagship B={B} predict: card {tc['flops'] / 1e9:.4f} GFLOP"
        f" {tc['bytes'] / 1e9:.4f} GB, CPU {tp['flops'] / 1e9:.4f} GFLOP "
        f"{tp['bytes'] / 1e9:.4f} GB; convolutions and products equal "
        f"stage by stage; the NMS count {rule:.0f} equal to its rule on the "
        f"CPU on the card's NMS inputs (the CPU step's own NMS count "
        f"{tp['kernel_flops']:.0f}: "
        + ("equal" if tp["kernel_flops"] == tc["kernel_flops"] else
           "its own inputs differ at the score threshold") + ")")
    return card


def variant_entries(res):
    """The JSON line's entries of phases 73-75's paths: the forward window
    conv and the NMS kernel on the VoxelNet and Nobn steps (host plans,
    bf16; paths "voxelnet", "nobn"), on the two-stage first stage (SECOND
    as shipped; its conv times are Nobn's, the same shapes on the same
    plan; path "second_two_stage") and on the deep grid from points (the
    windowed layers of its device plan, fp32; path "deep_points"), and the
    forward and backward kernels on RCNNSpMiddleFHD's training plan (path
    "rcnn_train"), each with the launches counted on its path."""
    conv_src = dict(name="window_conv", route="cuda",
                    source="det3d_tpu_torch/csrc/window_conv.cu",
                    replaces="det3d_tpu/ops/band_conv.py:216",
                    library_ms=None)
    nms_src = dict(name="rotated_nms_keep", route="cuda",
                   source="det3d_tpu_torch/csrc/rotated_nms.cu",
                   replaces="det3d_tpu/ops/nms_pallas.py:90", library_ms=None)
    stacks, (rcnn, rcnn_launches) = res[73]
    two = dict(res[74], conv=stacks["nobn"]["conv"])
    out = []
    for path, r in (("voxelnet", stacks["voxelnet"]),
                    ("nobn", stacks["nobn"]), ("second_two_stage", two),
                    ("deep_points", res[75])):
        c, n = r["conv"], r["nms"]
        out += [dict(conv_src, path=path, dtype=c["dtype"],
                     launches=r["launches"]["window_conv"],
                     max_abs_err=c["err"], ms=c["ms"], device_ms=c["device"],
                     plain_ms=c["plain"], bound_ms=c["bound_ms"],
                     bound_by=c["bound_by"]),
                dict(nms_src, path=path,
                     launches=r["launches"]["rotated_nms_keep"],
                     max_abs_err=0.0, ms=n["ms"], device_ms=n["device"],
                     plain_ms=n["plain"], bound_ms=n["bound_ms"],
                     bound_by=n["bound_by"])]
    f = rcnn["forward"]
    out.append(dict(conv_src, path="rcnn_train", dtype="fp32",
                    launches=rcnn_launches["window_conv"],
                    max_abs_err=f["err"], ms=f["ms"], device_ms=f["device"],
                    plain_ms=f["plain"], bound_ms=f["bound_ms"],
                    bound_by=f["bound_by"]))
    return out + bwd_entries("rcnn_train", rcnn, rcnn_launches)


def variants_phases(dev, smi):
    """Phases 73-76. Returns the JSON line's entries of their paths
    (variant_entries)."""
    from det3d_tpu_torch.utils.synth import structured_batch
    t0 = time.perf_counter()
    sec_range = second_config()["voxel_generator"]["range"]
    sec_batch = structured_batch(SECOND_B, POINTS, sec_range, seed=SEED)
    out = {}
    for phase, run in ((73, lambda: (phase_variant_stacks(dev, sec_batch,
                                                          smi),
                                     phase_rcnn_middle(dev, smi))),
                       (74, lambda: phase_two_stage(dev, sec_batch, smi)),
                       (75, lambda: phase_deep_grid(dev, smi)),
                       (76, lambda: phase_counts(dev, smi))):
        t = time.perf_counter()
        out[phase] = run()
        log(f"phase {phase} took {time.perf_counter() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phases 73-76 took {time.perf_counter() - t0:.1f} s")
    return variant_entries(out)


def dist_phases(dev, smi):
    """Phases 71 and 72. Returns {71: phase_dist's launches, 72:
    phase_nccl's}."""
    out = {}
    for phase, run in ((71, lambda: phase_dist(dev, smi)),
                       (72, lambda: phase_nccl(dev, smi))):
        t = time.perf_counter()
        out[phase] = run()
        log(f"phase {phase} took {time.perf_counter() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dist_entries(kernels, dist):
    """The JSON line's entries of phases 71-72's paths: each kernel's
    numbers as this run measured them on the nearest path (the fp32 window
    conv at SECOND's shapes, phase 48; its backward kernels and subm dX on
    SECOND's training plan, phase 58; the NMS kernel at the flagship's
    shape, phases 3, 6 and 13), its launches counted on the path: path
    "second_dist" (one rank's train step, phase 71), "second_nccl" (the
    first call of phase 72's captured step: its warm-up and capture),
    "kitti_pp_dist_eval" (one rank's eval_detector, phase 71)."""
    by = {(e["name"], e.get("path")): e for e in kernels}
    out = []
    for path, n in (("second_dist", dist[71]["second"]),
                    ("second_nccl", dist[72])):
        out += [dict(by[("window_conv", "second_points")], path=path,
                     launches=n["window_conv"]),
                dict(by[("window_conv", "second_train_subm_dx")],
                     path=f"{path}_subm_dx",
                     launches=n["window_conv_subm_dx"]),
                dict(by[("window_conv_dw", "second_train")], path=path,
                     launches=n["window_conv_dw"]),
                dict(by[("window_conv_inv", "second_train")], path=path,
                     launches=n["window_conv_inv"])]
    nms = {k: v for k, v in by[("rotated_nms_keep", None)].items()
           if k != "launches_by_path"}
    out.append(dict(nms, path="kitti_pp_dist_eval",
                    launches=dist[71]["eval"]["rotated_nms_keep"]))
    return out


# ---------------------------------------------------------------------------
# phases 77-80: the last modules (PointNet++, the temporal block, the image
# backbones and FPN, visualization), each at a published width
# ---------------------------------------------------------------------------

# PointRCNN's RPN backbone (sshaoshuai/PointRCNN, cfgs/default.yaml:
# RPN.SA_CONFIG and RPN.FP_MLPS, USE_INTENSITY False): 16384 points a
# scan, xyz only. The JAX package's mlp lists are output widths, so they
# are the config's lists as they stand
RCNN_B, RCNN_POINTS, RCNN_INVALID = 2, 16384, 1000
RCNN_NPOINTS = (4096, 1024, 256, 64)
RCNN_RADII = ((0.1, 0.5), (0.5, 1.0), (1.0, 2.0), (2.0, 4.0))
RCNN_NSAMPLES = ((16, 32),) * 4
RCNN_MLPS = (((16, 16, 32), (32, 32, 64)), ((64, 64, 128), (64, 96, 128)),
             ((128, 196, 256), (128, 196, 256)),
             ((256, 256, 512), (256, 384, 512)))
RCNN_FP = ((128, 128), (256, 256), (512, 512), (512, 512))
# card vs CPU, relative L2: the SA + FP forward in eval mode (the same
# points grouped on both, the sums in other orders), and one training
# step's gradients against the CPU's in float64. Each group's max-pool
# sends its gradient to its largest slot, and slots within rounding of
# each other send it elsewhere in fp32 than in float64: on the CPU fp32
# itself moves the gradients ~3e-3 (median) to ~8e-3 (worst) from float64.
# So the card's median and worst distances to float64 are held within
# GRAD_SPREAD x the CPU's fp32 ones (and POINT_GRAD_REL)
POINT_REL, POINT_GRAD_REL, GRAD_SPREAD = 1e-4, 1e-3, 3.0
# the expanded distance |a|^2 - 2ab + |b|^2 in fp32 is exact to about
# D2_ULPS units of 2^-24 (|a|^2 + |b|^2): at 70 m that is ~3e-3 m^2, so two
# devices' products may put a candidate on either side of a radius or of
# another candidate within it (and give a point's distance to itself as 0
# or as ~1e-4 m^2)
D2_ULPS = 8
# the flagship's neck output (3 x 128 channels at half the 496 x 432
# grid), two frames, through AlignFeatureAndAggregation(384, 9)
TEMPORAL_CH, TEMPORAL_NEIGHBOR, TEMPORAL_REL = 384, 9, 1e-4
# mmdetection configs/faster_rcnn_r50_fpn_1x.py: ResNet-50 (out_indices
# 0-3, frozen_stages 1, norm_eval), FPN [256, 512, 1024, 2048] -> 256, 5
# outputs, on a KITTI image (375 x 1242 padded to a multiple of 32)
IMAGE_B, IMAGE_HW = 2, (384, 1248)
SSD_B = 8
IMAGE_REL = 1e-4


class PointNet2Rpn(torch.nn.Module):
    """PointRCNN's RPN backbone (lib/net/pointnet2_msg.py) on the port's
    modules: four MSG set abstractions and four feature propagations, as
    the reference wires them (FP k takes level k+1's features, or the last
    SA's, and level k's as its skip). forward(xyz, valid) -> (features
    (B, N, 128), each level's xyz, each level's valid)."""

    def __init__(self):
        super().__init__()
        from det3d_tpu_torch.models.point_modules import (PointnetFPModule,
                                                          PointnetSAModuleMSG)
        self.sa = torch.nn.ModuleList()
        widths = [0]
        for npoint, radii, ns, mlps in zip(RCNN_NPOINTS, RCNN_RADII,
                                           RCNN_NSAMPLES, RCNN_MLPS):
            self.sa.append(PointnetSAModuleMSG(npoint, radii, ns, mlps,
                                               in_channels=widths[-1]))
            widths.append(sum(m[-1] for m in mlps))
        self.fp = torch.nn.ModuleList(
            PointnetFPModule(mlp, in_channels=(
                RCNN_FP[k + 1][-1] if k + 1 < len(RCNN_FP) else widths[-1])
                + widths[k])
            for k, mlp in enumerate(RCNN_FP))

    def forward(self, xyz, valid):
        xyzs, feats, valids = [xyz], [None], [valid]
        for sa in self.sa:
            x, f, v = sa(xyzs[-1], feats[-1], valids[-1])
            xyzs.append(x)
            feats.append(f)
            valids.append(v)
        for i in range(-1, -len(self.fp) - 1, -1):
            feats[i - 1] = self.fp[i](xyzs[i - 1], xyzs[i], feats[i - 1],
                                      feats[i], known_valid=valids[i])
        return feats[0], xyzs, valids


def rcnn_points(dev):
    """B=2 KITTI scans of 16384 points (train_scene: car-sized clusters and
    clutter over the flagship's range), xyz only, the last RCNN_INVALID
    rows of scan 1 padding (invalid)."""
    from det3d_tpu_torch.apis.flagship import PC_RANGE
    pts = train_scene(RCNN_B, RCNN_POINTS, PC_RANGE)["points"][..., :3]
    valid = np.ones((RCNN_B, RCNN_POINTS), bool)
    valid[1, -RCNN_INVALID:] = False
    return (torch.from_numpy(np.ascontiguousarray(pts)).to(dev),
            torch.from_numpy(valid).to(dev))


def fps_gap(xyz, valid, sel, m):
    """The gap between the two largest running minima FPS compares at its
    step m, on the CPU from the selection ``sel`` of steps before m."""
    dist = torch.full(valid.shape, float("inf")).masked_fill(~valid,
                                                             float("-inf"))
    for j in range(m):
        d = ((xyz - xyz[sel[j]]) ** 2).sum(-1)
        dist = torch.minimum(dist, d.masked_fill(~valid, float("-inf")))
    top = torch.topk(dist, 2).values
    return float(top[0] - top[1])


def float64_copy(model):
    """A float64 copy of ``model`` on the CPU, its BatchNorms returning
    float64 too."""
    from det3d_tpu_torch.models.norm import MaskedBatchNorm
    out = copy.deepcopy(model).cpu().double()
    for m in out.modules():
        if isinstance(m, MaskedBatchNorm):
            m.dtype = torch.float64
    return out


def d2_bound(a, b):
    """The expanded distance's rounding bound (float64) between points a
    and b (..., 3)."""
    return D2_ULPS * 2.0 ** -24 * ((a.double() ** 2).sum(-1)
                                   + (b.double() ** 2).sum(-1))


def ball_rows_explained(args, out, ref):
    """(rows, rows that differ card vs CPU, of them rows with no valid
    candidate within d2_bound of r^2) of one ball query."""
    xyz, centers, radius, valid = args
    differ = ((out[0].cpu() != ref[0]) | (out[1].cpu() != ref[1])).any(-1)
    bad = 0
    for b, m in differ.nonzero().tolist():
        d2 = ((xyz[b].double() - centers[b, m].double()) ** 2).sum(-1)
        near = (d2 - radius * radius).abs() <= d2_bound(xyz[b], centers[b, m])
        bad += not bool((near & valid[b]).any())
    return differ.numel(), int(differ.sum()), bad


def nn_rows_explained(args, out, ref):
    """(rows, rows whose 3-NN set differs card vs CPU, of them rows where a
    point of the difference lies farther than d2_bound from the third
    smallest d2, and rows of the same set whose squared distances differ
    by more than d2_bound) of one three_nn."""
    unknown, known, valid = args
    dist, idx = (t.cpu() for t in out)
    rdist, ridx = ref
    differ = (idx.sort(-1).values != ridx.sort(-1).values).any(-1)
    bad = 0
    for b, m in differ.nonzero().tolist():
        d2 = ((known[b].double() - unknown[b, m].double()) ** 2).sum(-1)
        if valid is not None:
            d2 = d2.masked_fill(~valid[b], float("inf"))
        third = d2.sort().values[2]
        odd = set(idx[b, m].tolist()) ^ set(ridx[b, m].tolist())
        bad += any(float((d2[j] - third).abs()) > 2 * float(
            d2_bound(known[b, j], unknown[b, m])) for j in odd)
    near = known.gather(1, ridx.reshape(ridx.shape[0], -1, 1).expand(
        -1, -1, 3)).reshape(*ridx.shape, 3)
    gap = (dist.double() ** 2 - rdist.double() ** 2).abs()
    same = ~differ[..., None] & (gap > 2 * d2_bound(near, unknown[:, :, None]))
    return differ.numel(), int(differ.sum()), bad + int(same.any(-1).sum())


class Decisions:
    """The ball queries' and 3-NN's results of a CPU forward, held against
    a card forward's: ``record()`` keeps each call's inputs and result;
    under ``replay()`` each card call's result is checked against the
    recorded one (ball_rows_explained, nn_rows_explained: it may differ
    only where the expanded distance's rounding decides) and the recorded
    one goes on, so that the rest of the card's forward computes on the
    CPU's groups and distances and the two outputs differ by arithmetic
    alone."""

    def __init__(self):
        self.calls, self.checked = [], {"ball": [0, 0, 0], "nn": [0, 0, 0]}

    @contextlib.contextmanager
    def _patched(self, replay):
        from det3d_tpu_torch.ops import pointnet2 as p2
        ball_query, three_nn = p2.ball_query, p2.three_nn
        recorded = iter(self.calls)

        def check(kind, out, like):
            args, ref = next(recorded)[1:]
            rows = (ball_rows_explained if kind == "ball"
                    else nn_rows_explained)(args, out, ref)
            self.checked[kind] = [a + b for a, b in
                                  zip(self.checked[kind], rows)]
            return tuple(r.to(like.device, like.dtype)
                         if r.is_floating_point() else r.to(like.device)
                         for r in ref)

        def ball(xyz, new_xyz, radius, nsample, valid=None, chunk=1024):
            out = ball_query(xyz, new_xyz, radius, nsample, valid, chunk)
            if replay:
                return check("ball", out, xyz)
            self.calls.append(("ball", (xyz, new_xyz, radius, valid), out))
            return out

        def nn(unknown, known, valid=None):
            out = three_nn(unknown, known, valid)
            if replay:
                return check("nn", out, unknown)
            self.calls.append(("nn", (unknown, known, valid), out))
            return out

        p2.ball_query, p2.three_nn = ball, nn
        try:
            yield self
        finally:
            p2.ball_query, p2.three_nn = ball_query, three_nn

    def record(self):
        self.calls.clear()
        return self._patched(False)

    def replay(self):
        return self._patched(True)

    def again(self):
        """A checker of another forward against the same recorded calls."""
        other = Decisions()
        other.calls = self.calls
        return other

    def summary(self):
        (br, bd, bb), (nr, nd, nb) = (self.checked["ball"],
                                      self.checked["nn"])
        return (f"ball-query rows differing card vs CPU {bd} of {br}, "
                f"unexplained {bb}; 3-NN sets differing {nd} of {nr}, "
                f"unexplained (or distances past the bound) {nb}"), bb + nb


def phase_pointnet2(dev, smi):
    """Phase 77: PointRCNN's RPN backbone (PointNet2Rpn) at its published
    widths, B=2 x 16384 points, weights from init_weights with
    torch.Generator().manual_seed(0): FPS card vs CPU (equal; where not,
    the first step that differs and the gap between its two top
    candidates), every ball query and 3-NN of the forward card vs CPU
    (Decisions: they differ only where the expanded distance's rounding
    decides), the eval forward card vs CPU on the CPU's groups and
    distances within POINT_REL (and on its own, printed), eager and
    captured ms of FPS alone and of the whole forward, peak memory, its
    FLOP count and share of peak, and one training step's gradients card
    vs CPU within POINT_GRAD_REL."""
    from det3d_tpu_torch.models.builder import init_weights
    from det3d_tpu_torch.ops.pointnet2 import furthest_point_sample
    label = "phase 77"
    xyz_d, valid_d = rcnn_points(dev)
    xyz, valid = xyz_d.cpu(), valid_d.cpu()
    n0 = RCNN_NPOINTS[0]
    sel_d = furthest_point_sample(xyz_d, n0, valid_d).cpu()
    sel = furthest_point_sample(xyz, n0, valid)
    if torch.equal(sel_d, sel):
        log(f"{label} FPS {RCNN_POINTS} -> {n0} points B={RCNN_B} "
            f"({RCNN_INVALID} padded rows in scan 1): card == CPU, "
            f"{sel.numel()} indices, none of them padding: "
            f"{bool(valid.gather(1, sel).all())}")
    else:
        for b in range(RCNN_B):
            diff = (sel_d[b] != sel[b]).nonzero()
            if len(diff):
                m = int(diff[0])
                gap = fps_gap(xyz[b], valid[b], sel[b], m)
                log(f"{label} FPS scan {b}: first differing step {m} of "
                    f"{n0}, card {int(sel_d[b, m])} vs CPU "
                    f"{int(sel[b, m])}; the gap between the two top "
                    f"candidates there {gap:.3e}")
                if gap > 1e-5 * float(xyz[b].abs().max()) ** 2:
                    raise AssertionError(f"{label}: FPS differs card vs CPU "
                                         f"at a gap of {gap:.3e}")
    cpu = init_weights(PointNet2Rpn(), torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(dev)
    cpu.eval()
    card.eval()
    decisions = Decisions()
    with torch.no_grad():
        with decisions.record():
            out, xyzs, _ = cpu(xyz, valid)
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        free = card(xyz_d, valid_d)[0]
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
        with decisions.replay():
            out_d, xyzs_d, _ = card(xyz_d, valid_d)
        same = all(torch.equal(a.cpu(), b) for a, b in zip(xyzs_d, xyzs))
        err, err_free = rel_l2(out_d, out), rel_l2(free, out)
        checked, unexplained = decisions.summary()
        log(f"{label} SA + FP forward (eval) B={RCNN_B}: features "
            f"{tuple(out_d.shape)}, finite {bool(out_d.isfinite().all())}, "
            f"every level's sampled xyz card == CPU: {same}; {checked} "
            f"(bound {D2_ULPS} x 2^-24 (|a|^2 + |b|^2)); on the CPU's groups "
            f"and distances card vs CPU relative L2 {err:.2e} (tolerance "
            f"{POINT_REL:g}); each on its own groups {err_free:.2e}; peak "
            f"memory {peak:.2f} GiB above the inputs and weights [{smi}]")
        if (not same or unexplained or err > POINT_REL
                or not out_d.isfinite().all()):
            raise AssertionError(f"{label}: the forward differs card vs CPU")
        fps = functools.partial(furthest_point_sample, xyz_d, n0, valid_d)
        fwd = functools.partial(card, xyz_d, valid_d)
        times = {f"FPS {RCNN_POINTS} -> {n0}": (
                     cuda_ms(fps, warmup=1, repeat=5), graph_ms(fps, reps=1)),
                 "SA + FP forward": (cuda_ms(fwd, warmup=1, repeat=5),
                                     graph_ms(fwd, reps=1))}
        counter = flop_counts.count_step(fwd)
    for name, (eager, captured) in times.items():
        log(f"{label} {name} B={RCNN_B}: eager {eager:.3f} ms, captured "
            f"(one CUDA graph) {captured:.3f} ms [{smi}]")
    t = counter.totals()
    peak_share, hbm_share = flop_counts.share(counter,
                                              times["SA + FP forward"][1])
    log(f"{label} SA + FP forward count: {t['flops'] / 1e9:.3f} GFLOP (its "
        f"products), {t['bytes'] / 1e9:.3f} GB; at the captured ms "
        f"{peak_share:.4f} of the fp32 peak, {hbm_share:.4f} of HBM [{smi}]")

    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    cpu64 = float64_copy(cpu)
    grads, decisions = {}, Decisions()
    card_check = decisions.again()
    for name, model, x, replay in (
            ("cpu", cpu, xyz, decisions.record),
            ("card", card, xyz_d, card_check.replay),
            ("cpu64", cpu64, xyz.double(), decisions.again().replay)):
        model.train()
        model.zero_grad(set_to_none=True)
        with replay():
            (model(x, valid.to(x.device))[0]
             * cot.to(x.device, x.dtype)).sum().backward()
        grads[name] = {k: p.grad for k, p in model.named_parameters()}
    errs = {dev_: [rel_l2(grads[dev_][k].double(), ref)
                   for k, ref in grads["cpu64"].items()]
            for dev_ in ("card", "cpu")}
    (card_med, card_max), (cpu_med, cpu_max) = (
        (statistics.median(e), max(e)) for e in (errs["card"], errs["cpu"]))
    worst = list(grads["cpu64"])[errs["card"].index(card_max)]
    stats = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        card.buffers(), cpu.buffers()))
    checked, unexplained = card_check.summary()
    log(f"{label} one training step on the CPU's groups and distances "
        f"({checked}): {len(errs['card'])} gradients against the CPU's in "
        f"float64, relative L2 median / worst: card {card_med:.2e} / "
        f"{card_max:.2e} ({worst}), the CPU in fp32 {cpu_med:.2e} / "
        f"{cpu_max:.2e} (bound max({POINT_GRAD_REL:g}, {GRAD_SPREAD:g} x "
        f"the CPU's)); running statistics card vs CPU max abs {stats:.2e}")
    if (card_med > max(POINT_GRAD_REL, GRAD_SPREAD * cpu_med)
            or card_max > max(POINT_GRAD_REL, GRAD_SPREAD * cpu_max)
            or stats > 1e-4 or unexplained):
        raise AssertionError(f"{label}: training step differs card vs CPU")


def phase_temporal(dev, smi):
    """Phase 78: AlignFeatureAndAggregation(384, 9) on the flagship's neck
    output (reader, scatter and RPN at full widths on two B=2 structured
    scans: (2, 248, 216, 384)), weights from init_weights: card vs CPU, eager and
    captured ms, peak memory, the FLOP count (its convolutions) beside the
    window sums' operations."""
    from det3d_tpu_torch.apis.flagship import PC_RANGE
    from det3d_tpu_torch.models.builder import init_weights
    from det3d_tpu_torch.models.temporal import AlignFeatureAndAggregation
    from det3d_tpu_torch.parallel.train import build_example
    from det3d_tpu_torch.utils.synth import structured_batch
    label = "phase 78"
    model, vg, asg = flagship_stack(dev)[:3]
    frames = []
    with torch.no_grad():
        for seed in (SEED, SEED + 1):
            batch = structured_batch(2, POINTS, PC_RANGE, seed=seed)
            ex = build_example({k: torch.as_tensor(v, device=dev)
                                for k, v in batch.items()}, vg, asg)
            coors = ex["coordinates"]
            x = model.reader(ex["voxels"], ex["num_points_per_voxel"], coors)
            x = model.backbone(x, coors, model.grid_size)
            frames.append(model.neck(x).float())
    del model
    key, cur = frames
    log(f"{label} the flagship's neck output, two frames: "
        f"{tuple(key.shape)} each")
    if key.shape[-1] != TEMPORAL_CH:
        raise AssertionError(f"{label}: neck output {tuple(key.shape)}")
    cpu = init_weights(AlignFeatureAndAggregation(TEMPORAL_CH,
                                                  TEMPORAL_NEIGHBOR),
                       torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(dev)
    with torch.no_grad():
        ref = cpu(key.cpu(), cur.cpu())
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        out = card(key, cur)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
        err = rel_l2(out, ref)
        run = functools.partial(card, key, cur)
        eager, captured = cuda_ms(run, warmup=2, repeat=10), graph_ms(
            run, reps=1)
        counter = flop_counts.count_step(run)
    b, h, w, c = key.shape
    window = 2.0 * b * h * w * TEMPORAL_NEIGHBOR ** 2 * (64 + c)
    t = counter.totals()
    peak_share, hbm_share = flop_counts.share(counter, captured)
    log(f"{label} AlignFeatureAndAggregation({TEMPORAL_CH}, "
        f"{TEMPORAL_NEIGHBOR}): output {tuple(out.shape)}, finite "
        f"{bool(out.isfinite().all())}, card vs CPU relative L2 {err:.2e} "
        f"(tolerance {TEMPORAL_REL:g}); eager {eager:.3f} ms, captured "
        f"{captured:.3f} ms, peak memory {peak:.2f} GiB above its inputs "
        f"[{smi}]")
    log(f"{label} count: {t['flops'] / 1e9:.3f} GFLOP in its convolutions "
        f"({peak_share:.4f} of the fp32 peak, {hbm_share:.4f} of HBM at the "
        f"captured ms), and {window / 1e9:.3f} GFLOP in the window sums "
        f"(correlation and align, elementwise, which the counter does not "
        f"see): {(t['ops_ms'] + window / FP32_FLOPS * 1e3) / captured:.4f} "
        f"of the fp32 peak together [{smi}]")
    if err > TEMPORAL_REL or not out.isfinite().all():
        raise AssertionError(f"{label}: output differs card vs CPU")


class ResNetFPN(torch.nn.Module):
    """faster_rcnn_r50_fpn_1x.py's backbone and neck: forward(x NHWC) ->
    FPN's five NHWC maps."""

    def __init__(self):
        super().__init__()
        from det3d_tpu_torch.models.builder import build_backbone, build_neck
        self.backbone = build_backbone(dict(
            type="ResNet", depth=50, num_stages=4, out_indices=(0, 1, 2, 3),
            frozen_stages=1, style="pytorch"))
        self.neck = build_neck(dict(
            type="FPN", in_channels=[256, 512, 1024, 2048],
            out_channels=256, num_outs=5))

    def forward(self, x):
        return self.neck(list(self.backbone(x)))


def image_case(dev, name, build, shape, smi, label):
    """One image model in eval mode: weights from init_weights, a seeded
    NHWC input of ``shape``; ms (CUDA events) and peak memory, the output
    shapes, the first sample's outputs card vs CPU within IMAGE_REL, the
    FLOP count and share. Returns (card model, input)."""
    from det3d_tpu_torch.models.builder import init_weights
    cpu = init_weights(build(), torch.Generator().manual_seed(0)).eval()
    card = copy.deepcopy(cpu).to(dev).eval()
    x = torch.randn(shape, generator=torch.Generator().manual_seed(2))
    x_d = x.to(dev)
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        outs = card(x_d)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
        refs = cpu(x[:1])
        errs = [rel_l2(o[:1], r) for o, r in zip(outs, refs)]
        run = functools.partial(card, x_d)
        ms = cuda_ms(run, warmup=2, repeat=10)
        counter = flop_counts.count_step(run)
    t = counter.totals()
    peak_share, hbm_share = flop_counts.share(counter, ms)
    log(f"{label} {name} B={shape[0]} on {shape[1]} x {shape[2]}: "
        f"{ms:.3f} ms, peak memory {peak:.2f} GiB; outputs "
        f"{[tuple(o.shape[1:]) for o in outs]}; sample 0 card vs CPU "
        f"relative L2 {max(errs):.2e} at worst (tolerance {IMAGE_REL:g}); "
        f"{t['flops'] / 1e9:.2f} GFLOP, {peak_share:.4f} of the fp32 peak, "
        f"{hbm_share:.4f} of HBM [{smi}]")
    if max(errs) > IMAGE_REL or not all(o.isfinite().all() for o in outs):
        raise AssertionError(f"{label}: {name} differs card vs CPU")
    return card, x_d, outs


def phase_image(dev, smi):
    """Phase 79: ResNet-50 + FPN as in faster_rcnn_r50_fpn_1x.py on a
    (2, 384, 1248, 3) KITTI image, SENet-50 at the same input, SSDVGG300
    at B=8 (image_case each), then one training step of ResNet-50 + FPN:
    the frozen stem and stage 1 get no gradient, every other parameter a
    finite one, and under norm_eval no running statistic moves."""
    from det3d_tpu_torch.models.image_backbones import SENet, SSDVGG
    label = "phase 79"
    shape = (IMAGE_B,) + IMAGE_HW + (3,)
    model, x, outs = image_case(dev, "ResNet-50 + FPN", ResNetFPN, shape,
                                smi, label)
    want = [(IMAGE_HW[0] // s, IMAGE_HW[1] // s, 256)
            for s in (4, 8, 16, 32)]
    want.append(((want[-1][0] + 1) // 2, (want[-1][1] + 1) // 2, 256))
    if [tuple(o.shape[1:]) for o in outs] != want:
        raise AssertionError(f"{label}: FPN shapes {outs}")
    del outs
    image_case(dev, "SENet-50", lambda: SENet(depth=50), shape, smi, label)
    ssd = image_case(dev, "SSDVGG300", lambda: SSDVGG(input_size=300),
                     (SSD_B, 300, 300, 3), smi, label)[2]
    if [o.shape[1] for o in ssd] != [38, 19, 10, 5, 3, 1]:
        raise AssertionError(f"{label}: SSD300 pyramid {ssd}")

    before = {k: b.clone() for k, b in model.named_buffers()}
    model.train()

    def train_step():
        model.zero_grad(set_to_none=True)
        sum((o * o).mean() for o in model(x)).backward()

    train_step()
    frozen = ("backbone.Conv_0.", "backbone.MaskedBatchNorm_0.") + tuple(
        f"backbone.{n}." for n in model.backbone.stages[0])
    params = dict(model.named_parameters())
    bad = [k for k, p in params.items()
           if k.startswith(frozen) != (p.grad is None)
           or (p.grad is not None and not p.grad.isfinite().all())]
    moved = [k for k, b in model.named_buffers()
             if not torch.equal(b, before[k])]
    ms = cuda_ms(train_step, warmup=1, repeat=5)
    n_frozen = sum(k.startswith(frozen) for k in params)
    log(f"{label} ResNet-50 + FPN training step B={IMAGE_B}: {ms:.3f} ms; "
        f"{n_frozen} parameters of the stem and stage 1 without a "
        f"gradient, the other {len(params) - n_frozen} with a finite one; "
        f"running statistics moved: {len(moved)} (norm_eval) [{smi}]")
    if bad or moved:
        raise AssertionError(f"{label}: frozen stages or norm_eval broken: "
                             f"{bad[:4]} {moved[:4]}")


def phase_visualization(dev, smi):
    """Phase 80: the flagship's captured predict step at B=8 (weights from
    init_weights, the NMS kernel's launches counted during its capture),
    its detections on scan 0 drawn by simplevis.kitti_vis through cv2
    where the host has it and through the numpy rasterizer, the scan and
    boxes written by viewer3d.export_ply, and netviz.summarize of the
    detector, whose total must equal its parameters' count. Returns the
    JSON line's entry of the NMS kernel on this path ("flagship_vis")."""
    import tempfile
    from det3d_tpu_torch.apis.flagship import PC_RANGE
    from det3d_tpu_torch.ops.nms_cuda import rotated_nms_keep
    from det3d_tpu_torch.parallel.predict import make_predict_step
    from det3d_tpu_torch.utils.synth import structured_batch
    from det3d_tpu_torch.visualization import netviz, simplevis, viewer3d
    label = "phase 80"
    model, vg, asg, cids, test_cfg = flagship_stack(dev)
    step = make_predict_step(model, vg, asg, cids, test_cfg)
    batch = structured_batch(B, POINTS, PC_RANGE, seed=SEED)
    rotated_nms_keep.launches = 0
    out = step(batch)
    launches = rotated_nms_keep.launches
    ms = cuda_ms(lambda: step(batch), warmup=1, repeat=5)
    counter = flop_counts.count_step(lambda: step.eager(batch), model)
    peak_share, hbm_share = flop_counts.share(counter, ms)
    t = counter.totals()
    valid = out["valid"][0].cpu().numpy()
    boxes = out["box3d_lidar"][0].cpu().numpy()[valid]
    pts = batch["points"][0, :int(batch["num_points"][0])]
    log(f"{label} flagship captured predict B={B}: {ms:.3f} ms a call, "
        f"{int(valid.sum())} detections on scan 0, NMS launches during the "
        f"first call (warm-up and capture) {launches}; {t['flops'] / 1e9:.3f}"
        f" GFLOP, {peak_share:.4f} of the fp32 peak, {hbm_share:.4f} of HBM "
        f"[{smi}]")
    if not len(boxes) or launches < 1:
        raise AssertionError(f"{label}: no detections or no NMS launch")
    canvases, host = {}, {}
    has_cv2 = simplevis._HAS_CV2
    for name, on in (("cv2", has_cv2), ("numpy", False)):
        if name == "cv2" and not has_cv2:
            continue
        simplevis._HAS_CV2 = on
        t0 = time.perf_counter()
        canvases[name] = simplevis.kitti_vis(pts, det_boxes=boxes,
                                             pc_range=PC_RANGE)
        host[name] = (time.perf_counter() - t0) * 1e3
    simplevis._HAS_CV2 = has_cv2
    with tempfile.TemporaryDirectory() as tmp:
        ply = Path(tmp) / "scan0.ply"
        t0 = time.perf_counter()
        viewer3d.export_ply(ply, pts, det_boxes=boxes)
        ply_ms = (time.perf_counter() - t0) * 1e3
        ply_bytes = ply.stat().st_size
        header = ply.read_text().splitlines()[2]
        for name, canvas in canvases.items():
            np.save(Path(tmp) / f"bev_{name}.npy", canvas)
    drawn = {k: int((c == (0, 128, 255)).all(-1).sum())
             for k, c in canvases.items()}
    table = netviz.summarize(model)
    total = sum(p.numel() for p in model.parameters())
    listed = int(table.splitlines()[-1].split()[-1].replace(",", ""))
    log(f"{label} kitti_vis canvases {canvases['numpy'].shape}: detection "
        f"pixels {drawn}, host ms {host} (cv2 on this host: {has_cv2}); "
        f"export_ply {ply_bytes} bytes ({header}), {ply_ms:.1f} ms; "
        f"netviz.summarize total {listed:,} = the parameters' count "
        f"{total:,}: {listed == total}")
    log(table)
    if (not all(drawn.values()) or ply_bytes == 0
            or header != f"element vertex {len(pts) + 8 * len(boxes)}"
            or listed != total):
        raise AssertionError(f"{label}: visualization output wrong")
    nms = nms_entry(step_nms_inputs(lambda: step.eager(batch)), label, smi)
    return dict(name="rotated_nms_keep", route="cuda",
                source="det3d_tpu_torch/csrc/rotated_nms.cu",
                replaces="det3d_tpu/ops/nms_pallas.py:90", library_ms=None,
                path="flagship_vis", launches=launches, max_abs_err=0.0,
                ms=nms["ms"], device_ms=nms["device"], plain_ms=nms["plain"],
                bound_ms=nms["bound_ms"], bound_by=nms["bound_by"])


def experiments_phases(dev, smi):
    """Phases 77-80. Returns the JSON line's entries of their paths (the
    NMS kernel on phase 80's flagship step; phases 77-79 launch neither
    kernel)."""
    from det3d_tpu_torch.ops.nms_cuda import rotated_nms_keep
    from det3d_tpu_torch.ops.window_conv_cuda import window_conv
    t0 = time.perf_counter()
    out = {}
    for phase, run in ((77, lambda: phase_pointnet2(dev, smi)),
                       (78, lambda: phase_temporal(dev, smi)),
                       (79, lambda: phase_image(dev, smi)),
                       (80, lambda: phase_visualization(dev, smi))):
        t = time.perf_counter()
        if phase < 80:
            rotated_nms_keep.launches = window_conv.launches = 0
        out[phase] = run()
        if phase < 80 and (rotated_nms_keep.launches or window_conv.launches):
            raise AssertionError(f"phase {phase} launched a kernel")
        log(f"phase {phase} took {time.perf_counter() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phases 77-80 took {time.perf_counter() - t0:.1f} s")
    return [out[80]]


def use_tree(tree):
    """Import det3d_tpu_torch from the checkout at ``tree`` (this one when
    None): its modules, imported with this script's bound rules
    (utils/flops.py), are dropped, so the next import reads the tree's."""
    if not tree:
        return
    sys.path.insert(0, str(Path(tree).resolve()))
    for name in [m for m in sys.modules
                 if m.split(".")[0] == "det3d_tpu_torch"]:
        del sys.modules[name]


def conv_timing_main(tree, prec, paths):
    """--conv-timing: phase 1, then for each of ``paths`` its host plan
    (plan_builder: the tree's own host_plan_fn) and the window-conv timing
    in ``prec`` on it (conv_timing; by default bf16 on SECOND's plan, fp32
    on Lyft's and KITTI-all's), with det3d_tpu_torch imported from
    ``tree``."""
    use_tree(tree)
    smi = phase_device()
    import det3d_tpu_torch
    from det3d_tpu_torch.utils.synth import structured_batch
    log(f"conv timing of {Path(det3d_tpu_torch.__file__).parent}")
    dev = torch.device("cuda", 0)
    for key in paths:
        if key == "second":
            cfg, layers = second_config(), SECOND_LAYERS
            batch = structured_batch(SECOND_B, POINTS,
                                     cfg["voxel_generator"]["range"],
                                     seed=SEED)
        else:
            path = FP32_PATHS[key]
            cfg, layers = path.config(), path.layers
            batch = path.scans(path.b, path.points)
        plan = plan_builder(cfg)(batch["points"], batch["num_points"])
        plan = {k: v for k, v in plan.items() if k.startswith("plan_")}
        plan.update(tail_plan(detector_of(cfg), plan, dev))
        conv_timing(dev, plan, smi,
                    prec or ("bf16" if key == "second" else "fp32"),
                    with_plan(layers, plan), f"conv-timing {key}")
    return 0


def bwd_timing_main(tree, paths):
    """--bwd-timing: phase 1, then for each of ``paths`` its host training
    plan (the tree's host_plan_fn(train=True)) and phase 58's checks and
    timing of the backward kernels on it (phase_bwd_kernels, with the
    im2col+mm yardsticks), with det3d_tpu_torch imported from ``tree``:
    SECOND (B=4 x 16384 points) and CBGS (B=2 x 300000) on phase 58's
    scenes, Lyft on its bench scans (B=2 x 300000 points over +-100.8 m)
    at its Cin-6 stem (LYFT_TRAIN_LAYERS)."""
    use_tree(tree)
    smi = phase_device()
    import det3d_tpu_torch
    log(f"backward timing of {Path(det3d_tpu_torch.__file__).parent}")
    dev = torch.device("cuda", 0)
    layers = {"second": SECOND_LAYERS, "cbgs": CBGS_LAYERS,
              "lyft": LYFT_TRAIN_LAYERS}
    sizes = {key: (b, points) for key, _, b, points in SPARSE_TRAIN}
    for key in paths:
        if key == "lyft":
            cfg = LYFT.config()
            data = with_train_plan(None, LYFT.scans(LYFT.b, LYFT.points),
                                   cfg=cfg)
        else:
            cfg = train_config(key)
            pc = cfg["voxel_generator"]["range"]
            b, points = sizes[key]
            data = with_train_plan(key, sparse_train_scene(key, b, pc,
                                                           points))
        data.update(tail_plan(detector_of(cfg), data, dev, train=True))
        phase_bwd_kernels(dev, data, with_plan(layers[key], data),
                          f"bwd-timing {key}", smi, yard=True)
        del data
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def build_timing_main(tree, paths):
    """--build-timing: phase 1, then phase 47's timing of the device voxels
    and plan (build_times) on each path's bench batch, with
    det3d_tpu_torch imported from ``tree``."""
    use_tree(tree)
    smi = phase_device()
    import det3d_tpu_torch
    from det3d_tpu_torch.apis.train import build_stack
    from det3d_tpu_torch.utils.synth import structured_batch
    log(f"device build timing of {Path(det3d_tpu_torch.__file__).parent}")
    dev = torch.device("cuda", 0)
    sec_range = second_config()["voxel_generator"]["range"]
    batches = {
        "second": (second_config(), structured_batch(
            SECOND_B, POINTS, sec_range, seed=SEED)),
        "kitti_all": (KITTI_ALL.config(), KITTI_ALL.scans(KITTI_ALL.b,
                                                          KITTI_ALL.points)),
        "cbgs": (cbgs_config(), cbgs_batch(
            CBGS_B, CBGS_POINTS, cbgs_config()["voxel_generator"]["range"])),
        "lyft": (LYFT.config(), LYFT.scans(LYFT.b, LYFT.points))}
    for key in paths:
        cfg, batch = batches[key]
        model, vg = build_stack(cfg, device="cpu")[:2]
        fn, spec = device_build(model, vg)
        pts = torch.as_tensor(batch["points"], device=dev)
        n = torch.as_tensor(batch["num_points"], device=dev)
        with torch.no_grad():
            t = build_times(vg, fn, spec, pts, n)
            split = kernel_split_ms(lambda: fn(pts, n), calls=5)
        log(f"build-timing {key} B={pts.shape[0]} P={pts.shape[1]}: "
            f"{t['device']:.3f} ms/batch on the device (one CUDA graph), "
            f"{t['both']:.3f} launched from Python (voxelize "
            f"{t['voxelize']:.3f}, plan {t['plan']:.3f}) [{smi}]")
        for name, ms in sorted(split.items(), key=lambda x: -x[1])[:8]:
            log(f"build-timing {key}   {ms:8.3f} ms a batch  {name[:90]}")
    return 0


def nms_timing_main(tree):
    """--nms-timing: phases 1 and 13, with det3d_tpu_torch imported from
    ``tree``."""
    use_tree(tree)
    smi = phase_device()
    import det3d_tpu_torch
    log(f"NMS timing of {Path(det3d_tpu_torch.__file__).parent}")
    nms_timing(torch.device("cuda", 0), smi, "nms-timing")
    return 0


def serving_phases(dev, smi):
    """Phases 3 to 50 and 46, 13: every serving path, in the order of the
    module docstring. Returns the entries of the kernels' JSON line."""
    nms_err = phase_kernel(dev)

    from det3d_tpu_torch.utils.synth import structured_batch
    from det3d_tpu_torch.apis.flagship import PC_RANGE
    batch = structured_batch(B, POINTS, PC_RANGE, seed=SEED)
    stack, state, flagship = phase_predict(dev, batch)
    phase_cpu(dev, stack[0], state, batch)
    nms_times = phase_timing(dev, stack, batch, smi)
    flagship_in = step_nms_inputs(lambda: stack[4].eager(batch))
    # the captured steps, kept for their profiles at the end, and what
    # phase_captured measured of each
    captured = {"flagship": stack[4]}
    caps = {"flagship": phase_captured(dev, stack[4], batch, flagship, smi,
                                       "phase 39 flagship")}
    del stack, state
    torch.cuda.empty_cache()

    sec_range = second_config()["voxel_generator"]["range"]
    sec_batch = structured_batch(SECOND_B, POINTS, sec_range, seed=SEED)
    plan, plan_ms = phase_second_plan(sec_batch)
    conv_err = phase_conv_kernel(dev, dict(plan, **tail_plan(
        detector_of(second_config()), plan, dev)))
    sec_stack, launches = phase_second_predict(dev, sec_batch, plan)
    phase_second_cpu(dev, sec_batch)
    conv = phase_second_timing(dev, sec_stack, plan_ms, smi)
    caps["second"] = phase_captured(dev, sec_stack[4], sec_stack[5],
                                    launches, smi, "phase 40 SECOND")

    cbgs_range = cbgs_config()["voxel_generator"]["range"]
    cbgs_data = cbgs_batch(CBGS_B, CBGS_POINTS, cbgs_range)
    cbgs_plan, cbgs_plan_ms = phase_cbgs_plan(cbgs_data)
    cbgs_conv_err = phase_conv_kernel(
        dev, dict(cbgs_plan, **tail_plan(detector_of(cbgs_config()),
                                         cbgs_plan, dev)),
        CBGS_LAYERS, "phase 15")
    cbgs_stack_, cbgs_launches, cbgs_in = phase_cbgs_predict(
        dev, cbgs_data, cbgs_plan)
    phase_cbgs_cpu(dev, cbgs_stack_)
    cbgs_conv, cbgs_nms = phase_cbgs_timing(dev, cbgs_stack_, cbgs_plan_ms,
                                            cbgs_in, smi)
    caps["cbgs"] = phase_captured(dev, cbgs_stack_[4], cbgs_stack_[5],
                                  cbgs_launches, smi, "phase 41 CBGS")

    # PointPillars as shipped: KITTI car on the flagship's batch through the
    # device voxelizer, nuScenes on CBGS's batch (the same range and
    # features) from host voxels
    kitti_stack, kitti_launches, kitti_in = pp_predict(
        dev, KITTI_PP_CFG, batch, {}, (B, 100, 7), (B, 1000, IOU_THR),
        "phase 20 KITTI car PointPillars (bf16)")
    nusc_vox, nusc_host_ms = phase_nusc_pp_voxels(dev, cbgs_data)
    nusc_stack, nusc_launches, nusc_in = pp_predict(
        dev, NUSC_PP_CFG, cbgs_data, nusc_vox, (CBGS_B, NUSC_PP_DETS, 9),
        (CBGS_B * 6, 1000, NUSC_PP_NMS_THR),
        "phase 22 nuScenes PointPillars (bf16)", min_labels=2)
    phase_pp_cpu(dev)
    pp_timing(dev, kitti_stack, None, kitti_in, smi,
              "phase 24 KITTI car PointPillars")
    nusc_nms = pp_timing(dev, nusc_stack, nusc_host_ms, nusc_in, smi,
                         "phase 24 nuScenes PointPillars")
    caps["kitti_pp"] = phase_captured(dev, kitti_stack[4], kitti_stack[5],
                                      kitti_launches, smi,
                                      "phase 42 KITTI car PointPillars")
    caps["nusc_pp"] = phase_captured(dev, nusc_stack[4], nusc_stack[5],
                                     nusc_launches, smi,
                                     "phase 43 nuScenes PointPillars")

    # the fp32 middles: Lyft on 300000-point scans over +-100.8 m (phases
    # 26-30), KITTI-all on SECOND's scans (31-35)
    fp32 = {p.key: run_fp32_path(dev, p, smi) for p in (LYFT, KITTI_ALL)}
    caps.update({k: v[6] for k, v in fp32.items()})
    # CBGS's middle with dense_from=3 and without the dense tail (38)
    phase_cbgs_variants(dev, cbgs_data, smi)

    # points alone: the device voxels and plans of the four sparse paths
    # against their host builds (47), SECOND and CBGS from points (48),
    # double-flip TTA on CBGS (49) and nuScenes PointPillars (50)
    builds = phase_device_plans(dev, {
        "second": ("phase 47 SECOND", second_config(), dict(
            sec_batch, **plan), plan_ms),
        "kitti_all": ("phase 47 KITTI-all SECOND", KITTI_ALL.config(),
                      fp32["kitti_all"][0][5], fp32["kitti_all"][7]),
        "cbgs": ("phase 47 CBGS", cbgs_config(), dict(cbgs_data,
                                                      **cbgs_plan),
                 cbgs_plan_ms),
        "lyft": ("phase 47 Lyft CBGS", LYFT.config(), fp32["lyft"][0][5],
                 fp32["lyft"][7])}, smi)
    points = phase_points_and_tta(dev, sec_batch, cbgs_data, smi)
    caps.update({k: v[3] for k, v in points.items()})
    for key, base in (("second_points", "second"), ("cbgs_points", "cbgs")):
        log(f"phase 48 {key}: captured step from points "
            f"{caps[key]['captured']:.3f} ms/batch (eager "
            f"{caps[key]['eager']:.3f}; from the card "
            f"{caps[key]['on_card']['captured']:.3f}) against the captured "
            f"step from host data {caps[base]['captured']:.3f} (from the "
            f"card {caps[base]['on_card']['captured']:.3f}), whose plan "
            f"the card builds in {builds[base]['device']:.3f} ms/batch "
            f"(phase 47) [{smi}]")

    # torch.profiler after every step is timed: each eager profile, then
    # the captured step's beside it (phase 46), the flagship's and KITTI
    # car PointPillars' captured steps alone; then the inputs the predict
    # steps feed the NMS kernel beside the synthetic cases
    stacks = {"second": sec_stack, "cbgs": cbgs_stack_,
              "kitti_pp": kitti_stack, "nusc_pp": nusc_stack,
              "lyft": fp32["lyft"][0], "kitti_all": fp32["kitti_all"][0]}
    stacks.update({k: v[0] for k, v in points.items()})
    captured.update({k: v[4] for k, v in stacks.items()})
    batches = {k: v[5] for k, v in stacks.items()}
    batches["flagship"] = batch
    eager_profiles = {
        "second": lambda: phase_profile(sec_stack, dev, smi),
        "cbgs": lambda: phase_profile(cbgs_stack_, dev, smi, steps=3,
                                      label="phase 19 CBGS", batch=CBGS_B),
        "nusc_pp": lambda: phase_profile(
            nusc_stack, dev, smi, label="phase 25 nuScenes PointPillars",
            batch=CBGS_B),
        "lyft": lambda: phase_profile(fp32["lyft"][0], dev, smi, steps=3,
                                      label=LYFT.label(5), batch=LYFT.b),
        "kitti_all": lambda: phase_profile(
            fp32["kitti_all"][0], dev, smi, steps=5,
            label=KITTI_ALL.label(5), batch=KITTI_ALL.b)}
    busy = {}
    for key, name in CAPTURED_PATHS:
        if key in eager_profiles:
            eager_profiles[key]()
        busy[key] = phase_captured_profile(
            dev, captured[key], batches[key], caps[key]["launches"], smi,
            f"phase 46 {name}")
    for key, name in CAPTURED_PATHS:
        c, share = caps[key], busy[key]
        share = (f"{share['busy'] / share['wall']:.2f} of the window "
                 f"({share['busy']:.3f} ms busy)" if share else
                 "not measured")
        log(f"captured steps: {name}: eager {c['eager']:.3f} ms/batch, "
            f"captured {c['captured']:.3f} ({c['eager'] / c['captured']:.2f}"
            f"x), copy {c['copy']['captured']:.3f} (eager "
            f"{c['copy']['eager']:.3f}); from the card: eager "
            f"{c['on_card']['eager']:.3f}, captured "
            f"{c['on_card']['captured']:.3f}; captured device busy {share} "
            f"[{smi}]")
    step, data = sec_stack[4], sec_stack[5]
    steps_in = (("flagship step B=8", flagship_in),
                ("SECOND step B=2", step_nms_inputs(lambda: step.eager(data))),
                ("CBGS step B=2", cbgs_in),
                ("KITTI car PointPillars step B=8", kitti_in),
                ("nuScenes PointPillars step B=2", nusc_in),
                ("Lyft CBGS step B=2", fp32["lyft"][2]),
                ("KITTI-all SECOND step B=2", fp32["kitti_all"][2])) + tuple(
                    (f"{k} step B=2", v[2]) for k, v in points.items())
    nms_dev = nms_timing(dev, smi, "phase 13", steps_in)
    nms_times["device"] = nms_dev["flagship N=8 K=1000"]["device"]

    nms_b_ms, nms_b_by, nms_all_ms = nms_bound(
        *nms_cases(dev)["flagship N=8 K=1000"])
    log(f"rotated NMS bound N=8 K=1000: {nms_b_ms:.7f} ms ({nms_b_by}; the "
        f"pairs these inputs need), {nms_all_ms:.7f} ms counting a full IoU "
        f"for every valid pair as before")
    cbgs_b_ms, cbgs_b_by, cbgs_all_ms = nms_bound(*cbgs_in[:3])
    log(f"rotated NMS bound on the CBGS step's inputs N=12 K=1000: "
        f"{cbgs_b_ms:.7f} ms ({cbgs_b_by}), {cbgs_all_ms:.7f} ms counting a "
        f"full IoU for every valid pair")
    bounds = {}
    for name, nms_in in (("kitti_pp", kitti_in), ("nusc_pp", nusc_in),
                         ("lyft", fp32["lyft"][2]),
                         ("kitti_all", fp32["kitti_all"][2])) + tuple(
                             (k, v[2]) for k, v in points.items()):
        bounds[name] = nms_bound(*nms_in[:3])
        log(f"rotated NMS bound on the {name} step's inputs "
            f"N={nms_in[0].shape[0]} K={nms_in[0].shape[1]}: "
            f"{bounds[name][0]:.7f} ms ({bounds[name][1]}), "
            f"{bounds[name][2]:.7f} ms counting a full IoU for every valid "
            f"pair")
    # launches: counted while each path's step, as a user calls it, was
    # captured (phases 39-45; equal to its eager step's)
    by_path = {name: {key: caps[key]["launches"][name]
                      for key, _ in CAPTURED_PATHS}
               for name in ("rotated_nms_keep", "window_conv")}
    nms_src = dict(name="rotated_nms_keep", route="cuda",
                   source="det3d_tpu_torch/csrc/rotated_nms.cu",
                   replaces="det3d_tpu/ops/nms_pallas.py:90")
    conv_src = dict(name="window_conv", route="cuda",
                    source="det3d_tpu_torch/csrc/window_conv.cu",
                    replaces="det3d_tpu/ops/band_conv.py:216")
    # the fp32 paths: the window conv's fp32 kernel and the NMS kernel on
    # each step's inputs
    fp32_entries = []
    for p, step_name in ((LYFT, "Lyft CBGS step B=2"),
                         (KITTI_ALL, "KITTI-all SECOND step B=2")):
        _, _, _, p_err, p_conv, p_nms, p_cap, _ = fp32[p.key]
        p_launches = p_cap["launches"]
        fp32_entries += [dict(
            conv_src, path=p.key, dtype="fp32",
            launches=p_launches["window_conv"], max_abs_err=p_err,
            ms=p_conv["kernel"], device_ms=p_conv["device"],
            plain_ms=p_conv["plain"], bound_ms=p_conv["bound_ms"],
            bound_by=p_conv["bound_by"], library_ms=None,
        ), dict(
            nms_src, path=p.key, launches=p_launches["rotated_nms_keep"],
            max_abs_err=float(nms_err), ms=p_nms["kernel"],
            device_ms=nms_dev[step_name]["device"], plain_ms=p_nms["plain"],
            bound_ms=bounds[p.key][0], bound_by=bounds[p.key][1],
            library_ms=None,
        )]
    # the steps fed points alone (48-50): the fp32 window conv on each
    # sparse step's device plan, the NMS kernel on each step's inputs
    for key, (_, _, _, _, p_conv_err, p_nms) in points.items():
        launches = caps[key]["launches"]
        if p_conv_err is not None:
            p_err, p_conv = p_conv_err
            fp32_entries.append(dict(
                conv_src, path=key, dtype="fp32",
                launches=launches["window_conv"], max_abs_err=p_err,
                ms=p_conv["kernel"], device_ms=p_conv["device"],
                plain_ms=p_conv["plain"], bound_ms=p_conv["bound_ms"],
                bound_by=p_conv["bound_by"], library_ms=None))
        fp32_entries.append(dict(
            nms_src, path=key, launches=launches["rotated_nms_keep"],
            max_abs_err=float(nms_err), ms=p_nms["kernel"],
            device_ms=nms_dev[f"{key} step B=2"]["device"],
            plain_ms=p_nms["plain"], bound_ms=bounds[key][0],
            bound_by=bounds[key][1], library_ms=None))
    # one entry per kernel over every path, with the flagship's (NMS) and
    # SECOND's (window conv) times, then one per kernel at CBGS's shapes,
    # the NMS kernel on the nuScenes PointPillars step's inputs, the fp32
    # paths' entries and those of the steps fed points alone
    return [dict(
        nms_src, launches=sum(by_path["rotated_nms_keep"].values()),
        launches_by_path=by_path["rotated_nms_keep"],
        max_abs_err=float(nms_err), ms=nms_times["kernel"],
        device_ms=nms_times["device"], plain_ms=nms_times["plain"],
        bound_ms=nms_b_ms, bound_by=nms_b_by, library_ms=None,
    ), dict(
        conv_src, launches=sum(by_path["window_conv"].values()),
        launches_by_path=by_path["window_conv"],
        max_abs_err=conv_err, ms=conv["kernel"], device_ms=conv["device"],
        plain_ms=conv["plain"], bound_ms=conv["bound_ms"],
        bound_by=conv["bound_by"], library_ms=None,
    ), dict(
        nms_src, path="cbgs",
        launches=caps["cbgs"]["launches"]["rotated_nms_keep"],
        max_abs_err=float(nms_err), ms=cbgs_nms["kernel"],
        device_ms=nms_dev["CBGS step B=2"]["device"],
        plain_ms=cbgs_nms["plain"], bound_ms=cbgs_b_ms, bound_by=cbgs_b_by,
        library_ms=None,
    ), dict(
        conv_src, path="cbgs",
        launches=caps["cbgs"]["launches"]["window_conv"],
        max_abs_err=cbgs_conv_err, ms=cbgs_conv["kernel"],
        device_ms=cbgs_conv["device"], plain_ms=cbgs_conv["plain"],
        bound_ms=cbgs_conv["bound_ms"], bound_by=cbgs_conv["bound_by"],
        library_ms=None,
    ), dict(
        nms_src, path="nusc_pp",
        launches=caps["nusc_pp"]["launches"]["rotated_nms_keep"],
        max_abs_err=float(nms_err), ms=nusc_nms["kernel"],
        device_ms=nms_dev["nuScenes PointPillars step B=2"]["device"],
        plain_ms=nusc_nms["plain"], bound_ms=bounds["nusc_pp"][0],
        bound_by=bounds["nusc_pp"][1], library_ms=None,
    )] + fp32_entries


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--conv-timing", action="store_true",
                    help="time only the window conv (conv_timing) on the "
                    "plans of --path")
    ap.add_argument("--prec", choices=("bf16", "fp32"),
                    help="with --conv-timing: the operands' type (default: "
                    "bf16 on SECOND's plan, fp32 on Lyft's and KITTI-all's)")
    ap.add_argument("--path", nargs="+",
                    choices=("second", "cbgs", "lyft", "kitti_all"),
                    help="with --conv-timing: whose host plans and layers "
                    "(second, lyft, kitti_all; default: second); with "
                    "--bwd-timing: whose training plans and layers (second, "
                    "cbgs, lyft; default: all three)")
    ap.add_argument("--bwd-timing", action="store_true",
                    help="time only the window conv's backward kernels "
                    "(phase 58) on the training plans of --path")
    ap.add_argument("--nms-timing", action="store_true",
                    help="time only the rotated-NMS kernel (phase 13)")
    ap.add_argument("--build-timing", nargs="+",
                    choices=("second", "kitti_all", "cbgs", "lyft"),
                    help="time only the device voxels and plan (phase 47) "
                    "on these paths' bench batches")
    ap.add_argument("--only", choices=("points", "train", "data", "nusc",
                                       "dist", "variants", "experiments"),
                    help="run phase 1, the build and only phases 51-52 "
                    "(Lyft and KITTI-all from points and under TTA), "
                    "only the training phases 53-62, only the data, "
                    "trainer and evaluation phases 63-66, only the "
                    "nuScenes, Lyft and CLI phases 67-70, only the "
                    "ranks' phases 71-72, only the variants' phases "
                    "73-76 or only the last modules' phases 77-80")
    ap.add_argument("--tree", help="with --conv-timing, --bwd-timing, "
                    "--nms-timing or --build-timing: the checkout whose "
                    "det3d_tpu_torch to time (default: this one)")
    args = ap.parse_args()
    if args.conv_timing:
        if args.path and "cbgs" in args.path:
            ap.error("--conv-timing takes --path second, lyft or kitti_all")
        return conv_timing_main(args.tree, args.prec, args.path or ["second"])
    if args.bwd_timing:
        if args.path and "kitti_all" in args.path:
            ap.error("--bwd-timing takes --path second, cbgs or lyft")
        return bwd_timing_main(args.tree,
                               args.path or ["second", "cbgs", "lyft"])
    if args.nms_timing:
        return nms_timing_main(args.tree)
    if args.build_timing:
        return build_timing_main(args.tree, args.build_timing)
    smi = phase_device()
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    phase_build()
    if args.only == "points":
        for path, phase in ((LYFT, 51), (KITTI_ALL, 52)):
            phase_fp32_points(dev, path, phase, smi)
        return 0
    if args.only == "train":
        training_phases(dev, smi)
        log(f"training phases took {time.perf_counter() - t0:.1f} s")
        return 0
    if args.only == "data":
        data_phases(dev, smi)
        log(f"data phases took {time.perf_counter() - t0:.1f} s with the "
            f"build")
        return 0
    if args.only == "nusc":
        nusc_phases(dev, smi)
        log(f"nuScenes, Lyft and CLI phases took "
            f"{time.perf_counter() - t0:.1f} s with the build")
        return 0
    if args.only == "variants":
        kernels = variants_phases(dev, smi)
        log(f"the variants' phases took {time.perf_counter() - t0:.1f} s "
            f"with the build")
        print(json.dumps({"kernels": kernels}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.only == "experiments":
        kernels = experiments_phases(dev, smi)
        log(f"the last modules' phases took {time.perf_counter() - t0:.1f} "
            f"s with the build")
        print(json.dumps({"kernels": kernels}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.only == "dist":
        dist_phases(dev, smi)
        log(f"the ranks' phases took {time.perf_counter() - t0:.1f} s with "
            f"the build")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    kernels = serving_phases(dev, smi)
    # every serving stack and graph is freed before the last phases: Lyft's
    # TTA step alone holds tens of GB
    gc.collect()
    torch.cuda.empty_cache()
    for path, phase in ((LYFT, 51), (KITTI_ALL, 52)):
        phase_fp32_points(dev, path, phase, smi)
        gc.collect()
        torch.cuda.empty_cache()
    kernels += training_phases(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    data_phases(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    kernels += nusc_phases(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    kernels += dist_entries(kernels, dist_phases(dev, smi))
    gc.collect()
    torch.cuda.empty_cache()
    kernels += variants_phases(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    kernels += experiments_phases(dev, smi)
    log(f"chip_smoke took {time.perf_counter() - t0:.1f} s after the "
        f"device check, the kernels' build included")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
