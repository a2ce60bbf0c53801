#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one
NVIDIA GPU.

    python3 chip_smoke.py             # from the repo root, on a Hopper card
    python3 chip_smoke.py --profile   # only torch.profiler loops over the
                                      # darts EF call and over one train
                                      # step at batch 64 (PERF.md)
    python3 chip_smoke.py --stage3    # only the pool gradients and phase 9
    python3 chip_smoke.py --derived   # only phase 10
    python3 chip_smoke.py --darts     # only the decode at the unified
                                      # vocabulary and phase 11
    python3 chip_smoke.py --int8      # only phase 12
    python3 chip_smoke.py --parallel  # only phase 13
    python3 chip_smoke.py --data      # only phase 14
    python3 chip_smoke.py --programs  # only phase 15
    python3 chip_smoke.py --remat     # only phase 16
    python3 chip_smoke.py --grad-spread
                                      # only how far the derived EF's fp32
                                      # gradients move under one rounding
                                      # of the input (B = 8 and 64)
    python3 chip_smoke.py --kernel-times [--root DIR]
                                      # only the cell, the node forward and
                                      # backward, the decode, the BatchNorm
                                      # forward and backward and the W / EF
                                      # calls, timed; --root takes
                                      # lctvqa_torch from another checkout
                                      # (a git archive of the parent), for
                                      # before/after runs in one call

Needs CUDA PyTorch, nvcc for sm_90a and numpy; imports neither JAX nor
the JAX package. Phases, any failure of which makes the script exit
non-zero:

1. Build the CUDA kernels from lctvqa_torch/csrc with nvcc.
2. Each kernel against its plain PyTorch version at full width, with the
   median times of both and of the one PyTorch call that computes the
   same function where there is one. The check calls the public wrapper
   (for a serving kernel its operator); the kernel's time is taken on
   the function that the operator's CUDA implementation calls, without
   the dispatch, which phase 15 times. TF32 is off for matmuls and
   convolutions in this phase. Tolerances, as |kernel - plain| <= tol +
   tol * |plain| unless said otherwise:
   - LSTM cell, sequences, decode (E 300, H 512, T 30, V 8192; B = 1, 8,
     64; the decode also at V = 8197, the unified vocabulary padded to
     full width, whose head the kernel pads to 8200 with columns that
     never win, its plan again generate_plan's): fp32 h/c 1e-5 (summation order); bf16 h/c 1e-3 (the same plus h
     rounded to bf16 every step, where a 1-ulp fp32 difference can round
     the other way: about 1e-4 at most); tokens equal, except that a
     differing bf16 token must be a near tie: its plain logit within 1e-3
     of the plain maximum. In bf16 the three LSTM kernels also run a
     probe on which rounding h before the recurrent product moves every
     gate by 1.5: the kernel must match the plain version there, and the
     plain version with h left unrounded must not. The two sequence
     kernels and nn.LSTM are also timed with the L2 flushed before each
     call (a 128 MB buffer rewritten outside the events), as a caller
     finds it that ran a convolutional encoder in between; the sequence
     and cell kernels' launch shapes on this card (blocks, batch tile,
     shared memory) must be what ops/cuda_lstm.py::seq_plan and cell_plan
     say, and the decode's (gate and head blocks, columns a head block,
     batch tiles, shared memory) what ops/cuda_generate.py::generate_plan
     says; the time of as many empty grid barriers as one call crosses
     is printed beside the sequence kernel's and the decode's plans, and
     the decode's device time and host enqueue at B = 64. The cell's and nn.LSTMCell's
     device time per call at B = 64 (torch.profiler) and their host
     enqueue times are printed too.
   - bn_fwd at the supernet's six shapes and the derived net's
     [64,32,32,32], fp32 and bf16 in and out: fp32
     out 1e-5 (summation order); bf16 out |kernel - plain| <= 1e-5 +
     2^-7 |plain|: a 1-ulp fp32 difference can round the normalized value
     to the neighbouring bf16, one bf16 ulp away, which is at most 2^-7
     of the value. At every shape and dtype pair of bn_fwd and bn_bwd the
     launch shape the card takes (lctvqa_bn_plan) must be
     ops/cuda_bn.py::bn_plan's, and two calls in a row must give the same
     bits.
   - mixed_node_fwd at the four cell shapes with E = 1, 3, 5 where the
     cell has them, N = 1, 8, 64: fp32 1e-5 (summation order). In bf16
     every stage output o is rounded to bf16, and a 1-ulp fp32
     difference flips a rounding now and then: one flip moves o by one
     bf16 ulp, at most 2^-7 |o|, and the output by w * 2^-7 * |o| / sigma
     after the folded BatchNorm, where |o| / sigma rarely passes 4; a
     flip in a sep conv's first stage spreads through its second at about
     the same size. The limit is 4 * 2^-7 * max|w| absolute. At
     NODE_PROFILE's two shapes the device time of each launch of one call
     (torch.profiler) and the host's enqueue time are printed.
   - bn_bwd at the same seven shapes, x and g each fp32 or bf16, against
     batchnorm_bwd_plain, relative to the gradient's scale s = max|plain|:
     1e-5 s where dx is fp32 (summation order), one bf16 ulp, 2^-7 s,
     where it is bf16.
   - mixed_node_bwd at the same cell shapes, E and N, against autograd
     through mixed_node_plain (which treats a stage output's rounding as
     the identity, as the kernel does) with the sep convs' inner ReLU
     decisions taken from the kernel's stored stage outputs (an inner
     BatchNorm output within an ulp of 0 falls on either side in the two
     forwards; the plain forward's own decisions are logged beside it,
     with the element and the decisions that differ where it is off),
     twice: on chip_smoke's draw (N = 1, 8, 64) and, untimed, on a second
     one (N = 1, 64) that has such an element; each gradient relative to
     its own scale s: fp32 1e-4 s (the sums of two BatchNorm backward passes in
     another order, and weight gradients that are residues of sums over
     up to 262144 pixels); bf16 2^-7 s for dx, which is rounded to bf16
     once, and 2e-3 s for the fp32 gradients of taps, pointwise matrices
     and weights: the plain version recomputes the forward, and a stage
     output that the two round to different bf16 neighbours moves a few
     terms of those sums. At NODE_PROFILE's first shape the device time
     of each launch of one call and the host's enqueue time are printed.
   - the three LSTM Functions (kernel forward, autograd through the plain
     version backward) at B = 64: gradients of x, h0, c0 and the weights
     against autograd through the plain version alone, 1e-5 s in fp32
     and 1e-3 s in bf16.
   - the port's avg and max pool gradients on a channel slice, card
     against CPU, 1e-6 (PyTorch's own channels-last avg_pool2d backward,
     which is wrong on the card in PyTorch 2.11, is logged beside them),
     and the avg pool's second order as stage 3 takes it (a
     Hessian-vector product through a cubed output), 1e-6 (1 + max).
3. Full-width W, fixed-EF and darts-EF params (and the supernet's arch
   parameters) from seeded torch.Generators, converted to the JAX
   layout, written as three artifacts with lctvqa_torch.export's
   save_artifact.
4. The artifacts served over HTTP (lctvqa_torch.serve.make_server,
   warmup first) with concurrent /answer, /generate and /healthz, twice
   in fp32: at the default kernel flags, then with the sequence, decode,
   mixed-op node and BatchNorm kernels on. Launch counts are zeroed
   before these runs; each kernel must have launched in the run where
   its flag is on, the node and BatchNorm kernels in the other run not at
   all, and the greedy questions of the two runs must agree for the
   fixed EF.
5. The darts EF at fixed dispatch groups (1, 4 and 64 rows) through
   ServingModel with both flag sets: one forward launches the node kernel
   14 times; the L2-normalized image features of the two within 1e-5
   and the answer logits, which random heads make insensitive to the
   image, within 1e-4 (the same math in another order of sums, through
   four cells of batch-stat BatchNorm);
   greedy tokens equal, or a near tie (the default run's logits of the
   two tokens within 2e-4 at the first differing step).
6. Served outputs on the card against the CPU (plain versions, fp32) on
   a two-image input, at PyTorch's default TF32 settings (the port keeps
   fp32 exact itself): finite, of the expected shapes; logits within
   1e-5 for W and the fixed EF (summation order; TF32 would be off by
   more) and 1e-4 for the darts EF (BatchNorm over a batch of two
   amplifies it), whose image features must agree within 1e-5; tokens
   equal or a near tie as in 5.
7. A batch-64 answer_logits / generate loop: pairs/s (informational).
8. Training at full width (ModelConfig's defaults: the PC-DARTS supernet
   EF and the VGG19 W, batch 64) through lctvqa_torch's Experiment on
   synthetic data made in RAM from a seed: stage 1 + stage 2 steps and
   one eval, at the default kernel flags and with all kernel flags on,
   in fp32 and in bf16. Launch counts are zeroed before each run. Checks:
   finite losses that agree between the two flag sets at the first step
   (fp32 1e-4: the same math in another order of sums); one stage-1 step
   with the flags on launches exactly 14 mixed_node_fwd, 14
   mixed_node_bwd, 40 bn_fwd and 40 bn_bwd (printed by shape and dtypes,
   which must add up to the launch counts), and none of them with the
   flags off, and the cell kernel launches in both; with dropout_rate = 0
   the stage-1 loss and its gradient w.r.t. every EF leaf agree between
   the two flag sets on the card and with the CPU (plain versions):
   loss 1e-4, each leaf within 2e-3 of its own scale plus 1e-5 of the
   largest leaf's. Four cells of batch-statistics BatchNorm amplify the
   summation-order difference, hence the first term. The second is for
   the convolutions that feed a BatchNorm directly: the loss does not
   depend on their weights' scale, so their gradient is a residue of
   terms that cancel, a thousandth of the largest leaf's in size, and
   carries the absolute noise of a full-size sum (4e-6 seen on a
   [64, 128, 1, 1] leaf of scale 4e-4, the largest leaf 0.8). A
   checkpoint is written, read back by a
   resumed Experiment and found equal bit for bit. Then ms per stage-1
   and stage-2 step and pairs/s (informational).
9. Stage 3 at full width (ModelConfig's defaults, batch 64, the same
   synthetic data) through Experiment with stage 3 on before every batch
   (exact-indirect, remat on): two train_steps in bf16 (stage 3, stage 1,
   stage 2 each) at each flag set, launch counts zeroed before each run.
   Checks: the W'-val loss and every other loss finite; every arch leaf
   moved and finite after the steps; no kernel counter moves inside any
   stage-3 call (it runs the plain versions); with the flags on, a
   stage-1 step launches what phase 8 counts (STAGE1_LAUNCHES) and the
   training kernels launch in the run; a checkpoint written after stage
   3 and read back by a resumed Experiment equal bit for bit, arch and
   its Adam state included. One arch gradient per mode (exact-indirect
   with remat and without, exact, fd) in bf16 at batch 64: finite,
   nonzero, no launch; ms per call and peak device memory printed
   (informational). The card against the CPU: the exact-indirect
   gradient in fp32, dropout off (W's VGG dropout, hard-coded at 0.5,
   replaced by the identity on both sides), full widths at batch
   STAGE3_CPU_BATCH = 8, cut from 64 only to keep the CPU's side short:
   the W'-val loss within STAGE3_LOSS_TOL (1 + |loss|) and each arch
   leaf within STAGE3_GRAD_TOL of its scale (see there).

10. The derived network of PC_DARTS_cifar (ModelConfig's widths, its
   cells the genotype's) through Experiment in bf16 at batch 64 on the
   same synthetic data, with npy records (data.synthetic.make_npy_records)
   for validation's BLEU4, at each flag set, the counts zeroed before each
   run: one train step under the BatchNorm tally (launches by shape and
   dtypes, which must add up to the launch counts; the kernels at the new
   [64,32,32,32], cell 1's stride-2 max pool, with the flags on and at no
   shape without), four more timed by stage, validation. Checks: finite
   losses; no stage-3 call and no mixed-op launch; with the flags on the
   BatchNorm, sequence, decode and cell kernels launch, with them off only
   the cell; validation logs a BLEU4 in [0, 100]; the kernel-flag run's
   checkpoint read back equal. Stage 1's loss and gradients with dropout
   off in fp32 at batch DERIVED_CPU_BATCH = 64: the two flag sets and the
   CPU against each other at phase 8's tolerances (at 8 rows, moving the
   input by one rounding moves the gradient on one device as far as the
   card lies from the CPU, past that limit: --grad-spread).
   lctvqa_torch.eval's main on the kernel-flag run's experiment (the
   card's loader in place
   of the h5 files, which need h5py): 256 items, accuracy and BLEU4 in
   range. A derived-EF artifact served over HTTP with its genotype at
   both flag sets (the BatchNorm, sequence and decode kernels launch with
   the flags on and not off, the mixed-op kernels never), through
   ServingModel at batch 64 held as phase 5 holds the darts EF (features
   1e-5, logits 1e-4, tokens equal or a near tie within 2e-4), against the
   CPU as in phase 6, and answer_logits / generate ms a call at B=64 bf16
   (informational). The phase's wall time is printed.

11. The darts and unified families (train/experiment_darts.py) at full
   width on npy records (data.synthetic.make_npy_records at phase 8's
   sizes, with data/vocab.py's question and answer vocabularies, the
   three vocabularies padded with filler words to 8192, 1000 and
   UNIFIED_VOCAB = 8197 words), their images make_arrays' through the npy
   loader's in-RAM table (every record's image checked to be there). Each
   family's experiment in bf16 at both flag sets, the counts zeroed
   before each run: one epoch over half the training records (4 steps,
   an arch step at batches 0 and 2: the default mode, exact-indirect,
   which this family runs as the finite difference), validation, the
   checkpoints. Checks: finite losses; every arch leaf moved and finite;
   no launch inside an arch step; with the flags on a train step launches
   exactly STAGE1_LAUNCHES and one lstm_seq_all, and a validation batch
   one greedy_generate, with them off no node or BatchNorm launch and no
   decode; accuracy in [0, 1], BLEU4 in [0, 100]; the three checkpoints
   read back by a resumed experiment equal bit for bit, Adam states
   included; a qst_only step from a fresh Adam state leaves the answer
   head's bits. The first train loss of each family in fp32 at the two
   flag sets within TRAIN_LOSS_TOL. One arch gradient per mode (fd,
   exact) in bf16 at B=64: finite, nonzero, no launch, ms and peak
   memory printed; the exact one in fp32, dropout off, at
   STAGE3_CPU_BATCH rows on the card against the CPU at phase 9's
   tolerances. The LCT loop on the npy loader (use_old_dataloader): two
   steps and validation, finite losses, BLEU4 in range. The unified
   artifact of the kernel-flag run (export.export_state) served over HTTP
   at both flag sets: /generate answers {"qa", "answer"}, /answer is a
   4xx, the decode and node kernels launch with the flags on and not off;
   ServingModel.generate at B=64 on the card against the CPU, tokens
   equal or a near tie (phase 5's rule), and its ms a call in bf16; the
   darts family's EF checkpoint served once as an "ef" artifact. Train
   and arch step times, trained pairs/s and the phase's wall time are
   printed.

12. int8 serving (lctvqa_torch/quant.py, ops/int8.py) and the export
   CLI at full width, bf16 with the kernel flags unless said otherwise.
   Phase 3's W params written as a checkpoint and exported with `python
   -m lctvqa_torch.export --int8 --check` on the card (the reloaded
   artifact against the model on the checkpoint's trees: floats within
   2e-4, tokens exact), served over HTTP (/answer; the sequence kernel and
   the int8 products launch); every int8 product of a distinct shape the
   W forward makes at B = 64, 1 and 5 (the padded GEMMs) and the derived
   EF's at B = 64 held bit for bit to its plain version on the same
   operands (exact on both); W's B = 64 answers against its fp32 and bf16
   forwards (agreement printed) and its int8 logits at fp32 compute
   dtype against the CPU's on INT8_CPU_ROWS rows (INT8_CPU_TOL of their
   scale: see there). Phase 10's kernel-flag derived EF exported --int8
   --check, served on /generate (greedy_generate and lstm_seq_all
   launch), and `lctvqa_torch.eval --int8` on it (accuracy and BLEU4 in
   range). Phase 8's bf16 kernel-flag experiment resumed for an epoch on
   a small split, twice: the six statistics files written, then each
   extended by one value. Printed beside the card's name and power limit:
   ms per W answer_logits call at B = 64 in int8, bf16 and fp32, weight
   bytes on the device, the largest patch matrix, the phase's wall time.
   With --int8 alone the checkpoints of phases 8 and 10 are made here,
   untrained.

13. Data parallelism on one card (lctvqa_torch/parallel/), fp32 at full
   width (ModelConfig's defaults, dropout off, the sequence, decode, cell
   and BatchNorm kernels on; stage 2's sampled questions taken greedily,
   so that the ranks' own streams do not enter the comparison). The four
   two-launch BatchNorm kernels (bn_fwd_sums, bn_fwd_apply, bn_bwd_sums,
   bn_bwd_apply) at a rank's half of each of the supernet's six shapes
   against their plain versions (see check_sync_bn_kernels for the
   limits), their grid the card's, two calls the same bits, timed at
   [32,64,64,32] beside their bound and PyTorch's SyncBatchNorm building
   blocks. The mixed-op node kernels' data-parallel mode (rows 5s and
   6s: six launches, A, B, Z and R, S, X) at a rank's half of cell 0
   (N=32 of 64, 64x64, Cs 4, E=5) in this process: a SyncForward and a
   SyncBackward on each half, their sums added between the launches as
   two ranks' all-reduce adds them, the halves' outputs against the
   one-process kernel on the whole batch at phase 2's forward limit;
   each launch and each direction event-timed and profiled beside the
   plain version and the bound. Then three spawned processes: two ranks on cuda:0 over gloo
   (NCCL refuses two ranks on one device), each on its 32 rows, and one
   rank of an NCCL group on the whole batch (the data-parallel path at
   one rank, its sums over NCCL); meanwhile this process runs the main
   path with no process group on the card, as the reference, from an
   Experiment: a stage-3 call (exact-indirect, remat on) on the first
   STAGE3_CPU_BATCH rows of the global batches, then train_step (stages 1
   and 2) on the global batch of 64 and one validation step, the launch
   counts set to 0 just before it and read just after it. The gloo ranks
   run the sync BatchNorm at the six shapes (held to its plain versions
   summed over the two halves and to the one-launch kernel on the whole
   batch, at phase 2's BatchNorm limits) and the node's data-parallel
   forward and backward on their rows of cell 0, both dtypes, each
   against the plain version under the same process group (moments
   all-reduced; the backward's taking the kernel's inner ReLU decisions)
   at phase 2's node limits and its second call's bits, then the two
   ranks together against the one-process kernel on the global batch
   (outputs and dx concatenated, weight-gradient shares summed; where an
   inner ReLU input within an ulp of 0 falls on the other side, against
   the plain backward on the global batch with the ranks' decisions),
   and a whole call with its gloo all-reduces timed; every rank runs the
   same main path, its counts likewise, and the gloo ranks then stage 1
   with pallas_mixed_op from the same start, as this process does on the
   whole batch: loss, counters, gradient and EF held as below, the six
   data-parallel node launches counted on each rank (and the one-process
   node kernels not), the two ranks' EF the same bits. Each rank against the reference: the
   losses within 1e-5 of one process's, the counters equal, the
   gradient each step's optimizer took (stage 3's arch, stage 1's EF,
   stage 2's W heads, copied as the optimizer receives it) within phase
   8's limit, the EF, W heads and arch within
   tests/test_mesh.py's tolerances (rtol 2e-4, atol 1e-5; the arch atol
   1e-6) except that an EF element may pass that limit where one
   process's gradient there is within phase 8's noise limit, by at most
   2 lr (Adam's first step keeps only the gradient's sign); the LSTM,
   decode and two-launch BatchNorm kernels launched and neither the node
   kernels nor the one-launch BatchNorm. The two gloo ranks' bits are
   equal. The train_step times are printed as informational: the ranks
   share one card.

14. The data path, from the raw files to a batch on the card. (a) The
   offline builders: data.synthetic.write_raw_vqa_json's jsons at phase
   8's sizes, `python -m lctvqa_torch.data.build vocab` and `npy` as
   subprocesses, their three vocabularies and train.npy / valid.npy equal
   to make_npy_records' (and data/vocab.py's) for the same seed and
   sizes; `download --list_only` lists the eight URLs (no network).
   images_h5, qa_h5 and resize run where h5py and PIL import; otherwise
   one line says they did not and why, and qa_h5 is seen to raise
   ImportError naming h5py. (b) The C++ core (lctvqa_torch/native) built
   from the port's source on the card's host: gather_rows bit for bit
   against numpy fancy indexing at [64, 64, 64, 3] uint8 (one thread,
   under the 1 MiB threshold) and [64, 224, 224, 3] (8 threads);
   sample_answers' labels and multi-choice rows equal to the plain
   splitmix64's for 3 seeds on enc_ans [64, 1000] with items that have
   no valid answer; ms a batch of the C++ gather at 1 and 8 threads and
   of numpy's, beside the card and the host CPU's model
   (informational). (c) The LCT main path at phase 8's full width (darts
   supernet, stage 3 off, B = 64, bf16, the kernel flags) through
   Experiment, its batches from epoch_batches on the native route with
   cfg.data.num_workers = 8 threads through the Prefetcher, the counts
   set to 0 just before: DATA_STEPS stage-1 + stage-2 steps. Checks:
   every consumed batch equal, key by key and dtype by dtype, to the one
   the plain route (numpy rows, plain splitmix64) assembles from the same
   seed; finite losses; each stage-1 step launches STAGE1_LAUNCHES and an
   LSTM kernel, each stage-2 step an LSTM kernel. The Prefetcher's wait a
   step and the phase's wall time are printed.

15. The serving functions as torch.export programs
   (lctvqa_torch/export.py::export_programs, lctvqa_torch/programs.py)
   on the card. First each of
   the six serving kernels' operators (`lctvqa_torch::lstm_cell`,
   `lstm_seq_final`, `lstm_seq`, `greedy_generate`, `mixed_node`,
   `batchnorm`) at a B = 64 bf16 serving shape: its result the same bits
   as the direct call of the function its CUDA implementation calls, and
   the host enqueue of each (informational). Then every function of the
   W, VGG19-EF and darts-EF artifacts (phase 3's), the derived EF's and a
   unified artifact on the supernet at UNIFIED_VOCAB words (written
   here), at both flag sets in bf16, on PROGRAM_WORKERS spawned
   processes: traced with a symbolic batch (the seconds printed), the program run at batches 1, 2, 5 and 64 against the eager
   ServingModel call (ids and tokens exactly, floats within 2e-4; the
   largest difference printed, 0 expected: the same kernels run); the
   launch counts of one B = 64 call of each equal, non-zero for each
   serving kernel of the flag set (program_kernels) and equal to the
   graph's number of each operator. Besides, fp32 W at both flag sets
   and the int8 W and derived EF (export_state(int8=True) of those
   artifacts' params) with the kernel flags: an int8 program's
   `aten._int_mm` nodes as many as its eager call's int8 products. Each
   program is then written into a copy of its artifact
   (export.program_entry, save_artifact: its bytes printed), loaded back
   with programs.load_programs (the seconds printed) and held against
   the eager call at batches 1, 2, 5 and 64 exactly, its launches at B
   = 64 the eager call's, with cuDNN's TF32 on globally (PyTorch's
   default; the loader turns it off for fp32, and how far the fp32
   program is off without that is printed); then one B = 64 call of
   the eager model, the traced program and the loaded one timed in
   turns, while other workers may trace or time (informational). Once
   the derived EF's kernel-flag programs are in, a fresh process runs
   `lctvqa_torch.serve --programs` on them (merged into one artifact)
   without --genotype: its /answer and /generate replies, one request
   at a time, equal the model code's server's with the genotype,
   /healthz says programs, and it imported neither lctvqa_torch.models
   nor lctvqa_torch.export. The phase's wall time is printed. The
   default-flag programs of the two supernet artifacts (darts EF,
   unified) are traced at PROGRAM_CUT_LAYERS cells: their full-width
   traces took 50-77 s each.

16. The supernet's execution modes and the reference's 224 px LCT
   configuration (`--remat` runs it alone). (a) The node kernels,
   forward and backward, at cell 0 of the 224 px trunk (224x224, Cs 4,
   N 64, E 3 and 5, both dtypes) and the BatchNorm kernels at its
   largest input ([64,224,224,32], every dtype pair) against their plain
   versions at phase 2's limits, TF32 off; times and bounds. (b) At full
   width, 64 px, B = 64, on one set of weights and one batch:
   fuse_mixed_ops, pack_conv_branches and the edge-batched cell with the
   kernel flags against the default folded path: the trunk's features
   in fp32 within 1e-4 of their scale and in bf16 within 5e-2, stage 1's
   loss (1e-2) and gradients in bf16 (5e-2 of each leaf's scale); each
   mode's stage-1 step timed, our kernels' launches and the device
   kernels a step (torch.profiler; informational). (c) At 224 px and
   B = REMAT_BATCH, one stage-1 step with and without remat_cells
   (kernel flags, bf16): the peak device memory of each, the loss within
   1e-5, each gradient leaf within 2e-3 of its scale; the forward
   kernels launch twice a step with remat. (d) The 224 px LCT loop at
   full width through Experiment with the kernel flags and remat_cells,
   bf16, B = BATCH_224, the counts set to 0 just before: STEPS_224 + 1
   stage-1 + stage-2 steps, then validation on one batch (greedy decode,
   BLEU4): finite losses, BLEU4 in range, each stage-1 step's node and
   BatchNorm launches (the forward ones twice); ms a step, launches a
   step and the peak device memory printed. The phase's wall time is
   printed.

It prints the card's name and power limit, one JSON line of the kernels
(times, bounds and launch counts; `derived_launches`, `darts_launches`
and `unified_launches` are phases 10 and 11's kernel-flag training runs';
the decode's row carries its V = 8197 case under `unified_vocab`; the
two-launch BatchNorm kernels' rows count phase 13's rank 0, and so do
the data-parallel node rows, mixed_node_fwd_sync and mixed_node_bwd_sync,
their `launches` a call's count on phase 13's node stage 1 with each
launch's under `launch_counts`; `program_launches` is a B = 64 call of
each of phase 15's programs, summed; the node and BatchNorm rows carry
phase 16's 224 px shapes under `at_224` and every row its launches in
phase 16's 224 px run under `lct224_launches`), and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import base64
import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SEED = 0
BATCHES = (1, 8, 64)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 1e-3}
TIE_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
LOGIT_TOL = 1e-5
DARTS_LOGIT_TOL = 1e-4
DARTS_FEATURE_TOL = 1e-5
DARTS_TIE_TOL = 2e-4
KERNEL_FLAGS = {"default": {},
                "kernels": {"pallas_seq_lstm": True, "pallas_generate": True,
                            "pallas_mixed_op": True}}
# the BatchNorm kernel's switch is process-wide (ops/conv.py), as in the JAX
# package; the "kernels" flag set turns it on for its runs
BN_KERNEL = {"default": False, "kernels": True}
NODE_CALLS_PER_FORWARD = 14
# the batches of check_node_bwd_kernel's second draw: other random inputs,
# on which an inner ReLU input of cell0's edge 2 lies within an ulp of 0
NODE_BWD_FAULT_DRAW = (1, 64)
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, dense bf16 tensor FLOP/s, fp32
# FLOP/s outside the tensor cores
H100 = {"bytes": 3.35e12, "bfloat16": 989e12, "float32": 67e12}
# (H, W, C of the cell's states, numbers of stride-1 edges a node has there)
NODE_SHAPES = {"cell0": (64, 64, 16, (3, 5)), "cell1": (32, 32, 32, (1, 3)),
               "cell2": (16, 16, 64, (1, 3)), "cell3": (16, 16, 64, (3, 5))}
# cell preprocess outputs, then the sep convs' inner BN on stride-2 edges,
# then the derived net's stride-2 max pool of cell 1 (its other pool BNs
# are at [64,64,64,16] and [64,16,16,64])
BN_SHAPES = ((64, 64, 64, 16), (64, 64, 64, 32), (64, 32, 32, 64),
             (64, 16, 16, 64), (64, 32, 32, 8), (64, 16, 16, 16),
             (64, 32, 32, 32))
# name -> (source, TPU kernel it replaces, flag set that runs it, path whose
# run gives its launch count: HTTP serving or training)
KERNELS = {
    "lstm_cell": ("lctvqa_torch/csrc/lstm.cu",
                  "lctvqa/ops/pallas_lstm.py:42", "default", "serve"),
    "lstm_seq_final": ("lctvqa_torch/csrc/lstm.cu",
                       "lctvqa/ops/pallas_lstm.py:172", "kernels", "serve"),
    "lstm_seq_all": ("lctvqa_torch/csrc/lstm.cu",
                     "lctvqa/ops/pallas_lstm.py:311", "kernels", "serve"),
    "greedy_generate": ("lctvqa_torch/csrc/generate.cu",
                        "lctvqa/ops/pallas_generate.py:142", "kernels",
                        "serve"),
    "mixed_node_fwd": ("lctvqa_torch/csrc/mixedop.cu",
                       "lctvqa/ops/pallas_mixedop.py:425", "kernels",
                       "serve"),
    "mixed_node_bwd": ("lctvqa_torch/csrc/mixedop.cu",
                       "lctvqa/ops/pallas_mixedop.py:721", "kernels",
                       "train"),
    "bn_fwd": ("lctvqa_torch/csrc/bn.cu", "lctvqa/ops/pallas_bn.py:81",
               "kernels", "serve"),
    "bn_bwd": ("lctvqa_torch/csrc/bn.cu", "lctvqa/ops/pallas_bn.py:95",
               "kernels", "train"),
}
# launches of one stage-1 step at full width with the kernel flags on
STAGE1_LAUNCHES = {"mixed_node_fwd": 14, "mixed_node_bwd": 14, "bn_fwd": 40,
                   "bn_bwd": 40}
L2_FLUSH_BYTES = 128 * 2 ** 20  # more than the card's 50 MB L2
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 2e-3
TRAIN_GRAD_FLOOR = 1e-5
# phase 9: the card against the CPU, exact-indirect fp32 at this batch. The
# arch gradient is a second derivative through four cells of
# batch-statistics BatchNorm over 8 rows, which amplify the summation-order
# difference of the two devices as in phase 8's first-order check (2e-3 of
# a leaf's scale there), here once in each of the two backward passes:
# 5e-3 of each leaf's scale (6.4e-4 seen). The W'-val loss is a forward
# only: 1e-4, as phase 8's
STAGE3_CPU_BATCH = 8
STAGE3_LOSS_TOL = 1e-4
STAGE3_GRAD_TOL = 5e-3
LSTM_KERNELS = ("lstm_cell", "lstm_seq_final", "lstm_seq_all",
                "greedy_generate")
# phase 10: the derived network retrained, served and evaluated
DERIVED_GENOTYPE = "PC_DARTS_cifar"
# artifact -> the genotype its ServingModel is given (the artifact does
# not carry it)
ARTIFACT_GENOTYPE = {"derived": DERIVED_GENOTYPE}
# EF encoders whose BatchNorm is batch-statistics (DARTS_* tolerances)
BATCH_STAT_EFS = ("darts", "derived")
# the card against the CPU, stage 1's loss and gradients at this batch:
# phase 8's. At 8 rows the fp32 gradient is too ill-conditioned for phase
# 8's tolerance: moving the input by one rounding (--grad-spread) moves
# it, on one device, as far as the card lies from the CPU (3.1 of the
# limit); at 64 rows both stay near half of it
DERIVED_CPU_BATCH = 64
# synthetic data of phases 8-11 (train_arrays, and the npy records of
# phases 10 and 11)
TRAIN_DATA = {"num_images": 256, "num_questions": 512}
# phase 11: the unified vocabulary padded to this size (V % 8 = 5, so the
# decode kernel's head is padded), and an arch step every this many batches
UNIFIED_VOCAB = 8197
DARTS_ARCH_FREQ = 2
# phase 12: the card's int8 W logits at fp32 compute dtype against the
# CPU's on this many rows. The int8 products are exact on both and the
# quantization the same bits (check_quantize_on_card), but the fp32 ops
# between them are not summed in one order (the question LSTM, the image
# feature's L2 norm): a code of fc1's input at a rounding tie rounds the
# other way and moves the logits by one code's share of fc1, which moves
# fc2's codes in turn: an estimated 5e-3 of the logits' scale at the full
# widths (2e-3 seen while the card's scales were an ulp off the CPU's),
# so the limit is 1e-2 of it; without a tie the two agree to about 1e-7
# of it
INT8_CPU_ROWS = 8
INT8_CPU_TOL = 1e-2
FAILURES: list = []


def log(*args):
    print(*args, flush=True)


def expect(cond: bool, what: str) -> None:
    if not cond:
        FAILURES.append(what)
        log(f"FAIL: {what}")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times, after warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_cold_ms(fn, flush, reps: int = 10) -> float:
    """Median of per-call CUDA-event times with the 50 MB L2 flushed before
    each call (`flush`, a buffer larger than L2, is rewritten outside the
    events): what a caller finds that ran other work in between."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def tf32_off():
    """TF32 off for matmuls and convolutions, restored after."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def time_library(fn):
    """time_ms of a PyTorch call that serves only as a yardstick; None,
    with the reason logged, where this PyTorch build does not take it."""
    try:
        return time_ms(fn)
    except (RuntimeError, NotImplementedError) as e:
        log(f"library call not timed: {type(e).__name__}: {e}")
        return None


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def _within(got, want, tol: float) -> bool:
    return all(bool(((g - w).abs() <= tol + tol * w.abs()).all())
               for g, w in zip(got, want))


def _plain_logits_at(qst, img_row, prefix, dtype):
    """Plain-version logits of one row's decode step len(prefix), fed the
    tokens `prefix` (the plain decode, teacher-forced)."""
    from lctvqa_torch.models.qst_encoder import START_TOKEN
    from lctvqa_torch.ops import nn as N
    from lctvqa_torch.ops.cuda_lstm import cell_weights, lstm_cell_plain

    w = cell_weights(qst["lstm"]["layers"][0], dtype)
    h = c = img_row[None].float()
    tok = torch.tensor([START_TOKEN], device=img_row.device)
    x = torch.tanh(N.embed(qst["word2vec"], tok))
    for t in range(len(prefix) + 1):
        h, c = lstm_cell_plain(w, x, h, c)
        if t < len(prefix):
            x = N.embed(qst["word2vec"], prefix[t:t + 1])
    return N.linear(qst["fc2"], torch.tanh(h), dtype=dtype)[0]


def _token_gaps(qst, img, got, want, dtype):
    """For each row whose kernel tokens differ from the plain ones: the
    plain logit gap between the plain and the kernel token at the first
    differing step."""
    gaps = []
    for r in torch.nonzero((got != want).any(1)).flatten().tolist():
        t = int(torch.nonzero(got[r] != want[r])[0])
        logits = _plain_logits_at(qst, img[r], want[r, :t].long(), dtype)
        gaps.append(float(logits[want[r, t]] - logits[got[r, t]]))
    return gaps


def _lstm_fns():
    """LSTM kernel -> (wrapper, plain version), both called as
    (weights, xs [B, T, E], h0, c0)."""
    from lctvqa_torch.ops import cuda_lstm as L

    return {
        "lstm_cell": (lambda w, xs, h, c: L.lstm_cell(w, xs[:, 0], h, c),
                      lambda w, xs, h, c: L.lstm_cell_plain(w, xs[:, 0], h,
                                                            c)),
        "lstm_seq_final": (L.lstm_seq_final, L.lstm_seq_final_plain),
        "lstm_seq_all": (L.lstm_seq, L.lstm_seq_plain),
    }


def _lstm_kernel_calls():
    """LSTM kernel -> the function that its operator's CUDA implementation
    calls, as (weights, xs [B, T, E], h0, c0): phase 2 times a kernel's
    `ms` on it, the kernel's call without the operator's dispatch, as
    before the operators; phase 15 times the dispatch
    (op_enqueue_times)."""
    from lctvqa_torch.ops import cuda_lstm as L

    return {
        "lstm_cell": lambda w, xs, h, c: L._cell_kernel(w, xs[:, 0], h, c),
        "lstm_seq_final": lambda w, xs, h, c: L._seq_final_kernel(
            w, xs, *L._zeros_state(w, xs, h, c)),
        "lstm_seq_all": lambda w, xs, h, c: L._seq_all_kernel(
            w, xs, *L._zeros_state(w, xs, h, c)),
    }


def _generate_kernel_call(qst, h0, seq, dtype):
    """greedy_generate without its operator (as _lstm_kernel_calls)."""
    from lctvqa_torch.ops import cuda_generate as G

    return G._generate_kernel(G.decode_weights(qst, dtype), h0, seq)


def _node_kernel_call(xs, ops, wts, cs):
    """mixed_node without its operator (as _lstm_kernel_calls); a tree
    older than the operators has no `_node_op_cuda`, and its mixed_node
    is that call."""
    from lctvqa_torch.ops import cuda_mixedop as M

    direct = getattr(M, "_node_op_cuda", None)
    if direct is None:
        return M.mixed_node(xs, ops, wts, cs)
    nodes = [M.node_weights(p) for p in ops]
    return direct(xs, [n.dw for n in nodes], [n.pw for n in nodes], wts, cs)


def h_rounding_probe(w, b: int, steps: int):
    """bf16 inputs on which rounding h to bf16 before the recurrent product
    decides the result. x = 0; h0 is 1 - 2^-10 on even units (rounds to
    1) and -(0.5 + 2^-10) on odd units (rounds to -0.5); W_hh rows are 2s
    on even units and 4s on odd ones, s = 512 // H. Every gate's
    recurrent sum is then exactly 0 with h rounded and -3sH/1024 (-1.5 at
    H = 512) without. -> (probe weights, the same in fp32 so that h is
    not rounded, inputs (xs, h0, c0))."""
    from lctvqa_torch.ops.cuda_lstm import CellWeights

    hid, emb = w.w_hh.shape[0], w.w_ih.shape[0]
    dev = w.w_hh.device
    even = torch.arange(hid, device=dev) % 2 == 0
    h0 = torch.where(even, 1 - 2 ** -10, -(0.5 + 2 ** -10)).float()
    s = max(1, 512 // hid)
    w_hh = torch.where(even, 2.0 * s, 4.0 * s)[:, None].expand(hid, 4 * hid)
    probe = CellWeights(w.w_ih, w_hh.to(w.w_hh.dtype).contiguous(), w.b)
    unrounded = CellWeights(w.w_ih.float(), w_hh.float().contiguous(), w.b)
    h0 = h0.expand(b, hid).contiguous()
    xs = torch.zeros(b, steps, emb, device=dev)
    return probe, unrounded, (xs, h0, torch.zeros_like(h0))


def bound(n_bytes: float, flops: float, dname: str):
    """The least time in ms the card could take: the larger of the bytes
    over its memory rate and the operations over its peak rate for their
    type -> (ms, "bytes" or "operations")."""
    by_bytes, by_ops = n_bytes / H100["bytes"], flops / H100[dname]
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                         else "operations")


def lstm_bounds(mcfg, b: int, dname: str):
    """Bounds of the four LSTM-family kernels: each input read once (the
    weights once for the whole batch and all steps), each output written
    once; the products at the tensor-core rate of their operand type."""
    e, h, t, v = (mcfg.word_embed_size, mcfg.lstm_hidden_size,
                  mcfg.max_qst_len, mcfg.qst_vocab_size)
    wb = 2 if dname == "bfloat16" else 4
    weights = (e + h) * 4 * h * wb + 4 * h * 4
    state = 2 * b * h * 4
    cell_flops = 2 * b * (e + h) * 4 * h
    head = h * v * wb + v * 4
    return {
        "lstm_cell": bound(weights + b * e * wb + 2 * state, cell_flops,
                           dname),
        "lstm_seq_final": bound(weights + b * t * e * wb + state,
                                t * cell_flops, dname),
        "lstm_seq_all": bound(weights + b * t * e * wb + 2 * state
                              + b * t * h * 4, t * cell_flops, dname),
        # the decode gathers one fp32 embedding row per token
        "greedy_generate": bound(weights + head + b * h * 4 + b * t * e * 4
                                 + b * t * 4,
                                 t * (cell_flops + 2 * b * h * v), dname),
    }


def lstm_library_fns(w, xs, h0, device):
    """The one PyTorch call per LSTM kernel that computes the same function
    on the same inputs, for timing only: nn.LSTMCell for the cell, nn.LSTM
    (cuDNN) over all steps for the sequences. Nothing decodes greedily in
    one call."""
    emb, hid = w.w_ih.shape[0], w.w_hh.shape[0]
    dt = w.w_ih.dtype
    cell = torch.nn.LSTMCell(emb, hid, device=device, dtype=dt)
    seq = torch.nn.LSTM(emb, hid, batch_first=True, device=device, dtype=dt)
    with torch.no_grad():
        for mod, sfx in ((cell, ""), (seq, "_l0")):
            getattr(mod, "weight_ih" + sfx).copy_(w.w_ih.t())
            getattr(mod, "weight_hh" + sfx).copy_(w.w_hh.t())
            getattr(mod, "bias_ih" + sfx).copy_(w.b)
            getattr(mod, "bias_hh" + sfx).zero_()
    seq.flatten_parameters()
    x, h = xs.to(dt), h0.to(dt)
    state = (h[None].contiguous(), h[None].contiguous())

    @torch.no_grad()
    def run_cell():
        return cell(x[:, 0], (h, h))

    @torch.no_grad()
    def run_seq():
        return seq(x, state)

    return {"lstm_cell": run_cell, "lstm_seq_final": run_seq,
            "lstm_seq_all": run_seq}


def check_kernels(device, mcfg, batches=BATCHES, time_fn=time_ms,
                  names=LSTM_KERNELS):
    """The LSTM-family kernels in `names` ->
    {kernel: {(B, dtype): {"err", "ms", "plain_ms", "library_ms",
    "bound_ms", "bound_by"[, "probe_err", "control_err"]}}}."""
    from lctvqa_torch.models.qst_encoder import ef_qst_encoder_init
    from lctvqa_torch.ops import cuda_generate, cuda_lstm
    from lctvqa_torch.ops import nn as N

    gen = torch.Generator().manual_seed(SEED)
    qst = ef_qst_encoder_init(gen, mcfg.qst_vocab_size, mcfg.word_embed_size,
                              mcfg.img_embed_size, 1, mcfg.lstm_hidden_size)
    qst = _to(qst, device)
    seq, hid = mcfg.max_qst_len, mcfg.lstm_hidden_size
    results = {name: {} for name in names}
    direct = _lstm_kernel_calls()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    for b in batches:
        ids = torch.randint(0, mcfg.qst_vocab_size, (b, seq), generator=gen)
        xs = torch.tanh(N.embed(qst["word2vec"], ids.to(device)))
        h0 = N.l2_normalize(torch.randn(b, hid, generator=gen)).to(device)
        # the inputs the serving path gives each kernel: the W encoder
        # starts from zeros, the EF encoder and the cell from the image
        inputs = {"lstm_cell": (xs, h0, h0), "lstm_seq_final": (xs, None, None),
                  "lstm_seq_all": (xs, h0, h0)}
        for dname, dtype in DTYPES.items():
            w = cuda_lstm.cell_weights(qst["lstm"]["layers"][0], dtype)
            bounds = lstm_bounds(mcfg, b, dname)
            library = lstm_library_fns(w, xs, h0, device)
            for name, (kern, plain) in _lstm_fns().items():
                if name not in names:
                    continue
                args = (w,) + inputs[name]
                got, want = _leaves(kern(*args)), _leaves(plain(*args))
                err = _max_err(got, want)
                expect(_within(got, want, TOL[dname]),
                       f"{name} B={b} {dname}: max |kernel - plain| = {err}"
                       f" exceeds {TOL[dname]}")
                r = results[name][(b, dname)] = {
                    "err": err, "ms": time_fn(lambda: direct[name](*args)),
                    "plain_ms": time_fn(lambda: plain(*args)),
                    "library_ms": time_library(library[name]),
                    "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
                if name != "lstm_cell" and time_fn is time_ms:
                    r["cold_ms"] = time_cold_ms(
                        lambda: direct[name](*args), flush)
                    r["library_cold_ms"] = time_cold_ms(library[name], flush)
                if dname != "bfloat16":
                    continue
                probe, unrounded, p_in = h_rounding_probe(w, b, seq)
                p_want = _leaves(plain(probe, *p_in))
                p_got = _leaves(kern(probe, *p_in))
                control = _leaves(plain(unrounded, *p_in))
                r["probe_err"] = _max_err(p_got, p_want)
                r["control_err"] = _max_err(control, p_want)
                expect(_within(p_got, p_want, TOL[dname]),
                       f"{name} B={b} h-rounding probe: max |kernel - "
                       f"plain| = {r['probe_err']} exceeds {TOL[dname]}")
                expect(not _within(control, p_want, TOL[dname]),
                       f"{name} B={b} h-rounding probe: unrounded h is "
                       f"within {TOL[dname]} of the plain version")
            if "greedy_generate" not in names:
                continue
            got = cuda_generate.greedy_generate(qst, h0, seq, dtype)
            want = cuda_generate.greedy_generate_plain(qst, h0, seq, dtype)
            expect(got.shape == (b, seq) and got.dtype == torch.int32,
                   f"greedy_generate B={b} {dname}: shape/dtype")
            gaps = _token_gaps(qst, h0, got, want, dtype)
            for gap in gaps:
                log(f"greedy_generate B={b} {dname}: a token differs at a "
                    f"plain logit gap of {gap}")
            expect(all(g <= TIE_TOL[dname] for g in gaps) and (
                dname == "bfloat16" or not gaps),
                f"greedy_generate B={b} {dname}: tokens differ, gaps {gaps}")
            results["greedy_generate"][(b, dname)] = {
                "err": max(gaps, default=0.0),
                "ms": time_fn(lambda: _generate_kernel_call(qst, h0, seq,
                                                            dtype)),
                "plain_ms": time_fn(lambda: cuda_generate.greedy_generate_plain(
                    qst, h0, seq, dtype)),
                "library_ms": None,
                "bound_ms": bounds["greedy_generate"][0],
                "bound_by": bounds["greedy_generate"][1]}
    for name, per in results.items():
        for (b, dname), r in sorted(per.items()):
            probe = (f"  h-rounding probe {r['probe_err']:.3e}, unrounded "
                     f"control {r['control_err']:.3e}"
                     if "probe_err" in r else "")
            cold = (f"  L2 flushed: kernel {r['cold_ms']:.4f} ms, library "
                    f"{r['library_cold_ms']:.4f} ms" if "cold_ms" in r else "")
            log(f"kernel {name:16s} B={b:3d} {dname:9s} {_times(r)}{cold}"
                f"{probe}")
    return results


def check_seq_plan(device, mcfg, time_fn=time_ms):
    """The sequence kernel's launch shape on this card against the Python
    mirror of the choice, and the time of max_qst_len - 1 empty grid
    barriers (what one call crosses) at that grid."""
    from lctvqa_torch.ops import cuda_lstm as L

    hid, steps = mcfg.lstm_hidden_size, mcfg.max_qst_len
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = {}
    for dname, dtype in DTYPES.items():
        plan = L.seq_plan_on_device(hid, dtype, device)
        want = L.seq_plan(hid, dtype, sms)
        expect(all(plan[k] == want[k] for k in plan),
               f"lstm_seq plan {dname}: the card chose {plan}, the Python "
               f"mirror {want}")
        g = plan["blocks"]
        none = time_fn(lambda: L.grid_barrier_probe(g, 0, device))
        ms = time_fn(lambda: L.grid_barrier_probe(g, steps - 1, device))
        many = time_fn(lambda: L.grid_barrier_probe(g, 10 * steps, device))
        out[dname] = dict(plan, barriers_ms=ms, per_barrier_us=1e3 * (
            many - none) / (10 * steps))
        log(f"lstm_seq {dname} H={hid} on {sms} SMs: {plan['blocks']} blocks "
            f"of {plan['threads']} threads, {plan['units']} units each, "
            f"batch tile {plan['batch_tile']}, {plan['smem_bytes']} B of "
            f"shared memory; {steps - 1} empty grid barriers {ms:.4f} ms, "
            f"none {none:.4f} ms, {10 * steps} barriers {many:.4f} ms "
            f"({out[dname]['per_barrier_us']:.3f} us each)")
    return out


def check_cell_plan(device, mcfg):
    """The cell kernel's launch shape on this card against the Python
    mirror of the choice."""
    from lctvqa_torch.ops import cuda_lstm as L

    emb, hid = mcfg.word_embed_size, mcfg.lstm_hidden_size
    limit = torch.cuda.get_device_properties(device) \
        .shared_memory_per_block_optin
    out = {}
    for dname, dtype in DTYPES.items():
        plan = L.cell_plan_on_device(emb, hid, dtype, device)
        want = L.cell_plan(emb, hid, dtype, limit)
        expect(all(plan[k] == want[k] for k in plan),
               f"lstm_cell plan {dname}: the card chose {plan}, the Python "
               f"mirror {want}")
        out[dname] = plan
        log(f"lstm_cell {dname} E={emb} H={hid}: {plan['blocks']} blocks of "
            f"{plan['threads']} threads, {plan['units']} units each, batch "
            f"tile {plan['batch_tile']}, {plan['smem_bytes']} B of shared "
            "memory")
    return out


def check_generate_plan(device, mcfg, time_fn=time_ms):
    """The decode kernel's launch shape on this card against the Python
    mirror of the choice, and the time of 2 max_qst_len empty grid
    barriers (as many hand-overs as one call makes) at that grid."""
    from lctvqa_torch.ops import cuda_generate as G
    from lctvqa_torch.ops import cuda_lstm as L

    emb, hid, steps = (mcfg.word_embed_size, mcfg.lstm_hidden_size,
                       mcfg.max_qst_len)
    vpad = -(-mcfg.qst_vocab_size // 8) * 8
    props = torch.cuda.get_device_properties(device)
    out = {}
    for dname, dtype in DTYPES.items():
        plan = G.generate_plan_on_device(emb, hid, vpad, dtype, device)
        want = G.generate_plan(emb, hid, vpad, dtype,
                               props.multi_processor_count,
                               props.shared_memory_per_block_optin)
        expect(plan == want, f"greedy_generate plan {dname}: the card chose "
               f"{plan}, the Python mirror {want}")
        ms = time_fn(lambda: L.grid_barrier_probe(plan["blocks"], 2 * steps,
                                                  device))
        out[dname] = dict(plan, barriers_ms=ms)
        log(f"greedy_generate {dname} E={emb} H={hid} V={vpad}: "
            f"{plan['gate_blocks']} gate blocks (batch tile "
            f"{plan['gate_tile']}) and {plan['head_blocks']} head blocks of "
            f"{plan['head_cols']} columns (batch tile {plan['head_tile']}), "
            f"{plan['threads']} threads, {plan['smem_bytes']} B of shared "
            f"memory; {2 * steps} empty grid barriers {ms:.4f} ms")
    return out


def device_times(fn, iters=10, required=True):
    """torch.profiler over `iters` calls of fn, after three unprofiled ones
    -> (device us per call, [(kernel, launches per call, us per call)] in
    launch order). Only device kernels count: the wrapper's host cost,
    which the event-timed medians include, is not in it. A profile that
    saw no kernel is a failure, or (None, []) where not `required`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    if not kernels and not required:
        return None, []
    expect(bool(kernels), "the profiler saw no device kernel")
    # one row per launch position of a call where every call launches the
    # same sequence, else one row per kernel name
    per = len(kernels) // iters
    names = [e.name for e in kernels]
    if per and len(kernels) == per * iters and all(
            names[i] == names[i % per] for i in range(len(names))):
        rows = [(names[i][:60], 1, sum(kernels[c * per + i].time_range
                                       .elapsed_us() for c in range(iters))
                 / iters) for i in range(per)]
    else:
        # the profiler misses a call now and then (9 of 10 seen): a kernel
        # seen n times launches round(n / iters) times a call, each taking
        # its mean duration
        by_name = {}
        for e in kernels:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        rows = [(k[:60], max(1, round(n / iters)),
                 us / n * max(1, round(n / iters)))
                for k, (n, us) in by_name.items()]
    return sum(r[2] for r in rows), rows


def _device_line(tag, total, rows):
    log(f"device time {tag}: {total:.1f} us/call in "
        f"{sum(r[1] for r in rows):g} launches: " + "; ".join(
            f"{us:.1f} us x{n:g} {name}" for name, n, us in rows))


def host_enqueue_us(fn, iters=20):
    """Host time to enqueue one call: a host clock around `iters` calls
    with no synchronize between them (after a synchronize)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / iters


def seq_device_times(device, mcfg, b=64, iters=10):
    """Device time by kernel of one lstm_seq call and of one nn.LSTM call
    at batch `b`."""
    from lctvqa_torch.ops import cuda_lstm as L
    from lctvqa_torch.ops.lstm import lstm_init

    gen = torch.Generator().manual_seed(SEED + 30)
    lp = _to(lstm_init(gen, mcfg.word_embed_size,
                       mcfg.lstm_hidden_size)["layers"][0], device)
    xs = torch.tanh(torch.randn(b, mcfg.max_qst_len, mcfg.word_embed_size,
                                generator=gen)).to(device)
    h0 = torch.nn.functional.normalize(
        torch.randn(b, mcfg.lstm_hidden_size, generator=gen)).to(device)
    for dname, dtype in DTYPES.items():
        w = L.cell_weights(lp, dtype)
        fns = {"lstm_seq": lambda: L.lstm_seq(w, xs, h0, h0),
               "nn.LSTM": lstm_library_fns(w, xs, h0, device)["lstm_seq_all"]}
        for name, fn in fns.items():
            total, rows = device_times(fn, iters)
            _device_line(f"{name} B={b} {dname}", total, rows)


def cell_device_times(device, mcfg, b=64, iters=20):
    """Device time per call of the cell kernel's call (without its
    operator, as _lstm_kernel_calls) and of nn.LSTMCell at
    batch `b`, on the inputs check_kernels gives them (x a strided fp32
    view, h = c the image embedding), with the host's enqueue time per
    call -> {dtype: {"kernel_us", "library_us", "kernel_launches",
    "kernel_enqueue_us", "library_enqueue_us"}}."""
    from lctvqa_torch.ops import cuda_lstm as L
    from lctvqa_torch.ops.lstm import lstm_init

    gen = torch.Generator().manual_seed(SEED + 31)
    lp = _to(lstm_init(gen, mcfg.word_embed_size,
                       mcfg.lstm_hidden_size)["layers"][0], device)
    xs = torch.tanh(torch.randn(b, mcfg.max_qst_len, mcfg.word_embed_size,
                                generator=gen)).to(device)
    h0 = torch.nn.functional.normalize(
        torch.randn(b, mcfg.lstm_hidden_size, generator=gen)).to(device)
    out = {}
    for dname, dtype in DTYPES.items():
        w = L.cell_weights(lp, dtype)
        kern = lambda: L._cell_kernel(w, xs[:, 0], h0, h0)  # noqa: E731
        lib = lstm_library_fns(w, xs, h0, device)["lstm_cell"]
        k_us, k_rows = device_times(kern, iters)
        l_us, l_rows = device_times(lib, iters)
        _device_line(f"lstm_cell B={b} {dname}", k_us, k_rows)
        _device_line(f"nn.LSTMCell B={b} {dname}", l_us, l_rows)
        out[dname] = {"kernel_us": k_us, "library_us": l_us,
                      "kernel_launches": sum(r[1] for r in k_rows),
                      "kernel_enqueue_us": host_enqueue_us(kern),
                      "library_enqueue_us": host_enqueue_us(lib)}
        log(f"lstm_cell B={b} {dname}: host enqueue "
            f"{out[dname]['kernel_enqueue_us']:.1f} us/call, nn.LSTMCell "
            f"{out[dname]['library_enqueue_us']:.1f} us/call")
    return out


# (cell, E, N, dtype) of the node forward's per-launch profile: the
# kernels line's pick, and a small-plane cell
NODE_PROFILE = (("cell0", 5, 64, "bfloat16"), ("cell2", 3, 64, "bfloat16"))


def node_device_times(device, picks=NODE_PROFILE, iters=10):
    """mixed_node_fwd at each pick, called without its operator
    (_node_kernel_call): device time of each launch of one call
    (torch.profiler), the event-timed call and the host's enqueue time ->
    {pick: {"device_us", "launches", "ms", "enqueue_us", "rows"}}."""
    from lctvqa_torch.models import search
    from lctvqa_torch.ops import cuda_mixedop

    out = {}
    for cell, edges, n, dname in picks:
        h, w, c, _ = NODE_SHAPES[cell]
        gen = torch.Generator().manual_seed(SEED + 12)
        ops = [_to(search.mixed_op_init(gen, c, 1, 4), device)
               for _ in range(edges)]
        ops = [dict(p, node=cuda_mixedop.node_weights(p)) for p in ops]
        xs = [torch.randn(n, h, w, c, generator=gen).to(device, DTYPES[dname])
              for _ in ops]
        wts = (torch.softmax(torch.randn(edges, 8, generator=gen), 1)
               * torch.softmax(torch.randn(edges, generator=gen),
                               0)[:, None]).to(device)
        fn = lambda: _node_kernel_call(xs, ops, wts, c // 4)  # noqa
        total, rows = device_times(fn, iters)
        tag = f"mixed_node_fwd {cell} E={edges} N={n} {dname}"
        r = out[(cell, edges, n, dname)] = {
            "device_us": total, "launches": sum(x[1] for x in rows),
            "ms": time_ms(fn), "enqueue_us": host_enqueue_us(fn),
            "rows": rows}
        _device_line(tag, total, rows)
        log(f"{tag}: {r['ms']:.4f} ms a call (events), host enqueue "
            f"{r['enqueue_us']:.1f} us, device {total:.1f} us: host share "
            f"{1 - total / (1e3 * r['ms']):.2f}")
    return out


def node_bwd_device_times(device, picks=NODE_PROFILE, iters=10):
    """mixed_node_bwd at each pick, on the stage outputs one forward left:
    device time of each launch of one call (torch.profiler), the
    event-timed call and the host's enqueue time -> as node_device_times."""
    from lctvqa_torch.models import search
    from lctvqa_torch.ops import cuda_mixedop as M

    out = {}
    for cell, edges, n, dname in picks:
        h, w, c, _ = NODE_SHAPES[cell]
        cs = c // 4
        gen = torch.Generator().manual_seed(SEED + 13)
        nodes = [M.node_weights(_to(search.mixed_op_init(gen, c, 1, 4),
                                    device)) for _ in range(edges)]
        xs = [torch.randn(n, h, w, c, generator=gen).to(
            device, DTYPES[dname])[..., :cs] for _ in nodes]
        wts = (torch.softmax(torch.randn(edges, 8, generator=gen), 1)
               * torch.softmax(torch.randn(edges, generator=gen),
                               0)[:, None]).to(device)
        g = torch.randn(n, h, w, cs, generator=gen).to(device)
        _, obuf, stat = M.node_fwd_launch(xs, nodes, wts, cs, device)
        fn = lambda: M.node_bwd_launch(xs, nodes, wts, g, obuf,  # noqa
                                       stat, cs, device)
        total, rows = device_times(fn, iters)
        tag = f"mixed_node_bwd {cell} E={edges} N={n} {dname}"
        r = out[(cell, edges, n, dname)] = {
            "device_us": total, "launches": sum(x[1] for x in rows),
            "ms": time_ms(fn), "enqueue_us": host_enqueue_us(fn),
            "rows": rows}
        _device_line(tag, total, rows)
        log(f"{tag}: {r['ms']:.4f} ms a call (events), host enqueue "
            f"{r['enqueue_us']:.1f} us, device {total:.1f} us: host share "
            f"{1 - total / (1e3 * r['ms']):.2f}")
        del obuf, stat
    return out


def generate_device_times(device, mcfg, batches=BATCHES, iters=10):
    """greedy_generate at full width, B in `batches`, both dtypes, called
    without its operator (_generate_kernel_call): device
    time per call (torch.profiler), the event-timed call and the host's
    enqueue; where the tree has the grid design, its launch plan and the
    time of as many empty grid barriers as one call crosses ->
    {(B, dtype): {...}}."""
    from lctvqa_torch.models.qst_encoder import ef_qst_encoder_init
    from lctvqa_torch.ops import cuda_generate as G
    from lctvqa_torch.ops import cuda_lstm as L
    from lctvqa_torch.ops import nn as N

    gen = torch.Generator().manual_seed(SEED + 14)
    qst = _to(ef_qst_encoder_init(gen, mcfg.qst_vocab_size,
                                  mcfg.word_embed_size, mcfg.img_embed_size,
                                  1, mcfg.lstm_hidden_size), device)
    seq, hid = mcfg.max_qst_len, mcfg.lstm_hidden_size
    out = {}
    for b in batches:
        h0 = N.l2_normalize(torch.randn(b, hid, generator=gen)).to(device)
        for dname, dtype in DTYPES.items():
            qd = dict(qst, decode=G.decode_weights(qst, dtype))
            fn = lambda: _generate_kernel_call(qd, h0, seq, dtype)  # noqa
            total, rows = device_times(fn, iters)
            tag = f"greedy_generate B={b} {dname}"
            r = out[(b, dname)] = {
                "device_us": total, "launches": sum(x[1] for x in rows),
                "ms": time_ms(fn), "enqueue_us": host_enqueue_us(fn),
                "rows": rows}
            if hasattr(G, "generate_plan_on_device"):
                dw = qd["decode"]
                plan = G.generate_plan_on_device(
                    dw.table.shape[1], hid, dw.fc2_w.shape[1], dtype, device)
                r["plan"] = plan
                # two hand-overs a step
                r["barriers_ms"] = time_ms(lambda: L.grid_barrier_probe(
                    plan["blocks"], 2 * seq, device))
            _device_line(tag, total, rows)
            log(f"{tag}: {r['ms']:.4f} ms a call (events), host enqueue "
                f"{r['enqueue_us']:.1f} us, device {total:.1f} us" + (
                    f"; {2 * seq} empty grid barriers of "
                    f"{r['plan']['blocks']} blocks {r['barriers_ms']:.4f} ms"
                    if "plan" in r else ""))
    return out


def _times(r) -> str:
    lib = ("none" if r["library_ms"] is None
           else f"{r['library_ms']:.4f} ms")
    return (f"max_abs_err {r['err']:.3e}  kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  library {lib}  bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})")


def check_bn_plan(device, x, other, backward: bool, tag: str):
    """The BatchNorm kernel's launch shape for x on this card (the C side's
    choice) against the Python mirror, bn_plan; logged once per shape."""
    from lctvqa_torch.ops import cuda_bn

    c = x.shape[-1]
    m = x.numel() // c
    props = torch.cuda.get_device_properties(device)
    want = cuda_bn.bn_plan(m, c, x.dtype, other, backward,
                           props.multi_processor_count,
                           props.shared_memory_per_block_optin)
    plan = cuda_bn.bn_plan_on_device(m, c, x.dtype, other, backward, device)
    expect(all(plan[k] == want[k] for k in plan),
           f"{tag}: the card chose the launch {plan}, bn_plan {want}")
    log(f"{tag}: {plan['blocks']} blocks of {plan['threads']} threads, "
        f"{plan['rows']} rows each, {plan['staged']} of them in "
        f"{plan['smem_bytes']} B of shared memory")
    return plan


def check_bn_kernel(device, time_fn=time_ms, shapes=BN_SHAPES):
    """bn_fwd at the supernet's shapes (`shapes`) -> {(shape, in, out):
    {...}}."""
    import torch.nn.functional as F

    from lctvqa_torch.ops import cuda_bn

    gen = torch.Generator().manual_seed(SEED + 10)
    results = {}
    for shape in shapes:
        base = (1.5 * torch.randn(shape, generator=gen) + 0.3).to(device)
        for in_name, in_dt in DTYPES.items():
            x = base.to(in_dt)
            nchw = x.permute(0, 3, 1, 2)  # a channels-last view, no copy
            for out_name, out_dt in DTYPES.items():
                tag = f"bn_fwd {shape} {in_name}->{out_name}"
                check_bn_plan(device, x, out_dt, False, tag)
                got, stat, _ = cuda_bn.batchnorm_fwd_stat(x, out_dt)
                again, stat2, _ = cuda_bn.batchnorm_fwd_stat(x, out_dt)
                want = cuda_bn.batchnorm_plain(x, out_dtype=out_dt)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                limit = (1e-5 + 1e-5 * want.float().abs()
                         if out_name == "float32"
                         else 1e-5 + 2.0 ** -7 * want.float().abs())
                err = float(diff.max())
                expect(got.dtype == out_dt and got.shape == x.shape
                       and bool((diff <= limit).all()),
                       f"{tag}: max |kernel - plain| = {err} exceeds its "
                       "limit")
                expect(torch.equal(got, again) and torch.equal(stat, stat2),
                       f"{tag}: two calls in a row differ")
                n = x.numel()
                ms, by = bound(n * (x.element_size() + got.element_size()),
                               5 * n, "float32")
                r = results[(shape, in_name, out_name)] = {
                    "err": err, "bound_ms": ms, "bound_by": by,
                    # the call without the operator (as
                    # _lstm_kernel_calls)
                    "ms": time_fn(lambda: cuda_bn.batchnorm_fwd_stat(
                        x, out_dt)[0]),
                    "plain_ms": time_fn(lambda: cuda_bn.batchnorm_plain(
                        x, out_dtype=out_dt)),
                    "library_ms": time_library(lambda: F.batch_norm(
                        nchw, None, None, training=True, eps=1e-5))}
                log(f"kernel {tag}: {_times(r)}")
    return results


def node_bound(n, h, w, cs, edges, dname):
    """Each edge's Cs-channel slice read once, the fp32 output written
    once; per input element 102 depthwise taps, six Cs-wide pointwise
    sums, two 9-tap pools and the statistics and fold of seven stage
    outputs, all fp32 outside the tensor cores."""
    elems = n * h * w * cs
    wb = 2 if dname == "bfloat16" else 4
    flops = edges * elems * (2 * 102 + 2 * 6 * cs + 18 + 7 * 5)
    return bound(edges * elems * wb + elems * 4, flops, "float32")


def check_node_kernel(device, batches=BATCHES, time_fn=time_ms,
                      shapes=NODE_SHAPES):
    """mixed_node_fwd at the four cell shapes (`shapes`) ->
    {(cell, E, N, dtype): {...}}."""
    from lctvqa_torch.models import search
    from lctvqa_torch.ops import cuda_mixedop

    gen = torch.Generator().manual_seed(SEED + 11)
    results = {}
    for cell, (h, w, c, edge_counts) in shapes.items():
        cs = c // 4
        ops = [_to(search.mixed_op_init(gen, c, 1, 4), device)
               for _ in range(max(edge_counts))]
        ops = [dict(p, node=cuda_mixedop.node_weights(p)) for p in ops]
        for n in batches:
            states = [torch.randn(n, h, w, c, generator=gen).to(device)
                      for _ in ops]
            for edges in edge_counts:
                wts = (torch.softmax(torch.randn(edges, 8, generator=gen), 1)
                       * torch.softmax(torch.randn(edges, generator=gen),
                                       0)[:, None]).to(device)
                nodes = [p["node"] for p in ops[:edges]]
                for dname, dtype in DTYPES.items():
                    xs = [s.to(dtype) for s in states[:edges]]
                    got = cuda_mixedop.mixed_node(xs, ops[:edges], wts, cs)
                    want = cuda_mixedop.mixed_node_plain(xs, nodes, wts, cs)
                    torch.cuda.synchronize()
                    over = _node_fwd_over(got, want, wts, dname)
                    err = float((got - want).abs().max())
                    tag = (f"mixed_node_fwd {cell} {h}x{w} Cs={cs} E={edges} "
                           f"N={n} {dname}")
                    expect(got.shape == (n, h, w, cs)
                           and got.dtype == torch.float32 and over <= 1.0,
                           f"{tag}: max |kernel - plain| = {err}, {over:.3f} "
                           "of the limit")
                    ms, by = node_bound(n, h, w, cs, edges, dname)
                    r = results[(cell, edges, n, dname)] = {
                        "err": err, "bound_ms": ms, "bound_by": by,
                        "library_ms": None,
                        "ms": time_fn(lambda: _node_kernel_call(
                            xs, ops[:edges], wts, cs)),
                        "plain_ms": time_fn(
                            lambda: cuda_mixedop.mixed_node_plain(
                                xs, nodes, wts, cs), reps=5, warmup=1)}
                    log(f"kernel {tag}: {_times(r)}")
    return results


def _grad_err(got, want):
    """-> (max |got - want|, max |want|) of two gradients."""
    return (float((got.float() - want.float()).abs().max()),
            float(want.float().abs().max()))


def check_bn_bwd_kernel(device, time_fn=time_ms, shapes=BN_SHAPES):
    """bn_bwd at the supernet's shapes (`shapes`) -> {(shape, x dtype, g
    dtype): {...}}. The library call is autograd's backward of
    F.batch_norm(training=True) on the channels-last view."""
    import torch.nn.functional as F

    from lctvqa_torch.ops import cuda_bn

    gen = torch.Generator().manual_seed(SEED + 20)
    results = {}
    for shape in shapes:
        base = (1.5 * torch.randn(shape, generator=gen) + 0.3).to(device)
        gbase = torch.randn(shape, generator=gen).to(device)
        for x_name, x_dt in DTYPES.items():
            x = base.to(x_dt)
            _, stat, _ = cuda_bn.batchnorm_fwd_stat(x)
            for g_name, g_dt in DTYPES.items():
                g = gbase.to(g_dt)
                tag = f"bn_bwd {shape} x {x_name} g {g_name}"
                check_bn_plan(device, x, g_dt, True, tag)
                got = cuda_bn.batchnorm_bwd(x, g, stat)
                again = cuda_bn.batchnorm_bwd(x, g, stat)
                want = cuda_bn.batchnorm_bwd_plain(
                    x, g, cuda_bn.batchnorm_stats_plain(x))
                torch.cuda.synchronize()
                err, scale = _grad_err(got, want)
                tol = 1e-5 if x_name == "float32" else 2.0 ** -7
                expect(got.dtype == x_dt and got.shape == x.shape
                       and bool(torch.isfinite(got.float()).all())
                       and err <= tol * scale,
                       f"{tag}: max |kernel - plain| = {err} exceeds "
                       f"{tol} * {scale}")
                expect(torch.equal(got, again),
                       f"{tag}: two calls in a row differ")
                n = x.numel()
                ms, by = bound(n * (2 * x.element_size() + g.element_size()),
                               10 * n, "float32")
                xl = x.permute(0, 3, 1, 2).detach().requires_grad_()
                yl = F.batch_norm(xl, None, None, training=True, eps=1e-5)
                gl = g.to(yl.dtype).permute(0, 3, 1, 2)
                r = results[(shape, x_name, g_name)] = {
                    "err": err, "bound_ms": ms, "bound_by": by,
                    "ms": time_fn(lambda: cuda_bn.batchnorm_bwd(x, g, stat)),
                    "plain_ms": time_fn(lambda: cuda_bn.batchnorm_bwd_plain(
                        x, g, stat)),
                    "library_ms": time_library(lambda: torch.autograd.grad(
                        yl, xl, gl, retain_graph=True))}
                log(f"kernel {tag}: {_times(r)}")
    return results


def _device_times_or_none(fn, iters):
    """device_times of a PyTorch call that serves only as a yardstick; None
    where this PyTorch build does not take it."""
    try:
        return device_times(fn, iters)[0]
    except (RuntimeError, NotImplementedError) as e:
        log(f"library call not profiled: {type(e).__name__}: {e}")
        return None


def bn_device_times(device, iters=10):
    """bn_fwd and bn_bwd at every BN_SHAPES entry and dtype pair (forward:
    x, y; backward: x, g; the forward without its operator, as
    _lstm_kernel_calls): the event-timed call, the device time of each
    launch of one call (torch.profiler), the host's enqueue, and the
    library call's time and device time (F.batch_norm(training=True) on the
    channels-last view; autograd's backward of it) -> {"fwd": {(shape, x,
    y): {...}}, "bwd": {(shape, x, g): {...}}}. Takes any tree's cuda_bn."""
    import torch.nn.functional as F

    from lctvqa_torch.ops import cuda_bn

    gen = torch.Generator().manual_seed(SEED + 22)
    out = {"fwd": {}, "bwd": {}}
    for shape in BN_SHAPES:
        base = (1.5 * torch.randn(shape, generator=gen) + 0.3).to(device)
        gbase = torch.randn(shape, generator=gen).to(device)
        for a_name, a_dt in DTYPES.items():
            x = base.to(a_dt)
            nchw = x.permute(0, 3, 1, 2)  # a channels-last view, no copy
            _, stat, _ = cuda_bn.batchnorm_fwd_stat(x)
            xl = nchw.detach().requires_grad_()
            yl = F.batch_norm(xl, None, None, training=True, eps=1e-5)
            for b_name, b_dt in DTYPES.items():
                g = gbase.to(b_dt)
                gl = g.to(yl.dtype).permute(0, 3, 1, 2)
                calls = {
                    "fwd": (lambda: cuda_bn.batchnorm_fwd_stat(x, b_dt)[0],
                            lambda: F.batch_norm(nchw, None, None,
                                                 training=True, eps=1e-5)),
                    "bwd": (lambda: cuda_bn.batchnorm_bwd(x, g, stat),
                            lambda: torch.autograd.grad(yl, xl, gl,
                                                        retain_graph=True))}
                n = x.numel()
                bounds = {"fwd": bound(n * (x.element_size()
                                            + g.element_size()), 5 * n,
                                       "float32"),
                          "bwd": bound(n * (2 * x.element_size()
                                            + g.element_size()), 10 * n,
                                       "float32")}
                for kind, (fn, lib) in calls.items():
                    total, rows = device_times(fn, iters)
                    r = out[kind][(shape, a_name, b_name)] = {
                        "bound_ms": bounds[kind][0], "device_us": total,
                        "launches": sum(row[1] for row in rows),
                        "ms": time_ms(fn), "enqueue_us": host_enqueue_us(fn),
                        "library_ms": time_library(lib),
                        "library_device_us": _device_times_or_none(lib,
                                                                   iters),
                        "rows": rows}
                    tag = (f"bn_{kind} {shape} {a_name} "
                           f"{'->' if kind == 'fwd' else 'g'} {b_name}")
                    _device_line(tag, total, rows)
                    lib_ms, lib_us = r["library_ms"], r["library_device_us"]
                    log(f"{tag}: {r['ms']:.4f} ms a call (events), host "
                        f"enqueue {r['enqueue_us']:.1f} us, device "
                        f"{total:.1f} us, bound {1e3 * r['bound_ms']:.1f} "
                        f"us; library "
                        + (f"{lib_ms:.4f} ms" if lib_ms is not None
                           else "not timed")
                        + (f", device {lib_us:.1f} us" if lib_us is not None
                           else ""))
    return out


def node_bwd_bound(n, h, w, cs, edges, dname):
    """Each edge's Cs-channel slice and the fp32 output gradient read once,
    each dx written once (the weight gradients are a few KB); about three
    times the forward's operations: each stage's depthwise and pointwise
    products twice more (for the input and for the weights), and the
    depthwise output computed again."""
    elems = n * h * w * cs
    wb = 2 if dname == "bfloat16" else 4
    flops = 3 * edges * elems * (2 * 102 + 2 * 6 * cs + 18 + 7 * 5)
    return bound(2 * edges * elems * wb + elems * 4, flops, "float32")


def _untimed(fn, **kwargs) -> float:
    return 0.0


def check_node_bwd_kernel(device, batches=BATCHES, time_fn=time_ms,
                          fault_draw=NODE_BWD_FAULT_DRAW, shapes=NODE_SHAPES):
    """mixed_node_bwd at the four cell shapes (`shapes`) -> {(cell, E, N,
    dtype): {...}} (of the draw `batches`). `err` is the largest error of any
    gradient relative to that gradient's scale against the plain backward
    that takes the kernel's inner ReLU decisions, `autograd_err` against
    autograd through the plain forward. Then, untimed, the same on the
    inputs of `fault_draw`, which gave the inner ReLU decisions that the
    two forwards take differently (ROADMAP.md section 3)."""
    results = _node_bwd_draw(device, batches, time_fn, shapes)
    if fault_draw:
        _node_bwd_draw(device, fault_draw, _untimed, shapes)
    return results


def node_bwd_cases(device, batches, shapes=NODE_SHAPES):
    """check_node_bwd_kernel's inputs in the order of its draw (a seeded
    torch.Generator, so that a draw is the same on every card): for each
    cell shape, N in `batches`, E and dtype, (cell, N, E, dtype name, the
    edge slices xs, their packed weights, the weights [E, 8], g)."""
    from lctvqa_torch.models import search
    from lctvqa_torch.ops import cuda_mixedop as M

    gen = torch.Generator().manual_seed(SEED + 21)
    for cell, (h, w, c, edge_counts) in shapes.items():
        cs = c // 4
        ops = [_to(search.mixed_op_init(gen, c, 1, 4), device)
               for _ in range(max(edge_counts))]
        all_nodes = [M.node_weights(p) for p in ops]
        for n in batches:
            states = [torch.randn(n, h, w, c, generator=gen).to(device)
                      for _ in ops]
            g = torch.randn(n, h, w, cs, generator=gen).to(device)
            for edges in edge_counts:
                wts = (torch.softmax(torch.randn(edges, 8, generator=gen), 1)
                       * torch.softmax(torch.randn(edges, generator=gen),
                                       0)[:, None]).to(device)
                for dname, dtype in DTYPES.items():
                    xs = [s.to(dtype)[..., :cs] for s in states[:edges]]
                    yield cell, n, edges, dname, xs, all_nodes[:edges], wts, g


def _node_bwd_draw(device, batches, time_fn, shapes=NODE_SHAPES):
    from lctvqa_torch.ops import cuda_mixedop as M

    results = {}
    for cell, n, edges, dname, xs, nodes, wts, g in node_bwd_cases(
            device, batches, shapes):
        h, w, c, _ = shapes[cell]
        cs, dtype = c // 4, DTYPES[dname]
        _, obuf, stat = M.node_fwd_launch(xs, nodes, wts, cs,
                                          device)
        got = M.node_bwd_launch(xs, nodes, wts, g, obuf, stat, cs,
                                device)
        auto = M.mixed_node_bwd_plain(xs, nodes, wts, g, cs)
        # a tree older than the decision-matched reference
        # (--root) is held against autograd alone
        want = (M.mixed_node_bwd_plain(xs, nodes, wts, g, cs,
                                       kept=(obuf, stat))
                if hasattr(M, "sep_inner_inputs_kept") else auto)
        torch.cuda.synchronize()
        tols = _node_bwd_tols(edges, dname)
        ok, rel, _ = _node_grads_within(got, want, tols)
        _, rel_auto, worst = _node_grads_within(got, auto, tols)
        tag = (f"mixed_node_bwd {cell} {h}x{w} Cs={cs} E={edges} "
               f"N={n} {dname}")
        expect(ok and got[0][0].dtype == dtype
               and got[3].shape == (edges, 8),
               f"{tag}: a gradient differs from the plain "
               f"version's by {rel} of its scale")
        log(f"{tag}: against autograd through the plain forward "
            f"(its own ReLU decisions) {rel_auto:.3e} of scale")
        if rel_auto > tols[0] and worst < edges and hasattr(
                M, "sep_inner_inputs_kept"):
            explain_node_bwd(xs, nodes, cs, obuf, stat,
                             got[0][worst], auto[0][worst],
                             worst, tag)
        ms, by = node_bwd_bound(n, h, w, cs, edges, dname)
        r = results[(cell, edges, n, dname)] = {
            "err": rel, "autograd_err": rel_auto,
            "bound_ms": ms, "bound_by": by,
            "library_ms": None,
            "ms": time_fn(lambda: M.node_bwd_launch(
                xs, nodes, wts, g, obuf, stat, cs, device)),
            "plain_ms": time_fn(lambda: M.mixed_node_bwd_plain(
                xs, nodes, wts, g, cs), reps=3, warmup=1)}
        log(f"kernel {tag}: {_times(r)}")
        del obuf, stat, got, want, auto
    return results


def _node_fwd_over(got, want, wts, dname) -> float:
    """The node forward's largest error as a share of phase 2's limit
    (check_node_kernel): fp32 1e-5 + 1e-5 |plain|, bf16 4 ulp of bf16 at
    the largest weight."""
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return float("inf")
    diff = (got.float() - want.float()).abs()
    limit = (1e-5 + 1e-5 * want.float().abs() if dname == "float32"
             else torch.full_like(diff, 4 * 2.0 ** -7 * float(wts.max())))
    return float((diff / limit).max())


def _node_bwd_tols(edges: int, dname: str) -> list:
    """Phase 2's node backward limits (check_node_bwd_kernel): each dx,
    then d dw, d pw and d weights, relative to their own scale."""
    fp32 = dname == "float32"
    return [1e-4 if fp32 else 2.0 ** -7] * edges + [
        1e-4 if fp32 else 2e-3] * 3


def _node_grads_within(got, want, tols):
    """mixed_node_bwd's outputs against a plain version's, each gradient
    relative to its own scale -> (all finite and within `tols`, the
    largest relative error, the index of the gradient that has it: edge
    e's dx is e, then d dw, d pw, d weights)."""
    pairs = list(zip(got[0], want[0])) + list(zip(got[1:], want[1:]))
    rel, ok, worst = 0.0, True, 0
    for i, ((a, b), tol) in enumerate(zip(pairs, tols)):
        err, scale = _grad_err(a, b)
        ok = ok and bool(torch.isfinite(a.float()).all()) \
            and err <= tol * scale
        if err / max(scale, 1e-30) > rel:
            rel, worst = err / max(scale, 1e-30), i
    return ok, rel, worst


def explain_node_bwd(xs, nodes, cs, obuf, stat, dx, dx_auto, e, tag):
    """Where the kernel's dx of edge e differs most from autograd through
    the plain forward: the element, the stage outputs the kernel stored
    there and the plain version's recomputed ones, and every inner ReLU
    decision and max-pool tap that the two forwards take differently on
    this edge, with its distance from the element. A decision flips where
    the inner BatchNorm's output lies within an ulp of 0; a tap differs
    where a 3x3 window of x holds its maximum twice."""
    import torch.nn.functional as F

    from lctvqa_torch.ops import cuda_mixedop as M

    n, h, w, _ = xs[e].shape
    diff = (dx.float() - dx_auto.float()).abs()
    at = np.unravel_index(int(diff.argmax()), tuple(diff.shape))
    pix = (at[0] * h + at[1]) * w + at[2]
    log(f"{tag}: edge {e} dx worst at (n, h, w, c) = {tuple(map(int, at))}: "
        f"kernel {float(dx[at]):.6e}, autograd {float(dx_auto[at]):.6e}, "
        f"|diff| {float(diff[at]):.3e}; x there {float(xs[e][at]):.6e}")
    kept = M.sep_inner_inputs_kept(obuf, stat, (n, h, w))[e]
    plain = M.sep_inner_inputs_plain([xs[e]], [nodes[e]], cs)[0]
    for b, name in enumerate(("sep_conv_3x3", "sep_conv_5x5")):
        log(f"  {name} stage 1 at the element's pixel, channels 0..{cs - 1}:"
            f" stored o {obuf[b, e, :, pix].float().tolist()}, inner ReLU "
            f"input kernel {kept[b][at[:3]].tolist()}, plain "
            f"{plain[b][at[:3]].tolist()}")
        flips = ((kept[b] > 0) != (plain[b] > 0)).nonzero().tolist()
        log(f"  {name}: {len(flips)} inner ReLU decision(s) differ on this "
            "edge")
        for q in flips[:8]:
            q = tuple(q)
            dist = max(abs(q[1] - int(at[1])), abs(q[2] - int(at[2])))
            log(f"    at {q} (same image: {q[0] == int(at[0])}, "
                f"{dist} px away): kernel {float(kept[b][q]):.3e}, plain "
                f"{float(plain[b][q]):.3e}, stored o "
                f"{float(obuf[b, e, q[3], (q[0] * h + q[1]) * w + q[2]]):.9e}")
    # max-pool taps: the kernel takes the first maximal tap of each window
    # in row-major order, PyTorch's max_pool2d its own choice
    x32 = xs[e][..., :cs].float().permute(0, 3, 1, 2)
    _, idx = F.max_pool2d(x32, 3, 1, 1, return_indices=True)
    win = F.unfold(F.pad(x32, (1, 1, 1, 1), value=-float("inf")), 3)
    first = win.view(n, cs, 9, h * w).argmax(2)  # first maximal tap
    ty, tx = first // 3 - 1, first % 3 - 1
    pos = torch.arange(h * w, device=x32.device)
    want = (pos // w + ty) * w + (pos % w + tx)
    taps = (idx.view(n, cs, h * w) != want).nonzero().tolist()
    log(f"  max pool: {len(taps)} window(s) whose tap differs on this edge"
        + "".join(f"; at (n, c, pixel) {tuple(t)}" for t in taps[:8]))


def check_pool_gradients(device):
    """The port's avg_pool and max_pool gradients on the card against the
    CPU's, on a channel slice of an NHWC tensor as the supernet pools
    one (exact sums of at most nine terms: 1e-6). PyTorch's own CUDA
    avg_pool2d backward on the same channels-last view is logged beside
    it: PyTorch 2.11 returns it shifted by a pixel, which is why
    ops/conv.py takes that backward on contiguous tensors."""
    import torch.nn.functional as F

    from lctvqa_torch.ops import conv as C

    gen = torch.Generator().manual_seed(SEED + 24)
    x = torch.randn(4, 16, 16, 64, generator=gen)
    for stride in (1, 2):
        g = torch.randn(4, 16 // stride, 16 // stride, 16, generator=gen)
        fns = {"avg_pool": lambda v: C.avg_pool(v[..., :16], 3, stride, 1),
               "max_pool": lambda v: C.max_pool(v[..., :16], 3, stride, 1),
               "F.avg_pool2d": lambda v: F.avg_pool2d(
                   v[..., :16].permute(0, 3, 1, 2), 3, stride, 1,
                   count_include_pad=False).permute(0, 2, 3, 1)}
        for name, fn in fns.items():
            grads = []
            for dev in ("cpu", device):
                v = x.to(dev).requires_grad_()
                grads.append(torch.autograd.grad(fn(v), v, g.to(dev))[0].cpu())
            err = float((grads[0] - grads[1]).abs().max())
            if name.startswith("F."):
                log(f"library {name} backward, stride {stride}, channels-last"
                    f" view: card vs CPU max |diff| {err:.3e} (informational)")
            else:
                log(f"{name} gradient, stride {stride}: card vs CPU max "
                    f"|diff| {err:.3e}")
                expect(err <= 1e-6, f"{name} gradient on the card differs "
                       f"from the CPU's by {err}")
        # the avg pool's second order, as stage 3 takes it: a
        # Hessian-vector product through a loss that cubes the output
        v = torch.randn(x.shape, generator=gen)
        hvps = []
        for dev in ("cpu", device):
            xd = x.to(dev).requires_grad_()
            (gd,) = torch.autograd.grad(
                (fns["avg_pool"](xd) ** 3).sum(), xd, create_graph=True)
            hvps.append(torch.autograd.grad((gd * v.to(dev)).sum(),
                                            xd)[0].cpu())
        err = float((hvps[0] - hvps[1]).abs().max())
        log(f"avg_pool second order, stride {stride}: card vs CPU max "
            f"|diff| {err:.3e} (largest {float(hvps[0].abs().max()):.3e})")
        expect(err <= 1e-6 * (1 + float(hvps[0].abs().max())),
               f"avg_pool's second order on the card differs from the "
               f"CPU's by {err}")


def check_lstm_functions(device, mcfg, b=64):
    """Gradients through the three LSTM Functions (kernel forward) against
    autograd through the plain versions alone, at full width."""
    from lctvqa_torch.ops import cuda_lstm as L
    from lctvqa_torch.ops.lstm import lstm_init

    gen = torch.Generator().manual_seed(SEED + 22)
    lp = _to(lstm_init(gen, mcfg.word_embed_size,
                       mcfg.lstm_hidden_size)["layers"][0], device)
    xs = torch.tanh(torch.randn(b, mcfg.max_qst_len, mcfg.word_embed_size,
                                generator=gen)).to(device)
    h0 = torch.nn.functional.normalize(
        torch.randn(b, mcfg.lstm_hidden_size, generator=gen)).to(device)
    for dname, dtype in DTYPES.items():
        for name, (kern, plain) in _lstm_fns().items():
            grads = []
            before = L.K.launch_counts()[name]
            for fn in (kern, plain):
                leaves = [v.clone().requires_grad_()
                          for v in (xs, h0, h0, *lp.values())]
                w = L.cell_weights(dict(zip(lp, leaves[3:])), dtype)
                outs = _leaves(fn(w, *leaves[:3]))
                cots = [torch.randn(o.shape, generator=torch.Generator()
                                    .manual_seed(SEED + 23 + i)).to(device)
                        for i, o in enumerate(outs)]
                grads.append(torch.autograd.grad(outs, leaves, cots))
            torch.cuda.synchronize()
            expect(L.K.launch_counts()[name] == before + 1,
                   f"{name} {dname}: the Function did not launch the kernel")
            tol = 1e-5 if dname == "float32" else 1e-3
            rel = 0.0
            for a, want in zip(*grads):
                err, scale = _grad_err(a, want)
                rel = max(rel, err / max(scale, 1e-30))
            expect(rel <= tol, f"{name} {dname}: a gradient through the "
                   f"Function differs by {rel} of its scale")
            log(f"function {name} B={b} {dname}: gradients vs autograd "
                f"through the plain version, max rel err {rel:.3e}")


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# phase 3: artifacts
# ---------------------------------------------------------------------------

def vocab_words(mcfg):
    qst = (["<pad>", "<unk>", "<start>", "<end>"]
           + [f"w{i}" for i in range(mcfg.qst_vocab_size - 4)])
    ans = ["<unk>"] + [f"a{i}" for i in range(mcfg.ans_vocab_size - 1)]
    return qst, ans


def model_configs():
    """Full width: ModelConfig's defaults, whose encoder is the PC-DARTS
    supernet, and the same with the fixed VGG19 encoder and with the
    derived network of DERIVED_GENOTYPE (its cells' shape, 4 nodes and 4
    concatenated, is the defaults'), and the unified model on the supernet
    at phase 11's vocabulary of UNIFIED_VOCAB words."""
    import dataclasses

    from lctvqa_torch.config import ModelConfig

    from lctvqa_torch.models import genotypes

    darts = ModelConfig()
    fixed = dataclasses.replace(darts, arch_type="fixed")
    derived = dataclasses.replace(darts, arch_type="derived",
                                  genotype=getattr(genotypes, DERIVED_GENOTYPE))
    unified = dataclasses.replace(darts, qst_vocab_size=UNIFIED_VOCAB)
    return {"w": fixed, "ef": fixed, "darts": darts, "derived": derived,
            "unified": unified}


def write_artifacts(out_dir: Path, names=("w", "ef", "darts"),
                    overrides=None):
    """Seeded full-width params of model_configs()'s W, EF and unified
    models (with ModelConfig `overrides`) -> artifact files. The
    supernet's arch parameters are scaled up from their 1e-3 init so that
    the op mixture is not uniform."""
    import dataclasses

    from lctvqa_torch import __version__, convert
    from lctvqa_torch.export import ARTIFACT_VERSION, save_artifact
    from lctvqa_torch.models import unified, vqa_ef, vqa_w

    paths = {}
    for seed, name in enumerate(names, start=SEED + 1):
        mcfg = dataclasses.replace(model_configs()[name], **(overrides or {}))
        qst_words, ans_words = vocab_words(mcfg)
        gen = torch.Generator().manual_seed(seed)
        if name == "w":
            params, arch = vqa_w.init_w_model(gen, mcfg), None
        elif name == "unified":
            params, arch = unified.init_unified_model(gen, mcfg)
        else:
            params, arch = vqa_ef.init_ef_model(gen, mcfg)
        bundle = {"params": convert.to_jax(params)}
        if arch is not None:
            bundle["arch"] = convert.to_jax(
                {k: 500.0 * v for k, v in arch.items()})
        n = sum(p.numel() for p in _leaves(params))
        meta = {"artifact_version": ARTIFACT_VERSION,
                "family": name if name in ("w", "unified") else "ef",
                "int8": False, "platforms": ["cuda"],
                "img_size": mcfg.img_size, "max_qst_len": mcfg.max_qst_len,
                "qst_vocab_size": mcfg.qst_vocab_size,
                "ans_vocab_size": mcfg.ans_vocab_size,
                "arch_type": mcfg.arch_type, "epoch": None,
                "lctvqa_version": __version__,
                "unified_words" if name == "unified" else "qst_words":
                qst_words, "ans_words": ans_words}
        path = out_dir / f"{name}.lctx"
        save_artifact({"exported": {}, "params": bundle, "meta": meta},
                      str(path))
        log(f"artifact {name}: {n} params, "
            f"{path.stat().st_size / 2**20:.1f} MiB")
        paths[name] = str(path)
    return paths


class kernel_flags:
    """The flag set `fname` for a run: ModelConfig overrides as `.flags`,
    and the process-wide BatchNorm kernel switch set for the duration."""

    def __init__(self, fname: str):
        self.fname = fname
        self.flags = KERNEL_FLAGS[fname]

    def __enter__(self):
        from lctvqa_torch.ops import conv

        self._was = conv.USE_PALLAS_BN
        conv.USE_PALLAS_BN = BN_KERNEL[self.fname]
        return self.flags

    def __exit__(self, *exc):
        from lctvqa_torch.ops import conv

        conv.USE_PALLAS_BN = self._was


# ---------------------------------------------------------------------------
# phase 4: HTTP serving
# ---------------------------------------------------------------------------

# the servers are local: no proxy from the environment may carry a request
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _post(port: int, path: str, payload=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with _OPENER.open(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def serve_run(paths, device, flags, n_answer=24, n_generate=12,
              max_batch=64):
    """Serve the artifacts, send concurrent requests; -> responses."""
    from lctvqa_torch import serve

    mcfg = model_configs()["w"]
    qst_words, ans_words = vocab_words(mcfg)
    rng = np.random.default_rng(SEED)
    s = mcfg.img_size
    images = rng.integers(0, 256, (max(n_answer, n_generate), s, s, 3),
                          dtype=np.uint8)
    questions = [" ".join(rng.choice(qst_words[4:], 6)) for _ in images]
    servers = {}
    try:
        for name, path in paths.items():
            t0 = time.perf_counter()
            srv = serve.make_server(path, port=0, window_ms=5.0,
                                    max_batch=max_batch, device=device,
                                    genotype=ARTIFACT_GENOTYPE.get(name),
                                    compute_dtype="float32", **flags)
            calls = srv.RequestHandlerClass.service.warmup()
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            servers[name] = srv
            log(f"serve {name}: loaded and warmed {calls} calls in "
                f"{time.perf_counter() - t0:.1f} s")
        ports = {f: srv.server_address[1] for f, srv in servers.items()}

        def img_b64(i):
            return base64.b64encode(images[i].tobytes()).decode()

        jobs = [(name, "/answer", i) for name in paths
                for i in range(n_answer)]
        jobs += [(name, "/generate", i) for name in paths if name != "w"
                 for i in range(n_generate)]

        def ask(job):
            name, path, i = job
            payload = {"image_b64": img_b64(i)}
            if path == "/answer":
                payload["question"] = questions[i]
            return _post(ports[name], path, payload)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(32) as pool:
            results = list(pool.map(ask, jobs))
        wall = time.perf_counter() - t0
        health = {f: _post(p, "/healthz") for f, p in ports.items()}
        groups = {name: srv.RequestHandlerClass.service.batcher.batch_sizes
                  for name, srv in servers.items()}
    finally:
        for srv in servers.values():
            srv.shutdown()
            srv.server_close()
    out = {f"{name}_{path[1:]}": [] for name, path, _ in jobs}
    for (name, path, _), (status, body) in zip(jobs, results):
        expect(status == 200, f"{name} {path}: HTTP {status} {body}")
        out[f"{name}_{path[1:]}"].append(body)
        ok = (isinstance(body.get("answer_id"), int)
              and 0 <= body["answer_id"] < mcfg.ans_vocab_size
              and body.get("answer") == ans_words[body["answer_id"]])
        if path == "/generate":
            ok = ok and isinstance(body.get("question"), str)
        expect(ok, f"{name} {path}: malformed response {body}")
    for name, (status, body) in health.items():
        expect(status == 200 and body.get("ok") is True
               and body.get("family") == ("w" if name == "w" else "ef"),
               f"{name} /healthz: {status} {body}")
    log(f"served {len(jobs)} requests in {wall:.2f} s "
        f"({len(jobs) / wall:.1f} req/s, 32 client threads); dispatch "
        f"groups: " + ", ".join(f"{k} {len(v)} (largest {max(v)})"
                                for k, v in groups.items()))
    return out


# ---------------------------------------------------------------------------
# phase 5: the darts EF at fixed dispatch groups, both flag sets
# ---------------------------------------------------------------------------

def _image_features(model, u8) -> torch.Tensor:
    """The EF model's L2-normalized image embedding [B, embed]."""
    from lctvqa_torch.data.pipeline import normalize_images
    from lctvqa_torch.models import vqa_ef

    with torch.inference_mode():
        img = normalize_images(torch.as_tensor(u8).to(model.device))
        return vqa_ef.ef_img_encode(model.params, model.arch, model.config,
                                    img)


def _features_agree(got, want, tag) -> None:
    got, want = got.cpu(), want.cpu()
    err = float((got - want).abs().max())
    log(f"{tag}: image features max |diff| {err:.3e} (scale "
        f"{float(want.abs().max()):.3f})")
    expect(bool(torch.isfinite(got).all())
           and _within([got], [want], DARTS_FEATURE_TOL),
           f"{tag}: image features differ by {err}")


def _tokens_agree(model, u8, got_tok, want_tok, tag) -> None:
    """Greedy tokens equal, or a near tie: at the first differing step the
    logits `model` gives the two tokens, fed the common prefix, lie within
    DARTS_TIE_TOL of each other."""
    if torch.equal(got_tok, want_tok):
        return
    with torch.inference_mode():
        feat = _image_features(model, u8)
        decoder = model.params["qa" if "qa" in model.params else "qst"]
        gaps = _token_gaps(decoder, feat, got_tok.to(feat.device),
                           want_tok.to(feat.device), torch.float32)
    for gap in gaps:
        log(f"{tag}: a token differs at a logit gap of {gap}")
    expect(all(abs(g) <= DARTS_TIE_TOL for g in gaps),
           f"{tag}: greedy tokens differ beyond a near tie, gaps {gaps}")


def check_darts_groups(path, device, groups=(1, 4, 64)):
    from lctvqa_torch.export import ServingModel, read_artifact
    from lctvqa_torch.ops import _build

    art = read_artifact(path)
    mcfg = model_configs()["darts"]
    rng = np.random.default_rng(SEED + 5)
    s = mcfg.img_size
    models = {}
    for fname in KERNEL_FLAGS:
        with kernel_flags(fname) as flags:
            models[fname] = ServingModel(art, device, compute_dtype="float32",
                                         **flags)
    for n in groups:
        u8 = rng.integers(0, 256, (n, s, s, 3), dtype=np.uint8)
        qst = rng.integers(0, mcfg.qst_vocab_size, (n, mcfg.max_qst_len),
                           dtype=np.int32)
        out = {}
        for fname, model in models.items():
            with kernel_flags(fname):
                before = _build.launch_counts()
                logits = model.answer_logits(u8, qst)
                after = _build.launch_counts()
                tok, ans = model.generate(u8)
                feat = _image_features(model, u8)
            torch.cuda.synchronize()
            out[fname] = (logits, tok, ans, feat)
            calls = {k: after[k] - before[k]
                     for k in ("mixed_node_fwd", "bn_fwd")}
            log(f"darts group of {n}, {fname}: one answer_logits call "
                f"launched {calls}")
            want = ({"mixed_node_fwd": NODE_CALLS_PER_FORWARD}
                    if fname == "kernels"
                    else {"mixed_node_fwd": 0, "bn_fwd": 0})
            expect(all(calls[k] == v for k, v in want.items())
                   and (fname == "default" or calls["bn_fwd"] > 0),
                   f"darts group of {n}, {fname}: launches {calls}, "
                   f"expected {want}")
        _features_agree(out["kernels"][3], out["default"][3],
                        f"darts group of {n}, kernels vs default")
        a, b = out["default"][0], out["kernels"][0]
        err = float((a - b).abs().max())
        expect(bool(torch.isfinite(b).all()) and _within(
            [b], [a], DARTS_LOGIT_TOL),
            f"darts group of {n}: answer logits of the two flag sets "
            f"differ by {err}")
        log(f"darts group of {n}: answer logits default vs kernels max "
            f"|diff| {err:.3e} (scale {float(a.abs().max()):.3f})")
        _tokens_agree(models["default"], u8, out["kernels"][1],
                      out["default"][1], f"darts group of {n}")
    del models
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 6 and 7: reference check and throughput
# ---------------------------------------------------------------------------

def check_against_cpu(paths, device):
    from lctvqa_torch.export import ServingModel, read_artifact

    rng = np.random.default_rng(SEED + 3)
    for name, path in paths.items():
        mcfg = model_configs()[name]
        s = mcfg.img_size
        u8 = rng.integers(0, 256, (2, s, s, 3), dtype=np.uint8)
        qst = rng.integers(0, mcfg.qst_vocab_size, (2, mcfg.max_qst_len),
                           dtype=np.int32)
        tol = DARTS_LOGIT_TOL if name in BATCH_STAT_EFS else LOGIT_TOL
        art = read_artifact(path)
        genotype = ARTIFACT_GENOTYPE.get(name)
        ref = ServingModel(art, "cpu", compute_dtype="float32",
                           genotype=genotype)
        want = ref.answer_logits(u8, qst)
        want_gen = ref.generate(u8) if name != "w" else None
        for fname in KERNEL_FLAGS:
            with kernel_flags(fname) as flags:
                model = ServingModel(art, device, compute_dtype="float32",
                                     genotype=genotype, **flags)
                got = model.answer_logits(u8, qst).cpu()
                err = float((got - want).abs().max())
                expect(got.shape == (2, mcfg.ans_vocab_size)
                       and bool(torch.isfinite(got).all())
                       and _within([got], [want], tol),
                       f"{name} {fname}: answer logits vs CPU max err {err}")
                log(f"{name} {fname}: answer logits vs CPU max |err| "
                    f"{err:.3e}")
                if want_gen is not None:
                    tok, ans = (t.cpu() for t in model.generate(u8))
                    expect(tok.shape == (2, mcfg.max_qst_len)
                           and tok.dtype == torch.int32,
                           f"{name} {fname}: generate shape/dtype")
                    if name in BATCH_STAT_EFS:
                        _features_agree(_image_features(model, u8),
                                        _image_features(ref, u8),
                                        f"{name} {fname} vs CPU")
                        _tokens_agree(ref, u8, tok, want_gen[0],
                                      f"{name} {fname} vs CPU")
                    else:
                        expect(torch.equal(tok, want_gen[0])
                               and torch.equal(ans, want_gen[1]),
                               f"{name} {fname}: generate differs from the "
                               "CPU")
            del model
        del ref, art
    torch.cuda.empty_cache()


def throughput(paths, device, batch=64, iters=5,
               flag_sets=tuple(KERNEL_FLAGS)):
    from lctvqa_torch.export import ServingModel, read_artifact

    rows = []
    for name, path in paths.items():
        art = read_artifact(path)
        s, seq = art["meta"]["img_size"], art["meta"]["max_qst_len"]
        rng = np.random.default_rng(SEED + 4)
        u8 = torch.from_numpy(rng.integers(0, 256, (batch, s, s, 3),
                                           dtype=np.uint8))
        qst = torch.zeros(batch, seq, dtype=torch.int32)
        for dtype in (("bfloat16",) if name in BATCH_STAT_EFS
                      else ("bfloat16", "float32")):
            for fname in flag_sets:
                with kernel_flags(fname) as flags:
                    model = ServingModel(art, device, compute_dtype=dtype,
                                         genotype=ARTIFACT_GENOTYPE.get(name),
                                         **flags)
                    fns = {"answer_logits":
                           lambda: model.answer_logits(u8, qst)}
                    if name != "w":
                        fns["generate"] = lambda: model.generate(u8)
                    for fn_name, fn in fns.items():
                        for _ in range(2):
                            fn()
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        for _ in range(iters):
                            fn()
                        torch.cuda.synchronize()
                        dt = time.perf_counter() - t0
                        rows.append((name, fn_name, dtype, fname,
                                     batch * iters / dt, 1e3 * dt / iters))
                del model
        del art
    torch.cuda.empty_cache()
    return rows


def profile_calls(fn, tag: str, iters: int = 5, top: int = 16):
    """A torch.profiler loop over `iters` calls of fn after three
    unprofiled ones: the wall time under the profiler, the device time
    and the device kernels a call, and the `top` kernels by device time,
    logged. -> (wall ms, device ms, kernels) a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / iters

    # device kernels are the rows whose own device type is CUDA; an op
    # row's device time repeats that of the kernels it launched
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    expect(bool(events), f"profile {tag}: the profiler saw no device "
           "kernel")
    total_ms = sum(dev_us(e) for e in events) / 1e3 / iters
    kernels = sum(e.count for e in events) // iters
    log(f"profile {tag}: wall {wall_ms:.3f} ms/call under the profiler, "
        f"device {total_ms:.3f} ms/call, {kernels} device kernels/call")
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        log(f"  {dev_us(e) / 1e3 / iters:8.3f} ms/call  "
            f"{e.count // iters:5d} launches/call  {e.key[:90]}")
    return wall_ms, total_ms, kernels


def profile_darts(path, device, batch=64, iters=5):
    """A torch.profiler loop over the darts EF's answer_logits at batch 64
    in bf16, both flag sets: device time by kernel name and the device's
    busy share of the wall time."""
    from lctvqa_torch.export import ServingModel, read_artifact

    art = read_artifact(path)
    s, seq = art["meta"]["img_size"], art["meta"]["max_qst_len"]
    rng = np.random.default_rng(SEED + 4)
    u8 = torch.from_numpy(rng.integers(0, 256, (batch, s, s, 3),
                                       dtype=np.uint8))
    qst = torch.zeros(batch, seq, dtype=torch.int32)
    for fname in KERNEL_FLAGS:
        with kernel_flags(fname) as flags:
            model = ServingModel(art, device, compute_dtype="bfloat16",
                                 **flags)
            profile_calls(lambda: model.answer_logits(u8, qst),
                          f"darts answer_logits B={batch} bf16 {fname}",
                          iters)
        del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------

def train_config(dtype: str, fname: str, root: str, dropout=None):
    """Full width: every ModelConfig default, batch 64, stage 3 off."""
    import dataclasses

    from lctvqa_torch.config import Config, ModelConfig, TrainConfig

    model = ModelConfig(compute_dtype=dtype, **KERNEL_FLAGS[fname])
    if dropout is not None:
        model = dataclasses.replace(model, dropout_rate=dropout)
    return Config(model=model,
                  train=TrainConfig(batch_size=64, num_epochs=1,
                                    skip_stage3=True, seed=SEED),
                  root_stats_dir=root, exp_name=f"{dtype}_{fname}")


def train_arrays():
    """Synthetic data in RAM at the model's full width: 64-pixel images,
    30-token questions over 8192 words, 1000 answers."""
    from lctvqa_torch.data import synthetic

    mcfg = model_configs()["darts"]
    return synthetic.make_arrays(
        **TRAIN_DATA, img_size=mcfg.img_size,
        n_answers=mcfg.ans_vocab_size, seed=SEED,
        max_qst_len=mcfg.max_qst_len, qst_vocab_size=mcfg.qst_vocab_size)


def _delta(before, after):
    # a kernel's counter exists once its wrapper module is imported
    return {k: after[k] - before.get(k, 0) for k in after}


def _ef_loss_grads(exp, batch, device, rows=None):
    """Stage 1's loss and its gradient per EF leaf on `device`, from the
    Experiment's params (dropout is off in its config), on the batch's
    first `rows` rows (all by default)."""
    from lctvqa_torch.data.pipeline import normalize_images
    from lctvqa_torch.models import vqa_ef
    from lctvqa_torch.optim.optimizers import tree_leaves, tree_map
    from lctvqa_torch.train.steps import with_grad

    move = lambda t: t[:rows].detach().to(device)  # noqa: E731
    params = with_grad(tree_map(lambda t: t.detach().to(device),
                                exp.ef_params))
    arch = tree_map(lambda t: t.detach().to(device), exp.arch)
    img = normalize_images(move(batch["image_u8"]))
    loss = vqa_ef.ef_loss(params, arch, exp.cfg.model, img,
                          move(batch["question"]),
                          move(batch["answer_label"]), deterministic=False,
                          gen=torch.Generator(device=device).manual_seed(0))
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [
        torch.zeros(p.shape) if g is None else g.cpu()
        for p, g in zip(leaves, grads)]


def _grads_agree(got, want, tag):
    top = max(float(w.abs().max()) for w in want)
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        err, scale = _grad_err(a, b)
        limit = TRAIN_GRAD_TOL * scale + TRAIN_GRAD_FLOOR * top
        worst = max(worst, err / limit)
        expect(bool(torch.isfinite(a).all()) and err <= limit,
               f"{tag}: leaf {i} {tuple(a.shape)} differs by {err} "
               f"(scale {scale}, largest leaf {top})")
    log(f"{tag}: {len(want)} gradient leaves, worst error {worst:.3f} of "
        f"its limit ({TRAIN_GRAD_TOL} of the leaf's scale + "
        f"{TRAIN_GRAD_FLOOR} of the largest, {top:.3e})")


@contextlib.contextmanager
def bn_shape_tally():
    """Counts the BatchNorm wrappers' calls by (kernel, shape, dtypes) while
    open, by wrapping cuda_bn's batchnorm_fwd_stat and batchnorm_bwd (a call
    on the card is one launch)."""
    from lctvqa_torch.ops import cuda_bn

    tally = collections.Counter()
    fwd, bwd = cuda_bn.batchnorm_fwd_stat, cuda_bn.batchnorm_bwd

    def name(dtype):
        return str(dtype or torch.float32).replace("torch.", "")

    def fwd_counted(x, out_dtype=None, eps=cuda_bn.EPS):
        tally[("bn_fwd", tuple(x.shape), name(x.dtype), name(out_dtype))] += 1
        return fwd(x, out_dtype, eps)

    def bwd_counted(x, g, stat):
        tally[("bn_bwd", tuple(x.shape), name(x.dtype), name(g.dtype))] += 1
        return bwd(x, g, stat)

    cuda_bn.batchnorm_fwd_stat, cuda_bn.batchnorm_bwd = (fwd_counted,
                                                         bwd_counted)
    try:
        yield tally
    finally:
        cuda_bn.batchnorm_fwd_stat, cuda_bn.batchnorm_bwd = fwd, bwd


def train_run(arrays, device, dtype: str, fname: str, root: str, steps=4):
    """A few stage 1 + stage 2 steps and one eval through Experiment.
    -> (first stage-1 loss, launches of the whole run)."""
    from lctvqa_torch.data import pipeline
    from lctvqa_torch.ops import _build
    from lctvqa_torch.optim.optimizers import tree_leaves
    from lctvqa_torch.train.experiment import Experiment, dev_batch

    mcfg = model_configs()["darts"]
    tag = f"train {dtype} {fname}"
    with kernel_flags(fname):
        run_before = _build.launch_counts()
        exp = Experiment(train_config(dtype, fname, root), device=device,
                         data=pipeline.loader_from_arrays(arrays))
        batches = iter(exp._batches("train"))
        # one stage-1 step alone, for its launch counts
        batch = dev_batch(next(batches))
        before = _build.launch_counts()
        with bn_shape_tally() as tally:
            (exp.ef_params, exp.ef_opt, loss0, _, _) = exp.steps["stage1"](
                exp.ef_params, exp.arch, exp.ef_opt, batch, exp.gen)
            torch.cuda.synchronize()
        calls = _delta(before, _build.launch_counts())
        if fname == "kernels":
            for kind in ("bn_fwd", "bn_bwd"):
                mine = {k[1:]: v for k, v in sorted(tally.items())
                        if k[0] == kind}
                log(f"{tag}: one stage-1 step's {kind} launches by (shape, "
                    f"dtypes): {mine}")
                expect(sum(mine.values()) == calls[kind],
                       f"{tag}: {kind} calls by shape {sum(mine.values())}"
                       f" against {calls[kind]} launches")
        want = (STAGE1_LAUNCHES if fname == "kernels"
                else dict.fromkeys(STAGE1_LAUNCHES, 0))
        log(f"{tag}: one stage-1 step launched "
            f"{ {k: v for k, v in calls.items() if v} }")
        expect(all(calls[k] == v for k, v in want.items())
               and calls["lstm_cell"] + calls["lstm_seq_all"] > 0,
               f"{tag}: stage-1 launches {calls}, expected {want} and the "
               "LSTM kernels")
        losses, times = [float(loss0)], {"stage1": [], "stage2": []}
        for batch in (next(batches) for _ in range(steps)):
            batch = dev_batch(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (exp.ef_params, exp.ef_opt, loss, c1, c2) = exp.steps["stage1"](
                exp.ef_params, exp.arch, exp.ef_opt, batch, exp.gen)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (exp.w_params, exp.w_opt, loss2, wc) = exp.steps["stage2"](
                exp.w_params, exp.w_opt, exp.ef_params, exp.arch, batch,
                exp.gen, exp.sample_gen)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            times["stage1"].append(1e3 * (t1 - t0))
            times["stage2"].append(1e3 * (t2 - t1))
            losses += [float(loss), float(loss2)]
            expect(0 <= int(c2) <= int(c1) <= 64 and 0 <= int(wc) <= 128,
                   f"{tag}: counters out of range")
        # one more pair through the Experiment's own train_step
        out = exp.train_step(next(batches))
        losses += [float(out[0]), float(out[3])]
        ev = exp._eval_step(batch)
        losses.append(float(ev[0]))
        expect(ev[3].shape == (64, mcfg.max_qst_len)
               and ev[3].dtype == torch.int32
               and ev[4].shape == (64, mcfg.ans_vocab_size),
               f"{tag}: eval shapes")
        expect(all(np.isfinite(losses)), f"{tag}: a loss is not finite: "
               f"{losses}")
        expect(losses[-3] < losses[0], f"{tag}: the EF loss did not fall "
               f"over {steps + 2} steps: {losses[0]} -> {losses[-3]}")
        # a checkpoint written and read back equal
        exp.save_model()
        again = Experiment(train_config(dtype, fname, root).replace(
            resume=True), device=device,
            data=pipeline.loader_from_arrays(arrays))
        same = all(torch.equal(a, b) for tree, other in (
            (again.ef_params, exp.ef_params), (again.w_params, exp.w_params),
            (again.arch, exp.arch), (again.ef_opt["m"], exp.ef_opt["m"]),
            (again.w_opt["v"], exp.w_opt["v"]))
            for a, b in zip(tree_leaves(tree), tree_leaves(other)))
        expect(same and again.ef_opt["step"] == exp.ef_opt["step"] == steps + 2
               and again.current_epoch == 1,
               f"{tag}: the checkpoint read back differs")
        launches = _delta(run_before, _build.launch_counts())
    s1, s2 = (statistics.median(times[k][1:]) for k in ("stage1", "stage2"))
    log(f"{tag}: EF loss {losses[0]:.4f} -> {losses[-3]:.4f}, stage 1 "
        f"{s1:.1f} ms/step, stage 2 {s2:.1f} ms/step, "
        f"{64e3 / (s1 + s2):.1f} pairs/s (medians of {steps - 1} steps, host "
        f"clock around synchronized steps); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del exp, again
    torch.cuda.empty_cache()
    return losses[0], launches


def check_train_gradients(arrays, device, root: str):
    """Stage 1's loss and gradients with dropout off: the two flag sets on
    the card against each other and against the CPU."""
    from lctvqa_torch.data import pipeline
    from lctvqa_torch.ops import _build
    from lctvqa_torch.train.experiment import Experiment

    out = {}
    for fname in KERNEL_FLAGS:
        with kernel_flags(fname):
            cfg = train_config("float32", fname, root, dropout=0.0).replace(
                exp_name=f"grads_{fname}")
            exp = Experiment(cfg, device=device,
                             data=pipeline.loader_from_arrays(arrays))
            batch = next(iter(exp._batches("train")))
            before = _build.launch_counts()
            out[fname] = _ef_loss_grads(exp, batch, device)
            calls = _delta(before, _build.launch_counts())
            expect((calls["mixed_node_bwd"] == 14) == (fname == "kernels"),
                   f"train gradients {fname}: node backward launches "
                   f"{calls['mixed_node_bwd']}")
            if fname == "default":
                t0 = time.perf_counter()
                out["cpu"] = _ef_loss_grads(exp, batch, torch.device("cpu"))
                log(f"train gradients: the CPU's stage-1 forward and "
                    f"backward took {time.perf_counter() - t0:.1f} s")
            del exp
    torch.cuda.empty_cache()
    for a, b in (("kernels", "default"), ("default", "cpu"),
                 ("kernels", "cpu")):
        err = abs(out[a][0] - out[b][0])
        expect(err <= TRAIN_LOSS_TOL + TRAIN_LOSS_TOL * abs(out[b][0]),
               f"train gradients: stage-1 loss {a} {out[a][0]} vs {b} "
               f"{out[b][0]}")
        _grads_agree(out[a][1], out[b][1], f"train gradients {a} vs {b}")


def profile_train(arrays, device, root: str):
    """A torch.profiler pass over one train step (stage 1 + stage 2) at
    batch 64 in bf16, both flag sets."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lctvqa_torch.data import pipeline
    from lctvqa_torch.train.experiment import Experiment, dev_batch

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    for fname in KERNEL_FLAGS:
        with kernel_flags(fname):
            cfg = train_config("bfloat16", fname, root).replace(
                exp_name=f"profile_{fname}")
            exp = Experiment(cfg, device=device,
                             data=pipeline.loader_from_arrays(arrays))
            batches = iter(exp._batches("train"))
            for _ in range(3):
                exp.train_step(next(batches))
            batch = next(batches)
            torch.cuda.synchronize()
            for stage in ("stage1", "stage2", "both"):
                t0 = time.perf_counter()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    b = dev_batch(batch)
                    if stage in ("stage1", "both"):
                        (exp.ef_params, exp.ef_opt, *_) = exp.steps["stage1"](
                            exp.ef_params, exp.arch, exp.ef_opt, b, exp.gen)
                    if stage in ("stage2", "both"):
                        (exp.w_params, exp.w_opt, *_) = exp.steps["stage2"](
                            exp.w_params, exp.w_opt, exp.ef_params, exp.arch,
                            b, exp.gen, exp.sample_gen)
                    torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0)
                events = [e for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA
                          and dev_us(e) > 0]
                expect(bool(events), f"profile train {fname}: the profiler "
                       "saw no device kernel")
                total_ms = sum(dev_us(e) for e in events) / 1e3
                log(f"profile train {stage} B=64 bf16 {fname}: wall "
                    f"{wall_ms:.1f} ms under the profiler, device "
                    f"{total_ms:.1f} ms ({100 * total_ms / wall_ms:.1f}% "
                    f"busy), {sum(e.count for e in events)} device kernels")
                if stage == "both":
                    continue
                for e in sorted(events, key=dev_us, reverse=True)[:12]:
                    log(f"  {dev_us(e) / 1e3:8.3f} ms  {e.count:5d} launches"
                        f"  {e.key[:90]}")
            # the same step without the profiler
            times = []
            for _ in range(4):
                b = next(batches)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                exp.train_step(b)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            log(f"profile train B=64 bf16 {fname}: "
                f"{statistics.median(times):.1f} ms/step without the "
                "profiler")
            del exp
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: stage 3
# ---------------------------------------------------------------------------

def stage3_config(dtype: str, fname: str, root: str, dropout=None):
    """train_config with stage 3 on before every batch (exact-indirect,
    remat on: TrainConfig's defaults)."""
    import dataclasses

    cfg = train_config(dtype, fname, root, dropout)
    return cfg.replace(
        train=dataclasses.replace(cfg.train, skip_stage3=False,
                                  arch_update_freq=1),
        exp_name=f"stage3_{dtype}_{fname}")


def record_stages(exp, names, record: list) -> None:
    """Wraps the Experiment's step functions `names`: each call appends
    (name, ms on the host clock between two synchronizes, launches of
    every kernel counter) to `record`."""
    from lctvqa_torch.ops import _build

    for name in names:
        def wrapped(*args, _fn=exp.steps[name], _name=name, **kwargs):
            torch.cuda.synchronize()
            before = _build.launch_counts()
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            record.append((_name, 1e3 * (time.perf_counter() - t0),
                           _delta(before, _build.launch_counts())))
            return out

        exp.steps[name] = wrapped


def stage3_run(arrays, device, fname: str, root: str, steps: int = 2):
    """`steps` train steps (stage 3, stage 1, stage 2 each) in bf16 through
    Experiment.train_step at full width, then a checkpoint read back.
    -> (stage-3 ms per call, launches of the whole run)."""
    from lctvqa_torch.data import pipeline
    from lctvqa_torch.ops import _build
    from lctvqa_torch.optim.optimizers import tree_leaves
    from lctvqa_torch.train.experiment import Experiment

    tag = f"stage3 bfloat16 {fname}"
    with kernel_flags(fname):
        run_before = _build.launch_counts()
        cfg = stage3_config("bfloat16", fname, root)
        exp = Experiment(cfg, device=device,
                         data=pipeline.loader_from_arrays(arrays))
        record = []
        record_stages(exp, ("stage3", "stage1", "stage2"), record)
        batches, valid = iter(exp._batches("train")), exp._cycled_valid()
        arch0 = [a.clone() for a in _leaves(exp.arch)]
        outs = [exp.train_step(next(batches), next(valid))
                for _ in range(steps)]
        s3 = [float(o[5]) for o in outs]
        losses = [float(o[i]) for o in outs for i in (0, 3)]
        expect(all(np.isfinite(s3 + losses)), f"{tag}: a loss is not "
               f"finite: W'-val {s3}, EF and W {losses}")
        moved = all(bool(torch.isfinite(b).all()) and not torch.equal(a, b)
                    for a, b in zip(arch0, _leaves(exp.arch)))
        expect(moved and exp.arch_opt["step"] == steps,
               f"{tag}: arch not moved by every stage-3 step, or not finite")
        want1 = (STAGE1_LAUNCHES if fname == "kernels"
                 else dict.fromkeys(STAGE1_LAUNCHES, 0))
        for name, ms, calls in record:
            if name == "stage3":
                launched = {k: v for k, v in calls.items() if v}
                expect(not launched, f"{tag}: a stage-3 call launched "
                       f"kernels: {launched}")
            if name == "stage1":
                expect(all(calls[k] == v for k, v in want1.items()),
                       f"{tag}: stage-1 launches {calls}, expected {want1}")
        s3_ms = [ms for name, ms, _ in record if name == "stage3"]
        log(f"{tag}: W'-val losses {s3}, EF and W losses {losses}; "
            "launches by stage call: "
            + "; ".join(f"{n} {ms:.0f} ms "
                        f"{ {k: v for k, v in c.items() if v} }"
                        for n, ms, c in record))
        # a checkpoint written after stage 3, read back equal
        exp.save_model()
        again = Experiment(cfg.replace(resume=True), device=device,
                           data=pipeline.loader_from_arrays(arrays))
        same = all(torch.equal(a, b) for tree, other in (
            (again.arch, exp.arch), (again.arch_opt["m"], exp.arch_opt["m"]),
            (again.arch_opt["v"], exp.arch_opt["v"]),
            (again.ef_params, exp.ef_params), (again.w_params, exp.w_params),
            (again.ef_opt["v"], exp.ef_opt["v"]))
            for a, b in zip(tree_leaves(tree), tree_leaves(other)))
        expect(same and again.arch_opt["step"] == exp.arch_opt["step"]
               and again.arch_opt["lr"] == exp.arch_opt["lr"],
               f"{tag}: the checkpoint read back differs")
        launches = _delta(run_before, _build.launch_counts())
    del exp, again
    torch.cuda.empty_cache()
    return s3_ms, launches


def _stage3_batches(exp, rows=None):
    """A train and a validation batch as the architect takes them:
    normalized images on the Experiment's device, `rows` of each."""
    from lctvqa_torch.data.pipeline import normalize_images
    from lctvqa_torch.train.experiment import dev_batch

    out = []
    for batch in (dev_batch(next(iter(exp._batches("train")))),
                  exp._to_device(next(exp._cycled_valid()))):
        out.append({"image": normalize_images(batch["image_u8"][:rows]),
                    "question": batch["question"][:rows],
                    "answer_label": batch["answer_label"][:rows]})
    return out


def stage3_modes(arrays, device, root: str, card: str):
    """One arch gradient per architect mode at full width, bf16, batch 64
    (two calls each, timed on the host clock between synchronizes): finite
    and nonzero, no kernel launched; the peak device memory of an
    exact-indirect call with remat and without."""
    import dataclasses

    from lctvqa_torch.data import pipeline
    from lctvqa_torch.ops import _build
    from lctvqa_torch.optim.architect_lct import make_lct_arch_grad
    from lctvqa_torch.train.experiment import Experiment

    cfg = stage3_config("bfloat16", "default", root).replace(
        exp_name="stage3_modes")
    exp = Experiment(cfg, device=device,
                     data=pipeline.loader_from_arrays(arrays))
    tb, vb = _stage3_batches(exp)
    lr = exp._epoch_lr()
    for mode, remat in (("exact-indirect", True), ("exact-indirect", False),
                        ("exact", True), ("fd", True)):
        fn = make_lct_arch_grad(exp.cfg.model, dataclasses.replace(
            exp.cfg.train, stage3_remat=remat), mode)
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            before = _build.launch_counts()
            t0 = time.perf_counter()
            g, val_loss = fn(exp.arch, exp.ef_params, exp.w_params, tb, vb,
                             lr, lr, exp.gen)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            calls = _delta(before, _build.launch_counts())
        peak = torch.cuda.max_memory_allocated()
        flat = torch.cat([v.flatten().float() for v in _leaves(g)])
        tag = f"stage3 {mode} remat {remat} bfloat16 B=64"
        expect(bool(torch.isfinite(flat).all()) and float(flat.abs().max()) > 0
               and bool(torch.isfinite(val_loss)),
               f"{tag}: arch gradient not finite and nonzero")
        expect(not any(calls.values()), f"{tag}: launched kernels {calls}")
        log(f"{tag}: {times[0]:.0f} ms, then {times[1]:.0f} ms a call (host "
            f"clock between synchronizes); peak device memory "
            f"{peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB above "
            f"the {base / 2**30:.2f} GiB held before the call; W'-val loss "
            f"{float(val_loss):.4f}, largest |grad| "
            f"{float(flat.abs().max()):.3e} on {card}")
    del exp
    torch.cuda.empty_cache()


@contextlib.contextmanager
def identity_dropout():
    """Dropout as the identity while open: W's VGG has a hard-coded rate
    of 0.5, whose masks the card's and the CPU's generators draw from
    different streams."""
    from lctvqa_torch.ops import nn as N

    was = N.dropout
    N.dropout = lambda x, *args, **kwargs: x
    try:
        yield
    finally:
        N.dropout = was


def check_stage3_against_cpu(arrays, device, root: str):
    """The exact-indirect arch gradient and W'-val loss on the card against
    the CPU: fp32, dropout off, full widths at batch STAGE3_CPU_BATCH."""
    from lctvqa_torch.data import pipeline
    from lctvqa_torch.optim.architect_lct import make_lct_arch_grad
    from lctvqa_torch.optim.optimizers import tree_map
    from lctvqa_torch.train.experiment import Experiment

    cfg = stage3_config("float32", "default", root, dropout=0.0).replace(
        exp_name="stage3_cpu")
    exp = Experiment(cfg, device=device,
                     data=pipeline.loader_from_arrays(arrays))
    batches = _stage3_batches(exp, rows=STAGE3_CPU_BATCH)
    fn = make_lct_arch_grad(exp.cfg.model, exp.cfg.train, "exact-indirect")
    out = []
    with identity_dropout():
        for dev in (device, torch.device("cpu")):
            move = lambda t: t.detach().to(dev)  # noqa: E731
            t0 = time.perf_counter()
            g, val_loss = fn(*(tree_map(move, t) for t in (
                exp.arch, exp.ef_params, exp.w_params, *batches)),
                exp._epoch_lr(), exp._epoch_lr(),
                torch.Generator(device=dev).manual_seed(SEED))
            out.append(([v.cpu() for v in _leaves(g)], float(val_loss)))
            log(f"stage3 against the CPU: exact-indirect fp32 B="
                f"{STAGE3_CPU_BATCH} on {dev.type} took "
                f"{time.perf_counter() - t0:.1f} s (the batch is cut from 64 "
                "only to keep the CPU's side short)")
    del exp
    torch.cuda.empty_cache()
    (g_card, v_card), (g_cpu, v_cpu) = out
    err = abs(v_card - v_cpu)
    expect(err <= STAGE3_LOSS_TOL * (1 + abs(v_cpu)),
           f"stage3 against the CPU: W'-val loss {v_card} vs {v_cpu}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(g_card, g_cpu)):
        err, scale = _grad_err(a, b)
        worst = max(worst, err / max(STAGE3_GRAD_TOL * scale, 1e-30))
        expect(bool(torch.isfinite(a).all()) and scale > 0
               and err <= STAGE3_GRAD_TOL * scale,
               f"stage3 against the CPU: arch leaf {i} {tuple(a.shape)} "
               f"differs by {err} (scale {scale})")
    log(f"stage3 against the CPU: W'-val loss {v_card:.6f} vs {v_cpu:.6f}; "
        f"{len(g_cpu)} arch leaves, worst error {worst:.3f} of its limit "
        f"({STAGE3_GRAD_TOL} of the leaf's scale)")


def stage3_phase(arrays, device, root: str, card: str) -> None:
    """Phase 9: stage3_run at both flag sets (the counts zeroed before
    each), stage3_modes, check_stage3_against_cpu."""
    from lctvqa_torch.ops import _build

    t0 = time.perf_counter()
    for fname in KERNEL_FLAGS:
        _build.reset_launch_counts()
        s3_ms, launches = stage3_run(arrays, device, fname, root)
        log(f"launches in the bfloat16 {fname} stage-3 run: "
            f"{ {k: v for k, v in launches.items() if v} }")
        for name, (_, _, run, path) in KERNELS.items():
            if path == "train" and run == fname:
                expect(launches[name] > 0, f"{name} never launched in the "
                       f"{fname} stage-3 run's stages 1 and 2")
        log(f"stage3 exact-indirect bfloat16 B=64 {fname}: "
            + ", ".join(f"{ms:.0f}" for ms in s3_ms)
            + f" ms a call in Experiment.train_step on {card}")
    stage3_modes(arrays, device, root, card)
    check_stage3_against_cpu(arrays, device, root)
    log(f"stage-3 phase took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 10: the derived network
# ---------------------------------------------------------------------------

def derived_config(dtype: str, fname: str, root: str, records: str,
                   dropout=None):
    """train_config with the derived EF of DERIVED_GENOTYPE; validation's
    BLEU4 reads `records`' valid.npy."""
    import dataclasses

    cfg = train_config(dtype, fname, root, dropout)
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, arch_type="derived",
            genotype=model_configs()["derived"].genotype),
        data=dataclasses.replace(cfg.data, input_dir=records),
        exp_name=f"derived_{dtype}_{fname}")


def derived_run(arrays, records, device, fname: str, root: str,
                steps: int = 4, resume: bool = False):
    """A stage-1 + stage-2 train step under the BatchNorm tally, `steps`
    more timed by stage, then validation (its BLEU4 read from the log),
    in bf16 at full width through Experiment; with `resume` a checkpoint
    written and read back. -> (exp_name, launches of the whole run)."""
    from lctvqa_torch.data import pipeline
    from lctvqa_torch.ops import _build
    from lctvqa_torch.optim.optimizers import tree_leaves
    from lctvqa_torch.train.experiment import Experiment

    tag = f"derived bfloat16 {fname}"
    with kernel_flags(fname):
        run_before = _build.launch_counts()
        cfg = derived_config("bfloat16", fname, root, records)
        exp = Experiment(cfg, device=device,
                         data=pipeline.loader_from_arrays(arrays))
        expect(exp.arch is None and exp.arch_opt is None,
               f"{tag}: a derived EF has no arch")
        record = []
        record_stages(exp, ("stage3", "stage1", "stage2"), record)
        batches = iter(exp._batches("train"))
        with bn_shape_tally() as tally:
            out = exp.train_step(next(batches))
            torch.cuda.synchronize()
        first = _delta(run_before, _build.launch_counts())
        losses = [float(out[0]), float(out[3])]
        for _ in range(steps):
            out = exp.train_step(next(batches))
            losses += [float(out[0]), float(out[3])]
        expect(all(np.isfinite(losses)), f"{tag}: a loss is not finite: "
               f"{losses}")
        expect(not any(name == "stage3" for name, _, _ in record),
               f"{tag}: stage 3 ran for a net without an arch")
        for kind in ("bn_fwd", "bn_bwd"):
            mine = {k[1:]: v for k, v in sorted(tally.items())
                    if k[0] == kind}
            log(f"{tag}: one train step's {kind} launches by (shape, "
                f"dtypes): {mine}")
            expect(sum(mine.values()) == first[kind],
                   f"{tag}: {kind} calls by shape {sum(mine.values())} "
                   f"against {first[kind]} launches")
            at = sum(v for k, v in mine.items() if k[0] == (64, 32, 32, 32))
            expect((at > 0) == (fname == "kernels"),
                   f"{tag}: {kind} launched {at} times at [64,32,32,32]")
        exp.val()
        log_text = (Path(exp.exp_dir) / "log.txt").read_text()
        bleu = [float(line.split("BLEU4: ")[1].split()[0])
                for line in log_text.splitlines() if "BLEU4: " in line]
        expect(len(bleu) == 1 and 0.0 <= bleu[0] <= 100.0,
               f"{tag}: validation's BLEU4 {bleu}")
        if resume:
            exp.save_model()
            again = Experiment(cfg.replace(resume=True), device=device,
                               data=pipeline.loader_from_arrays(arrays))
            same = all(torch.equal(a, b) for tree, other in (
                (again.ef_params, exp.ef_params),
                (again.ef_opt["m"], exp.ef_opt["m"]),
                (again.w_params, exp.w_params))
                for a, b in zip(tree_leaves(tree), tree_leaves(other)))
            expect(same and again.arch is None
                   and again.cfg.model.genotype == cfg.model.genotype
                   and again.ef_opt["step"] == exp.ef_opt["step"],
                   f"{tag}: the checkpoint read back differs")
            del again
        launches = _delta(run_before, _build.launch_counts())
    timed = {n: [ms for name, ms, _ in record[2:] if name == n]
             for n in ("stage1", "stage2")}
    s1, s2 = (statistics.median(timed[n]) for n in ("stage1", "stage2"))
    per_step = {n: {k: v for k, v in c.items() if v}
                for n, _, c in record[:2]}
    log(f"{tag}: EF losses {losses[0::2]}, W losses {losses[1::2]}, "
        f"validation BLEU4 {bleu}")
    log(f"{tag}: launches per step by stage {per_step}; stage 1 "
        f"{s1:.1f} ms/step, stage 2 {s2:.1f} ms/step, "
        f"{64e3 / (s1 + s2):.1f} pairs/s (medians of {steps} steps, host "
        f"clock between synchronizes)")
    name = exp.exp_dir
    del exp
    torch.cuda.empty_cache()
    return os.path.basename(name), launches


def _limit_ratios(got, want):
    """Each leaf's error as a share of phase 8's limit, largest first:
    [(share, leaf, shape, error, scale)]."""
    top = max(float(w.abs().max()) for w in want)
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        err, scale = _grad_err(a, b)
        limit = TRAIN_GRAD_TOL * scale + TRAIN_GRAD_FLOOR * top
        out.append((err / limit, i, tuple(a.shape), err, scale))
    return sorted(out, reverse=True)


def derived_gradient_spread(device, batches=(8, 64)):
    """How far stage 1's fp32 gradients of the derived EF (dropout off,
    default flags) move when the input moves by one rounding (the image
    normalization's mean one fp32 ulp up), on the card and on the CPU,
    beside the card against the CPU, at each batch: each as the largest
    share of phase 8's limit over the leaves (--grad-spread)."""
    from lctvqa_torch.data import pipeline, synthetic
    from lctvqa_torch.train.experiment import Experiment

    fn = pipeline.normalize_images
    with tempfile.TemporaryDirectory(dir=Path.cwd()) as root:
        records = str(Path(root) / "records")
        synthetic.make_npy_records(records, **TRAIN_DATA, n_answers=1000,
                                   seed=SEED)
        cfg = derived_config("float32", "default", root, records,
                             dropout=0.0)
        exp = Experiment(cfg, device=device,
                         data=pipeline.loader_from_arrays(train_arrays()))
        batch = next(iter(exp._batches("train")))
        res = {}
        for b in batches:
            for name, d in (("card", device), ("cpu", torch.device("cpu"))):
                res[(name, b)] = _ef_loss_grads(exp, batch, d, rows=b)
                was = fn.__defaults__
                fn.__defaults__ = (tuple(float(torch.nextafter(
                    torch.tensor(m), torch.tensor(1.0))) for m in was[0]),
                    *was[1:])
                try:
                    res[(name + " one ulp", b)] = _ef_loss_grads(
                        exp, batch, d, rows=b)
                finally:
                    fn.__defaults__ = was
        del exp
    for b in batches:
        for x, y in (("card", "cpu"), ("cpu one ulp", "cpu"),
                     ("card one ulp", "card")):
            (lx, gx), (ly, gy) = res[(x, b)], res[(y, b)]
            r = _limit_ratios(gx, gy)
            log(f"gradient spread B={b} {x} vs {y}: loss {lx:.7f} vs "
                f"{ly:.7f}; worst {r[0][0]:.3f} of phase 8's limit, "
                f"{sum(q[0] > 1 for q in r)} of {len(r)} leaves over it; "
                + "; ".join(f"leaf {i} {sh} err {e:.2e} scale {sc:.2e}"
                            for _, i, sh, e, sc in r[:3]))


def check_derived_gradients(arrays, records, device, root: str):
    """Stage 1's loss and gradients of the derived EF, dropout off, fp32,
    batch DERIVED_CPU_BATCH: the two flag sets on the card against each
    other and against the CPU, at phase 8's tolerances."""
    from lctvqa_torch.data import pipeline
    from lctvqa_torch.train.experiment import Experiment

    out = {}
    for fname in KERNEL_FLAGS:
        with kernel_flags(fname):
            cfg = derived_config("float32", fname, root, records,
                                 dropout=0.0).replace(
                exp_name=f"derived_grads_{fname}")
            exp = Experiment(cfg, device=device,
                             data=pipeline.loader_from_arrays(arrays))
            batch = next(iter(exp._batches("train")))
            out[fname] = _ef_loss_grads(exp, batch, device,
                                        rows=DERIVED_CPU_BATCH)
            if fname == "default":
                out["cpu"] = _ef_loss_grads(exp, batch, torch.device("cpu"),
                                            rows=DERIVED_CPU_BATCH)
            del exp
    torch.cuda.empty_cache()
    for a, b in (("kernels", "default"), ("default", "cpu"),
                 ("kernels", "cpu")):
        err = abs(out[a][0] - out[b][0])
        expect(err <= TRAIN_LOSS_TOL + TRAIN_LOSS_TOL * abs(out[b][0]),
               f"derived gradients: stage-1 loss {a} {out[a][0]} vs {b} "
               f"{out[b][0]}")
        _grads_agree(out[a][1], out[b][1],
                     f"derived gradients B={DERIVED_CPU_BATCH} {a} vs {b}")


def check_derived_serving(path, device, card: str):
    """The derived-EF artifact over HTTP at both flag sets (launch counts
    zeroed before each), through ServingModel at a batch of 64 (answer
    logits, image features and greedy tokens of the two flag sets held as
    phase 5 holds the darts EF's), against the CPU (phase 6), and
    answer_logits / generate timed at B=64 bf16."""
    from lctvqa_torch.export import ServingModel, read_artifact
    from lctvqa_torch.ops import _build

    for fname in KERNEL_FLAGS:
        _build.reset_launch_counts()
        with kernel_flags(fname) as flags:
            serve_run({"derived": path}, device, flags, n_answer=8,
                      n_generate=8)
        calls = _build.launch_counts()
        log(f"derived serving {fname}: launches "
            f"{ {k: v for k, v in calls.items() if v} }")
        on = fname == "kernels"
        expect(calls["mixed_node_fwd"] == calls["mixed_node_bwd"] == 0
               and (calls["bn_fwd"] > 0) == on
               and (calls["greedy_generate"] > 0) == on
               and (calls["lstm_seq_all"] > 0) == on,
               f"derived serving {fname}: launches {calls}")
    art = read_artifact(path)
    mcfg = model_configs()["derived"]
    rng = np.random.default_rng(SEED + 6)
    s = mcfg.img_size
    u8 = rng.integers(0, 256, (64, s, s, 3), dtype=np.uint8)
    qst = rng.integers(0, mcfg.qst_vocab_size, (64, mcfg.max_qst_len),
                       dtype=np.int32)
    out, models = {}, {}
    for fname in KERNEL_FLAGS:
        with kernel_flags(fname) as flags:
            model = models[fname] = ServingModel(
                art, device, compute_dtype="float32",
                genotype=DERIVED_GENOTYPE, **flags)
            out[fname] = (model.answer_logits(u8, qst), model.generate(u8)[0],
                          _image_features(model, u8))
    _features_agree(out["kernels"][2], out["default"][2],
                    "derived B=64, kernels vs default")
    a, b = out["default"][0], out["kernels"][0]
    err = float((a - b).abs().max())
    expect(bool(torch.isfinite(b).all()) and _within([b], [a],
                                                     DARTS_LOGIT_TOL),
           f"derived B=64: answer logits of the two flag sets differ by "
           f"{err}")
    log(f"derived B=64: answer logits default vs kernels max |diff| "
        f"{err:.3e}")
    _tokens_agree(models["default"], u8, out["kernels"][1],
                  out["default"][1], "derived B=64")
    del models, out
    check_against_cpu({"derived": path}, device)
    for name, fn_name, dtype, fname, rate, ms in throughput(
            {"derived": path}, device):
        log(f"derived {fn_name} B=64 {dtype} {fname}: {ms:.2f} ms a call "
            f"({rate:.1f} pairs/s) on {card}")


def derived_phase(arrays, device, root: str, card: str) -> dict:
    """Phase 10: npy records for validation's and eval's BLEU4, derived_run
    at both flag sets (the counts zeroed before each), the gradients
    against the CPU, eval on the trained experiment, the artifact served.
    -> the kernel-flag run's launches."""
    from lctvqa_torch import eval as t_eval
    from lctvqa_torch.data import pipeline, synthetic
    from lctvqa_torch.ops import _build

    t0 = time.perf_counter()
    mcfg = model_configs()["derived"]
    records = str(Path(root) / "derived_records")
    synthetic.make_npy_records(records, **TRAIN_DATA,
                               n_answers=mcfg.ans_vocab_size, seed=SEED)
    launches = {}
    for fname in KERNEL_FLAGS:
        _build.reset_launch_counts()
        exp_name, launches[fname] = derived_run(
            arrays, records, device, fname, root,
            resume=fname == "kernels")
        log(f"launches in the bfloat16 {fname} derived run: "
            f"{ {k: v for k, v in launches[fname].items() if v} }")
    kern = launches["kernels"]
    expect(kern["mixed_node_fwd"] == kern["mixed_node_bwd"] == 0
           and all(kern[k] > 0 for k in ("bn_fwd", "bn_bwd", "lstm_seq_all",
                                         "lstm_seq_final", "greedy_generate",
                                         "lstm_cell")),
           f"derived kernels run: launches {kern}")
    expect(all(v == 0 for k, v in launches["default"].items()
               if k != "lstm_cell") and launches["default"]["lstm_cell"] > 0,
           f"derived default run: launches {launches['default']}")
    check_derived_gradients(arrays, records, device, root)
    # eval on the kernel-flag run's checkpoint (its flags are the
    # checkpoint's config), the card's loader in place of the h5 files
    with kernel_flags("kernels"):
        t1 = time.perf_counter()
        res = t_eval.main(["--exp", exp_name, "--root_stats_dir", root,
                           "--input_dir", records, "--batch_size", "64",
                           "--num_batches", "4", "--device", device.type],
                          data=pipeline.loader_from_arrays(arrays))
    expect(res["n"] == 256 and 0.0 <= res["acc"] <= 1.0
           and 0.0 <= res["bleu4"] <= 100.0, f"derived eval: {res}")
    log(f"derived eval: {res} in {time.perf_counter() - t1:.1f} s")
    paths = write_artifacts(Path(root), names=("derived",))
    check_derived_serving(paths["derived"], device, card)
    log(f"derived phase took {time.perf_counter() - t0:.1f} s")
    return kern


# ---------------------------------------------------------------------------
# phase 11: the darts and unified families
# ---------------------------------------------------------------------------

def pad_vocab(path: Path, size: int, prefix: str) -> None:
    """Pad a vocabulary file to `size` words with filler words after the
    real ones, as make_arrays pads its question vocabulary."""
    words = path.read_text().splitlines()
    expect(len(words) <= size, f"{path.name}: {len(words)} words, more than "
           f"the model's {size}")
    words += [f"{prefix}{i}" for i in range(size - len(words))]
    path.write_text("".join(w + "\n" for w in words))


def darts_records(root: str, arrays):
    """npy records at TRAIN_DATA's sizes with their vocabularies, padded to
    full width (8192 question words, 1000 answers, UNIFIED_VOCAB unified
    words), and make_arrays' images for the same seed as the npy loader's
    in-RAM table, every record's image in it. -> (directory, images)."""
    from lctvqa_torch.data import pipeline_npy, synthetic, vocab

    mcfg = model_configs()["darts"]
    d = Path(root) / "darts_records"
    synthetic.make_npy_records(str(d), **TRAIN_DATA,
                               n_answers=mcfg.ans_vocab_size, seed=SEED)
    vocab.make_vocab_questions(str(d / "Questions"),
                               str(d / "vocab_questions.txt"))
    vocab.make_vocab_answers(str(d / "Annotations"),
                             str(d / "vocab_answers.txt"),
                             n_answers=mcfg.ans_vocab_size)
    for name, size, prefix in (
            ("vocab_questions.txt", mcfg.qst_vocab_size, "w"),
            ("vocab_answers.txt", mcfg.ans_vocab_size, "a"),
            ("vocab_unified.txt", UNIFIED_VOCAB, "u")):
        pad_vocab(d / name, size, prefix)
    images = {s: arrays[s] for s in ("train", "val")}
    ids = {s: {int(c) for c in arrays[s]["coco_ids"]} for s in images}
    for f in ("train.npy", "valid.npy"):
        for rec in np.load(d / f, allow_pickle=True):
            split, coco_id = pipeline_npy.image_table_key(rec["image_name"])
            expect(coco_id in ids[split], f"{f}: the image of "
                   f"{rec['image_name']} is not in make_arrays' table")
    return str(d), images


def darts_config(dtype: str, fname: str, root: str, records: str,
                 family: str, dropout=None, **train_kw):
    """train_config on the npy records: half the training questions (4
    batches of 64), an arch step every DARTS_ARCH_FREQ batches (the
    default mode, exact-indirect, which this family runs as the finite
    difference)."""
    import dataclasses

    cfg = train_config(dtype, fname, root, dropout)
    return cfg.replace(
        train=dataclasses.replace(cfg.train, train_portion=0.5,
                                  arch_update_freq=DARTS_ARCH_FREQ,
                                  **train_kw),
        data=dataclasses.replace(cfg.data, input_dir=records),
        exp_name=f"{family}_{dtype}_{fname}")


def darts_experiment(family: str, cfg, device, records: str, images,
                     **kwargs):
    """DartsExperiment or DartsExperimentUnified on the npy loader's
    in-RAM route."""
    from lctvqa_torch.data import pipeline_npy
    from lctvqa_torch.train.experiment_darts import (DartsExperiment,
                                                     DartsExperimentUnified)

    cls = DartsExperimentUnified if family == "unified" else DartsExperiment
    data = pipeline_npy.get_npy_loader(
        records, max_qst_length=cfg.model.max_qst_len,
        img_size=cfg.model.img_size, unified=family == "unified",
        train_portion=cfg.train.train_portion, images=images)
    return cls(cfg, device=device, data=data, **kwargs)


def _launched(calls) -> dict:
    return {k: v for k, v in calls.items() if v}


def darts_run(records, images, device, family: str, fname: str, root: str):
    """One epoch of `family` in bf16 at full width through its experiment
    (4 train steps, arch steps at batches 0 and 2, validation over 8
    batches, the checkpoints), each step call timed and its launches
    counted; the checkpoints read back by a resumed experiment. With
    the kernel flags, a qst_only train step of the darts family.
    -> (ms per train and arch step, exp name, launches of the run)."""
    from lctvqa_torch.ops import _build
    from lctvqa_torch.optim.optimizers import tree_leaves
    from lctvqa_torch.train.experiment_darts import make_darts_steps

    tag = f"{family} bfloat16 {fname}"
    want_train = dict(STAGE1_LAUNCHES, lstm_seq_all=1)
    with kernel_flags(fname):
        run_before = _build.launch_counts()
        cfg = darts_config("bfloat16", fname, root, records, family)
        exp = darts_experiment(family, cfg, device, records, images)
        record = []
        record_stages(exp, ("arch", "train", "eval"), record)
        arch0 = [a.clone() for a in tree_leaves(exp.arch)]
        t0 = time.perf_counter()
        exp.run()
        wall = time.perf_counter() - t0
        losses = exp.train_loss + exp.val_loss
        expect(all(np.isfinite(losses)), f"{tag}: a loss is not finite: "
               f"{losses}")
        moved = all(bool(torch.isfinite(b).all()) and not torch.equal(a, b)
                    for a, b in zip(arch0, tree_leaves(exp.arch)))
        expect(moved and exp.arch_opt["step"] == 2 and exp.opt["step"] == 4,
               f"{tag}: arch steps {exp.arch_opt['step']}, train steps "
               f"{exp.opt['step']}, every arch leaf moved: {moved}")
        on = fname == "kernels"
        for name, ms, calls in record:
            calls, got = collections.Counter(calls), _launched(calls)
            if name == "arch":
                expect(not got, f"{tag}: an arch step launched {got}")
            elif name == "train":
                expect(got == want_train if on else not any(
                    calls[k] for k in STAGE1_LAUNCHES),
                    f"{tag}: a train step launched {got}")
            else:
                expect(calls["greedy_generate"] == (1 if on else 0),
                       f"{tag}: a validation batch launched {got}")
        expect(0.0 <= exp.val_acc[-1] <= 1.0
               and 0.0 <= exp.val_b4[-1] <= 100.0,
               f"{tag}: validation accuracy {exp.val_acc}, BLEU4 "
               f"{exp.val_b4}")
        if family == "darts" and on:
            # question-only: the answer head gets no gradient and, from a
            # fresh Adam state, keeps its bits
            steps = make_darts_steps(exp.cfg, exp.ans_vocab.unk2idx,
                                     qst_only=True)
            batch = exp._to_device(next(exp.data["train"].batches(
                cfg.train.batch_size, np.random.default_rng(SEED))))
            new, _, loss = steps["train"](exp.params,
                                          steps["tx"].init(exp.params),
                                          exp.arch, batch, exp.gen)
            head = [(a, b) for k in ("fc1", "fc2") for a, b in zip(
                tree_leaves(new[k]), tree_leaves(exp.params[k]))]
            expect(np.isfinite(float(loss))
                   and all(torch.equal(a, b) for a, b in head)
                   and not torch.equal(new["img_fc"]["w"],
                                       exp.params["img_fc"]["w"]),
                   f"{tag}: a qst_only step moved the answer head, or "
                   "nothing else")
        again = darts_experiment(family, cfg.replace(resume=True), device,
                                 records, images)
        same = all(torch.equal(a, b) for tree, other in (
            (again.params, exp.params), (again.arch, exp.arch),
            (again.opt["m"], exp.opt["m"]), (again.opt["v"], exp.opt["v"]),
            (again.arch_opt["m"], exp.arch_opt["m"]),
            (again.arch_opt["v"], exp.arch_opt["v"]))
            for a, b in zip(tree_leaves(tree), tree_leaves(other)))
        expect(same and again.current_epoch == 1
               and again.opt["step"] == exp.opt["step"]
               and again.arch_opt["step"] == exp.arch_opt["step"]
               and again.val_b4 == exp.val_b4
               and again.cfg.model == exp.cfg.model,
               f"{tag}: the checkpoints read back differ")
        launches = collections.Counter(_delta(run_before,
                                              _build.launch_counts()))
    ms = {n: [m for name, m, _ in record if name == n]
          for n in ("train", "arch", "eval")}
    train_ms = statistics.median(ms["train"][1:])
    log(f"{tag}: train losses {exp.train_loss}, validation loss "
        f"{exp.val_loss}, accuracy {exp.val_acc}, BLEU4 {exp.val_b4}; "
        "launches a train step "
        f"{_launched(next(c for n, _, c in record if n == 'train'))}")
    log(f"{tag}: train step {train_ms:.1f} ms (median of "
        f"{len(ms['train']) - 1} after the first; "
        + ", ".join(f"{m:.1f}" for m in ms["train"]) + "), "
        f"{64e3 / train_ms:.1f} trained pairs/s; arch step "
        + ", ".join(f"{m:.0f}" for m in ms["arch"]) + " ms; validation "
        f"batch {statistics.median(ms['eval']):.1f} ms (median); the epoch "
        f"{wall:.1f} s (host clock between synchronizes)")
    name = os.path.basename(exp.exp_dir)
    del exp, again
    torch.cuda.empty_cache()
    return {"train_ms": train_ms, "arch_ms": ms["arch"]}, name, launches


def darts_first_losses(records, images, device, root: str):
    """The first train step's loss of each family in fp32 at the two flag
    sets (the same batch and dropout draws): within TRAIN_LOSS_TOL, as in
    phase 8."""
    for family in ("darts", "unified"):
        first = {}
        for fname in KERNEL_FLAGS:
            with kernel_flags(fname):
                cfg = darts_config("float32", fname, root, records, family)
                exp = darts_experiment(family, cfg.replace(
                    exp_name=f"first_{family}_{fname}"), device, records,
                    images)
                batch = next(iter(exp._batches("train")))
                out = exp.steps["train"](exp.params, exp.opt, exp.arch,
                                         exp._to_device(batch), exp.gen)
                first[fname] = float(out[2])
                del exp
        a, b = first["default"], first["kernels"]
        expect(abs(a - b) <= TRAIN_LOSS_TOL * (1 + abs(a)),
               f"{family} fp32: first train loss default {a} vs kernels {b}")
        log(f"{family} fp32: first train loss default {a:.6f}, kernels "
            f"{b:.6f}")
    torch.cuda.empty_cache()


def darts_arch_modes(records, images, device, root: str, card: str):
    """One arch step per mode (fd, the default's, and exact) in bf16 at
    B=64, two calls each: the gradient finite and nonzero, no launch; ms
    per call and peak device memory (informational). Then the exact arch
    gradient in fp32, dropout off, at STAGE3_CPU_BATCH rows on the card
    against the CPU: validation loss within STAGE3_LOSS_TOL (1 + |loss|),
    each arch leaf within STAGE3_GRAD_TOL of its scale."""
    from lctvqa_torch.data.pipeline import normalize_images
    from lctvqa_torch.models import vqa_ef
    from lctvqa_torch.ops import _build
    from lctvqa_torch.optim.architect import make_darts_arch_grad
    from lctvqa_torch.optim.architect_lct import plain_model_config
    from lctvqa_torch.optim.optimizers import tree_map

    out = {}
    cfg = darts_config("bfloat16", "default", root, records, "darts")
    exp = darts_experiment("darts", cfg.replace(exp_name="darts_modes"),
                           device, records, images)
    tb, vb = (exp._to_device(next(exp.data[split].batches(
        cfg.train.batch_size, np.random.default_rng(SEED))))
        for split in ("train", "valid"))
    batches = [{"image": normalize_images(b["image_u8"]),
                "question": b["question"],
                "answer_label": b["answer_label"]} for b in (tb, vb)]
    mcfg = plain_model_config(exp.cfg.model)
    lr = exp._epoch_lr()

    def loss_fn(p, a, batch, gen):
        return vqa_ef.ef_loss(p, a, mcfg, batch["image"], batch["question"],
                              batch["answer_label"], gen=gen,
                              deterministic=False)

    for mode in ("fd", "exact"):
        fn = make_darts_arch_grad(loss_fn, mode)
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            before = _build.launch_counts()
            t0 = time.perf_counter()
            g, val_loss = fn(exp.params, exp.arch, *batches, lr, exp.gen)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            calls = _launched(_delta(before, _build.launch_counts()))
        peak = torch.cuda.max_memory_allocated()
        flat = torch.cat([v.flatten().float() for v in _leaves(g)])
        tag = f"darts arch {mode} bfloat16 B=64"
        expect(bool(torch.isfinite(flat).all()) and float(flat.abs().max())
               > 0 and bool(torch.isfinite(val_loss)),
               f"{tag}: arch gradient not finite and nonzero")
        expect(not calls, f"{tag}: launched kernels {calls}")
        out[mode] = times
        log(f"{tag}: {times[0]:.0f} ms, then {times[1]:.0f} ms a call (host "
            f"clock between synchronizes); peak device memory "
            f"{peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB above "
            f"the {base / 2**30:.2f} GiB held before; validation loss "
            f"{float(val_loss):.4f}, largest |grad| "
            f"{float(flat.abs().max()):.3e} on {card}")
    # the card against the CPU, exact, fp32, dropout off
    mcfg32 = plain_model_config(darts_config(
        "float32", "default", root, records, "darts", dropout=0.0).model)

    def loss32(p, a, batch, gen):
        return vqa_ef.ef_loss(p, a, mcfg32, batch["image"], batch["question"],
                              batch["answer_label"], gen=gen,
                              deterministic=False)

    res = []
    for dev in (device, torch.device("cpu")):
        move = lambda t: t[:STAGE3_CPU_BATCH].detach().to(dev)  # noqa: E731
        t0 = time.perf_counter()
        g, val_loss = make_darts_arch_grad(loss32, "exact")(
            tree_map(lambda t: t.detach().to(dev), exp.params),
            tree_map(lambda t: t.detach().to(dev), exp.arch),
            *[tree_map(move, b) for b in batches], lr,
            torch.Generator(device=dev).manual_seed(SEED))
        res.append(([v.cpu() for v in _leaves(g)], float(val_loss)))
        log(f"darts arch exact fp32 B={STAGE3_CPU_BATCH} on {dev.type} took "
            f"{time.perf_counter() - t0:.1f} s")
    del exp
    torch.cuda.empty_cache()
    (g_card, v_card), (g_cpu, v_cpu) = res
    expect(abs(v_card - v_cpu) <= STAGE3_LOSS_TOL * (1 + abs(v_cpu)),
           f"darts arch against the CPU: validation loss {v_card} vs {v_cpu}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(g_card, g_cpu)):
        err, scale = _grad_err(a, b)
        worst = max(worst, err / max(STAGE3_GRAD_TOL * scale, 1e-30))
        expect(bool(torch.isfinite(a).all()) and scale > 0
               and err <= STAGE3_GRAD_TOL * scale,
               f"darts arch against the CPU: leaf {i} {tuple(a.shape)} "
               f"differs by {err} (scale {scale})")
    log(f"darts arch against the CPU: validation loss {v_card:.6f} vs "
        f"{v_cpu:.6f}; {len(g_cpu)} arch leaves, worst error {worst:.3f} of "
        f"its limit ({STAGE3_GRAD_TOL} of the leaf's scale)")
    return out


def npy_lct_run(records, images, device, root: str):
    """The LCT loop on the npy loader (use_old_dataloader) at the kernel
    flags, bf16: two train steps (stages 1 and 2) and validation; finite
    losses, BLEU4 in [0, 100]."""
    import dataclasses

    from lctvqa_torch.data import pipeline_npy
    from lctvqa_torch.train.experiment import Experiment

    with kernel_flags("kernels"):
        cfg = train_config("bfloat16", "kernels", root)
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, input_dir=records, use_old_dataloader=True),
            exp_name="lct_npy")
        data = pipeline_npy.get_npy_loader(
            records, max_qst_length=cfg.model.max_qst_len,
            img_size=cfg.model.img_size, images=images)
        exp = Experiment(cfg, device=device, data=data)
        batches = iter(exp._batches("train"))
        t0 = time.perf_counter()
        outs = [exp.train_step(next(batches)) for _ in range(2)]
        exp.val()
        losses = [float(o[i]) for o in outs for i in (0, 3)] + exp.val_ef_loss
        bleu = [float(line.split("BLEU4: ")[1].split()[0]) for line in (
            Path(exp.exp_dir) / "log.txt").read_text().splitlines()
            if "BLEU4: " in line]
    expect(all(np.isfinite(losses)) and len(bleu) == 1
           and 0.0 <= bleu[0] <= 100.0,
           f"LCT on the npy loader: losses {losses}, BLEU4 {bleu}")
    log(f"LCT on the npy loader, bfloat16 kernels: EF and W losses "
        f"{losses[:4]}, validation loss {losses[4]:.4f}, BLEU4 {bleu}, "
        f"{time.perf_counter() - t0:.1f} s")
    del exp
    torch.cuda.empty_cache()


def _post_status(port: int, path: str, payload):
    """_post, with an HTTP error's status and body as its result."""
    try:
        return _post(port, path, payload)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_family(path, device, fname: str, n=16):
    """One artifact over HTTP at a flag set, fp32: concurrent /generate
    requests and one /answer. A unified artifact's /generate answers
    {"qa", "answer"} and its /answer is a 400; an EF artifact's answer
    with vocabulary words. -> launches of the run."""
    from lctvqa_torch import serve
    from lctvqa_torch.ops import _build

    _build.reset_launch_counts()
    with kernel_flags(fname) as flags:
        srv = serve.make_server(path, port=0, window_ms=5.0, max_batch=64,
                                device=device, compute_dtype="float32",
                                **flags)
        svc = srv.RequestHandlerClass.service
        svc.warmup()
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            port = srv.server_address[1]
            s = svc.meta["img_size"]
            u8 = np.random.default_rng(SEED + 7).integers(
                0, 256, (n, s, s, 3), dtype=np.uint8)

            def ask(i):
                return _post_status(port, "/generate", {
                    "image_b64": base64.b64encode(u8[i].tobytes()).decode()})

            with ThreadPoolExecutor(16) as pool:
                gen = list(pool.map(ask, range(n)))
            ans = _post_status(port, "/answer", {
                "image_b64": base64.b64encode(u8[0].tobytes()).decode(),
                "question": "what color is the cat"})
        finally:
            srv.shutdown()
            srv.server_close()
    family = svc.meta["family"]
    tag = f"serve {family} {fname}"
    if family == "unified":
        words = set(svc.meta["unified_words"])
        expect(all(st == 200 and set(b) == {"qa", "answer"}
                   and all(w in words for w in b["qa"].split())
                   for st, b in gen), f"{tag}: /generate {gen[:2]}")
        expect(400 <= ans[0] < 500, f"{tag}: /answer answered {ans}")
    else:
        words = svc.meta["ans_words"]
        expect(all(st == 200 and b.get("answer") in words
                   and isinstance(b.get("question"), str) for st, b in gen)
               and ans[0] == 200 and ans[1].get("answer") in words,
               f"{tag}: /generate {gen[:2]}, /answer {ans}")
    log(f"{tag}: {n} /generate, e.g. {gen[0][1]}; /answer {ans[0]}")
    return collections.Counter(_build.launch_counts())


def check_unified_serving(path, device, card: str):
    """The unified artifact: ServingModel.generate on the card (fp32, the
    kernel flags) against the CPU at B=64, tokens equal or a near tie
    (phase 5's rule); generate's ms a call at B=64 bf16 with the kernel
    flags (informational)."""
    from lctvqa_torch.export import ServingModel, read_artifact

    art = read_artifact(path)
    s = art["meta"]["img_size"]
    u8 = np.random.default_rng(SEED + 8).integers(0, 256, (64, s, s, 3),
                                                  dtype=np.uint8)
    ref = ServingModel(art, "cpu", compute_dtype="float32")
    want = ref.generate(u8)
    with kernel_flags("kernels") as flags:
        model = ServingModel(art, device, compute_dtype="float32", **flags)
        got = model.generate(u8).cpu()
        expect(got.shape == want.shape == (64, art["meta"]["max_qst_len"])
               and got.dtype == torch.int32, "unified generate shape/dtype")
        _features_agree(_image_features(model, u8), _image_features(ref, u8),
                        "unified B=64 vs CPU")
        _tokens_agree(ref, u8, got, want, "unified B=64 vs CPU")
        log(f"unified B=64 vs CPU: {int((got == want).all(1).sum())} of 64 "
            f"streams equal; answers e.g. {model.generated_answers(u8[:2])}")
        bf16 = ServingModel(art, device, compute_dtype="bfloat16", **flags)
        ms = time_ms(lambda: bf16.generate(u8), reps=10)
    log(f"unified generate B=64 bfloat16 kernels: {ms:.2f} ms a call "
        f"({64e3 / ms:.1f} streams/s) on {card}")
    del model, bf16, ref
    torch.cuda.empty_cache()


def darts_artifact(root: str, exp_name: str, records: str, name: str):
    """export_state on a trained DARTS-family experiment's vqa_model.ckpt
    and arch_par.ckpt, written as an artifact file."""
    from lctvqa_torch.export import export_state, save_artifact
    from lctvqa_torch.train import checkpoint

    d = Path(root) / exp_name
    state = {**checkpoint.load_state(str(d / "vqa_model.ckpt")),
             **checkpoint.load_state(str(d / "arch_par.ckpt"))}
    mcfg = checkpoint.config_from_state(state).model
    path = str(Path(root) / f"{name}.lctx")
    save_artifact(export_state(state, mcfg, input_dir=records), path)
    return path


def darts_phase(arrays, device, root: str, card: str) -> dict:
    """Phase 11: npy records padded to full width, each family's run at
    both flag sets (the counts zeroed before each), the first fp32 losses
    of the two flag sets, the arch steps by mode and against the CPU, the
    LCT loop on the npy loader, the unified and darts-EF artifacts
    served. -> the kernel-flag runs' launches by family."""
    from lctvqa_torch.ops import _build

    t0 = time.perf_counter()
    records, images = darts_records(root, arrays)
    launches, names, times = {}, {}, {}
    for family in ("darts", "unified"):
        for fname in KERNEL_FLAGS:
            _build.reset_launch_counts()
            times[(family, fname)], names[(family, fname)], got = darts_run(
                records, images, device, family, fname, root)
            log(f"launches in the bfloat16 {fname} {family} run: "
                f"{_launched(got)}")
            if fname == "kernels":
                launches[family] = got
                expect(all(got[k] > 0 for k in (*STAGE1_LAUNCHES,
                                                "lstm_seq_all",
                                                "greedy_generate")),
                       f"{family} kernels run: launches {got}")
    darts_first_losses(records, images, device, root)
    arch = darts_arch_modes(records, images, device, root, card)
    npy_lct_run(records, images, device, root)
    paths = {family: darts_artifact(root, names[(family, "kernels")],
                                    records, f"{family}_trained")
             for family in ("unified", "darts")}
    for fname in KERNEL_FLAGS:
        calls = serve_family(paths["unified"], device, fname)
        on = fname == "kernels"
        expect((calls["greedy_generate"] > 0) == on
               and (calls["mixed_node_fwd"] > 0) == on,
               f"serve unified {fname}: launches {_launched(calls)}")
        log(f"serve unified {fname}: launches {_launched(calls)}")
    check_unified_serving(paths["unified"], device, card)
    calls = serve_family(paths["darts"], device, "kernels")
    expect(calls["greedy_generate"] > 0, f"serve darts EF: {calls}")
    for (family, fname), t in times.items():
        log(f"{family} bfloat16 {fname}: train step {t['train_ms']:.1f} ms, "
            f"{64e3 / t['train_ms']:.1f} trained pairs/s, arch step "
            + ", ".join(f"{m:.0f}" for m in t["arch_ms"]) + f" ms on {card}")
    for mode, t in arch.items():
        log(f"darts arch {mode} bfloat16 B=64: "
            + ", ".join(f"{m:.0f}" for m in t) + f" ms a call on {card}")
    log(f"darts and unified phase took {time.perf_counter() - t0:.1f} s")
    return launches


def check_unified_decode(device):
    """Phase 2's case for the unified vocabulary: the decode kernel at
    V = UNIFIED_VOCAB (V % 8 = 5: a padded head), B = 1, 8, 64, both
    dtypes, against its plain version (phase 2's rule for tokens and
    near ties), TF32 off; the card's plan is generate_plan's."""
    import dataclasses

    with tf32_off():
        mcfg = dataclasses.replace(model_configs()["w"],
                                   qst_vocab_size=UNIFIED_VOCAB)
        res = check_kernels(device, mcfg,
                            names=("greedy_generate",))["greedy_generate"]
        check_generate_plan(device, mcfg)
    return res


# ---------------------------------------------------------------------------
# phase 12: int8 serving, the export CLI and the training statistics
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def int8_calls():
    """Records the int8 products that conv2d and linear ask for while
    open, with their operands: [(name, args)]. A conv's own GEMM is part
    of its int8_conv2d call and is not recorded apart."""
    from lctvqa_torch.ops import int8

    calls, depth = [], [0]
    conv, mm = int8.int8_conv2d, int8.int8_matmul

    def wrap(name, fn):
        def recorded(*args):
            if depth[0] == 0:
                calls.append((name, args))
            depth[0] += 1
            try:
                return fn(*args)
            finally:
                depth[0] -= 1
        return recorded

    int8.int8_conv2d = wrap("int8_conv2d", conv)
    int8.int8_matmul = wrap("int8_matmul", mm)
    try:
        yield calls
    finally:
        int8.int8_conv2d, int8.int8_matmul = conv, mm


def check_int8_products(calls, tag: str) -> dict:
    """Each recorded int8 product of a distinct shape on the card against
    its plain version on the same operands: equal bit for bit (int32
    sums of int8 codes are exact on both). -> {(name, shapes): patch
    matrix bytes (0 for a matmul)}."""
    from lctvqa_torch.ops import int8

    seen = {}
    for name, args in calls:
        key = (name, tuple(tuple(a.shape) if torch.is_tensor(a) else a
                           for a in args))
        if key in seen:
            continue
        if name == "int8_conv2d":
            x, w = args[:2]
            got, want = int8.int8_conv2d(*args), int8.int8_conv2d_plain(*args)
            seen[key] = int8.patch_bytes(tuple(x.shape), w.shape[2],
                                         w.shape[3], *args[2:])
        else:
            got, want = int8.int8_matmul(*args), int8.int8_matmul_plain(*args)
            seen[key] = 0
        torch.cuda.synchronize()
        expect(got.dtype == torch.int32 and torch.equal(got, want),
               f"{tag}: {name} at {key[1]} differs from its plain version "
               f"({int((got.long() - want.long()).abs().max())})")
    log(f"{tag}: {len(seen)} int8 product shapes, each equal to its plain "
        f"version: " + "; ".join(
            f"{n[4:]} {s[0]}x{s[1]}" + (f" {s[2:]}" if len(s) > 2 else "")
            for n, s in seen))
    return seen


def check_quantize_on_card(device, w_params) -> None:
    """quant.quantize_model of the full-width W params and quantize_act of
    a conv input (per sample and per tensor) on the card, equal bit for
    bit to the CPU's: the same scales (a division, not a product with the
    reciprocal) and so the same codes."""
    from lctvqa_torch import quant
    from lctvqa_torch.ops import conv

    got = _leaves(quant.quantize_model(_to(w_params, device)))
    want = _leaves(quant.quantize_model(w_params))
    same = sum(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    expect(same == len(want), f"quantize_model: {len(want) - same} of "
           f"{len(want)} leaves differ between the card and the CPU")
    x = torch.randn(64, 64, 64, 64, generator=torch.Generator().manual_seed(
        SEED + 12)) * torch.rand(64, 1, 1, 1)
    acts = []
    for per_sample in (True, False):
        a = [t.cpu() for t in conv.quantize_act(x.to(device), per_sample)]
        b = conv.quantize_act(x, per_sample)
        acts.append(all(torch.equal(u, v) for u, v in zip(a, b)))
    expect(all(acts), f"quantize_act: the card's codes or scales differ "
           f"from the CPU's (per sample, per tensor: {acts})")
    log(f"quantization on the card equals the CPU's: {same}/{len(want)} W "
        f"leaves, activations per sample and per tensor {acts}")


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree)
               if torch.is_tensor(t))


def write_vocab_dir(d: Path, mcfg) -> str:
    """vocab_questions.txt and vocab_answers.txt of vocab_words, for an
    export's --input_dir."""
    d.mkdir(parents=True, exist_ok=True)
    for fname, words in zip(("vocab_questions.txt", "vocab_answers.txt"),
                            vocab_words(mcfg)):
        (d / fname).write_text("\n".join(words) + "\n")
    return str(d)


def serve_int8(path, device, route: str, genotype=None, n=8):
    """An int8 artifact over HTTP in bf16 with the kernel flags: n
    concurrent requests on `route` (/answer or /generate), answered with
    vocabulary words. -> (the kernels' launches, the int8 products) of
    the run, warmup included."""
    from lctvqa_torch import serve
    from lctvqa_torch.ops import _build, int8

    _build.reset_launch_counts()
    int8.reset_launch_counts()
    with kernel_flags("kernels") as flags:
        srv = serve.make_server(path, port=0, window_ms=5.0, max_batch=64,
                                device=device, genotype=genotype, **flags)
        svc = srv.RequestHandlerClass.service
        svc.warmup()
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            port = srv.server_address[1]
            s = svc.meta["img_size"]
            qst_words, _ = vocab_words(model_configs()["w"])
            rng = np.random.default_rng(SEED + 9)
            u8 = rng.integers(0, 256, (n, s, s, 3), dtype=np.uint8)

            def ask(i):
                payload = {"image_b64": base64.b64encode(
                    u8[i].tobytes()).decode()}
                if route == "/answer":
                    payload["question"] = " ".join(rng.choice(qst_words[4:],
                                                              6))
                return _post_status(port, route, payload)

            with ThreadPoolExecutor(8) as pool:
                got = list(pool.map(ask, range(n)))
        finally:
            srv.shutdown()
            srv.server_close()
    words = svc.meta["ans_words"]
    tag = f"serve int8 {svc.meta['family']} {route}"
    expect(svc.meta.get("int8") is True
           and all(st == 200 and b.get("answer") in words for st, b in got)
           and (route == "/answer" or all(isinstance(b.get("question"), str)
                                          for _, b in got)),
           f"{tag}: {got[:2]}")
    calls = _launched(_build.launch_counts())
    log(f"{tag}: {n} requests, e.g. {got[0][1]}; launches {calls}; int8 "
        f"products {dict(int8.LAUNCHES)}")
    return calls, dict(int8.LAUNCHES)


def int8_w_checks(fp_path, int8_path, device, card: str) -> dict:
    """The W model int8 against fp on the card: every int8 product shape
    at B = 64, 1 and 5 held to its plain version; answers at B = 64
    against the fp32 and bf16 forwards; logits at fp32 compute dtype
    against the CPU's int8 forward on INT8_CPU_ROWS rows; ms per
    answer_logits call and weight bytes on the device. -> the readings."""
    from lctvqa_torch.export import ServingModel, read_artifact

    mcfg = model_configs()["w"]
    rng = np.random.default_rng(SEED + 10)
    s, seq = mcfg.img_size, mcfg.max_qst_len
    u8 = rng.integers(0, 256, (64, s, s, 3), dtype=np.uint8)
    qst = rng.integers(4, mcfg.qst_vocab_size, (64, seq), dtype=np.int32)
    fp_art, q_art = read_artifact(fp_path), read_artifact(int8_path)
    out, ms, dev_bytes, prof = {}, {}, {}, {}
    for name, art, dtype in (("fp32", fp_art, "float32"),
                             ("bf16", fp_art, "bfloat16"),
                             ("int8", q_art, "bfloat16")):
        before = torch.cuda.memory_allocated()
        model = ServingModel(art, device, compute_dtype=dtype)
        dev_bytes[name] = torch.cuda.memory_allocated() - before
        if name == "int8":
            with int8_calls() as calls:
                for b in (64, 1, 5):
                    model.answer_logits(u8[:b], qst[:b])
            shapes = check_int8_products(calls, "W int8")
            del calls
        out[name] = model.answer_logits(u8, qst).float().cpu()
        ms[name] = time_ms(lambda: model.answer_logits(u8, qst))
        if name != "fp32":
            prof[name] = profile_calls(
                lambda: model.answer_logits(u8, qst),
                f"W answer_logits B=64 {name}", top=12)
        del model
        torch.cuda.empty_cache()
    agree = {ref: float((out["int8"].argmax(1) == out[ref].argmax(1))
                        .float().mean()) for ref in ("fp32", "bf16")}
    rel = float((out["int8"] - out["fp32"]).norm() / out["fp32"].norm())
    expect(bool(torch.isfinite(out["int8"]).all())
           and out["int8"].shape == (64, mcfg.ans_vocab_size),
           f"W int8 B=64: logits {out['int8'].shape}")
    # the card against the CPU, int8 at fp32 compute dtype
    rows = slice(0, INT8_CPU_ROWS)
    got = ServingModel(q_art, device, compute_dtype="float32").answer_logits(
        u8[rows], qst[rows]).cpu()
    want = ServingModel(q_art, "cpu", compute_dtype="float32").answer_logits(
        u8[rows], qst[rows])
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    expect(err <= INT8_CPU_TOL * scale,
           f"W int8 fp32: card against CPU {err} (scale {scale})")
    largest = max(shapes.items(), key=lambda kv: kv[1])
    res = {"ms": ms, "device_bytes": dev_bytes,
           "profiled": {k: dict(zip(("wall_ms", "device_ms", "kernels"), v))
                        for k, v in prof.items()},
           "artifact_leaf_bytes": {
               "fp32": _tensor_bytes(_as_tensors(fp_art["params"])),
               "int8": _tensor_bytes(_as_tensors(q_art["params"]))},
           "agree_with": agree, "rel_logit_err_fp32": rel,
           "cpu_max_abs_err": err, "cpu_logit_scale": scale,
           "largest_patch_bytes": largest[1],
           "largest_patch_at": list(largest[0][1][:2])}
    log(f"W B=64 answer_logits: int8 {ms['int8']:.3f} ms, bf16 "
        f"{ms['bf16']:.3f}, fp32 {ms['fp32']:.3f} a call (CUDA events, "
        f"median of 20); weight bytes on the device int8 "
        f"{dev_bytes['int8']}, bf16 {dev_bytes['bf16']}, fp32 "
        f"{dev_bytes['fp32']}; answers agree with fp32 {agree['fp32']:.4f}, "
        f"bf16 {agree['bf16']:.4f}, relative logit error against fp32 "
        f"{rel:.4f}; int8 fp32 card against CPU {err:.3e} of scale "
        f"{scale:.3e} ({INT8_CPU_ROWS} rows); largest patch matrix "
        f"{largest[1]} bytes at x {largest[0][1][0]}, w {largest[0][1][1]} "
        f"on {card}")
    return res


def _as_tensors(tree):
    from lctvqa_torch import convert

    return convert.as_tensors(tree)


def stats_epochs(arrays_small, device, root: str) -> None:
    """Phase 8's bf16 kernel-flag experiment resumed for one epoch on a
    small split, then once more: the first resumed run writes the six
    statistics lists (the loop never ran an epoch there), the second
    extends each by one value and keeps the first."""
    import dataclasses

    from lctvqa_torch.data import pipeline
    from lctvqa_torch.train.experiment import STATS, Experiment

    exp_dir = Path(root) / "bfloat16_kernels"
    lists = []
    for epochs in (2, 3):
        cfg = train_config("bfloat16", "kernels", root)
        cfg = cfg.replace(resume=True, train=dataclasses.replace(
            cfg.train, num_epochs=epochs))
        with kernel_flags("kernels"):
            exp = Experiment(cfg, device=device,
                             data=pipeline.loader_from_arrays(arrays_small))
            exp.run()
        lists.append({n: json.loads((exp_dir / f"{n}.txt").read_text())
                      for n in STATS})
        del exp
        torch.cuda.empty_cache()
    first, second = lists
    expect(all(len(first[n]) == 1 and len(second[n]) == 2
               and second[n][0] == first[n][0]
               and np.isfinite(second[n]).all() for n in STATS),
           f"stats files after two resumed epochs: {lists}")
    pngs = sorted(p.name for p in exp_dir.glob("*.png"))
    log(f"stats files of {exp_dir.name} after two resumed epochs: "
        f"{second}; plots {pngs or 'skipped (no matplotlib)'}")


def int8_phase(arrays, device, root: str, card: str, w_path=None) -> dict:
    """Phase 12: the W and derived-EF checkpoints exported int8 through
    the CLI (--check on the card), served over HTTP, the products held to
    their plain versions, eval --int8, and the statistics files of phase
    8's run. Where an earlier phase did not run (--int8), its artifact,
    records and experiments are made here, untrained. -> the readings."""
    from lctvqa_torch import eval as t_eval, export
    from lctvqa_torch.config import Config, ModelConfig
    from lctvqa_torch.data import pipeline, synthetic
    from lctvqa_torch.export import ServingModel, read_artifact
    from lctvqa_torch.models import vqa_w
    from lctvqa_torch.train import checkpoint
    from lctvqa_torch.train.experiment import Experiment

    t0 = time.perf_counter()
    rootp = Path(root)
    mcfg = model_configs()["w"]
    if w_path is None:
        w_path = write_artifacts(rootp, names=("w",))["w"]
    # phase 3's W params (write_artifacts' seed for "w") as a checkpoint
    w_params = vqa_w.init_w_model(torch.Generator().manual_seed(SEED + 1),
                                  mcfg)
    check_quantize_on_card(device, w_params)
    (rootp / "int8_w").mkdir()
    checkpoint.save_state(str(rootp / "int8_w" / "w_model.ckpt"),
                          {"w_params": w_params, "epoch": 1},
                          config=Config(model=ModelConfig(arch_type="fixed")))
    del w_params
    vocab = write_vocab_dir(rootp / "int8_vocab", mcfg)
    t1 = time.perf_counter()
    w8 = export.main(["--exp", "int8_w", "--root_stats_dir", root,
                      "--model", "w", "--int8", "--check", "--input_dir",
                      vocab, "--device", device.type])
    log(f"export --int8 --check of the W checkpoint: "
        f"{time.perf_counter() - t1:.1f} s")
    calls, products = serve_int8(w8, device, "/answer")
    expect(calls.get("lstm_seq_final", 0) > 0
           and products["int8_conv2d"] > 0 and products["int8_matmul"] > 0,
           f"serve int8 W: launches {calls}, int8 products {products}")
    res = int8_w_checks(w_path, w8, device, card)

    # phase 10's derived EF (its kernel-flag run), int8
    records = rootp / "derived_records"
    exp_name = "derived_bfloat16_kernels"
    if not (rootp / exp_name).exists():
        synthetic.make_npy_records(str(records), **TRAIN_DATA,
                                   n_answers=mcfg.ans_vocab_size, seed=SEED)
        Experiment(derived_config("bfloat16", "kernels", root, str(records)),
                   device=device,
                   data=pipeline.loader_from_arrays(arrays)).save_model()
    d8 = str(rootp / "derived_int8.lctx")
    export.main(["--exp", exp_name, "--root_stats_dir", root, "--model",
                 "ef", "--int8", "--check", "--out", d8, "--input_dir",
                 vocab, "--device", device.type])
    calls, products = serve_int8(d8, device, "/generate",
                                 genotype=DERIVED_GENOTYPE)
    expect(calls.get("greedy_generate", 0) > 0
           and calls.get("lstm_seq_all", 0) > 0
           and products["int8_conv2d"] > 0,
           f"serve int8 derived EF: launches {calls}, products {products}")
    res["derived_serve_launches"] = calls
    res["derived_int8_products"] = products
    with kernel_flags("kernels") as flags:
        model = ServingModel(read_artifact(d8), device,
                             genotype=DERIVED_GENOTYPE, **flags)
        u8 = np.random.default_rng(SEED + 11).integers(
            0, 256, (64, mcfg.img_size, mcfg.img_size, 3), dtype=np.uint8)
        qst = np.zeros((64, mcfg.max_qst_len), np.int32)
        with int8_calls() as rec:
            model.answer_logits(u8, qst)
            tok, ans = model.generate(u8)
        check_int8_products(rec, "derived EF int8")
        del rec, model
        expect(tok.shape == (64, mcfg.max_qst_len) and ans.shape == (64,),
               f"derived int8 generate: {tok.shape}, {ans.shape}")
        t1 = time.perf_counter()
        got = t_eval.main(["--exp", exp_name, "--root_stats_dir", root,
                           "--input_dir", str(records), "--batch_size", "64",
                           "--num_batches", "2", "--device", device.type,
                           "--int8"], data=pipeline.loader_from_arrays(arrays))
    expect(got["n"] == 128 and 0.0 <= got["acc"] <= 1.0
           and 0.0 <= got["bleu4"] <= 100.0, f"eval --int8: {got}")
    log(f"eval --int8 of {exp_name}: {got} in "
        f"{time.perf_counter() - t1:.1f} s")
    torch.cuda.empty_cache()

    # phase 8's run: the statistics files, and a resumed epoch
    if not (rootp / "bfloat16_kernels").exists():
        with kernel_flags("kernels"):
            Experiment(train_config("bfloat16", "kernels", root),
                       device=device,
                       data=pipeline.loader_from_arrays(arrays)).save_model()
    dm = model_configs()["darts"]
    stats_epochs(synthetic.make_arrays(
        num_images=64, num_questions=128, img_size=dm.img_size,
        n_answers=dm.ans_vocab_size, seed=SEED + 8,
        max_qst_len=dm.max_qst_len, qst_vocab_size=dm.qst_vocab_size),
        device, root)
    res["wall_s"] = time.perf_counter() - t0
    log("int8 readings: " + json.dumps(res, default=str))
    log(f"int8 phase took {res['wall_s']:.1f} s on {card}")
    return res


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 13: data parallel on one card
# ---------------------------------------------------------------------------

# two gloo ranks on cuda:0 (NCCL refuses two ranks on one device), each on
# half of a global batch of PARALLEL_BATCH rows; stage 3 on the first
# STAGE3_CPU_BATCH rows of the global batches (two ranks of 4)
PARALLEL_RANKS = 2
PARALLEL_BATCH = 64
PARALLEL_JOIN_SECONDS = 600
# the two-launch BatchNorm kernels of several ranks (rows 7 and 7b)
SYNC_BN_KERNELS = {
    "bn_fwd_sums": "lctvqa/ops/pallas_bn.py:81",
    "bn_fwd_apply": "lctvqa/ops/pallas_bn.py:81",
    "bn_bwd_sums": "lctvqa/ops/pallas_bn.py:95",
    "bn_bwd_apply": "lctvqa/ops/pallas_bn.py:95"}
# the node kernels' data-parallel mode (rows 5s and 6s): row -> (its
# launches, the TPU kernel it replaces)
SYNC_NODE_KERNELS = {
    "mixed_node_fwd_sync": (("mixed_node_fwd_sync_a", "mixed_node_fwd_sync_b",
                             "mixed_node_fwd_sync_z"),
                            "lctvqa/ops/pallas_mixedop.py:425"),
    "mixed_node_bwd_sync": (("mixed_node_bwd_sync_r", "mixed_node_bwd_sync_s",
                             "mixed_node_bwd_sync_x"),
                            "lctvqa/ops/pallas_mixedop.py:721")}
SYNC_NODE_LAUNCHES = tuple(k for ks, _ in SYNC_NODE_KERNELS.values()
                           for k in ks)
# the node of their checks: supernet cell 0 (64x64, Cs 4) with E edges, on
# the global batch of PARALLEL_BATCH rows
SYNC_NODE_CASE = ("cell0", 5)
# what a data-parallel run of the main path must launch, and must not (the
# one-launch BatchNorm gives way to the two-launch one; the node kernels
# run only with pallas_mixed_op, in the stage 1 of node_stage1)
PARALLEL_LAUNCHED = LSTM_KERNELS + tuple(SYNC_BN_KERNELS)
PARALLEL_NOT_LAUNCHED = ("mixed_node_fwd", "mixed_node_bwd", "bn_fwd",
                         "bn_bwd") + SYNC_NODE_LAUNCHES
# the supernet's six BatchNorm shapes (global rows) and the dtype pairs of
# the sync check: (x, y) forward, (x, g) backward
SYNC_BN_SHAPES = BN_SHAPES[:6]
SYNC_BN_DTYPES = (("float32", "float32"), ("float32", "bfloat16"))
# the sync kernels' rows in the kernels line: the largest shape a rank's
# half batch gives them on the phase's fp32 path
SYNC_BN_ROW = ((32, 64, 64, 32), "float32", "float32")
# tests/test_mesh.py's tolerances: losses, parameters, the arch
PARALLEL_LOSS_RTOL = 1e-5
PARALLEL_PARAM_TOL = (2e-4, 1e-5)
PARALLEL_ARCH_TOL = (2e-4, 1e-6)


def parallel_config(root: str, name: str):
    """Full width (ModelConfig's defaults) in fp32 with the kernel flags of
    a data-parallel run on: the sequence and decode kernels (the cell is on
    by default), the BatchNorm switch set by the caller; dropout off, so
    that the ranks' own streams do not enter the comparison."""
    from lctvqa_torch.config import Config, ModelConfig, TrainConfig

    return Config(model=ModelConfig(compute_dtype="float32", dropout_rate=0.0,
                                    pallas_seq_lstm=True,
                                    pallas_generate=True),
                  train=TrainConfig(batch_size=PARALLEL_BATCH, num_epochs=1,
                                    skip_stage3=False, seed=SEED),
                  root_stats_dir=root, exp_name=name)


@contextlib.contextmanager
def greedy_sampling():
    """torch.multinomial as the first maximum while open: stage 2's
    sampled questions become the greedy ones, whatever stream a rank
    draws from."""
    was = torch.multinomial
    torch.multinomial = lambda probs, n, generator=None: probs.argmax(
        -1, keepdim=True)
    try:
        yield
    finally:
        torch.multinomial = was


def parallel_batches(arrays):
    """The global train and validation batches: the first of an epoch of
    each split, as one process's loader gathers them."""
    from lctvqa_torch.data import pipeline

    data = pipeline.loader_from_arrays(arrays)
    rng = np.random.default_rng(SEED)
    return [next(pipeline.epoch_batches(data[split], PARALLEL_BATCH, rng,
                                        shuffle=False))
            for split in ("train", "valid")]


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_tree(v) for v in tree]
    return tree.detach().cpu()


def _heads(tree):
    """W's tree without the VGG trunk, which no step trains."""
    return {k: v for k, v in tree.items() if k != "vgg"}


@contextlib.contextmanager
def optimizer_grads():
    """While open, every Optimizer.update's gradients, by call: a list of
    leaf lists (copies on the device, None where the loss does not reach
    a leaf). Each is what that step's optimizer took, before its clip
    and weight decay, so a check of them needs no pass of its own."""
    from lctvqa_torch.optim import optimizers

    calls = []
    was = optimizers.Optimizer.update

    def update(self, params, grads, state):
        grads = list(grads)
        calls.append([None if g is None else g.detach().clone()
                      for g in grads])
        return was(self, params, grads, state)

    optimizers.Optimizer.update = update
    try:
        yield calls
    finally:
        optimizers.Optimizer.update = was


def _host_grads(tree, grads, pick=lambda t: t):
    """`grads` (in `tree`'s leaf order) on the host for the leaves of
    pick(tree), zeros where None."""
    from lctvqa_torch.optim.optimizers import tree_from_leaves

    return [torch.zeros(tuple(p.shape)) if g is None else g.cpu()
            for p, g in zip(_leaves(pick(tree)),
                            _leaves(pick(tree_from_leaves(tree, grads))))]


def parallel_steps(exp, train, valid):
    """The main path of a data-parallel run on the Experiment's rows of
    the global batches (all of them without a process group), from its
    fresh state, the launch counts set to 0 just before it and read just
    after it: one stage-3 call (exact-indirect, remat on) on the first
    STAGE3_CPU_BATCH rows, stages 1 and 2 through train_step, one
    validation step. -> outputs on the host (with the gradient each
    step's optimizer took: stage 3's arch, stage 1's EF, stage 2's W
    heads), launches, ms of the train_step."""
    from lctvqa_torch.ops import _build
    from lctvqa_torch.parallel import mesh as mesh_lib

    def dev(batch, n):
        half = mesh_lib.shard_batch({k: v[:n] for k, v in batch.items()},
                                    exp.mesh)
        return exp._to_device(half)

    with identity_dropout(), greedy_sampling(), optimizer_grads() as calls:
        _build.reset_launch_counts()
        lr = exp._epoch_lr()
        exp.arch, exp.arch_opt, s3 = exp.steps["stage3"](
            exp.arch, exp.arch_opt, exp.ef_params, exp.w_params,
            dev(train, STAGE3_CPU_BATCH), dev(valid, STAGE3_CPU_BATCH),
            lr, lr, exp.gen)
        batch = dev(train, PARALLEL_BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, c1, c2, loss2, wc, _ = exp.train_step(batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        ev = exp._eval_step(dev(valid, PARALLEL_BATCH))
        torch.cuda.synchronize()
        launches = _build.launch_counts()
    expect(len(calls) == 3, f"the main path made {len(calls)} optimizer "
           "steps, not 3 (stage 3, stage 1, stage 2)")
    grads = dict(zip(("arch", "ef", "w_heads"), (
        _host_grads(tree, call, pick) for (tree, pick), call in zip(
            ((exp.arch, lambda t: t), (exp.ef_params, lambda t: t),
             (exp.w_params, _heads)), calls))))
    return ({"ef": _host_tree(exp.ef_params), "arch": _host_tree(exp.arch),
             "w_heads": _host_tree(_heads(exp.w_params)), "grads": grads,
             "ef_lr": float(exp.ef_opt["lr"]), "stage3": float(s3),
             "stage1": float(loss), "stage2": float(loss2),
             "eval": float(ev[0]),
             "counts": (int(c1), int(c2), int(wc), int(ev[1]), int(ev[2]))},
            launches, ms)


def sync_bn_inputs(device):
    """The sync check's tensors: x and g at each SYNC_BN_SHAPES entry, on
    `device`, the same on every rank (a seeded CPU generator)."""
    gen = torch.Generator().manual_seed(SEED + 30)
    return {shape: ((1.5 * torch.randn(shape, generator=gen) + 0.3).to(
        device), torch.randn(shape, generator=gen).to(device))
        for shape in SYNC_BN_SHAPES}


def sync_bn_ranks(device, rows: slice):
    """On each rank: the two-launch forward and backward of its rows of
    every sync input, and the ms of a whole call (sums, all-reduce over
    gloo, apply) at the largest shape."""
    from lctvqa_torch.ops import cuda_bn

    out, ms = {}, {}
    for shape, (xb, gb) in sync_bn_inputs(device).items():
        for a, b in SYNC_BN_DTYPES:
            x = xb[rows].to(DTYPES[a])
            g = gb[rows].to(DTYPES[b])
            y, stat, _ = cuda_bn.batchnorm_fwd_stat_sync(x, DTYPES[b])
            dx = cuda_bn.batchnorm_bwd_sync(x, g, stat)
            out[(shape, a, b)] = (y.cpu(), stat.cpu(), dx.cpu())
            if shape == SYNC_BN_SHAPES[1] and (a, b) == SYNC_BN_DTYPES[1]:
                ms["fwd"] = time_ms(lambda: cuda_bn.batchnorm_fwd_stat_sync(
                    x, DTYPES[b]))
                ms["bwd"] = time_ms(lambda: cuda_bn.batchnorm_bwd_sync(
                    x, g, stat))
    return out, ms

def sync_node_inputs(device):
    """The node checks' tensors at SYNC_NODE_CASE, the same on every rank
    (a seeded CPU generator): the global batch's E edge states [64, 64,
    64, 16] fp32, their packed weights, the weights [E, 8], g [64, 64, 64,
    4]."""
    from lctvqa_torch.models import search
    from lctvqa_torch.ops import cuda_mixedop as M

    cell, edges = SYNC_NODE_CASE
    h, w, c, _ = NODE_SHAPES[cell]
    gen = torch.Generator().manual_seed(SEED + 31)
    nodes = [M.node_weights(_to(search.mixed_op_init(gen, c, 1, 4), device))
             for _ in range(edges)]
    xs = [torch.randn(PARALLEL_BATCH, h, w, c, generator=gen).to(device)
          for _ in range(edges)]
    g = torch.randn(PARALLEL_BATCH, h, w, c // 4, generator=gen).to(device)
    wts = (torch.softmax(torch.randn(edges, 8, generator=gen), 1)
           * torch.softmax(torch.randn(edges, generator=gen), 0)[:, None]
           ).to(device)
    return xs, nodes, wts, g


def sync_node_ranks(device, rows: slice) -> dict:
    """On each rank, in both dtypes: the node's data-parallel forward and
    backward (node_fwd_sync, node_bwd_sync) on its rows of the node inputs
    against their plain versions under the same process group (moments
    all-reduced through cuda_bn.batch_moments; the backward's taking the
    kernel's inner ReLU decisions, kept=), and a second call's bits.
    -> per dtype the checks' numbers and, on the host, the output, dx,
    this rank's shares of the weight gradients and the inner BatchNorms'
    planes and statistics; and the ms of a whole call with its gloo
    all-reduces, the kernels' and the plain version's, in bf16. The
    checks are made by the main process (check_sync_node_ranks)."""
    from lctvqa_torch.ops import cuda_mixedop as M

    xs_all, nodes, wts, g_all = sync_node_inputs(device)
    cs = g_all.shape[-1]
    out = {}
    for dname, dtype in DTYPES.items():
        xs = [x[rows].to(dtype)[..., :cs] for x in xs_all]
        g = g_all[rows].contiguous()
        y, obuf, stat = M.node_fwd_sync(xs, nodes, wts, cs, device)
        grads = M.node_bwd_sync(xs, nodes, wts, g, obuf, stat, cs, device)
        y2, obuf2, stat2 = M.node_fwd_sync(xs, nodes, wts, cs, device)
        grads2 = M.node_bwd_sync(xs, nodes, wts, g, obuf2, stat2, cs, device)
        y_p = M.mixed_node_plain(xs, nodes, wts, cs)
        grads_p = M.mixed_node_bwd_plain(xs, nodes, wts, g, cs,
                                         kept=(obuf, stat))
        torch.cuda.synchronize()
        ok, rel, _ = _node_grads_within(grads, grads_p,
                                        _node_bwd_tols(len(xs), dname))
        flat = [y, obuf, stat, *grads[0], *grads[1:]]
        flat2 = [y2, obuf2, stat2, *grads2[0], *grads2[1:]]
        out[dname] = {
            "fwd_over": _node_fwd_over(y, y_p, wts, dname),
            "fwd_err": float((y - y_p).abs().max()), "bwd_ok": ok,
            "bwd_err": rel, "dtype_ok": grads[0][0].dtype == dtype,
            "same_bits": all(torch.equal(a, b) for a, b in zip(flat, flat2)),
            "y": y.cpu(), "dx": [d.cpu() for d in grads[0]],
            "shares": [t.cpu() for t in grads[1:]],
            "obuf2": obuf[:2].cpu(), "stat": stat.cpu()}
        if dname == "bfloat16":
            out["call_ms"] = {
                "fwd": time_ms(lambda: M.node_fwd_sync(xs, nodes, wts, cs,
                                                       device)),
                "bwd": time_ms(lambda: M.node_bwd_sync(
                    xs, nodes, wts, g, obuf, stat, cs, device)),
                "plain_fwd": time_ms(lambda: M.mixed_node_plain(
                    xs, nodes, wts, cs), reps=5, warmup=1),
                "plain_bwd": time_ms(lambda: M.mixed_node_bwd_plain(
                    xs, nodes, wts, g, cs), reps=3, warmup=1)}
    return out


def sync_node_launch_times(device) -> dict:
    """The node's data-parallel launches with the card to themselves (no
    process group), at a rank's half of SYNC_NODE_CASE: a SyncForward and
    a SyncBackward on each half of the global batch, their sums added
    between the launches as two ranks' all-reduce adds them, the halves'
    outputs together against the one-process kernel on the global batch
    at phase 2's forward limit. Then each launch (a memset, the finish of
    the statistics where it has one, its stage) and each direction's three
    together are event-timed and profiled (device us, retried), beside the
    plain version at the same half without a process group and the bound.
    -> {row name: row} in bf16; fp32 logged."""
    from lctvqa_torch.ops import cuda_mixedop as M

    xs_all, nodes, wts, g_all = sync_node_inputs(device)
    cell, edges = SYNC_NODE_CASE
    h, w, c, _ = NODE_SHAPES[cell]
    cs, half = c // 4, PARALLEL_BATCH // PARALLEL_RANKS
    halves = [slice(r * half, (r + 1) * half) for r in range(PARALLEL_RANKS)]

    def add(bufs):  # the all-reduce of the ranks, in this process
        total = sum(b.clone() for b in bufs)
        for b in bufs:
            b.copy_(total)

    rows = {}
    for dname, dtype in DTYPES.items():
        xs = [[x[k].to(dtype)[..., :cs] for x in xs_all] for k in halves]
        gs = [g_all[k].contiguous() for k in halves]
        fwd = [M.SyncForward(x, nodes, wts, cs, device, ranks=PARALLEL_RANKS)
               for x in xs]
        for step, part in (("a", slice(0, 2)), ("b", slice(2, None)),
                           ("z", None)):
            for f in fwd:
                getattr(f, step)()
            if part is not None:
                add([f.sums[part] for f in fwd])
        bwd = [M.SyncBackward(x, nodes, wts, g, f.obuf, f.stat, cs, device,
                              ranks=PARALLEL_RANKS)
               for x, g, f in zip(xs, gs, fwd)]
        for step, sums in (("r", "sums_r"), ("s", "sums_s"), ("x", None)):
            for b in bwd:
                getattr(b, step)()
            if sums is not None:
                add([getattr(b, sums) for b in bwd])
        whole_x = [x.to(dtype)[..., :cs] for x in xs_all]
        one, obuf, stat = M.node_fwd_launch(whole_x, nodes, wts, cs, device)
        one_bwd = M.node_bwd_launch(whole_x, nodes, wts, g_all.contiguous(),
                                    obuf, stat, cs, device)
        out = torch.cat([f.out for f in fwd])
        over = _node_fwd_over(out, one, wts, dname)
        expect(over <= 1.0, f"node sync {dname}: two halves in one process "
               f"against the one-process kernel: {over:.3f} of the limit")
        parts = [b.outputs() for b in bwd]
        _, bwd_rel, _ = _node_grads_within(
            ([torch.cat([p[0][e] for p in parts]) for e in range(edges)],
             *(sum(p[i] for p in parts) for i in (1, 2, 3))), one_bwd,
            _node_bwd_tols(edges, dname))
        errs = {"mixed_node_fwd_sync": float((out - one).abs().max()),
                "mixed_node_bwd_sync": bwd_rel}
        del one, obuf, stat, one_bwd, parts
        f0, b0 = fwd[0], bwd[0]
        # the backward first: a timed call's sums are not added to the
        # other half's, so what it leaves is not read again
        for name, launches, plain, (b_ms, by) in (
                ("mixed_node_bwd_sync", (b0.r, b0.s, b0.x),
                 lambda: M.mixed_node_bwd_plain(xs[0], nodes, wts, gs[0],
                                                cs),
                 node_bwd_bound(half, h, w, cs, edges, dname)),
                ("mixed_node_fwd_sync", (f0.a, f0.b, f0.z),
                 lambda: M.mixed_node_plain(xs[0], nodes, wts, cs),
                 node_bound(half, h, w, cs, edges, dname))):
            fns = dict(zip(SYNC_NODE_KERNELS[name][0], launches))

            def whole(launches=launches):
                for f in launches:
                    f()

            r = {"err": errs[name], "bound_ms": b_ms, "bound_by": by,
                 "library_ms": None, "ms": time_ms(whole),
                 "plain_ms": time_ms(plain, reps=3, warmup=1),
                 "launch_ms": {k: time_ms(f) for k, f in fns.items()}}
            tag = (f"{name} {cell} {h}x{w} Cs={cs} E={edges} N={half} (a "
                   f"rank's half of {PARALLEL_BATCH}) {dname}")
            log(f"kernel {tag}: {_times(r)}; launches "
                + ", ".join(f"{k} {v:.3f} ms"
                            for k, v in r["launch_ms"].items())
                + "; max_abs_err (backward: of each gradient's scale) of "
                "the two halves against the one-process kernel on the "
                "whole batch")
            if dname == "bfloat16":
                r["device_us"] = _sync_device_us(tag, whole)
                r["launch_device_us"] = {k: _sync_device_us(k, f)
                                         for k, f in fns.items()}
                rows[name] = r
    return rows


def check_sync_node_ranks(gloo, device) -> dict:
    """The ranks' data-parallel node calls (sync_node_ranks): each within
    phase 2's limits of its plain version under the process group, its
    second call the same bits, the two ranks' statistics the same bits;
    then the two ranks together against the one-process kernel on the
    global batch (the outputs and dx concatenated, the gradient shares
    summed) at the same limits. An inner ReLU input within an ulp of 0 can
    fall on either side in two orders of the statistics' sums (ROADMAP.md
    section 3, the node backward's fp32 dx): where the backward is beyond
    the limit, it passes only if some inner ReLU decision of the ranks
    differs from the one-process kernel's and the ranks' gradients are
    within the limit of the plain backward on the global batch that takes
    the ranks' decisions. -> {dtype: (forward error, backward error relative to
    scale)}, the worst rank's against its plain version."""
    from lctvqa_torch.ops import cuda_mixedop as M

    xs_all, nodes, wts, g = sync_node_inputs(device)
    cs = g.shape[-1]
    worst = {}
    for dname, dtype in DTYPES.items():
        per = [out["node"][dname] for out in gloo]
        for r, res in enumerate(per):
            tag = f"parallel gloo rank {r} node sync {dname}"
            expect(res["fwd_over"] <= 1.0, f"{tag}: forward off the plain "
                   f"version by {res['fwd_over']:.3f} of the limit")
            expect(res["bwd_ok"] and res["dtype_ok"], f"{tag}: a gradient "
                   f"off the plain version's by {res['bwd_err']} of its "
                   "scale")
            expect(res["same_bits"], f"{tag}: two calls differ")
        expect(torch.equal(per[0]["stat"], per[1]["stat"]),
               f"node sync {dname}: the ranks' statistics differ")
        worst[dname] = (max(res["fwd_err"] for res in per),
                        max(res["bwd_err"] for res in per))
        xs = [x.to(dtype)[..., :cs] for x in xs_all]
        y1, obuf1, stat1 = M.node_fwd_launch(xs, nodes, wts, cs, device)
        want = M.node_bwd_launch(xs, nodes, wts, g.contiguous(), obuf1,
                                 stat1, cs, device)
        got = ([torch.cat([res["dx"][e] for res in per]).to(device)
                for e in range(len(xs))],
               *(sum(res["shares"][i] for res in per).to(device)
                 for i in range(3)))
        y = torch.cat([res["y"] for res in per]).to(device)
        fwd_over = _node_fwd_over(y, y1, wts, dname)
        tols = _node_bwd_tols(len(xs), dname)
        ok, rel, _ = _node_grads_within(got, want, tols)
        note = ""
        if not ok:
            kept = (torch.cat([res["obuf2"] for res in per], -1).to(device),
                    per[0]["stat"].to(device))
            flips = sum(int(((a > 0) != (b > 0)).sum())
                        for za, zb in zip(
                            M.sep_inner_inputs_kept(obuf1, stat1,
                                                    y1.shape[:3]),
                            M.sep_inner_inputs_kept(*kept, y1.shape[:3]))
                        for a, b in zip(za, zb))
            plain = M.mixed_node_bwd_plain(xs, nodes, wts, g, cs, kept=kept)
            ok2, rel2, _ = _node_grads_within(got, plain, tols)
            ok = flips > 0 and ok2
            note = (f"; beyond the limit with {flips} inner ReLU "
                    "decision(s) differing from the one-process kernel's, "
                    f"{rel2:.3e} of scale against the plain backward on "
                    "the global batch with the ranks' decisions")
        expect(fwd_over <= 1.0 and ok,
               f"node sync {dname} on two ranks against the one-process "
               f"kernel on the global batch: forward {fwd_over:.3f} of the "
               f"limit, gradients {rel:.3e} of scale{note}")
        log(f"node sync {dname} on two ranks: against the plain version "
            f"under the group forward {worst[dname][0]:.3e}, gradients "
            f"{worst[dname][1]:.3e} of scale; against the one-process "
            f"kernel on the global batch of {PARALLEL_BATCH} forward "
            f"{fwd_over:.3f} of the limit, gradients {rel:.3e} of "
            f"scale{note}")
        del obuf1, stat1, want, got
    return worst


def _snapshot(tree):
    """A copy of a parameter tree on its device."""
    from lctvqa_torch.optim.optimizers import tree_map

    return tree_map(lambda t: t.detach().clone(), tree)


def node_stage1(exp, train, ef0, arch0):
    """Stage 1 with the node kernels (pallas_mixed_op) on the Experiment's
    rows of the global train batch, from the EF and arch it started with
    (ef0, arch0), the launch counts set to 0 just before it and read just
    after. -> ({loss, counters, the EF after the step and the gradient its
    optimizer took, on the host, its lr}, launches)."""
    import dataclasses

    from lctvqa_torch.ops import _build
    from lctvqa_torch.parallel import mesh as mesh_lib
    from lctvqa_torch.train.steps import make_lct_steps

    cfg = dataclasses.replace(exp.cfg, model=dataclasses.replace(
        exp.cfg.model, pallas_mixed_op=True))
    steps = make_lct_steps(cfg, exp.ans_vocab.unk2idx, exp.device)
    batch = exp._to_device(mesh_lib.shard_batch(train, exp.mesh))
    opt = steps["ef_tx"].init(ef0)
    with identity_dropout(), optimizer_grads() as calls:
        _build.reset_launch_counts()
        p, _, loss, c1, c2 = steps["stage1"](ef0, arch0, opt, batch, exp.gen)
        torch.cuda.synchronize()
        launches = _build.launch_counts()
    expect(len(calls) == 1, f"node stage 1 made {len(calls)} optimizer "
           "steps, not 1")
    return ({"ef": _host_tree(p), "grads": _host_grads(ef0, calls[0]),
             "loss": float(loss), "counts": (int(c1), int(c2)),
             "lr": float(opt["lr"])}, launches)


def _node_stage1_agrees(tag, out, ref, ref_launches):
    """Stage 1 with the node kernels under a process group against one
    process's: the loss within PARALLEL_LOSS_RTOL, the counters equal, the
    gradient within phase 8's limit, the EF within test_mesh's tolerances
    with the 2-lr rule of _trees_close; the rank launched every
    data-parallel node kernel and not the one-process ones, one process
    the reverse."""
    got, launches = out["node_stage1"], out["node_launches"]
    expect(abs(got["loss"] - ref["loss"]) <= PARALLEL_LOSS_RTOL
           * abs(ref["loss"]), f"{tag}: loss {got['loss']} vs {ref['loss']}")
    expect(got["counts"] == ref["counts"],
           f"{tag}: counters {got['counts']} vs {ref['counts']}")
    _grads_agree(got["grads"], ref["grads"],
                 f"{tag} EF gradient vs one process")
    _trees_close(got["ef"], ref["ef"], PARALLEL_PARAM_TOL,
                 f"{tag} EF vs one process", grads=ref["grads"],
                 lr=ref["lr"])
    for name in SYNC_NODE_LAUNCHES:
        expect(launches[name] > 0, f"{tag}: {name} never launched")
        expect(ref_launches[name] == 0,
               f"one process's node stage 1 launched {name}")
    for name in ("mixed_node_fwd", "mixed_node_bwd"):
        expect(launches[name] == 0, f"{tag}: {name} launched under data "
               "parallelism")
        expect(ref_launches[name] > 0,
               f"one process's node stage 1 never launched {name}")
    log(f"{tag}: loss {got['loss']:.6f} (one process {ref['loss']:.6f}); "
        "launches " + ", ".join(f"{k} {launches[k]}"
                                for k in SYNC_NODE_LAUNCHES))


def _parallel_rank(rank: int, world: int, port: int, backend: str,
                   label: str, device: str, tmp: str) -> None:
    """One rank of phase 13 (a spawned process): `world` ranks of
    `backend` on `device`, its results in `tmp`/<label><rank>.pt. The two
    "dp" ranks: the sync BatchNorm and the data-parallel node calls on
    their rows, then the main path on their rows, then stage 1 with the
    node kernels from the same start; the "one" rank (NCCL on the card):
    the main path on the whole batch."""
    import traceback

    from lctvqa_torch.data import pipeline
    from lctvqa_torch.ops import conv
    from lctvqa_torch.parallel import distributed
    from lctvqa_torch.parallel import mesh as mesh_lib
    from lctvqa_torch.train.experiment import Experiment

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        distributed.initialize(f"localhost:{port}", world, rank,
                               device=device, backend=backend)
        conv.USE_PALLAS_BN = True
        arrays = train_arrays()
        train, valid = parallel_batches(arrays)
        out = {}
        if label == "dp":
            rows = mesh_lib.shard_rows(PARALLEL_BATCH,
                                       mesh_lib.make_mesh(world))
            out["bn"], out["bn_ms"] = sync_bn_ranks(device, rows)
            out["node"] = sync_node_ranks(device, rows)
        exp = Experiment(parallel_config(tmp, f"parallel_{label}"),
                         device=device,
                         data=pipeline.loader_from_arrays(arrays))
        start = _snapshot(exp.ef_params), _snapshot(exp.arch)
        out["result"], out["launches"], out["ms"] = parallel_steps(
            exp, train, valid)
        if label == "dp":
            out["node_stage1"], out["node_launches"] = node_stage1(
                exp, train, *start)
        out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                           if device.type == "cuda" else 0.0)
        torch.save(out, Path(tmp) / f"{label}{rank}.pt")
    except BaseException:
        (Path(tmp) / f"{label}{rank}.err").write_text(
            traceback.format_exc())
        raise
    finally:
        distributed.shutdown()


def check_sync_bn_kernels(device, time_fn=time_ms):
    """The four two-launch BatchNorm kernels at a rank's half of each
    supernet shape against their plain versions on the same inputs, their
    grid the card's (lctvqa_bn_sync_plan) and two calls the same bits.
    Limits: the sums 1e-5 of the sum of the terms' magnitudes (the order
    of an fp32 sum of up to 131,072 terms); y as phase 2's bn_fwd (fp32
    1e-5 + 1e-5 |plain|, bf16 1e-5 + 2^-7 |plain|); dx as phase 2's bn_bwd
    (1e-5 of its scale). -> {name: row at SYNC_BN_ROW}."""
    from lctvqa_torch.ops import cuda_bn

    rows = {}
    props = torch.cuda.get_device_properties(device)
    for shape, (xb, gb) in sync_bn_inputs(device).items():
        half = slice(0, shape[0] // PARALLEL_RANKS)
        for a, b in SYNC_BN_DTYPES:
            x, g = xb[half].to(DTYPES[a]), gb[half].to(DTYPES[b])
            c = x.shape[-1]
            m = x.numel() // c
            count = m * PARALLEL_RANKS
            tag = f"sync bn {list(x.shape)} {a} {b}"
            for gd in (None, g.dtype):
                want = cuda_bn.sync_plan(m, c, x.dtype, gd,
                                         props.multi_processor_count)
                got = cuda_bn.sync_plan_on_device(m, c, x.dtype, gd, device)
                expect(got == want, f"{tag}: the card's grid {got}, "
                       f"sync_plan's {want}")
            x32, g32 = x.float().reshape(-1, c), g.float().reshape(-1, c)
            sums = cuda_bn.bn_sums(x)
            want = cuda_bn.bn_sums_plain(x)
            scale = torch.stack([x32.abs().sum(0), (x32 * x32).sum(0)])
            err_s = float(((sums - want).abs() / scale).max())
            y, stat = cuda_bn.bn_fwd_apply(x, want, count, DTYPES[b])
            y_p, stat_p = cuda_bn.bn_fwd_apply_plain(x, want, count,
                                                     DTYPES[b])
            bsums = cuda_bn.bn_bwd_sums(x, g, stat_p)
            bwant = cuda_bn.bn_bwd_sums_plain(x, g, stat_p)
            xhat = (x32 - stat_p[0]) * stat_p[1]
            bscale = torch.stack([g32.abs().sum(0),
                                  (g32 * xhat).abs().sum(0)])
            err_b = float(((bsums - bwant).abs() / bscale).max())
            dx = cuda_bn.bn_bwd_apply(x, g, stat_p, bwant, count)
            dx_p = cuda_bn.bn_bwd_apply_plain(x, g, stat_p, bwant, count)
            again = (cuda_bn.bn_sums(x), cuda_bn.bn_bwd_sums(x, g, stat_p),
                     cuda_bn.bn_fwd_apply(x, want, count, DTYPES[b])[0],
                     cuda_bn.bn_bwd_apply(x, g, stat_p, bwant, count))
            torch.cuda.synchronize()
            diff = (y.float() - y_p.float()).abs()
            lim = (1e-5 + 1e-5 * y_p.float().abs() if b == "float32"
                   else 1e-5 + 2.0 ** -7 * y_p.float().abs())
            err_dx, dscale = _grad_err(dx, dx_p)
            expect(err_s <= 1e-5 and err_b <= 1e-5,
                   f"{tag}: sums off by {err_s} (forward), {err_b} "
                   "(backward) of their terms' magnitude")
            expect(bool((diff <= lim).all()) and torch.allclose(
                stat, stat_p, rtol=1e-5, atol=0.0) and y.dtype == DTYPES[b],
                f"{tag}: forward apply off by {float(diff.max())}")
            expect(err_dx <= 1e-5 * dscale and dx.dtype == x.dtype,
                   f"{tag}: backward apply off by {err_dx} (scale {dscale})")
            expect(all(torch.equal(p, q) for p, q in zip(
                again, (sums, bsums, y, dx))), f"{tag}: two calls differ")
            log(f"{tag}: sums err {err_s:.2e} / {err_b:.2e} of their terms' "
                f"magnitude, y {float(diff.max()):.2e}, dx {err_dx:.2e} "
                f"(scale {dscale:.2e})")
            if (tuple(x.shape), a, b) != SYNC_BN_ROW:
                continue
            n = x.numel()
            ex, eg = x.element_size(), g.element_size()
            nchw = x.permute(0, 3, 1, 2)
            gl = g.to(x.dtype).permute(0, 3, 1, 2)
            mean, invstd = stat_p[0].contiguous(), stat_p[1].contiguous()
            cnt = torch.full((PARALLEL_RANKS,), m, dtype=torch.int32,
                             device=device)
            calls = {
                "bn_fwd_sums": (
                    lambda: cuda_bn.bn_sums(x),
                    lambda: cuda_bn.bn_sums_plain(x),
                    lambda: torch.batch_norm_stats(nchw, cuda_bn.EPS),
                    bound(n * ex, 3 * n, "float32"), err_s),
                "bn_fwd_apply": (
                    lambda: cuda_bn.bn_fwd_apply(x, want, count, DTYPES[b]),
                    lambda: cuda_bn.bn_fwd_apply_plain(x, want, count,
                                                       DTYPES[b]),
                    lambda: torch.batch_norm_elemt(nchw, None, None, mean,
                                                   invstd, cuda_bn.EPS),
                    bound(n * (ex + y.element_size()), 2 * n, "float32"),
                    float(diff.max())),
                "bn_bwd_sums": (
                    lambda: cuda_bn.bn_bwd_sums(x, g, stat_p),
                    lambda: cuda_bn.bn_bwd_sums_plain(x, g, stat_p),
                    lambda: torch.batch_norm_backward_reduce(
                        gl, nchw, mean, invstd, None, True, False, False),
                    bound(n * (ex + eg), 5 * n, "float32"), err_b),
                "bn_bwd_apply": (
                    lambda: cuda_bn.bn_bwd_apply(x, g, stat_p, bwant, count),
                    lambda: cuda_bn.bn_bwd_apply_plain(x, g, stat_p, bwant,
                                                       count),
                    lambda: torch.batch_norm_backward_elemt(
                        gl, nchw, mean, invstd, None, bwant[0].contiguous(),
                        bwant[1].contiguous(), cnt),
                    bound(n * (2 * ex + eg), 6 * n, "float32"), err_dx)}
            for name, (fn, plain, lib, (b_ms, by), err) in calls.items():
                r = rows[name] = {"err": err, "bound_ms": b_ms,
                                  "bound_by": by, "ms": time_fn(fn),
                                  "plain_ms": time_fn(plain),
                                  "library_ms": _library_ms(lib)}
                log(f"kernel {name} {list(x.shape)} {a} {b}: {_times(r)}")
                if time_fn is time_ms:  # device time, the memset included
                    r["device_us"] = _sync_device_us(name, fn)
                    r["library_device_us"] = _sync_device_us(
                        f"{name}'s library call", lib)
    return rows


def _sync_device_us(tag, fn, tries=3):
    """The device time of a sync kernel or of its library call
    (informational): up to `tries` profiles, each miss logged, and None
    where none saw a kernel (PERF.md, open questions: the profiler on the
    card's machine now and then sees no kernel in a profile) or where
    this PyTorch does not take the library call's signature."""
    for i in range(tries):
        try:
            total, rows = device_times(fn, required=False)
        except (RuntimeError, NotImplementedError, TypeError,
                AttributeError) as e:
            log(f"device time {tag}: not profiled: {type(e).__name__}: {e}")
            return None
        if total is not None:
            _device_line(tag, total, rows)
            return total
        log(f"device time {tag}: profile {i + 1} of {tries} saw no kernel")
    log(f"device time {tag}: not measured")
    return None


def _library_ms(fn):
    """time_library of a yardstick whose signature this PyTorch may not
    take (the SyncBatchNorm building blocks); None, logged, where not."""
    try:
        return time_library(fn)
    except (TypeError, AttributeError) as e:
        log(f"library call not timed: {type(e).__name__}: {e}")
        return None


def _same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _trees_close(got, want, tol, tag, grads=None, lr=0.0):
    """Every leaf of `got` within (rtol, atol) of `want`'s. With `grads`
    (one process's gradient of the Adam step that made `want`, by leaf)
    and that step's `lr`, an element beyond that limit passes only where
    that gradient lies within phase 8's limit of summation-order noise
    (TRAIN_GRAD_TOL of its leaf's scale plus TRAIN_GRAD_FLOOR of the
    largest leaf's), and then by at most 2 lr beyond the limit. Adam's
    first update is lr g / (|g| + 1e-8): it keeps g's sign and loses its
    size, so where g is noise the two runs' updates may differ by up to
    2 lr (2e-3), two orders above atol, and by no more."""
    rtol, atol = tol
    top = max(float(g.abs().max()) for g in grads) if grads else 0.0
    worst, beyond, elems, moved = 0.0, 0, 0, 0.0
    for i, (a, b) in enumerate(zip(_leaves(got), _leaves(want))):
        diff = (a - b).abs()
        limit = atol + rtol * b.abs()
        off = diff > limit
        over = float((diff / limit).max())
        worst = max(worst, over)
        elems += b.numel()
        ok = a.shape == b.shape and bool(torch.isfinite(a).all())
        if grads is not None and bool(off.any()):
            g = grads[i].abs()
            noise = TRAIN_GRAD_TOL * float(g.max()) + TRAIN_GRAD_FLOOR * top
            beyond += int(off.sum())
            past = float((diff - limit)[off].max())
            moved = max(moved, past)
            ok = ok and bool((g[off] <= noise).all()) and past <= 2 * lr
        else:
            ok = ok and over <= 1.0
        expect(ok, f"{tag}: leaf {i} {tuple(a.shape)} off by {over:.3f} of "
               f"its limit (rtol {rtol}, atol {atol})"
               + (f" at an element whose gradient is not noise, or by more "
                  f"than 2 lr ({2 * lr:g}) beyond it"
                  if grads is not None else ""))
    log(f"{tag}: {len(_leaves(want))} leaves, worst {worst:.3f} of the limit "
        f"(rtol {rtol}, atol {atol})"
        + (f"; {beyond} of {elems} elements beyond it, each where one "
           "process's gradient is within phase 8's noise limit, the "
           f"farthest {moved:.3e} beyond it (bound 2 lr = {2 * lr:g}: "
           "Adam's first step)" if grads is not None else ""))


def _parallel_agrees(tag, out, ref):
    """One run of the main path under a process group against one
    process's: the losses within PARALLEL_LOSS_RTOL, the counters equal,
    each step's gradient within phase 8's limit (stage 3's arch, stage
    1's EF, stage 2's W heads), the params within test_mesh's
    tolerances, and what launched."""
    got = out["result"]
    for k in ("stage3", "stage1", "stage2", "eval"):
        expect(abs(got[k] - ref[k]) <= PARALLEL_LOSS_RTOL * abs(ref[k]),
               f"{tag}: {k} loss {got[k]} vs {ref[k]}")
    expect(got["counts"] == ref["counts"],
           f"{tag}: counters {got['counts']} vs {ref['counts']}")
    log(f"{tag}: losses stage 3 {got['stage3']:.6f}, stage 1 "
        f"{got['stage1']:.6f}, stage 2 {got['stage2']:.6f}, eval "
        f"{got['eval']:.6f} (one process {ref['stage3']:.6f}, "
        f"{ref['stage1']:.6f}, {ref['stage2']:.6f}, {ref['eval']:.6f}); "
        f"launches { {k: v for k, v in out['launches'].items() if v} }; "
        f"train_step {out['ms']:.1f} ms; peak {out['peak_gib']:.2f} GiB")
    for name in PARALLEL_LAUNCHED:
        expect(out["launches"][name] > 0, f"{tag}: {name} never launched")
    for name in PARALLEL_NOT_LAUNCHED:
        expect(out["launches"][name] == 0,
               f"{tag}: {name} launched under data parallelism")
    for tree, step in (("arch", "stage-3 arch"), ("ef", "stage-1 EF"),
                       ("w_heads", "stage-2 W-head")):
        _grads_agree(got["grads"][tree], ref["grads"][tree],
                     f"{tag} {step} gradient vs one process")
    _trees_close(got["ef"], ref["ef"], PARALLEL_PARAM_TOL,
                 f"{tag} EF after stages 3, 1 vs one process",
                 grads=ref["grads"]["ef"], lr=ref["ef_lr"])
    _trees_close(got["w_heads"], ref["w_heads"], PARALLEL_PARAM_TOL,
                 f"{tag} W heads after stage 2")
    _trees_close(got["arch"], ref["arch"], PARALLEL_ARCH_TOL,
                 f"{tag} arch after stage 3")


def parallel_phase(arrays, device, root: str, card: str) -> dict:
    """Phase 13: the sync BatchNorm kernels against their plain versions
    (timed with the card to themselves); then, spawned, two gloo ranks on
    cuda:0 and one NCCL rank, while this process runs the main path with
    no process group on the card as the reference; the ranks against it.
    -> the sync kernels' rows of the kernels line."""
    import multiprocessing

    from lctvqa_torch.data import pipeline
    from lctvqa_torch.ops import conv, cuda_bn
    from lctvqa_torch.parallel import distributed
    from lctvqa_torch.parallel import mesh as mesh_lib
    from lctvqa_torch.train.experiment import Experiment

    t0 = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    was = conv.USE_PALLAS_BN
    tmp = tempfile.mkdtemp(dir=root)
    ctx = multiprocessing.get_context("spawn")
    on = f"{device.type}:0" if device.type == "cuda" else "cpu"
    # (rank, world, backend, label): NCCL where there is a card
    runs = [(r, PARALLEL_RANKS, "gloo", "dp") for r in range(PARALLEL_RANKS)]
    runs.append((0, 1, "nccl" if device.type == "cuda" else "gloo", "one"))
    ports = {"dp": distributed.free_port(), "one": distributed.free_port()}
    procs = []
    try:
        rows = check_sync_bn_kernels(device)
        rows.update(sync_node_launch_times(device))
        # the ranks start up while this process runs the reference
        procs = [ctx.Process(target=_parallel_rank,
                             args=(r, w, ports[label], be, label, on, tmp))
                 for r, w, be, label in runs]
        for p in procs:
            p.start()
        conv.USE_PALLAS_BN = True
        train, valid = parallel_batches(arrays)
        exp = Experiment(parallel_config(root, "parallel_ref"),
                         device=device,
                         data=pipeline.loader_from_arrays(arrays))
        start = _snapshot(exp.ef_params), _snapshot(exp.arch)
        ref, ref_launches, ref_ms = parallel_steps(exp, train, valid)
        node_ref, node_ref_launches = node_stage1(exp, train, *start)
        del exp, start
        one_launch = {}
        for shape, (xb, gb) in sync_bn_inputs(device).items():
            for a, b in SYNC_BN_DTYPES:
                x, g = xb.to(DTYPES[a]), gb.to(DTYPES[b])
                y, stat, _ = cuda_bn.batchnorm_fwd_stat(x, DTYPES[b])
                one_launch[(shape, a, b)] = (
                    y.cpu(), stat.cpu(), cuda_bn.batchnorm_bwd(x, g,
                                                               stat).cpu())
        torch.cuda.empty_cache()
        log(f"parallel reference (one process, B={PARALLEL_BATCH}): "
            f"launches { {k: v for k, v in ref_launches.items() if v} }, "
            f"train_step {ref_ms:.1f} ms (informational: the ranks start "
            "up on the same card meanwhile)")
        deadline = time.perf_counter() + PARALLEL_JOIN_SECONDS
        for p in procs:
            p.join(max(deadline - time.perf_counter(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        conv.USE_PALLAS_BN = was
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    for (r, _, be, label), p in zip(runs, procs):
        err = Path(tmp) / f"{label}{r}.err"
        expect(p.exitcode == 0, f"parallel {label} rank {r} ({be}) exited "
               f"with {p.exitcode}" + (f":\n{err.read_text()}"
                                       if err.exists() else ""))
    if any(p.exitcode != 0 for p in procs):
        return {}
    gloo = [torch.load(Path(tmp) / f"dp{r}.pt", weights_only=False)
            for r in range(PARALLEL_RANKS)]
    nccl = torch.load(Path(tmp) / "one0.pt", weights_only=False)

    # the sync BatchNorm on two ranks: its plain versions summed over the
    # two halves, and one rank's one-launch kernel on the whole batch
    worst = {"plain": 0.0, "one_launch": 0.0}
    for (shape, a, b), (y1, stat1, dx1) in one_launch.items():
        xb, gb = (t.cpu() for t in sync_bn_inputs("cpu")[shape])
        x, g = xb.to(DTYPES[a]), gb.to(DTYPES[b])
        halves = [mesh_lib.shard_rows(shape[0],
                                      mesh_lib.Mesh(r, PARALLEL_RANKS))
                  for r in range(PARALLEL_RANKS)]
        count = x.numel() // x.shape[-1]  # the global batch's rows
        sums = sum(cuda_bn.bn_sums_plain(x[h]) for h in halves)
        for r, h in enumerate(halves):
            y, stat, dx = gloo[r]["bn"][(shape, a, b)]
            y_p, stat_p = cuda_bn.bn_fwd_apply_plain(x[h], sums, count,
                                                     DTYPES[b])
            bsums = sum(cuda_bn.bn_bwd_sums_plain(x[k], g[k], stat_p)
                        for k in halves)
            dx_p = cuda_bn.bn_bwd_apply_plain(x[h], g[h], stat_p, bsums,
                                              count)
            for kind, (yw, dxw) in (("plain", (y_p, dx_p)),
                                    ("one_launch", (y1[h], dx1[h]))):
                lim = (1e-5 + 1e-5 * yw.float().abs() if b == "float32"
                       else 1e-5 + 2.0 ** -7 * yw.float().abs())
                over_y = float(((y.float() - yw.float()).abs() / lim).max())
                err_dx, dscale = _grad_err(dx, dxw)
                over = max(over_y, err_dx / max(1e-5 * dscale, 1e-30))
                worst[kind] = max(worst[kind], over)
                expect(over <= 1.0, f"sync bn on two ranks {shape} {a} {b} "
                       f"rank {r} against {kind}: {over:.3f} of the limit")
    log(f"sync bn on two ranks at {len(SYNC_BN_SHAPES)} shapes: worst "
        f"{worst['plain']:.3f} of the limit against the plain versions, "
        f"{worst['one_launch']:.3f} against the one-launch kernel on the "
        f"whole batch; a whole call (sums, gloo all-reduce, apply) at "
        f"{list(SYNC_BN_SHAPES[1])} {SYNC_BN_DTYPES[1]}: forward "
        f"{gloo[0]['bn_ms']['fwd']:.3f} ms, backward "
        f"{gloo[0]['bn_ms']['bwd']:.3f} ms on rank 0 (informational: two "
        f"ranks share one card)")

    # the node kernels' data-parallel mode on two ranks
    node_err = check_sync_node_ranks(gloo, device)
    ms = gloo[0]["node"]["call_ms"]
    log(f"node sync on two ranks, a whole call with its gloo all-reduces "
        f"at a rank's half of {SYNC_NODE_CASE} bfloat16 on rank 0: forward "
        f"{ms['fwd']:.3f} ms (plain version {ms['plain_fwd']:.3f} ms), "
        f"backward {ms['bwd']:.3f} ms (plain version {ms['plain_bwd']:.3f} "
        "ms) (informational: two ranks share one card)")

    # the main path on two gloo ranks, and on one NCCL rank, against one
    # process with no process group; stage 1 with the node kernels
    for r, out in enumerate(gloo):
        _parallel_agrees(f"parallel gloo rank {r}", out, ref)
        _node_stage1_agrees(f"parallel gloo rank {r} node stage 1", out,
                            node_ref, node_ref_launches)
    a, b = (out["result"] for out in gloo)
    for tree in ("ef", "arch", "w_heads"):
        expect(_same_bits(a[tree], b[tree]),
               f"parallel: the two ranks' {tree} differ")
    expect(_same_bits(*(out["node_stage1"]["ef"] for out in gloo)),
           "parallel: the two ranks' EF after node stage 1 differ")
    _parallel_agrees("parallel nccl (one rank)", nccl, ref)
    log(f"parallel train_step (stages 1 and 2) at B={PARALLEL_BATCH}: one "
        f"process {ref_ms:.1f} ms, two gloo ranks on one card "
        + ", ".join(f"{out['ms']:.1f}" for out in gloo) + " ms, one NCCL "
        f"rank {nccl['ms']:.1f} ms (informational: the ranks share one "
        f"card) on {card}")
    log(f"parallel phase took {time.perf_counter() - t0:.1f} s")
    for name, row in rows.items():
        if name not in SYNC_NODE_KERNELS:
            row["launches"] = gloo[0]["launches"][name]
            continue
        counts = {k: gloo[0]["node_launches"][k]
                  for k in SYNC_NODE_KERNELS[name][0]}
        expect(len(set(counts.values())) == 1,
               f"{name}: its launches ran unequal times {counts}")
        fwd = name == "mixed_node_fwd_sync"
        row.update(launches=max(counts.values()), launch_counts=counts,
                   err=node_err["bfloat16"][0 if fwd else 1],
                   call_ms=ms["fwd" if fwd else "bwd"],
                   plain_call_ms=ms["plain_fwd" if fwd else "plain_bwd"])
    return rows


# ---------------------------------------------------------------------------
# phase 14: the data path, from the raw files to a batch on the card
# ---------------------------------------------------------------------------

# the answer vocabulary at full width (ModelConfig.ans_vocab_size)
DATA_ANSWERS = 1000
# the C++ gather at the main path's batch (786 KB: one thread, under the
# core's 1 MiB threshold) and at 224 px (9.6 MB: the threaded copy)
GATHER_SHAPES = ((64, 64, 64, 3), (64, 224, 224, 3))
GATHER_TABLE_ROWS = 256
DATA_WORKERS = 8
SAMPLE_SEEDS = (SEED, 1, 2 ** 62 - 1)
DATA_STEPS = 3


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it (its model name where that
    is given, else its vendor, family, model and stepping numbers), its
    architecture and its core count."""
    import platform

    model = "model not reported"
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as f:
            fields = {}
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
        if fields.get("model name", "unknown") != "unknown":
            model = fields["model name"]
        elif "vendor_id" in fields:
            model = ", ".join(f"{k} {fields.get(k)}" for k in (
                "vendor_id", "cpu family", "model", "stepping"))
    return f"{model} ({platform.machine()}), {os.cpu_count()} cores"


def _build_cli(*argv, ok=True):
    """python -m lctvqa_torch.data.build ... from the repo root; ->
    (returncode, stdout, stderr). Fails the phase where the exit code is
    not what `ok` says."""
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    expect((proc.returncode == 0) == ok,
           f"{' '.join(argv[:2])}: exit code {proc.returncode}, stderr "
           f"{proc.stderr[-2000:]}")
    return proc


def data_builders(root: Path) -> None:
    """(a) The offline builders from the raw jsons, as subprocesses: the
    vocabularies and the npy records against make_npy_records' (and
    data/vocab.py's) for the same seed and sizes; the h5 and resize
    builders where h5py and PIL import, else their ImportError."""
    import importlib.util

    from lctvqa_torch.data import synthetic, vocab

    raw, ref, out = root / "raw", root / "ref", root / "built"
    synthetic.write_raw_vqa_json(str(raw), **TRAIN_DATA, seed=SEED)
    synthetic.make_npy_records(str(ref), **TRAIN_DATA,
                               n_answers=DATA_ANSWERS, seed=SEED)
    vocab.make_vocab_questions(str(ref / "Questions"),
                               str(ref / "vocab_questions.txt"))
    vocab.make_vocab_answers(str(ref / "Annotations"),
                             str(ref / "vocab_answers.txt"),
                             n_answers=DATA_ANSWERS)
    build = "lctvqa_torch.data.build"
    _build_cli(build, "vocab", "--input_dir", str(raw), "--output_dir",
               str(out), "--n_answers", str(DATA_ANSWERS))
    _build_cli(build, "npy", "--input_dir", str(raw), "--image_dir",
               str(ref), "--output_dir", str(out))
    for name in ("vocab_questions.txt", "vocab_answers.txt",
                 "vocab_unified.txt"):
        expect((out / name).read_bytes() == (ref / name).read_bytes(),
               f"data: build vocab's {name} differs from data/vocab.py's")
    for name in ("train.npy", "valid.npy"):
        got = np.load(out / name, allow_pickle=True).tolist()
        want = np.load(ref / name, allow_pickle=True).tolist()
        expect(got == want and len(got) == TRAIN_DATA["num_questions"],
               f"data: build npy's {name} differs from make_npy_records'")
    urls = _build_cli("lctvqa_torch.data.download", "--list_only")
    expect(len(urls.stdout.split()) == 8, "data: download --list_only "
           f"printed {urls.stdout!r}")
    missing = [m for m in ("h5py", "PIL")
               if importlib.util.find_spec(m) is None]
    if missing:
        # the documented skip: these builders need h5py and PIL, which
        # this machine lacks; tests/test_torch_data_build.py runs them
        names = " and ".join(missing)
        log(f"data: images_h5, qa_h5 and resize not run: {names} not "
            "installed on this machine (the CPU tests hold them to the JAX "
            "package's builders)")
        if "h5py" in missing:
            proc = _build_cli(build, "qa_h5", "--input_dir", str(raw),
                              "--output_dir", str(out), ok=False)
            expect("No module named 'h5py'" in proc.stderr,
                   f"data: qa_h5 without h5py: {proc.stderr[-500:]}")
    else:
        import h5py
        from PIL import Image

        rng = np.random.default_rng(SEED)
        for si, split in enumerate(("train2014", "val2014")):
            (raw / split).mkdir()
            for i in range(8):
                Image.fromarray(rng.integers(0, 256, (40, 52, 3),
                                             dtype=np.uint8)).save(
                    raw / split / f"COCO_{split}_{1000 * (si + 1) + i:012d}"
                    ".jpg")
        _build_cli(build, "images_h5", "--train_dir", str(raw / "train2014"),
                   "--val_dir", str(raw / "val2014"), "--output_dir",
                   str(out), "--size", "64")
        _build_cli(build, "qa_h5", "--input_dir", str(raw), "--output_dir",
                   str(out))
        resized = _build_cli(build, "resize", "--input_dir", str(raw),
                             "--output_dir", str(root / "resized"),
                             "--size", "32")
        n_ans = len((out / "vocab_answers.txt").read_text().splitlines())
        with h5py.File(out / "images.h5") as im, \
                h5py.File(out / "qst-ans.h5") as qa:
            shapes = (im["train/images"].shape, qa["train/enc_qst"].shape,
                      qa["train/enc_ans"].shape)
        expect(shapes == ((8, 64, 64, 3), (TRAIN_DATA["num_questions"], 25),
                          (TRAIN_DATA["num_questions"], n_ans)),
               f"data: the h5 files' shapes {shapes}")
        expect("resized 16 images" in resized.stdout,
               f"data: resize printed {resized.stdout!r}")
        log("data: images_h5, qa_h5 and resize ran")
    log("data: the offline builders' files equal make_npy_records' and "
        "data/vocab.py's")


def _host_ms(fn, reps: int = 20) -> float:
    """Median host-clock ms of `fn` (host work only: no device)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def check_native_core(arrays, card: str) -> None:
    """(b) The C++ core built from the port's source on this host: the
    row gather bit for bit against numpy at the main path's batch and at
    224 px (8 threads), the answer draw against the plain splitmix64 on
    full-width enc_ans; ms per batch printed (informational)."""
    from lctvqa_torch import native
    from lctvqa_torch.native import build as nbuild

    t0 = time.perf_counter()
    fresh = not nbuild.library_path().exists()
    expect(native.available(), "data: the C++ core did not load")
    log(f"data: C++ core {Path(native._lib._name).name} "
        f"{'built' if fresh else 'found built'} in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED)
    cpu = host_cpu()
    for shape in GATHER_SHAPES:
        table = (arrays["train"]["images"] if shape[1:] == arrays["train"][
            "images"].shape[1:] else rng.integers(
                0, 256, (GATHER_TABLE_ROWS,) + shape[1:], dtype=np.uint8))
        rows = rng.integers(0, len(table), shape[0]).astype(np.int32)
        want = native.gather_rows_plain(table, rows)
        for threads in (1, DATA_WORKERS):
            got = native.gather_rows(table, rows, num_threads=threads)
            expect(got.shape == shape and np.array_equal(got, want),
                   f"data: gather_rows {shape} at {threads} threads differs "
                   "from numpy")
        ms = {t: _host_ms(lambda t=t: native.gather_rows(table, rows, t))
              for t in (1, 2, 4, DATA_WORKERS)}
        np_ms = _host_ms(lambda: table[rows])
        log(f"data: gather {list(shape)} uint8 ({want.nbytes / 1e6:.2f} MB): "
            "C++ " + ", ".join(f"{t} thread(s) {v:.4f}"
                               for t, v in ms.items())
            + f" ms, numpy {np_ms:.4f} ms a batch (host clock, median of 20; "
            f"informational) on {cpu}; card {card}")
    enc = np.ascontiguousarray(arrays["train"]["enc_ans"][:64])
    enc[::8] = 0                             # items with no valid answer
    expect(enc.shape == (64, DATA_ANSWERS), f"data: enc_ans {enc.shape}")
    for seed in SAMPLE_SEEDS:
        got = native.sample_answers(enc, 0, seed)
        want = native.sample_answers_plain(enc, 0, seed)
        expect(all(np.array_equal(g, w) for g, w in zip(got, want))
               and (got[0][::8] == 0).all() and (got[1][::8] == -1).all(),
               f"data: sample_answers seed {seed} differs from the plain "
               "splitmix64")
    log(f"data: sample_answers on [64, {DATA_ANSWERS}] equal to the plain "
        f"version for seeds {SAMPLE_SEEDS}; "
        f"{_host_ms(lambda: native.sample_answers(enc, 0, SEED)):.4f} ms a "
        "batch (informational)")


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def data_main_path(arrays, device, root: str, card: str,
                   steps: int = DATA_STEPS) -> dict:
    """(c) The LCT main path at full width (phase 8's: the darts
    supernet, stage 3 off, B = 64, bf16) with the kernel flags, fed by
    the loader's native route (cfg.data.num_workers = 8 threads) through
    the Prefetcher: `steps` stage-1 + stage-2 steps, the counts set to 0
    just before and read just after. Every consumed batch equal to the
    plain route's, finite losses, each stage-1 step's launches
    STAGE1_LAUNCHES and an LSTM kernel, stage 2 an LSTM kernel. ->
    launches of the run."""
    from lctvqa_torch.data import pipeline
    from lctvqa_torch.ops import _build
    from lctvqa_torch.train.experiment import Experiment

    tag = "data main path"
    cfg = train_config("bfloat16", "kernels", root).replace(
        exp_name="data_path")
    expect(cfg.data.num_workers == DATA_WORKERS,
           f"{tag}: num_workers {cfg.data.num_workers}")
    with kernel_flags("kernels"):
        exp = Experiment(cfg, device=device,
                         data=pipeline.loader_from_arrays(arrays))
        want = pipeline.epoch_batches_plain(
            exp.data["train"], cfg.train.batch_size,
            np.random.default_rng(cfg.train.seed))
        _build.reset_launch_counts()
        batches = iter(exp._batches("train"))
        waits, losses, same = [], [], 0
        for _ in range(steps):
            t0 = time.perf_counter()
            batch = next(batches)
            waits.append(1e3 * (time.perf_counter() - t0))
            before = _build.launch_counts()
            (exp.ef_params, exp.ef_opt, loss, _, _) = exp.steps["stage1"](
                exp.ef_params, exp.arch, exp.ef_opt,
                {k: batch[k] for k in pipeline.DEVICE_KEYS}, exp.gen)
            torch.cuda.synchronize()
            mid = _build.launch_counts()
            (exp.w_params, exp.w_opt, loss2, _) = exp.steps["stage2"](
                exp.w_params, exp.w_opt, exp.ef_params, exp.arch,
                {k: batch[k] for k in pipeline.DEVICE_KEYS}, exp.gen,
                exp.sample_gen)
            torch.cuda.synchronize()
            s1, s2 = _delta(before, mid), _delta(mid, _build.launch_counts())
            expect(all(s1.get(k) == v for k, v in STAGE1_LAUNCHES.items())
                   and s1.get("lstm_cell", 0) + s1.get("lstm_seq_all", 0) > 0,
                   f"{tag}: stage-1 launches {s1}, expected "
                   f"{STAGE1_LAUNCHES} and an LSTM kernel")
            expect(sum(s2.get(k, 0) for k in LSTM_KERNELS) > 0,
                   f"{tag}: stage 2 launched no LSTM kernel: {s2}")
            losses += [float(loss), float(loss2)]
            ref = next(want)
            ok = set(batch) == set(ref) and all(
                np.array_equal(_host(batch[k]), ref[k])
                and _host(batch[k]).dtype == ref[k].dtype for k in ref)
            expect(ok, f"{tag}: a consumed batch differs from the plain "
                   "route's")
            same += ok
        launches = _build.launch_counts()
    expect(all(np.isfinite(losses)), f"{tag}: a loss is not finite: "
           f"{losses}")
    log(f"{tag}: {same}/{steps} consumed batches equal to the plain route's; "
        f"losses {[round(x, 4) for x in losses]}; launches "
        f"{ {k: v for k, v in launches.items() if v} }; Prefetcher wait "
        f"{', '.join(f'{w:.3f}' for w in waits)} ms a step (host clock; the "
        f"first includes the first gather; informational) on {card}; host "
        f"{host_cpu()}")
    del exp
    torch.cuda.empty_cache()
    return launches


def data_phase(arrays, device, root: str, card: str) -> dict:
    """Phase 14: (a), (b) and (c); its wall time printed."""
    t0 = time.perf_counter()
    data_builders(Path(root) / "data14")
    check_native_core(arrays, card)
    launches = data_main_path(arrays, device, root, card)
    log(f"data phase took {time.perf_counter() - t0:.1f} s on {card}")
    return launches


# ---------------------------------------------------------------------------
# phase 15: the serving functions as torch.export programs
# ---------------------------------------------------------------------------

# the artifacts, their longest traces first (the supernet's graph)
PROGRAM_ARTIFACTS = ("darts", "unified", "derived", "ef", "w")
# jobs beyond every function of PROGRAM_ARTIFACTS at both flag sets: name
# -> (the artifact whose params it serves, ModelConfig overrides, the flag
# sets it runs at); the int8 ones on write_int8_artifacts' copies
PROGRAM_VARIANTS = {"derived_int8": ("derived", {}, ("kernels",)),
                    "w_fp32": ("w", {"compute_dtype": "float32"},
                               ("default", "kernels")),
                    "w_int8": ("w", {}, ("kernels",))}
PROGRAM_BATCHES = (1, 2, 5, 64)
# the supernet artifacts' default-flag programs are traced at this many
# cells (their full-width traces took 50-77 s each, PERF.md)
PROGRAM_CUT_LAYERS = 2
PROGRAM_CUT = ("darts", "unified")
# one a core of the card's host: the traces are single-threaded Python
PROGRAM_WORKERS = 8
# an operator of a program's graph -> the kernel its CUDA implementation
# launches, once a call at these shapes
OP_KERNELS = {"lstm_cell": "lstm_cell", "lstm_seq_final": "lstm_seq_final",
              "lstm_seq": "lstm_seq_all", "greedy_generate": "greedy_generate",
              "mixed_node": "mixed_node_fwd", "batchnorm": "bn_fwd"}


def program_kernels(name: str, fname: str, fn: str) -> set:
    """The serving kernels that `fn` of artifact `name` launches at the
    flag set `fname`: the cell at every step with the default flags; with
    the kernel flags W's final-state sequence kernel, the EF encoders'
    every-step one, the decode for `generate`, the node and BatchNorm
    kernels on the supernet, the BatchNorm kernel in the derived net."""
    if fname == "default":
        return {"lstm_cell"}
    kernels = {"w": {"lstm_seq_final"}, "unified": set()}.get(
        name, {"lstm_seq_all"})
    if fn == "generate":
        kernels = kernels | {"greedy_generate"}
    if name in ("darts", "unified"):
        kernels = kernels | {"mixed_node_fwd", "bn_fwd"}
    if name == "derived":
        kernels = kernels | {"bn_fwd"}
    return kernels


def _graph_ops(program) -> dict:
    counts = collections.Counter()
    for node in program.graph.nodes:
        if (node.op == "call_function"
                and getattr(node.target, "namespace", None) == "lctvqa_torch"):
            counts[node.target._schema.name.split("::")[1]] += 1
    return dict(counts)


def _outputs_differ(got, want) -> float:
    """The largest |program - eager| over the outputs (floats), or the
    number of differing ids and tokens; inf where a shape or dtype
    differs."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            return float("inf")
        if g.is_floating_point():
            worst = max(worst, float((g - w).abs().max()))
        else:
            worst = max(worst, float((g != w).sum()))
    return worst


def _program_worker(jobs, next_job, results, device: str, root: str) -> None:
    """A spawned process of phase 15: takes jobs (artifact path, name,
    flag set, function) in turn until none is left, traces, checks and
    round-trips each through an artifact file (_program_checks), then
    times its program, the loaded one and its eager call (_time_program)
    while other workers may still trace on the host's cores or time on
    the card: the times are informational. Puts each job's numbers on
    `results`, or the traceback of a failure, then None."""
    import traceback

    torch.set_num_threads(1)  # the host's cores go to the other workers
    try:
        while True:
            with next_job.get_lock():
                i = next_job.value
                next_job.value += 1
            if i >= len(jobs):
                break
            path, name, fname, fn = jobs[i]
            FAILURES.clear()
            with kernel_flags(fname) as flags:
                r, calls = _program_checks(path, name, fname, fn, flags,
                                           torch.device(device), root)
                (r["eager_ms"], r["program_ms"],
                 r["loaded_ms"]) = _time_program(calls)
            r["failures"] = list(FAILURES)
            results.put(r)
            del calls  # the job's model and programs
    except BaseException:
        results.put({"error": traceback.format_exc()})
    finally:
        results.put(None)


def _time_program(calls):
    """One eager call, one call of the traced program and one of the
    program loaded from the artifact at the largest batch, in turns after
    2 of each, host clock around a synchronize -> their median ms over
    5."""
    fns = calls(max(PROGRAM_BATCHES))
    times = {f: [] for f in fns}
    for _ in range(2):
        for f in fns:
            f()
    for _ in range(5):
        for f in fns:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f()
            torch.cuda.synchronize()
            times[f].append(1e3 * (time.perf_counter() - t0))
    return tuple(statistics.median(times[f]) for f in fns)


def _program_checks(path: str, name: str, fname: str, fn: str, flags,
                    device, root: str):
    """The artifact's ServingModel with `flags` (and PROGRAM_VARIANTS'
    overrides), `fn` traced with export.export_programs, the program
    against the eager call at PROGRAM_BATCHES (tokens and ids exactly,
    floats within export._agree's 2e-4), the launch counts of one call of
    each at B = 64 (equal, non-zero for program_kernels, each the graph's
    number of its operator; an int8 model's `aten._int_mm` nodes its
    eager call's int8 products). Then the round trip: the program
    written into a copy of the artifact (export.program_entry,
    save_artifact), loaded with programs.load_programs, and held against
    the eager call at PROGRAM_BATCHES exactly, its launches at B = 64 the
    eager call's, with cuDNN's TF32 on (PyTorch's default), which the
    loader turns off for an fp32 program; the copy kept for the derived
    EF's kernel-flag jobs (phase 15's server), else removed. An fp32
    traced program runs under ops/conv.py::_no_tf32 too, as the loader
    runs it. -> (the numbers, calls: b -> (eager call, program call,
    loaded call) on new inputs of b rows)."""
    from lctvqa_torch import export, programs
    from lctvqa_torch.ops import _build, int8
    from lctvqa_torch.ops.conv import _no_tf32

    base, overrides, _ = PROGRAM_VARIANTS.get(name, (name, {}, None))
    art = export.read_artifact(path)
    meta = art["meta"]
    s, steps, vocab = (meta["img_size"], meta["max_qst_len"],
                       meta["qst_vocab_size"])
    expect(fn in export.FUNCTIONS[meta["family"]], f"{name} has no {fn}")
    model = export.ServingModel(art, device,
                                genotype=ARTIFACT_GENOTYPE.get(base),
                                **flags, **overrides)
    exact = model.config.compute_dtype == "float32"
    t_job = time.perf_counter()
    program = export.export_programs(model, max_batch=max(PROGRAM_BATCHES),
                                     functions=(fn,))[fn]
    trace_s = time.perf_counter() - t_job
    run = program.module()
    graph = _graph_ops(program)
    int_mm = sum(n.op == "call_function"
                 and n.target is torch.ops.aten._int_mm.default
                 for n in program.graph.nodes)
    rng = np.random.default_rng(SEED + 15)
    held = {}

    def calls(b):
        u8 = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
        qst = rng.integers(0, vocab, (b, steps), dtype=np.int32)
        eager_args = (u8, qst) if fn == "answer_logits" else (u8,)

        def program_call(tf32_off=exact):
            with torch.no_grad(), (_no_tf32() if tf32_off
                                   else contextlib.nullcontext()):
                return run(*(torch.from_numpy(a).to(device)
                             for a in eager_args))

        return ((lambda: getattr(model, fn)(*eager_args)), program_call,
                (lambda: getattr(held["loaded"], fn)(*eager_args)))

    diffs = {}
    for b in PROGRAM_BATCHES:
        eager, prog, _ = calls(b)
        diff = diffs[b] = _outputs_differ(prog(), eager())
        expect(diff <= (2e-4 if fn == "answer_logits" else 0.0),
               f"program {name} {fname} {fn} B={b}: differs from the eager "
               f"call by {diff}")

    def launched(call):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        int8.reset_launch_counts()
        call()
        torch.cuda.synchronize()
        return ({k: v for k, v in _build.launch_counts().items() if v},
                int8.LAUNCHES["int8_matmul"])

    launches = {}
    eager, prog, _ = calls(max(PROGRAM_BATCHES))
    launches["eager"], products = launched(eager)
    launches["program"], _ = launched(prog)
    got = launches["program"]
    expect(got == launches["eager"],
           f"program {name} {fname} {fn}: launches {got} against the eager "
           f"call's {launches['eager']}")
    expect(set(got) == program_kernels(base, fname, fn),
           f"program {name} {fname} {fn}: launched {sorted(got)}, expected "
           f"{sorted(program_kernels(base, fname, fn))}")
    expect({OP_KERNELS[op]: n for op, n in graph.items()} == got,
           f"program {name} {fname} {fn}: operators {graph}, launches {got}")
    expect(int_mm == products and (int_mm > 0) == bool(meta.get("int8")),
           f"program {name} {fname} {fn}: {int_mm} aten._int_mm nodes, "
           f"{products} int8 products in the eager call")
    checked_s = time.perf_counter() - t_job

    # the round trip through an artifact file
    t0 = time.perf_counter()
    files, record = export.program_entry(model, {fn: program},
                                         max(PROGRAM_BATCHES))
    copy = Path(root) / f"{name}_{fname}_{fn}.lctx"
    export.save_artifact({**art, programs.PROGRAMS_DIR: {device.type: files},
                          "meta": {**meta, "torch_programs": {
                              device.type: record}}}, str(copy))
    del art, files
    write_s = time.perf_counter() - t0
    (added,) = export.program_bytes(str(copy)).values()
    t0 = time.perf_counter()
    held["loaded"] = programs.load_programs(str(copy), device)
    load_s = time.perf_counter() - t0
    if not (name == "derived" and fname == "kernels"):
        copy.unlink()
    cudnn = torch.backends.cudnn
    was, cudnn.allow_tf32 = cudnn.allow_tf32, True
    loaded_diffs = {}
    for b in PROGRAM_BATCHES:
        eager, _, load = calls(b)
        diff = loaded_diffs[b] = _outputs_differ(load(), eager())
        expect(diff == 0.0, f"loaded program {name} {fname} {fn} B={b}: "
               f"differs from the eager call by {diff}")
    eager, prog, load = calls(max(PROGRAM_BATCHES))
    loaded_launches, _ = launched(load)
    expect(loaded_launches == launches["eager"],
           f"loaded program {name} {fname} {fn}: launches {loaded_launches}"
           f" against the eager call's {launches['eager']}")
    # without the loader's switch, at the global TF32 setting
    tf32_diff = (_outputs_differ(prog(tf32_off=False), eager()) if exact
                 else None)
    expect(cudnn.allow_tf32 is True, f"loaded program {name} {fname} {fn}: "
           "cuDNN's TF32 switch not restored")
    cudnn.allow_tf32 = was
    return ({"name": name, "flags": fname, "fn": fn, "trace_s": trace_s,
             "checked_s": checked_s, "nodes": len(program.graph.nodes),
             "graph_ops": graph, "launches": got, "diffs": diffs,
             "int_mm": int_mm, "bytes": added, "write_s": write_s,
             "load_s": load_s, "loaded_diffs": loaded_diffs,
             "tf32_diff": tf32_diff, "copy": str(copy),
             "dtype": model.config.compute_dtype}, calls)


def op_enqueue_times(device) -> dict:
    """Each operator at a serving shape (B = 64 bf16 at the full widths;
    the node at cell0 with E = 5; BatchNorm at [64,64,64,32] fp32 in, bf16
    out) called through torch.ops and through the function its CUDA
    implementation calls (`host_enqueue_us`, in turns), and the two
    results the same bits. -> {op: {"op_us", "direct_us"}}."""
    from lctvqa_torch.models.qst_encoder import ef_qst_encoder_init
    from lctvqa_torch.ops import (cuda_bn, cuda_generate, cuda_lstm,
                                  cuda_mixedop)
    from lctvqa_torch.ops import nn as N

    bf16 = torch.bfloat16
    mcfg = model_configs()["ef"]
    gen = torch.Generator().manual_seed(SEED + 15)
    qst = _to(ef_qst_encoder_init(gen, mcfg.qst_vocab_size,
                                  mcfg.word_embed_size, mcfg.img_embed_size,
                                  1, mcfg.lstm_hidden_size), device)
    b, steps, hid = 64, mcfg.max_qst_len, mcfg.lstm_hidden_size
    ids = torch.randint(0, mcfg.qst_vocab_size, (b, steps), generator=gen)
    xs = torch.tanh(N.embed(qst["word2vec"], ids.to(device)))
    h0 = N.l2_normalize(torch.randn(b, hid, generator=gen)).to(device)
    w = cuda_lstm.cell_weights(qst["lstm"]["layers"][0], bf16)
    d = cuda_generate.decode_weights(qst, bf16)
    h, wd, c, _ = NODE_SHAPES["cell0"]
    xn, ops, wts = _node_inputs(gen, b, h, wd, c, 5, bf16, device)
    nodes = [cuda_mixedop.node_weights(p) for p in ops]
    dws, pws = [n.dw for n in nodes], [n.pw for n in nodes]
    x_bn = torch.randn(64, 64, 64, 32, generator=gen).to(device)
    cases = {
        "lstm_cell": (cuda_lstm.LSTM_CELL_OP, (xs[:, 0], h0, h0, *w),
                      lambda: cuda_lstm._cell_out(w, xs[:, 0], h0, h0)),
        "lstm_seq_final": (cuda_lstm.LSTM_SEQ_FINAL_OP, (xs, h0, h0, *w),
                           lambda: cuda_lstm._seq_final_kernel(w, xs, h0,
                                                               h0)),
        "lstm_seq": (cuda_lstm.LSTM_SEQ_OP, (xs, h0, h0, *w),
                     lambda: cuda_lstm._seq_all_kernel(w, xs, h0, h0)),
        "greedy_generate": (
            cuda_generate.GREEDY_GENERATE_OP,
            (h0, d.x0, *d.cell, d.fc2_w, d.fc2_b, d.table, steps),
            lambda: cuda_generate._generate_kernel(d, h0, steps)),
        "mixed_node": (cuda_mixedop.MIXED_NODE_OP, (xn, dws, pws, wts, c // 4),
                       lambda: cuda_mixedop._node_op_cuda(xn, dws, pws, wts,
                                                          c // 4)),
        "batchnorm": (cuda_bn.BATCHNORM_OP, (x_bn, bf16, 1e-5),
                      lambda: cuda_bn._bn_op_cuda(x_bn, bf16, 1e-5)),
    }
    out = {}
    with torch.no_grad():
        for name, (op, args, direct) in cases.items():
            same = _outputs_differ(_leaves_tuple(op(*args)),
                                   _leaves_tuple(direct()))
            expect(same == 0.0, f"operator {name}: its result differs from "
                   f"the direct call's by {same}")
            us = {"op_us": [], "direct_us": []}
            for _ in range(3):
                us["op_us"].append(host_enqueue_us(lambda: op(*args)))
                us["direct_us"].append(host_enqueue_us(direct))
            out[name] = {k: statistics.median(v) for k, v in us.items()}
            log(f"host enqueue {name}: {out[name]['op_us']:.1f} us through "
                f"torch.ops, {out[name]['direct_us']:.1f} us direct")
    return out


def _leaves_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _node_inputs(gen, n, h, w, c, edges, dtype, device):
    """`edges` edge states [n, h, w, c] of `dtype`, their mixed-op params and
    the [edges, 8] mixture, at the supernet's channel proportion 1/4."""
    from lctvqa_torch.models import search

    ops = [_to(search.mixed_op_init(gen, c, 1, 4), device)
           for _ in range(edges)]
    xs = [torch.randn(n, h, w, c, generator=gen).to(device, dtype)
          for _ in range(edges)]
    wts = (torch.softmax(torch.randn(edges, 8, generator=gen), 1)
           * torch.softmax(torch.randn(edges, generator=gen), 0)[:, None])
    return xs, ops, wts.to(device)


INT8_ARTIFACTS = {"w_int8": "w", "derived_int8": "derived"}


def write_int8_artifacts(paths) -> None:
    """The W and derived-EF artifacts' params quantized
    (export.export_state(int8=True), as the export CLI's --int8) into
    the files that `paths` names for "w_int8" and "derived_int8"."""
    from lctvqa_torch import convert, export

    for name, base in INT8_ARTIFACTS.items():
        art = export.read_artifact(paths[base])
        params = convert.from_jax(art["params"]["params"])
        state = ({"w_params": params} if base == "w" else
                 {"ef_params": params, "arch": art["params"].get("arch")})
        export.save_artifact(export.export_state(
            state, model_configs()[base], int8=True), paths[name])


# a fresh process: `python -m lctvqa_torch.serve --programs` on argv[1] in
# a thread; its port is on the "serving ..." line; after a line on stdin
# it prints the model and export modules it imported
SERVE_PROGRAMS = """
import json, sys, threading
from lctvqa_torch import serve
threading.Thread(target=serve.main, daemon=True, args=([
    "--artifact", sys.argv[1], "--programs", "--device", sys.argv[2],
    "--max_batch", sys.argv[3], "--port", "0", "--warmup"],)).start()
sys.stdin.readline()
print(json.dumps(sorted(m for m in sys.modules if m.startswith(
    ("lctvqa_torch.models", "lctvqa_torch.export")))), flush=True)
"""


def _merge_programs(copies, out: str) -> str:
    """One artifact of the copies' programs (one function each, one
    platform, the same params and buffers) -> its path."""
    from lctvqa_torch import export, programs

    arts = [export.read_artifact(c) for c in copies]
    (platform,) = arts[0]["meta"]["torch_programs"]
    recs = [a["meta"]["torch_programs"][platform] for a in arts]
    expect(all(r["buffers"] == recs[0]["buffers"] for r in recs),
           "phase 15: the derived EF's programs have other buffers")
    files = {k: v for a in arts
             for k, v in a[programs.PROGRAMS_DIR][platform].items()}
    record = {**recs[0], "functions": sorted(files)}
    export.save_artifact({**arts[0], programs.PROGRAMS_DIR: {platform: files},
                          "meta": {**arts[0]["meta"], "torch_programs": {
                              platform: record}}}, out)
    return out


def serve_programs(copies, fp_path: str, device, root: str, card: str,
                   n: int = 4) -> dict:
    """The derived EF's kernel-flag programs (phase 15's copies, merged
    into one artifact) served by `python -m lctvqa_torch.serve --programs`
    in a fresh process without --genotype, against the model code's
    server on the fp artifact with the genotype: n /answer and n
    /generate requests, one at a time (a derived net's BatchNorm is
    batch-statistics, so one row a batch on both), equal replies; /healthz
    says programs; the process imported neither lctvqa_torch.models nor
    lctvqa_torch.export. -> the readings."""
    import re

    from lctvqa_torch import export, serve
    from lctvqa_torch.ops import _build

    t0 = time.perf_counter()
    path = _merge_programs(copies, str(Path(root) / "derived_programs.lctx"))
    env = dict(os.environ, PYTHONPATH=str(Path(_build.__file__).parents[2]))
    proc = subprocess.Popen([sys.executable, "-c", SERVE_PROGRAMS, path,
                             device.type, str(max(PROGRAM_BATCHES))],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    watchdog = threading.Timer(600, proc.kill)  # a hung server ends here
    watchdog.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith("serving "):
                break
        found = re.search(r"http://[^:]+:(\d+)", lines[-1] if lines else "")
        if not found:
            raise RuntimeError("serve --programs did not start:\n"
                               + "\n".join(lines))
        port = int(found.group(1))
        start_s = time.perf_counter() - t0
        meta = export.read_artifact(fp_path)["meta"]
        qst_words, size = meta["qst_words"], meta["img_size"]
        rng = np.random.default_rng(SEED + 16)
        u8 = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
        asks = [("/answer", {"image_b64": base64.b64encode(
                    u8[i].tobytes()).decode(), "question": " ".join(
                    rng.choice(qst_words[4:], 6))}) for i in range(n)]
        asks += [("/generate", {"image_b64": base64.b64encode(
                     u8[i].tobytes()).decode()}) for i in range(n)]
        with kernel_flags("kernels") as flags:
            srv = serve.make_server(fp_path, port=0, window_ms=5.0,
                                    max_batch=max(PROGRAM_BATCHES),
                                    device=device, genotype=DERIVED_GENOTYPE,
                                    **flags)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            try:
                eager_port = srv.server_address[1]
                got = [_post(port, r, p) for r, p in asks]
                want = [_post(eager_port, r, p) for r, p in asks]
            finally:
                srv.shutdown()
                srv.server_close()
        with _OPENER.open(f"http://127.0.0.1:{port}/healthz",
                          timeout=60) as r:
            health = json.loads(r.read())
        proc.stdin.write("done\n")
        proc.stdin.flush()
        out = proc.stdout.read()
        proc.wait(timeout=60)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    loaded = json.loads(out.strip().splitlines()[-1])
    expect(got == want and all(st == 200 for st, _ in got),
           f"serve --programs: {got[:2]} against the model code's "
           f"{want[:2]}")
    expect(health.get("serving") == "programs", f"serve --programs: "
           f"/healthz {health}")
    expect(loaded == [], f"serve --programs imported {loaded}")
    log(f"serve --programs (derived EF, no --genotype): started and warmed "
        f"in {start_s:.1f} s ({lines[-2] if len(lines) > 1 else ''}); "
        f"{len(got)} replies equal to the model code's, e.g. {got[-1][1]}; "
        f"/healthz {health['serving']}; model or export modules imported: "
        f"{loaded}; {time.perf_counter() - t0:.1f} s on {card}")
    return {"start_s": start_s, "replies": len(got)}


def _log_program_job(r: dict, card: str) -> None:
    """A phase 15 job's numbers, and its failures, as it comes in."""
    for failure in r["failures"]:
        expect(False, failure)
    diffs = ", ".join(f"B={b} {d:.3g}" for b, d in r["diffs"].items())
    loaded = ", ".join(f"B={b} {d:.3g}" for b, d in r["loaded_diffs"].items())
    extra = (f"; with cuDNN TF32 on, the traced program without the loader's "
             f"switch differs by {r['tf32_diff']:.3g}"
             if r["tf32_diff"] is not None else "")
    extra += (f"; {r['int_mm']} aten._int_mm nodes, each an eager int8 "
              "product" if r["int_mm"] else "")
    log(f"program {r['name']} {r['flags']} {r['fn']} {r['dtype']}: traced in "
        f"{r['trace_s']:.1f} s ({r['nodes']} nodes; checked after "
        f"{r['checked_s']:.1f} s), operators {r['graph_ops']}, launches at "
        f"B=64 {r['launches']}; largest |program - eager| {diffs}; written "
        f"into the artifact in {r['write_s']:.1f} s (+{r['bytes']} bytes), "
        f"loaded in {r['load_s']:.1f} s, largest |loaded - eager| "
        f"{loaded}{extra}; B=64 loaded program {r['loaded_ms']:.2f} ms, "
        f"traced program {r['program_ms']:.2f} ms, eager {r['eager_ms']:.2f} "
        f"ms on {card}")


def programs_phase(device, root: str, card: str, paths=None) -> dict:
    """Phase 15: each operator's host enqueue, then every serving function
    of the W, VGG19-EF, darts-EF, derived-EF and unified artifacts (`paths`
    where an earlier phase wrote them, else written here) at both flag
    sets as a program, fp32 W at both and int8 W and derived EF with the
    kernel flags (PROGRAM_VARIANTS), on PROGRAM_WORKERS spawned processes
    (_program_worker), the longest traces first, each program also
    written into a copy of its artifact and loaded back; once the derived
    EF's kernel-flag programs are in, `serve --programs` against the model
    code (serve_programs) on a thread meanwhile. The supernet artifacts'
    default-flag jobs serve a copy cut to PROGRAM_CUT_LAYERS cells. Prints
    each job's numbers and the phase's wall time. -> {"program_launches":
    launches
    of one B = 64 call of every program, summed by kernel, "jobs",
    "enqueue", "serve"}."""
    import multiprocessing
    import queue

    from lctvqa_torch.export import FUNCTIONS

    t0 = time.perf_counter()
    paths = dict(paths or {})
    missing = tuple(n for n in PROGRAM_ARTIFACTS if n not in paths)
    paths.update(write_artifacts(Path(root), names=missing))
    paths.update({n: str(Path(root) / f"{n}.lctx") for n in INT8_ARTIFACTS})
    write_int8_artifacts(paths)
    cut_dir = Path(root) / "program_cut"
    cut_dir.mkdir(exist_ok=True)
    cut = write_artifacts(cut_dir, names=PROGRAM_CUT,
                          overrides={"darts_layers": PROGRAM_CUT_LAYERS})
    enqueue = op_enqueue_times(device)
    torch.cuda.empty_cache()
    family = {"w": "w", "unified": "unified"}
    jobs = []
    for name in (*PROGRAM_ARTIFACTS[:3], "derived_int8",
                 *PROGRAM_ARTIFACTS[3:], "w_fp32", "w_int8"):
        base, _, fnames = PROGRAM_VARIANTS.get(
            name, (name, {}, tuple(KERNEL_FLAGS)))
        jobs += [(cut[name] if fname == "default" and name in cut
                  else paths.get(name, paths[base]), name, fname, fn)
                 for fname in fnames
                 for fn in FUNCTIONS[family.get(base, "ef")]]
    copies_dir = Path(root) / "program_copies"
    copies_dir.mkdir(exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    n = min(PROGRAM_WORKERS, len(jobs))
    out, next_job = ctx.Queue(), ctx.Value("i", 0)
    args = (jobs, next_job, out, str(device), str(copies_dir))
    procs = [ctx.Process(target=_program_worker, args=args)
             for _ in range(n)]
    for proc in procs:
        proc.start()
    results, errors, done = [], [], 0
    served, server = {}, None

    def serve_thread(copies):
        try:
            served.update(serve_programs(copies, paths["derived"], device,
                                         root, card))
        except BaseException:
            import traceback
            served["error"] = traceback.format_exc()

    while done < n:  # drained before the workers are joined
        try:
            item = out.get(timeout=10)
        except queue.Empty:
            if not any(proc.is_alive() for proc in procs):
                break  # a worker died without a word
            continue
        if item is None:
            done += 1
        elif "error" in item:
            errors.append(item["error"])
        else:
            results.append(item)
            _log_program_job(item, card)
            copies = [r["copy"] for r in results
                      if (r["name"], r["flags"]) == ("derived", "kernels")]
            if server is None and len(copies) == 2:
                server = threading.Thread(target=serve_thread, args=(copies,))
                server.start()
    for proc in procs:
        proc.join(60)
    codes = [proc.exitcode for proc in procs]
    if server is not None:
        server.join()
    if errors or done < n or any(codes):
        raise RuntimeError(f"phase 15: {n - done} worker(s) gave no end, "
                           f"exit codes {codes}\n" + "\n".join(errors))
    if server is None or "error" in served:
        raise RuntimeError("phase 15: serve --programs "
                           + served.get("error", "did not run"))
    expect(len(results) == len(jobs),
           f"phase 15: {len(results)} results of {len(jobs)} jobs")
    totals = collections.Counter()
    for r in results:
        totals.update(r["launches"])

    def spread(key, jobs=results):
        values = [key(r) for r in jobs]
        return f"{min(values):.2f}-{max(values):.2f}"

    big = [r for r in results if r["nodes"] > 2000]
    log(f"programs over {len(results)} jobs at B=64: loaded / traced "
        f"program {spread(lambda r: r['loaded_ms'] / r['program_ms'])}x, "
        f"loaded / eager {spread(lambda r: r['loaded_ms'] / r['eager_ms'])}"
        f"x; bytes a graph node {spread(lambda r: r['bytes'] / r['nodes'])}"
        f"; load ms a graph node "
        f"{spread(lambda r: 1e3 * r['load_s'] / r['nodes'])} "
        f"({spread(lambda r: 1e3 * r['load_s'] / r['nodes'], big)} over "
        f"2,000 nodes) on {card}")
    log(f"programs phase took {time.perf_counter() - t0:.1f} s on {card}")
    return {"program_launches": dict(totals), "jobs": results,
            "enqueue": enqueue, "serve": served}


# ---------------------------------------------------------------------------
# phase 16: the supernet's execution modes and the reference's 224 px LCT
# configuration
# ---------------------------------------------------------------------------

# the reference's full resolution
IMG_224 = 224
# the 224 px training run's batch: the reference's 64, which the card holds
# with remat_cells (PERF.md)
BATCH_224 = 64
STEPS_224 = 3
# remat_cells against no remat: one stage-1 step at this batch
REMAT_BATCH = 16
# cell 0 of the 224 px trunk: H, W, C of its states, stride-1 edges a node
NODE_SHAPES_224 = {"cell0_224": (224, 224, 16, (3, 5))}
# the 224 px trunk's largest BatchNorm input: cell 1's preprocess outputs,
# [B, 224, 224, 32], 3.2 M rows at B = 64
BN_SHAPES_224 = ((64, 224, 224, 32),)
# the supernet's ways of running at 64 px: name -> (the KERNEL_FLAGS set
# it runs under, its other ModelConfig overrides); fused_kernels is the
# edge-batched cell with the kernel flags, whose BatchNorms then take the
# kernel at the stacked widths E * Cs (up to 80 channels)
MODE_SETS = {
    "default": ("default", {}),
    "fused": ("default", {"fuse_mixed_ops": True}),
    "packed": ("default", {"pack_conv_branches": True}),
    "kernels": ("kernels", {}),
    "fused_kernels": ("kernels", {"fuse_mixed_ops": True})}
# fused and packed against the default folded path at 64 px, B = 64. fp32:
# the same math summed in other orders (the packed chain's zero taps, the
# fused path's stacked convolutions and fp32 products): features within
# 1e-4 of their scale, stage-1 gradients at phase 8's limit (TRAIN_GRAD_TOL
# of each leaf's scale + TRAIN_GRAD_FLOOR of the largest). bf16: the
# rounding points differ (the fused path's pointwise products sum bf16
# operands in fp32 where the default path's convolutions round their sums
# to bf16; the packed chain rounds one 9x9 convolution where the default
# path rounds four smaller ones), each rounding 2^-8 of a value, through
# four cells: the features within 5e-2 of their scale and the gradient,
# all leaves as one vector, within 5e-2 of its norm. Leaf by leaf it is
# not held: the smallest leaves (1e-4 of the largest) sum terms of the
# large leaves' size that cancel, so their rounding error is 2^-8 of
# those terms, not of their own scale; the kernel flags' own path lay 4.9x
# phase 8's floor off the default path there on an H100 (PERF.md). The
# worst leaf's share is printed
MODE_FEATURE_TOL = 1e-4
MODE_BF16_TOL = 5e-2
# remat_cells against no remat at REMAT_BATCH: each gradient leaf within
# 2e-3 of its scale (+ TRAIN_GRAD_FLOOR of the largest): the node
# backward's bf16 limit on the conv weights (phase 2), the tighter of the
# node's and BatchNorm's
REMAT_GRAD_TOL = 2e-3
MODE_STEPS = 3


def kernels_224(device) -> dict:
    """The node kernels, forward and backward, at cell 0 of the 224 px
    trunk (N = 64, E = 3 and 5, both dtypes) and the BatchNorm kernels at
    its largest input, each against its plain version at phase 2's limits,
    TF32 off; times and bounds printed. -> {"node", "node_bwd", "bn",
    "bn_bwd"}: phase 2's result dicts."""
    with tf32_off():
        out = {"node": check_node_kernel(device, batches=(BATCH_224,),
                                         shapes=NODE_SHAPES_224)}
        torch.cuda.empty_cache()
        out["node_bwd"] = check_node_bwd_kernel(
            device, batches=(BATCH_224,), fault_draw=(),
            shapes=NODE_SHAPES_224)
        torch.cuda.empty_cache()
        out["bn"] = check_bn_kernel(device, shapes=BN_SHAPES_224)
        torch.cuda.empty_cache()
        out["bn_bwd"] = check_bn_bwd_kernel(device, shapes=BN_SHAPES_224)
    torch.cuda.empty_cache()
    return out


def _mode_config(mode: str, dtype: str, **kw):
    """Full width, dropout off, the mode's flags."""
    import dataclasses

    from lctvqa_torch.config import ModelConfig

    fname, overrides = MODE_SETS[mode]
    return dataclasses.replace(ModelConfig(compute_dtype=dtype,
                                           dropout_rate=0.0),
                               **KERNEL_FLAGS[fname], **overrides, **kw)


def _random_batch(mcfg, b: int, device, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    s = mcfg.img_size
    batch = {
        "image_u8": rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8),
        "question": rng.integers(4, mcfg.qst_vocab_size,
                                 (b, mcfg.max_qst_len)).astype(np.int32),
        "answer_label": rng.integers(0, mcfg.ans_vocab_size,
                                     b).astype(np.int32),
        "answer_multi_choice": rng.integers(
            -1, mcfg.ans_vocab_size, (b, 10)).astype(np.int32)}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _features(mcfg, ef, arch, batch):
    """The supernet's trunk features [B, 12544] (fp32)."""
    from lctvqa_torch.data.pipeline import normalize_images
    from lctvqa_torch.models import search, search_fused
    from lctvqa_torch.ops.nn import torch_dtype

    net = (search_fused.network_apply_fused if mcfg.fuse_mixed_ops
           else search.network_apply)
    with torch.no_grad():
        return net(ef["darts"], arch, mcfg, normalize_images(
            batch["image_u8"]), dtype=torch_dtype(mcfg.compute_dtype))


def _stage1_grads(mcfg, ef, arch, batch):
    """Stage 1's loss and its gradient per EF leaf (dropout off)."""
    from lctvqa_torch.data.pipeline import normalize_images
    from lctvqa_torch.models import vqa_ef
    from lctvqa_torch.optim.optimizers import tree_leaves, with_grad

    p = with_grad(ef)
    loss = vqa_ef.ef_loss(p, arch, mcfg, normalize_images(batch["image_u8"]),
                          batch["question"], batch["answer_label"],
                          deterministic=True)
    leaves = tree_leaves(p)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [
        torch.zeros_like(q) if g is None else g.detach()
        for q, g in zip(leaves, grads)]


def _leaves_within(got, want, tol: float, tag: str,
                   held: bool = True) -> float:
    """Each leaf within tol of its scale + TRAIN_GRAD_FLOOR of the largest
    (counted as failures where `held`) -> the worst share of the
    limit."""
    top = max(float(w.float().abs().max()) for w in want)
    worst, same = 0.0, 0
    for i, (a, b) in enumerate(zip(got, want)):
        err, scale = _grad_err(a, b)
        limit = tol * scale + TRAIN_GRAD_FLOOR * top
        worst = max(worst, err / limit)
        same += bool(torch.equal(a, b))
        expect(not held or (bool(torch.isfinite(a.float()).all())
                            and err <= limit),
               f"{tag}: leaf {i} {tuple(a.shape)} differs by {err} "
               f"(scale {scale}, largest leaf {top})")
    log(f"{tag}: {len(want)} leaves, {same} the same bits, worst error "
        f"{worst:.3f} of {'its limit' if held else 'a limit of'} ({tol} of "
        f"the leaf's scale + {TRAIN_GRAD_FLOOR} of the largest, {top:.3e})")
    return worst


def _norm_within(got, want, tol: float, tag: str) -> float:
    """All leaves as one vector: |got - want| within tol of |want| -> the
    relative error."""
    diff = torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm((a.float() - b.float()).flatten())
        for a, b in zip(got, want)]))
    norm = torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(b.float().flatten()) for b in want]))
    rel = float(diff / norm)
    expect(all(bool(torch.isfinite(a.float()).all()) for a in got)
           and rel <= tol, f"{tag}: |got - want| = {rel:.3e} of |want|, "
           f"limit {tol}")
    log(f"{tag}: |got - want| = {rel:.3e} of |want| (limit {tol})")
    return rel


def _time_stage1(mcfg, ef, arch, batch, device, tag: str, card: str):
    """MODE_STEPS stage-1 steps after two (host clock around synchronized
    steps; each from the same weights), one under torch.profiler. -> (ms a
    step, our kernels' launches a step, device kernels a step, device
    busy share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lctvqa_torch.config import Config, TrainConfig
    from lctvqa_torch.ops import _build
    from lctvqa_torch.train.steps import make_lct_steps

    cfg = Config(model=mcfg, train=TrainConfig(batch_size=64,
                                               skip_stage3=True))
    steps = make_lct_steps(cfg, 1, device)
    opt = steps["ef_tx"].init(ef)
    gen = torch.Generator(device=device).manual_seed(SEED)

    def step():
        return steps["stage1"](ef, arch, opt, batch, gen)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    times = []
    before = _build.launch_counts()
    for _ in range(MODE_STEPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    ours = {k: v // MODE_STEPS for k, v in _delta(
        before, _build.launch_counts()).items() if v}
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in events)
    kernels = sum(e.count for e in events)
    ms = statistics.median(times)
    log(f"mode {tag}: stage 1 {ms:.1f} ms/step (median of {MODE_STEPS}, "
        f"host clock), our kernels a step {ours}; under the profiler "
        f"{kernels} device kernels, device {dev_us / 1e3:.1f} ms of "
        f"{wall:.1f} ms wall ({100 * dev_us / 1e3 / wall:.1f}% busy) on "
        f"{card}")
    expect(kernels > 0, f"mode {tag}: the profiler saw no device kernel")
    return ms, ours, kernels, dev_us / 1e3 / wall


def check_modes(device, card: str) -> dict:
    """fuse_mixed_ops and pack_conv_branches (and the edge-batched cell
    and the node kernel with the kernel flags) against the default folded
    path at full width, 64 px, B = 64, on the same weights and batch: the
    trunk's features and stage 1's loss and gradients in fp32
    (MODE_FEATURE_TOL; TRAIN_GRAD_TOL leaf by leaf) and in bf16
    (MODE_BF16_TOL; the gradient as one vector); then each mode's bf16
    stage-1 step timed, with its
    launches and device kernels a step (informational). -> {mode: (ms,
    our launches, device kernels, busy share)}."""
    from lctvqa_torch.models import vqa_ef

    gen = torch.Generator().manual_seed(SEED + 30)
    base = _mode_config("default", "bfloat16")
    ef, arch = vqa_ef.init_ef_model(gen, base)
    ef = _to(ef, device)
    arch = {k: (500.0 * v).to(device) for k, v in arch.items()}
    batch = _random_batch(base, 64, device, SEED + 31)
    want = {}
    out = {}
    # dtype -> (feature limit, loss limit)
    limits = {"float32": (MODE_FEATURE_TOL, TRAIN_LOSS_TOL),
              "bfloat16": (MODE_BF16_TOL, 1e-2)}
    for mode, (fname, _) in MODE_SETS.items():
        with kernel_flags(fname):
            for dname, (f_tol, l_tol) in limits.items():
                mcfg = _mode_config(mode, dname)
                with tf32_off():
                    got = {"features": _features(mcfg, ef, arch, batch),
                           "grads": _stage1_grads(mcfg, ef, arch, batch)}
                if mode == "default":
                    want[dname] = got
                    continue
                ref = want[dname]
                err, scale = _grad_err(got["features"], ref["features"])
                expect(err <= f_tol * scale, f"mode {mode}: {dname} "
                       f"features differ by {err} (scale {scale})")
                log(f"mode {mode}: {dname} features {err:.3e} off the "
                    f"default path's (scale {scale:.3e}, limit "
                    f"{f_tol * scale:.3e})")
                loss, ref_loss = got["grads"][0], ref["grads"][0]
                expect(abs(loss - ref_loss) <= l_tol + l_tol * abs(ref_loss),
                       f"mode {mode}: {dname} stage-1 loss {loss} vs "
                       f"{ref_loss}")
                tag = (f"mode {mode}: stage-1 gradients {dname} against the "
                       "default path")
                if dname == "float32":
                    _leaves_within(got["grads"][1], ref["grads"][1],
                                   TRAIN_GRAD_TOL, tag)
                else:
                    _norm_within(got["grads"][1], ref["grads"][1],
                                 MODE_BF16_TOL, tag)
                    _leaves_within(got["grads"][1], ref["grads"][1],
                                   MODE_BF16_TOL, tag, held=False)
                del got
            out[mode] = _time_stage1(mcfg, ef, arch, batch, device, mode,
                                     card)
        torch.cuda.empty_cache()
    ours = {m: r[1] for m, r in out.items()}
    expect(all(ours["kernels"].get(k) == v
               for k, v in STAGE1_LAUNCHES.items()),
           f"modes: the kernel flags' stage-1 launches {ours['kernels']}")
    expect(ours["fused_kernels"].get("bn_fwd", 0) > 0
           and "mixed_node_fwd" not in ours["fused_kernels"],
           f"modes: the edge-batched cell with the kernel flags launched "
           f"{ours['fused_kernels']}")
    for mode in ("default", "fused", "packed"):
        expect(not any(k in ours[mode] for k in STAGE1_LAUNCHES),
               f"modes: {mode} launched {ours[mode]}")
    return out


def remat_against_plain(device, card: str) -> dict:
    """One stage-1 step (kernel flags, bf16, dropout off) at 224 px and
    REMAT_BATCH rows with and without remat_cells, from the same weights
    and batch: the step's peak device memory each, the loss equal within
    1e-5, every gradient leaf (Adam's first moment, (1 - b1) g) within
    REMAT_GRAD_TOL. -> {remat: peak bytes}."""
    import dataclasses

    from lctvqa_torch.config import Config, TrainConfig
    from lctvqa_torch.models import vqa_ef
    from lctvqa_torch.ops import _build
    from lctvqa_torch.optim.optimizers import tree_leaves
    from lctvqa_torch.train.steps import make_lct_steps

    base = _mode_config("kernels", "bfloat16", img_size=IMG_224)
    ef, arch = vqa_ef.init_ef_model(torch.Generator().manual_seed(SEED + 40),
                                    base)
    ef = _to(ef, device)
    arch = {k: (500.0 * v).to(device) for k, v in arch.items()}
    batch = _random_batch(base, REMAT_BATCH, device, SEED + 41)
    res, peaks = {}, {}
    with kernel_flags("kernels"):
        for remat in (False, True):
            cfg = Config(model=dataclasses.replace(base, remat_cells=remat),
                         train=TrainConfig(batch_size=REMAT_BATCH,
                                           skip_stage3=True))
            steps = make_lct_steps(cfg, 1, device)
            opt = steps["ef_tx"].init(ef)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            before = _build.launch_counts()
            t0 = time.perf_counter()
            _, opt, loss, _, _ = steps["stage1"](
                ef, arch, opt, batch,
                torch.Generator(device=device).manual_seed(SEED))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            calls = _delta(before, _build.launch_counts())
            peaks[remat] = torch.cuda.max_memory_allocated()
            res[remat] = (float(loss), tree_leaves(opt["m"]))
            twice = 2 if remat else 1
            expect(calls["mixed_node_fwd"] == twice * 14
                   and calls["mixed_node_bwd"] == 14
                   and calls["bn_fwd"] == twice * 40
                   and calls["bn_bwd"] == 40,
                   f"remat {remat}: stage-1 launches {calls}")
            log(f"224 px B={REMAT_BATCH} stage 1, remat_cells={remat}: "
                f"peak {peaks[remat] / 2**30:.2f} GiB "
                f"({(peaks[remat] - held) / 2**30:.2f} GiB over the "
                f"{held / 2**30:.2f} held before the step), {ms:.1f} ms "
                f"(one step, its first call: informational), launches "
                f"{ {k: v for k, v in calls.items() if v} } on {card}")
    (l0, g0), (l1, g1) = res[False], res[True]
    expect(abs(l1 - l0) <= 1e-5 * abs(l0), f"remat: stage-1 loss {l1} vs "
           f"{l0} without remat")
    _leaves_within(g1, g0, REMAT_GRAD_TOL,
                   f"224 px B={REMAT_BATCH} remat against no remat")
    expect(peaks[True] < peaks[False],
           f"remat: peak {peaks[True]} not below {peaks[False]}")
    del res, ef
    torch.cuda.empty_cache()
    return peaks


def train_224(device, root: str, card: str, batch: int = BATCH_224,
              steps: int = STEPS_224) -> dict:
    """The reference's 224 px LCT configuration at full width through
    Experiment: bf16, the kernel flags, remat_cells, B = `batch`, stage 3
    off; `steps` + 1 stage-1 + stage-2 steps, the counts set to 0 just
    before and read just after, then validation on one batch (greedy
    decode, BLEU4 against the npy records). Checks: finite losses, each
    stage-1 step's node and BatchNorm launches STAGE1_LAUNCHES with the
    forward ones twice (the cells recomputed), BLEU4 in [0, 100]. Prints
    ms a step by stage, launches a step and the peak device memory. ->
    launches of the run."""
    from lctvqa_torch.config import (Config, DataConfig, ModelConfig,
                                     TrainConfig)
    from lctvqa_torch.data import pipeline, synthetic
    from lctvqa_torch.ops import _build
    from lctvqa_torch.train.experiment import Experiment

    tag = f"224 px B={batch}"
    mcfg = ModelConfig(compute_dtype="bfloat16", img_size=IMG_224,
                       remat_cells=True, **KERNEL_FLAGS["kernels"])
    data = {"num_images": batch, "num_questions": batch * (steps + 1)}
    records = str(Path(root) / "records224")
    synthetic.make_npy_records(records, **data,
                               n_answers=mcfg.ans_vocab_size, seed=SEED)
    arrays = synthetic.make_arrays(
        **data, img_size=IMG_224, n_answers=mcfg.ans_vocab_size, seed=SEED,
        max_qst_len=mcfg.max_qst_len, qst_vocab_size=mcfg.qst_vocab_size)
    # validation on one batch
    arrays["val"] = {k: (v[:batch] if k in ("enc_qst", "qst_len", "enc_ans",
                                            "img_id") else v)
                     for k, v in arrays["val"].items()}
    cfg = Config(model=mcfg,
                 train=TrainConfig(batch_size=batch, num_epochs=1,
                                   skip_stage3=True, seed=SEED),
                 data=DataConfig(input_dir=records), root_stats_dir=root,
                 exp_name="lct224")
    with kernel_flags("kernels"):
        exp = Experiment(cfg, device=device,
                         data=pipeline.loader_from_arrays(arrays))
        record = []
        record_stages(exp, ("stage1", "stage2"), record)
        batches = iter(exp._batches("train"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _build.reset_launch_counts()
        losses = []
        for _ in range(steps + 1):
            out = exp.train_step(next(batches))
            losses += [float(out[0]), float(out[3])]
        launches = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        exp.val()
        val_s = time.perf_counter() - t0
    log_text = (Path(exp.exp_dir) / "log.txt").read_text()
    bleu = [float(line.split("BLEU4: ")[1].split()[0])
            for line in log_text.splitlines() if "BLEU4: " in line]
    expect(all(np.isfinite(losses + exp.val_ef_loss)),
           f"{tag}: a loss is not finite: {losses}, {exp.val_ef_loss}")
    expect(len(bleu) == 1 and 0.0 <= bleu[0] <= 100.0,
           f"{tag}: validation's BLEU4 {bleu}")
    for name, ms, calls in record:
        if name == "stage1":
            want = {k: v * (2 if k.endswith("fwd") else 1)
                    for k, v in STAGE1_LAUNCHES.items()}
            expect(all(calls.get(k) == v for k, v in want.items()),
                   f"{tag}: stage-1 launches {calls}, expected {want}")
    timed = {n: [ms for name, ms, _ in record[2:] if name == n]
             for n in ("stage1", "stage2")}
    s1, s2 = (statistics.median(timed[n]) for n in ("stage1", "stage2"))
    per_step = {n: {k: v for k, v in c.items() if v}
                for n, _, c in record[:2]}
    log(f"{tag} bf16 kernel flags remat_cells: EF losses {losses[0::2]}, W "
        f"losses {losses[1::2]}, validation loss {exp.val_ef_loss[-1]:.4f}, "
        f"BLEU4 {bleu} ({val_s:.1f} s for one batch)")
    log(f"{tag}: stage 1 {s1:.1f} ms/step, stage 2 {s2:.1f} ms/step, "
        f"{batch * 1e3 / (s1 + s2):.1f} pairs/s (medians of {steps} steps "
        f"after the first, host clock between synchronizes); launches a "
        f"step by stage {per_step}; peak device memory "
        f"{peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB held before the "
        f"first step) on {card}")
    del exp
    torch.cuda.empty_cache()
    return launches


def modes_phase(device, root: str, card: str) -> dict:
    """Phase 16: kernels_224, check_modes, remat_against_plain, train_224;
    its wall time printed. -> {"kernels": kernels_224's, "launches":
    train_224's, "modes", "peaks"}."""
    t0 = time.perf_counter()
    out = {"kernels": kernels_224(device)}
    out["modes"] = check_modes(device, card)
    out["peaks"] = remat_against_plain(device, card)
    out["launches"] = train_224(device, root, card)
    log(f"phase 16 took {time.perf_counter() - t0:.1f} s on {card}")
    return out


def kernel_rows(lstm, bn, node, bn_bwd, node_bwd, launches, seq_plan,
                cell_dev, node_dev, gen_plan, gen_dev, node_bwd_dev):
    """The kernels line: one row per kernel at the largest shape the
    batch-64 bf16 path gives it; `launches` of the run of its path. The
    cell's row also has its device time per call and nn.LSTMCell's
    (torch.profiler), the node forward's and backward's the device time of
    each launch of one call, the decode's its device time, its grid and
    the time of as many empty grid barriers as one call makes."""
    picks = {name: (lstm[name][(64, "bfloat16")], "B=64 bfloat16")
             for name in LSTM_KERNELS}
    picks["mixed_node_fwd"] = (node[("cell0", 5, 64, "bfloat16")],
                               "cell0 64x64 Cs=4 E=5 N=64 bfloat16")
    picks["mixed_node_bwd"] = (node_bwd[("cell0", 5, 64, "bfloat16")],
                               "cell0 64x64 Cs=4 E=5 N=64 bfloat16")
    picks["bn_fwd"] = (bn[((64, 64, 64, 32), "float32", "bfloat16")],
                       "[64,64,64,32] float32 -> bfloat16")
    picks["bn_bwd"] = (bn_bwd[((64, 64, 64, 32), "float32", "bfloat16")],
                       "[64,64,64,32] x float32, g bfloat16")
    rows = []
    for name, (source, replaces, _, _) in KERNELS.items():
        r, shape = picks[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": shape})
        if name in LSTM_KERNELS:
            rows[-1]["fp32_max_abs_err"] = max(
                lstm[name][(b, "float32")]["err"] for b in BATCHES)
        if "probe_err" in r:
            rows[-1]["h_rounding_probe_err"] = max(
                lstm[name][(b, "bfloat16")]["probe_err"] for b in BATCHES)
        if name == "lstm_cell":
            d = cell_dev["bfloat16"]
            rows[-1].update(device_us=d["kernel_us"],
                            library_device_us=d["library_us"],
                            fp32_device_us=cell_dev["float32"]["kernel_us"],
                            fp32_library_device_us=cell_dev["float32"][
                                "library_us"])
        if name in ("bn_fwd", "bn_bwd"):  # the stride-2 edges' inner BN
            small = (bn if name == "bn_fwd" else bn_bwd)[
                ((64, 32, 32, 8), "bfloat16", "bfloat16")]
            rows[-1].update(small_shape="[64,32,32,8] bfloat16, bfloat16",
                            small_ms=small["ms"],
                            small_plain_ms=small["plain_ms"],
                            small_bound_ms=small["bound_ms"],
                            small_library_ms=small["library_ms"])
        if name in ("mixed_node_fwd", "mixed_node_bwd"):
            d = (node_dev if name == "mixed_node_fwd"
                 else node_bwd_dev)[NODE_PROFILE[0]]
            rows[-1].update(device_us=d["device_us"], launch_device_us=[
                [k, us] for k, _, us in d["rows"]])
        if name == "greedy_generate":
            plan = gen_plan["bfloat16"]
            rows[-1].update(
                device_us=gen_dev[(64, "bfloat16")]["device_us"],
                fp32_ms=lstm[name][(64, "float32")]["ms"],
                blocks=plan["blocks"], smem_bytes=plan["smem_bytes"],
                empty_barriers_ms=plan["barriers_ms"])
        if "cold_ms" in r:
            plan = seq_plan["bfloat16"]
            rows[-1].update(
                l2_flushed_ms=r["cold_ms"],
                library_l2_flushed_ms=r["library_cold_ms"],
                fp32_ms=lstm[name][(64, "float32")]["ms"],
                fp32_library_ms=lstm[name][(64, "float32")]["library_ms"],
                blocks=plan["blocks"], smem_bytes=plan["smem_bytes"],
                empty_barriers_ms=plan["barriers_ms"])
    return rows


def kernel_times(device, card: str, tree: str) -> int:
    """The short comparison run (--kernel-times): the cell against its
    plain version and nn.LSTMCell at B = 1, 8, 64 in both dtypes with its
    device time and host enqueue at B = 64, the node forward at every
    shape of check_node_kernel and the node backward at every shape of
    check_node_bwd_kernel, both with their per-launch device times at
    NODE_PROFILE, greedy_generate against its plain version with its
    device time and host enqueue at B = 1, 8, 64 in both dtypes, bn_fwd
    and bn_bwd at every BatchNorm shape and dtype pair (bn_device_times),
    and the W and EF answer_logits / generate loop at the default flags. One JSON line of the numbers, also written to
    chiprun_out/kernel_times_<tree>_<pid>.json."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mcfg = model_configs()["w"]
    cell = check_kernels(device, mcfg, names=("lstm_cell",))["lstm_cell"]
    for (b, dname), r in sorted(cell.items()):
        log(f"kernel lstm_cell B={b:3d} {dname:9s} {_times(r)}")
    cell_dev = cell_device_times(device, mcfg)
    node = check_node_kernel(device)
    node_dev = node_device_times(device)
    node_bwd = check_node_bwd_kernel(device, fault_draw=None)
    node_bwd_dev = node_bwd_device_times(device)
    bn_dev = bn_device_times(device)
    gen = check_kernels(device, mcfg,
                        names=("greedy_generate",))["greedy_generate"]
    gen_dev = generate_device_times(device, mcfg)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory(dir=Path.cwd()) as tmp:
        paths = write_artifacts(Path(tmp), names=("w", "ef"))
        rows = throughput(paths, device, flag_sets=("default",))
    for name, fn_name, dtype, fname, rate, ms in rows:
        log(f"throughput {name} {fn_name} B=64 {dtype} {fname}: "
            f"{rate:.1f} pairs/s ({ms:.2f} ms/batch) on {card}")
    record = {
        "tree": tree, "card": card,
        "cell": {f"B={b} {d}": {k: r[k] for k in ("ms", "plain_ms",
                                                   "library_ms", "err")}
                 for (b, d), r in cell.items()},
        "cell_device": cell_dev,
        "node": {" ".join(map(str, k)): {"ms": r["ms"], "err": r["err"]}
                 for k, r in node.items()},
        "node_device": {" ".join(map(str, k)): r
                        for k, r in node_dev.items()},
        "node_bwd": {" ".join(map(str, k)): {"ms": r["ms"], "err": r["err"]}
                     for k, r in node_bwd.items()},
        "node_bwd_device": {" ".join(map(str, k)): r
                            for k, r in node_bwd_dev.items()},
        "generate": {f"B={b} {d}": {k: r[k] for k in ("ms", "plain_ms",
                                                       "err")}
                     for (b, d), r in gen.items()},
        "generate_device": {f"B={b} {d}": r
                            for (b, d), r in gen_dev.items()},
        "bn_device": {kind: {f"{list(shape)} {a} {b}": r
                             for (shape, a, b), r in rows_.items()}
                      for kind, rows_ in bn_dev.items()},
        "throughput": [{"model": n, "fn": f, "dtype": d, "ms": ms}
                       for n, f, d, _, _, ms in rows]}
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    tag = tree.strip("/.").replace("/", "_") or "repo"
    (out_dir / f"kernel_times_{tag}_{os.getpid()}.json").write_text(
        json.dumps(record))
    log(json.dumps(record))
    log(card)
    return 1 if FAILURES else 0


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--profile", action="store_true",
                      help="only build, then profile the darts EF call")
    mode.add_argument("--stage3", action="store_true",
                      help="only build, then the avg pool's gradients and "
                      "phase 9 (stage 3)")
    mode.add_argument("--derived", action="store_true",
                      help="only build, then phase 10 (the derived network "
                      "retrained, evaluated and served)")
    mode.add_argument("--darts", action="store_true",
                      help="only build, then the decode kernel at the "
                      "unified vocabulary and phase 11 (the darts and "
                      "unified families trained, validated and served)")
    mode.add_argument("--grad-spread", action="store_true",
                      help="only build, then how far the derived EF's fp32 "
                      "gradients move under one rounding of the input, "
                      "beside the card against the CPU")
    mode.add_argument("--int8", action="store_true",
                      help="only build, then phase 12 (int8 serving, the "
                      "export CLI and the training statistics), its "
                      "checkpoints made untrained")
    mode.add_argument("--parallel", action="store_true",
                      help="only build, then phase 13 (data parallelism on "
                      "one card: the two-launch BatchNorm kernels, two gloo "
                      "ranks and one NCCL rank against one process)")
    mode.add_argument("--data", action="store_true",
                      help="only build, then phase 14 (the offline data "
                      "builders, the C++ gather core, and the LCT main path "
                      "fed by it)")
    mode.add_argument("--programs", action="store_true",
                      help="only build, then phase 15 (the serving "
                      "functions as torch.export programs, traced and "
                      "loaded back from the artifact, against the eager "
                      "calls; serve --programs; the operators' host "
                      "enqueue)")
    mode.add_argument("--remat", action="store_true",
                      help="only build, then phase 16 (the supernet's "
                      "execution modes against the default path, and the "
                      "reference's 224 px LCT configuration with "
                      "remat_cells)")
    mode.add_argument("--kernel-times", action="store_true",
                      help="only build, then time the cell, the node "
                      "forward and backward, the decode, the BatchNorm "
                      "forward and backward and the W / EF calls (the "
                      "before/after run)")
    parser.add_argument("--root", default=None,
                        help="take lctvqa_torch from this checkout (e.g. "
                        "a git archive of another commit) instead of the "
                        "one beside this script")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.root is not None:
        sys.path.insert(0, str(Path(args.root).resolve()))
    from lctvqa_torch.ops import _build

    t_start = time.perf_counter()
    device = torch.device("cuda")
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; lctvqa_torch from "
        f"{Path(_build.__file__).parents[2]}")

    # 1. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    build_log = (_build.BUILD_DIR / "build.log").read_text().splitlines()
    for line in build_log:
        if "registers" in line or "spill" in line:
            log("ptxas:", line.strip())
    # the LSTM and node kernels by name: registers, static shared memory,
    # spills
    for i, line in enumerate(build_log):
        if "Compiling entry function" in line and any(
                k in line for k in ("lstm_seq_kernel", "xw_gemm",
                                    "lstm_cell_kernel", "node_")):
            name = line.split("'")[1]
            log(f"ptxas {name}: " + "; ".join(
                t.strip().replace("ptxas info    : ", "")
                for t in build_log[i + 2:i + 4]))

    if args.kernel_times:
        return kernel_times(device, card, args.root or ".")
    if args.stage3:
        check_pool_gradients(device)
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
            stage3_phase(train_arrays(), device, tmp, card)
        log(card)
        return 1 if FAILURES else 0
    if args.derived:
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
            derived_phase(train_arrays(), device, tmp, card)
        log(card)
        return 1 if FAILURES else 0
    if args.darts:
        check_unified_decode(device)
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
            darts_phase(train_arrays(), device, tmp, card)
        log(card)
        return 1 if FAILURES else 0
    if args.int8:
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
            int8_phase(train_arrays(), device, tmp, card)
        log(card)
        return 1 if FAILURES else 0
    if args.parallel:
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
            parallel_phase(train_arrays(), device, tmp, card)
        log(card)
        return 1 if FAILURES else 0
    if args.data:
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
            data_phase(train_arrays(), device, tmp, card)
        log(card)
        return 1 if FAILURES else 0
    if args.programs:
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
            programs_phase(device, tmp, card)
        log(card)
        return 1 if FAILURES else 0
    if args.remat:
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
            modes_phase(device, tmp, card)
        log(card)
        return 1 if FAILURES else 0
    if args.grad_spread:
        derived_gradient_spread(device)
        log(card)
        return 0
    if args.profile:
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
            paths = write_artifacts(Path(tmp), names=("darts",))
            profile_darts(paths["darts"], device)
            profile_train(train_arrays(), device, tmp)
        log(card)
        return 1 if FAILURES else 0

    # 2. kernels vs plain versions, TF32 off; later phases run at
    # PyTorch's defaults, as a server does
    t0 = time.perf_counter()
    with tf32_off():
        kern = check_kernels(device, model_configs()["w"])
        seq_plan = check_seq_plan(device, model_configs()["w"])
        check_cell_plan(device, model_configs()["w"])
        gen_plan = check_generate_plan(device, model_configs()["w"])
        seq_device_times(device, model_configs()["w"])
        cell_dev = cell_device_times(device, model_configs()["w"])
        kern_bn = check_bn_kernel(device)
        kern_node = check_node_kernel(device)
        node_dev = node_device_times(device)
        kern_bn_bwd = check_bn_bwd_kernel(device)
        kern_node_bwd = check_node_bwd_kernel(device)
        node_bwd_dev = node_bwd_device_times(device, picks=NODE_PROFILE[:1])
        gen_dev = generate_device_times(device, model_configs()["w"],
                                        batches=(64,))
        gen_unified = check_unified_decode(device)
        check_lstm_functions(device, model_configs()["w"])
        check_pool_gradients(device)
    log(f"kernel phase took {time.perf_counter() - t0:.1f} s; TF32 at "
        f"PyTorch's defaults from here: matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN "
        f"{torch.backends.cudnn.allow_tf32}")
    log(card)

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        # 3. artifacts
        paths = write_artifacts(Path(tmp))

        # 4. the main path: HTTP serving, twice
        _build.reset_launch_counts()
        responses, per_run = {}, {}
        for fname in KERNEL_FLAGS:
            before = _build.launch_counts()
            with kernel_flags(fname) as flags:
                responses[fname] = serve_run(paths, device, flags)
            after = _build.launch_counts()
            per_run[fname] = {k: after[k] - before[k] for k in after}
            log(f"launches in the {fname} run: {per_run[fname]}")
        launches = _build.launch_counts()
        for name, (_, _, run, path) in KERNELS.items():
            expect(per_run[run][name] > 0 or path != "serve",
                   f"{name} never launched in the {run} serving run")
            expect(per_run[run][name] == 0 or path == "serve",
                   f"{name}, a kernel of training, launched while serving")
        for name in ("mixed_node_fwd", "bn_fwd"):
            expect(per_run["default"][name] == 0,
                   f"{name} launched in the default serving run")
        gen_a = responses["default"]["ef_generate"]
        gen_b = responses["kernels"]["ef_generate"]
        expect(gen_a == gen_b, "greedy questions differ between the default "
               "and the kernels run")
        same = sum(a == b for a, b in zip(responses["default"]["w_answer"],
                                          responses["kernels"]["w_answer"]))
        log(f"generate responses equal across runs: {gen_a == gen_b}; W "
            f"answers equal: {same}/{len(responses['default']['w_answer'])}")

        # 5. the darts EF at fixed groups, both flag sets
        check_darts_groups(paths["darts"], device)

        # 6. against the CPU
        check_against_cpu(paths, device)

        # 7. throughput (informational)
        for name, fn_name, dtype, fname, rate, ms in throughput(paths,
                                                                device):
            log(f"throughput {name} {fn_name} B=64 {dtype} {fname}: "
                f"{rate:.1f} pairs/s ({ms:.2f} ms/batch) on {card}")

        # 8. the second main path: training, each run with the counts at 0
        arrays = train_arrays()
        first_loss = {}
        for dtype in DTYPES:
            for fname in KERNEL_FLAGS:
                _build.reset_launch_counts()
                first_loss[(dtype, fname)], train_launches = train_run(
                    arrays, device, dtype, fname, tmp)
                log(f"launches in the {dtype} {fname} training run: "
                    f"{ {k: v for k, v in train_launches.items() if v} }")
                for name, (_, _, run, path) in KERNELS.items():
                    if path == "train" and run == fname:
                        expect(train_launches[name] > 0, f"{name} never "
                               f"launched in the {dtype} {fname} training "
                               "run")
                        if dtype == "bfloat16":
                            launches[name] = train_launches[name]
            a, b = (first_loss[(dtype, f)] for f in KERNEL_FLAGS)
            tol = TRAIN_LOSS_TOL if dtype == "float32" else 1e-2
            expect(abs(a - b) <= tol + tol * abs(a),
                   f"train {dtype}: first stage-1 loss default {a} vs "
                   f"kernels {b}")
        check_train_gradients(arrays, device, tmp)
        log(f"training timed on {card}")

        # 9. the third path: stage 3, each run with the counts at 0
        stage3_phase(arrays, device, tmp, card)

        # 10. the fourth path: the derived network, each run with the
        # counts at 0
        derived_launches = derived_phase(arrays, device, tmp, card)

        # 11. the fifth and sixth: the darts and unified families, each
        # run with the counts at 0
        family_launches = darts_phase(arrays, device, tmp, card)

        # 12. int8 serving through the export CLI, and the statistics of
        # phase 8's run
        int8_phase(arrays, device, tmp, card, paths["w"])

        # 13. data parallelism on one card, each run with the counts at 0
        sync_rows = parallel_phase(arrays, device, tmp, card)

        # 14. the data path: the offline builders, the C++ core, and the
        # LCT main path fed by it, the counts at 0
        data_phase(arrays, device, tmp, card)

        # 15. the serving functions as torch.export programs, each call's
        # counts at 0 just before it
        programs = programs_phase(device, tmp, card, paths)

        # 16. the supernet's execution modes and the 224 px configuration,
        # its training run's counts at 0 just before it
        modes = modes_phase(device, tmp, card)

    rows = kernel_rows(kern, kern_bn, kern_node, kern_bn_bwd, kern_node_bwd,
                       launches, seq_plan, cell_dev, node_dev, gen_plan,
                       gen_dev, node_bwd_dev)
    for row in rows:  # the bf16 kernel-flag training runs of 10 and 11
        row["derived_launches"] = derived_launches[row["name"]]
        row["darts_launches"] = family_launches["darts"][row["name"]]
        row["unified_launches"] = family_launches["unified"][row["name"]]
        row["program_launches"] = programs["program_launches"].get(
            row["name"], 0)
        if row["name"] == "greedy_generate":
            r = gen_unified[(64, "bfloat16")]
            row["unified_vocab"] = {
                "V": UNIFIED_VOCAB, "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "max_abs_err": r["err"],
                "fp32_ms": gen_unified[(64, "float32")]["ms"]}
    for name, r in sync_rows.items():
        if name in SYNC_NODE_KERNELS:
            cell, edges = SYNC_NODE_CASE
            h, w, c, _ = NODE_SHAPES[cell]
            rows.append({
                "name": name, "route": "cuda",
                "source": "lctvqa_torch/csrc/mixedop.cu",
                "replaces": SYNC_NODE_KERNELS[name][1],
                "max_abs_err": r["err"],
                **{k: r[k] for k in (
                    "launches", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "device_us", "launch_counts", "launch_ms",
                    "launch_device_us", "call_ms", "plain_call_ms")},
                "shape": f"{cell} {h}x{w} Cs={c // 4} E={edges} "
                         f"N={PARALLEL_BATCH // PARALLEL_RANKS} bfloat16 (a "
                         f"rank's half of N={PARALLEL_BATCH})"})
            continue
        rows.append({"name": name, "route": "cuda",
                     "source": "lctvqa_torch/csrc/bn.cu",
                     "replaces": SYNC_BN_KERNELS[name],
                     "launches": r["launches"], "max_abs_err": r["err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"],
                     "device_us": r["device_us"],
                     "library_device_us": r["library_device_us"],
                     "shape": f"{list(SYNC_BN_ROW[0])} {SYNC_BN_ROW[1]}, "
                              f"{SYNC_BN_ROW[2]} (a rank's half of "
                              "[64,64,64,32])"})
    at_224 = {"mixed_node_fwd": ("node", ("cell0_224", 5, 64, "bfloat16")),
              "mixed_node_bwd": ("node_bwd",
                                 ("cell0_224", 5, 64, "bfloat16")),
              "bn_fwd": ("bn", (BN_SHAPES_224[0], "float32", "bfloat16")),
              "bn_bwd": ("bn_bwd",
                         (BN_SHAPES_224[0], "float32", "bfloat16"))}
    for row in rows:
        row["lct224_launches"] = modes["launches"].get(row["name"], 0)
        if row["name"] in at_224:
            kind, key = at_224[row["name"]]
            r = modes["kernels"][kind][key]
            row["at_224"] = {"shape": str(key), "max_abs_err": r["err"],
                             **{k: r[k] for k in (
                                 "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}}
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s in all, "
        f"the build included, on {card}")
    if FAILURES:
        log(f"{len(FAILURES)} check(s) failed:")
        for f in FAILURES:
            log(f"  {f}")
        return 1
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
