"""Smoke test of dali_tpu_torch on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``. Phases, each raising
on failure:

1. card name and power limit; build both native libraries from the sources
   in the checkout and print their build seconds;
2. the CMN kernel (``csrc/cmn.cu``) against its plain PyTorch version on the
   card at the main path's shapes ([256, 224, 224, 3] uint8, mixed mirror
   flags, trimmed valid widths) in five forms (``tools/bench_cmn.py``):
   float32 CHW (RN50), float16 CHW, float16 HWC with ``pad_output``
   (channels-last mixed precision), and uint8 and int8 CHW with values
   pushed past both ends of the type (saturating stores); then two folded
   forms: two BraTS-sized float32 DHWC volumes' 128^3 windows to float16
   DCHW (read in place through ``src_index``) and a [16, 8, 224, 224, 3]
   uint8 sequence batch to float32 FCHW; float32 within 1e-5, float16
   within one half-precision step, integers equal. For each: the C entry
   point alone with the L2 flushed (median of 30, CUDA events), the
   wrapper, the plain version, the bytes moved, the HBM bound and the share
   of it reached; and one ``copy_`` of the permuted input to float32 CHW as
   a yardstick of the bandwidth one PyTorch call reaches with the same
   bytes;
3. the RN50 training path at full size (batch 256, hybrid_scale=2, 224x224,
   ImageNet mean/std, FLOAT CHW) on the committed 32-file corpus through
   ``DALIClassificationIterator``: 3 warm-up + 20 timed batches, each checked
   for shape, dtype, device and finiteness; the CMN launch count of that run;
   images/s; per-stage device milliseconds of one instrumented batch;
4. the same pipeline at a small batch on the card and on the CPU (plain
   versions): labels equal, images within one uint8 step / std;
4b. the RN50 pipeline in the form channels-last mixed-precision trainers ask
   for (CMN ``dtype=FLOAT16, output_layout="HWC", pad_output=True``) at
   batch 256: 3 warm-up + 10 timed batches, each checked for shape [256,
   224, 224, 4], dtype, device, finiteness and a zero fourth channel; the
   exact CMN launch count; images/s; then batch 16 on the card against the
   CPU: labels equal, values within one uint8 step / std plus one float16
   step;
5. the ASR mel front end of bench.py's audio lane at full width (batch 32,
   16 kHz 16-bit clips of 4-10 s from the generated 128-clip corpus, window
   320, hop 160, nfft 512, 80 mels, dB, normalize over time): 3 warm-up +
   20 timed batches, each checked for device, dtype, canvas shape, host-known
   per-sample shapes and finiteness on the valid region; clips/s, host
   ms/batch, per-stage device ms of one instrumented batch; then batch 8 on
   the card against the CPU: equal shapes, dB within 1e-3 dB and normalized
   values within 1e-3;
6. EfficientNet-B0's training input with automatic augmentation at full width
   (batch 256, 224x224): the RN50 reader, hybrid decode and resize, then
   ``auto_aug.trivial_augment_wide`` (31 bins, fill 128; 3 warm-up + 20 timed
   batches) and ``auto_aug.auto_augment_image_net`` (3 warm-up + 10 timed),
   then mirror + CMN through ``DALIClassificationIterator`` with
   ``enable_conditionals=True``; each batch checked for shape, dtype, device and
   finiteness, the exact CMN launch count; images/s, host ms/batch by operator
   schema, boundary edges and the H2D window, device ms of one instrumented
   batch run alone, by stage (decode, resize, augmentation ops by schema,
   merges, CMN), peak device memory and the phase's wall time; then both
   recipes at batch 16 on the card against the CPU (labels equal, at least
   99.9% of the augmentation output bit-equal), and each policy alone on the
   same resized batch: TrivialAugment within one step on at most 1e-3 of
   values, AutoAugment at least 99.9% bit-equal;
7. eager mode, bench.py's ``bench_ndd`` recipe at full width through
   ``dali_tpu_torch.experimental.dynamic``: eager ``ndd.readers.file`` over
   the 256-entry file list at batch 256 and the captured frontend (hybrid
   decode at ``hybrid_scale=2``, resize 224, coin-flip mirror, CMN FLOAT CHW;
   the capture gets the host's cores as ``num_threads``, as rn50_train does):
   3 warm-up + 10 timed steps, each checked for shape, dtype, device and
   finiteness; the exact CMN launch count; images/s and its ratio to phase
   3's rate. Then pure eager on the card (one decoded uint8 batch ->
   ``as_batch`` -> ``.gpu()`` -> ``resize`` -> ``crop_mirror_normalize`` with
   a mirror Batch) against the same calls under ``EvalContext(device="cpu")``,
   within one uint8 step / std, and a capture of those calls against them;
8. RN50 fed by a per-sample ``parallel=True`` external source (host cores - 1
   worker processes, ``fork``) that reads JPEG bytes and labels from the file
   list, through the same hybrid decode, resize, mirror and CMN and
   ``DALIClassificationIterator``: 3 warm-up + 10 timed batches checked as in
   phase 3, the exact CMN launch count, images/s and host ms/batch; then batch
   16 on the card against the CPU;
9. the ImageNet training recipe of ``docs/examples/imagenet_training.py`` at
   full width: the same reader over the 256-entry file list, the whole-image
   hybrid decode (``decoders.image``, ``hybrid_scale=2``, int8 wire),
   ``random_resized_crop(size=[224, 224])``, a coin-flip mirror and CMN to
   FLOAT CHW, batch 256 through ``DALIClassificationIterator``: 3 warm-up +
   20 timed batches checked as in phase 3, the exact CMN launch count,
   images/s and its ratio to phase 3's rate, host ms/batch and device wait,
   device ms by stage of one instrumented batch (H2D, wire, whole-image
   IDCT tail, RandomResizedCrop, CMN), peak device memory; then batch 16 on
   the card against the CPU;
10. the RN50 validation recipe the same way: the decode at
   ``hybrid_scale=1`` (the dense flat wire: an 8x8 selection does not fit
   the sparse bitmaps), ``resize(resize_shorter=256,
   interp_type=INTERP_TRIANGULAR)`` onto its per-sample canvas, CMN
   ``crop=(224, 224)`` with no mirror; 3 warm-up + 10 timed batches;
11. rn50_host_decode, the training recipe of DALI's PyTorch ResNet-50
   example with the decode on the host: ``decoders.image_random_crop(
   device="mixed", random_area=[0.1, 1.0], random_aspect_ratio=[0.8, 1.25],
   num_attempts=100)`` (the libjpeg-free C++ decode of the whole image on the
   host cores, then the window), ``resize`` to 224x224 with a triangular
   filter, coin-flip mirror and CMN to FLOAT CHW, on the same reader at batch
   256: 3 warm-up + 20 timed batches, checked and reported as phase 9 (H2D of
   the crops, resize, CMN), then batch 16 on the card against the CPU;
12. proxy_int16_wire, ``docs/examples/pytorch_proxy_training.py``'s graph on
   the same reader at batch 256: ``decoders.image(device="mixed",
   hybrid_device_decode=True)`` on its default int16 wire at
   ``hybrid_scale=1``, ``random_resized_crop(size=[224, 224])``, coin-flip
   CMN; 3 warm-up + 10 timed batches, reported as phase 9 (H2D of the int16
   planes, IDCT tail, RandomResizedCrop, CMN), then batch 16 against the CPU;
13. imagenet_forms, phase 11's recipe over every image form an ImageNet-like
   corpus holds: the 32 corpus files and every fixture of
   ``dali_tpu_torch/testdata/codecs`` (CMYK, YCCK, RGB-colour, 4:1:1 and
   h=4 JPEGs, partly interleaved scans, a progressive JPEG cut at 60%, PNG
   under a ``.JPEG`` name, 16-bit and palette PNGs, 24-bit and RLE8 BMPs,
   GIFs: 256-colour, interlaced, transparent, a local table on an offset
   image, animated; WebPs: lossy, lossless, VP8X with alpha; TIFFs: LZW with
   predictor 2, tiled Deflate, 16-bit RGB, RGBA; a binary PPM)
   repeated to 256 entries, so each batch holds every form; 3 warm-up + 10
   timed batches reported as phase 9, then batch 64 on the card against the
   CPU; then the single-threaded host decode time of each form (ms/image);
14. the SSD300 detection input of ``docs/examples/ssd_detection.py`` at full
   width (``tools/bench_ssd.py``): ``readers.coco`` over the corpus under an
   annotation file made from seed 0 (256 entries, COCO's box-count shape;
   ``testdata/make_coco_annotations.py``), ``random_bbox_crop``, the window
   decoded on the host, resize 300x300, coin-flip ``bb_flip`` and mirror, CMN
   FLOAT CHW and ``box_encoder`` on SSD300's 8,732 default boxes, batch 64
   through ``DALIGenericIterator``, in two forms: ssd_train (the example:
   box ops on the host; 3 warm-up + 20 timed) and ssd_device_encode (DALI's
   upstream SSD300 recipe: mixed decode of the window, ``hsv`` and
   ``brightness_contrast``, ``bb_flip`` and ``box_encoder`` on the card; 3 +
   10). Each batch checked (images, dense [64, 8732, 4] float32 and [64,
   8732] int32 encoder outputs, on the card in the second form), the exact
   CMN launch count; images/s and its share of rn50_train's, host ms/batch
   (also by operator schema), device wait, device ms by stage of one batch
   alone (H2D, Resize, CMN, BoxEncoder, ...), peak device memory; then one
   more batch with its CMN call recorded, and the kernel's output on that
   batch ([64, 300, 300, 3] uint8 in ssd_train, float32 from
   ``brightness_contrast`` in ssd_device_encode) held against the plain
   version on the same arguments within 1e-5, and both timed on it beside
   the HBM bound (the kernel alone with the L2 flushed). Then batch
   16 on the card against the CPU: ssd_train's labels, boxes and encoded
   outputs equal, images within one uint8 step / std on at most 1e-3 of
   values; the card's BoxEncoder against the host encoder on the boxes it
   received (labels equal, or each mismatch a tie, printed; boxes within
   1e-6);
15-16. ImageNet training fed by stored-format readers at batch 256
   (``tools/bench_readers.py``), over the corpus repeated to 1,024 samples
   and written in the run: wds_train (``docs/examples/webdataset_ingest.py``'s
   recipe: ``readers.webdataset`` over 4 tar shards with ``wds2idx`` index
   files, the whole-image hybrid decode at ``hybrid_scale=2`` on the int8
   wire, ``random_resized_crop(224)``, coin-flip CMN FLOAT CHW) and
   tfrecord_train (DALI's TensorFlow ResNet-50 input: ``readers.tfrecord``
   over 4 files with ``tfrecord2idx`` index files, ``image/encoded`` and
   ``image/class/label`` int64 [1], the host decode of
   ``decoders.image_random_crop(device="mixed")`` with its default window
   arguments, resize 224x224, coin-flip CMN FLOAT HWC); each 3 warm-up + 10
   timed batches through ``DALIGenericIterator``, checked (images on the
   card and finite, labels on the host), the exact CMN launch count;
   images/s and its share of rn50_train's, host ms/batch (by operator
   schema), device wait, device ms by stage of one batch alone, peak
   device memory; the CMN kernel held against its plain version on one
   more batch of the path and timed on it beside the HBM bound; then batch
   16 on the card against the CPU (labels equal, images within one uint8
   step / std on at most 1e-3 of values);
17. numpy_volumes: ``readers.numpy(device="gpu")`` over 4 float32 volumes
   of BraTS's ``[4, 155, 240, 240]`` (143 MB each, seed 0) at batch 2,
   whole and as the ``[4, 128, 128, 128]`` centre ROI over axes 1-3: 3
   warm-up + 10 timed batches, each on ``cuda:0`` with its shape and
   dtype; GB/s delivered, host ms/batch, device wait, the H2D ms of one
   batch alone; the first two batches bit-equal to the cpu reader's; the
   files deleted at the end;
18. serialized_rn50 (``tools/bench_frontend.py``): phase 3's graph at batch
   256 over the corpus repeated to 16 batches (``build/rn50_file_list_x16.txt``),
   built through the ``ops`` class API with checkpointing on,
   ``serialize()``d and rebuilt by ``Pipeline.deserialize`` on ``cuda:0``
   with no Python definition, driven through ``DALIClassificationIterator(
   reader_name="Reader", prepare_first_batch=False)``: 3 warm-up + 10 timed
   batches, each bit-equal to the source pipeline's batch; after batch 5
   the iterator's ``checkpoints()`` rebuild the pipeline (``checkpoint=``,
   ``restore_counter``) and its next 3 batches equal the uninterrupted
   run's; the exact CMN launch count; ``executor_statistics()`` and the dot
   file (``build/serialized_rn50.dot``); the CMN kernel held against its
   plain version on one more batch of the path and timed on it; images/s
   beside rn50_train's;
19. effnet_shape_translate: phase 6's TrivialAugment Wide recipe with
   ``shape=[224, 224]``, so its translates read each image's shape on the
   card (``Shapes``, ``Cast``, a subscript, their matrix built there): 3
   warm-up + 10 timed batches reported as phase 6, then batch 16 against
   the CPU as phase 6 checks it;
20. volumes_zscore: ``readers.numpy(device="gpu")`` over 4 BraTS-sized
   volumes at batch 2, ``reshape(layout="CDHW")``, a 128^3 ``slice`` at
   ``random.uniform`` relative starts, per-channel ``reductions.mean`` and
   ``std_dev`` over DHW, ``(x - mean) / std`` and ``stack`` of the
   normalised and raw windows: 3 warm-up + 10 timed batches checked for
   shape, device and finiteness; GB/s of volumes read, host ms/batch,
   device ms by stage of one batch alone; the first two batches on the card
   against the CPU: windows bit-equal, the stacked output within 1e-5
   relative;
21. rn50_affine_mixup (``tools/bench_affine_mixup.py``): phase 3's reader,
   decode and resize, then DALI's geometric-transforms recipe (a rotation,
   scale, shear and translation composed by ``transforms.*`` on the host
   from host random draws, applied by ``warp_affine(inverse_map=False)`` on
   the card), ``noise.gaussian`` with a per-sample stddev drawn on the card
   (``random.uniform(device="gpu")``), CMN with a coin-flip mirror, and
   mixup with ``batch_permutation`` and ``random.beta(0.2, 0.2)``, through
   ``DALIGenericIterator`` at batch 256: 3 warm-up + 10 timed batches, each
   checked for shape, dtype, device and finiteness; the exact CMN launch
   count; images/s beside rn50_train's; host ms/batch by schema; device ms
   by stage of one batch run alone; peak memory; the CMN kernel held
   against its plain version on one more batch of the path and timed on
   it; then batch 16 on the card against the CPU: host draws (labels,
   permuted labels, lam, matrices, permutation) equal, warped images within
   one uint8 step on at most 1e-3 of values, the device noise by its
   distribution (the mean and mean square of noisy - warped within 3
   standard errors of the exact moments of a rounded, clipped normal of
   each sample's drawn stddev), mixup equal to its formula, and the same
   seed twice bit-identical on the card;
22. random_ops: every device random and noise operator at [256, 224, 224,
   3] on the card, by moments within 3 standard errors and KS tests
   against scipy (p > 1e-3); Water, Sphere, GridMask and ColorTwist card
   against CPU (within one uint8 step on at most 1e-3 of values) and
   Jitter's determinism; ``docs/examples/custom_operators.py``'s graph with
   ``fn.torch_function`` on the card, to the example's asserted values;
23. rn50_rcm_jpeg (``tools/bench_rcm_jpeg.py``): phase 3's reader, rn50_val's
   decode (hybrid, scale 1, int8 wire), ``fast_resize_crop_mirror`` (shorter
   side to 256, a random 224x224 crop, a coin-flip mirror: one resample),
   ``jpeg_compression_distortion`` at a quality drawn in [30, 95] and CMN to
   float CHW, through ``DALIClassificationIterator`` at batch 256: 3 warm-up
   + 10 timed batches, each checked for shape, dtype, device and finiteness;
   the exact CMN launch count; images/s beside rn50_train's and rn50_val's;
   host ms/batch by schema; device ms by stage of one batch run alone; peak
   memory; the CMN kernel held against its plain version on one more batch
   of the path and timed on it; then batch 16 on the card against the CPU:
   labels and host draws equal, resized images within one uint8 step on at
   most 1e-3 of values, at most 1e-3 of the distorted 8x8 blocks differing,
   normalised images within one step / std where the distorted pixels agree;
24. gpu_ops: every other operator of Queue 1 item 5g (Dilate, Erode,
   MedianBlur at 3 and 5, Clahe, Debayer, Filter 5x5, Remap,
   WarpPerspective nearest and linear, MultiPaste as a 2x2 mosaic into
   448x448, ElementExtract, SequenceRearrange, PerFrame, TensorResize,
   PowerSpectrum, NonsilentRegion; and ColorTwist at brightness 0.9 and Hsv
   at value 0.9, whose rounding ties the XLA-CPU sum order decides, equal
   to the CPU's) card against CPU at batch 16 (4
   sequences, 8 clips) within the CPU tests' tolerances, and its device ms
   on one full batch ([256, 224, 224, 3] uint8 images; [16, 8, 224, 224, 3]
   sequences; numpy_volumes' two [4, 155, 240, 240] float32 volumes at
   scale 0.5; asr_frontend's 32 clips), with the phase's peak memory;
25. asr_resample (``tools/bench_dali_cpu.py``): phase 5's graph over the same
   128 clips written at 48 kHz (``build/audio_corpus_48k``), with
   ``experimental.audio_resample`` 48 kHz -> 16 kHz on the card (a
   Kaiser-windowed sinc, 32 taps) between the mixed decode and the
   preemphasis: 3 warm-up + 10 timed batches of 32, each checked as in
   phase 5; clips/s beside asr_frontend's, host ms/batch, device ms by stage
   of one batch alone (AudioResample's among them), peak memory; then batch
   4 on the card against the CPU: each clip's resampled signal within 1e-5
   of its peak, the dB mel within 1e-3 dB;
26. rn50_dali_cpu: DeepLearningExamples' ResNet-50 ``--dali-cpu`` recipe at
   batch 256 over the corpus: ``decoders.image(device="cpu")``,
   ``random_resized_crop(device="cpu")`` (224, area [0.08, 1], 100
   attempts) on the host's threads, ``.gpu()``, coin-flip CMN to float CHW
   through ``DALIClassificationIterator``: 3 warm-up + 10 timed batches,
   each checked; the exact CMN launch count; images/s beside rn50_train's;
   host ms/batch by schema; device ms by stage of one batch alone; peak
   memory; the CMN kernel held against its plain version on one more batch
   of the path and timed on it; then batch 16 against the same graph with
   CMN on the host before ``.gpu()`` (labels equal, images within 1e-5);
27. host_geometry: docs/examples/serialization.py, transforms_3d.py and
   audio_processing.py run whole through the port (each asserts its own
   outputs), then every host geometry and colour operator of the port
   (Resize, RandomResizedCrop, CropMirrorNormalize, Flip, WarpAffine, Rotate,
   Transpose, Pad, Erase, Paste and the six colour schemas) on one batch of
   [256, 224, 224, 3] uint8: host ms per batch on one thread and on the
   host's cores. No cv2 is imported (checked);
28. rn50_host_augment (``tools/bench_dali_cpu.py``): phase 26's graph with the
   robustness recipes' host augmentations after the crop, on the host's
   threads: ``jpeg_compression_distortion`` at a quality drawn from
   [30, 95], ``gaussian_blur`` at a sigma drawn from [0.1, 2.0] and
   ``experimental.equalize``; then ``.gpu()`` and CMN as phase 26: 3 warm-up
   + 10 timed batches of 256, each checked (shapes, finite values, labels in
   the file list's range); the exact CMN launch count; images/s beside
   rn50_dali_cpu's in this run; host ms/batch by schema; device ms of one
   batch alone; peak memory; the CMN kernel held against its plain version
   on one more batch of the path and timed on it; then batch 16 against the
   same graph with CMN on the host (labels equal, images within 1e-5);
29. host_filters: docs/examples/augmentation_gallery.py run whole through the
   port, then every host operator ported with the filters (GaussianBlur,
   Laplacian, Filter, Equalize, Water, Sphere, Jitter, GridMask, MedianBlur,
   Dilate, Erode, Clahe, Debayer bilinear and edge-aware on [256, 224, 224]
   mosaics, MultiPaste, DumpImage, TensorResize, ResizeCropMirror,
   FastResizeCropMirror, JpegCompressionDistortion, Remap, WarpPerspective)
   on one batch of [256, 224, 224, 3] uint8: host ms per batch on one thread
   and on the host's cores; then each op with both placements on a batch of
   16 on the host and on the card, held within ``PLACEMENT_BOUNDS`` (JPEG's
   placements differ by design and Jitter draws from other generators, so
   neither is compared). No cv2 is imported (checked);
30. asr_flac: phase 5's asr_frontend over the same 128 clips written as
   16-bit FLAC (``build/audio_corpus_flac``, by ``testdata/flac_writer.py``
   at first use), reading ``*.flac`` as bench.py's audio lane does: 3
   warm-up + 20 timed batches checked as in phase 5; clips/s beside
   asr_frontend's; the host ms of one batch's decode, FLAC and WAV, on the
   host's cores; one batch's dB mel on the card bit-equal to the WAV path's;
31. sequence_augment (``tools/bench_seq_volumes.py``): ``readers.sequence``
   over 32 sequences of 16 BMP frames of 224x224 panning across the corpus
   images (``build/sequence_corpus``), 8 sequences a batch; on the card a
   per-sequence warp from ``fn.transforms.*``, ``gaussian_blur`` (sigma in
   [0.1, 2]), ``experimental.equalize`` and CMN to FLOAT FCHW (the kernel's
   FCHW fold): 3 warm-up + 10 timed batches, each checked; frames/s beside
   rn50_train's images/s; host ms by schema; device ms by stage of one
   batch alone; peak memory; the exact CMN launch count; the CMN kernel
   held against its plain version on one more batch and timed on it; then
   batch 2 on the card against the CPU (each uint8 stage within one step on
   at most 1e-3 of values, the output within one uint8 step / std);
32. volume_augment (``tools/bench_seq_volumes.py``): four BraTS-sized
   float32 volumes ``[4, 155, 240, 240]`` read through the centre 128^3 ROI
   at batch 2 (``readers.numpy(device="gpu")``), transposed to DHWC,
   ``gaussian_blur`` (sigma in [0.5, 1.5] on all three axes) and ``rotate``
   about a random axis by an angle in [-15, 15] degrees, ``keep_size``: 3
   warm-up + 10 timed batches, each checked; GB/s beside numpy_volumes' ROI
   rate; device ms by stage; peak memory; then a 64^3 ROI on the card
   against the CPU within 1e-5 (the files deleted after);
33. wds_webp_train (``tools/bench_readers.py``): webdataset shards of WebP
   (``.webp`` + ``.cls``, as img2dataset writes them) from the corpus stored
   as WebP at quality 85 (``testdata/webp``), repeated to 1,024 samples in
   4 shards with ``wds2idx`` indexes (``build/reader_datasets/wds_webp``):
   ``readers.webdataset(ext=["webp", "cls"], random_shuffle=True)``,
   ``decoders.image_random_crop(device="mixed")`` with its default window
   arguments (the batch's WebPs in one native call on the task pool),
   ``resize`` to 224x224 and coin-flip CMN FLOAT CHW at batch 256 through
   ``DALIGenericIterator``: 3 warm-up + 10 timed batches, each checked; the
   exact CMN launch count; images/s beside wds_train's in this run; host
   ms/batch by schema; device ms by stage of one batch alone; peak memory;
   the WebP decode of one batch in one native call on one thread and on the
   host's cores; the CMN kernel held against its plain version on one more
   batch and timed on it; then batch 16 on the card against the CPU (labels
   equal, images within one uint8 step / std on at most 1e-3 of values);
34. rn50_dataloader_proxy (``tools/bench_plugins.py``): a PyTorch training
   loop that keeps its own ``DataLoader``: a ``Dataset`` over the corpus
   repeated to 1,024 samples returns ``(server.proxy(jpeg bytes), label)``,
   ``plugin.proxy.DataLoader(server, ds, batch_size=256, num_workers=host
   cores - 1)`` collates them in workers forked after the pipeline built,
   and the pipeline (phase 8's graph with ``fn.external_source(name=
   "jpegs")`` in place of the parallel source) runs on each batch: 3 warm-up
   + 10 timed batches, each checked; images/s beside rn50_train's and
   rn50_parallel_es's in this run; host ms and the main process's wait for
   the workers per batch; the exact CMN launch count; the CMN kernel held
   against its plain version on one more batch and timed on it; then batch
   16 on the card against the CPU (labels equal, images within one uint8
   step / std on at most 1e-3 of values);
35. rn50_capi_serve (``tools/bench_plugins.py``): the preprocessing Triton's
   DALI backend runs, rn50_val's recipe fed from
   ``fn.external_source(name="DALI_INPUT_0")``, written by
   ``plugin.triton.save_model_repo`` to ``build/model_repo/rn50/1/model.dali``
   and served through the C API (``dali_tpu_torch/capi``, built here with
   g++ against this Python into ``build/libdali_tpu_torch_c.so``), driven
   through ctypes in this process: 3 warm-up + 10 timed batches of 256
   encoded JPEGs fed with ``daliTpuFeedInput``, run, and every output sample
   copied out with ``daliTpuCopyOutputSample`` (154 MB a batch, timed);
   images/s beside rn50_val's in this run; the exact CMN launch count; the
   CMN kernel held against its plain version on one more batch and timed on
   it; then ``capi/test_capi.c`` compiled with gcc serves one batch as a
   subprocess on the card, bit-equal to the document run by
   ``Pipeline.deserialize`` in Python on the same inputs;
36. asr_mp3 (``tools/bench_audio_codecs.py``): asr_resample's graph (phase
   25) over the 32 committed 48 kHz mono MP3 clips of
   ``testdata/audio_codecs/corpus_mp3`` (Common Voice's form, 64 kbit/s),
   decoded on the host by ``csrc/host/mp3_decode.cc``, resampled to 16 kHz
   and turned into the mel on the card: 3 warm-up + 20 timed batches of 32,
   each checked; clips/s beside asr_frontend's and asr_resample's in this
   run; host ms/batch; the ms of one batch's MP3 decode on one thread and
   on the host's cores; the exact CMN launch count (0: no CMN on this
   path); one batch of all 32 clips on the card against the CPU within
   asr_resample's contract;
37. audio codecs (``tools/bench_audio_codecs.py``): every committed MP3 and
   Vorbis fixture decoded by this machine's build against
   ``testdata/audio_codecs/reference.npz`` (dali_tpu's FFmpeg decode):
   equal lengths, channels and rates, within the "full accuracy" bounds of
   ISO/IEC 11172-4; the streams the port does not decode raise as they
   should; then one batch of the 8 Vorbis clips of ``corpus_vorbis``
   through phase 36's graph, card against CPU.

The kernel table (its CMN entry with the main form's numbers, the launches of
each path and every form's readings, the SSD and reader paths' own batches
among them) is the JSON object on the line before
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the rest of
the repository beside it, the script exits non-zero before printing either.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH = 256
OUT = 224
WARMUP, TIMED = 3, 20
MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]
LSB_OVER_STD = 1.0 / min(STD)  # one uint8 step after normalization
AUDIO_BATCH, HOP, NMEL = 32, 160, 80
AUDIO_TOL = 1e-3  # dB, and normalized units
AUG_TIMED = {"trivial_augment_wide": 20, "auto_augment_image_net": 10,
             "effnet_shape_translate": 10}
AUG_CHECK_BATCH = 16
AMP_TIMED = 10
RECIPE_TIMED = {"imagenet_train": 20, "rn50_val": 10, "rn50_host_decode": 20,
                "proxy_int16_wire": 10}
FORMS_TIMED, FORMS_CHECK_BATCH, FORMS_DECODE_REPS = 10, 64, 10
SSD_BATCH, SSD_CHECK_BATCH = 64, 16
SSD_TIMED = {"ssd_train": 20, "ssd_device_encode": 10}
READER_TIMED, READER_CHECK_BATCH = 10, 16
FRONTEND_TIMED, VOLUMES_TIMED = 10, 10
AFFINE_TIMED, AFFINE_CHECK_BATCH = 10, 16
RCM_TIMED, RCM_CHECK_BATCH = 10, 16
ASR_RESAMPLE_TIMED, DALI_CPU_TIMED = 10, 10
HOST_AUGMENT_TIMED = 10
SEQ_TIMED, VOLUME_AUGMENT_TIMED = 10, 10
PLUGIN_TIMED = 10
FORM_KEYS = ("name", "ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_share", "max_abs_err")
F16_STEP = 2.0 ** -9  # one float16 step for 2 <= |x| < 4; normalized images stay within (-3, 3)


def require(cond, msg):
    """A check that stays under ``python -O`` (unlike ``assert``)."""
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def build_phase():
    from dali_tpu_torch.native import build

    secs = {}
    for name, fn in (("host", build.host_library), ("kernels", build.kernel_library)):
        t0 = time.perf_counter()
        path = fn()
        secs[name] = time.perf_counter() - t0
        print(f"built {os.path.relpath(path, HERE)} in {secs[name]:.2f} s")
    return secs


def cmn_phase(card):
    from dali_tpu_torch.kernels import cmn
    from dali_tpu_torch.tools import bench_cmn

    forms, copy = bench_cmn.measure(cmn, reps=30)
    require([f["name"] for f in forms] == [f[0] for f in bench_cmn.FORMS],
            "the CMN kernel did not run every form")
    forms += bench_cmn.measure_folds(cmn, reps=30)
    for f in forms:
        print(f"cmn {f['name']} -> {f['shape_out']}: kernel alone {f['ms']:.4f} ms (cold L2), "
              f"wrapper {f['wrapper_ms']:.4f} ms, plain {f['plain_ms']:.4f} ms; {f['bytes']} "
              f"bytes, bound {f['bound_ms']:.4f} ms, {100 * f['bound_share']:.1f}% of it; max "
              f"abs diff vs plain {f['max_abs_err']:.3e} ({card})")
        require(f["agrees"], f"CMN kernel disagrees with its plain version in form {f['name']}:"
                f" max abs diff {f['max_abs_err']}")
    print(f"yardstick, one copy_ of the permuted input into float32 CHW ({copy['bytes']} bytes): "
          f"{copy['ms']:.4f} ms cold L2, {100 * copy['bound_share']:.1f}% of the bound ({card})")
    return forms, copy


def make_pipe(file_list, batch, out, device, amp=False):
    from dali_tpu_torch import fn, pipeline_def, types

    @pipeline_def(batch_size=batch, num_threads=os.cpu_count() or 1, seed=42,
                  prefetch_queue_depth=2, device=device)
    def rn50_train():
        jpegs, labels = fn.readers.file(file_list=file_list, random_shuffle=True, name="Reader")
        images = fn.decoders.image_random_crop(jpegs, device="mixed", hybrid_device_decode=True,
                                               hybrid_scale=2)
        images = fn.resize(images, resize_x=out, resize_y=out)
        mirror = fn.random.coin_flip(probability=0.5)
        form = (dict(dtype=types.FLOAT16, output_layout="HWC", pad_output=True) if amp
                else dict(dtype=types.FLOAT, output_layout="CHW"))
        images = fn.crop_mirror_normalize(images, mirror=mirror, mean=MEAN, std=STD, **form)
        return images, labels

    return rn50_train()


def write_file_list(forms=False, repeat=1) -> str:
    """The 32-file corpus repeated to ``repeat`` batches of BATCH entries,
    ``path label`` lines; with ``forms``, the image-form fixtures join it
    (label 2)."""
    root = os.path.join(HERE, "dali_tpu_torch", "testdata", "rn50")
    files = sorted(os.path.join(c, f) for c in sorted(os.listdir(root))
                   for f in sorted(os.listdir(os.path.join(root, c))))
    require(len(files) == 32, f"expected the 32-file corpus under {root}, found {len(files)}")
    entries = [f"{os.path.join(root, f)} {int(f.split(os.sep)[0][len('class'):])}" for f in files]
    if forms:
        codecs = os.path.join(HERE, "dali_tpu_torch", "testdata", "codecs")
        entries += [f"{os.path.join(codecs, f)} 2" for f in sorted(os.listdir(codecs))]
    n = BATCH * repeat
    lines = (entries * (-(-n // len(entries))))[:max(n, len(entries))]
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    path = os.path.join(HERE, "build", "imagenet_forms_file_list.txt" if forms
                        else "rn50_file_list.txt" if repeat == 1
                        else f"rn50_file_list_x{repeat}.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def check_batch(batch, amp=False):
    data, label = batch[0]["data"], batch[0]["label"]
    dtype, shape = (torch.float16, (BATCH, OUT, OUT, 4)) if amp else (torch.float32,
                                                                    (BATCH, 3, OUT, OUT))
    require(data.is_cuda and data.dtype == dtype, f"batch on {data.device} as {data.dtype}")
    require(tuple(data.shape) == shape, f"batch shape {tuple(data.shape)}")
    require(not amp or not bool(data[..., 3].any()), "the padded channel is not zero")
    require(tuple(label.shape) == (BATCH, 1) and not label.is_floating_point(),
            f"labels {tuple(label.shape)} {label.dtype}")
    require(bool(torch.isfinite(data).all()), "non-finite values in a batch")


def drive(pipe, timed, what, amp=False):
    """Build ``pipe`` and run it through ``DALIClassificationIterator``:
    WARMUP + ``timed`` batches, each checked, then the prefetched batches
    collected so every run has finished. The CMN launch count is set to 0
    just before and must equal the batches run. Returns (images/s, executor
    stat deltas and host ms/batch by schema over the timed batches,
    launches)."""
    from dali_tpu_torch.kernels import cmn
    from dali_tpu_torch.plugin.pytorch import DALIClassificationIterator

    pipe.build()
    ex = pipe.executor
    cmn.COUNTER.launches = 0
    it = DALIClassificationIterator(pipe)
    for _ in range(WARMUP):
        check_batch(next(it), amp=amp)
    torch.cuda.synchronize()
    st0, by0 = dict(ex.stats), dict(ex.host_seconds_by_schema)
    t0 = time.perf_counter()
    for _ in range(timed):
        check_batch(next(it), amp=amp)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = {k: v - st0[k] for k, v in ex.stats.items()}
    by = {k: 1e3 * (v - by0.get(k, 0.0)) / st["host_batches"]
          for k, v in ex.host_seconds_by_schema.items()}
    for _ in range(pipe.prefetch_queue_depth):
        pipe.outputs()
    torch.cuda.synchronize()
    launches = cmn.COUNTER.launches
    ran = WARMUP + timed + pipe.prefetch_queue_depth
    require(launches == ran, f"{what}: CMN kernel launched {launches} times for {ran} batches")
    return timed * BATCH / dt, st, by, launches


def host_line(st, timed):
    return (f"host phase {1e3 * st['host_phase_seconds'] / st['host_batches']:.2f} ms/batch over "
            f"{st['host_batches']} batches ({os.cpu_count()} host cores); the device stage waited "
            f"{1e3 * st['device_wait_seconds'] / timed:.2f} ms/batch for staged batches")


def e2e_phase(card, file_list):
    pipe = make_pipe(file_list, BATCH, OUT, "cuda:0")
    ips, st, _, launches = drive(pipe, TIMED, "rn50_train")
    print(f"cmn launches in the main path: {launches} (batches run: {launches}: "
          f"{WARMUP + TIMED} through the iterator + {pipe.prefetch_queue_depth} prefetched)")
    print(f"e2e rn50_train batch {BATCH}: {ips:.1f} images/s over {TIMED} batches ({card})")
    print(f"during the timed batches: {host_line(st, TIMED)}")

    ex = pipe.executor
    ex.record_stage_events = True
    for _ in range(pipe.prefetch_queue_depth + 2):
        pipe.schedule_run()
    for _ in range(pipe.prefetch_queue_depth + 2):
        pipe.outputs()
    torch.cuda.synchronize()
    require(not ex.record_stage_events and ex.stage_events, "the instrumented batch did not run")
    names = {"h2d": "H2D", "wire": "wire", "_JpegIdctSplitRRC": "IDCT tail",
             "Resize": "resize", "CropMirrorNormalize": "CMN"}
    stages = {names[s]: a.elapsed_time(b) for s, a, b in ex.stage_events}
    print("stage ms: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + f" ({card})")
    pipe.shutdown()
    return launches, ips, stages


def reference_phase(file_list, amp=False, make=None, what="", batch=16):
    """The same pipeline (``make(batch, device)``, by default rn50_train's) at
    ``batch`` on the card and on the CPU; in the fp16 form the limits grow by
    one float16 step."""
    make = make or (lambda batch, device: make_pipe(file_list, batch, OUT, device, amp))
    outs = []
    for device in ("cuda:0", "cpu"):
        pipe = make(batch, device)
        pipe.build()
        res = [pipe.run() for _ in range(2)]
        outs.append([(r[0].as_tensor().cpu(), r[1].as_array()) for r in res])
        pipe.shutdown()
    worst, frac = 0.0, 0.0
    step = F16_STEP if amp else 1e-4
    for (g_img, g_lab), (c_img, c_lab) in zip(*outs):
        require((g_lab == c_lab).all(), "labels differ between card and CPU")
        d = (g_img.float() - c_img.float()).abs()
        worst = max(worst, float(d.max()))
        frac = max(frac, float((d > step).float().mean()))
    limit = LSB_OVER_STD + step
    print(f"card vs CPU plain path{' (fp16 HWC form)' if amp else ''}{what} (batch {batch}, 2 "
          "iterations): "
          f"max abs diff {worst:.4f} (limit {limit:.4f}), fraction > {step:.1e}: {frac:.2e} "
          "(limit 1e-3)")
    require(worst <= limit and frac <= 1e-3,
            "the card's output disagrees with the CPU reference path")


def amp_phase(card, file_list):
    """RN50 in the channels-last mixed-precision form; returns its CMN
    launches and images/s."""
    t_phase = time.perf_counter()
    pipe = make_pipe(file_list, BATCH, OUT, "cuda:0", amp=True)
    ips, _, _, launches = drive(pipe, AMP_TIMED, "AMP form", amp=True)
    pipe.shutdown()
    print(f"e2e rn50_train fp16 HWC pad_output batch {BATCH}: {ips:.1f} images/s over {AMP_TIMED}"
          f" batches; cmn launches {launches}, one per batch ({card})")
    reference_phase(file_list, amp=True)
    print(f"AMP form phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, ips


def make_asr_pipe(root, batch, device, ext="wav"):
    """bench.py's asr_frontend on the WAV (or ``ext``) corpus; returns the
    decoded audio (for its per-sample lengths), the dB mel and the
    normalized output."""
    from dali_tpu_torch import fn, pipeline_def, types

    @pipeline_def(batch_size=batch, seed=7, prefetch_queue_depth=2, device=device)
    def asr_frontend():
        enc, _ = fn.readers.file(file_root=root, file_filters=[f"*.{ext}"], random_shuffle=True,
                                 name="R")
        audio, _rate = fn.decoders.audio(enc, dtype=types.FLOAT, downmix=True, device="mixed")
        pre = fn.preemphasis_filter(audio, preemph_coeff=0.97)
        spec = fn.spectrogram(pre, nfft=512, window_length=320, window_step=HOP)
        mel = fn.mel_filter_bank(spec, sample_rate=16000.0, nfilter=NMEL)
        db = fn.to_decibels(mel, multiplier=10.0, cutoff_db=-80.0)
        return audio, db, fn.normalize(db, axes=[1])

    pipe = asr_frontend()
    pipe.build()
    return pipe


def check_audio_batch(outs, batch):
    audio, _, out = outs
    data = out.as_tensor()
    canvas = audio.as_tensor().shape[1]
    require(data.is_cuda and data.dtype == torch.float32, f"mel batch on {data.device} as {data.dtype}")
    require(tuple(data.shape) == (batch, NMEL, canvas // HOP + 1),
            f"mel batch {tuple(data.shape)} for an audio canvas of {canvas}")
    require(isinstance(out._shapes, np.ndarray), "per-sample shapes of the output are not host-known")
    frames = [s[0] // HOP + 1 for s in audio.shape()]
    require(out.shape() == [(NMEL, f) for f in frames], "per-sample shapes differ from len//160+1")
    valid = torch.arange(data.shape[2], device=data.device)[None, :] < torch.tensor(
        frames, device=data.device)[:, None]
    require(bool((torch.isfinite(data) | ~valid[:, None, :]).all()),
            "non-finite values in the valid region")


def time_asr(pipe):
    """WARMUP + TIMED batches of an asr_frontend pipeline as an iterator runs
    it (take one batch, schedule the next), each checked; (clips/s, executor
    stat deltas of the timed batches)."""
    ex = pipe.executor

    def step():
        check_audio_batch(pipe.outputs(), AUDIO_BATCH)
        pipe.schedule_run()

    pipe._prefetch()
    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    st0 = dict(ex.stats)
    t0 = time.perf_counter()
    for _ in range(TIMED):
        step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = {k: v - st0[k] for k, v in ex.stats.items()}
    for _ in range(pipe.prefetch_queue_depth):
        pipe.outputs()
    return TIMED * AUDIO_BATCH / dt, st


def audio_phase(card):
    from dali_tpu_torch.testdata.make_audio_corpus import ensure_corpus

    t0 = time.perf_counter()
    root = ensure_corpus()
    print(f"audio corpus {os.path.relpath(root, HERE)}: 128 clips ready in "
          f"{time.perf_counter() - t0:.2f} s")
    pipe = make_asr_pipe(root, AUDIO_BATCH, "cuda:0")
    ex = pipe.executor
    cps, st = time_asr(pipe)
    print(f"e2e asr_frontend batch {AUDIO_BATCH}: {cps:.1f} clips/s over {TIMED} batches ({card})")
    print(f"during the timed batches: host phase {1e3 * st['host_phase_seconds'] / st['host_batches']:.2f}"
          f" ms/batch over {st['host_batches']} batches ({os.cpu_count()} host cores); the device"
          f" stage waited {1e3 * st['device_wait_seconds'] / TIMED:.2f} ms/batch for staged batches"
          f" ({card})")
    ex.record_stage_events = True
    check_audio_batch(pipe.run(), AUDIO_BATCH)
    torch.cuda.synchronize()
    require(not ex.record_stage_events and ex.stage_events, "the instrumented batch did not run")
    names = {"h2d": "H2D", "wire": "boundary", "_AudioToOutput": "int16->float",
             "PreemphasisFilter": "preemphasis", "Spectrogram": "spectrogram",
             "MelFilterBank": "mel", "ToDecibels": "dB", "Normalize": "normalize"}
    stages = {names[s]: a.elapsed_time(b) for s, a, b in ex.stage_events}
    print("audio stage ms: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f" ({card})")
    pipe.shutdown()

    outs = []
    for device in ("cuda:0", "cpu"):
        pipe = make_asr_pipe(root, 8, device)
        outs.append([pipe.run() for _ in range(2)])
        pipe.shutdown()
    worst = [0.0, 0.0]
    for got, want in zip(*outs):
        for k in (1, 2):
            g, w = got[k], want[k]
            require(tuple(g.as_tensor().shape) == tuple(w.as_tensor().shape)
                    and g.shape() == w.shape(), "card and CPU shapes differ")
            gs, ws = g.as_cpu(), w.as_cpu()
            for i in range(len(gs)):
                worst[k - 1] = max(worst[k - 1], float(abs(gs.at(i) - ws.at(i)).max()))
    print(f"asr_frontend card vs CPU (batch 8, 2 iterations): max abs diff dB {worst[0]:.3e}, "
          f"normalized {worst[1]:.3e} (limit {AUDIO_TOL})")
    require(max(worst) <= AUDIO_TOL, "the card's audio output disagrees with the CPU path")
    return cps, stages


def asr_resample_phase(card, asr_cps):
    """Phase 25: asr_resample."""
    from dali_tpu_torch.testdata.make_audio_corpus import ensure_corpus
    from dali_tpu_torch.tools import bench_dali_cpu

    t0 = time.perf_counter()
    root = ensure_corpus(rate=int(bench_dali_cpu.IN_RATE))
    print(f"48 kHz audio corpus {os.path.relpath(root, HERE)}: 128 clips ready in "
          f"{time.perf_counter() - t0:.2f} s")
    r = bench_dali_cpu.run_asr_resample(root, AUDIO_BATCH, WARMUP, ASR_RESAMPLE_TIMED)
    print(f"asr_resample batch {AUDIO_BATCH}: {r['clips_per_s']:.1f} clips/s over {r['timed']} "
          f"batches, {100 * r['clips_per_s'] / asr_cps:.1f}% of asr_frontend's {asr_cps:.1f} in "
          f"this run; host phase {r['host_ms_per_batch']:.2f} ms/batch ({os.cpu_count()} host "
          f"cores); device stage waited {r['device_wait_ms_per_batch']:.2f} ms/batch ({card})")
    print("asr_resample device ms of one batch alone: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(r["stage_ms"].items(), key=lambda kv: -kv[1]))
        + f"; AudioResample {r['resample_ms']:.3f} ms; peak device memory "
        f"{r['peak_gib']:.2f} GiB ({card})")
    k = bench_dali_cpu.check_asr_resample(root)
    print(f"asr_resample card vs CPU (batch {k['batch']}, {k['iterations']} iterations): "
          f"resampled {k['resampled_rel_to_peak']:.2e} of each clip's peak (limit "
          f"{bench_dali_cpu.RESAMPLE_RTOL}), dB {k['db_max_diff']:.2e} (limit "
          f"{bench_dali_cpu.DB_ATOL})")
    print(f"asr_resample phase: {time.perf_counter() - t0:.1f} s")
    return r["clips_per_s"]


def dali_cpu_phase(card, file_list, rn50_ips, augment=False, timed=DALI_CPU_TIMED,
                   base=None):
    """Phase 26 (rn50_dali_cpu) or, with ``augment``, phase 28
    (rn50_host_augment, its rate beside ``base``, rn50_dali_cpu's images/s);
    returns the path's CMN launches, the kernel's readings on the path's own
    batch and the path's images/s."""
    from dali_tpu_torch.tools import bench_dali_cpu, bench_ssd

    what = "rn50_host_augment" if augment else "rn50_dali_cpu"
    t0 = time.perf_counter()
    r = bench_dali_cpu.run_rn50_dali_cpu(file_list, BATCH, WARMUP, timed, augment=augment)
    beside = ("" if base is None else
              f" and {100 * r['images_per_s'] / base:.1f}% of rn50_dali_cpu's {base:.1f}")
    print(f"{what} batch {BATCH}: {r['images_per_s']:.1f} images/s over {r['timed']} "
          f"batches, {100 * r['images_per_s'] / rn50_ips:.1f}% of rn50_train's {rn50_ips:.1f}"
          f"{beside} in this run; cmn launches {r['cmn_launches']} ({card})")
    print(f"{what} host phase {r['host_ms_per_batch']:.2f} ms/batch ({os.cpu_count()} "
          f"host cores); device stage waited {r['device_wait_ms_per_batch']:.2f} ms/batch; host "
          "ms/batch by schema: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                             r["host_ms_by_schema"].items() if v >= 0.05)
          + f" ({card})")
    print(f"{what} device ms of one batch alone: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(r["stage_ms"].items(), key=lambda kv: -kv[1]))
        + f"; peak device memory {r['peak_gib']:.2f} GiB ({card})")
    pipe = bench_dali_cpu.make_rn50_pipe(file_list, BATCH, "cuda:0", augment=augment)
    with bench_ssd.recording_cmn([]) as calls:
        pipe.run()
    pipe.shutdown()
    c = dict(bench_ssd.time_cmn(calls[0]), max_abs_err=bench_ssd.hold_cmn(calls[0]))
    print(f"{what} CMN kernel on the path's own batch {c['shape_in']} {c['dtype_in']} "
          f"-> {c['shape_out']} float32: max abs diff vs plain {c['max_abs_err']:.3e} (limit "
          f"1e-05; path launches {r['cmn_launches']}); kernel alone {c['ms']:.4f} ms (cold L2), "
          f"wrapper {c['wrapper_ms']:.4f} ms, plain {c['plain_ms']:.4f} ms; {c['bytes']} bytes, "
          f"bound {c['bound_ms']:.4f} ms, {100 * c['bound_share']:.1f}% of it ({card})")
    k = bench_dali_cpu.check_rn50_dali_cpu(file_list, augment=augment)
    print(f"{what} card CMN vs host CMN (batch {k['batch']}, {k['iterations']} "
          f"iterations): labels equal, images {k['max_abs_diff']:.3e} apart (limit "
          f"{bench_dali_cpu.CMN_ATOL}) ({card})")
    print(f"{what} phase: {time.perf_counter() - t0:.1f} s")
    return r["cmn_launches"], c, r["images_per_s"]


def host_geometry_phase(card):
    """Phase 27: the three examples whole and the host ops timed."""
    from dali_tpu_torch.tools import bench_dali_cpu

    t0 = time.perf_counter()
    r = bench_dali_cpu.host_geometry(BATCH, (OUT, OUT))
    require("cv2" not in sys.modules, "cv2 was imported")
    print("examples run whole through the port: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in r["examples_s"].items()))
    for name, by_threads in r["host_ms"].items():
        print(f"host op {name} on [{BATCH}, {OUT}, {OUT}, 3] uint8: " + ", ".join(
            f"{v:.2f} ms/batch on {n} thread{'s' if n > 1 else ''}"
            for n, v in sorted(by_threads.items())) + f" ({card})")
    print(f"host geometry phase: {time.perf_counter() - t0:.1f} s")


def host_filters_phase(card):
    """Phase 29: augmentation_gallery.py whole, the host filters timed, and
    the ops' host and card placements held within their bounds."""
    from dali_tpu_torch.tools import bench_dali_cpu

    t0 = time.perf_counter()
    r = bench_dali_cpu.host_filters(BATCH, (OUT, OUT))
    require("cv2" not in sys.modules, "cv2 was imported")
    print("examples run whole through the port: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in r["examples_s"].items()) + f" ({card})")
    for name, by_threads in r["host_ms"].items():
        shape = f"[{BATCH}, {OUT}, {OUT}{'' if name.startswith('experimental.Debayer') else ', 3'}]"
        print(f"host op {name} on {shape} uint8: " + ", ".join(
            f"{v:.2f} ms/batch on {n} thread{'s' if n > 1 else ''}"
            for n, v in sorted(by_threads.items())) + f" ({card})")
    print("host vs card placements (batch 16, limits max diff / share): " + ", ".join(
        f"{k} {w:g} on {s:.2e} ({bench_dali_cpu.PLACEMENT_BOUNDS[k][0]} / "
        f"{bench_dali_cpu.PLACEMENT_BOUNDS[k][1]:g})" for k, (w, s) in r["placements"].items())
        + f" ({card})")
    print(f"host filters phase: {time.perf_counter() - t0:.1f} s")


def _policy(name, images):
    from dali_tpu_torch import auto_aug

    if name == "trivial_augment_wide":
        return auto_aug.trivial_augment_wide(images, num_magnitude_bins=31, fill_value=128)
    if name == "effnet_shape_translate":
        return auto_aug.trivial_augment_wide(images, num_magnitude_bins=31, fill_value=128,
                                             shape=[OUT, OUT])
    return auto_aug.auto_augment_image_net(images)


def make_aug_pipe(file_list, batch, out, device, policy, with_aug=False):
    """EfficientNet-B0's training input: RN50's reader, decode and resize,
    then the automatic augmentation ``policy``, mirror and CMN. With
    ``with_aug`` the uint8 augmentation output and its input are outputs too."""
    from dali_tpu_torch import fn, pipeline_def, types

    @pipeline_def(batch_size=batch, num_threads=os.cpu_count() or 1, seed=42,
                  prefetch_queue_depth=2, device=device, enable_conditionals=True)
    def effnet_train():
        jpegs, labels = fn.readers.file(file_list=file_list, random_shuffle=True, name="Reader")
        images = fn.decoders.image_random_crop(jpegs, device="mixed", hybrid_device_decode=True,
                                               hybrid_scale=2)
        resized = fn.resize(images, resize_x=out, resize_y=out)
        augmented = _policy(policy, resized)
        mirror = fn.random.coin_flip(probability=0.5)
        images = fn.crop_mirror_normalize(augmented, mirror=mirror, dtype=types.FLOAT,
                                          output_layout="CHW", mean=MEAN, std=STD)
        return (images, labels, augmented, resized) if with_aug else (images, labels)

    pipe = effnet_train()
    pipe.build()
    return pipe


def make_aug_only_pipe(data, device, policy):
    """The policy alone on a fixed uint8 batch."""
    from dali_tpu_torch import fn, pipeline_def

    @pipeline_def(batch_size=len(data), num_threads=1, seed=42, device=device,
                  enable_conditionals=True)
    def aug_only():
        return _policy(policy, fn.external_source(source=lambda: data, batch=True,
                                                  layout="HWC").gpu())

    pipe = aug_only()
    pipe.build()
    return pipe


def _stage_group(schema):
    if schema in ("wire", "_JpegIdctSplitRRC"):
        return "decode"
    return {"h2d": "H2D", "Resize": "resize", "CropMirrorNormalize": "CMN",
            "_conditional.Merge": "merges"}.get(schema, schema)


def aug_run(card, file_list, policy):
    """One policy at full width; returns its CMN launches and readings."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    pipe = make_aug_pipe(file_list, BATCH, OUT, "cuda:0", policy)
    timed = AUG_TIMED[policy]
    ips, st, by, launches = drive(pipe, timed, policy)
    ex = pipe.executor
    nb = st["host_batches"]
    if policy == "effnet_shape_translate":
        shape_ops = sorted({n.spec.schema_name for n in ex.device_ops} & {
            "Shapes", "Cast", "_TensorSubscript", "Reshape", "Cat", "Full"})
        require({"Shapes", "_TensorSubscript"} <= set(shape_ops),
                "the shape-relative translates did not run on the card")
        print(f"{policy}: shape ops on the card each batch: {', '.join(shape_ops)}")
    host_ms = 1e3 * st["host_phase_seconds"] / nb
    by = sorted(by.items(), key=lambda kv: -kv[1])
    print(f"{policy} batch {BATCH}: {ips:.1f} images/s over {timed} batches; {len(ex.device_ops)} "
          f"device ops, {len(ex.host_ops)} host ops; cmn launches {launches} ({card})")
    print(f"{policy} host phase {host_ms:.2f} ms/batch over {nb} batches ({os.cpu_count()} host "
          f"cores); device stage waited {1e3 * st['device_wait_seconds'] / timed:.2f} ms/batch; "
          "host ms/batch by schema: " + ", ".join(f"{k} {v:.2f}" for k, v in by if v >= 0.05))

    # one batch alone: no host phase competes with the device thread's launches
    ex.record_stage_events = True
    pipe.run()
    torch.cuda.synchronize()
    require(not ex.record_stage_events and ex.stage_events, "the instrumented batch did not run")
    stages = {}
    for s, a, b in ex.stage_events:
        g = _stage_group(s)
        stages[g] = stages.get(g, 0.0) + a.elapsed_time(b)
    total = sum(v for k, v in stages.items() if k != "H2D")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{policy} boundary edges {len(ex.boundary_edges)}, H2D window {stages.get('H2D', 0):.3f} ms;"
          f" device ms of one batch {total:.3f}: " + ", ".join(
              f"{k} {v:.3f}" for k, v in sorted(stages.items(), key=lambda kv: -kv[1]))
          + f"; peak device memory {peak:.2f} GiB ({card})")
    pipe.shutdown()
    wall = time.perf_counter() - t_phase
    print(f"{policy} phase wall time {wall:.1f} s")
    return launches, ips


def aug_check(policy, file_list):
    """The recipe at batch 16 on the card and on the CPU (plain versions):
    labels equal, and at least 99.9% of the augmentation output bit-equal (a
    one-step tie of the resize can move a later posterize, solarize or
    equalize by more). Then the policy alone on the card's resized batch,
    card against CPU: TrivialAugment within one step on at most 1e-3 of
    values, AutoAugment at least 99.9% bit-equal."""
    outs = []
    for device in ("cuda:0", "cpu"):
        pipe = make_aug_pipe(file_list, AUG_CHECK_BATCH, OUT, device, policy, with_aug=True)
        res = [pipe.run() for _ in range(2)]
        outs.append([(r[0].as_tensor().cpu(), r[1].as_array(), r[2].as_tensor().cpu(),
                      r[3].as_tensor().cpu()) for r in res])
        pipe.shutdown()
    same, frac_img = 1.0, 0.0
    for (g_img, g_lab, g_aug, _), (c_img, c_lab, c_aug, _) in zip(*outs):
        require((g_lab == c_lab).all(), f"{policy}: labels differ between card and CPU")
        same = min(same, float((g_aug == c_aug).float().mean()))
        frac_img = max(frac_img, float(((g_img - c_img).abs() > 1e-4).float().mean()))
    print(f"{policy} recipe card vs CPU (batch {AUG_CHECK_BATCH}, 2 iterations): labels equal, "
          f"augmentation output bit-equal on {same:.6f} of values (limit 0.999), CMN output "
          f"> 1e-4 apart on {frac_img:.2e}")
    require(same >= 0.999, f"{policy}: card and CPU recipe outputs disagree")

    data = outs[0][0][3].numpy()
    got = []
    for device in ("cuda:0", "cpu"):
        pipe = make_aug_only_pipe(data, device, policy)
        got.append(pipe.run()[0].as_tensor().cpu().to(torch.int32))
        pipe.shutdown()
    d = (got[0] - got[1]).abs()
    worst, frac = int(d.max()), float((d > 0).float().mean())
    print(f"{policy} alone on the same input, card vs CPU: max diff {worst}, fraction differing "
          f"{frac:.2e}")
    if policy != "auto_augment_image_net":
        require(worst <= 1 and frac <= 1e-3, f"{policy}: card and CPU disagree")
    else:
        require(frac <= 1e-3, f"{policy}: less than 99.9% of values bit-equal")


def aug_phase(card, file_list, policies=("trivial_augment_wide", "auto_augment_image_net")):
    launches = {}
    for policy in policies:
        launches[policy] = aug_run(card, file_list, policy)[0]
    for policy in policies:
        aug_check(policy, file_list)
    return launches


def check_images(data, what):
    require(data.is_cuda and data.dtype == torch.float32, f"{what}: {data.device} {data.dtype}")
    require(tuple(data.shape) == (BATCH, 3, OUT, OUT), f"{what}: shape {tuple(data.shape)}")
    require(bool(torch.isfinite(data).all()), f"{what}: non-finite values")


def _within_one_step(got, want, what):
    d = (got.float().cpu() - want.float().cpu()).abs()
    worst, frac = float(d.max()), float((d > 1e-4).float().mean())
    print(f"{what}: max abs diff {worst:.4f} (limit {LSB_OVER_STD + 1e-4:.4f}), fraction > 1e-4: "
          f"{frac:.2e} (limit 1e-3)")
    require(worst <= LSB_OVER_STD + 1e-4 and frac <= 1e-3, f"{what}: outputs disagree")


def ndd_phase(card, file_list, rn50_ips):
    """bench.py's bench_ndd at full width on the card; returns the CMN
    launches of the captured path and of the eager path."""
    import dali_tpu_torch.experimental.dynamic as ndd
    from dali_tpu_torch import types
    from dali_tpu_torch.kernels import cmn

    cores = os.cpu_count() or 1
    t_phase = time.perf_counter()
    with ndd.EvalContext(seed=42, num_threads=cores, device="cuda:0"):
        def read_batch():
            return ndd.readers.file(file_list=file_list, random_shuffle=True, batch_size=BATCH,
                                    name="R")

        @ndd.capture(num_threads=cores)
        def frontend(jpegs):
            images = ndd.decoders.image_random_crop(
                jpegs, device="mixed", hybrid_device_decode=True, hybrid_scale=2)
            images = ndd.resize(images, resize_x=OUT, resize_y=OUT)
            mirror = ndd.random.coin_flip(probability=0.5)
            return ndd.crop_mirror_normalize(
                images, mirror=mirror, dtype=types.FLOAT, output_layout="CHW", mean=MEAN,
                std=STD)

        def step():
            jpegs, _labels = read_batch()
            out = frontend(jpegs)
            check_images(out.as_array(), "ndd step")
            return out

        cmn.COUNTER.launches = 0
        for _ in range(WARMUP):
            step()
        torch.cuda.synchronize()
        pipe = frontend._captured_pipelines[BATCH]
        st0 = dict(pipe.executor.stats)
        t0 = time.perf_counter()
        for _ in range(AMP_TIMED):
            step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        captured = cmn.COUNTER.launches
        require(captured == WARMUP + AMP_TIMED,
                f"ndd: CMN kernel launched {captured} times for {WARMUP + AMP_TIMED} steps")
        st = {k: v - st0[k] for k, v in pipe.executor.stats.items()}
        ips = AMP_TIMED * BATCH / dt
        print(f"ndd_rn50 batch {BATCH}: {ips:.1f} images/s over {AMP_TIMED} steps, "
              f"{100 * ips / rn50_ips:.1f}% of rn50_train's {rn50_ips:.1f} in this run; captured "
              f"pipeline host phase {1e3 * st['host_phase_seconds'] / st['host_batches']:.2f} "
              f"ms/batch; cmn launches {captured} ({card})")

        @ndd.capture(num_threads=cores)
        def decode(jpegs):
            return ndd.decoders.image_random_crop(jpegs, device="mixed",
                                                  hybrid_device_decode=True, hybrid_scale=2)

        decoded = decode(read_batch()[0]).cpu()
        mirror = ndd.random.coin_flip(probability=0.5, batch_size=BATCH)
        for p in list(frontend._captured_pipelines.values()) + list(
                decode._captured_pipelines.values()):
            p.shutdown()

    def eager(x, m):
        x = ndd.resize(x.gpu(), resize_x=OUT, resize_y=OUT)
        return ndd.crop_mirror_normalize(x, mirror=m, dtype=types.FLOAT, output_layout="CHW",
                                         mean=MEAN, std=STD)

    samples = [decoded.at(i) for i in range(BATCH)]
    with ndd.EvalContext(seed=42, device="cuda:0"):
        cmn.COUNTER.launches = 0
        on_card = eager(ndd.as_batch(samples, layout="HWC"), mirror).as_array()
        torch.cuda.synchronize()
        eager_launches = cmn.COUNTER.launches
        require(eager_launches == 1, f"eager ndd: CMN kernel launched {eager_launches} times")
        check_images(on_card, "eager ndd")
        captured_eager = ndd.capture(eager)
        via_capture = captured_eager(ndd.as_batch(samples, layout="HWC"), mirror).as_array()
        for p in captured_eager._captured_pipelines.values():
            p.shutdown()
    with ndd.EvalContext(seed=42, device="cpu"):
        on_cpu = eager(ndd.as_batch(samples, layout="HWC"), mirror).as_array()
    _within_one_step(on_card, on_cpu, f"eager ndd card vs CPU (batch {BATCH})")
    _within_one_step(via_capture, on_card, f"captured vs eager ndd on the card (batch {BATCH})")
    print(f"ndd phase: {time.perf_counter() - t_phase:.1f} s")
    return captured, eager_launches, ips


def parallel_phase(card, file_list, rn50_ips):
    """RN50 fed by a parallel external source
    (``tools/bench_parallel_es.py``); returns its CMN launches."""
    from dali_tpu_torch.tools import bench_parallel_es

    t_phase = time.perf_counter()
    r, launches = bench_parallel_es.measure(file_list, BATCH, WARMUP, AMP_TIMED, check=check_batch)
    require(launches == r["batches"], f"parallel source: CMN kernel launched {launches} times for "
            f"{r['batches']} batches")
    print(f"rn50_parallel_es batch {BATCH}: {r['images_per_s']:.1f} images/s over {AMP_TIMED} "
          f"batches ({100 * r['images_per_s'] / rn50_ips:.1f}% of rn50_train's rate in this run), "
          f"{r['workers']} workers; host phase "
          f"{r['host_ms_per_batch']:.2f} ms/batch; device stage waited "
          f"{r['device_wait_ms_per_batch']:.2f} ms/batch; cmn launches {launches} ({card})")
    reference_phase(file_list, make=lambda b, d: bench_parallel_es.make_pipe(file_list, b, d),
                    what=" (parallel external source)")
    print(f"parallel source phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, r["images_per_s"]


def make_imagenet_pipe(file_list, batch, device, recipe):
    """imagenet_train (whole-image decode at hybrid_scale=2, RandomResizedCrop
    224, coin-flip mirror, CMN), rn50_val (decode at hybrid_scale=1,
    resize_shorter 256, CMN crop 224), rn50_host_decode (host decode with the
    random crop, resize 224 triangular, coin-flip CMN) or proxy_int16_wire
    (int16-wire decode at hybrid_scale=1, RandomResizedCrop 224, coin-flip
    CMN)."""
    from dali_tpu_torch import fn, pipeline_def, types

    train = recipe == "imagenet_train"

    @pipeline_def(batch_size=batch, num_threads=os.cpu_count() or 1, seed=42,
                  prefetch_queue_depth=2, device=device)
    def imagenet():
        jpegs, labels = fn.readers.file(file_list=file_list, random_shuffle=True, name="Reader")
        if recipe in ("rn50_host_decode", "proxy_int16_wire"):
            if recipe == "rn50_host_decode":
                images = fn.decoders.image_random_crop(
                    jpegs, device="mixed", output_type=types.RGB, random_area=[0.1, 1.0],
                    random_aspect_ratio=[0.8, 1.25], num_attempts=100)
                images = fn.resize(images, resize_x=OUT, resize_y=OUT,
                                   interp_type=types.INTERP_TRIANGULAR)
            else:
                images = fn.decoders.image(jpegs, device="mixed", hybrid_device_decode=True)
                images = fn.random_resized_crop(images, size=[OUT, OUT])
            return fn.crop_mirror_normalize(images, mirror=fn.random.coin_flip(probability=0.5),
                                            dtype=types.FLOAT, output_layout="CHW", mean=MEAN,
                                            std=STD), labels
        images = fn.decoders.image(jpegs, device="mixed", hybrid_device_decode=True,
                                   hybrid_scale=2 if train else 1, hybrid_wire="int8")
        if train:
            images = fn.random_resized_crop(images, size=[OUT, OUT])
            images = fn.crop_mirror_normalize(images, mirror=fn.random.coin_flip(probability=0.5),
                                              dtype=types.FLOAT, output_layout="CHW", mean=MEAN,
                                              std=STD)
        else:
            images = fn.resize(images, resize_shorter=256, interp_type=types.INTERP_TRIANGULAR)
            images = fn.crop_mirror_normalize(images, crop=(OUT, OUT), dtype=types.FLOAT,
                                              output_layout="CHW", mean=MEAN, std=STD)
        return images, labels

    return imagenet()


def imagenet_phase(card, file_list, rn50_ips, recipe, name=None, timed=None, check_batch=16):
    """One recipe at full width (reported as ``name``); returns its CMN
    launches and images/s."""
    t_phase = time.perf_counter()
    name = name or recipe
    torch.cuda.reset_peak_memory_stats()
    pipe = make_imagenet_pipe(file_list, BATCH, "cuda:0", recipe)
    timed = timed or RECIPE_TIMED[recipe]
    ips, st, _, launches = drive(pipe, timed, name)
    ex = pipe.executor
    print(f"{name} batch {BATCH}: {ips:.1f} images/s over {timed} batches, "
          f"{100 * ips / rn50_ips:.1f}% of rn50_train's {rn50_ips:.1f} in this run; "
          f"{host_line(st, timed)}; cmn launches {launches} ({card})")

    # one batch alone: no host phase competes with the device thread
    ex.record_stage_events = True
    pipe.run()
    torch.cuda.synchronize()
    require(not ex.record_stage_events and ex.stage_events, "the instrumented batch did not run")
    names = {"h2d": "H2D", "_JpegIdctSplit": "IDCT tail", "_JpegIdct": "IDCT tail",
             "CropMirrorNormalize": "CMN"}
    stages = {}
    for s_name, a, b in ex.stage_events:
        k = names.get(s_name, s_name)
        stages[k] = stages.get(k, 0.0) + a.elapsed_time(b)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{name} stage ms: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"; peak device memory {peak:.2f} GiB ({card})")
    pipe.shutdown()
    reference_phase(file_list, make=lambda b, d: make_imagenet_pipe(file_list, b, d, recipe),
                    what=f" ({name})", batch=check_batch)
    print(f"{name} phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, ips


def forms_phase(card, rn50_ips):
    """imagenet_forms: rn50_host_decode over every image form; then each
    form's single-threaded host decode (``imgcodec.decode``, RGB uint8, the
    route the reference takes). Returns the CMN launches and images/s."""
    from dali_tpu_torch import imgcodec

    file_list = write_file_list(forms=True)
    launches, ips = imagenet_phase(card, file_list, rn50_ips, "rn50_host_decode",
                                   name="imagenet_forms", timed=FORMS_TIMED,
                                   check_batch=FORMS_CHECK_BATCH)
    with open(file_list) as f:
        paths = list(dict.fromkeys(line.split()[0] for line in f if line.strip()))
    per_form = {}
    for path in [paths[0]] + [p for p in paths if os.sep + "codecs" + os.sep in p]:
        with open(path, "rb") as f:
            data = f.read()
        img = imgcodec.decode(data)
        require(img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3,
                f"{path}: decoded to {img.shape} {img.dtype}")
        t0 = time.perf_counter()
        for _ in range(FORMS_DECODE_REPS):
            imgcodec.decode(data)
        ms = 1e3 * (time.perf_counter() - t0) / FORMS_DECODE_REPS
        key = "baseline_420.jpg" if path == paths[0] else os.path.basename(path)
        per_form[key] = round(ms, 3)
        print(f"host decode {key} {img.shape[1]}x{img.shape[0]}: {ms:.3f} ms/image, one thread "
              f"({card})")
    print("imagenet_forms decode ms/image: " + json.dumps(per_form))
    return launches, ips


def ssd_phase(card, rn50_ips):
    """Phase 14: both SSD forms at batch 64, then the checks at batch 16;
    returns the CMN launches of each form."""
    from dali_tpu_torch.testdata.make_coco_annotations import write_annotations
    from dali_tpu_torch.tools import bench_ssd

    t_phase = time.perf_counter()
    ann = write_annotations(os.path.join(HERE, "build", "coco_annotations.json"), 0)
    launches, held = {}, {}
    for form, timed in SSD_TIMED.items():
        r = bench_ssd.measure(form, ann, SSD_BATCH, WARMUP, timed)
        launches[form] = r["cmn_launches"]
        stages = ", ".join(f"{k} {v:.3f}" for k, v in r["stage_ms"].items())
        print(f"{form} batch {SSD_BATCH}: {r['images_per_s']:.1f} images/s over {timed} batches, "
              f"{100 * r['images_per_s'] / rn50_ips:.1f}% of rn50_train's {rn50_ips:.1f} in this "
              f"run; host phase {r['host_ms_per_batch']:.2f} ms/batch ({os.cpu_count()} host "
              f"cores); device stage waited {r['device_wait_ms_per_batch']:.2f} ms/batch; cmn "
              f"launches {launches[form]} ({card})")
        print(f"{form} host ms/batch by schema: " + ", ".join(
            f"{k} {v:.2f}" for k, v in r["host_ms_by_schema"].items() if v >= 0.05))
        print(f"{form} stage ms of one batch alone: {stages}; peak device memory "
              f"{r['peak_gib']:.2f} GiB ({card})")
        c = r["cmn"]
        held[form] = c
        print(f"{form} CMN kernel on the path's own batch {c['shape_in']} {c['dtype_in']} -> "
              f"{c['shape_out']} float32: max abs diff vs plain {c['max_abs_err']:.3e} (limit "
              f"{bench_ssd.CMN_ATOL:g}; path launches {launches[form]}); kernel alone "
              f"{c['ms']:.4f} ms (cold L2), wrapper {c['wrapper_ms']:.4f} ms, plain "
              f"{c['plain_ms']:.4f} ms; {c['bytes']} bytes, bound {c['bound_ms']:.4f} ms, "
              f"{100 * c['bound_share']:.1f}% of it ({card})")

    anchors = bench_ssd.dboxes300_coco()
    runs = {}
    for device in ("cuda:0", "cpu"):
        pipe = bench_ssd.make_pipe(ann, SSD_CHECK_BATCH, device, "ssd_train", with_boxes=True)
        pipe.build()
        runs[device] = [[o.as_tensor().cpu() if k == 0 else o
                         for k, o in enumerate(pipe.run())] for _ in range(2)]
        pipe.shutdown()
    for got, want in zip(runs["cuda:0"], runs["cpu"]):
        for k, what in ((1, "encoded boxes"), (2, "encoded labels"), (3, "boxes"), (4, "labels")):
            require(all(np.array_equal(got[k].at(i), want[k].at(i))
                        for i in range(SSD_CHECK_BATCH)), f"ssd_train: {what} differ card vs CPU")
    _within_one_step(torch.cat([r[0] for r in runs["cuda:0"]]),
                     torch.cat([r[0] for r in runs["cpu"]]),
                     f"ssd_train card vs CPU (batch {SSD_CHECK_BATCH}, 2 iterations; boxes, labels "
                     "and encoded outputs equal)")
    pipe = bench_ssd.make_pipe(ann, SSD_CHECK_BATCH, "cuda:0", "ssd_device_encode",
                               with_boxes=True)
    pipe.build()
    ties, matched = [], 0
    for _ in range(2):
        _, eb, el, boxes, labels = pipe.run()
        for i in range(SSD_CHECK_BATCH):
            ties += bench_ssd.check_against_cpu_encoder(boxes.at(i), labels.at(i), eb.at(i),
                                                        el.at(i), anchors)
            matched += int((el.at(i) > 0).sum())
    pipe.shutdown()
    require(matched > 0, "ssd_device_encode: the encoder matched no anchor")
    print(f"ssd_device_encode BoxEncoder on the card vs the host encoder (batch {SSD_CHECK_BATCH}, "
          f"2 iterations, {matched} matched anchors): boxes within 1e-6, {len(ties)} label "
          f"mismatches, each a tie: {ties}")
    print(f"ssd phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, held


def readers_phase(card, rn50_ips):
    """Phases 15-17: wds_train and tfrecord_train at batch 256, each then at
    batch 16 against the CPU, and numpy_volumes; returns the CMN launches
    and the kernel's readings on each recipe's own batch."""
    from dali_tpu_torch.tools import bench_readers

    t_phase = time.perf_counter()
    data = bench_readers.write_datasets(os.path.join(HERE, "build", "reader_datasets"))
    print(f"reader datasets: {bench_readers.SAMPLES} samples as {bench_readers.FILES} tar shards "
          f"of JPEG and of WebP and {bench_readers.FILES} TFRecord files, written in "
          f"{time.perf_counter() - t_phase:.2f} s")
    launches, held, ips = {}, {}, {}
    for form in bench_readers.FORMS:
        r = bench_readers.measure(form, data[form], BATCH, WARMUP, READER_TIMED)
        launches[form] = r["cmn_launches"]
        ips[form] = r["images_per_s"]
        held[form] = c = r["cmn"]
        print(f"{form} batch {BATCH}: {r['images_per_s']:.1f} images/s over {READER_TIMED} "
              f"batches, {100 * r['images_per_s'] / rn50_ips:.1f}% of rn50_train's {rn50_ips:.1f} "
              f"in this run; host phase {r['host_ms_per_batch']:.2f} ms/batch ({os.cpu_count()} "
              f"host cores); device stage waited {r['device_wait_ms_per_batch']:.2f} ms/batch; cmn "
              f"launches {launches[form]} ({card})")
        print(f"{form} host ms/batch by schema: " + ", ".join(
            f"{k} {v:.2f}" for k, v in r["host_ms_by_schema"].items() if v >= 0.05))
        print(f"{form} stage ms of one batch alone: "
              + ", ".join(f"{k} {v:.3f}" for k, v in r["stage_ms"].items())
              + f"; peak device memory {r['peak_gib']:.2f} GiB ({card})")
        print(f"{form} CMN kernel on the path's own batch {c['shape_in']} {c['dtype_in']} -> "
              f"{c['shape_out']} float32: max abs diff vs plain {c['max_abs_err']:.3e} (limit "
              f"1e-05; path launches {launches[form]}); kernel alone {c['ms']:.4f} ms (cold L2), "
              f"wrapper {c['wrapper_ms']:.4f} ms, plain {c['plain_ms']:.4f} ms; {c['bytes']} "
              f"bytes, bound {c['bound_ms']:.4f} ms, {100 * c['bound_share']:.1f}% of it ({card})")
        reference_phase(None, make=lambda b, d, form=form: bench_readers.make_pipe(
            form, data[form], b, d), what=f" ({form})", batch=READER_CHECK_BATCH)
    written, volumes = bench_readers.numpy_phase(
        os.path.join(HERE, "build", "reader_datasets", "volumes"), warmup=WARMUP,
        timed=READER_TIMED)
    for v in volumes:
        print(f"numpy_volumes {v['form']} batch {v['batch']} ({v['bytes_per_batch']} bytes): "
              f"{v['gb_per_s']:.3f} GB/s over {v['timed']} batches; host phase "
              f"{v['host_ms_per_batch']:.2f} ms/batch; device stage waited "
              f"{v['device_wait_ms_per_batch']:.2f} ms/batch; H2D of one batch alone "
              f"{v['h2d_ms']:.3f} ms; on cuda:0, {v['bit_equal_batches']} batches bit-equal to "
              f"the cpu reader's ({card})")
    print(f"numpy volumes written in {written:.2f} s and deleted; readers phase: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return (launches, held, next(v["gb_per_s"] for v in volumes if v["form"] == "roi"), ips,
            data[bench_readers.WEBP_FORM])


def webp_phase(card, wds_ips, data):
    """Phase 33: wds_webp_train at batch 256 over the WebP shards the
    readers phase wrote, then at batch 16 against the CPU; returns the CMN
    launches and the kernel's readings on the path's own batch."""
    from dali_tpu_torch.tools import bench_readers

    t0 = time.perf_counter()
    form = bench_readers.WEBP_FORM
    r = bench_readers.measure(form, data, BATCH, WARMUP, READER_TIMED)
    c = r["cmn"]
    print(f"{form} batch {BATCH}: {r['images_per_s']:.1f} images/s over {READER_TIMED} batches, "
          f"{100 * r['images_per_s'] / wds_ips:.1f}% of wds_train's {wds_ips:.1f} in this run; "
          f"host phase {r['host_ms_per_batch']:.2f} ms/batch ({os.cpu_count()} host cores); "
          f"device stage waited {r['device_wait_ms_per_batch']:.2f} ms/batch; cmn launches "
          f"{r['cmn_launches']} ({card})")
    print(f"{form} host ms/batch by schema: " + ", ".join(
        f"{k} {v:.2f}" for k, v in r["host_ms_by_schema"].items() if v >= 0.05))
    print(f"{form} stage ms of one batch alone: "
          + ", ".join(f"{k} {v:.3f}" for k, v in r["stage_ms"].items())
          + f"; peak device memory {r['peak_gib']:.2f} GiB ({card})")
    d = bench_readers.webp_decode_ms(data, BATCH)
    print(f"{form} WebP decode of one batch ({d['batch']} images, one native call): "
          f"{d['one_thread_ms']:.1f} ms on one thread, {d['pool_ms']:.1f} ms on {d['threads']} "
          f"({1e3 * d['batch'] / d['pool_ms']:.1f} images/s) ({card})")
    print(f"{form} CMN kernel on the path's own batch {c['shape_in']} {c['dtype_in']} -> "
          f"{c['shape_out']} float32: max abs diff vs plain {c['max_abs_err']:.3e} (limit "
          f"1e-05; path launches {r['cmn_launches']}); kernel alone {c['ms']:.4f} ms (cold L2), "
          f"wrapper {c['wrapper_ms']:.4f} ms, plain {c['plain_ms']:.4f} ms; {c['bytes']} bytes, "
          f"bound {c['bound_ms']:.4f} ms, {100 * c['bound_share']:.1f}% of it ({card})")
    reference_phase(None, make=lambda b, dev: bench_readers.make_pipe(form, data, b, dev),
                    what=f" ({form})", batch=READER_CHECK_BATCH)
    print(f"{form} phase: {time.perf_counter() - t0:.1f} s")
    return r["cmn_launches"], c


def frontend_phase(card, file_list, rn50_ips):
    """Phases 18-20: serialized_rn50, effnet_shape_translate and
    volumes_zscore; returns the CMN launches of each path and the kernel's
    readings on serialized_rn50's batch."""
    from dali_tpu_torch.kernels import cmn
    from dali_tpu_torch.tools import bench_frontend, bench_ssd

    t_phase = time.perf_counter()
    dot = os.path.join(HERE, "build", "serialized_rn50.dot")
    # an epoch of 16 batches: the iterator stops at the end of its reader's epoch
    r, launches, pipe = bench_frontend.serialized_rn50(
        write_file_list(repeat=16), BATCH, OUT, "cuda:0", warmup=WARMUP, timed=FRONTEND_TIMED,
        dot_file=dot)
    print(f"serialized_rn50 batch {BATCH}: {r['images_per_s']:.1f} images/s over {r['timed']} "
          f"batches, {100 * r['images_per_s'] / rn50_ips:.1f}% of rn50_train's {rn50_ips:.1f} in "
          f"this run; host phase {r['host_ms_per_batch']:.2f} ms/batch, device stage waited "
          f"{r['device_wait_ms_per_batch']:.2f} ms/batch; cmn launches {launches} ({card})")
    print(f"serialized_rn50: a {r['payload_bytes']}-byte payload of the ops-built graph, "
          f"deserialized on cuda:0; {r['batches_equal']} batches bit-equal to the source "
          f"pipeline's; resumed from the iterator's checkpoints after batch "
          f"{bench_frontend.CHECKPOINT_AFTER} (counter {r['counter']}): {r['resumed_equal']} "
          f"batches equal to the uninterrupted run's; dot file {os.path.relpath(dot, HERE)} "
          f"({os.path.getsize(dot)} bytes)")
    print("serialized_rn50 executor_statistics(): " + json.dumps(pipe.executor_statistics()))
    with bench_ssd.recording_cmn([]) as calls:
        pipe.run()
    pipe.shutdown()
    c = dict(bench_ssd.time_cmn(calls[0]), max_abs_err=bench_ssd.hold_cmn(calls[0]))
    print(f"serialized_rn50 CMN kernel on the path's own batch {c['shape_in']} {c['dtype_in']} -> "
          f"{c['shape_out']} float32: max abs diff vs plain {c['max_abs_err']:.3e} (limit 1e-05; "
          f"path launches {launches}); kernel alone {c['ms']:.4f} ms (cold L2), wrapper "
          f"{c['wrapper_ms']:.4f} ms, plain {c['plain_ms']:.4f} ms; {c['bytes']} bytes, bound "
          f"{c['bound_ms']:.4f} ms, {100 * c['bound_share']:.1f}% of it ({card})")
    out = {"serialized_rn50": launches}

    t0 = time.perf_counter()
    out["effnet_shape_translate"], ips = aug_run(card, file_list, "effnet_shape_translate")
    print(f"effnet_shape_translate: {100 * ips / rn50_ips:.1f}% of rn50_train's rate")
    aug_check("effnet_shape_translate", file_list)
    print(f"effnet_shape_translate phase: {time.perf_counter() - t0:.1f} s")

    cmn.COUNTER.launches = 0
    written, v = bench_frontend.volumes_phase(os.path.join(HERE, "build", "frontend_volumes"),
                                              warmup=WARMUP, timed=VOLUMES_TIMED)
    out["volumes_zscore"] = cmn.COUNTER.launches
    print(f"volumes_zscore batch {v['batch']} ({v['bytes_per_batch']} bytes of volumes): "
          f"{v['gb_per_s']:.3f} GB/s over {v['timed']} batches; host phase "
          f"{v['host_ms_per_batch']:.2f} ms/batch; device stage waited "
          f"{v['device_wait_ms_per_batch']:.2f} ms/batch; stage ms of one batch alone: "
          + ", ".join(f"{k} {ms:.3f}" for k, ms in v["stage_ms"].items()) + f" ({card})")
    print(f"volumes_zscore card vs CPU ({v['checked_batches']} batches): windows bit-equal, "
          f"stacked output {v['max_rel_err']:.3e} apart relative (limit 1e-05); volumes written "
          f"in {written:.2f} s and deleted; cmn launches {out['volumes_zscore']} (no CMN on this "
          "path)")
    print(f"front-end phases: {time.perf_counter() - t_phase:.1f} s")
    return out, {"serialized_rn50": c}


def affine_mixup_phase(card, file_list, rn50_ips):
    """Phase 21: rn50_affine_mixup; returns its CMN launches and the
    kernel's readings on the path's own batch."""
    from dali_tpu_torch.tools import bench_affine_mixup, bench_ssd

    t0 = time.perf_counter()
    r = bench_affine_mixup.run_path(file_list, BATCH, OUT, warmup=WARMUP, timed=AFFINE_TIMED)
    print(f"rn50_affine_mixup batch {BATCH}: {r['images_per_s']:.1f} images/s over {r['timed']} "
          f"batches, {100 * r['images_per_s'] / rn50_ips:.1f}% of rn50_train's {rn50_ips:.1f} in "
          f"this run; {r['device_ops']} device ops, {r['host_ops']} host ops; cmn launches "
          f"{r['cmn_launches']} ({card})")
    print(f"rn50_affine_mixup host phase {r['host_ms_per_batch']:.2f} ms/batch ({os.cpu_count()} "
          f"host cores); device stage waited {r['device_wait_ms_per_batch']:.2f} ms/batch; host "
          "ms/batch by schema: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                             r["host_ms_by_schema"].items() if v >= 0.05))
    print(f"rn50_affine_mixup device ms of one batch alone {r['device_ms']:.3f}: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(r["stage_ms"].items(), key=lambda kv: -kv[1]))
        + f"; peak device memory {r['peak_gib']:.2f} GiB ({card})")
    pipe = bench_affine_mixup.make_pipe(file_list, BATCH, OUT, "cuda:0")
    with bench_ssd.recording_cmn([]) as calls:
        pipe.run()
    pipe.shutdown()
    c = dict(bench_ssd.time_cmn(calls[0]), max_abs_err=bench_ssd.hold_cmn(calls[0]))
    print(f"rn50_affine_mixup CMN kernel on the path's own batch {c['shape_in']} {c['dtype_in']} "
          f"-> {c['shape_out']} float32: max abs diff vs plain {c['max_abs_err']:.3e} (limit "
          f"1e-05; path launches {r['cmn_launches']}); kernel alone {c['ms']:.4f} ms (cold L2), "
          f"wrapper {c['wrapper_ms']:.4f} ms, plain {c['plain_ms']:.4f} ms; {c['bytes']} bytes, "
          f"bound {c['bound_ms']:.4f} ms, {100 * c['bound_share']:.1f}% of it ({card})")
    k = bench_affine_mixup.check_against_cpu(file_list, AFFINE_CHECK_BATCH, OUT)
    print(f"rn50_affine_mixup card vs CPU (batch {k['batch']}, {k['iterations']} iterations): "
          f"labels, permuted labels, lam, matrices and permutations equal; warped images max diff "
          f"{k['warped_max_diff']} on {k['warped_frac_differing']:.2e} of values (limits 1, "
          f"1e-3); device noise z-scores of the mean and mean square (limit 3): "
          + ", ".join(f"{a:+.2f} {b:+.2f}" for a, b in k["noise_z"])
          + f"; mixup {k['mix_max_err']:.1e} from its formula; the same seed twice bit-identical "
          "on the card")
    print(f"rn50_affine_mixup phase: {time.perf_counter() - t0:.1f} s")
    return r["cmn_launches"], c


def random_ops_phase(card):
    """Phase 22: the device random and noise ops at full size, the gpu
    distortion ops card vs CPU, and the custom-operators example."""
    from dali_tpu_torch.tools import bench_affine_mixup

    t0 = time.perf_counter()
    r = bench_affine_mixup.random_ops(BATCH, (OUT, OUT, 3))
    print(f"device random ops at {r['shape']}: " + ", ".join(
        f"{k} {v:.3g}" for k, v in r.items() if k.endswith(("_p", "_z")))
        + " (KS p > 1e-3, |z| <= 3); a new iteration draws a new stream; device ms of one batch: "
        + ", ".join(f"{k} {v:.3f}" for k, v in r["stage_ms"].items()) + f" ({card})")
    d = bench_affine_mixup.distortion_ops()
    print("gpu distortion ops card vs CPU: " + ", ".join(
        f"{k} max diff {v['max_diff']} on {v['frac_differing']:.2e}" for k, v in d.items()
        if isinstance(v, dict)) + "; jitter deterministic, new displacements per iteration")
    c = bench_affine_mixup.custom_operators()
    print(f"custom_operators example with fn.torch_function on the card: {c['outputs_checked']} "
          "outputs equal the example's asserted values")
    print(f"random ops phase: {time.perf_counter() - t0:.1f} s")


def rcm_jpeg_phase(card, file_list, rn50_ips, val_ips):
    """Phase 23: rn50_rcm_jpeg; returns its CMN launches and the kernel's
    readings on the path's own batch."""
    from dali_tpu_torch.tools import bench_rcm_jpeg, bench_ssd

    t0 = time.perf_counter()
    r = bench_rcm_jpeg.run_path(file_list, BATCH, OUT, warmup=WARMUP, timed=RCM_TIMED)
    print(f"rn50_rcm_jpeg batch {BATCH}: {r['images_per_s']:.1f} images/s over {r['timed']} "
          f"batches, {100 * r['images_per_s'] / rn50_ips:.1f}% of rn50_train's {rn50_ips:.1f} "
          f"and {100 * r['images_per_s'] / val_ips:.1f}% of rn50_val's {val_ips:.1f} in this run; "
          f"{r['device_ops']} device ops, {r['host_ops']} host ops; cmn launches "
          f"{r['cmn_launches']} ({card})")
    print(f"rn50_rcm_jpeg host phase {r['host_ms_per_batch']:.2f} ms/batch ({os.cpu_count()} "
          f"host cores); device stage waited {r['device_wait_ms_per_batch']:.2f} ms/batch; host "
          "ms/batch by schema: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                             r["host_ms_by_schema"].items() if v >= 0.05))
    print(f"rn50_rcm_jpeg device ms of one batch alone {r['device_ms']:.3f}: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(r["stage_ms"].items(), key=lambda kv: -kv[1]))
        + f"; peak device memory {r['peak_gib']:.2f} GiB ({card})")
    pipe = bench_rcm_jpeg.make_pipe(file_list, BATCH, "cuda:0")
    with bench_ssd.recording_cmn([]) as calls:
        pipe.run()
    pipe.shutdown()
    c = dict(bench_ssd.time_cmn(calls[0]), max_abs_err=bench_ssd.hold_cmn(calls[0]))
    print(f"rn50_rcm_jpeg CMN kernel on the path's own batch {c['shape_in']} {c['dtype_in']} "
          f"-> {c['shape_out']} float32: max abs diff vs plain {c['max_abs_err']:.3e} (limit "
          f"1e-05; path launches {r['cmn_launches']}); kernel alone {c['ms']:.4f} ms (cold L2), "
          f"wrapper {c['wrapper_ms']:.4f} ms, plain {c['plain_ms']:.4f} ms; {c['bytes']} bytes, "
          f"bound {c['bound_ms']:.4f} ms, {100 * c['bound_share']:.1f}% of it ({card})")
    k = bench_rcm_jpeg.check_against_cpu(file_list, RCM_CHECK_BATCH, OUT)
    print(f"rn50_rcm_jpeg card vs CPU (batch {k['batch']}, {k['iterations']} iterations): labels, "
          f"qualities, crop positions and mirrors equal; resized images max diff "
          f"{k['resized_max_diff']} on {k['resized_frac_differing']:.2e} of values (limits 1, "
          f"1e-3); distorted 8x8 blocks differing {k['jpeg_block_share']:.2e} (limit 1e-3, max "
          f"diff {k['jpeg_max_diff']}); normalised images {k['normalized_max_err']:.2e} apart "
          f"where the distorted pixels agree (limit {LSB_OVER_STD + 1e-4:.4f})")
    print(f"rn50_rcm_jpeg phase: {time.perf_counter() - t0:.1f} s")
    return r["cmn_launches"], c


def gpu_ops_phase(card):
    """Phase 24: the other gpu operators of item 5g, card vs CPU and device
    ms at full size."""
    from dali_tpu_torch.tools import bench_rcm_jpeg

    t0 = time.perf_counter()
    r, peak = bench_rcm_jpeg.gpu_ops(check_batch=16, batch=BATCH, hw=(OUT, OUT))
    for name, v in r.items():
        print(f"gpu op {name}: card vs CPU " + ", ".join(
            f"{k} {x:.3g}" if isinstance(x, float) else f"{k} {x}" for k, x in v["check"].items())
            + f"; device ms of one batch {v['shape']}: {v['ms']:.3f} ({card})")
    print(f"gpu ops peak device memory {peak:.2f} GiB; gpu ops phase: "
          f"{time.perf_counter() - t0:.1f} s")


def asr_flac_phase(card, asr_cps):
    """Phase 30: asr_frontend over the same 128 clips as 16-bit FLAC; the
    host decode ms of a batch, FLAC and WAV; one batch's dB mel bit-equal
    to the WAV path's on the card."""
    from dali_tpu_torch.testdata.make_audio_corpus import ensure_corpus
    from dali_tpu_torch.tools import bench_seq_volumes as bsv

    t0 = time.perf_counter()
    wav = ensure_corpus()
    root = ensure_corpus(fmt="flac")
    print(f"FLAC audio corpus {os.path.relpath(root, HERE)}: 128 clips ready in "
          f"{time.perf_counter() - t0:.2f} s")
    pipe = make_asr_pipe(root, AUDIO_BATCH, "cuda:0", ext="flac")
    cps, st = time_asr(pipe)
    pipe.shutdown()
    print(f"e2e asr_flac batch {AUDIO_BATCH}: {cps:.1f} clips/s over {TIMED} batches, "
          f"{100 * cps / asr_cps:.1f}% of asr_frontend's {asr_cps:.1f} in this run; host phase "
          f"{1e3 * st['host_phase_seconds'] / st['host_batches']:.2f} ms/batch "
          f"({os.cpu_count()} host cores); the device stage waited "
          f"{1e3 * st['device_wait_seconds'] / TIMED:.2f} ms/batch ({card})")
    ms = {ext: bsv.host_decode_ms(r, ext, AUDIO_BATCH) for ext, r in (("flac", root), ("wav", wav))}
    print(f"host decode of {AUDIO_BATCH} clips in one batch call on {os.cpu_count()} cores: "
          f"FLAC {ms['flac']:.2f} ms, WAV {ms['wav']:.2f} ms ({card})")
    outs = []
    for r, ext in ((root, "flac"), (wav, "wav")):
        pipe = make_asr_pipe(r, AUDIO_BATCH, "cuda:0", ext=ext)
        res = pipe.run()
        outs.append((res[1].as_tensor().clone(), res[1].shape()))
        pipe.shutdown()
    (g, g_sh), (w, w_sh) = outs
    require(g.is_cuda and g_sh == w_sh and torch.equal(g, w),
            "asr_flac: the dB mel of the FLAC batch differs from the WAV batch's on the card")
    print(f"asr_flac dB mel of one batch {tuple(g.shape)} on the card bit-equal to the WAV path's; "
          f"asr_flac phase: {time.perf_counter() - t0:.1f} s")
    return cps


def sequence_phase(card, rn50_ips):
    """Phase 31: sequence_augment (``tools/bench_seq_volumes.py``); returns
    the CMN launches and the kernel's readings on the path's batch."""
    from dali_tpu_torch.tools import bench_seq_volumes as bsv

    t0 = time.perf_counter()
    root = bsv.ensure_sequence_corpus()
    print(f"sequence corpus {os.path.relpath(root, HERE)}: 32 sequences of {bsv.SEQ_FRAMES} "
          f"BMP frames ready in {time.perf_counter() - t0:.2f} s")
    r = bsv.run_sequences(root, warmup=WARMUP, timed=SEQ_TIMED)
    c = r["cmn"]
    print(f"sequence_augment batch {r['batch']}x{bsv.SEQ_FRAMES} frames: {r['frames_per_s']:.1f} "
          f"frames/s over {r['timed']} batches ({100 * r['frames_per_s'] / rn50_ips:.1f}% of "
          f"rn50_train's {rn50_ips:.1f} images/s in this run); host phase "
          f"{r['host_ms_per_batch']:.2f} ms/batch ({os.cpu_count()} host cores); device stage "
          f"waited {r['device_wait_ms_per_batch']:.2f} ms/batch; cmn launches "
          f"{r['cmn_launches']} ({card})")
    print("sequence_augment host ms/batch by schema: " + ", ".join(
        f"{k} {v:.2f}" for k, v in r["host_ms_by_schema"].items() if v >= 0.05))
    print("sequence_augment device ms of one batch alone: " + ", ".join(
        f"{k} {v:.3f}" for k, v in r["stage_ms"].items())
        + f"; peak device memory {r['peak_gib']:.2f} GiB ({card})")
    print(f"sequence_augment CMN kernel (FCHW fold) on the path's own batch {c['shape_in']} "
          f"{c['dtype_in']} -> {c['shape_out']} float32: max abs diff vs plain "
          f"{c['max_abs_err']:.3e} (limit 1e-05); kernel alone {c['ms']:.4f} ms (cold L2), "
          f"wrapper {c['wrapper_ms']:.4f} ms, plain {c['plain_ms']:.4f} ms; {c['bytes']} bytes, "
          f"bound {c['bound_ms']:.4f} ms, {100 * c['bound_share']:.1f}% of it ({card})")
    k = bsv.check_sequences(root)
    print(f"sequence_augment card vs CPU (batch {k['batch']}, {k['iterations']} iterations): "
          + ", ".join(f"{n} max diff {k[n]['max_diff']:.3g} on {k[n]['frac_differing']:.2e} of "
                      "values" for n in ("warp", "blur", "equalize", "normalized"))
          + f" (limits one step, one uint8 step / std, on 1e-3); sequence_augment phase: "
          f"{time.perf_counter() - t0:.1f} s")
    return r["cmn_launches"], c


def volume_phase(card, numpy_roi_gbps):
    """Phase 32: volume_augment (``tools/bench_seq_volumes.py``)."""
    from dali_tpu_torch.tools import bench_seq_volumes as bsv

    t0 = time.perf_counter()
    written, r = bsv.volume_phase(os.path.join(HERE, "build", "volume_augment"), warmup=WARMUP,
                                  timed=VOLUME_AUGMENT_TIMED)
    print(f"volume_augment batch {r['batch']} ({r['bytes_per_batch']} bytes of 128^3 ROI): "
          f"{r['gb_per_s']:.3f} GB/s over {r['timed']} batches, {100 * r['gb_per_s'] / numpy_roi_gbps:.1f}%"
          f" of numpy_volumes' ROI {numpy_roi_gbps:.3f} GB/s in this run; host phase "
          f"{r['host_ms_per_batch']:.2f} ms/batch; device stage waited "
          f"{r['device_wait_ms_per_batch']:.2f} ms/batch ({card})")
    print("volume_augment device ms of one batch alone: " + ", ".join(
        f"{k} {v:.3f}" for k, v in r["stage_ms"].items())
        + f"; peak device memory {r['peak_gib']:.2f} GiB ({card})")
    k = r["check"]
    print(f"volume_augment card vs CPU (batch {k['batch']}, ROI {k['roi']}): max abs diff "
          f"{k['max_abs_diff']:.3e} (limit {bsv.VOLUME_ATOL}); volumes written in {written:.2f} s "
          f"and deleted; volume_augment phase: {time.perf_counter() - t0:.1f} s")


def proxy_phase(card, rn50_ips, parallel_ips):
    """Phase 34: rn50_dataloader_proxy; returns its CMN launches and the
    kernel's readings on the path's own batch."""
    from dali_tpu_torch.tools import bench_plugins

    t0 = time.perf_counter()
    r = bench_plugins.measure_proxy(BATCH, WARMUP, PLUGIN_TIMED)
    c = r["cmn"]
    print(f"rn50_dataloader_proxy batch {BATCH}: {r['images_per_s']:.1f} images/s over "
          f"{PLUGIN_TIMED} batches, {100 * r['images_per_s'] / rn50_ips:.1f}% of rn50_train's "
          f"{rn50_ips:.1f} and {100 * r['images_per_s'] / parallel_ips:.1f}% of "
          f"rn50_parallel_es's {parallel_ips:.1f} in this run; {r['workers']} DataLoader workers; "
          f"host phase {r['host_ms_per_batch']:.2f} ms/batch; pipeline run "
          f"{r['run_ms_per_batch']:.2f} ms/batch, waiting for the workers "
          f"{r['loader_wait_ms_per_batch']:.2f} ms/batch; cmn launches {r['cmn_launches']} "
          f"({card})")
    print(f"rn50_dataloader_proxy CMN kernel on the path's own batch {c['shape_in']} "
          f"{c['dtype_in']} -> {c['shape_out']} float32: max abs diff vs plain "
          f"{c['max_abs_err']:.3e} (limit 1e-05); kernel alone {c['ms']:.4f} ms (cold L2), "
          f"wrapper {c['wrapper_ms']:.4f} ms, plain {c['plain_ms']:.4f} ms; bound "
          f"{c['bound_ms']:.4f} ms, {100 * c['bound_share']:.1f}% of it ({card})")
    worst, frac = bench_plugins.proxy_card_vs_cpu(16)
    limit = LSB_OVER_STD + 1e-4
    print(f"card vs CPU plain path (rn50_dataloader_proxy) (batch 16, 2 batches): max abs diff "
          f"{worst:.4f} (limit {limit:.4f}), fraction > 1.0e-04: {frac:.2e} (limit 1e-3)")
    require(worst <= limit and frac <= 1e-3,
            "the card's output disagrees with the CPU reference path")
    print(f"rn50_dataloader_proxy phase: {time.perf_counter() - t0:.1f} s")
    return r["cmn_launches"], c


def capi_phase(card, val_ips):
    """Phase 35: rn50_capi_serve; returns its CMN launches and the kernel's
    readings on the path's own batch."""
    from dali_tpu_torch.tools import bench_plugins

    t0 = time.perf_counter()
    r = bench_plugins.measure_serve(BATCH, WARMUP, PLUGIN_TIMED)
    c = r["cmn"]
    print(f"C API library built in {r['capi_build_s']:.2f} s: "
          f"{os.path.relpath(r['library'], HERE)}; model {os.path.relpath(r['model'], HERE)}")
    print(f"rn50_capi_serve batch {BATCH}: {r['images_per_s']:.1f} images/s over "
          f"{PLUGIN_TIMED} batches through the C API ({r['copy_out_mb_per_batch']:.1f} MB copied "
          f"out a batch), {100 * r['images_per_s'] / val_ips:.1f}% of rn50_val's {val_ips:.1f} "
          f"in this run; cmn launches {r['cmn_launches']} ({card})")
    print(f"rn50_capi_serve CMN kernel on the path's own batch {c['shape_in']} {c['dtype_in']} "
          f"-> {c['shape_out']} float32: max abs diff vs plain {c['max_abs_err']:.3e} (limit "
          f"1e-05); kernel alone {c['ms']:.4f} ms (cold L2), wrapper {c['wrapper_ms']:.4f} ms, "
          f"plain {c['plain_ms']:.4f} ms; bound {c['bound_ms']:.4f} ms, "
          f"{100 * c['bound_share']:.1f}% of it ({card})")
    secs, n = bench_plugins.client_vs_python(r["library"], r["model"], BATCH)
    print(f"rn50_capi_serve C client (test_capi.c --serve, a subprocess on the card): one batch "
          f"in {secs:.1f} s with its start, {n} output samples bit-equal to "
          f"Pipeline.deserialize's run in Python")
    print(f"rn50_capi_serve phase: {time.perf_counter() - t0:.1f} s")
    return r["cmn_launches"], c


def asr_mp3_phase(card, asr_cps, resample_cps):
    """Phase 36: asr_mp3; returns its CMN launches (none expected)."""
    from dali_tpu_torch.kernels import cmn
    from dali_tpu_torch.tools import bench_audio_codecs as bac
    from dali_tpu_torch.tools import bench_dali_cpu

    t0 = time.perf_counter()
    cmn.COUNTER.launches = 0
    r = bac.run_asr_mp3(AUDIO_BATCH, WARMUP, TIMED)
    launches = cmn.COUNTER.launches
    print(f"e2e asr_mp3 batch {AUDIO_BATCH}: {r['clips_per_s']:.1f} clips/s over {r['timed']} "
          f"batches, {100 * r['clips_per_s'] / asr_cps:.1f}% of asr_frontend's {asr_cps:.1f} and "
          f"{100 * r['clips_per_s'] / resample_cps:.1f}% of asr_resample's {resample_cps:.1f} in "
          f"this run; host phase {r['host_ms_per_batch']:.2f} ms/batch ({os.cpu_count()} host "
          f"cores); device stage waited {r['device_wait_ms_per_batch']:.2f} ms/batch; cmn "
          f"launches {launches} (no CMN on this path) ({card})")
    print(f"asr_mp3 MP3 decode of one batch ({AUDIO_BATCH} clips, "
          f"{r['audio_seconds_per_batch']:.1f} s of 48 kHz audio): "
          f"{r['decode_ms_one_thread']:.1f} ms on one thread "
          f"({r['audio_seconds_per_batch'] / (r['decode_ms_one_thread'] / 1e3):.0f}x real time), "
          f"{r['decode_ms_pool']:.1f} ms on {r['cores']} threads; device ms of one batch alone: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(r["stage_ms"].items(),
                                                         key=lambda kv: -kv[1]))
          + f"; peak device memory {r['peak_gib']:.2f} GiB ({card})")
    k = r["check"]
    print(f"asr_mp3 card vs CPU (batch {k['batch']}, {k['iterations']} iterations): resampled "
          f"{k['resampled_rel_to_peak']:.2e} of each clip's peak (limit "
          f"{bench_dali_cpu.RESAMPLE_RTOL}), dB {k['db_max_diff']:.2e} (limit "
          f"{bench_dali_cpu.DB_ATOL}); asr_mp3 phase: {time.perf_counter() - t0:.1f} s")
    return launches


def audio_codecs_phase(card):
    """Phase 37: the MP3 and Vorbis fixtures against reference.npz, then a
    Vorbis batch through asr_mp3's graph, card against CPU."""
    from dali_tpu_torch.tools import bench_audio_codecs as bac
    from dali_tpu_torch.tools import bench_dali_cpu

    t0 = time.perf_counter()
    r = bac.run_audio_codecs()
    f = r["fixtures"]
    print(f"audio codecs: {f['fixtures']['mp3']} MP3 and {f['fixtures']['vorbis']} Vorbis "
          f"fixtures decoded on this machine against reference.npz: lengths, channels and rates "
          f"equal, worst max abs {f['worst']['max_abs']:.2e} (limit {bac.MAX_BOUND:.2e}), worst "
          f"RMS {f['worst']['rms']:.2e} (limit {bac.RMS_BOUND:.2e}); {f['failing']} streams "
          f"raise as they should")
    k = r["vorbis_check"]
    print(f"Vorbis batch of {r['vorbis_batch']} clips: decode {r['vorbis_decode_ms_pool']:.1f} ms "
          f"on {os.cpu_count()} threads; card vs CPU resampled {k['resampled_rel_to_peak']:.2e} "
          f"of each clip's peak (limit {bench_dali_cpu.RESAMPLE_RTOL}), dB "
          f"{k['db_max_diff']:.2e} (limit {bench_dali_cpu.DB_ATOL}) ({card}); audio codecs "
          f"phase: {time.perf_counter() - t0:.1f} s")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import dali_tpu_torch  # noqa: F401  (fails when run outside the repository)

    card = card_line()
    print(f"card: {card}; torch: {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    build_phase()
    forms, copy = cmn_phase(card)
    file_list = write_file_list()
    launches, rn50_ips, _ = e2e_phase(card, file_list)
    launches = {"rn50": launches}
    reference_phase(file_list)
    launches["rn50_fp16_hwc"] = amp_phase(card, file_list)[0]
    t0 = time.perf_counter()
    asr_cps = audio_phase(card)[0]
    print(f"audio phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(aug_phase(card, file_list))
    print(f"augmentation phase: {time.perf_counter() - t0:.1f} s")
    launches["ndd_rn50_captured"], launches["ndd_eager"], _ = ndd_phase(card, file_list, rn50_ips)
    launches["rn50_parallel_es"], parallel_ips = parallel_phase(card, file_list, rn50_ips)
    recipe_ips = {}
    for recipe in RECIPE_TIMED:
        launches[recipe], recipe_ips[recipe] = imagenet_phase(card, file_list, rn50_ips, recipe)
    launches["imagenet_forms"] = forms_phase(card, rn50_ips)[0]
    ssd_launches, path_cmn = ssd_phase(card, rn50_ips)
    launches.update(ssd_launches)
    reader_launches, reader_cmn, numpy_roi_gbps, reader_ips, webp_data = readers_phase(
        card, rn50_ips)
    launches.update(reader_launches)
    path_cmn.update(reader_cmn)
    frontend_launches, frontend_cmn = frontend_phase(card, file_list, rn50_ips)
    launches.update(frontend_launches)
    path_cmn.update(frontend_cmn)
    launches["rn50_affine_mixup"], path_cmn["rn50_affine_mixup"] = affine_mixup_phase(
        card, file_list, rn50_ips)
    random_ops_phase(card)
    launches["rn50_rcm_jpeg"], path_cmn["rn50_rcm_jpeg"] = rcm_jpeg_phase(
        card, file_list, rn50_ips, recipe_ips["rn50_val"])
    gpu_ops_phase(card)
    resample_cps = asr_resample_phase(card, asr_cps)
    launches["rn50_dali_cpu"], path_cmn["rn50_dali_cpu"], dali_cpu_ips = dali_cpu_phase(
        card, file_list, rn50_ips)
    host_geometry_phase(card)
    launches["rn50_host_augment"], path_cmn["rn50_host_augment"], _ = dali_cpu_phase(
        card, file_list, rn50_ips, augment=True, timed=HOST_AUGMENT_TIMED, base=dali_cpu_ips)
    host_filters_phase(card)
    asr_flac_phase(card, asr_cps)
    launches["sequence_augment"], path_cmn["sequence_augment"] = sequence_phase(card, rn50_ips)
    volume_phase(card, numpy_roi_gbps)
    launches["wds_webp_train"], path_cmn["wds_webp_train"] = webp_phase(
        card, reader_ips["wds_train"], webp_data)
    launches["rn50_dataloader_proxy"], path_cmn["rn50_dataloader_proxy"] = proxy_phase(
        card, rn50_ips, parallel_ips)
    launches["rn50_capi_serve"], path_cmn["rn50_capi_serve"] = capi_phase(
        card, recipe_ips["rn50_val"])
    launches["asr_mp3"] = asr_mp3_phase(card, asr_cps, resample_cps)
    audio_codecs_phase(card)
    print("CMN launches of the main paths: " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    main_form = forms[0]  # u8 -> f32 CHW, the RN50 and augmentation paths' form
    print(json.dumps({"kernels": [{
        "name": "crop_mirror_normalize", "route": "cuda",
        "source": "dali_tpu_torch/csrc/cmn.cu",
        "replaces": "dali_tpu/kernels/cmn_pallas.py:58",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": main_form["max_abs_err"], "ms": main_form["ms"],
        "plain_ms": main_form["plain_ms"], "bound_ms": main_form["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "yardstick_copy_ms": copy["ms"],
        "forms": [{k: f[k] for k in FORM_KEYS} for f in forms]
        + [dict({k: c[k] for k in FORM_KEYS if k != "name"}, name=f"{path}_path_batch",
                shape_in=c["shape_in"], dtype_in=c["dtype_in"]) for path, c in path_cmn.items()]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
