"""Video readers (counterpart of ``dali_tpu/backend/video.py``):
``readers.Video`` and ``experimental.inputs.Video``, cpu and mixed, over
the port's own MP4 and AVI host decode (``native.VideoFile``,
``csrc/host/video_decode.cc``), whose frames equal the reference's FFmpeg
decode bit for bit.

The mixed placements ship 4:2:0 frames across the host -> device boundary
as the planar YUV wire (``batch.YUVStaged``: 1.5 bytes a pixel against
RGB24's 3); the device rebuilds RGB with the host's integer BT.601
(``kernels.wire.yuv420_boundary``), so cpu and mixed outputs are bit-equal.
The mixed reader decodes a batch's sequences at once on the task pool
(``native.video_read_batch``, one task per file). Float, luma and
``pad_mode`` none/constant outputs take the dense RGB path, as in the
reference, and so do streams that are not 4:2:0 (pixel-format class 0:
HuffYUV, FFV1 and Motion JPEG 4:2:2/4:4:4/grey), which the host converts
to RGB as libswscale does (``csrc/host/sws_rgb.cc``).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List

import numpy as np

from .. import native
from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import HostBatch, YUVStaged
from .base import Operator, SamplePool
from .readers import BaseReader

_INT32_MAX = 2**31 - 1

# files a reader keeps open: each holds its sample table, two decoder
# pictures and a file descriptor; the least recently used one is dropped,
# and closed once no read holds it (the next read of it opens it anew and
# seeks, which gives the same frames)
_MAX_OPEN_FILES = 64


def stage_yuv_batch(dims, full_range, decode_into):
    """The planar YUV wire of a batch (counterpart of the reference's
    ``stage_yuv_batch``): per-sample offsets and shapes, flat plane buffers
    and the container. ``dims``: planned luma dims ``[(emit, h, w)]``;
    ``decode_into(i, ys, us, vs, emit)`` decodes sample i into its flat
    slices and returns the frames it emitted (fewer only for a sample
    planned as shrinkable). The canvas returned is the batch's own; the
    executor merges it into the edge's grow-only canvas."""
    n = len(dims)
    shapes = np.empty((n, 4), np.int64)
    yoffs = np.zeros(n, np.int64)
    coffs = np.zeros(n, np.int64)
    ytot = ctot = 0
    for i, (emit, h_, w_) in enumerate(dims):
        shapes[i] = (emit, h_, w_, 3)
        yoffs[i], coffs[i] = ytot, ctot
        ytot += emit * h_ * w_
        ctot += emit * ((h_ + 1) // 2) * ((w_ + 1) // 2)
    if ytot > _INT32_MAX or ctot > _INT32_MAX:
        raise ValueError(
            f"video batch luma/chroma wire ({ytot} / {ctot} elements) exceeds int32 offset "
            "addressing: reduce batch_size or sequence_length (a padded dense canvas at this "
            "size would not fit either)")
    ybuf = np.empty(ytot, np.uint8)
    ubuf = np.empty(ctot, np.uint8)
    vbuf = np.empty(ctot, np.uint8)

    for i, (emit, h_, w_) in enumerate(dims):
        fy = emit * h_ * w_
        fc = emit * ((h_ + 1) // 2) * ((w_ + 1) // 2)
        shapes[i, 0] = decode_into(i, ybuf[yoffs[i]: yoffs[i] + fy],
                                   ubuf[coffs[i]: coffs[i] + fc],
                                   vbuf[coffs[i]: coffs[i] + fc], emit)
    canvas = [int(shapes[:, d].max()) if n else 0 for d in range(3)] + [3]
    return YUVStaged(ybuf, ubuf, vbuf, np.stack([yoffs, coffs]).astype(np.int32), shapes,
                     canvas, full_range)


def pad_indices(got: int, want: int, mode: str) -> np.ndarray:
    """Source index of each padded slot [got, want) (the reference's
    pad_mode semantics); -1 for constant padding."""
    extra = want - got
    if mode == "constant":
        return np.full(extra, -1, np.int64)
    if mode in ("edge", "repeat"):
        return np.full(extra, got - 1, np.int64)
    if mode in ("reflect_1001", "symmetric"):
        return np.array([(got - 1) - (i % got) if (i // got) % 2 == 0 else i % got
                         for i in range(extra)], np.int64)
    if mode in ("reflect_101", "reflect"):
        if got == 1:
            return np.full(extra, 0, np.int64)
        period = 2 * (got - 1)
        idx = []
        for i in range(extra):
            p = (got - 2 - i) % period
            idx.append(p if p < got else period - p)
        return np.asarray(idx, np.int64)
    raise ValueError(f"Unknown pad_mode {mode!r}")


def pad_frames(frames: np.ndarray, want: int, mode: str, fill=0.0) -> np.ndarray:
    """Pads a short [F, H, W, C] sequence to ``want`` frames (none, constant,
    edge/repeat and the reflect modes)."""
    got = frames.shape[0]
    if want - got <= 0 or mode == "none" or got == 0:
        return frames
    idx = pad_indices(got, want, mode)
    if mode == "constant":
        fv = np.asarray(fill, np.float64).reshape(-1)
        pad = np.empty((len(idx),) + frames.shape[1:], frames.dtype)
        pad[...] = fv if fv.size == frames.shape[-1] else fv[0]
    else:
        pad = frames[idx]
    return np.concatenate([frames, pad], axis=0)


DALI_SCHEMA("readers.Video").DocStr(
    """Reads fixed-length frame sequences from video files (reference
    ``readers__Video``). Outputs [F, H, W, C] uint8 (+ label when
    ``file_list``/``labels`` given). Host MP4 and AVI decode."""
).NumInput(0).OutputFn(
    lambda spec: (1 + (1 if (spec.GetArgument("labels", None)
                             or spec.GetArgument("file_list", None)
                             or spec.GetArgument("file_root", None)) else 0)
                  + (1 if spec.GetArgument("enable_frame_num", False) else 0)
                  + (1 if spec.GetArgument("enable_timestamps", False) else 0))
).Devices(
    "cpu", "mixed"
).MakeReader().AddOptionalArg(
    "filenames", ArgType.STRING_VEC, "Video file paths.", None
).AddOptionalArg(
    "file_root", ArgType.STRING, "Directory with class subdirs of videos.", None
).AddOptionalArg(
    "file_list", ArgType.STRING, "File with 'path label [start end]' lines.", None
).AddOptionalArg(
    "labels", ArgType.INT_VEC, "Labels for `filenames`.", None
).AddArg("sequence_length", ArgType.INT, "Frames per sample.").AddOptionalArg(
    "step", ArgType.INT, "Frame distance between first frames of sequences (-1 = sequence_length).",
    -1
).AddOptionalArg(
    "stride", ArgType.INT, "Distance between consecutive frames.", 1
).AddOptionalArg(
    "image_type", ArgType.IMAGE_TYPE, "Output color space (RGB).", None
).AddOptionalArg(
    "enable_frame_num", ArgType.BOOL,
    "Extra output: the sequence's first frame index (reference readers__Video "
    "`enable_frame_num`).", False
).AddOptionalArg(
    "enable_timestamps", ArgType.BOOL,
    "Extra output: per-frame timestamps in seconds (frame/fps).", False
).AddOptionalArg(
    "pad_sequences", ArgType.BOOL,
    "Also emit trailing sequences that run past the video's end, padded by repeating the "
    "last frame (reference `pad_sequences`).", False
).AddOptionalArg(
    "normalized", ArgType.BOOL, "Output floats scaled to [0, 1].", False
).AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Output dtype (UINT8 or FLOAT).", None
).AddOptionalArg(
    "channels", ArgType.INT, "Output channels: 3 (RGB) or 1 (luma).", 3
).AddOptionalArg(
    "skip_vfr_check", ArgType.BOOL,
    "Skip the variable-frame-rate check (compat hint; the host decoder indexes frames by "
    "their timestamps).", False
).AddOptionalArg(
    "file_list_frame_num", ArgType.BOOL,
    "file_list start/end columns are frame numbers (True) or seconds (False).", False
).AddOptionalArg(
    "file_list_include_preceding_frame", ArgType.BOOL,
    "Seconds-based ranges include the frame straddling the start time.", False
).AddOptionalArg(
    "file_list_format", ArgType.STRING,
    'Experimental-reader form of the file_list range columns: "frames" or "timestamps" '
    "(reference experimental readers__Video `file_list_format`; overrides "
    "file_list_frame_num when set).", None
).AddOptionalArg(
    "file_list_rounding", ArgType.STRING,
    'Non-exact frame-match rounding: "start_down_end_up" (default), "start_up_end_down", '
    '"all_up", "all_down".', "start_down_end_up"
).AddOptionalArg(
    "file_list_include_end", ArgType.BOOL, "Include the end frame in the range.", True
).AddOptionalArg(
    "uniform_sample", ArgType.BOOL,
    "One sequence per video: sequence_length frames spread evenly over the video (linspace "
    "rounded half away from zero; repeats when the video is shorter). stride/step/pad_mode "
    "are ignored.", False
).AddOptionalArg(
    "pad_mode", ArgType.STRING,
    'Short-sequence handling: "none" (emit shorter tails), "constant" (fill_value), '
    '"edge"/"repeat", "reflect_101", "reflect_1001". When set, tail sequences past the '
    "video end are emitted (like pad_sequences).", None
).AddOptionalArg(
    "fill_value", ArgType.INT_VEC,
    "Pad value(s) 0..255 for pad_mode='constant' (per channel when several).", [0])


class _VideoReaderImpl(SamplePool, BaseReader):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._sequences = None  # [(file_idx, start_frame, label)]
        self._files: List[str] = None
        self._handles: OrderedDict = OrderedDict()
        self._handles_lock = threading.Lock()
        self._ranges: List = []
        self._fps: Dict[int, float] = {}
        self._corpus_pix = None

    def _build_index(self):
        if self._sequences is not None:
            return
        spec = self.spec
        files, labels = [], []
        if spec.GetArgument("filenames", None):
            files = list(spec.GetArgument("filenames"))
            arg_labels = spec.GetArgument("labels", None)
            labels = list(arg_labels) if arg_labels else [-1] * len(files)
        elif spec.GetArgument("file_list", None):
            with open(spec.GetArgument("file_list")) as f:
                for line in f:
                    parts = line.split()
                    if not parts:
                        continue
                    if len(parts) >= 4:  # path label start end
                        files.append(parts[0])
                        labels.append(int(parts[1]))
                        self._ranges.append((float(parts[2]), float(parts[3])))
                    else:
                        path, _, lab = line.strip().rpartition(" ")
                        files.append(path)
                        labels.append(int(lab))
                        self._ranges.append(None)
        elif spec.GetArgument("file_root", None):
            import os

            root = spec.GetArgument("file_root")
            for li, sub in enumerate(sorted(os.listdir(root))):
                subp = os.path.join(root, sub)
                if os.path.isdir(subp):
                    for fname in sorted(os.listdir(subp)):
                        files.append(os.path.join(subp, fname))
                        labels.append(li)
        else:
            raise ValueError("readers.video requires filenames, file_list, or file_root")
        self._files = files
        L = spec.GetArgument("sequence_length")
        stride = spec.GetArgument("stride", 1)
        step = spec.GetArgument("step", -1)
        if step is None or step < 0:
            step = L
        self._sequences = []
        self._fps = {}
        self._spans = {}   # uniform_sample: fi -> (lo, hi)
        self._limits = {}  # fi -> range end (pad instead of reading past it)
        self._dims = {}    # fi -> (height, width)
        self._pix = {}     # fi -> pixel-format class
        self._corpus_pix = None
        span = (L - 1) * stride + 1
        pad_mode = spec.GetArgument("pad_mode", None)
        pad_seq = spec.GetArgument("pad_sequences", False) or (
            pad_mode is not None and pad_mode != "none")
        uniform = spec.GetArgument("uniform_sample", False)
        fmt = spec.GetArgument("file_list_format", None)
        by_frame = (fmt == "frames" if fmt is not None
                    else spec.GetArgument("file_list_frame_num", False))
        incl_prev = spec.GetArgument("file_list_include_preceding_frame", False)
        rounding = spec.GetArgument("file_list_rounding", "start_down_end_up")
        lo_fn, hi_fn = {
            "start_down_end_up": (np.floor, np.ceil),
            "start_up_end_down": (np.ceil, np.floor),
            "all_up": (np.ceil, np.ceil),
            "all_down": (np.floor, np.floor),
        }[rounding]
        if fmt is None and not incl_prev:
            lo_fn = np.ceil  # legacy reader: next frame at/after the start time
        for fi, path in enumerate(files):
            v = native.VideoFile(path)
            n = v.num_frames
            fps = v.fps or 25.0
            self._fps[fi] = fps
            self._dims[fi] = (v.height, v.width)
            self._pix[fi] = v.pixfmt_class
            v.close()
            rng = self._ranges[fi] if fi < len(self._ranges) else None
            lo, hi = 0, n
            if rng is not None:
                a, b = rng
                if by_frame:
                    lo = int(a) if a >= 0 else n + int(a)
                    hi = (int(b) if b >= 0 else n + int(b)) if b != 0 else n
                    if fmt is not None and spec.GetArgument("file_list_include_end", True):
                        hi += 1
                else:  # seconds
                    lo = int(lo_fn(a * fps))
                    hi = int(hi_fn(b * fps)) if b > 0 else n
                    if fmt is not None and spec.GetArgument("file_list_include_end", True):
                        hi += 1
                lo, hi = max(lo, 0), min(max(hi, lo), n)
            self._limits[fi] = hi
            if uniform:
                if lo < hi:
                    self._spans[fi] = (lo, hi)
                    self._sequences.append((fi, lo, labels[fi]))
                continue
            start = lo
            limit = hi if not pad_seq else hi - 1 + span  # allow padded tails
            while start + (1 if pad_seq else span) <= hi and start + span <= limit:
                self._sequences.append((fi, start, labels[fi]))
                start += step
        if not self._sequences:
            raise ValueError("readers.video found no sequences")

    def _num_samples(self):
        return len(self._sequences)

    def _handle(self, fi):
        with self._handles_lock:
            h = self._handles.pop(fi, None)
            if h is None:
                h = native.VideoFile(self._files[fi])
                h._lock = threading.Lock()
            self._handles[fi] = h
            while len(self._handles) > _MAX_OPEN_FILES:
                self._handles.popitem(last=False)
        return h

    def _has_labels(self):
        s = self.spec
        return bool(s.GetArgument("labels", None) or s.GetArgument("file_list", None)
                    or s.GetArgument("file_root", None))

    def _uniform_idxs(self, fi):
        """sequence_length frames spread over [lo, hi), rounded half away
        from zero like std::round."""
        L = self.spec.GetArgument("sequence_length")
        lo, hi = self._spans[fi]
        t = (np.arange(L) / (L - 1)) if L > 1 else np.zeros(1)
        return lo + np.floor(t * (hi - lo - 1) + 0.5).astype(np.int64)

    def _want(self, fi, start):
        """Frames to read: the range end clamps the read; frames past it are
        padded, not read."""
        spec = self.spec
        L = spec.GetArgument("sequence_length")
        stride = spec.GetArgument("stride", 1)
        hi = self._limits.get(fi)
        if hi is None:
            return L
        return max(min(L, -(-(hi - start) // stride)), 0)

    def _frame_idxs(self, start, got, total):
        """The source frame index of each emitted frame; padded slots report
        the source index of their content (edge/reflect), or -1 for
        constant padding."""
        spec = self.spec
        stride = spec.GetArgument("stride", 1)
        idxs = start + np.arange(total, dtype=np.int64) * stride
        if 0 < got < total:
            mode = spec.GetArgument("pad_mode", None) or "edge"
            src = pad_indices(got, total, mode)
            idxs[got:] = np.where(src >= 0, idxs[np.maximum(src, 0)], -1)
        return idxs

    def _extras(self, label, frame_idxs, fi):
        spec = self.spec
        outs = []
        if self._has_labels():
            outs.append(np.array([label], np.int32))
        if spec.GetArgument("enable_frame_num", False):
            outs.append(np.array([int(frame_idxs[0])], np.int32))
        if spec.GetArgument("enable_timestamps", False):
            fps = self._fps.get(fi, 25.0)
            outs.append(np.where(frame_idxs >= 0, frame_idxs / fps, -1.0).astype(np.float64))
        return outs

    def _read_payload(self, index: int):
        fi, start, label = self._sequences[index]
        spec = self.spec
        L = spec.GetArgument("sequence_length")
        stride = spec.GetArgument("stride", 1)
        h = self._handle(fi)
        if spec.GetArgument("uniform_sample", False):
            idxs = self._uniform_idxs(fi)
            lo, hi = self._spans[fi]
            with h._lock:
                frames = h.read(lo, hi - lo, 1)
            frames = frames[idxs - lo]
            frame_idxs = idxs
        else:
            want = self._want(fi, start)
            with h._lock:  # the decoder handle is stateful
                frames = h.read(start, want, stride,
                                pad=spec.GetArgument("pad_mode", None) is None and want == L)
            got = frames.shape[0]
            if got < L:
                # unset pad_mode repeats the last frame; "none" leaves the tail short
                mode = spec.GetArgument("pad_mode", None) or "edge"
                frames = pad_frames(frames, L, mode, spec.GetArgument("fill_value", [0]))
            frame_idxs = self._frame_idxs(start, got, frames.shape[0])
        if spec.GetArgument("channels", 3) == 1:
            luma = 0.299 * frames[..., 0] + 0.587 * frames[..., 1] + 0.114 * frames[..., 2]
            frames = np.clip(np.round(luma), 0, 255).astype(np.uint8)[..., None]
        dt = spec.GetArgument("dtype", None)
        if spec.GetArgument("normalized", False):
            frames = frames.astype(np.float32) / 255.0
        elif dt is not None:
            from ..types import cast_host

            frames = cast_host(frames, dt)
        outs = [frames] + self._extras(label, frame_idxs, fi)
        return tuple(outs) if len(outs) > 1 else outs[0]

    def _payload_layouts(self):
        return ["FHWC", "", "", ""]

    def close(self):
        SamplePool.close(self)
        with self._handles_lock:
            for h in self._handles.values():
                h.close()
            self._handles.clear()


@register_operator("readers.Video", "cpu")
class VideoReaderCPU(_VideoReaderImpl):
    pass


@register_operator("readers.Video", "mixed")
class VideoReaderMixed(_VideoReaderImpl):
    """device='mixed': sequences land on the device as padded [F, H, W, C].
    A batch of uint8 RGB sequences padded by repetition crosses as the
    planar YUV wire, decoded at once on the task pool; channels=1, float
    outputs and pad_mode none/constant take the dense RGB path."""

    def stage_batch_multi(self, ctx, ins):
        from ..types import DALIDataType

        spec = self.spec
        dt = spec.GetArgument("dtype", None)
        if (spec.GetArgument("channels", 3) != 3 or spec.GetArgument("normalized", False)
                or (dt is not None and int(dt) != int(DALIDataType.UINT8))
                or spec.GetArgument("pad_mode", None) in ("none", "constant")):
            return None
        # every fallback decision comes before the loader's indices are read
        self._build_index()
        if self._corpus_pix is None:
            pix = set(self._pix.values())
            self._corpus_pix = pix.pop() if len(pix) == 1 else 0
        if self._corpus_pix == 0:
            # a corpus of both ranges, or with a file that is not 4:2:0
            # (class 0, converted on the host as libswscale does): dense RGB
            return None
        full_range = self._corpus_pix == 2
        self._ensure_loader()
        L = spec.GetArgument("sequence_length")
        stride = spec.GetArgument("stride", 1)
        indices = [self._loader.read_index() for _ in range(ctx.batch_size)]
        n = len(indices)
        dims = [(L,) + self._dims[self._sequences[idx][0]] for idx in indices]
        results = [None] * n
        uniform = spec.GetArgument("uniform_sample", False)
        pad_native = spec.GetArgument("pad_mode", None) is None
        reads = []  # (i, file handle, start, want, (y, u, v) slices)

        def decode_into(i, ys, us, vs, emit):
            fi, start, label = self._sequences[indices[i]]
            h_, w_ = self._dims[fi]
            fy, fc = h_ * w_, ((h_ + 1) // 2) * ((w_ + 1) // 2)
            hnd = self._handle(fi)
            if uniform:
                idxs = self._uniform_idxs(fi)
                lo, hi = self._spans[fi]
                ty, tu, tv, _ = hnd.read_yuv(lo, hi - lo, 1)
                ys.reshape(L, fy)[:] = ty.reshape(hi - lo, fy)[idxs - lo]
                us.reshape(L, fc)[:] = tu.reshape(hi - lo, fc)[idxs - lo]
                vs.reshape(L, fc)[:] = tv.reshape(hi - lo, fc)[idxs - lo]
                results[i] = (label, idxs, fi)
            else:
                want = self._want(fi, start)
                reads.append((i, hnd, start, want, (ys, us, vs), fy, fc))
            return emit

        try:
            staged = stage_yuv_batch(dims, full_range, decode_into)
            if reads:
                nonempty = [r for r in reads if r[3] > 0]
                gots = native.video_read_batch(
                    native.shared_pool(getattr(self.pipeline, "num_threads", 1) or 1),
                    [r[1] for r in nonempty], [r[2] for r in nonempty],
                    [r[3] for r in nonempty], [stride] * len(nonempty),
                    [(ys[: want * fy], us[: want * fc], vs[: want * fc])
                     for _, _, _, want, (ys, us, vs), fy, fc in nonempty], yuv=True)
        except native.VideoPixfmtChanged:
            # a file whose frame size changes mid-stream, seen only now that
            # the loader's indices are read: this batch decodes densely from
            # the same indices (the RGB read stops at the change), and the
            # reader keeps to the dense path, as the reference's does. The
            # handles are opened anew: a decoder that met the change keeps
            # its size, so a read through it from the start would fail
            self._corpus_pix = 0
            with self._handles_lock:
                self._handles.clear()
            return self._dense_batch_from(indices)
        if reads:
            got_of = {r[0]: int(g) for r, g in zip(nonempty, gots)}
            for i, _, start, want, (ys, us, vs), fy, fc in reads:
                got = got_of.get(i, 0)
                planes = (ys.reshape(L, fy), us.reshape(L, fc), vs.reshape(L, fc))
                if pad_native and want == L and 0 < got < want:
                    for p in planes:  # the read's own EOF padding: the last frame
                        p[got:want] = p[got - 1]
                    got = want
                if got < L:
                    src = pad_indices(got, L, spec.GetArgument("pad_mode", None) or "edge")
                    for p in planes:
                        p[got:] = p[src]
                fi, _, label = self._sequences[indices[i]]
                results[i] = (label, self._frame_idxs(start, got, L), fi)
        outs = [staged]
        extras = [self._extras(*r) for r in results]
        for j in range(len(extras[0])):
            outs.append(HostBatch([e[j] for e in extras]))
        return outs


# ================================ experimental.inputs.Video =======================================

DALI_SCHEMA("experimental.inputs.Video").DocStr(
    """Feed-driven video input (reference ``video/input/video_input.h``): the user feeds ONE
    encoded video file via ``Pipeline.feed_input``; successive ``run()`` calls return batches
    of ``sequence_length``-frame [F,H,W,C] sequences until the file is consumed (full
    batches, then one final batch holding the leftover full sequences plus a partial or
    padded one). The next fed file starts after the previous one is depleted."""
).NumInput(0).NumOutput(1).Devices("cpu", "mixed").MakeStateful().AddArg(
    "sequence_length", ArgType.INT, "Frames per returned sequence."
).AddOptionalArg(
    "last_sequence_policy", ArgType.STRING, "'partial' or 'pad'.", "partial"
).AddOptionalArg(
    "blocking", ArgType.BOOL, "Compatibility knob (feeding is synchronous here).", False
).AddOptionalArg("no_copy", ArgType.BOOL, "Zero-copy hint.", False)


class _VideoInputImpl(Operator):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        policy = spec.GetArgument("last_sequence_policy", "partial")
        if policy not in ("partial", "pad"):
            raise ValueError(f"last_sequence_policy must be 'partial' or 'pad', got {policy!r}")
        self._policy = policy
        self._queue = []
        self._vf = None
        self._pos = 0

    def feed(self, data, layout=None):
        """One feed = one encoded video file (bytes / uint8 array / 1-elem list)."""
        if isinstance(data, (list, tuple)):
            self._queue.extend(np.asarray(d, np.uint8).tobytes() for d in data)
        elif isinstance(data, (bytes, bytearray)):
            self._queue.append(bytes(data))
        else:
            self._queue.append(np.asarray(data, np.uint8).tobytes())

    def _open_next(self):
        if not self._queue:
            raise RuntimeError(
                "inputs.video has no data; feed an encoded video via Pipeline.feed_input")
        self._vf = native.VideoFile(self._queue.pop(0))
        self._pos = 0

    def _close_current(self):
        if self._vf is not None:
            self._vf.close()
            self._vf = None

    def run_batch(self, ctx, *unused):
        if self._vf is None:
            self._open_next()
        L = self.spec.GetArgument("sequence_length")
        samples = []
        for _ in range(ctx.batch_size):
            remaining = self._vf.num_frames - self._pos
            if remaining <= 0:
                break
            take = min(L, remaining)
            frames = self._vf.read(self._pos, take)
            self._pos += take
            if take < L and self._policy == "pad":
                pad = np.zeros((L - take,) + frames.shape[1:], np.uint8)
                frames = np.concatenate([frames, pad], axis=0)
            samples.append(frames)
        if self._pos >= self._vf.num_frames:
            self._close_current()
        if not samples:  # fed an empty video
            raise RuntimeError("inputs.video: fed video has no frames")
        return [HostBatch(samples, layout="FHWC")]

    def output_layout(self, j, inputs):
        return "FHWC"

    def close(self):
        self._close_current()


@register_operator("experimental.inputs.Video", "cpu")
class VideoInputCPU(_VideoInputImpl):
    pass


@register_operator("experimental.inputs.Video", "mixed")
class VideoInputMixed(_VideoInputImpl):
    """device='mixed': sequences cross as the planar YUV wire; the 'pad'
    policy pads with YUV black (Y 16, or 0 at full range; U = V = 128),
    which the integer conversion maps to exactly RGB 0, the cpu path's
    zero padding."""

    def stage_batch_multi(self, ctx, ins):
        if self._vf is None:
            self._open_next()
        if self._vf.pixfmt_class == 0:
            return None  # not 4:2:0: the dense RGB path
        full_range = self._vf.pixfmt_class == 2
        L = self.spec.GetArgument("sequence_length")
        h_, w_ = self._vf.height, self._vf.width
        fy, fc = h_ * w_, ((h_ + 1) // 2) * ((w_ + 1) // 2)
        # the batch outline first: sizes known up front
        plan = []  # (start, take, emit): emit = take, or L under 'pad'
        pos = self._pos
        for _ in range(ctx.batch_size):
            remaining = self._vf.num_frames - pos
            if remaining <= 0:
                break
            take = min(L, remaining)
            emit = L if (take < L and self._policy == "pad") else take
            plan.append((pos, take, emit))
            pos += take
        if not plan:
            raise RuntimeError("inputs.video: fed video has no frames")

        def decode_into(i, ys, us, vs, emit):
            start, take, _ = plan[i]
            # num_frames may overcount: a short read repeats its last frame,
            # as the cpu path's read() does
            self._vf.read_yuv(start, take, 1, pad=True,
                              out=(ys[: take * fy], us[: take * fc], vs[: take * fc]))
            if emit > take:  # 'pad' policy: YUV black == RGB zeros exactly
                ys[take * fy:] = 0 if full_range else 16
                us[take * fc:] = 128
                vs[take * fc:] = 128
            return emit

        try:
            staged = stage_yuv_batch([(e, h_, w_) for _, _, e in plan], full_range,
                                     decode_into)
        except native.VideoPixfmtChanged:
            # a change of frame size mid-stream: the position is unmoved, so
            # the dense RGB path reads this batch again
            return None
        self._pos = pos
        if self._pos >= self._vf.num_frames:
            self._close_current()
        return [staged]
