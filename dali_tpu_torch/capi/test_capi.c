/* C API test client (DALI's c_api_2 test usage); it compiles against the
 * dali_tpu.h of dali_tpu or of dali_tpu_torch:
 *   mode 1: <pipeline.json> [--dump <out.bin>]  — create/run/info/copy +
 *            error paths; --dump writes the first run's outputs
 *   mode 2: <pipeline.json> --feed     — external_source: feed_input,
 *            zero-copy output access, checkpoint/restore round trip
 *   mode 3: <pipeline.json> --resume   — checkpoint-resume determinism and
 *            the error contracts
 *   mode 4: <pipeline.json> --serve <input name> <in.bin> <out.bin> — feed
 *            one batch of encoded samples (in.bin: int32 n, then n x (int64
 *            size, bytes)) as uint8 arrays, run once, write every output
 *            sample, each copied out with daliTpuCopyOutputSample
 * out.bin: int32 outputs, int32 batch, then per output and sample: int32
 * dtype, int64 ndim, int64 shape[ndim], int64 nbytes, the bytes.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "dali_tpu.h"

static char* read_file(const char* path, long* out_n) {
  FILE* f = fopen(path, "rb");
  if (!f) { perror("open"); return NULL; }
  fseek(f, 0, SEEK_END); long n = ftell(f); fseek(f, 0, SEEK_SET);
  char* payload = malloc(n);
  fread(payload, 1, n, f); fclose(f);
  *out_n = n;
  return payload;
}

static int dump_outputs(daliTpuPipeline p, const char* path) {
  int count, bs;
  if (daliTpuOutputCount(p, &count) != DALI_TPU_OK || daliTpuBatchSize(p, &bs) != DALI_TPU_OK) {
    fprintf(stderr, "count: %s\n", daliTpuGetLastError()); return 1;
  }
  FILE* f = fopen(path, "wb");
  if (!f) { perror("dump"); return 1; }
  fwrite(&count, sizeof(int), 1, f);
  fwrite(&bs, sizeof(int), 1, f);
  for (int o = 0; o < count; o++) {
    for (int s = 0; s < bs; s++) {
      daliTpuTensorInfo info;
      if (daliTpuOutputInfo(p, o, s, &info) != DALI_TPU_OK) {
        fprintf(stderr, "info: %s\n", daliTpuGetLastError()); fclose(f); return 1;
      }
      void* buf = malloc(info.nbytes ? info.nbytes : 1);
      if (daliTpuCopyOutputSample(p, o, s, buf, info.nbytes) != DALI_TPU_OK) {
        fprintf(stderr, "copy: %s\n", daliTpuGetLastError()); fclose(f); return 1;
      }
      fwrite(&info.dtype, sizeof(int32_t), 1, f);
      fwrite(&info.ndim, sizeof(int64_t), 1, f);
      fwrite(info.shape, sizeof(int64_t), info.ndim, f);
      fwrite(&info.nbytes, sizeof(int64_t), 1, f);
      fwrite(buf, 1, info.nbytes, f);
      free(buf);
    }
  }
  fclose(f);
  return 0;
}

static int run_basic(const char* payload, long n, const char* dump) {
  daliTpuPipeline p;
  if (daliTpuCreatePipeline(&p, payload, n) != DALI_TPU_OK) {
    fprintf(stderr, "create: %s\n", daliTpuGetLastError()); return 1;
  }
  if (daliTpuRun(p) != DALI_TPU_OK) { fprintf(stderr, "run: %s\n", daliTpuGetLastError()); return 1; }
  if (dump && dump_outputs(p, dump) != 0) return 1;
  int count, bs;
  daliTpuOutputCount(p, &count);
  daliTpuBatchSize(p, &bs);
  printf("outputs=%d batch=%d\n", count, bs);
  daliTpuTensorInfo info;
  if (daliTpuOutputInfo(p, 0, 0, &info) != DALI_TPU_OK) {
    fprintf(stderr, "info: %s\n", daliTpuGetLastError()); return 1;
  }
  printf("sample0: ndim=%lld nbytes=%lld dtype=%d shape=[", (long long)info.ndim,
         (long long)info.nbytes, info.dtype);
  for (int i = 0; i < info.ndim; i++) printf("%lld%s", (long long)info.shape[i], i + 1 < info.ndim ? "," : "");
  printf("]\n");
  void* buf = malloc(info.nbytes);
  if (daliTpuCopyOutputSample(p, 0, 0, buf, info.nbytes) != DALI_TPU_OK) {
    fprintf(stderr, "copy: %s\n", daliTpuGetLastError()); return 1;
  }
  float first; memcpy(&first, buf, sizeof(float));
  printf("first float: %f\n", first);
  /* error-path probe: bad sample index must fail cleanly */
  if (daliTpuOutputInfo(p, 0, 9999, &info) == DALI_TPU_OK) {
    fprintf(stderr, "expected error for bad sample index\n"); return 1;
  }
  printf("bad-index error: %s\n", daliTpuGetLastError());
  /* reader_size: this pipeline has no reader -> must error, not crash */
  int64_t rsz = -1;
  if (daliTpuReaderSize(p, "NoSuchReader", &rsz) == DALI_TPU_OK) {
    fprintf(stderr, "expected error for unknown reader\n"); return 1;
  }
  printf("unknown-reader error: %s\n", daliTpuGetLastError());
  daliTpuDestroyPipeline(p);
  printf("C API OK\n");
  return 0;
}

static int run_feed(const char* payload, long n) {
  daliTpuPipeline p;
  if (daliTpuCreatePipeline(&p, payload, n) != DALI_TPU_OK) {
    fprintf(stderr, "create: %s\n", daliTpuGetLastError()); return 1;
  }
  /* feed one batch of 2 float32 samples [2,3] (pipeline multiplies by 2) */
  float data[12];
  for (int i = 0; i < 12; i++) data[i] = (float)i;
  daliTpuTensorInfo infos[2];
  for (int s = 0; s < 2; s++) {
    infos[s].ndim = 2; infos[s].shape[0] = 2; infos[s].shape[1] = 3;
    infos[s].dtype = 9; /* DALIDataType.FLOAT */
    infos[s].nbytes = 24;
  }
  if (daliTpuFeedInput(p, "src", data, infos, 2, NULL) != DALI_TPU_OK) {
    fprintf(stderr, "feed: %s\n", daliTpuGetLastError()); return 1;
  }
  if (daliTpuRun(p) != DALI_TPU_OK) { fprintf(stderr, "run: %s\n", daliTpuGetLastError()); return 1; }
  const void* view = NULL;
  daliTpuTensorInfo oi;
  if (daliTpuOutputSampleData(p, 0, 1, &view, &oi) != DALI_TPU_OK) {
    fprintf(stderr, "view: %s\n", daliTpuGetLastError()); return 1;
  }
  const float* f = (const float*)view;
  /* sample 1 starts at value 6; x*2 => 12 */
  if (f[0] != 12.0f || f[5] != 22.0f) {
    fprintf(stderr, "zero-copy values wrong: %f %f\n", f[0], f[5]); return 1;
  }
  printf("feed+zero-copy OK (%f..%f)\n", f[0], f[5]);

  /* checkpoint round trip */
  size_t need = 0;
  if (daliTpuCheckpoint(p, NULL, 0, &need) != DALI_TPU_OK || need == 0) {
    fprintf(stderr, "ckpt size: %s\n", daliTpuGetLastError()); return 1;
  }
  char* ck = malloc(need);
  if (daliTpuCheckpoint(p, ck, need, NULL) != DALI_TPU_OK) {
    fprintf(stderr, "ckpt: %s\n", daliTpuGetLastError()); return 1;
  }
  printf("checkpoint bytes=%zu\n", need - 1);
  if (daliTpuRestoreCheckpoint(p, ck, need - 1) != DALI_TPU_OK) {
    fprintf(stderr, "restore: %s\n", daliTpuGetLastError()); return 1;
  }
  free(ck);
  daliTpuDestroyPipeline(p);
  printf("C API FEED OK\n");
  return 0;
}

/* mode 3: checkpoint-resume determinism through the C surface — a fresh
 * pipeline restored from a checkpoint must produce the bit-identical
 * continuation (Pipeline.checkpoint contract, exercised without Python). */
static int run_resume(const char* payload, long n) {
  daliTpuPipeline p1;
  if (daliTpuCreatePipeline(&p1, payload, n) != DALI_TPU_OK) {
    fprintf(stderr, "create: %s\n", daliTpuGetLastError()); return 1;
  }
  for (int i = 0; i < 2; i++)
    if (daliTpuRun(p1) != DALI_TPU_OK) { fprintf(stderr, "run: %s\n", daliTpuGetLastError()); return 1; }
  size_t need = 0;
  if (daliTpuCheckpoint(p1, NULL, 0, &need) != DALI_TPU_OK) {
    fprintf(stderr, "ckpt size: %s\n", daliTpuGetLastError()); return 1;
  }
  char* ck = malloc(need);
  if (daliTpuCheckpoint(p1, ck, need, NULL) != DALI_TPU_OK) {
    fprintf(stderr, "ckpt: %s\n", daliTpuGetLastError()); return 1;
  }
  /* continuation on the original */
  if (daliTpuRun(p1) != DALI_TPU_OK) { fprintf(stderr, "run3: %s\n", daliTpuGetLastError()); return 1; }
  daliTpuTensorInfo ia;
  const void* va;
  if (daliTpuOutputSampleData(p1, 0, 0, &va, &ia) != DALI_TPU_OK) {
    fprintf(stderr, "view1: %s\n", daliTpuGetLastError()); return 1;
  }
  char* expect = malloc(ia.nbytes);
  memcpy(expect, va, ia.nbytes);

  /* fresh pipeline restored from the snapshot */
  daliTpuPipeline p2;
  if (daliTpuCreatePipeline(&p2, payload, n) != DALI_TPU_OK) {
    fprintf(stderr, "create2: %s\n", daliTpuGetLastError()); return 1;
  }
  if (daliTpuRestoreCheckpoint(p2, ck, need - 1) != DALI_TPU_OK) {
    fprintf(stderr, "restore: %s\n", daliTpuGetLastError()); return 1;
  }
  if (daliTpuRun(p2) != DALI_TPU_OK) { fprintf(stderr, "run-restored: %s\n", daliTpuGetLastError()); return 1; }
  daliTpuTensorInfo ib;
  const void* vb;
  if (daliTpuOutputSampleData(p2, 0, 0, &vb, &ib) != DALI_TPU_OK) {
    fprintf(stderr, "view2: %s\n", daliTpuGetLastError()); return 1;
  }
  if (ia.nbytes != ib.nbytes || memcmp(expect, vb, ia.nbytes) != 0) {
    fprintf(stderr, "restored continuation differs (%lld vs %lld bytes)\n",
            (long long)ia.nbytes, (long long)ib.nbytes);
    return 1;
  }
  printf("resume bytes=%lld identical\n", (long long)ia.nbytes);

  /* error-contract probes: buffer too small, invalid handle, bad JSON */
  char tiny[1];
  if (daliTpuCopyOutputSample(p2, 0, 0, tiny, sizeof(tiny)) != DALI_TPU_BUFFER_TOO_SMALL) {
    fprintf(stderr, "expected BUFFER_TOO_SMALL\n"); return 1;
  }
  if (daliTpuRun(NULL) != DALI_TPU_INVALID_HANDLE) {
    fprintf(stderr, "expected INVALID_HANDLE\n"); return 1;
  }
  daliTpuPipeline bad;
  if (daliTpuCreatePipeline(&bad, "{not json", 9) == DALI_TPU_OK) {
    fprintf(stderr, "expected error for bad JSON\n"); return 1;
  }
  printf("bad-json error: %s\n", daliTpuGetLastError());

  free(expect); free(ck);
  daliTpuDestroyPipeline(p1);
  daliTpuDestroyPipeline(p2);
  printf("C API RESUME OK\n");
  return 0;
}

static int run_serve(const char* payload, long n, const char* name, const char* in_path,
                     const char* out_path) {
  long in_n;
  char* in = read_file(in_path, &in_n);
  if (!in || in_n < 4) return 2;
  int32_t count;
  memcpy(&count, in, 4);
  daliTpuTensorInfo* infos = calloc(count, sizeof(daliTpuTensorInfo));
  char* blob = malloc(in_n);
  long pos = 4, total = 0;
  for (int i = 0; i < count; i++) {
    int64_t size;
    memcpy(&size, in + pos, 8);
    memcpy(blob + total, in + pos + 8, size);
    pos += 8 + size;
    total += size;
    infos[i].ndim = 1; infos[i].shape[0] = size;
    infos[i].dtype = 0; /* DALIDataType.UINT8 */
    infos[i].nbytes = size;
  }
  daliTpuPipeline p;
  if (daliTpuCreatePipeline(&p, payload, n) != DALI_TPU_OK) {
    fprintf(stderr, "create: %s\n", daliTpuGetLastError()); return 1;
  }
  if (daliTpuFeedInput(p, name, blob, infos, count, NULL) != DALI_TPU_OK) {
    fprintf(stderr, "feed: %s\n", daliTpuGetLastError()); return 1;
  }
  if (daliTpuRun(p) != DALI_TPU_OK) { fprintf(stderr, "run: %s\n", daliTpuGetLastError()); return 1; }
  if (dump_outputs(p, out_path) != 0) return 1;
  daliTpuDestroyPipeline(p);
  free(infos); free(blob); free(in);
  printf("C API SERVE OK (%d samples)\n", count);
  return 0;
}

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s <serialized.json> [--dump out|--feed|--resume|--serve name in out]\n",
            argv[0]);
    return 2;
  }
  long n;
  char* payload = read_file(argv[1], &n);
  if (!payload) return 2;
  if (daliTpuInit() != DALI_TPU_OK) { fprintf(stderr, "init: %s\n", daliTpuGetLastError()); return 1; }
  if (argc >= 3 && strcmp(argv[2], "--feed") == 0) return run_feed(payload, n);
  if (argc >= 3 && strcmp(argv[2], "--resume") == 0) return run_resume(payload, n);
  if (argc >= 6 && strcmp(argv[2], "--serve") == 0)
    return run_serve(payload, n, argv[3], argv[4], argv[5]);
  return run_basic(payload, n, argc >= 4 && strcmp(argv[2], "--dump") == 0 ? argv[3] : NULL);
}
