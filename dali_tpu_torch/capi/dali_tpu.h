/*
 * dali_tpu_torch C API, the same C surface as dali_tpu's (DALI's c_api_2):
 * a client compiles against either package's header unchanged.
 *
 * Handle-based, error-code returning interface for driving dali_tpu_torch
 * pipelines from hosts without Python (Triton's DALI backend loads
 * model.dali through it). The implementation (capi.cc) embeds CPython and
 * runs Pipeline.deserialize's pipeline: on the card unless the document's
 * params say "device": "cpu". Each daliTpuRun copies the outputs to host
 * memory once; the sample calls read that copy.
 *
 * Usage:
 *   daliTpuInit();
 *   daliTpuPipeline p;
 *   daliTpuCreatePipeline(&p, serialized_json, len);       // Pipeline.deserialize
 *   daliTpuRun(p);
 *   daliTpuOutputCount(p, &n);
 *   daliTpuOutputInfo(p, 0, 0, &info);                     // sample 0 of output 0
 *   daliTpuCopyOutputSample(p, 0, 0, buffer, buffer_size); // host copy
 *   daliTpuDestroyPipeline(p);
 */

#ifndef DALI_TPU_C_API_H_
#define DALI_TPU_C_API_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef void* daliTpuPipeline;

typedef enum {
  DALI_TPU_OK = 0,
  DALI_TPU_ERROR = 1,
  DALI_TPU_INVALID_HANDLE = 2,
  DALI_TPU_BUFFER_TOO_SMALL = 3,
} daliTpuResult;

typedef struct {
  int64_t ndim;
  int64_t shape[16];
  int32_t dtype;        /* DALIDataType enum value */
  int64_t nbytes;
} daliTpuTensorInfo;

/* Initialize the embedded runtime (idempotent). */
daliTpuResult daliTpuInit(void);

/* Last error message for this thread (valid until the next API call). */
const char* daliTpuGetLastError(void);

/* Build a pipeline from a serialized graph (Pipeline.serialize JSON). */
daliTpuResult daliTpuCreatePipeline(daliTpuPipeline* handle,
                                    const char* serialized_json, size_t len);

/* Schedule + wait one iteration (Pipeline.run). */
daliTpuResult daliTpuRun(daliTpuPipeline handle);

daliTpuResult daliTpuOutputCount(daliTpuPipeline handle, int* count);
daliTpuResult daliTpuBatchSize(daliTpuPipeline handle, int* batch_size);

/* Shape/dtype of one sample of the last iteration's outputs. */
daliTpuResult daliTpuOutputInfo(daliTpuPipeline handle, int output, int sample,
                                daliTpuTensorInfo* info);

/* Copy one sample into a caller buffer (host memory, C-contiguous). */
daliTpuResult daliTpuCopyOutputSample(daliTpuPipeline handle, int output,
                                      int sample, void* dst, size_t dst_bytes);

/* Zero-copy view of one sample of the last iteration's outputs (in the host
 * copy daliTpuRun made). The pointer borrows the runtime's host buffer and
 * stays valid until the next daliTpuRun / daliTpuDestroyPipeline. info may
 * be NULL. */
daliTpuResult daliTpuOutputSampleData(daliTpuPipeline handle, int output,
                                      int sample, const void** data,
                                      daliTpuTensorInfo* info);

/* Feed a batch into a named external_source node (Pipeline.feed_input).
 * `data` holds n_samples C-contiguous samples back to back; infos[i]
 * describes sample i (ndim/shape/dtype/nbytes). `layout` may be NULL. */
daliTpuResult daliTpuFeedInput(daliTpuPipeline handle, const char* name,
                               const void* data, const daliTpuTensorInfo* infos,
                               int n_samples, const char* layout);

/* Serialize pipeline state (Pipeline.checkpoint). Call with dst=NULL to get
 * the required size (incl. NUL); payload is a NUL-terminated JSON string. */
daliTpuResult daliTpuCheckpoint(daliTpuPipeline handle, char* dst,
                                size_t dst_bytes, size_t* required);

/* Restore state captured by daliTpuCheckpoint into a built pipeline. */
daliTpuResult daliTpuRestoreCheckpoint(daliTpuPipeline handle,
                                       const char* payload, size_t len);

/* Epoch size of a named reader (Pipeline.reader_meta). */
daliTpuResult daliTpuReaderSize(daliTpuPipeline handle, const char* reader_name,
                                int64_t* size);

daliTpuResult daliTpuDestroyPipeline(daliTpuPipeline handle);

#ifdef __cplusplus
}
#endif

#endif /* DALI_TPU_C_API_H_ */
