/* brush_tpu_torch C API — train a Gaussian-splat scene and save .ply
 * exports.
 *
 * Counterpart of the reference's C FFI app (apps/brush-c/src/lib.rs:109
 * `train_and_save(dataset_path, options, progress_cb, user_data)`): a
 * blocking call that drives a full training run, delivering typed progress
 * messages to a callback, with panics/exceptions caught at the boundary.
 * The entry points and status codes are those of brush_tpu's C API.
 *
 * This library embeds CPython and runs brush_tpu_torch's training process
 * on the GPU (or on the CPU with the option "device": "cpu"). Build it with
 * `python -m brush_tpu_torch.native.build` and link with
 * -lbrush_tpu_torch_ffi. If the host process is not already a Python
 * process, set the environment variable BRUSH_TPU_TORCH_PYTHONPATH to the
 * directory containing `brush_tpu_torch/` before the first call.
 */
#ifndef BRUSH_TPU_TORCH_FFI_H
#define BRUSH_TPU_TORCH_FFI_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define BRUSH_TPU_TORCH_ABI_VERSION 1

/* Status codes returned by brush_train_and_save. */
enum {
  BRUSH_OK = 0,
  BRUSH_ERR_PYTHON_INIT = 1, /* interpreter could not be initialised      */
  BRUSH_ERR_IMPORT = 2,      /* brush_tpu_torch not importable (check path) */
  BRUSH_ERR_TRAIN = 3,       /* training raised; see brush_last_error     */
  BRUSH_ERR_BAD_ARG = 4,     /* NULL dataset path                         */
};

/* Progress callback: `message_json` is a UTF-8 JSON object
 * {"kind": "step"|"refine"|"eval"|"export", "iter": N, ...} matching the
 * TrainMessage stream (brush_tpu_torch/process.py). The pointer is only
 * valid for the duration of the call. Return nonzero to request
 * cancellation. */
typedef int32_t (*brush_progress_cb)(const char *message_json,
                                     void *user_data);

/* Blocking: load `dataset_path` (COLMAP / Nerfstudio / RealityCapture
 * directory or zip), train with `options_json` (JSON object of
 * TrainConfig/ProcessConfig/LoadConfig fields and "device", e.g.
 * {"total_train_iters": 30000, "export_path": "out_{iter}.ply",
 * "device": "cuda"}; NULL or "" for defaults), saving .ply exports as
 * configured. Returns BRUSH_OK or an error code; details via
 * brush_last_error(). */
int32_t brush_train_and_save(const char *dataset_path,
                             const char *options_json,
                             brush_progress_cb progress_cb, void *user_data);

/* Last error message for this thread ("" if none). Valid until the next
 * brush_* call on the same thread. */
const char *brush_last_error(void);

/* ABI version of this library (BRUSH_TPU_TORCH_ABI_VERSION at build time). */
int32_t brush_abi_version(void);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* BRUSH_TPU_TORCH_FFI_H */
