/* C ABI for embedding the PyTorch port of xflow-tpu (xflow_tpu_torch) in
 * native applications: the symbols and signatures of the JAX package's
 * xflow_tpu/c_api/xflow_c_api.h, so a client switches package by linking
 * the other shim. Thread-safety: calls must come from one thread (the
 * embedded interpreter owns the GIL).
 *
 * The device: training, evaluation and prediction run on the CUDA card
 * unless the handle asks for the CPU with the undotted key "device":
 *   XFSetConfig(h, "device", "cpu");
 * Every other key is a dotted config override.
 *
 * Build a client against the shim with:
 *   gcc client.c xflow_c_api.c -I<this dir> $(python3-config --includes) \
 *       $(python3-config --ldflags --embed) -o client
 * and run it with the repository root on PYTHONPATH.
 */

#ifndef XFLOW_TORCH_C_API_H_
#define XFLOW_TORCH_C_API_H_

#ifdef __cplusplus
extern "C" {
#endif

/* Create a trainer for `train_prefix`/`test_prefix` shard sets
 * (reads <prefix>-%05d). Returns 0 on success, nonzero on failure. */
int XFCreate(void** out_handle, const char* train_prefix, const char* test_prefix);

/* Apply a dotted config override, e.g. ("model.name", "fm"), or set the
 * handle's device ("device": "cuda", the default, or "cpu"). */
int XFSetConfig(void* handle, const char* dotted_key, const char* value);

/* Run training (and evaluation when a test prefix was given). */
int XFStartTrain(void* handle);

/* Test AUC from the last XFStartTrain (NaN if not evaluated). */
double XFGetAUC(void* handle);

/* Load the newest COMMITTED checkpoint under `checkpoint_dir` into an
 * online predictor for this handle (reshard-on-load; corrupt newer
 * steps walk back to the previous committed one). Config overrides
 * applied via XFSetConfig must match the checkpoint's model/hash
 * config. Returns 0 on success, nonzero on failure. */
int XFLoadCheckpoint(void* handle, const char* checkpoint_dir);

/* Predict pCTR for newline-separated libffm feature rows (an optional
 * leading label per row is ignored). Writes up to `capacity` values
 * into `out_pctr`; returns the number of predictions written, or -1
 * on error (no loaded checkpoint, malformed row). Predictions come
 * from the same forward the trainer's evaluate uses. */
int XFPredict(void* handle, const char* rows, double* out_pctr, int capacity);

/* Release the trainer. */
int XFDestroy(void* handle);

#ifdef __cplusplus
}
#endif

#endif /* XFLOW_TORCH_C_API_H_ */
