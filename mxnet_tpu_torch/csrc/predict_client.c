/* C deployment client of the port's MXPred* ABI (c_predict_api.cc): load
 * a symbol JSON and a .params blob from disk, MXPredCreate on the given
 * device, feed one input from stdin, forward, and write output 0.
 *
 * Usage: predict_client <symbol.json> <model.params> <input_name>
 *                       <dev_type> <dim0> [<dim1> ...]
 *   dev_type 1 = cpu, 2 = gpu (CUDA device 0). Reads prod(dims)
 *   little-endian float32 values from stdin and writes output 0 as raw
 *   float32 to stdout, with a line "shape d0 d1 ..." on stderr.
 * Exit codes: 0 done, 1 an MXPred* call failed (its MXGetLastError on
 * stderr) or a read failed, 2 bad arguments.
 *
 * Built by mxnet_tpu_torch/native.py; run it with PYTHONPATH holding the
 * repository and the Python installation that has torch.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef unsigned int mx_uint;
typedef float mx_float;
typedef void *PredictorHandle;

extern const char *MXGetLastError(void);
extern int MXPredCreate(const char *symbol_json_str, const void *param_bytes,
                        int param_size, int dev_type, int dev_id,
                        mx_uint num_input_nodes, const char **input_keys,
                        const mx_uint *input_shape_indptr,
                        const mx_uint *input_shape_data,
                        PredictorHandle *out);
extern int MXPredSetInput(PredictorHandle handle, const char *key,
                          const mx_float *data, mx_uint size);
extern int MXPredForward(PredictorHandle handle);
extern int MXPredGetOutputShape(PredictorHandle handle, mx_uint index,
                                mx_uint **shape_data, mx_uint *shape_ndim);
extern int MXPredGetOutput(PredictorHandle handle, mx_uint index,
                           mx_float *data, mx_uint size);
extern int MXPredFree(PredictorHandle handle);

#define MAX_DIMS 8

#define CHECK(call)                                                       \
  do {                                                                    \
    if ((call) != 0) {                                                    \
      fprintf(stderr, "FAILED %s: %s\n", #call, MXGetLastError());        \
      return 1;                                                           \
    }                                                                     \
  } while (0)

static char *read_file(const char *path, long *size) {
  FILE *f = fopen(path, "rb");
  if (!f) return NULL;
  if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return NULL; }
  *size = ftell(f);
  if (*size < 0 || fseek(f, 0, SEEK_SET) != 0) { fclose(f); return NULL; }
  char *buf = (char *)malloc(*size + 1);
  if (!buf || fread(buf, 1, *size, f) != (size_t)*size) {
    fclose(f); free(buf); return NULL;
  }
  buf[*size] = 0;
  fclose(f);
  return buf;
}

/* a decimal in [lo, hi], or -1 */
static long parse_num(const char *s, long lo, long hi) {
  char *end = NULL;
  long v = strtol(s, &end, 10);
  if (!end || *end || end == s || v < lo || v > hi) return -1;
  return v;
}

int main(int argc, char **argv) {
  if (argc < 6 || argc - 5 > MAX_DIMS) {
    fprintf(stderr, "usage: %s symbol.json model.params input_name "
            "dev_type dim0 [dim1 ...]\n", argv[0]);
    return 2;
  }
  long dev_type = parse_num(argv[4], 1, 2);
  mx_uint ndim = (mx_uint)(argc - 5), shape[MAX_DIMS];
  unsigned long long total = 1;
  for (mx_uint i = 0; i < ndim; ++i) {
    long d = parse_num(argv[5 + i], 1, 0x7fffffffL);
    if (d < 0) {
      fprintf(stderr, "bad dimension argument: %s\n", argv[5 + i]);
      return 2;
    }
    shape[i] = (mx_uint)d;
    total *= (unsigned long long)d;
  }
  if (dev_type < 0 || total > 0xffffffffULL) {
    fprintf(stderr, "bad device type or input size: %s\n", argv[4]);
    return 2;
  }
  long json_size = 0, param_size = 0;
  char *json = read_file(argv[1], &json_size);
  char *params = read_file(argv[2], &param_size);
  if (!json || !params) {
    fprintf(stderr, "cannot read model files\n");
    return 1;
  }
  mx_uint n = (mx_uint)total;
  mx_float *in = (mx_float *)malloc(sizeof(mx_float) * n);
  if (!in) {
    fprintf(stderr, "out of memory for %u inputs\n", n);
    return 1;
  }
  if (fread(in, sizeof(mx_float), n, stdin) != (size_t)n) {
    fprintf(stderr, "short read on stdin\n");
    return 1;
  }

  const char *input_keys[1] = {argv[3]};
  mx_uint indptr[2] = {0, ndim};
  PredictorHandle pred = NULL;
  CHECK(MXPredCreate(json, params, (int)param_size, (int)dev_type, 0, 1,
                     input_keys, indptr, shape, &pred));
  CHECK(MXPredSetInput(pred, argv[3], in, n));
  CHECK(MXPredForward(pred));

  mx_uint *oshape = NULL, ondim = 0;
  CHECK(MXPredGetOutputShape(pred, 0, &oshape, &ondim));
  unsigned long long out_total = 1;
  fprintf(stderr, "shape");
  for (mx_uint i = 0; i < ondim; ++i) {
    out_total *= oshape[i];
    fprintf(stderr, " %u", oshape[i]);
  }
  fprintf(stderr, "\n");
  if (out_total > 0xffffffffULL) {
    fprintf(stderr, "output of %llu values too large\n", out_total);
    return 1;
  }
  mx_float *out = (mx_float *)malloc(sizeof(mx_float) * out_total);
  if (!out) {
    fprintf(stderr, "out of memory for %llu outputs\n", out_total);
    return 1;
  }
  CHECK(MXPredGetOutput(pred, 0, out, (mx_uint)out_total));
  if (fwrite(out, sizeof(mx_float), out_total, stdout) != out_total) {
    fprintf(stderr, "short write on stdout\n");
    return 1;
  }
  fflush(stdout);

  CHECK(MXPredFree(pred));
  free(in);
  free(out);
  free(json);
  free(params);
  return 0;
}
