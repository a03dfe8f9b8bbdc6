/* A C program over the port's predict ABI (src/c_predict_api.h, built by
   incubator_mxnet_tpu_torch/native.py's build_predict).  Compile it with
     g++ -x c++ c_predict_main.c -o main $(flags of native.predict_flags)
   and run it as
     PYTHONPATH=<checkout> ./main prefix-symbol.json prefix-0000.params \
       dev_type dim0 dim1 ...
   Exit codes: 2 bad arguments, 3 create failed (the message is printed),
   4 set_input, 5 forward, 6 output shape, 7 get_output. */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "c_predict_api.h"

static char *read_file(const char *path, size_t *size) {
  FILE *f = fopen(path, "rb");
  if (!f) return NULL;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  char *buf = (char *)malloc((size_t)n + 1);
  if (fread(buf, 1, (size_t)n, f) != (size_t)n) return NULL;
  buf[n] = 0;
  if (size) *size = (size_t)n;
  fclose(f);
  return buf;
}

/* symbol.json params dev_type dim0 dim1 ...: one input, "data", filled
   with ((i * 7919) % 1000) / 1000; prints the output's shape and values */
int main(int argc, char **argv) {
  if (argc < 5) return 2;
  size_t psize = 0;
  char *json = read_file(argv[1], NULL);
  char *params = read_file(argv[2], &psize);
  if (!json || !params) { fprintf(stderr, "read failed\n"); return 2; }
  int dev_type = atoi(argv[3]);
  uint32_t ndim = (uint32_t)(argc - 4), shape[8], total = 1;
  for (uint32_t i = 0; i < ndim && i < 8; ++i) {
    shape[i] = (uint32_t)atoi(argv[4 + i]);
    total *= shape[i];
  }
  const char *keys[] = {"data"};
  uint32_t indptr[] = {0, ndim};
  PredictorHandle h = NULL;
  if (MXTPUPredCreate(json, params, psize, dev_type, 0, 1, keys, indptr,
                      shape, &h) != 0) {
    printf("create: %s\n", MXTPUGetLastError());
    return 3;
  }
  float *input = (float *)malloc(total * sizeof(float));
  for (uint32_t i = 0; i < total; ++i)
    input[i] = (float)((i * 7919u) % 1000u) * 0.001f;
  if (MXTPUPredSetInput(h, "data", input, total) != 0) {
    printf("set_input: %s\n", MXTPUGetLastError());
    return 4;
  }
  if (MXTPUPredForward(h) != 0) {
    printf("forward: %s\n", MXTPUGetLastError());
    return 5;
  }
  uint32_t *oshape = NULL, ondim = 0;
  if (MXTPUPredGetOutputShape(h, 0, &oshape, &ondim) != 0) return 6;
  uint32_t n = 1;
  for (uint32_t i = 0; i < ondim; ++i) n *= oshape[i];
  float *out = (float *)malloc(n * sizeof(float));
  if (MXTPUPredGetOutput(h, 0, out, n) != 0) {
    printf("get_output: %s\n", MXTPUGetLastError());
    return 7;
  }
  printf("shape %u", oshape[0]);
  for (uint32_t i = 1; i < ondim; ++i) printf("x%u", oshape[i]);
  printf("\n");
  for (uint32_t i = 0; i < n; ++i) printf("%.9g ", out[i]);
  printf("\n");
  MXTPUPredFree(h);
  return 0;
}
