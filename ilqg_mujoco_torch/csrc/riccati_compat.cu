// Batched compat Riccati backward pass (nu = 1) for Hopper (sm_90a).
//
// Replaces the TPU kernel ilqg_mujoco_tpu/experimental/pallas_riccati.py,
// function backward_compat_batched (Pallas body _kernel).  It computes the
// reference's compat backward recursion (reference inc/ilqr.h:133-176,
// ilqr.backward_pass_compat) for a batch of independent instances with one
// control (the cart-pole):
//
//   V = v v^T (v: terminal cost gradient), then for t = N-1 .. 0:
//     V  <- sym(V) + mu I                      (the shift is never removed)
//     invT = 1 / (2 B^T V B + 2 r^2)
//     K  = -2 invT B^T V A,   k = -invT (B^T (v + 2 V c) + r)
//     V' = (A+BK)^T V (A+BK) + q q^T + K^T r^2 K
//     v' = 2 (B k + c)^T V' (A+BK) + v^T (A+BK) + q^T + 2 k r^2 K
//   (v' reads the NEW V: the reference's aliasing, inc/ilqr.h:173-174).
//
// Design.  One thread per instance; the step loop runs inside the thread
// with V (n x n) and v (n) in registers for the whole horizon, so the carry
// never touches device memory.  The Pallas kernel's grid over 1024-lane
// tiles and its (8, 128) batch packing are TPU layout and are not carried
// over: each thread reads its instance's blocks straight from the caller's
// batch-major arrays (A[b, t] is n*n contiguous elements, so every fetched
// sector is used), and the ragged edge is masked by the bounds check rather
// than by padding.  Terminal gains are not written; the caller appends
// zeros.  The batch stride of every array is an argument, so a view that
// drops the terminal knot of the linearizer's (B, N+1, ...) output is read
// in place.
//
// Bound.  At B = 4096, N = 20, n = 4 each instance reads A 320, B 80,
// gx 84, gu 20, diffs 80 elements and writes K 80, k 20: 684 elements,
// 22.4 MB in double and 11.2 MB in float.  The arithmetic is about
// 562 operations per instance and step (46 MFLOP in all), so the kernel is
// bound by memory: 22.4 MB / 3.35 TB/s = 6.7 us on an H100 SXM at 700 W.
// Nothing here chases that bound yet: B = 4096 threads fill only 32 blocks
// of 128 on 132 SMs, and each thread's loads are strided by its instance.

#include <cuda_runtime.h>

namespace {

template <typename T, int n>
__global__ void riccati_compat_kernel(
    const T* __restrict__ A, long long sA,
    const T* __restrict__ Bm, long long sB,
    const T* __restrict__ gx, long long sgx,
    const T* __restrict__ gu, long long sgu,
    const T* __restrict__ diffs, long long sd,
    T mu, T* __restrict__ K, T* __restrict__ k, int Bt, int N) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= Bt) return;
  A += b * sA;
  Bm += b * sB;
  gx += b * sgx;
  gu += b * sgu;
  diffs += b * sd;
  K += (long long)b * N * n;
  k += (long long)b * N;

  T V[n][n], v[n];
#pragma unroll
  for (int i = 0; i < n; ++i) v[i] = gx[N * n + i];
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < n; ++j) V[i][j] = v[i] * v[j];

  for (int t = N - 1; t >= 0; --t) {
    T a[n][n], bc[n], q[n], c[n];
#pragma unroll
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int j = 0; j < n; ++j) a[i][j] = A[(t * n + i) * n + j];
      bc[i] = Bm[t * n + i];
      q[i] = gx[t * n + i];
      c[i] = diffs[t * n + i];
    }
    const T r = gu[t];
    const T R = r * r;

    // V <- sym(V) + mu I, in place (the upper triangle first reads both)
#pragma unroll
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int j = i; j < n; ++j) {
        const T s = T(0.5) * (V[i][j] + V[j][i]) + (i == j ? mu : T(0));
        V[i][j] = s;
        V[j][i] = s;
      }

    // u = V B; B^T V B; K_j = -2 invT (u^T A)_j; k
    T u[n];
    T BtVB = T(0);
#pragma unroll
    for (int i = 0; i < n; ++i) {
      T s = T(0);
#pragma unroll
      for (int j = 0; j < n; ++j) s += V[i][j] * bc[j];
      u[i] = s;
      BtVB += bc[i] * s;
    }
    const T invT = T(1) / (T(2) * BtVB + T(2) * R);
    T Kt[n];
#pragma unroll
    for (int j = 0; j < n; ++j) {
      T s = T(0);
#pragma unroll
      for (int l = 0; l < n; ++l) s += u[l] * a[l][j];
      Kt[j] = -invT * T(2) * s;
    }
    T Btv = T(0), uc = T(0);
#pragma unroll
    for (int i = 0; i < n; ++i) {
      Btv += bc[i] * v[i];
      uc += u[i] * c[i];
    }
    const T kt = -invT * (Btv + T(2) * uc + r);

    // ABK = A + B K, in place
#pragma unroll
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int j = 0; j < n; ++j) a[i][j] += bc[i] * Kt[j];

    // V' = ABK^T (V ABK) + q q^T + K^T R K, written over V
    T P[n][n];
#pragma unroll
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int j = 0; j < n; ++j) {
        T s = T(0);
#pragma unroll
        for (int l = 0; l < n; ++l) s += V[i][l] * a[l][j];
        P[i][j] = s;
      }
#pragma unroll
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int j = 0; j < n; ++j) {
        T s = T(0);
#pragma unroll
        for (int l = 0; l < n; ++l) s += a[l][i] * P[l][j];
        V[i][j] = s + q[i] * q[j] + Kt[i] * R * Kt[j];
      }

    // v' = 2 (B k + c)^T V' ABK + v^T ABK + q + 2 k R K
    T y[n];
#pragma unroll
    for (int j = 0; j < n; ++j) {
      T s = T(0);
#pragma unroll
      for (int i = 0; i < n; ++i) s += (bc[i] * kt + c[i]) * V[i][j];
      y[j] = s;
    }
    T vn[n];
#pragma unroll
    for (int j = 0; j < n; ++j) {
      T s1 = T(0), s2 = T(0);
#pragma unroll
      for (int i = 0; i < n; ++i) {
        s1 += y[i] * a[i][j];
        s2 += v[i] * a[i][j];
      }
      vn[j] = T(2) * s1 + s2 + q[j] + T(2) * kt * R * Kt[j];
    }
#pragma unroll
    for (int j = 0; j < n; ++j) {
      v[j] = vn[j];
      K[t * n + j] = Kt[j];
    }
    k[t] = kt;
  }
}

template <typename T>
int launch(const T* A, long long sA, const T* B, long long sB, const T* gx,
           long long sgx, const T* gu, long long sgu, const T* diffs,
           long long sd, T mu, T* K, T* k, int Bt, int N, int n,
           cudaStream_t stream) {
  if (n != 4 || Bt < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (Bt == 0) return 0;
  const int threads = 128;
  const int blocks = (Bt + threads - 1) / threads;
  riccati_compat_kernel<T, 4><<<blocks, threads, 0, stream>>>(
      A, sA, B, sB, gx, sgx, gu, sgu, diffs, sd, mu, K, k, Bt, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int riccati_compat_f64(const double* A, long long sA,
                                  const double* B, long long sB,
                                  const double* gx, long long sgx,
                                  const double* gu, long long sgu,
                                  const double* diffs, long long sd,
                                  double mu, double* K, double* k, int Bt,
                                  int N, int n, void* stream) {
  return launch<double>(A, sA, B, sB, gx, sgx, gu, sgu, diffs, sd, mu, K, k,
                        Bt, N, n, (cudaStream_t)stream);
}

extern "C" int riccati_compat_f32(const float* A, long long sA,
                                  const float* B, long long sB,
                                  const float* gx, long long sgx,
                                  const float* gu, long long sgu,
                                  const float* diffs, long long sd, float mu,
                                  float* K, float* k, int Bt, int N, int n,
                                  void* stream) {
  return launch<float>(A, sA, B, sB, gx, sgx, gu, sgu, diffs, sd, mu, K, k,
                       Bt, N, n, (cudaStream_t)stream);
}
