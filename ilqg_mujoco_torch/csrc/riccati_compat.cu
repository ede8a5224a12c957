// Batched compat Riccati backward pass (nu = 1) for Hopper (sm_90a).
//
// Replaces the TPU kernel ilqg_mujoco_tpu/experimental/pallas_riccati.py,
// function backward_compat_batched (Pallas body _kernel).  It computes the
// reference's compat backward recursion (reference inc/ilqr.h:133-176,
// ilqr.backward_pass_compat) for a batch of independent instances with one
// control and n = 2 nv states, for every even n from 2 to 32:
//
//   V = v v^T (v: terminal cost gradient), then for t = N-1 .. 0:
//     V  <- sym(V) + mu I                      (the shift is never removed)
//     invT = 1 / (2 B^T V B + 2 r^2)
//     K  = -2 invT B^T V A,   k = -invT (B^T (v + 2 V c) + r)
//     V' = (A+BK)^T V (A+BK) + q q^T + K^T r^2 K
//     v' = 2 (B k + c)^T V' (A+BK) + v^T (A+BK) + q + 2 k r^2 K
//   (v' reads the NEW V: the reference's aliasing, inc/ilqr.h:173-174).
//
// Bound.  The recursion does 4n^3 + 15n^2 + 14n + 10 operations per
// instance and step on (n^2 + 3n + 1) input elements: at n = 4, 562
// operations on 232 bytes in double, about 2.4 operations a byte, against
// the H100's float64 ridge of about 10 (34 TFLOP/s over 3.35 TB/s).  So
// the work is bound by bytes: at B = 4096, N = 20, n = 4 the kernel reads
// and writes 684 elements per instance, 22.4 MB in double, 6.7 us at
// 3.35 TB/s (H100 SXM, 700 W).  Tensor cores do not help.  What holds a
// kernel of this recursion back is latency, and the design answers each
// cause:
//   1. Occupancy.  One thread per instance gave 32 blocks at B = 4096.
//      Here an instance has n^2 threads (thread (i, j) owns V[i][j]) and a
//      block holds max(1, 128 / n^2) instances: 512 blocks of 128 threads
//      at B = 4096, n = 4, all resident at once on 132 SMs.
//   2. The serial chain.  Each thread's chain per step is O(n) (a row or a
//      column sum, one term of a product), not O(n^3).  Where the
//      instance's tile lies inside one warp (n <= 4) the sums and the
//      transposes are warp shuffles and the barriers are __syncwarp; for
//      larger n they go through shared memory with block barriers.  The
//      operands of P = V (A+BK) and of V' are read from shared-memory
//      copies of V, (A+BK)^T and P^T, so each thread's operands are two
//      contiguous rows.  The v' update of step t is finished at the top of
//      step t-1, where its sums overlap those of V's symmetrisation and
//      u = V b instead of lengthening the chain.
//   3. Prefetch.  The inputs of the next kStages-1 steps are in flight in a
//      shared-memory ring (cp.async, commit_group / wait_group) while a
//      step computes, so a step waits for no load issued in it.
//   4. Coalescing.  Neighbouring threads copy neighbouring elements of an
//      instance's contiguous block (A[b, t] is n^2 elements), so a warp's
//      copy covers whole lines instead of one line per instance.
// What bounds this design instead: at n = 4 a warp runs about 170
// instructions per step, 34 of them shuffles and about 20 shared-memory
// accesses, so at B = 4096 the SMs' issue and shared-memory/shuffle pipes,
// not the bytes and not one tile's chain, set the time (PERF.md, Findings).
// The ragged edge is masked, never returned from: every thread of the
// block reaches every barrier, and a masked instance computes on zeros
// (r = 1, so it stays finite) and stores nothing.  Terminal gains are not
// written; the caller appends zeros.  The batch stride of every array is
// an argument, so a view that drops the terminal knot of the linearizer's
// (B, N+1, ...) output is read in place.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 32;    // the largest n whose n^2 tile fits a block
constexpr int kStages = 4;   // ring depth: steps in flight beyond the one
                             // being computed is kStages - 1
constexpr unsigned kFull = 0xffffffffu;

template <int n>
struct Shape {
  static constexpr int NN = n * n;                     // threads a tile
  static constexpr int IPB = NN >= 128 ? 1 : 128 / NN;  // tiles a block
  static constexpr int THREADS = IPB * NN;
  static constexpr bool WARP = NN <= 32;   // a tile inside one warp
  static constexpr int L = NN + 3 * n + 1;  // a stage: A | B | q | c | r
  static constexpr int SCRATCH = WARP ? 0 : 3 * NN;  // up to 3 sums at once
  // ring, then V, A+BK, P, then two scratch buffers, per tile
  static constexpr int ELEMS = IPB * (kStages * L + 3 * NN + 2 * SCRATCH);
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Sums and transposes over one instance's n x n tile of threads, thread
// (i, j) holding one value each.  A row sum (over j) reaches every thread
// of row i, a column sum (over i) every thread of column j; transpose
// returns the value of thread (j, i).  In a warp the sums are butterflies,
// so every thread of a row or column gets the same bits.  Otherwise the
// values go through one of two scratch buffers in turn: a buffer is
// written only after the next call's barrier, which every thread reaches
// after reading the buffer's last contents.
template <typename T, int n>
struct Tile {
  using S = Shape<n>;
  int i, j, tid, lane_t;
  T* scratch[2];
  int turn;

  __device__ void sync() const {
    if constexpr (S::WARP) __syncwarp(); else __syncthreads();
  }

  __device__ T* next() {
    T* p = scratch[turn];
    turn ^= 1;
    return p;
  }

  __device__ T transpose(T x) {
    if constexpr (S::WARP) {
      return __shfl_sync(kFull, x, lane_t);
    } else {
      T* s = next();
      s[tid] = x;
      sync();
      return s[j * n + i];
    }
  }

  template <int K>
  __device__ void row_sums(T (&x)[K]) {
    if constexpr (S::WARP) {
#pragma unroll
      for (int off = n / 2; off >= 1; off >>= 1)
#pragma unroll
        for (int m = 0; m < K; ++m) x[m] += __shfl_xor_sync(kFull, x[m], off);
    } else {
      T* s = next();
#pragma unroll
      for (int m = 0; m < K; ++m) s[m * S::NN + tid] = x[m];
      sync();
#pragma unroll
      for (int m = 0; m < K; ++m) {
        T acc = T(0);
#pragma unroll
        for (int l = 0; l < n; ++l) acc += s[m * S::NN + i * n + l];
        x[m] = acc;
      }
    }
  }

  template <int K>
  __device__ void col_sums(T (&x)[K]) {
    if constexpr (S::WARP) {
#pragma unroll
      for (int off = S::NN / 2; off >= n; off >>= 1)
#pragma unroll
        for (int m = 0; m < K; ++m) x[m] += __shfl_xor_sync(kFull, x[m], off);
    } else {
      T* s = next();
#pragma unroll
      for (int m = 0; m < K; ++m) s[m * S::NN + tid] = x[m];
      sync();
#pragma unroll
      for (int m = 0; m < K; ++m) {
        T acc = T(0);
#pragma unroll
        for (int l = 0; l < n; ++l) acc += s[m * S::NN + l * n + j];
        x[m] = acc;
      }
    }
  }

  __device__ T col_sum(T x) {
    T a[1] = {x};
    col_sums<1>(a);
    return a[0];
  }
};

template <typename T, int n>
__global__ void __launch_bounds__(Shape<n>::THREADS) riccati_compat_kernel(
    const T* __restrict__ A, long long sA,
    const T* __restrict__ Bm, long long sB,
    const T* __restrict__ gx, long long sgx,
    const T* __restrict__ gu, long long sgu,
    const T* __restrict__ diffs, long long sd,
    T mu, T* __restrict__ K, T* __restrict__ k, int Bt, int N) {
  using S = Shape<n>;
  constexpr int NN = S::NN, L = S::L;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int slot = threadIdx.x / NN;
  const int tid = threadIdx.x - slot * NN;
  const int i = tid / n, j = tid - (tid / n) * n;
  const long long b = (long long)blockIdx.x * S::IPB + slot;
  const bool live = b < Bt;

  T* ring = smem + slot * L;                          // stage s: + s*IPB*L
  T* sV = smem + kStages * S::IPB * L + slot * NN;
  T* sM = sV + S::IPB * NN;                           // (A+BK)^T
  T* sP = sM + S::IPB * NN;                           // P^T
  Tile<T, n> tile;
  tile.i = i;
  tile.j = j;
  tile.tid = tid;
  tile.lane_t = (int)(threadIdx.x & 31) - tid + j * n + i;
  tile.scratch[0] = smem + S::IPB * (kStages * L + 3 * NN) + slot * S::SCRATCH;
  tile.scratch[1] = tile.scratch[0] + S::IPB * S::SCRATCH;
  tile.turn = 0;

  if (live) {
    A += b * sA;
    Bm += b * sB;
    gx += b * sgx;
    gu += b * sgu;
    diffs += b * sd;
    K += b * N * n;
    k += b * N;
  }

  // step t's inputs into a stage, neighbouring threads on neighbouring
  // elements: thread tid copies A's element tid and the vector elements
  // (B | q | c | r) tid + m NN, each from src + t * step.  A masked
  // instance's stages hold zeros and r = 1 from the start and are never
  // copied into.
  constexpr int E = (3 * n + 1 + NN - 1) / NN;
  const T* vsrc[E];
  int vstep[E];
  bool vok[E];
#pragma unroll
  for (int m = 0; m < E; ++m) {
    const int e = tid + m * NN;
    vok[m] = live && e < 3 * n + 1;
    vsrc[m] = e < n ? Bm + e : e < 2 * n ? gx + (e - n)
              : e < 3 * n ? diffs + (e - 2 * n) : gu;
    vstep[m] = e < 3 * n ? n : 1;
  }
  if (!live) {
    for (int s = 0; s < kStages; ++s) {
      T* st = ring + s * S::IPB * L;
      st[tid] = T(0);
#pragma unroll
      for (int m = 0; m < E; ++m) {
        const int e = tid + m * NN;
        if (e < 3 * n + 1) st[NN + e] = e == 3 * n ? T(1) : T(0);
      }
    }
  }
  auto fetch = [&](int t, int stage) {
    T* st = ring + stage * S::IPB * L;
    if (live) cp_async<sizeof(T)>(st + tid, A + (long long)t * NN + tid);
#pragma unroll
    for (int m = 0; m < E; ++m)
      if (vok[m])
        cp_async<sizeof(T)>(st + NN + tid + m * NN, vsrc[m] + t * vstep[m]);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (N - 1 - s >= 0) fetch(N - 1 - s, s);
    cp_async_commit();
  }

  // v is updated one step late: step t's v' is finished at the top of
  // step t-1, where its chain overlaps the symmetrisation and u = V b.
  // The carried terms start as an update that yields the terminal v.
  const T vN_j = live ? gx[(long long)N * n + j] : T(0);
  T V = (live ? gx[(long long)N * n + i] : T(0)) * vN_j;
  T vj = T(0), pw = T(0), pM = i == j ? T(1) : T(0), pq = vN_j, pK = T(0);

  for (int it = 0; it < N; ++it) {
    const int t = N - 1 - it;
    if (t - (kStages - 1) >= 0)
      fetch(t - (kStages - 1), (it + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    tile.sync();

    const T* st = ring + (it % kStages) * S::IPB * L;
    const T a = st[tid];
    const T bi = st[NN + i], bj = st[NN + j];
    const T qi = st[NN + n + i], qj = st[NN + n + j];
    const T ci = st[NN + 2 * n + i];
    const T r = st[NN + 3 * n];
    const T R = r * r;

    // the previous step's v' (V still holds its V'):
    // v'_j = sum_i (2 y_i + v_i) (A+BK)_ij + q_j + 2 k R K_j,
    // y_j = sum_i (b_i k + c_i) V'_ij
    const T Vt = tile.transpose(V);
    const T yj = tile.col_sum(pw * V);
    // V <- sym(V) + mu I; u_i = (V b)_i
    V = T(0.5) * (V + Vt) + (i == j ? mu : T(0));
    T rs[1] = {V * bj};
    tile.row_sums(rs);
    const T ui = rs[0];
    const T zi = tile.transpose(T(2) * yj + vj);
    vj = tile.col_sum(zi * pM) + pq + pK;

    // B^T V B, (u^T A)_j and u^T c, column sums; B^T v, a row sum
    T cs[3] = {bi * ui, ui * a, ui * ci};
    tile.col_sums(cs);
    T bv[1] = {bj * vj};
    tile.row_sums(bv);
    const T invT = T(1) / (T(2) * cs[0] + T(2) * R);
    const T Kj = -invT * T(2) * cs[1];
    const T kt = -invT * (bv[0] + T(2) * cs[2] + r);
    const T M = a + bi * Kj;                         // (A + B K)_ij
    const T Ki = tile.transpose(Kj);

    // P = V (A+BK), then V' = (A+BK)^T P + q q^T + K^T R K, with
    // (A+BK) and P stored transposed so that the operands are rows
    sV[tid] = V;
    sM[j * n + i] = M;
    tile.sync();
    T P = T(0);
#pragma unroll
    for (int l = 0; l < n; ++l) P += sV[i * n + l] * sM[j * n + l];
    sP[j * n + i] = P;
    tile.sync();
    T Vn = T(0);
#pragma unroll
    for (int l = 0; l < n; ++l) Vn += sM[i * n + l] * sP[j * n + l];
    V = Vn + (qi * qj + Ki * R * Kj);
    pw = bi * kt + ci;
    pM = M;
    pq = qj;
    pK = T(2) * kt * R * Kj;

    if (live && i == 0) K[t * n + j] = Kj;
    if (live && tid == 0) k[t] = kt;
  }
}

template <typename T, int n>
int launch_n(const T* A, long long sA, const T* B, long long sB, const T* gx,
             long long sgx, const T* gu, long long sgu, const T* diffs,
             long long sd, T mu, T* K, T* k, int Bt, int N,
             cudaStream_t stream) {
  using S = Shape<n>;
  const size_t smem = sizeof(T) * S::ELEMS;
  auto kern = riccati_compat_kernel<T, n>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (Bt + S::IPB - 1) / S::IPB;
  kern<<<blocks, S::THREADS, smem, stream>>>(A, sA, B, sB, gx, sgx, gu, sgu,
                                             diffs, sd, mu, K, k, Bt, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* A, long long sA, const T* B, long long sB, const T* gx,
           long long sgx, const T* gu, long long sgu, const T* diffs,
           long long sd, T mu, T* K, T* k, int Bt, int N, int n,
           cudaStream_t stream) {
  if (n < 2 || n > kMaxN || n % 2 || Bt < 0 || N < 0)
    return (int)cudaErrorInvalidValue;
  if (Bt == 0 || N == 0) return 0;
#define RICCATI_CASE(NV2)                                                   \
  case NV2:                                                                 \
    return launch_n<T, NV2>(A, sA, B, sB, gx, sgx, gu, sgu, diffs, sd, mu,  \
                            K, k, Bt, N, stream);
  switch (n) {
    RICCATI_CASE(2) RICCATI_CASE(4) RICCATI_CASE(6) RICCATI_CASE(8)
    RICCATI_CASE(10) RICCATI_CASE(12) RICCATI_CASE(14) RICCATI_CASE(16)
    RICCATI_CASE(18) RICCATI_CASE(20) RICCATI_CASE(22) RICCATI_CASE(24)
    RICCATI_CASE(26) RICCATI_CASE(28) RICCATI_CASE(30) RICCATI_CASE(32)
  }
#undef RICCATI_CASE
  return (int)cudaErrorInvalidValue;
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
