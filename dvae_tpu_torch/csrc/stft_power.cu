// STFT power spectrogram as a fused real FFT, for sm_90a (H100).
//
// Replaces dvae_tpu/ops/pallas_stft.py::_stft_power_kernel. For every frame
// i of every waveform b (frame i = x[b, i*hop : i*hop + nfft]) it computes
// the windowed nfft-point real DFT X[k], k <= nfft/2, and writes
//     p = re^2 + im^2,  or p = log(p + eps) when log_out,
// as (batch, n_frames, nfft/2 + 1), exactly nfft/2 + 1 bins per frame.
//
// Bound on this card. Per frame the function needs the window and one
// FFT (~5 nfft log2 nfft = 51 kFLOP at nfft 1024) and the bytes of one hop
// of waveform in and 513 bins out. At the train frame set (40,448 frames)
// that is ~2.2 GFLOP against ~125 MB: bound by bytes, ~0.037 ms at
// 3.35 TB/s, and two thirds of those bytes are the output.
//
// Design. The real-input transform runs as a complex FFT of half the size:
//   1. pack z[m] = w[2m] x[2m] + i w[2m+1] x[2m+1], m < N = nfft/2;
//   2. a Stockham (self-sorting) N-point FFT: radix-8 passes while 8 points
//      remain, then one radix-4 or radix-2 pass (512 = 8 x 8 x 8). A pass
//      with stride NS reads v[r] = buf[j + r N/R], multiplies by W_N^((j%NS)
//      r N/(NS R)), does an R-point DFT in registers and writes
//      buf[(j/NS) NS R + j%NS + r NS]; the output is in natural order;
//   3. the real split: with A = Z[k], B = Z[N-k], E = (A + B*)/2 and
//      O = (A - B*)/2i, X[k] = E + W_nfft^k O and X[N - k] = (E - W_nfft^k O)*,
//      so each lane turns one pair (k, N-k) into two bins;
//   4. the epilogue in registers and a store of each bin straight from the
//      lane that made it: a warp writes 32 consecutive floats at a time.
// A block owns a run of fpb consecutive frames of one waveform: 32 where
// the grid then keeps >= 8 blocks per SM (the train frame set's 1,280
// blocks), else 8, one per warp (a VAD batch's 640 blocks). It
// loads their contiguous stretch of (fpb - 1) hop + nfft samples into shared
// memory once (float4 loads when aligned); frames are read from there at hop
// offsets, windowed as they are packed, and the frame matrix never exists.
// Each of the 8 warps runs whole frames on its own N-point float2 buffer
// (4 KB at nfft 1024), in place, with __syncwarp() between passes and no
// block barrier after the load. Buffer index i lives at i ^ ((i >> 3) & 15):
// every pass and the split then read and write it at (nearly) 2 shared
// wavefronts per float2 access, against up to 16 unswizzled. The window,
// the per-pass twiddles (laid out [pass][r - 1][j % NS], so consecutive
// lanes read consecutive entries) and W_nfft^k come from tables that the
// host builds in float64 and rounds to f32, read through the L1 cache.
// Registers and shared memory per block at nfft 1024, hop 256: ptxas gives
// 128 registers (the cap of __launch_bounds__(256, 2)) with 32 bytes of
// spill, so registers allow 2 blocks (16 warps) per SM; shared memory is
// 32,768 B of buffers plus the stretch, 68,608 B at fpb 32 and 44,032 B at
// fpb 8, so it never holds fewer blocks than that. A cap of 85 registers
// (3 blocks per SM, 136 bytes of spill) and blocks of 4 warps both ran
// slower on the card. nfft 2048 spills 584 bytes; no caller uses it. The
// card's SM count and shared memory, and the kernel's shared-memory
// attribute, are set up once per device, so a launch costs the host only
// the launch itself.
//
// Why f32. The DFT is taken in full f32 arithmetic with f32 tables: TF32 or
// half-precision products would leave ~1e-3 relative error, which log()
// turns into O(1) errors in near-silent bins. An FFT's rounding grows as
// log2 nfft, below the plain matmul DFT's.
//
// Plain C interface, loaded with ctypes; stft_power_launch returns the
// cudaError_t of the launch (cudaErrorInvalidValue for an nfft it does not
// take).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace {

constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;
constexpr float RSQRT2 = 0.70710678118654752f;

struct Args {
  const float* x;          // (batch, t_pad) waveforms
  const float* win;        // (nfft,) window
  const float2* tw;        // Stockham twiddles, [pass][r - 1][j % NS]
  const float2* tw_split;  // W_nfft^k, k < nfft / 2
  float* out;              // (batch, n_frames, nfft / 2 + 1)
  int t_pad, n_frames, hop, fpb, log_out;
  float eps;
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_mi(float2 a) { return make_float2(a.y, -a.x); }  // a * -i

// in place forward R-point DFT: v[q] <- sum_r v[r] exp(-2 pi i r q / R)
template <int R>
__device__ __forceinline__ void dft(float2* v);

template <>
__device__ __forceinline__ void dft<2>(float2* v) {
  const float2 t = v[0];
  v[0] = cadd(t, v[1]);
  v[1] = csub(t, v[1]);
}

template <>
__device__ __forceinline__ void dft<4>(float2* v) {
  const float2 c0 = cadd(v[0], v[2]), c1 = csub(v[0], v[2]);
  const float2 c2 = cadd(v[1], v[3]), c3 = mul_mi(csub(v[1], v[3]));
  v[0] = cadd(c0, c2);
  v[1] = cadd(c1, c3);
  v[2] = csub(c0, c2);
  v[3] = csub(c1, c3);
}

template <>
__device__ __forceinline__ void dft<8>(float2* v) {
  float2 e[4], o[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    e[r] = cadd(v[r], v[r + 4]);
    o[r] = csub(v[r], v[r + 4]);
  }
  // o[r] *= exp(-2 pi i r / 8)
  o[1] = make_float2(RSQRT2 * (o[1].x + o[1].y), RSQRT2 * (o[1].y - o[1].x));
  o[2] = mul_mi(o[2]);
  o[3] = make_float2(RSQRT2 * (o[3].y - o[3].x), -RSQRT2 * (o[3].x + o[3].y));
  dft<4>(e);
  dft<4>(o);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = e[q];
    v[2 * q + 1] = o[q];
  }
}

// where buffer index i lives
__device__ __forceinline__ int sw(int i) { return i ^ ((i >> 3) & 15); }

template <int N>
__host__ __device__ constexpr int radix_at(int ns) { return N / ns >= 8 ? 8 : N / ns; }

// Stockham destination of output r of butterfly j in a pass of stride NS
template <int R, int NS>
__device__ __forceinline__ int dest(int j, int r) { return (j / NS) * NS * R + j % NS + r * NS; }

// First pass (NS = 1, no twiddles): pack and window the frame's samples
// from the stretch, R-point DFTs, write the buffer.
template <int N, int R>
__device__ __forceinline__ void first_pass(const float* xf, bool even, const float* win,
                                           float2* buf, int lane) {
  constexpr int NB = N / R, PER = (NB + 31) / 32;
  float2 v[PER][R];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int j = lane + 32 * p;
    if (NB % 32 == 0 || j < NB) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int m = j + r * NB;
        const float2 s = even ? *reinterpret_cast<const float2*>(xf + 2 * m)
                              : make_float2(xf[2 * m], xf[2 * m + 1]);
        const float2 w = __ldg(reinterpret_cast<const float2*>(win) + m);
        v[p][r] = make_float2(s.x * w.x, s.y * w.y);
      }
      dft<R>(v[p]);
    }
  }
  __syncwarp();  // the previous frame's split has read the buffer
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int j = lane + 32 * p;
    if (NB % 32 == 0 || j < NB) {
#pragma unroll
      for (int r = 0; r < R; ++r) buf[sw(dest<R, 1>(j, r))] = v[p][r];
    }
  }
  __syncwarp();
}

// A later pass in place on the buffer; tw points at this pass's twiddles.
template <int N, int R, int NS>
__device__ __forceinline__ void pass(float2* buf, const float2* tw, int lane) {
  constexpr int NB = N / R, PER = (NB + 31) / 32;
  float2 v[PER][R];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int j = lane + 32 * p;
    if (NB % 32 == 0 || j < NB) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[p][r] = buf[sw(j + r * NB)];
#pragma unroll
      for (int r = 1; r < R; ++r) v[p][r] = cmul(v[p][r], __ldg(tw + (r - 1) * NS + j % NS));
      dft<R>(v[p]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int j = lane + 32 * p;
    if (NB % 32 == 0 || j < NB) {
#pragma unroll
      for (int r = 0; r < R; ++r) buf[sw(dest<R, NS>(j, r))] = v[p][r];
    }
  }
  __syncwarp();
}

// The passes after the first, from stride NS on; OFF is where their
// twiddles start in the table.
template <int N, int NS, int OFF>
__device__ __forceinline__ void later_passes(float2* buf, const float2* tw, int lane) {
  if constexpr (NS < N) {
    constexpr int R = radix_at<N>(NS);
    pass<N, R, NS>(buf, tw + OFF, lane);
    later_passes<N, NS * R, OFF + (R - 1) * NS>(buf, tw, lane);
  }
}

// The real split and the epilogue: bins k and N - k from Z[k] and Z[N - k].
template <int N>
__device__ __forceinline__ void split_store(const float2* buf, const float2* tw_split,
                                            float* row, int lane, int log_out, float eps) {
#pragma unroll
  for (int i = 0; i <= N / 64; ++i) {
    const int k = lane + 32 * i;
    if (k > N / 2) break;
    const float2 a = buf[sw(k)], b = buf[sw((N - k) & (N - 1))];
    const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
    const float2 o = make_float2(0.5f * (a.y + b.y), -0.5f * (a.x - b.x));
    const float2 t = cmul(__ldg(tw_split + k), o);
    const float2 lo = cadd(e, t), hi = csub(e, t);
    float p_lo = lo.x * lo.x + lo.y * lo.y, p_hi = hi.x * hi.x + hi.y * hi.y;
    if (log_out) {
      p_lo = logf(p_lo + eps);
      p_hi = logf(p_hi + eps);
    }
    row[k] = p_lo;
    if (k != N / 2) row[N - k] = p_hi;
  }
}

template <int N>
__global__ void __launch_bounds__(NT, 2) stft_power_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, f0 = blockIdx.x * a.fpb;
  const int nf = min(a.fpb, a.n_frames - f0);
  float2* buf = reinterpret_cast<float2*>(smem) + warp * N;
  float* xs = smem + 2 * WARPS * N;  // the frames' waveform stretch

  // every frame below n_frames lies inside t_pad, so the stretch does too
  const int span = (nf - 1) * a.hop + 2 * N;
  const float* xb = a.x + (size_t)b * a.t_pad + (size_t)f0 * a.hop;
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(xb) & 15) == 0) {
    const int n4 = span / 4;
    for (int i = tid; i < n4; i += NT)
      reinterpret_cast<float4*>(xs)[i] = __ldg(reinterpret_cast<const float4*>(xb) + i);
    head = 4 * n4;
  }
  for (int i = head + tid; i < span; i += NT) xs[i] = __ldg(xb + i);
  __syncthreads();

  constexpr int R0 = radix_at<N>(1);
  for (int f = warp; f < nf; f += WARPS) {
    const int off = f * a.hop;
    first_pass<N, R0>(xs + off, (off & 1) == 0, a.win, buf, lane);
    later_passes<N, R0, 0>(buf, a.tw, lane);
    split_store<N>(buf, a.tw_split, a.out + ((size_t)b * a.n_frames + f0 + f) * (N + 1), lane,
                   a.log_out, a.eps);
  }
}

size_t smem_bytes(int nfft, int hop, int fpb) {
  return sizeof(float) * ((size_t)WARPS * nfft + (size_t)(fpb - 1) * hop + nfft);
}

constexpr int MAX_DEVICES = 64;

// The card's SM count and opt-in shared memory per block, queried once per
// device (0 until then).
void card(int dev, int* sms, int* max_smem) {
  static std::atomic<int> known_sms[MAX_DEVICES], known_smem[MAX_DEVICES];
  const bool cached = dev >= 0 && dev < MAX_DEVICES;
  *sms = cached ? known_sms[dev].load() : 0;
  *max_smem = cached ? known_smem[dev].load() : 0;
  if (*sms > 0) return;
  *sms = 132;
  *max_smem = 232448;
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (cached) {
    known_smem[dev].store(*max_smem);
    known_sms[dev].store(*sms);
  }
}

// Frames per block for this launch: 32 where that still gives >= 8 blocks
// per SM and fits in shared memory, else 8 (one frame per warp).
int frames_per_block(int dev, int batch, int n_frames, int nfft, int hop) {
  int sms, max_smem;
  card(dev, &sms, &max_smem);
  const int fpb = 4 * WARPS;
  const long long blocks = (long long)batch * ((n_frames + fpb - 1) / fpb);
  if (blocks >= 8LL * sms && smem_bytes(nfft, hop, fpb) <= (size_t)max_smem) return fpb;
  return WARPS;
}

// Raises the kernel's dynamic shared memory limit on a device to what a
// launch needs, once for each larger need (the attribute only grows).
template <int N>
cudaError_t allow_smem(int dev, int smem) {
  static std::atomic<int> allowed[MAX_DEVICES];
  static std::mutex mu;
  const bool cached = dev >= 0 && dev < MAX_DEVICES;
  if (cached && smem <= allowed[dev].load()) return cudaSuccess;
  std::lock_guard<std::mutex> lock(mu);
  if (cached && smem <= allowed[dev].load()) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      stft_power_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cached) allowed[dev].store(smem);
  return err;
}

template <int N>
int launch(const Args& a, int batch, int dev, cudaStream_t stream) {
  const int smem = (int)smem_bytes(2 * N, a.hop, a.fpb);
  const cudaError_t err = allow_smem<N>(dev, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n_frames + a.fpb - 1) / a.fpb, batch);
  stft_power_kernel<N><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Warps per block; the wrapper checks framings against this.
int stft_power_warps() { return WARPS; }

// Bytes of dynamic shared memory one block of fpb frames needs.
long long stft_power_smem_bytes(int nfft, int hop, int fpb) {
  return (long long)smem_bytes(nfft, hop, fpb);
}

int stft_power_launch(const float* x, const float* win, const float* tw, const float* tw_split,
                      float* out, int batch, int t_pad, int n_frames, int nfft, int hop,
                      int log_out, float eps, void* stream) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  Args a{x, win, reinterpret_cast<const float2*>(tw), reinterpret_cast<const float2*>(tw_split),
         out, t_pad, n_frames, hop, frames_per_block(dev, batch, n_frames, nfft, hop),
         log_out, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nfft) {
    case 256: return launch<128>(a, batch, dev, s);
    case 512: return launch<256>(a, batch, dev, s);
    case 1024: return launch<512>(a, batch, dev, s);
    case 2048: return launch<1024>(a, batch, dev, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
