// STFT power spectrogram with a fused epilogue, for sm_90a (H100).
//
// Replaces dvae_tpu/ops/pallas_stft.py::_stft_power_kernel. For every frame
// i of every waveform b (frame i = x[b, i*hop : i*hop + nfft]) and every
// bin k < n_bins:
//     re = sum_n frame[n] cos_w[n][k]       im = sum_n frame[n] msin_w[n][k]
//     p  = re^2 + im^2                      p = log(p + eps) when log_out
// against the window-folded DFT bases cos_w = w cos(2 pi n k / nfft) and
// msin_w = -w sin(2 pi n k / nfft), each (nfft, n_bins) row-major. The
// output is (batch, n_frames, n_bins), exactly n_bins columns.
//
// Bound on this card. The function needs an FFT per frame (~5 nfft log2 nfft
// operations) and the bytes of waveform and output: for 32 utterances of
// ~5.1 s (~10,240 frames) that is ~0.5 GFLOP against ~31 MB, so it is bound
// by bytes, ~0.01 ms at 3.35 TB/s. This kernel does the DFT as products
// instead, 2 * rows * nfft * 2 n_bins = 21.5 GFLOP at that shape, 0.32 ms at
// the 67 TFLOP/s f32 CUDA-core peak: its own design is bound by operations,
// ~30x above the function's bound. The products stay in full f32 FMAs on
// CUDA cores: TF32 keeps ~3 digits, and log() turns that into O(1) errors
// in near-silent bins.
//
// Design. A block owns TM = 64 consecutive frames of one waveform and
// TN = 64 bins. Its frames span one contiguous stretch of
// (TM - 1) * hop + nfft samples (68.6 KB at hop 256, nfft 1024), loaded
// into shared memory once: each sample is read from device memory once per
// bin tile, and the frame matrix is never materialized (what the TPU kernel
// could not avoid). The bases stream through shared memory in TK-row tiles,
// double-buffered, the next tile held in registers while the current one
// is used. Each warp owns 8 frames, each lane 2 adjacent bins of each, so
// a thread keeps 8 x 2 (re, im) sums in registers; per 4 basis rows it
// reads 8 broadcast float4 of samples and 4 float2 of each basis, 8 FMAs
// per shared load instruction. Basis columns past n_bins read as 0 and
// frames past n_frames are computed from zero samples; neither is written.
//
// Plain C interface, loaded with ctypes; stft_power_launch returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TM = 64;              // frames per block
constexpr int TN = 64;              // bins per block
constexpr int TK = 32;              // basis rows per shared-memory tile
constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;
constexpr int FPW = TM / WARPS;     // frames per warp
constexpr int BPL = TN / 32;        // bins per lane
constexpr int LPT = TK * TN / NT;   // basis values per thread per tile, per basis
static_assert(BPL == 2, "lanes read their bins as one float2");
static_assert(TK % 4 == 0, "samples are read as float4");

struct Args {
  const float* x;
  const float* cosb;
  const float* msinb;
  float* out;
  int t_pad, n_frames, nfft, hop, n_bins, log_out;
  float eps;
};

__host__ __device__ inline size_t smem_floats(int nfft, int hop) {
  return (size_t)4 * TK * TN + (size_t)(TM - 1) * hop + nfft;
}

__device__ __forceinline__ float lane_of(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fetch_tile(const Args& a, int k0, int n0, int tid,
                                           float* rc, float* rs) {
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int e = tid + j * NT;
    const int col = n0 + e % TN;
    const size_t g = (size_t)(k0 + e / TN) * a.n_bins + col;
    const bool ok = col < a.n_bins;
    rc[j] = ok ? a.cosb[g] : 0.f;
    rs[j] = ok ? a.msinb[g] : 0.f;
  }
}

__device__ __forceinline__ void stash_tile(float* bc, float* bs, int tid, const float* rc,
                                           const float* rs) {
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    bc[tid + j * NT] = rc[j];
    bs[tid + j * NT] = rs[j];
  }
}

__global__ void __launch_bounds__(NT, 2) stft_power_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* bc = smem;                  // [2][TK][TN] cos tiles
  float* bs = bc + 2 * TK * TN;      // [2][TK][TN] -sin tiles
  float* xs = bs + 2 * TK * TN;      // the block's waveform stretch
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f0 = blockIdx.x * TM, n0 = blockIdx.y * TN, b = blockIdx.z;

  const int span = (TM - 1) * a.hop + a.nfft;
  const long long start = (long long)f0 * a.hop;
  const float* xb = a.x + (size_t)b * a.t_pad + start;
  const long long avail = a.t_pad - start;
  for (int i = tid; i < span; i += NT) xs[i] = i < avail ? xb[i] : 0.f;

  float rc[LPT], rs[LPT];
  fetch_tile(a, 0, n0, tid, rc, rs);
  stash_tile(bc, bs, tid, rc, rs);
  __syncthreads();

  float re[FPW][BPL], im[FPW][BPL];
#pragma unroll
  for (int f = 0; f < FPW; ++f) {
#pragma unroll
    for (int j = 0; j < BPL; ++j) re[f][j] = im[f][j] = 0.f;
  }

  const float* xw = xs + (size_t)warp * FPW * a.hop;
  const int n_tiles = a.nfft / TK;
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) fetch_tile(a, (t + 1) * TK, n0, tid, rc, rs);
    const float* cb = bc + buf * TK * TN + lane * BPL;
    const float* sb = bs + buf * TK * TN + lane * BPL;
    const int k0 = t * TK;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 4) {
      float4 xv[FPW];
#pragma unroll
      for (int f = 0; f < FPW; ++f)
        xv[f] = *reinterpret_cast<const float4*>(xw + f * a.hop + k0 + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 c = *reinterpret_cast<const float2*>(cb + (kk + q) * TN);
        const float2 m = *reinterpret_cast<const float2*>(sb + (kk + q) * TN);
#pragma unroll
        for (int f = 0; f < FPW; ++f) {
          const float v = lane_of(xv[f], q);
          re[f][0] = fmaf(v, c.x, re[f][0]);
          re[f][1] = fmaf(v, c.y, re[f][1]);
          im[f][0] = fmaf(v, m.x, im[f][0]);
          im[f][1] = fmaf(v, m.y, im[f][1]);
        }
      }
    }
    if (t + 1 < n_tiles) stash_tile(bc + (buf ^ 1) * TK * TN, bs + (buf ^ 1) * TK * TN, tid, rc, rs);
    __syncthreads();
  }

#pragma unroll
  for (int f = 0; f < FPW; ++f) {
    const int frame = f0 + warp * FPW + f;
    if (frame >= a.n_frames) break;
    float* row = a.out + ((size_t)b * a.n_frames + frame) * a.n_bins;
#pragma unroll
    for (int j = 0; j < BPL; ++j) {
      const int col = n0 + lane * BPL + j;
      if (col < a.n_bins) {
        float p = re[f][j] * re[f][j] + im[f][j] * im[f][j];
        if (a.log_out) p = logf(p + a.eps);
        row[col] = p;
      }
    }
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for this framing.
long long stft_power_smem_bytes(int nfft, int hop) {
  return (long long)(smem_floats(nfft, hop) * sizeof(float));
}

// The tile sizes the wrapper checks shapes against: nfft must be a multiple
// of stft_power_k_tile(), hop a multiple of 4.
int stft_power_k_tile() { return TK; }

int stft_power_launch(const float* x, const float* cosb, const float* msinb, float* out,
                      int batch, int t_pad, int n_frames, int nfft, int hop, int n_bins,
                      int log_out, float eps, void* stream) {
  Args a{x, cosb, msinb, out, t_pad, n_frames, nfft, hop, n_bins, log_out, eps};
  const size_t smem = smem_floats(nfft, hop) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stft_power_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_frames + TM - 1) / TM, (n_bins + TN - 1) / TN, batch);
  stft_power_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
