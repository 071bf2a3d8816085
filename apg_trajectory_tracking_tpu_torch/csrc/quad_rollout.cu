// Fused k-step quadrotor rollout on Hopper: forward and backward kernels.
//
// Replaces ops/pallas_rollout.py::_rollout_kernel of the JAX package (the
// Pallas TPU kernel, forward only, with _quad_step_block as its step) and
// adds the reverse sweep that training needs. The step follows
// dynamics/quad.py::quad_step for any gravity vector:
//   thrust = a0*15 - 7.5 + 9.81
//   acc    = R(att)[:, 2] * thrust + gravity + translational_drag
//   pos'   = pos + 0.5*dt^2*acc + 0.5*dt*vel
//   vel'   = vel + dt*acc
//   att'   = att + dt*E(att)*av          (E from the OLD av)
//   av'    = av + dt*(kinv*((a1..3 - 0.5) - av) + rot_drag/J)
//
// What bounds it on this card. Per row the forward reads 12 + 4k floats and
// writes 12k; the backward reads the input state, the actions, all k saved
// states and the k output gradients (12 + 4k + 24k floats) and writes
// 4k + 12. At B = 4096, k = 10 that is 2.8 MB and 5.6 MB, 0.84 and 1.68 us
// at 3.35 TB/s, against a few hundred float operations per row-step, so the
// bound is bytes. In practice the kernels are bound by latency: only B rows
// exist, each a chain of k dependent steps, so at B = 4096 there are 128
// warps' worth of rows, about one warp per SM, and nothing hides a global
// round trip or the step's own arithmetic latency.
//
// Design. A block owns a tile of kRows rows, one thread per row, and walks
// the time axis in chunks of kChunk = 10 steps (one chunk at the shipped
// horizon; shared memory does not grow with k). Per chunk the block first
// stages its input tiles in shared memory: the forward its states (once)
// and the chunk's actions; the backward walks the chunks from the end and
// also stages the chunk's output gradients and its saved states, shifted by
// one step (step t reads out[t-1], or the input state at t = 0). Then each
// thread runs its row's steps with the 12 state values in registers,
// reading and writing shared memory only, and the block writes the chunk's
// output tile back. Global memory is touched in those copies alone, so a
// round trip is paid once per chunk, not once per step. Every copy is a
// TMA bulk copy of one row's contiguous span, whole 16-byte units, issued
// by the row's own thread and completed on an mbarrier (loads) or a bulk
// group (stores). Each row of a shared tile is padded to an odd number of
// float4, so when every thread reads or writes one float4 of its own row,
// the eight threads of a quarter-warp hit eight distinct groups of four
// banks: no bank conflicts. Every global row offset is a multiple of 16
// bytes; the wrapper (ops/rollout.py) refuses a data pointer that is not.
//
// Tile height. 8 rows spread B = 4096 over 512 blocks, about four per SM,
// one for each of its four warp schedulers, where 32 rows (one warp per
// block) would give each SM a single warp and leave three schedulers idle.
// On the H100, 8-row tiles with bulk copies timed fastest at B = 4096,
// against 4, 16, 32 and 64 rows and against 16-byte cp.async copies. At
// B = 8 only 4-row tiles beat them, by 0.3 to 0.6 us, and those lose 0.6
// us at B = 4096. PERF.md has that sweep.
//
// ptxas (-Xptxas -v, sm_90a): forward 50 registers, backward 64; each a
// 32-byte stack frame for sincosf's slow-path range reduction, no spills;
// 16 bytes of static shared memory (the mbarrier) besides the dynamic
// tiles, 5,760 bytes forward and 11,136 backward, under the 48 KB that a
// launch gets without opting in.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (no --use_fast_math: precise sincosf, since
//             angles grow along an unroll).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 8;
constexpr int kChunk = 10;

// row strides of the shared tiles in float4, odd (see the note above)
constexpr int odd(int n) { return n | 1; }
constexpr int kStateRow = 3;                // one state, 12 floats
constexpr int kActRow = odd(kChunk);        // a chunk of actions, 4 each
constexpr int kSeqRow = odd(3 * kChunk);    // a chunk of states, 12 each
constexpr int kFwdSmem = 16 * kRows * (kStateRow + kActRow + kSeqRow);
constexpr int kBwdSmem = 16 * kRows * (kStateRow + 2 * kActRow + 2 * kSeqRow);
static_assert(kFwdSmem <= 48 * 1024 && kBwdSmem <= 48 * 1024,
              "dynamic shared memory above 48 KB needs an opt-in");

struct QuadConsts {
  float kinv[3];
  float gravity[3];
  float trans_drag[3];
  float rot_drag_over_inertia[3];
  float dt;
  float half_dt;     // 0.5 * dt
  float half_dt_sq;  // 0.5 * dt * dt
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Moves a block's tiles between global and shared memory with TMA bulk
// copies, thread i copying row i. A tile is `rows` rows of `units` float4
// each; a row is contiguous in both memories.
class Stager {
 public:
  __device__ Stager(uint64_t* bar, int rows) : bar_(bar), rows_(rows) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(smem_u32(bar)), "r"(blockDim.x) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }

  // Start copying row i of src (at src + i * src_row) to dst + i * dst_row.
  // The thread announces its bytes on the barrier before its copy, and
  // arrives only in wait().
  __device__ void load(float4* dst, int dst_row, const float4* src,
                       size_t src_row, int units) {
    const int i = threadIdx.x;
    if (units <= 0 || i >= rows_) return;
    const uint32_t bytes = 16u * units;
    asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(bar_)), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_u32(dst + i * dst_row)), "l"(src + i * src_row),
           "r"(bytes), "r"(smem_u32(bar_))
        : "memory");
  }

  // Wait until every load started since the last wait has landed.
  __device__ void wait() {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_u32(bar_)) : "memory");
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done) : "r"(smem_u32(bar_)), "r"(phase_) : "memory");
    }
    phase_ ^= 1;
  }

  // Copy row i of src (at src + i * src_row) to dst + i * dst_row. Every
  // thread has written its own row of src before the call; on return src
  // may be overwritten.
  __device__ void store(float4* dst, size_t dst_row, const float4* src,
                        int src_row, int units) {
    const int i = threadIdx.x;
    if (i >= rows_ || units <= 0) return;
    // make this thread's shared writes visible to the bulk copy, then
    // wait until the copy has read them
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group"
                 " [%0], [%1], %2;"
                 :: "l"(dst + i * dst_row), "r"(smem_u32(src + i * src_row)),
                    "r"(16u * units)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }

 private:
  uint64_t* bar_;
  int rows_;
  uint32_t phase_ = 0;
};

__global__ void __launch_bounds__(kRows)
    quad_rollout_fwd_kernel(const float* __restrict__ states,
                            const float* __restrict__ actions,
                            float* __restrict__ out, int B, int K,
                            QuadConsts c) {
  extern __shared__ float4 smem[];
  __shared__ uint64_t bar;
  float4* s_state = smem;
  float4* s_act = s_state + kRows * kStateRow;
  float4* s_out = s_act + kRows * kActRow;

  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - row0);
  const int r = threadIdx.x;
  // the block's rows in float4: a state is 3, a step's actions 1
  const float4* g_state =
      reinterpret_cast<const float4*>(states) + static_cast<size_t>(row0) * 3;
  const float4* g_act = reinterpret_cast<const float4*>(actions) +
                        static_cast<size_t>(row0) * K;
  float4* g_out =
      reinterpret_cast<float4*>(out) + static_cast<size_t>(row0) * 3 * K;
  Stager stage(&bar, rows);

  float pos[3], att[3], vel[3], av[3];
  for (int t0 = 0; t0 < K; t0 += kChunk) {
    const int n = min(kChunk, K - t0);
    if (t0 == 0) stage.load(s_state, kStateRow, g_state, 3, 3);
    stage.load(s_act, kActRow, g_act + t0, K, n);
    stage.wait();

    if (r < rows) {
      if (t0 == 0) {
        const float4* s = s_state + r * kStateRow;
        const float4 s0 = s[0], s1 = s[1], s2 = s[2];
        pos[0] = s0.x; pos[1] = s0.y; pos[2] = s0.z;
        att[0] = s0.w; att[1] = s1.x; att[2] = s1.y;
        vel[0] = s1.z; vel[1] = s1.w; vel[2] = s2.x;
        av[0] = s2.y;  av[1] = s2.z;  av[2] = s2.w;
      }
      for (int j = 0; j < n; ++j) {
        const float4 a = s_act[r * kActRow + j];
        const float body[3] = {a.y, a.z, a.w};
        const float thrust = a.x * 15.0f - 7.5f + 9.81f;
        float sr, cr, sp, cp, sy, cy;
        sincosf(att[0], &sr, &cr);
        sincosf(att[1], &sp, &cp);
        sincosf(att[2], &sy, &cy);
        const float rot[3] = {cy * sp * cr + sr * sy, cr * sy * sp - cy * sr,
                              cr * cp};
        const float rate[3] = {av[0] - sp * av[2],
                               cr * av[1] + cp * sr * av[2],
                               -sr * av[1] + cp * cr * av[2]};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float acc = rot[i] * thrust + c.gravity[i] + c.trans_drag[i];
          const float ang_acc = c.kinv[i] * ((body[i] - 0.5f) - av[i]) +
                                c.rot_drag_over_inertia[i];
          pos[i] = pos[i] + c.half_dt_sq * acc + c.half_dt * vel[i];
          vel[i] = vel[i] + c.dt * acc;
          att[i] = att[i] + c.dt * rate[i];
          av[i] = av[i] + c.dt * ang_acc;
        }
        float4* o = s_out + r * kSeqRow + 3 * j;
        o[0] = make_float4(pos[0], pos[1], pos[2], att[0]);
        o[1] = make_float4(att[1], att[2], vel[0], vel[1]);
        o[2] = make_float4(vel[2], av[0], av[1], av[2]);
      }
    }
    stage.store(g_out + 3 * t0, 3 * static_cast<size_t>(K), s_out, kSeqRow,
                3 * n);
    __syncthreads();  // every row is done with this chunk's tiles
  }
}

// Reverse sweep. g holds the adjoint of the state after step t; each step
// maps it to the adjoint of the state before step t and emits the action
// gradient. Position and velocity enter the step linearly, so only the
// attitude and body rates of the saved states are read.
__global__ void __launch_bounds__(kRows)
    quad_rollout_bwd_kernel(const float* __restrict__ states,
                            const float* __restrict__ actions,
                            const float* __restrict__ out,
                            const float* __restrict__ grad_out,
                            float* __restrict__ grad_actions,
                            float* __restrict__ grad_states, int B, int K,
                            QuadConsts c) {
  extern __shared__ float4 smem[];
  __shared__ uint64_t bar;
  float4* s_state = smem;  // the input states, then their gradient
  float4* s_act = s_state + kRows * kStateRow;
  float4* s_gact = s_act + kRows * kActRow;
  float4* s_prev = s_gact + kRows * kActRow;  // slot j: state before t0 + j
  float4* s_gout = s_prev + kRows * kSeqRow;

  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - row0);
  const int r = threadIdx.x;
  const size_t row_k = static_cast<size_t>(row0) * K;
  const float4* g_state =
      reinterpret_cast<const float4*>(states) + static_cast<size_t>(row0) * 3;
  const float4* g_act = reinterpret_cast<const float4*>(actions) + row_k;
  const float4* g_out = reinterpret_cast<const float4*>(out) + 3 * row_k;
  const float4* g_gout = reinterpret_cast<const float4*>(grad_out) + 3 * row_k;
  float4* g_gact = reinterpret_cast<float4*>(grad_actions) + row_k;
  float4* g_gstate =
      reinterpret_cast<float4*>(grad_states) + static_cast<size_t>(row0) * 3;
  const size_t seq_row = 3 * static_cast<size_t>(K);
  Stager stage(&bar, rows);

  float g[12];
  for (int t0 = (K - 1) / kChunk * kChunk; t0 >= 0; t0 -= kChunk) {
    const int n = min(kChunk, K - t0);
    // at t0 = 0 slot 0 stays empty: step 0 reads the input state
    const int skip = t0 == 0 ? 1 : 0;
    if (t0 == 0) stage.load(s_state, kStateRow, g_state, 3, 3);
    stage.load(s_act, kActRow, g_act + t0, K, n);
    stage.load(s_gout, kSeqRow, g_gout + 3 * t0, seq_row, 3 * n);
    stage.load(s_prev + 3 * skip, kSeqRow, g_out + 3 * (t0 - 1 + skip),
               seq_row, 3 * (n - skip));
    stage.wait();

    if (r < rows) {
      for (int j = n - 1; j >= 0; --j) {
        const int t = t0 + j;
        const float4* go = s_gout + r * kSeqRow + 3 * j;
        const float4 go0 = go[0], go1 = go[1], go2 = go[2];
        const float gin[12] = {go0.x, go0.y, go0.z, go0.w, go1.x, go1.y,
                               go1.z, go1.w, go2.x, go2.y, go2.z, go2.w};
        // the output gradient of step t joins g before step t: the same
        // additions, in the same order, as joining it after step t + 1
#pragma unroll
        for (int i = 0; i < 12; ++i) {
          g[i] = (t == K - 1) ? gin[i] : g[i] + gin[i];
        }

        const float4* s = (t == 0) ? s_state + r * kStateRow
                                   : s_prev + r * kSeqRow + 3 * j;
        const float4 s0 = s[0], s1 = s[1], s2 = s[2];
        const float q = s2.z, rr = s2.w;  // body rates q and r
        const float thrust = s_act[r * kActRow + j].x * 15.0f - 7.5f + 9.81f;
        float sr, cr, sp, cp, sy, cy;
        sincosf(s0.w, &sr, &cr);
        sincosf(s1.x, &sp, &cp);
        sincosf(s1.y, &sy, &cy);
        const float rot[3] = {cy * sp * cr + sr * sy, cr * sy * sp - cy * sr,
                              cr * cp};

        // acc enters pos' with 0.5*dt^2 and vel' with dt
        float gacc[3], u[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          gacc[i] = c.half_dt_sq * g[i] + c.dt * g[6 + i];
          u[i] = c.dt * g[3 + i];  // adjoint of the Euler rate
        }
        const float g_thrust = gacc[0] * rot[0] + gacc[1] * rot[1] +
                               gacc[2] * rot[2];
        const float grot[3] = {gacc[0] * thrust, gacc[1] * thrust,
                               gacc[2] * thrust};

        s_gact[r * kActRow + j] = make_float4(
            15.0f * g_thrust, g[9] * c.dt * c.kinv[0],
            g[10] * c.dt * c.kinv[1], g[11] * c.dt * c.kinv[2]);

        const float g_roll = g[3]
            + grot[0] * (cr * sy - cy * sp * sr)
            + grot[1] * (-sr * sy * sp - cy * cr)
            + grot[2] * (-sr * cp)
            + u[1] * (-sr * q + cp * cr * rr)
            + u[2] * (-cr * q - cp * sr * rr);
        const float g_pitch = g[4]
            + grot[0] * (cy * cp * cr)
            + grot[1] * (cr * sy * cp)
            + grot[2] * (-cr * sp)
            - u[0] * (cp * rr)
            - u[1] * (sp * sr * rr)
            - u[2] * (sp * cr * rr);
        const float g_yaw = g[5]
            + grot[0] * (sr * cy - sy * sp * cr)
            + grot[1] * (cr * cy * sp + sy * sr);
        const float g_p = g[9] * (1.0f - c.dt * c.kinv[0]) + u[0];
        const float g_q = g[10] * (1.0f - c.dt * c.kinv[1]) + u[1] * cr
            - u[2] * sr;
        const float g_r = g[11] * (1.0f - c.dt * c.kinv[2]) - u[0] * sp
            + u[1] * cp * sr + u[2] * cp * cr;

        // pos' = pos + ... + 0.5*dt*vel and vel' = vel + ...: g[0:3] passes
        // through unchanged
#pragma unroll
        for (int i = 0; i < 3; ++i) g[6 + i] += c.half_dt * g[i];
        g[3] = g_roll;
        g[4] = g_pitch;
        g[5] = g_yaw;
        g[9] = g_p;
        g[10] = g_q;
        g[11] = g_r;
      }
      if (t0 == 0) {
        float4* gs = s_state + r * kStateRow;
        gs[0] = make_float4(g[0], g[1], g[2], g[3]);
        gs[1] = make_float4(g[4], g[5], g[6], g[7]);
        gs[2] = make_float4(g[8], g[9], g[10], g[11]);
      }
    }
    stage.store(g_gact + t0, K, s_gact, kActRow, n);
    if (t0 == 0) stage.store(g_gstate, 3, s_state, kStateRow, 3);
    __syncthreads();  // every row is done with this chunk's tiles
  }
}

QuadConsts make_consts(float kinv0, float kinv1, float kinv2, float g0,
                       float g1, float g2, float d0, float d1, float d2,
                       float r0, float r1, float r2, double dt) {
  QuadConsts c;
  c.kinv[0] = kinv0;
  c.kinv[1] = kinv1;
  c.kinv[2] = kinv2;
  c.gravity[0] = g0;
  c.gravity[1] = g1;
  c.gravity[2] = g2;
  c.trans_drag[0] = d0;
  c.trans_drag[1] = d1;
  c.trans_drag[2] = d2;
  c.rot_drag_over_inertia[0] = r0;
  c.rot_drag_over_inertia[1] = r1;
  c.rot_drag_over_inertia[2] = r2;
  // rounded once from double, as the plain PyTorch step rounds its Python
  // float coefficients
  c.dt = static_cast<float>(dt);
  c.half_dt = static_cast<float>(0.5 * dt);
  c.half_dt_sq = static_cast<float>(0.5 * dt * dt);
  return c;
}

int blocks_for(int B) { return (B + kRows - 1) / kRows; }

}  // namespace

// C interface for ctypes. Pointers are device pointers, 16-byte aligned;
// the stream is a cudaStream_t. Each returns cudaGetLastError() after its
// launch.
extern "C" int quad_rollout_fwd(const float* states, const float* actions,
                                float* out, int B, int K, float kinv0,
                                float kinv1, float kinv2, float g0, float g1,
                                float g2, float d0, float d1, float d2,
                                float r0, float r1, float r2, double dt,
                                void* stream) {
  const QuadConsts c = make_consts(kinv0, kinv1, kinv2, g0, g1, g2, d0, d1,
                                   d2, r0, r1, r2, dt);
  quad_rollout_fwd_kernel<<<blocks_for(B), kRows, kFwdSmem,
                            static_cast<cudaStream_t>(stream)>>>(
      states, actions, out, B, K, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int quad_rollout_bwd(const float* states, const float* actions,
                                const float* out, const float* grad_out,
                                float* grad_actions, float* grad_states,
                                int B, int K, float kinv0, float kinv1,
                                float kinv2, float g0, float g1, float g2,
                                float d0, float d1, float d2, float r0,
                                float r1, float r2, double dt, void* stream) {
  const QuadConsts c = make_consts(kinv0, kinv1, kinv2, g0, g1, g2, d0, d1,
                                   d2, r0, r1, r2, dt);
  quad_rollout_bwd_kernel<<<blocks_for(B), kRows, kBwdSmem,
                            static_cast<cudaStream_t>(stream)>>>(
      states, actions, out, grad_out, grad_actions, grad_states, B, K, c);
  return static_cast<int>(cudaGetLastError());
}
