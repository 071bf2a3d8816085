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
// Design: one thread per batch row. The row's 12 state values stay in
// registers for all k steps; the ragged tail of the last block is masked.
// The parameters arrive as scalar kernel arguments, so modified params need
// no rebuild.
//
// What bounds it on this card: memory traffic, not arithmetic. Per row the
// forward reads 12 + 4k floats and writes 12k; the backward reads the input
// state, the actions, all k saved states and the k output gradients
// (12 + 4k + 24k floats) and writes 4k + 12. At B = 4096, k = 10 that is
// 2.8 MB and 5.6 MB, under 2 us at 3.35 TB/s, and a few hundred FLOPs per
// row-step. At the trainer's batch of 8 only launch latency counts.
// Neighbouring threads read rows 48 bytes apart, so loads are not
// coalesced; staging rows through shared memory is later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (no --use_fast_math: precise sincosf, since
//             angles grow along an unroll).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

struct QuadConsts {
  float kinv[3];
  float gravity[3];
  float trans_drag[3];
  float rot_drag_over_inertia[3];
  float dt;
  float half_dt;     // 0.5 * dt
  float half_dt_sq;  // 0.5 * dt * dt
};

__global__ void quad_rollout_fwd_kernel(const float* __restrict__ states,
                                        const float* __restrict__ actions,
                                        float* __restrict__ out, int B, int K,
                                        QuadConsts c) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const float* s0 = states + static_cast<size_t>(row) * 12;
  const float* act = actions + static_cast<size_t>(row) * K * 4;
  float* o = out + static_cast<size_t>(row) * K * 12;

  float pos[3], att[3], vel[3], av[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pos[i] = s0[i];
    att[i] = s0[3 + i];
    vel[i] = s0[6 + i];
    av[i] = s0[9 + i];
  }

  for (int t = 0; t < K; ++t) {
    const float* a = act + 4 * t;
    const float thrust = a[0] * 15.0f - 7.5f + 9.81f;
    float sr, cr, sp, cp, sy, cy;
    sincosf(att[0], &sr, &cr);
    sincosf(att[1], &sp, &cp);
    sincosf(att[2], &sy, &cy);
    const float rot[3] = {cy * sp * cr + sr * sy, cr * sy * sp - cy * sr,
                          cr * cp};
    const float rate[3] = {av[0] - sp * av[2], cr * av[1] + cp * sr * av[2],
                           -sr * av[1] + cp * cr * av[2]};
    float* ot = o + 12 * t;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float acc = rot[i] * thrust + c.gravity[i] + c.trans_drag[i];
      const float ang_acc = c.kinv[i] * ((a[1 + i] - 0.5f) - av[i]) +
                            c.rot_drag_over_inertia[i];
      pos[i] = pos[i] + c.half_dt_sq * acc + c.half_dt * vel[i];
      vel[i] = vel[i] + c.dt * acc;
      att[i] = att[i] + c.dt * rate[i];
      av[i] = av[i] + c.dt * ang_acc;
      ot[i] = pos[i];
      ot[3 + i] = att[i];
      ot[6 + i] = vel[i];
      ot[9 + i] = av[i];
    }
  }
}

// Reverse sweep. g holds the adjoint of the state after step t; each step
// maps it to the adjoint of the state before step t and emits the action
// gradient. Position and velocity enter the step linearly, so only the
// attitude and body rates of the saved states are read.
__global__ void quad_rollout_bwd_kernel(const float* __restrict__ states,
                                        const float* __restrict__ actions,
                                        const float* __restrict__ out,
                                        const float* __restrict__ grad_out,
                                        float* __restrict__ grad_actions,
                                        float* __restrict__ grad_states,
                                        int B, int K, QuadConsts c) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const size_t rk = static_cast<size_t>(row) * K;
  const float* s0 = states + static_cast<size_t>(row) * 12;
  const float* act = actions + rk * 4;
  const float* o = out + rk * 12;
  const float* go = grad_out + rk * 12;
  float* ga = grad_actions + rk * 4;

  float g[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) g[i] = go[12 * (K - 1) + i];

  for (int t = K - 1; t >= 0; --t) {
    const float* s = (t == 0) ? s0 : o + 12 * (t - 1);
    const float* a = act + 4 * t;
    const float q = s[10], r = s[11];
    const float thrust = a[0] * 15.0f - 7.5f + 9.81f;
    float sr, cr, sp, cp, sy, cy;
    sincosf(s[3], &sr, &cr);
    sincosf(s[4], &sp, &cp);
    sincosf(s[5], &sy, &cy);
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

    float* gat = ga + 4 * t;
    gat[0] = 15.0f * g_thrust;
#pragma unroll
    for (int i = 0; i < 3; ++i) gat[1 + i] = g[9 + i] * c.dt * c.kinv[i];

    const float g_roll = g[3]
        + grot[0] * (cr * sy - cy * sp * sr)
        + grot[1] * (-sr * sy * sp - cy * cr)
        + grot[2] * (-sr * cp)
        + u[1] * (-sr * q + cp * cr * r)
        + u[2] * (-cr * q - cp * sr * r);
    const float g_pitch = g[4]
        + grot[0] * (cy * cp * cr)
        + grot[1] * (cr * sy * cp)
        + grot[2] * (-cr * sp)
        - u[0] * (cp * r)
        - u[1] * (sp * sr * r)
        - u[2] * (sp * cr * r);
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
    if (t > 0) {
#pragma unroll
      for (int i = 0; i < 12; ++i) g[i] += go[12 * (t - 1) + i];
    }
  }
  float* gs = grad_states + static_cast<size_t>(row) * 12;
#pragma unroll
  for (int i = 0; i < 12; ++i) gs[i] = g[i];
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

}  // namespace

// C interface for ctypes. Pointers are device pointers; the stream is a
// cudaStream_t. Each returns cudaGetLastError() after its launch.
extern "C" int quad_rollout_fwd(const float* states, const float* actions,
                                float* out, int B, int K, float kinv0,
                                float kinv1, float kinv2, float g0, float g1,
                                float g2, float d0, float d1, float d2,
                                float r0, float r1, float r2, double dt,
                                void* stream) {
  const QuadConsts c = make_consts(kinv0, kinv1, kinv2, g0, g1, g2, d0, d1,
                                   d2, r0, r1, r2, dt);
  const int blocks = (B + kThreads - 1) / kThreads;
  quad_rollout_fwd_kernel<<<blocks, kThreads, 0,
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
  const int blocks = (B + kThreads - 1) / kThreads;
  quad_rollout_bwd_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      states, actions, out, grad_out, grad_actions, grad_states, B, K, c);
  return static_cast<int>(cudaGetLastError());
}
