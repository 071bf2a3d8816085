// Fused k-step fixed-wing rollout on Hopper: forward and backward kernels.
//
// The JAX package has no kernel for the wing: it unrolls
// dynamics/fixed_wing.py::wing_step with lax and differentiates the unroll,
// so these kernels replace no Pallas kernel. They replace the port's
// step-by-step loop over dynamics/fixed_wing.py::wing_step in
// training/train_wing.py::wing_loss and the autograd backward it builds:
// about 215 elementwise kernels a step forward and 420 backward, some 6,000
// launches at k = 10, where the whole unroll is about 1 MFLOP at 8 rows.
// The step follows wing_step op for op:
//   T, del_e, del_a, del_r  from the action in [0, 1]
//   V = |vel|, alpha = clamp(atan(w/u)), beta = clamp(atan(v/V)), +-10 deg
//   six coefficients linear in alpha, beta, the rates and the surfaces
//   L, D, Y = qbarS * C; moments qbarS * c * C; qbarS = 0.5 rho V^2 S
//   f = wind-to-body(L, D, Y) + gravity + thrust tilted by epsilon
//   pos' = pos + dt R_ib vel
//   vel' = vel + dt (f / mass - omega x vel)
//   eul' = eul + dt E(phi, theta) omega     (tan and sec of theta)
//   omega' = omega + dt I^-1 (M - omega x I omega)
//
// What bounds it on this card. Per row the forward reads 12 + 4k floats and
// writes 12k, about 280 float operations a step; the backward reads
// 12 + 4k + 24k and writes 4k + 12, about 530 operations a step. At 8 rows
// that is a few kB and a few hundred kFLOP: nothing. The kernels are bound
// by latency, a chain of k dependent steps per row, each a few hundred
// dependent float operations with eight transcendental functions forward,
// so one thread owns one row and keeps it in registers for the whole
// unroll. At 4,096 rows there are 128 warps, about one per SM, and the
// chain is still the time.
//
// Design. One thread per row, 32 rows a block. The block first copies the
// packed params (ops/wing_rollout.py::pack_wing_params: the 30
// coefficients, the inertia and its inverse, mass, rho, S, c, b, g,
// epsilon) from device memory into shared memory once. Each thread then
// walks its row's k steps with the state in registers, loading the next
// step's inputs (16-byte units) before it computes the current one, so a
// global round trip overlaps a step's arithmetic. The backward is a
// hand-derived reverse sweep: for each step, from the last, it recomputes
// the step's intermediates from the saved state before it (the forward's
// output, or the input state at t = 0), maps the adjoint of the state after
// the step to the adjoint of the state before it and emits the action's
// gradient. The clamps pass the gradient where lo <= x <= hi, inclusive,
// as autograd's clamp does; NaN at u = 0 stays NaN. Every row offset is a
// multiple of 16 bytes; the wrapper refuses a data pointer that is not
// 16-byte aligned.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (no --use_fast_math: precise sqrtf, atanf,
//             sincosf and tanf, as the plain PyTorch step).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 32;

// the packed params, in ops/wing_rollout.py's order; the coefficients in
// dynamics/fixed_wing.py::_COEF_KEYS order
enum Param {
  kCL0, kCL_alpha, kCL_q, kCL_del_e,
  kCD0, kCD_alpha, kCD_q, kCD_del_e,
  kCY0, kCY_beta, kCY_p, kCY_r, kCY_del_a, kCY_del_r,
  kCl0, kCl_beta, kCl_p, kCl_r, kCl_del_a, kCl_del_r,
  kCm0, kCm_alpha, kCm_q, kCm_del_e,
  kCn0, kCn_beta, kCn_p, kCn_r, kCn_del_a, kCn_del_r,
  kInertia,                 // 9, row major
  kInertiaInv = kInertia + 9,  // 9, row major
  kMass = kInertiaInv + 9,
  kRho, kS, kChord, kSpan, kGravity, kEpsilon,
  kParams
};
static_assert(kParams == 55, "the packed params hold 55 floats");

constexpr double kPiD = 3.14159265358979323846;
constexpr float kPi = static_cast<float>(kPiD);
// the angle-of-attack and sideslip clamp, 10 degrees
constexpr float kBound = static_cast<float>(10.0 / 180.0 * kPiD);

// torch.clamp: NaN passes through (fminf / fmaxf would drop it)
__device__ __forceinline__ float clamp_angle(float x) {
  return x < -kBound ? -kBound : (x > kBound ? kBound : x);
}

// autograd's clamp gradient: where lo <= x <= hi
__device__ __forceinline__ bool in_bound(float x) {
  return x >= -kBound && x <= kBound;
}

// the packed params from device memory into the block's shared memory
__device__ __forceinline__ void load_params(const float* __restrict__ src,
                                            float* dst) {
  for (int i = threadIdx.x; i < kParams; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

// The normalised action (T, del_e, del_a, del_r), as normalize_wing_action.
struct Action {
  float T, de, da, dr;
};

__device__ __forceinline__ Action normalize(float4 a) {
  Action n;
  n.T = a.x * 7.0f;
  n.de = kPi * (a.y * 40.0f - 20.0f) / 180.0f;
  n.da = kPi * (a.z * 5.0f - 2.5f) / 180.0f;
  n.dr = kPi * (a.w * 40.0f - 20.0f) / 180.0f;
  return n;
}

// What a step computes from its state and action before the rates: the
// forward uses it to step, the backward recomputes it for the adjoint.
struct Aero {
  float V, z_a, z_b, at_a, at_b;  // airspeed, w/u, v/V and their atans
  float hc, hb;                   // c / 2V and b / 2V
  float CL, CD, CY, Cl, Cm, Cn;
  float Q;                        // qbarS
  float sa, ca, sb, cb;           // of alpha and beta (clamped)
};

__device__ __forceinline__ Aero aero(const float* P, const float s[12],
                                     const Action& n) {
  Aero x;
  const float u = s[3], v = s[4], w = s[5];
  const float p = s[9], q = s[10], r = s[11];
  x.V = sqrtf(u * u + v * v + w * w);
  x.z_a = w / u;
  x.z_b = v / x.V;
  x.at_a = atanf(x.z_a);
  x.at_b = atanf(x.z_b);
  const float alpha = clamp_angle(x.at_a);
  const float beta = clamp_angle(x.at_b);
  x.hc = P[kChord] / (2.0f * x.V);
  x.hb = P[kSpan] / (2.0f * x.V);
  x.CL = P[kCL0] + P[kCL_alpha] * alpha + P[kCL_q] * x.hc * q +
         P[kCL_del_e] * n.de;
  x.CD = P[kCD0] + P[kCD_alpha] * alpha + P[kCD_q] * x.hc * q +
         P[kCD_del_e] * n.de;
  x.CY = P[kCY0] + P[kCY_beta] * beta + P[kCY_p] * x.hb * p +
         P[kCY_r] * x.hb * r + P[kCY_del_a] * n.da + P[kCY_del_r] * n.dr;
  x.Cl = P[kCl0] + P[kCl_beta] * beta + P[kCl_p] * x.hb * p +
         P[kCl_r] * x.hb * r + P[kCl_del_a] * n.da + P[kCl_del_r] * n.dr;
  x.Cm = P[kCm0] + P[kCm_alpha] * alpha + P[kCm_q] * x.hc * q +
         P[kCm_del_e] * n.de;
  x.Cn = P[kCn0] + P[kCn_beta] * beta + P[kCn_p] * x.hb * p +
         P[kCn_r] * x.hb * r + P[kCn_del_a] * n.da + P[kCn_del_r] * n.dr;
  x.Q = 0.5f * P[kRho] * (x.V * x.V) * P[kS];
  sincosf(alpha, &x.sa, &x.ca);
  sincosf(beta, &x.sb, &x.cb);
  return x;
}

// One Euler step of wing_step, in place.
__device__ __forceinline__ void step_forward(const float* P, float s[12],
                                             float4 action, float dt,
                                             float cos_eps, float sin_eps) {
  const Action n = normalize(action);
  const Aero x = aero(P, s, n);
  const float u = s[3], v = s[4], w = s[5];
  const float p = s[9], q = s[10], r = s[11];
  const float L = x.Q * x.CL, D = x.Q * x.CD, Y = x.Q * x.CY;
  const float Qc = x.Q * P[kChord];
  const float moment[3] = {Qc * x.Cl, Qc * x.Cm, Qc * x.Cn};

  const float f_aero_x = x.ca * x.cb * (-D) + (-x.ca) * x.sb * Y - x.sa * (-L);
  const float f_aero_y = x.sb * (-D) + x.cb * Y;
  const float f_aero_z = x.sa * x.cb * (-D) - x.sa * x.sb * Y + x.ca * (-L);

  const float g_m = P[kGravity] * P[kMass];
  float sph, cph, sth, cth, sps, cps;
  sincosf(s[6], &sph, &cph);
  sincosf(s[7], &sth, &cth);
  sincosf(s[8], &sps, &cps);
  const float f[3] = {f_aero_x + (-g_m * sth) + n.T * cos_eps,
                      f_aero_y + sph * cth * g_m,
                      f_aero_z + cph * cth * g_m + n.T * sin_eps};

  float ds[12];
  // position kinematics: R_ib @ vel
  ds[0] = u * (cth * cps) + v * (-cph * sps + sph * sth * cps) +
          w * (sph * sps + cph * sth * cps);
  ds[1] = u * (cth * sps) + v * (cph * cps + sph * sth * sps) +
          w * (-sph * cps + cph * sth * sps);
  ds[2] = -u * sth + v * sph * cth + w * cph * cth;
  // body-frame accelerations: f / mass - omega x vel
  ds[3] = f[0] / P[kMass] - (q * w - r * v);
  ds[4] = f[1] / P[kMass] - (r * u - p * w);
  ds[5] = f[2] / P[kMass] - (p * v - q * u);
  // Euler-angle rates through tan and sec of theta
  const float tth = tanf(s[7]);
  ds[6] = p + sph * tth * q + cph * tth * r;
  ds[7] = cph * q - sph * r;
  ds[8] = sph / cth * q + cph / cth * r;
  // angular accelerations: I^-1 (M - omega x I omega)
  const float* I = P + kInertia;
  const float* Iinv = P + kInertiaInv;
  const float h[3] = {I[0] * p + I[1] * q + I[2] * r,
                      I[3] * p + I[4] * q + I[5] * r,
                      I[6] * p + I[7] * q + I[8] * r};
  const float torque[3] = {moment[0] - (q * h[2] - r * h[1]),
                           moment[1] - (r * h[0] - p * h[2]),
                           moment[2] - (p * h[1] - q * h[0])};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    ds[9 + i] = Iinv[3 * i] * torque[0] + Iinv[3 * i + 1] * torque[1] +
                Iinv[3 * i + 2] * torque[2];
  }
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = s[i] + dt * ds[i];
}

// The adjoint of one step from the state s before it: g holds the adjoint
// of the state after the step and becomes the adjoint of s; ga receives
// the action's gradient. The math of ops/wing_rollout.py::_step_vjp.
__device__ __forceinline__ void step_backward(const float* P,
                                              const float s[12],
                                              float4 action, float g[12],
                                              float ga[4], float dt,
                                              float cos_eps, float sin_eps) {
  const Action n = normalize(action);
  const Aero x = aero(P, s, n);
  const float u = s[3], v = s[4], w = s[5];
  const float p = s[9], q = s[10], r = s[11];
  const float L = x.Q * x.CL, D = x.Q * x.CD, Y = x.Q * x.CY;
  float sph, cph, sth, cth, sps, cps;
  sincosf(s[6], &sph, &cph);
  sincosf(s[7], &sth, &cth);
  sincosf(s[8], &sps, &cps);
  const float tth = tanf(s[7]);
  const float R[3][3] = {
      {cth * cps, -cph * sps + sph * sth * cps, sph * sps + cph * sth * cps},
      {cth * sps, cph * cps + sph * sth * sps, -sph * cps + cph * sth * sps},
      {-sth, sph * cth, cph * cth}};
  const float pos_dot[3] = {u * R[0][0] + v * R[0][1] + w * R[0][2],
                            u * R[1][0] + v * R[1][1] + w * R[1][2],
                            u * R[2][0] + v * R[2][1] + w * R[2][2]};

  // the adjoint of the state's rate
  float G[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) G[i] = dt * g[i];

  // omega_dot = I^-1 torque, torque = M - omega x h, h = I omega
  const float* I = P + kInertia;
  const float* Iinv = P + kInertiaInv;
  float Gt[3], h[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    Gt[j] = G[9] * Iinv[j] + G[10] * Iinv[3 + j] + G[11] * Iinv[6 + j];
    h[j] = I[3 * j] * p + I[3 * j + 1] * q + I[3 * j + 2] * r;
  }
  // omega x Gt, then through I
  const float oGt[3] = {q * Gt[2] - r * Gt[1], r * Gt[0] - p * Gt[2],
                        p * Gt[1] - q * Gt[0]};
  float g_omega[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g_omega[j] = oGt[0] * I[j] + oGt[1] * I[3 + j] + oGt[2] * I[6 + j];
  }
  // Gt x h
  g_omega[0] += Gt[1] * h[2] - Gt[2] * h[1];
  g_omega[1] += Gt[2] * h[0] - Gt[0] * h[2];
  g_omega[2] += Gt[0] * h[1] - Gt[1] * h[0];
  // uvw_dot = f / mass - omega x vel
  const float Gv[3] = {G[3], G[4], G[5]};
  const float Gfx = Gv[0] / P[kMass], Gfy = Gv[1] / P[kMass],
              Gfz = Gv[2] / P[kMass];
  g_omega[0] += Gv[1] * w - Gv[2] * v;
  g_omega[1] += Gv[2] * u - Gv[0] * w;
  g_omega[2] += Gv[0] * v - Gv[1] * u;
  float g_vel[3] = {q * Gv[2] - r * Gv[1], r * Gv[0] - p * Gv[2],
                    p * Gv[1] - q * Gv[0]};
  // Euler rates
  const float Gphi_d = G[6], Gth_d = G[7], Gpsi_d = G[8];
  const float A1 = sph * q + cph * r;
  const float A2 = cph * q - sph * r;
  float g_p = Gphi_d;
  float g_q = Gphi_d * sph * tth + Gth_d * cph + Gpsi_d * sph / cth;
  float g_r = Gphi_d * cph * tth - Gth_d * sph + Gpsi_d * cph / cth;
  float g_phi = Gphi_d * tth * A2 - Gth_d * A1 + Gpsi_d * A2 / cth;
  float g_theta =
      (Gphi_d * (1.0f + tth * tth) + Gpsi_d * sth / (cth * cth)) * A1;
  // position kinematics
  const float Gpx = G[0], Gpy = G[1], Gpz = G[2];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g_vel[j] += Gpx * R[0][j] + Gpy * R[1][j] + Gpz * R[2][j];
  }
  g_phi += Gpx * (v * R[0][2] - w * R[0][1]) +
           Gpy * (v * R[1][2] - w * R[1][1]) +
           Gpz * (v * R[2][2] - w * R[2][1]);
  g_theta += (Gpx * cps + Gpy * sps) * pos_dot[2] -
             Gpz * (u * cth + (v * sph + w * cph) * sth);
  const float g_psi = Gpy * pos_dot[0] - Gpx * pos_dot[1];
  // gravity and thrust
  const float g_m = P[kGravity] * P[kMass];
  g_phi += (Gfy * cph - Gfz * sph) * cth * g_m;
  g_theta -= (Gfx * cth + (Gfy * sph + Gfz * cph) * sth) * g_m;
  const float g_T = Gfx * cos_eps + Gfz * sin_eps;
  // the wind-to-body rotation of L, D and Y
  const float g_D = -(Gfx * x.ca * x.cb + Gfy * x.sb + Gfz * x.sa * x.cb);
  const float g_Y = -Gfx * x.ca * x.sb + Gfy * x.cb - Gfz * x.sa * x.sb;
  const float g_L = Gfx * x.sa - Gfz * x.ca;
  const float DY = x.cb * D + x.sb * Y;
  float g_alpha = Gfx * (x.sa * DY + x.ca * L) + Gfz * (x.sa * L - x.ca * DY);
  float g_beta = (Gfx * x.ca + Gfz * x.sa) * (x.sb * D - x.cb * Y) -
                 Gfy * (x.cb * D + x.sb * Y);
  // the coefficients through qbarS; the moments are Q * c * C
  const float Qc = x.Q * P[kChord];
  const float g_CL = g_L * x.Q, g_CD = g_D * x.Q, g_CY = g_Y * x.Q;
  const float g_Cl = Gt[0] * Qc, g_Cm = Gt[1] * Qc, g_Cn = Gt[2] * Qc;
  const float g_Q = g_L * x.CL + g_D * x.CD + g_Y * x.CY +
                    P[kChord] * (Gt[0] * x.Cl + Gt[1] * x.Cm + Gt[2] * x.Cn);
  float g_V = g_Q * P[kRho] * x.V * P[kS];
  g_alpha += g_CL * P[kCL_alpha] + g_CD * P[kCD_alpha] + g_Cm * P[kCm_alpha];
  g_beta += g_CY * P[kCY_beta] + g_Cl * P[kCl_beta] + g_Cn * P[kCn_beta];
  const float k_q = g_CL * P[kCL_q] + g_CD * P[kCD_q] + g_Cm * P[kCm_q];
  const float k_p = g_CY * P[kCY_p] + g_Cl * P[kCl_p] + g_Cn * P[kCn_p];
  const float k_r = g_CY * P[kCY_r] + g_Cl * P[kCl_r] + g_Cn * P[kCn_r];
  g_q += x.hc * k_q;
  g_p += x.hb * k_p;
  g_r += x.hb * k_r;
  g_V -= (x.hc * k_q * q + x.hb * (k_p * p + k_r * r)) / x.V;
  const float g_de =
      g_CL * P[kCL_del_e] + g_CD * P[kCD_del_e] + g_Cm * P[kCm_del_e];
  const float g_da =
      g_CY * P[kCY_del_a] + g_Cl * P[kCl_del_a] + g_Cn * P[kCn_del_a];
  const float g_dr =
      g_CY * P[kCY_del_r] + g_Cl * P[kCl_del_r] + g_Cn * P[kCn_del_r];
  // the clamps, then atan(w / u) and atan(v / V)
  const float g_za =
      (in_bound(x.at_a) ? g_alpha : 0.0f) / (1.0f + x.z_a * x.z_a);
  const float g_zb =
      (in_bound(x.at_b) ? g_beta : 0.0f) / (1.0f + x.z_b * x.z_b);
  g_V -= g_zb * x.z_b / x.V;
  g_vel[0] += g_V * u / x.V - g_za * x.z_a / u;
  g_vel[1] += g_V * v / x.V + g_zb / x.V;
  g_vel[2] += g_V * w / x.V + g_za / u;

  constexpr float kDeg = static_cast<float>(kPiD / 180.0);
  ga[0] = 7.0f * g_T;
  ga[1] = 40.0f * kDeg * g_de;
  ga[2] = 5.0f * kDeg * g_da;
  ga[3] = 40.0f * kDeg * g_dr;

  // the position's adjoint passes through unchanged
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g[3 + i] += g_vel[i];
    g[9 + i] += g_omega[i];
  }
  g[6] += g_phi;
  g[7] += g_theta;
  g[8] += g_psi;
  g[9] += g_p;
  g[10] += g_q;
  g[11] += g_r;
}

__device__ __forceinline__ void unpack(const float4* src, float s[12]) {
  const float4 a = src[0], b = src[1], c = src[2];
  s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
  s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
  s[8] = c.x; s[9] = c.y; s[10] = c.z; s[11] = c.w;
}

__device__ __forceinline__ void pack(const float s[12], float4* dst) {
  dst[0] = make_float4(s[0], s[1], s[2], s[3]);
  dst[1] = make_float4(s[4], s[5], s[6], s[7]);
  dst[2] = make_float4(s[8], s[9], s[10], s[11]);
}

__global__ void __launch_bounds__(kThreads)
    wing_rollout_fwd_kernel(const float* __restrict__ states,
                            const float* __restrict__ actions,
                            const float* __restrict__ params,
                            float* __restrict__ out, int B, int K,
                            float dt) {
  __shared__ float P[kParams];
  load_params(params, P);
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= B) return;
  float cos_eps, sin_eps;
  sincosf(P[kEpsilon], &sin_eps, &cos_eps);

  const float4* act =
      reinterpret_cast<const float4*>(actions) + static_cast<size_t>(row) * K;
  float4* o = reinterpret_cast<float4*>(out) + static_cast<size_t>(row) * 3 * K;
  float s[12];
  unpack(reinterpret_cast<const float4*>(states) + static_cast<size_t>(row) * 3,
         s);
  float4 a = act[0];
  for (int t = 0; t < K; ++t) {
    // the next step's action is read while this step computes
    const float4 a_next = act[min(t + 1, K - 1)];
    step_forward(P, s, a, dt, cos_eps, sin_eps);
    pack(s, o + 3 * t);
    a = a_next;
  }
}

// Reverse sweep. g holds the adjoint of the state after step t; the output
// gradient of step t joins it before step t's adjoint is taken.
__global__ void __launch_bounds__(kThreads)
    wing_rollout_bwd_kernel(const float* __restrict__ states,
                            const float* __restrict__ actions,
                            const float* __restrict__ params,
                            const float* __restrict__ out,
                            const float* __restrict__ grad_out,
                            float* __restrict__ grad_actions,
                            float* __restrict__ grad_states, int B, int K,
                            float dt) {
  __shared__ float P[kParams];
  load_params(params, P);
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= B) return;
  float cos_eps, sin_eps;
  sincosf(P[kEpsilon], &sin_eps, &cos_eps);

  const size_t row_k = static_cast<size_t>(row) * K;
  const float4* s0 =
      reinterpret_cast<const float4*>(states) + static_cast<size_t>(row) * 3;
  const float4* act = reinterpret_cast<const float4*>(actions) + row_k;
  const float4* so = reinterpret_cast<const float4*>(out) + 3 * row_k;
  const float4* go = reinterpret_cast<const float4*>(grad_out) + 3 * row_k;
  float4* gact = reinterpret_cast<float4*>(grad_actions) + row_k;

  // step t reads the state before it: out[t - 1], or the input at t = 0
  auto before = [&](int t) { return t == 0 ? s0 : so + 3 * (t - 1); };
  float g[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) g[i] = 0.0f;
  float s[12], gin[12];
  unpack(before(K - 1), s);
  unpack(go + 3 * (K - 1), gin);
  float4 a = act[K - 1];
  for (int t = K - 1; t >= 0; --t) {
    // the previous step's inputs are read while this step computes
    const int tn = t > 0 ? t - 1 : 0;
    float s_next[12], gin_next[12];
    unpack(before(tn), s_next);
    unpack(go + 3 * tn, gin_next);
    const float4 a_next = act[tn];
#pragma unroll
    for (int i = 0; i < 12; ++i) g[i] += gin[i];
    float ga[4];
    step_backward(P, s, a, g, ga, dt, cos_eps, sin_eps);
    gact[t] = make_float4(ga[0], ga[1], ga[2], ga[3]);
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      s[i] = s_next[i];
      gin[i] = gin_next[i];
    }
    a = a_next;
  }
  pack(g, reinterpret_cast<float4*>(grad_states) +
              static_cast<size_t>(row) * 3);
}

int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }

}  // namespace

// C interface for ctypes. Pointers are device pointers, 16-byte aligned;
// params is the packed (55,) float32 tensor; the stream is a cudaStream_t.
// dt is rounded to float once, as the plain PyTorch step rounds its Python
// float. Each returns cudaGetLastError() after its launch (0 for B = 0,
// which launches nothing).
extern "C" int wing_rollout_fwd(const float* states, const float* actions,
                                const float* params, float* out, int B, int K,
                                double dt, void* stream) {
  if (B <= 0) return 0;
  wing_rollout_fwd_kernel<<<blocks_for(B), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      states, actions, params, out, B, K, static_cast<float>(dt));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wing_rollout_bwd(const float* states, const float* actions,
                                const float* params, const float* out,
                                const float* grad_out, float* grad_actions,
                                float* grad_states, int B, int K, double dt,
                                void* stream) {
  if (B <= 0) return 0;
  wing_rollout_bwd_kernel<<<blocks_for(B), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      states, actions, params, out, grad_out, grad_actions, grad_states, B,
      K, static_cast<float>(dt));
  return static_cast<int>(cudaGetLastError());
}
