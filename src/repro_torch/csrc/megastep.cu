// Megastep: K fused environment steps per launch, for sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/envstep/megastep.py::megastep_pallas (body
// _megastep_kernel, step order fused_transition; env bodies from
// src/repro/kernels/envstep/specs.py::_cartpole_rows, _mountain_car_rows,
// _pendulum_rows, _acrobot_rows, _pong_rows, _breakout_rows).
//
// Each step: the env body advances the state, the TimeLimit counter row
// counts and cuts, and AutoReset selects the precomputed fresh state and
// observation where the episode ended. Layout is row-major with the batch
// on the minor axis: state (S', B), act (K, B), fresh (K, S', B),
// fresh_obs (K, O, B); outputs new_state (S', B), obs and terminal_obs
// (K, O, B), reward, done and truncated (K, B), all float32. S' = S + 1
// when max_steps >= 0 (the step counter row), S otherwise.
//
// Bound: bytes moved. Every lane is an independent recurrence of a few
// dozen flops per step, so the kernel must stream each input once and write
// each output once: with TimeLimit, CartPole moves 84 B per lane-step
// (act 4, fresh 20, fresh_obs 16 read; obs 16, terminal_obs 16, reward,
// done, truncated 12 written) plus 40 B of state per lane per launch.
// Design: one thread per lane, 128 threads a block, ceil(B/128) blocks; the
// S' state values stay in registers across the K loop, and neighbouring
// threads touch neighbouring addresses on every load and store, so every
// access is coalesced. No padding: lanes >= B return at once. The body is a
// template parameter, so each env compiles to straight-line code. A body
// whose observation is its new state (kObsIsState: Pong, Breakout) writes
// no separate observation array; the kernel stores the new state rows as
// the observation.
//
// Numbers: the kernel must give the bits of the plain PyTorch version
// (kernels/envstep/ref.py) on the card, op by op. So every constant is
// computed in double, as the Python modules compute it, and rounded to float
// once; x**2 is x*x; floor-mod is fmodf plus the sign fix-up of
// torch.remainder and jnp.mod; sinf/cosf are the accurate ones (no fast
// math); every product is mul() (__fmul_rn), which nvcc never fuses with an
// add, because PyTorch rounds each op of the plain version apart; and every
// division is an IEEE division (the plain version divides by constants held
// in 0-dim tensors for that reason: see envs/classic/cartpole.py::_div).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr double kPi = 3.14159265358979323846;

// A product rounded on its own: never contracted into a fused multiply-add.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  // std::min(std::max(v, lo), hi), as torch.clamp computes it
  v = v < lo ? lo : v;
  return hi < v ? hi : v;
}

__device__ __forceinline__ float floor_mod(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r += b;
  return r;
}

// -- CartPole (envs/classic/cartpole.py) --------------------------------------
namespace cartpole {
constexpr double kMassPole = 0.1, kTotalMass = 1.0 + 0.1, kLength = 0.5;
constexpr float kGravity = (float)9.8;
constexpr float kMassPoleF = (float)kMassPole;
constexpr float kTotalMassF = (float)kTotalMass;
constexpr float kLengthF = (float)kLength;
constexpr float kPolemassLength = (float)(kMassPole * kLength);
constexpr float kForceMag = (float)10.0;
constexpr float kTau = (float)0.02;
constexpr float kFourThirds = (float)(4.0 / 3.0);
constexpr float kThetaThreshold = (float)(12 * 2 * kPi / 360);
constexpr float kXThreshold = (float)2.4;
}  // namespace cartpole

struct CartPole {
  static constexpr bool kObsIsState = false;
  static constexpr int S = 4, O = 4;
  __device__ static void step(const float* s, float a, float* ns, float* ob,
                              float& reward, float& done) {
    using namespace cartpole;
    const float x = s[0], x_dot = s[1], theta = s[2], theta_dot = s[3];
    const float force = a == 1.0f ? kForceMag : -kForceMag;
    const float costheta = cosf(theta), sintheta = sinf(theta);
    const float temp =
        (force + mul(mul(kPolemassLength, mul(theta_dot, theta_dot)), sintheta)) /
        kTotalMassF;
    const float thetaacc =
        (mul(kGravity, sintheta) - mul(costheta, temp)) /
        mul(kLengthF,
            kFourThirds - mul(kMassPoleF, mul(costheta, costheta)) /
                              kTotalMassF);
    const float xacc =
        temp - mul(mul(kPolemassLength, thetaacc), costheta) / kTotalMassF;
    ns[0] = x + mul(kTau, x_dot);
    ns[1] = x_dot + mul(kTau, xacc);
    ns[2] = theta + mul(kTau, theta_dot);
    ns[3] = theta_dot + mul(kTau, thetaacc);
    for (int i = 0; i < 4; ++i) ob[i] = ns[i];
    reward = 1.0f;
    done = (fabsf(ns[0]) > kXThreshold) || (fabsf(ns[2]) > kThetaThreshold)
               ? 1.0f : 0.0f;
  }
};

// -- MountainCar (envs/classic/mountain_car.py) -------------------------------
namespace mountain_car {
constexpr float kMinPos = (float)-1.2, kMaxPos = (float)0.6;
constexpr float kMaxSpeed = (float)0.07;
constexpr float kGoalPos = (float)0.5, kGoalVel = (float)0.0;
constexpr float kForce = (float)0.001, kNegGravity = (float)-0.0025;
}  // namespace mountain_car

struct MountainCar {
  static constexpr bool kObsIsState = false;
  static constexpr int S = 2, O = 2;
  __device__ static void step(const float* s, float a, float* ns, float* ob,
                              float& reward, float& done) {
    using namespace mountain_car;
    const float pos = s[0], vel = s[1];
    float nv = vel + mul(a - 1.0f, kForce) + mul(cosf(mul(3.0f, pos)), kNegGravity);
    nv = clampf(nv, -kMaxSpeed, kMaxSpeed);
    const float npos = clampf(pos + nv, kMinPos, kMaxPos);
    if (npos <= kMinPos && nv < 0.0f) nv = 0.0f;
    ns[0] = ob[0] = npos;
    ns[1] = ob[1] = nv;
    reward = -1.0f;
    done = (npos >= kGoalPos && nv >= kGoalVel) ? 1.0f : 0.0f;
  }
};

// -- Pendulum (envs/classic/pendulum.py) --------------------------------------
namespace pendulum {
constexpr double kG = 10.0, kM = 1.0, kL = 1.0;
constexpr float kMaxSpeed = (float)8.0, kMaxTorque = (float)2.0;
constexpr float kDt = (float)0.05;
constexpr float kPiF = (float)kPi, kTwoPiF = (float)(2 * kPi);
constexpr float kGravityTerm = (float)(3 * kG / (2 * kL));
constexpr float kTorqueTerm = (float)(3.0 / (kM * kL * kL));
constexpr float kThdotCost = (float)0.1, kTorqueCost = (float)0.001;
}  // namespace pendulum

struct Pendulum {
  static constexpr bool kObsIsState = false;
  static constexpr int S = 2, O = 3;
  __device__ static void step(const float* s, float a, float* ns, float* ob,
                              float& reward, float& done) {
    using namespace pendulum;
    const float th = s[0], thdot = s[1];
    const float u = clampf(a, -kMaxTorque, kMaxTorque);
    const float an = floor_mod(th + kPiF, kTwoPiF) - kPiF;
    const float costs = mul(an, an) + mul(kThdotCost, mul(thdot, thdot)) +
                        mul(kTorqueCost, mul(u, u));
    float nthdot =
        thdot + mul(mul(kGravityTerm, sinf(th)) + mul(kTorqueTerm, u), kDt);
    nthdot = clampf(nthdot, -kMaxSpeed, kMaxSpeed);
    const float nth = th + mul(nthdot, kDt);
    ns[0] = nth;
    ns[1] = nthdot;
    ob[0] = cosf(nth);
    ob[1] = sinf(nth);
    ob[2] = nthdot;
    reward = -costs;
    done = 0.0f;
  }
};

// -- Acrobot (envs/classic/acrobot.py) ----------------------------------------
namespace acrobot {
constexpr double kL1 = 1.0, kM1 = 1.0, kM2 = 1.0, kLC1 = 0.5, kLC2 = 0.5;
constexpr double kI1 = 1.0, kI2 = 1.0, kG = 9.8, kDtD = 0.2;
// d1 = M1*LC1**2 + M2*(L1**2 + LC2**2 + 2*L1*LC2*cos(t2)) + I1 + I2, with
// M2 = 1 and 2*L1*LC2 = 1 (multiplications by one are exact)
constexpr float kD1a = (float)(kM1 * kLC1 * kLC1);
constexpr float kD1b = (float)(kL1 * kL1 + kLC2 * kLC2);
constexpr float kI1F = (float)kI1, kI2F = (float)kI2;
constexpr float kD2a = (float)(kLC2 * kLC2);
constexpr float kD2b = (float)(kL1 * kLC2);
constexpr float kPhi2 = (float)(kM2 * kLC2 * kG);
constexpr float kHalfPi = (float)(kPi / 2.0);
constexpr float kPhi1a = (float)(-kM2 * kL1 * kLC2);
constexpr float kPhi1c = (float)((kM1 * kLC1 + kM2 * kL1) * kG);
constexpr float kDd2 = (float)(kM2 * kL1 * kLC2);
constexpr float kDen = (float)(kM2 * kLC2 * kLC2 + kI2);
constexpr float kHalfDt = (float)(kDtD / 2), kDt = (float)kDtD;
constexpr float kDtSixth = (float)(kDtD / 6.0);
constexpr float kNegPi = (float)-kPi, kTwoPi = (float)(2 * kPi);
constexpr float kMaxVel1 = (float)(4 * kPi), kMaxVel2 = (float)(9 * kPi);

__device__ __forceinline__ void dsdt(const float* s, float torque, float* k) {
  const float theta1 = s[0], theta2 = s[1], dtheta1 = s[2], dtheta2 = s[3];
  const float d1 = ((kD1a + (kD1b + cosf(theta2))) + kI1F) + kI2F;
  const float d2 = (kD2a + mul(kD2b, cosf(theta2))) + kI2F;
  const float phi2 = mul(kPhi2, cosf((theta1 + theta2) - kHalfPi));
  const float phi1 =
      ((mul(mul(kPhi1a, mul(dtheta2, dtheta2)), sinf(theta2)) -
        mul(mul(dtheta2, dtheta1), sinf(theta2))) +
       mul(kPhi1c, cosf(theta1 - kHalfPi))) +
      phi2;
  const float ddtheta2 =
      (((torque + mul(d2 / d1, phi1)) -
        mul(mul(kDd2, mul(dtheta1, dtheta1)), sinf(theta2))) -
       phi2) /
      (kDen - mul(d2, d2) / d1);
  const float ddtheta1 = -(mul(d2, ddtheta2) + phi1) / d1;
  k[0] = dtheta1;
  k[1] = dtheta2;
  k[2] = ddtheta1;
  k[3] = ddtheta2;
}

__device__ __forceinline__ float wrap(float x) {
  return kNegPi + floor_mod(x - kNegPi, kTwoPi);
}
}  // namespace acrobot

struct Acrobot {
  static constexpr bool kObsIsState = false;
  static constexpr int S = 4, O = 6;
  __device__ static void step(const float* s, float a, float* ns, float* ob,
                              float& reward, float& done) {
    using namespace acrobot;
    const float torque = a - 1.0f;
    float k1[4], k2[4], k3[4], k4[4], t[4];
    dsdt(s, torque, k1);
    for (int i = 0; i < 4; ++i) t[i] = s[i] + mul(kHalfDt, k1[i]);
    dsdt(t, torque, k2);
    for (int i = 0; i < 4; ++i) t[i] = s[i] + mul(kHalfDt, k2[i]);
    dsdt(t, torque, k3);
    for (int i = 0; i < 4; ++i) t[i] = s[i] + mul(kDt, k3[i]);
    dsdt(t, torque, k4);
    for (int i = 0; i < 4; ++i)
      t[i] = s[i] + mul(kDtSixth, ((k1[i] + mul(2.0f, k2[i])) +
                                   mul(2.0f, k3[i])) + k4[i]);
    const float th1 = wrap(t[0]), th2 = wrap(t[1]);
    const float dth1 = clampf(t[2], -kMaxVel1, kMaxVel1);
    const float dth2 = clampf(t[3], -kMaxVel2, kMaxVel2);
    ns[0] = th1;
    ns[1] = th2;
    ns[2] = dth1;
    ns[3] = dth2;
    done = (-cosf(th1) - cosf(th2 + th1)) > 1.0f ? 1.0f : 0.0f;
    reward = done > 0.0f ? 0.0f : -1.0f;
    ob[0] = cosf(th1);
    ob[1] = sinf(th1);
    ob[2] = cosf(th2);
    ob[3] = sinf(th2);
    ob[4] = dth1;
    ob[5] = dth2;
  }
};

// -- Pong (envs/arcade/pong.py) -----------------------------------------------
namespace pong {
constexpr double kPaddleHalfD = 0.12, kPlayerXD = 0.92, kOppXD = 0.08;
constexpr float kPaddleHalf = (float)kPaddleHalfD;
constexpr float kPaddleHigh = (float)(1.0 - kPaddleHalfD);
constexpr float kPaddleSpeed = (float)0.05, kOppSpeed = (float)0.03;
constexpr float kSpin = (float)0.25, kMaxVy = (float)0.05;
constexpr float kPlayerX = (float)kPlayerXD, kOppX = (float)kOppXD;
constexpr float kTwoPlayerX = (float)(2.0 * kPlayerXD), kTwoOppX = (float)(2.0 * kOppXD);
}  // namespace pong

struct Pong {
  static constexpr bool kObsIsState = true;
  static constexpr int S = 6, O = 6;
  __device__ static void step(const float* s, float a, float* ns, float*,
                              float& reward, float& done) {
    using namespace pong;
    const float x = s[0], y = s[1];
    float vx = s[2], vy = s[3];
    const float move = a - 1.0f;
    const float py = clampf(s[4] + mul(move, kPaddleSpeed), kPaddleHalf, kPaddleHigh);
    float oy = s[5] + clampf(y - s[5], -kOppSpeed, kOppSpeed);
    oy = clampf(oy, kPaddleHalf, kPaddleHigh);
    float nx = x + vx, ny = y + vy;
    // top/bottom wall bounce
    if (ny < 0.0f || ny > 1.0f) vy = -vy;
    if (ny < 0.0f) ny = -ny;
    if (ny > 1.0f) ny = 2.0f - ny;
    // agent paddle (right plane), then opponent paddle (left plane)
    if (x < kPlayerX && nx >= kPlayerX && fabsf(ny - py) <= kPaddleHalf) {
      vy = clampf(vy + mul(ny - py, kSpin), -kMaxVy, kMaxVy);
      vx = -vx;
      nx = kTwoPlayerX - nx;
    }
    if (x > kOppX && nx <= kOppX && fabsf(ny - oy) <= kPaddleHalf) {
      vy = clampf(vy + mul(ny - oy, kSpin), -kMaxVy, kMaxVy);
      vx = -vx;
      nx = kTwoOppX - nx;
    }
    ns[0] = nx;
    ns[1] = ny;
    ns[2] = vx;
    ns[3] = vy;
    ns[4] = py;
    ns[5] = oy;
    reward = (nx < 0.0f ? 1.0f : 0.0f) - (nx > 1.0f ? 1.0f : 0.0f);
    done = (nx < 0.0f || nx > 1.0f) ? 1.0f : 0.0f;
  }
};

// -- Breakout (envs/arcade/breakout.py) ---------------------------------------
namespace breakout {
constexpr int kRows = 4, kCols = 6, kCells = kRows * kCols;
constexpr double kBrickTopD = 0.12, kBrickHD = 0.05, kPaddleYD = 0.92;
constexpr double kPaddleHalfD = 0.14;
constexpr float kBrickTop = (float)kBrickTopD, kBrickH = (float)kBrickHD;
constexpr float kBrickBottom = (float)(kBrickTopD + kRows * kBrickHD);
constexpr float kPaddleY = (float)kPaddleYD, kTwoPaddleY = (float)(2.0 * kPaddleYD);
constexpr float kPaddleHalf = (float)kPaddleHalfD;
constexpr float kPaddleHigh = (float)(1.0 - kPaddleHalfD);
constexpr float kPaddleSpeed = (float)0.06, kSpin = (float)0.15;
constexpr float kMaxVx = (float)0.04, kClearBonus = (float)5.0;
}  // namespace breakout

// The 24-cell board rides in rows 5..28 as 0/1 floats, as the env's int32
// bricks do. The body packs it into the bits of one integer, so the cell
// under the ball is found by a shift, not by a loop over 24 cells or an
// index into a register array (which would put the rows in local memory).
// The hit is masked exactly as the plain version's (row, col) comparison
// masks it: a cell only when the ball is in the brick region and
// floor((ny - top) / h) is a row 0..3 and floor(nx * 6) a column 0..5
// (nx == 1.0 gives column 6: no cell). `cleared` counts the cells left.
struct Breakout {
  static constexpr bool kObsIsState = true;
  static constexpr int S = 5 + breakout::kCells, O = S;
  __device__ static void step(const float* s, float a, float* ns, float*,
                              float& reward, float& done) {
    using namespace breakout;
    const float x = s[0], y = s[1];
    float vx = s[2], vy = s[3];
    const float move = a - 1.0f;
    const float px = clampf(s[4] + mul(move, kPaddleSpeed), kPaddleHalf, kPaddleHigh);
    float nx = x + vx, ny = y + vy;
    // side walls, then the ceiling
    if (nx < 0.0f || nx > 1.0f) vx = -vx;
    if (nx < 0.0f) nx = -nx;
    if (nx > 1.0f) nx = 2.0f - nx;
    if (ny < 0.0f) vy = -vy;
    if (ny < 0.0f) ny = -ny;
    // paddle bounce (crossing the paddle plane within reach)
    if (y < kPaddleY && ny >= kPaddleY && fabsf(nx - px) <= kPaddleHalf) {
      vx = clampf(vx + mul(nx - px, kSpin), -kMaxVx, kMaxVx);
      vy = -vy;
      ny = kTwoPaddleY - ny;
    }
    unsigned board = 0u;
#pragma unroll
    for (int i = 0; i < kCells; ++i) board |= (s[5 + i] > 0.0f ? 1u : 0u) << i;
    const float cell_r = floorf((ny - kBrickTop) / kBrickH);
    const float cell_c = floorf(mul(nx, (float)kCols));
    const bool in_cell = ny >= kBrickTop && ny < kBrickBottom &&
                         cell_r >= 0.0f && cell_r < (float)kRows &&
                         cell_c >= 0.0f && cell_c < (float)kCols;
    const unsigned hit =
        in_cell ? board & (1u << ((int)cell_r * kCols + (int)cell_c)) : 0u;
    board &= ~hit;
    const float broke = hit ? 1.0f : 0.0f;
    if (hit) vy = -vy;
    const bool cleared = __popc(board) == 0;
    ns[0] = nx;
    ns[1] = ny;
    ns[2] = vx;
    ns[3] = vy;
    ns[4] = px;
#pragma unroll
    for (int i = 0; i < kCells; ++i) ns[5 + i] = (board >> i) & 1u ? 1.0f : 0.0f;
    reward = broke + (cleared ? kClearBonus : 0.0f);
    done = (cleared || ny > 1.0f) ? 1.0f : 0.0f;
  }
};

constexpr int kBlock = 128;

template <class Env, bool kTimeLimit>
__global__ void __launch_bounds__(kBlock)
megastep_kernel(const float* __restrict__ state, const float* __restrict__ act,
                const float* __restrict__ fresh,
                const float* __restrict__ fresh_obs,
                float* __restrict__ out_state, float* __restrict__ obs,
                float* __restrict__ tobs, float* __restrict__ rew,
                float* __restrict__ done_out, float* __restrict__ trunc_out,
                int B, int K, int max_steps) {
  constexpr int S = Env::S, O = Env::O, SP = S + (kTimeLimit ? 1 : 0);
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  if (lane >= B) return;
  const size_t b = (size_t)B;
  const float limit = (float)max_steps;

  float rows[SP];
#pragma unroll
  for (int r = 0; r < SP; ++r) rows[r] = state[r * b + lane];

  for (int t = 0; t < K; ++t) {
    float ns[S], ob_own[Env::kObsIsState ? 1 : O], reward, done;
    Env::step(rows, act[t * b + lane], ns, ob_own, reward, done);
    const float* ob = Env::kObsIsState ? ns : ob_own;
    float trunc = 0.0f, tcnt = 0.0f;
    if constexpr (kTimeLimit) {
      tcnt = rows[S] + 1.0f;
      const float hit = tcnt >= limit ? 1.0f : 0.0f;
      trunc = mul(hit, 1.0f - done);
      done = fmaxf(done, hit);
    }
    const bool reset = done > 0.0f;
    const float* f = fresh + (size_t)t * SP * b + lane;
#pragma unroll
    for (int r = 0; r < S; ++r) rows[r] = reset ? f[r * b] : ns[r];
    if constexpr (kTimeLimit) rows[S] = reset ? f[S * b] : tcnt;
    const float* fo = fresh_obs + (size_t)t * O * b + lane;
    float* o_out = obs + (size_t)t * O * b + lane;
    float* to_out = tobs + (size_t)t * O * b + lane;
#pragma unroll
    for (int i = 0; i < O; ++i) {
      to_out[i * b] = ob[i];
      o_out[i * b] = reset ? fo[i * b] : ob[i];
    }
    rew[t * b + lane] = reward;
    done_out[t * b + lane] = done;
    trunc_out[t * b + lane] = trunc;
  }
#pragma unroll
  for (int r = 0; r < SP; ++r) out_state[r * b + lane] = rows[r];
}

template <class Env>
void launch(bool time_limit, int B, int K, int max_steps, const float* state,
            const float* act, const float* fresh, const float* fresh_obs,
            float* out_state, float* obs, float* tobs, float* rew, float* done,
            float* trunc, cudaStream_t stream) {
  const int grid = (B + kBlock - 1) / kBlock;
  if (time_limit) {
    megastep_kernel<Env, true><<<grid, kBlock, 0, stream>>>(
        state, act, fresh, fresh_obs, out_state, obs, tobs, rew, done, trunc,
        B, K, max_steps);
  } else {
    megastep_kernel<Env, false><<<grid, kBlock, 0, stream>>>(
        state, act, fresh, fresh_obs, out_state, obs, tobs, rew, done, trunc,
        B, K, max_steps);
  }
}

}  // namespace

// body: 0 CartPole, 1 MountainCar, 2 Pendulum, 3 Acrobot, 4 Pong, 5 Breakout
// (megastep.py BODIES);
// max_steps < 0: no TimeLimit. Returns the launch's cudaError_t.
extern "C" int megastep(int body, int max_steps, int B, int K,
                        const float* state, const float* act,
                        const float* fresh, const float* fresh_obs,
                        float* out_state, float* obs, float* tobs, float* rew,
                        float* done, float* trunc, void* stream) {
  const bool tl = max_steps >= 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case 0:
      launch<CartPole>(tl, B, K, max_steps, state, act, fresh, fresh_obs,
                       out_state, obs, tobs, rew, done, trunc, s);
      break;
    case 1:
      launch<MountainCar>(tl, B, K, max_steps, state, act, fresh, fresh_obs,
                          out_state, obs, tobs, rew, done, trunc, s);
      break;
    case 2:
      launch<Pendulum>(tl, B, K, max_steps, state, act, fresh, fresh_obs,
                       out_state, obs, tobs, rew, done, trunc, s);
      break;
    case 3:
      launch<Acrobot>(tl, B, K, max_steps, state, act, fresh, fresh_obs,
                      out_state, obs, tobs, rew, done, trunc, s);
      break;
    case 4:
      launch<Pong>(tl, B, K, max_steps, state, act, fresh, fresh_obs,
                   out_state, obs, tobs, rew, done, trunc, s);
      break;
    case 5:
      launch<Breakout>(tl, B, K, max_steps, state, act, fresh, fresh_obs,
                       out_state, obs, tobs, rew, done, trunc, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
