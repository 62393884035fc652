// Megastep: K fused environment steps per launch, for sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/envstep/megastep.py::megastep_pallas (body
// _megastep_kernel, step order fused_transition; env bodies from
// src/repro/kernels/envstep/specs.py::_cartpole_rows, _mountain_car_rows,
// _pendulum_rows, _acrobot_rows, _pong_rows, _breakout_rows,
// _lightsout_rows, _frozen_lake_rows, _cliff_walk_rows, _maze_rows,
// _snake_rows).
//
// Each step, in AutoReset.step's order (core/wrappers.py): the lane's key
// is split into the next chain key and a reset key, the env body advances
// the state, the TimeLimit counter row counts and cuts, and where the
// episode ended the body's own reset runs from the reset key and its fresh
// observation is written as `obs`. The TPU kernel takes the K fresh states
// as precomputed inputs; this one carries each lane's key chain in two
// registers and computes a reset only where a lane resets, so no K*B fresh
// states are built or read. Layout is row-major with the batch on the
// minor axis: state (S', B) and act (K, B) float32, keys (B, 2) int64
// holding uint32 words; outputs new_state (S', B), final keys (B, 2), obs
// and terminal_obs (K, O, B), reward, done and truncated (K, B). S' = S + 1
// when max_steps >= 0 (the step counter row, reset to 0), S otherwise.
//
// Random numbers: threefry-2x32 (20 rounds, rotations 13,15,26,6 /
// 17,29,16,24, a key injection every 4 rounds), bit for bit with
// repro_torch/random.py, itself the legacy jax.random layout. `split(key)`
// is blocks (0,2), (1,3): the next key is their y0 words, the reset key
// their y1 words. `split(key, 3)` is blocks (0,3), (1,4), (2,5) = a, b, c,
// the keys (a.y0, b.y0), (c.y0, a.y1), (b.y1, c.y1). `random_bits(key,
// (n,))` cuts the counts in halves: with h = ceil(n/2), block j (counts j,
// j + h, the last x1 0 when n is odd) gives element j as y0 and element
// j + h as y1. `uniform` fills the mantissa of 1.0 with the top 23 bits,
// subtracts 1, multiplies by the float32 span and adds lo, each op rounded
// on its own, then clamps below at lo. `randint` splits, draws `higher`
// from the first key and `lower` from the second, and combines them in
// wrapping uint32 arithmetic. Integer arithmetic is exact, so the key
// chain and every grid level are bit for bit with the plain version.
//
// Bound (chip_smoke.py's megastep_bytes and megastep_ops). Bytes: with
// TimeLimit, CartPole moves 48 B per lane-step (act 4 read; obs 16,
// terminal_obs 16, reward, done, truncated 12 written) plus the state (20
// B) and the keys (16 B) read and written once per launch: 105.4 MB at B =
// 65,536, K = 32, 0.031 ms at 3.35 TB/s. Integer operations: two threefry
// blocks a lane-step for the split, plus the reset's blocks on the
// lane-steps that reset (CartPole 2, MountainCar 1, Pendulum 4, Acrobot 2,
// Pong 6, Breakout 4, LightsOut 8, FrozenLake 13, CliffWalk 30, Maze 46,
// Snake 18), 79 int32 ops a block (2 key xors, 2 adds, 20 rounds of add,
// funnel shift and xor, 5 injections of 3 adds): 0.020 ms for the split at
// CartPole's size at 64 int32 lanes a clock on each of 132 SMs (1.98 GHz).
// The bound is the larger; float ops are far below both.
//
// Design: one thread per lane, 128 threads a block, ceil(B/128) blocks; the
// S' state values and the two key words stay in registers across the K
// loop, and neighbouring threads touch neighbouring addresses on every
// load and store, so every access is coalesced. No padding. The body is a
// template parameter, so each env compiles to straight-line code. A body
// whose observation is its new state (kObsIsState: Pong, Breakout) writes
// no separate observation array; the kernel stores the new state rows as
// the observation.
//
// The grid and puzzle bodies (LightsOut, FrozenLake, CliffWalk, Maze,
// Snake) run a second kernel, packed_megastep_kernel, with the same layout
// and step order. The TPU kernel reduces them over (m, B) planes of cells;
// here a lane's cells are loops unrolled over the compile-time cell count.
// Their state is up to 77 rows and their observation up to 64 cell codes,
// too many floats to hold and index in registers, so each body keeps a
// packed state: its 0/1 planes (LightsOut's lights, FrozenLake's holes,
// CliffWalk's cliff, Maze's walls) as the bits of one integer, so a cell is
// a shift, the cross toggle an XOR and "all lights off" a compare with 0;
// cell indices as ints; Snake's ages as ints and its food priorities as
// floats. The observation is computed code by code as it is stored. The
// bodies take states of the envs' own form (0/1 planes, integer cells), as
// every reset and step makes them; their integer arithmetic is exact, and
// Snake's one float sum is rounded as the plain version rounds it. Their
// resets draw a level: up to 64 uniforms (32 threefry blocks for Maze's
// walls), a carved path, a goal. Drawn by the resetting lane alone, a
// reset would hold its whole warp for up to 32 blocks. So the warp draws
// each resetting lane's wide uniform field together: __ballot_sync gives
// the lanes that reset; for each of them, its key is broadcast by
// __shfl_sync, lane j computes block j, and two ballots give the 0/1 plane
// as two words (cells j and j + h, the halves layout); Snake's priorities
// are gathered by shuffles into the resetting lane's registers. The rest of
// a reset (splits, randint, the carved path) runs per lane.
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

#include <type_traits>

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

// -- threefry-2x32 (random.py) -------------------------------------------------
struct Key {
  unsigned a, b;   // the two uint32 words of a (2,) key
};

__device__ __forceinline__ unsigned rotl(unsigned x, int r) {
  return __funnelshift_l(x, x, r);
}

// One block: the two words (y0, y1) for the counts (x0, x1).
__device__ __forceinline__ uint2 threefry2x32(Key k, unsigned x0, unsigned x1) {
  const unsigned k0 = k.a, k1 = k.b, k2 = k.a ^ k.b ^ 0x1BD11BDAu;
#define TF_ROUNDS(r0, r1, r2, r3)                \
  x0 += x1; x1 = rotl(x1, r0) ^ x0;              \
  x0 += x1; x1 = rotl(x1, r1) ^ x0;              \
  x0 += x1; x1 = rotl(x1, r2) ^ x0;              \
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
  x0 += k0;
  x1 += k1;
  TF_ROUNDS(13, 15, 26, 6)  x0 += k1; x1 += k2 + 1u;
  TF_ROUNDS(17, 29, 16, 24) x0 += k2; x1 += k0 + 2u;
  TF_ROUNDS(13, 15, 26, 6)  x0 += k0; x1 += k1 + 3u;
  TF_ROUNDS(17, 29, 16, 24) x0 += k1; x1 += k2 + 4u;
  TF_ROUNDS(13, 15, 26, 6)  x0 += k2; x1 += k0 + 5u;
#undef TF_ROUNDS
  return make_uint2(x0, x1);
}

// split(key): returns the next chain key, `sub` the second key.
__device__ __forceinline__ Key split2(Key k, Key& sub) {
  const uint2 p = threefry2x32(k, 0u, 2u), q = threefry2x32(k, 1u, 3u);
  sub = Key{p.y, q.y};
  return Key{p.x, q.x};
}

// split(key, 3)
__device__ __forceinline__ void split3(Key k, Key& k0, Key& k1, Key& k2) {
  const uint2 a = threefry2x32(k, 0u, 3u), b = threefry2x32(k, 1u, 4u),
              c = threefry2x32(k, 2u, 5u);
  k0 = Key{a.x, b.x};
  k1 = Key{c.x, a.y};
  k2 = Key{b.y, c.y};
}

// random_bits(key, (N,)), element by element: f(i, bits of element i).
// Block j gives elements j and j + h; an odd N pads the last block's x1
// with 0 and drops its y1.
template <int N, class F>
__device__ __forceinline__ void random_bits(Key k, F f) {
  constexpr int h = (N + 1) / 2;
#pragma unroll
  for (int j = 0; j < h; ++j) {
    const uint2 y = threefry2x32(k, (unsigned)j, j + h < N ? (unsigned)(j + h) : 0u);
    f(j, y.x);
    if (j + h < N) f(j + h, y.y);
  }
}

// random_bits(key, ()): block (0, 0), its y0.
__device__ __forceinline__ unsigned scalar_bits(Key k) {
  return threefry2x32(k, 0u, 0u).x;
}

// uniform's value of one element's bits in [lo, hi), each op rounded apart
__device__ __forceinline__ float uniform(unsigned bits, float lo, float hi) {
  const float one_to_two = __uint_as_float((bits >> 9) | 0x3F800000u);
  const float v = __fadd_rn(mul(__fsub_rn(one_to_two, 1.0f), __fsub_rn(hi, lo)), lo);
  return v < lo ? lo : v;
}

__device__ __forceinline__ float uniform01(unsigned bits) {
  return uniform(bits, 0.0f, 1.0f);
}

// randint's value in [kLo, kHi) from its two draws: higher % span times
// 2**32 mod span, plus lower % span, in wrapping uint32 arithmetic
template <int kLo, int kHi>
__device__ __forceinline__ int randint_of(unsigned higher, unsigned lower) {
  constexpr unsigned span = kHi > kLo ? (unsigned)(kHi - kLo) : 1u;
  constexpr unsigned m16 = 65536u % span, mult = m16 * m16 % span;
  const unsigned offset = (higher % span) * mult + lower % span;
  return (int)(offset % span) + kLo;
}

// randint(key, (), kLo, kHi)
template <int kLo, int kHi>
__device__ __forceinline__ int randint_scalar(Key k) {
  Key second;
  const Key first = split2(k, second);
  return randint_of<kLo, kHi>(scalar_bits(first), scalar_bits(second));
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
  // reset: uniform(key, (4,), -0.05, 0.05); the observation is the state
  __device__ static void reset(Key k, float* s, float* ob) {
    random_bits<4>(k, [&](int i, unsigned v) {
      s[i] = uniform(v, (float)-0.05, (float)0.05);
    });
    for (int i = 0; i < 4; ++i) ob[i] = s[i];
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
  // reset: position uniform(key, (), -0.6, -0.4), velocity 0
  __device__ static void reset(Key k, float* s, float* ob) {
    s[0] = ob[0] = uniform(scalar_bits(k), (float)-0.6, (float)-0.4);
    s[1] = ob[1] = 0.0f;
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
  // reset: split, then theta uniform in [-pi, pi) from the first key and
  // theta_dot in [-1, 1) from the second
  __device__ static void reset(Key k, float* s, float* ob) {
    using namespace pendulum;
    Key second;
    const Key first = split2(k, second);
    s[0] = uniform(scalar_bits(first), -kPiF, kPiF);
    s[1] = uniform(scalar_bits(second), -1.0f, 1.0f);
    ob[0] = cosf(s[0]);
    ob[1] = sinf(s[0]);
    ob[2] = s[1];
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
  // reset: uniform(key, (4,), -0.1, 0.1); the observation is cos and sin
  // of the two angles, then the two velocities
  __device__ static void reset(Key k, float* s, float* ob) {
    random_bits<4>(k, [&](int i, unsigned v) {
      s[i] = uniform(v, (float)-0.1, (float)0.1);
    });
    ob[0] = cosf(s[0]);
    ob[1] = sinf(s[0]);
    ob[2] = cosf(s[1]);
    ob[3] = sinf(s[1]);
    ob[4] = s[2];
    ob[5] = s[3];
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
constexpr float kBallSpeedX = (float)0.035;
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
  // reset: split(key, 3) into ky, kd, kv; the ball at x 0.5 and y
  // uniform in [0.3, 0.7), served right where bernoulli(kd) (vx
  // BALL_SPEED_X times +-1), vy uniform in [-0.02, 0.02); both paddles at
  // 0.5
  __device__ static void reset(Key k, float* s, float*) {
    using namespace pong;
    Key ky, kd, kv;
    split3(k, ky, kd, kv);
    const float serve = uniform01(scalar_bits(kd)) < 0.5f ? 1.0f : -1.0f;
    s[0] = 0.5f;
    s[1] = uniform(scalar_bits(ky), (float)0.3, (float)0.7);
    s[2] = mul(kBallSpeedX, serve);
    s[3] = uniform(scalar_bits(kv), (float)-0.02, (float)0.02);
    s[4] = 0.5f;
    s[5] = 0.5f;
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
constexpr float kBallVx0 = (float)0.022, kBallVy0 = (float)0.03;
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
  // reset: split; the ball at x uniform in [0.2, 0.8) from the first key,
  // y 0.55, served right where bernoulli(second key) (vx BALL_VX0 times
  // +-1), vy BALL_VY0; the paddle at 0.5; every brick standing
  __device__ static void reset(Key k, float* s, float*) {
    using namespace breakout;
    Key second;
    const Key first = split2(k, second);
    const float serve = uniform01(scalar_bits(second)) < 0.5f ? 1.0f : -1.0f;
    s[0] = uniform(scalar_bits(first), (float)0.2, (float)0.8);
    s[1] = (float)0.55;
    s[2] = mul(kBallVx0, serve);
    s[3] = kBallVy0;
    s[4] = 0.5f;
#pragma unroll
    for (int i = 0; i < kCells; ++i) s[5 + i] = 1.0f;
  }
};

// -- The grid and puzzle bodies (packed_megastep_kernel) ---------------------
// Each has a packed `State` in registers and:
//   load(st, rows, b)   the state from rows[r * b], r < S (a lane's column)
//   store(st, rows, b)  the state back to its rows
//   step(st, a, reward, done)
//   code(st, i)         observation row i of the state, a float
// Every loop over cells is unrolled, so no register array is indexed at run
// time.
struct Packed {};

__device__ __forceinline__ float bit(unsigned long long plane, int i) {
  return (plane >> i) & 1ull ? 1.0f : 0.0f;
}

template <int M>
__device__ __forceinline__ unsigned long long load_plane(const float* rows,
                                                         size_t b) {
  unsigned long long plane = 0ull;
#pragma unroll
  for (int i = 0; i < M; ++i)
    plane |= (rows[i * b] > 0.0f ? 1ull : 0ull) << i;
  return plane;
}

template <int M>
__device__ __forceinline__ void store_plane(unsigned long long plane,
                                            float* rows, size_t b) {
#pragma unroll
  for (int i = 0; i < M; ++i) rows[i * b] = bit(plane, i);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (hi < v ? hi : v);
}

// Gym FrozenLake action order: 0 left, 1 down, 2 right, 3 up; another
// action stands still (envs/grid/common.py::move_deltas).
__device__ __forceinline__ int grid_dr(float a) {
  return (a == 1.0f ? 1 : 0) - (a == 3.0f ? 1 : 0);
}
__device__ __forceinline__ int grid_dc(float a) {
  return (a == 2.0f ? 1 : 0) - (a == 0.0f ? 1 : 0);
}

// The edge-clipped cell a move leads to.
template <int kRows, int kCols>
__device__ __forceinline__ int grid_move(int pos, float a) {
  const int r = pos / kCols, c = pos % kCols;
  return clampi(r + grid_dr(a), 0, kRows - 1) * kCols +
         clampi(c + grid_dc(a), 0, kCols - 1);
}

// -- the grid levels' draws, by the warp --------------------------------------
// Each resetting lane's wide uniform field is drawn by its whole warp: for
// each lane that resets, in turn, its key is broadcast and lane j computes
// block j (elements j and j + h, the halves layout). Measured against each
// lane drawing its own field inside its reset (PERF.md's findings): 1.42x
// on a Maze-v0 chunk, 1.89x on Snake-v0's, as fast on the others but
// FrozenLake's reset-heavy case (0.79x). Every lane of the warp must call
// these, so the packed kernel keeps its lanes past B in the loop.
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// The plane `uniform(key, (M,)) < p` as the bits of an integer, on the
// lanes where `reset` (0 elsewhere); two ballots give cells j and j + h.
template <int M>
__device__ __forceinline__ unsigned long long draw_plane(bool reset, Key k,
                                                         float p) {
  constexpr int h = (M + 1) / 2;
  static_assert(h <= 32, "one block a lane");
  const unsigned lane = threadIdx.x & 31u;
  unsigned long long plane = 0ull;
  for (unsigned todo = __ballot_sync(kFullWarp, reset); todo;
       todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    const Key kk{__shfl_sync(kFullWarp, k.a, src),
                 __shfl_sync(kFullWarp, k.b, src)};
    bool lo = false, hi = false;
    if (lane < (unsigned)h) {
      const bool pair = lane + h < (unsigned)M;
      const uint2 y = threefry2x32(kk, lane, pair ? lane + h : 0u);
      lo = uniform01(y.x) < p;
      hi = pair && uniform01(y.y) < p;
    }
    const unsigned wlo = __ballot_sync(kFullWarp, lo);
    const unsigned whi = __ballot_sync(kFullWarp, hi);
    if (lane == (unsigned)src)
      plane = (unsigned long long)wlo | ((unsigned long long)whi << h);
  }
  return plane;
}

// out[i] = uniform(key, (M,))[i] on the lanes where `reset`, gathered by
// shuffles into the resetting lane's own registers; the other lanes' `out`
// is left as it is.
template <int M>
__device__ __forceinline__ void draw_uniforms(bool reset, Key k, float* out) {
  constexpr int h = M / 2;
  static_assert(h <= 32 && M % 2 == 0, "one block a lane, no padding");
  const unsigned lane = threadIdx.x & 31u;
  for (unsigned todo = __ballot_sync(kFullWarp, reset); todo;
       todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    const Key kk{__shfl_sync(kFullWarp, k.a, src),
                 __shfl_sync(kFullWarp, k.b, src)};
    float lo = 0.0f, hi = 0.0f;
    if (lane < (unsigned)h) {
      const uint2 y = threefry2x32(kk, lane, lane + h);
      lo = uniform01(y.x);
      hi = uniform01(y.y);
    }
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const float a = __shfl_sync(kFullWarp, lo, j);
      const float b = __shfl_sync(kFullWarp, hi, j);
      if (lane == (unsigned)src) {
        out[j] = a;
        out[j + h] = b;
      }
    }
  }
}

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

// common.py::carve_path: a random monotone lattice path from cell 0 to
// (goal_r, goal_c), as the bits of an integer. Step i moves a row where
// one is needed and either no column is or uniform(key, (steps,))[i] <
// 0.5, else a column where one is needed.
template <int kRows, int kCols>
__device__ __forceinline__ unsigned long long carve_path(Key k, int goal_r,
                                                         int goal_c) {
  constexpr int kSteps = kRows + kCols - 2;
  static_assert(kSteps <= 32, "the row picks fit one word");
  unsigned row_pick = 0u;   // bit i: uniform draw i < 0.5
  random_bits<kSteps>(k, [&](int i, unsigned v) {
    row_pick |= (uniform01(v) < 0.5f ? 1u : 0u) << i;
  });
  int r = 0, c = 0;
  unsigned long long path = 1ull;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int need_r = goal_r - r, need_c = goal_c - c;
    const bool go_row = need_r != 0 && (need_c == 0 || ((row_pick >> i) & 1u));
    const bool go_col = !go_row && need_c != 0;
    r += go_row ? sgn(need_r) : 0;
    c += go_col ? sgn(need_c) : 0;
    path |= 1ull << (r * kCols + c);
  }
  return path;
}

// -- LightsOut (envs/puzzle.py) -----------------------------------------------
struct LightsOut : Packed {
  // N and scramble_presses: puzzle.py::LightsOut's defaults (megastep.py's
  // BODIES records them)
  static constexpr int N = 5, M = N * N, S = M + 1, O = M, kPresses = 6;
  struct State {
    unsigned long long board;   // bit i: cell i lit
    float t;
  };
  __device__ __forceinline__ static void load(State& st, const float* rows,
                                              size_t b) {
    st.board = load_plane<M>(rows, b);
    st.t = rows[M * b];
  }
  __device__ __forceinline__ static void store(const State& st, float* rows,
                                               size_t b) {
    store_plane<M>(st.board, rows, b);
    rows[M * b] = st.t;
  }
  __device__ __forceinline__ static unsigned long long cross(int p) {
    const int r = p / N, c = p % N;
    unsigned long long x = 1ull << p;
    if (r > 0) x |= 1ull << (p - N);
    if (r < N - 1) x |= 1ull << (p + N);
    if (c > 0) x |= 1ull << (p - 1);
    if (c < N - 1) x |= 1ull << (p + 1);
    return x;
  }
  // reset: presses = randint(key, (kPresses,), 0, M), toggled in order on
  // a solved board
  __device__ __forceinline__ static void reset(bool reset, Key k, State& st) {
    if (!reset) return;
    Key second;
    const Key first = split2(k, second);
    unsigned higher[kPresses], lower[kPresses];
    random_bits<kPresses>(first, [&](int i, unsigned v) { higher[i] = v; });
    random_bits<kPresses>(second, [&](int i, unsigned v) { lower[i] = v; });
    st.board = 0ull;
#pragma unroll
    for (int i = 0; i < kPresses; ++i)
      st.board ^= cross(randint_of<0, M>(higher[i], lower[i]));
    st.t = 0.0f;
  }
  __device__ __forceinline__ static void step(State& st, float a, float& reward,
                                              float& done) {
    st.board ^= cross((int)a);
    st.t = st.t + 1.0f;
    done = st.board == 0ull ? 1.0f : 0.0f;
    reward = st.board == 0ull ? 10.0f : -1.0f;
  }
  __device__ __forceinline__ static float code(const State& st, int i) {
    return bit(st.board, i);
  }
};

// -- FrozenLake (envs/grid/frozen_lake.py) ------------------------------------
// frozen_lake.py::HOLE_P
constexpr float kHoleP = (float)0.3;

// N: frozen_lake.py::FrozenLake's default (megastep.py's BODIES records it)
struct FrozenLake : Packed {
  static constexpr int N = 4, M = N * N, S = 1 + M, O = M;
  struct State {
    int pos;
    unsigned long long holes;
  };
  __device__ __forceinline__ static void load(State& st, const float* rows,
                                              size_t b) {
    st.pos = (int)rows[0];
    st.holes = load_plane<M>(rows + b, b);
  }
  __device__ __forceinline__ static void store(const State& st, float* rows,
                                               size_t b) {
    rows[0] = (float)st.pos;
    store_plane<M>(st.holes, rows + b, b);
  }
  // reset: split; holes where uniform(first, (M,)) < HOLE_P off the path
  // carved from the second key to the last cell; the agent at cell 0
  __device__ __forceinline__ static void reset(bool reset, Key k, State& st) {
    Key first{0u, 0u}, second{0u, 0u};
    if (reset) first = split2(k, second);
    const unsigned long long u = draw_plane<M>(reset, first, kHoleP);
    if (!reset) return;
    st.holes = u & ~carve_path<N, N>(second, N - 1, N - 1);
    st.pos = 0;
  }
  __device__ __forceinline__ static void step(State& st, float a, float& reward,
                                              float& done) {
    st.pos = grid_move<N, N>(st.pos, a);
    const bool goal = st.pos == M - 1;
    done = ((st.holes >> st.pos) & 1ull) || goal ? 1.0f : 0.0f;
    reward = goal ? 1.0f : 0.0f;
  }
  __device__ __forceinline__ static float code(const State& st, int i) {
    return i == st.pos ? 3.0f : (i == M - 1 ? 2.0f : bit(st.holes, i));
  }
};

// -- CliffWalk (envs/grid/cliff_walk.py) --------------------------------------
// cliff_walk.py::CLIFF_P
constexpr float kCliffP = (float)0.25;

// The cells of column 0 and of the last column of a kRows x kCols grid.
template <int kRows, int kCols>
__host__ __device__ constexpr unsigned long long edge_columns() {
  unsigned long long x = 0ull;
  for (int r = 0; r < kRows; ++r)
    x |= (1ull << (r * kCols)) | (1ull << (r * kCols + kCols - 1));
  return x;
}

struct CliffWalk : Packed {
  // n_rows, n_cols: cliff_walk.py::CliffWalk's defaults (megastep.py's
  // BODIES records them)
  static constexpr int kRows = 4, kCols = 12, M = kRows * kCols, S = 1 + M,
                       O = M, kStart = (kRows - 1) * kCols;
  struct State {
    int pos;
    unsigned long long cliff;
  };
  __device__ __forceinline__ static void load(State& st, const float* rows,
                                              size_t b) {
    st.pos = (int)rows[0];
    st.cliff = load_plane<M>(rows + b, b);
  }
  __device__ __forceinline__ static void store(const State& st, float* rows,
                                               size_t b) {
    rows[0] = (float)st.pos;
    store_plane<M>(st.cliff, rows + b, b);
  }
  // the cells of one row; of column 0 and the last column; of the bottom
  // row between them
  static constexpr unsigned long long kRow = (1ull << kCols) - 1ull;
  static constexpr unsigned long long kEdges = edge_columns<kRows, kCols>();
  static constexpr unsigned long long kBottom = (kRow << kStart) & ~kEdges;
  // reset: split; cliff where (the bottom row between start and goal, or
  // uniform(first, (M,)) < CLIFF_P) and not on a safe cell: column 0, the
  // last column, or the row randint(second, (), 0, n_rows - 1); the agent
  // at the start
  __device__ __forceinline__ static void reset(bool reset, Key k, State& st) {
    Key first{0u, 0u}, second{0u, 0u};
    if (reset) first = split2(k, second);
    const unsigned long long u = draw_plane<M>(reset, first, kCliffP);
    if (!reset) return;
    const int safe_row = randint_scalar<0, kRows - 1>(second);
    const unsigned long long safe = kEdges | (kRow << (safe_row * kCols));
    st.cliff = (kBottom | u) & ~safe;
    st.pos = kStart;
  }
  __device__ __forceinline__ static void step(State& st, float a, float& reward,
                                              float& done) {
    const int npos = grid_move<kRows, kCols>(st.pos, a);
    const bool fell = (st.cliff >> npos) & 1ull;
    done = npos == M - 1 ? 1.0f : 0.0f;   // the goal, before a fall
    st.pos = fell ? kStart : npos;
    reward = fell ? -100.0f : -1.0f;
  }
  __device__ __forceinline__ static float code(const State& st, int i) {
    return i == st.pos ? 3.0f : (i == M - 1 ? 2.0f : bit(st.cliff, i));
  }
};

// -- Maze (envs/grid/maze.py) -------------------------------------------------
// maze.py::WALL_P
constexpr float kWallP = (float)0.35;

// N: maze.py::Maze's default (megastep.py's BODIES records it)
struct Maze : Packed {
  static constexpr int N = 8, M = N * N, S = 2 + M, O = M;
  struct State {
    int pos, goal;
    unsigned long long walls;
  };
  __device__ __forceinline__ static void load(State& st, const float* rows,
                                              size_t b) {
    st.pos = (int)rows[0];
    st.goal = (int)rows[b];
    st.walls = load_plane<M>(rows + 2 * b, b);
  }
  __device__ __forceinline__ static void store(const State& st, float* rows,
                                               size_t b) {
    rows[0] = (float)st.pos;
    rows[b] = (float)st.goal;
    store_plane<M>(st.walls, rows + 2 * b, b);
  }
  // reset: split(key, 3); walls where uniform(k0, (M,)) < WALL_P off the
  // path carved from k2 to the goal randint(k1, (), M / 2, M); the agent
  // at cell 0
  __device__ __forceinline__ static void reset(bool reset, Key k, State& st) {
    Key k0{0u, 0u}, k1{0u, 0u}, k2{0u, 0u};
    if (reset) split3(k, k0, k1, k2);
    const unsigned long long u = draw_plane<M>(reset, k0, kWallP);
    if (!reset) return;
    st.goal = randint_scalar<M / 2, M>(k1);
    st.walls = u & ~carve_path<N, N>(k2, st.goal / N, st.goal % N);
    st.pos = 0;
  }
  __device__ __forceinline__ static void step(State& st, float a, float& reward,
                                              float& done) {
    const int cand = grid_move<N, N>(st.pos, a);
    if (!((st.walls >> cand) & 1ull)) st.pos = cand;
    done = st.pos == st.goal ? 1.0f : 0.0f;
    reward = done;
  }
  __device__ __forceinline__ static float code(const State& st, int i) {
    return i == st.pos ? 3.0f : (i == st.goal ? 2.0f : bit(st.walls, i));
  }
};

// -- Snake (envs/grid/snake.py) -----------------------------------------------
namespace snake {
constexpr float kPhi = (float)0.6180339887498949;   // rounded once
}  // namespace snake

// Rows: head, food, length, eaten, ages (36), prio (36) (the spec's
// field_order). Ages are integers up to 36 and priorities floats, 72
// registers; every access is at an unrolled, compile-time cell index. N:
// snake.py::Snake's default (megastep.py's BODIES records it).
struct Snake : Packed {
  static constexpr int N = 6, M = N * N, S = 4 + 2 * M, O = M;
  struct State {
    int head, food, length, eaten;
    int ages[M];
    float prio[M];
  };
  __device__ __forceinline__ static void load(State& st, const float* rows,
                                              size_t b) {
    st.head = (int)rows[0];
    st.food = (int)rows[b];
    st.length = (int)rows[2 * b];
    st.eaten = (int)rows[3 * b];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      st.ages[i] = (int)rows[(4 + i) * b];
      st.prio[i] = rows[(4 + M + i) * b];
    }
  }
  __device__ __forceinline__ static void store(const State& st, float* rows,
                                               size_t b) {
    rows[0] = (float)st.head;
    rows[b] = (float)st.food;
    rows[2 * b] = (float)st.length;
    rows[3 * b] = (float)st.eaten;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      rows[(4 + i) * b] = (float)st.ages[i];
      rows[(4 + M + i) * b] = st.prio[i];
    }
  }
  // The k-th food (k = eaten): the free cell (age 0, not the head)
  // minimising frac(prio + k·phi), ties to the lowest index
  // (snake.py::place_food). The product and the sum are rounded apart, as
  // PyTorch rounds them; nvcc would fuse a plain `prio + k * phi` into one
  // FMA.
  __device__ __forceinline__ static int place_food(const State& st, int head) {
    const float k = __fmul_rn((float)st.eaten, snake::kPhi);
    float v[M], vmin = 2.0f;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float s = __fadd_rn(st.prio[i], k);
      v[i] = st.ages[i] == 0 && i != head ? __fsub_rn(s, floorf(s)) : 2.0f;
      vmin = v[i] < vmin ? v[i] : vmin;
    }
    int placed = M;
#pragma unroll
    for (int i = M - 1; i >= 0; --i)
      if (v[i] == vmin) placed = i;
    return placed;
  }
  // reset: prio = uniform(key, (M,)), drawn into the state's own
  // registers; a length-1 snake at the centre; the first food
  __device__ __forceinline__ static void reset(bool reset, Key k, State& st) {
    draw_uniforms<M>(reset, k, st.prio);
    if (!reset) return;
    constexpr int kCenter = (N / 2) * N + N / 2;
    st.head = kCenter;
    st.length = 1;
    st.eaten = 0;
#pragma unroll
    for (int i = 0; i < M; ++i) st.ages[i] = i == kCenter ? 1 : 0;
    st.food = place_food(st, kCenter);
  }
  __device__ __forceinline__ static void step(State& st, float a, float& reward,
                                              float& done) {
    const int r = st.head / N, c = st.head % N;
    const int nr = r + grid_dr(a), nc = c + grid_dc(a);
    const bool inb = nr >= 0 && nr < N && nc >= 0 && nc < N;
    const int cand = clampi(nr, 0, N - 1) * N + clampi(nc, 0, N - 1);
    const bool eat = inb && cand == st.food;
    // The tail leaves one cell unless eating; a move into the cell just
    // left is legal.
    bool hit = false;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int age = st.ages[i] - (eat ? 0 : 1);
      st.ages[i] = age < 0 ? 0 : age;
      if (i == cand && st.ages[i] > 0) hit = true;
    }
    const bool die = !inb || hit;
    st.length += eat ? 1 : 0;
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (i == cand) st.ages[i] = st.length;
    const bool over = die || st.length >= M;
    st.eaten += eat ? 1 : 0;
    if (eat && !over) st.food = place_food(st, cand);
    st.head = cand;
    done = over ? 1.0f : 0.0f;
    reward = (eat ? 1.0f : 0.0f) + (die ? -1.0f : 0.0f);
  }
  __device__ __forceinline__ static float code(const State& st, int i) {
    return i == st.head ? 2.0f
                        : (st.ages[i] > 0 ? 1.0f : (i == st.food ? 3.0f : 0.0f));
  }
};

constexpr int kBlock = 128;

__device__ __forceinline__ Key load_key(const long long* keys, int lane) {
  const longlong2 k = reinterpret_cast<const longlong2*>(keys)[lane];
  return Key{(unsigned)k.x, (unsigned)k.y};
}

__device__ __forceinline__ void store_key(long long* keys, int lane, Key k) {
  reinterpret_cast<longlong2*>(keys)[lane] =
      make_longlong2((long long)k.a, (long long)k.b);
}

template <class Env, bool kTimeLimit>
__global__ void __launch_bounds__(kBlock)
megastep_kernel(const float* __restrict__ state,
                const long long* __restrict__ keys,
                const float* __restrict__ act, float* __restrict__ out_state,
                long long* __restrict__ out_keys, float* __restrict__ obs,
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
  Key key = load_key(keys, lane);

  for (int t = 0; t < K; ++t) {
    Key reset_key;
    key = split2(key, reset_key);
    float ns[S], ob_own[Env::kObsIsState ? 1 : O], reward, done;
    Env::step(rows, act[t * b + lane], ns, ob_own, reward, done);
    float* ob = Env::kObsIsState ? ns : ob_own;
    float trunc = 0.0f, tcnt = 0.0f;
    if constexpr (kTimeLimit) {
      tcnt = rows[S] + 1.0f;
      const float hit = tcnt >= limit ? 1.0f : 0.0f;
      trunc = mul(hit, 1.0f - done);
      done = fmaxf(done, hit);
    }
    float* to_out = tobs + (size_t)t * O * b + lane;
#pragma unroll
    for (int i = 0; i < O; ++i) to_out[i * b] = ob[i];
    const bool reset = done > 0.0f;
    if (reset) {
      Env::reset(reset_key, ns, ob);
      tcnt = 0.0f;
    }
#pragma unroll
    for (int r = 0; r < S; ++r) rows[r] = ns[r];
    if constexpr (kTimeLimit) rows[S] = tcnt;
    float* o_out = obs + (size_t)t * O * b + lane;
#pragma unroll
    for (int i = 0; i < O; ++i) o_out[i * b] = ob[i];
    rew[t * b + lane] = reward;
    done_out[t * b + lane] = done;
    trunc_out[t * b + lane] = trunc;
  }
#pragma unroll
  for (int r = 0; r < SP; ++r) out_state[r * b + lane] = rows[r];
  store_key(out_keys, lane, key);
}

// The grid and puzzle bodies: the step order of megastep_kernel over a
// packed state. The observation is written code by code; a lane that resets
// draws its new level and writes the new level's codes as `obs`. A warp's
// lanes past B stay in the loop (clamped to lane B - 1 and never
// resetting) so that every lane reaches the warp's draws; they store
// nothing.
template <class Env, bool kTimeLimit>
__global__ void __launch_bounds__(kBlock)
packed_megastep_kernel(const float* __restrict__ state,
                       const long long* __restrict__ keys,
                       const float* __restrict__ act,
                       float* __restrict__ out_state,
                       long long* __restrict__ out_keys,
                       float* __restrict__ obs, float* __restrict__ tobs,
                       float* __restrict__ rew, float* __restrict__ done_out,
                       float* __restrict__ trunc_out, int B, int K,
                       int max_steps) {
  constexpr int S = Env::S, O = Env::O;
  const int thread = blockIdx.x * kBlock + threadIdx.x;
  const bool live = thread < B;
  const int lane = live ? thread : B - 1;
  const size_t b = (size_t)B;
  const float limit = (float)max_steps;

  typename Env::State st;
  Env::load(st, state + lane, b);
  float tcnt = kTimeLimit ? state[S * b + lane] : 0.0f;
  Key key = load_key(keys, lane);

  for (int t = 0; t < K; ++t) {
    Key reset_key;
    key = split2(key, reset_key);
    float reward, done;
    Env::step(st, act[t * b + lane], reward, done);
    float trunc = 0.0f;
    if constexpr (kTimeLimit) {
      tcnt = tcnt + 1.0f;
      const float hit = tcnt >= limit ? 1.0f : 0.0f;
      trunc = mul(hit, 1.0f - done);
      done = fmaxf(done, hit);
    }
    const bool reset = live && done > 0.0f;
    float* o_out = obs + (size_t)t * O * b + lane;
    float* to_out = tobs + (size_t)t * O * b + lane;
    if (live) {
#pragma unroll
      for (int i = 0; i < O; ++i) {
        const float code = Env::code(st, i);
        to_out[i * b] = code;
        if (!reset) o_out[i * b] = code;
      }
    }
    Env::reset(reset, reset_key, st);
    if (reset) {
      tcnt = 0.0f;
#pragma unroll
      for (int i = 0; i < O; ++i) o_out[i * b] = Env::code(st, i);
    }
    if (live) {
      rew[t * b + lane] = reward;
      done_out[t * b + lane] = done;
      trunc_out[t * b + lane] = trunc;
    }
  }
  if (!live) return;
  Env::store(st, out_state + lane, b);
  if constexpr (kTimeLimit) out_state[S * b + lane] = tcnt;
  store_key(out_keys, lane, key);
}

struct Args {
  int B, K, max_steps;
  const float* state;
  const long long* keys;
  const float* act;
  float* out_state;
  long long* out_keys;
  float *obs, *tobs, *rew, *done, *trunc;
};

template <class Env, bool kTimeLimit>
void launch_body(const Args& a, cudaStream_t stream) {
  const int grid = (a.B + kBlock - 1) / kBlock;
  if constexpr (std::is_base_of<Packed, Env>::value) {
    packed_megastep_kernel<Env, kTimeLimit><<<grid, kBlock, 0, stream>>>(
        a.state, a.keys, a.act, a.out_state, a.out_keys, a.obs, a.tobs, a.rew,
        a.done, a.trunc, a.B, a.K, a.max_steps);
  } else {
    megastep_kernel<Env, kTimeLimit><<<grid, kBlock, 0, stream>>>(
        a.state, a.keys, a.act, a.out_state, a.out_keys, a.obs, a.tobs, a.rew,
        a.done, a.trunc, a.B, a.K, a.max_steps);
  }
}

template <class Env>
void launch(const Args& a, cudaStream_t stream) {
  if (a.max_steps >= 0) {
    launch_body<Env, true>(a, stream);
  } else {
    launch_body<Env, false>(a, stream);
  }
}

}  // namespace

// body: 0 CartPole, 1 MountainCar, 2 Pendulum, 3 Acrobot, 4 Pong, 5 Breakout,
// 6 LightsOut, 7 FrozenLake, 8 CliffWalk, 9 Maze, 10 Snake (megastep.py
// BODIES);
// max_steps < 0: no TimeLimit. keys and out_keys: (B, 2) int64, 16-byte
// aligned. Returns the launch's cudaError_t.
extern "C" int megastep(int body, int max_steps, int B, int K,
                        const float* state, const long long* keys,
                        const float* act, float* out_state,
                        long long* out_keys, float* obs, float* tobs,
                        float* rew, float* done, float* trunc, void* stream) {
  const Args a{B, K, max_steps, state, keys, act, out_state, out_keys,
               obs, tobs, rew, done, trunc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case 0: launch<CartPole>(a, s); break;
    case 1: launch<MountainCar>(a, s); break;
    case 2: launch<Pendulum>(a, s); break;
    case 3: launch<Acrobot>(a, s); break;
    case 4: launch<Pong>(a, s); break;
    case 5: launch<Breakout>(a, s); break;
    case 6: launch<LightsOut>(a, s); break;
    case 7: launch<FrozenLake>(a, s); break;
    case 8: launch<CliffWalk>(a, s); break;
    case 9: launch<Maze>(a, s); break;
    case 10: launch<Snake>(a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
