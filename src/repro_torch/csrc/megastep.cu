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
// floats. The observation is computed code by code as it is stored, and
// the fresh state and observation are read only where a lane resets. The
// bodies take states of the envs' own form (0/1 planes, integer cells), as
// every reset and step makes them; their integer arithmetic is exact, and
// Snake's one float sum is rounded as the plain version rounds it. They are
// bound by bytes too, mostly the obs and terminal_obs codes they write:
// 2·O floats a lane-step, 512 of Maze's 528 bytes.
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

// -- LightsOut (envs/puzzle.py) -----------------------------------------------
struct LightsOut : Packed {
  static constexpr int N = 5, M = N * N, S = M + 1, O = M;
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
  __device__ __forceinline__ static void step(State& st, float a, float& reward,
                                              float& done) {
    const int p = (int)a, r = p / N, c = p % N;
    unsigned long long cross = 1ull << p;
    if (r > 0) cross |= 1ull << (p - N);
    if (r < N - 1) cross |= 1ull << (p + N);
    if (c > 0) cross |= 1ull << (p - 1);
    if (c < N - 1) cross |= 1ull << (p + 1);
    st.board ^= cross;
    st.t = st.t + 1.0f;
    done = st.board == 0ull ? 1.0f : 0.0f;
    reward = st.board == 0ull ? 10.0f : -1.0f;
  }
  __device__ __forceinline__ static float code(const State& st, int i) {
    return bit(st.board, i);
  }
};

// -- FrozenLake (envs/grid/frozen_lake.py) ------------------------------------
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
struct CliffWalk : Packed {
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
// registers; every access is at an unrolled, compile-time cell index.
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
    if (eat && !over) {
      // The k-th food: the free cell minimising frac(prio + k·phi), ties to
      // the lowest index (snake.py::place_food). The product and the sum
      // are rounded apart, as PyTorch rounds them; nvcc would fuse a plain
      // `prio + k * phi` into one FMA.
      const float k = __fmul_rn((float)st.eaten, snake::kPhi);
      float v[M], vmin = 2.0f;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const float s = __fadd_rn(st.prio[i], k);
        v[i] = st.ages[i] == 0 && i != cand ? __fsub_rn(s, floorf(s)) : 2.0f;
        vmin = v[i] < vmin ? v[i] : vmin;
      }
      int placed = M;
#pragma unroll
      for (int i = M - 1; i >= 0; --i)
        if (v[i] == vmin) placed = i;
      st.food = placed;
    }
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

// The grid and puzzle bodies: the step order of megastep_kernel over a
// packed state. The observation is written code by code; a lane that resets
// reads its fresh state and observation, the others read neither.
template <class Env, bool kTimeLimit>
__global__ void __launch_bounds__(kBlock)
packed_megastep_kernel(const float* __restrict__ state,
                       const float* __restrict__ act,
                       const float* __restrict__ fresh,
                       const float* __restrict__ fresh_obs,
                       float* __restrict__ out_state, float* __restrict__ obs,
                       float* __restrict__ tobs, float* __restrict__ rew,
                       float* __restrict__ done_out,
                       float* __restrict__ trunc_out, int B, int K,
                       int max_steps) {
  constexpr int S = Env::S, O = Env::O, SP = S + (kTimeLimit ? 1 : 0);
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  if (lane >= B) return;
  const size_t b = (size_t)B;
  const float limit = (float)max_steps;

  typename Env::State st;
  Env::load(st, state + lane, b);
  float tcnt = kTimeLimit ? state[S * b + lane] : 0.0f;

  for (int t = 0; t < K; ++t) {
    float reward, done;
    Env::step(st, act[t * b + lane], reward, done);
    float trunc = 0.0f;
    if constexpr (kTimeLimit) {
      tcnt = tcnt + 1.0f;
      const float hit = tcnt >= limit ? 1.0f : 0.0f;
      trunc = mul(hit, 1.0f - done);
      done = fmaxf(done, hit);
    }
    const bool reset = done > 0.0f;
    float* o_out = obs + (size_t)t * O * b + lane;
    float* to_out = tobs + (size_t)t * O * b + lane;
#pragma unroll
    for (int i = 0; i < O; ++i) {
      const float code = Env::code(st, i);
      to_out[i * b] = code;
      if (!reset) o_out[i * b] = code;
    }
    if (reset) {
      const float* f = fresh + (size_t)t * SP * b + lane;
      const float* fo = fresh_obs + (size_t)t * O * b + lane;
      Env::load(st, f, b);
      if constexpr (kTimeLimit) tcnt = f[S * b];
#pragma unroll
      for (int i = 0; i < O; ++i) o_out[i * b] = fo[i * b];
    }
    rew[t * b + lane] = reward;
    done_out[t * b + lane] = done;
    trunc_out[t * b + lane] = trunc;
  }
  Env::store(st, out_state + lane, b);
  if constexpr (kTimeLimit) out_state[S * b + lane] = tcnt;
}

template <class Env, bool kTimeLimit>
void launch_body(int grid, cudaStream_t stream, int B, int K, int max_steps,
                 const float* state, const float* act, const float* fresh,
                 const float* fresh_obs, float* out_state, float* obs,
                 float* tobs, float* rew, float* done, float* trunc) {
  if constexpr (std::is_base_of<Packed, Env>::value) {
    packed_megastep_kernel<Env, kTimeLimit><<<grid, kBlock, 0, stream>>>(
        state, act, fresh, fresh_obs, out_state, obs, tobs, rew, done, trunc,
        B, K, max_steps);
  } else {
    megastep_kernel<Env, kTimeLimit><<<grid, kBlock, 0, stream>>>(
        state, act, fresh, fresh_obs, out_state, obs, tobs, rew, done, trunc,
        B, K, max_steps);
  }
}

template <class Env>
void launch(bool time_limit, int B, int K, int max_steps, const float* state,
            const float* act, const float* fresh, const float* fresh_obs,
            float* out_state, float* obs, float* tobs, float* rew, float* done,
            float* trunc, cudaStream_t stream) {
  const int grid = (B + kBlock - 1) / kBlock;
  if (time_limit) {
    launch_body<Env, true>(grid, stream, B, K, max_steps, state, act, fresh,
                           fresh_obs, out_state, obs, tobs, rew, done, trunc);
  } else {
    launch_body<Env, false>(grid, stream, B, K, max_steps, state, act, fresh,
                            fresh_obs, out_state, obs, tobs, rew, done, trunc);
  }
}

}  // namespace

// body: 0 CartPole, 1 MountainCar, 2 Pendulum, 3 Acrobot, 4 Pong, 5 Breakout,
// 6 LightsOut, 7 FrozenLake, 8 CliffWalk, 9 Maze, 10 Snake (megastep.py
// BODIES);
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
    case 6:
      launch<LightsOut>(tl, B, K, max_steps, state, act, fresh, fresh_obs,
                        out_state, obs, tobs, rew, done, trunc, s);
      break;
    case 7:
      launch<FrozenLake>(tl, B, K, max_steps, state, act, fresh, fresh_obs,
                         out_state, obs, tobs, rew, done, trunc, s);
      break;
    case 8:
      launch<CliffWalk>(tl, B, K, max_steps, state, act, fresh, fresh_obs,
                        out_state, obs, tobs, rew, done, trunc, s);
      break;
    case 9:
      launch<Maze>(tl, B, K, max_steps, state, act, fresh, fresh_obs,
                   out_state, obs, tobs, rew, done, trunc, s);
      break;
    case 10:
      launch<Snake>(tl, B, K, max_steps, state, act, fresh, fresh_obs,
                    out_state, obs, tobs, rew, done, trunc, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
