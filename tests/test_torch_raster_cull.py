"""The rasteriser's per-tile cull, proven on the plain version, on the CPU.

csrc/raster.cu draws each pixel tile from the segments that pass a
conservative reach test only; `kernels/raster/ref.py::tile_keep` is that
test's plain twin. Here: `rasterize_ref` with each tile's culled segments
zeroed equals `rasterize_ref` bit for bit inside the tile, on the scenes of
the port's envs (Pong, Breakout, Maze, Snake, LightsOut, Multitask), on
random scenes with segments placed just outside and just inside the reach
margin, on zero-radius dots, and on 60×100 frames with ragged tiles. The
CUDA kernel itself is held bit for bit against `rasterize_ref` on the card
by chip_smoke.py.

    PYTHONPATH=src python tests/test_torch_raster_cull.py

prints, per env and tile shape, the share of the all-pairs work (every
pixel against every live segment) that the cull leaves, ragged tiles
counted whole.
"""
import numpy as np
import pytest
import torch

from repro_torch import random as R
from repro_torch.envs.arcade import Breakout, Pong
from repro_torch.envs.grid import Maze, Snake
from repro_torch.envs.multitask import Multitask
from repro_torch.envs.puzzle import LightsOut
from repro_torch.kernels.raster import rasterize_ref, tile_keep


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: the kernel's warp tile (rows, cols): kTileH, kTileW in csrc/raster.cu
KERNEL_TILE = (8, 32)
#: tile shapes proven here: the kernel's, and a square one
TILES = (KERNEL_TILE, (16, 16))
ENVS = {"Pong": Pong, "Breakout": Breakout, "Maze": Maze, "Snake": Snake,
        "LightsOut": LightsOut, "Multitask": Multitask}


def assert_cull_exact(segs, intens, h, w, tile):
    """Every tile of every frame, drawn from its kept segments only, equals
    the frame drawn from all of them, bit for bit. Returns the kept share
    of the live (frame, tile, segment) triples."""
    th, tw = tile
    keep = tile_keep(segs, intens, h, w, tile)         # (N, T, S)
    n, t, s = keep.shape
    want = rasterize_ref(segs, intens, h, w)
    culled = (intens[:, None, :] * keep).reshape(n * t, s)
    got = rasterize_ref(segs.repeat_interleave(t, 0), culled, h, w)
    got = got.reshape(n, t, h, w)
    tiles_x = -(-w // tw)
    for i in range(t):
        r0, c0 = (i // tiles_x) * th, (i % tiles_x) * tw
        a = got[:, i, r0:r0 + th, c0:c0 + tw]
        b = want[:, r0:r0 + th, c0:c0 + tw]
        diff = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        assert diff == 0, f"tile {i} ({r0}, {c0}): {diff} pixels differ"
    live = (intens != 0)[:, None, :].expand_as(keep)
    return float(keep.sum()) / max(1, int(live.sum()))


def env_scenes(name, n, seed, steps=3):
    """Scenes of n lanes of an env of the port, reset from threefry keys
    and stepped a few random actions."""
    env = ENVS[name]()
    keys = R.split(R.PRNGKey(seed, "cpu"), n)
    state, _ = env.reset(keys)
    rng = np.random.default_rng(seed)
    for i in range(steps):
        act = torch.from_numpy(rng.integers(0, env.action_space.n, n))
        state = env.step(state, act, R.fold_in(keys, i)).state
    return [x.contiguous() for x in env.scene(state)]


def margin_scenes(n, s, h, seed):
    """Capsules whose grown boxes end just outside or just inside a tile's
    box of pixel centres: each segment is placed so that the gap from its
    box to a random pixel-centre line is r + f·softness, f one of 1/4, 1/2,
    3/4 and 1, times 1 ± a few float32 ulps, on x or on y, at random radii
    (zero included). A reach test tighter than r + softness/2 drops a
    covering segment here."""
    rng = np.random.default_rng(seed)
    soft = np.float32(1.0 / h)
    segs = np.zeros((n, s, 5), np.float32)
    r = rng.uniform(0.0, 0.05, (n, s)).astype(np.float32)
    r[:, ::4] = 0.0
    line = ((rng.integers(0, h, (n, s)) + 0.5) / h).astype(np.float32)
    ulps = rng.integers(-3, 4, (n, s)).astype(np.float32)
    side = np.where(rng.random((n, s)) < 0.5, -1.0, 1.0).astype(np.float32)
    f = rng.choice(np.float32([0.25, 0.5, 0.75, 1.0]), (n, s))
    edge = line - side * (r + f * soft) * (1 + ulps * np.float32(2 ** -23))
    length = rng.uniform(0.0, 0.3, (n, s)).astype(np.float32)
    far = edge - side * length                  # the far end, away from the line
    other = rng.uniform(0.0, 1.0, (n, s, 2)).astype(np.float32)
    on_x = rng.random((n, s)) < 0.5
    segs[..., 0] = np.where(on_x, edge, other[..., 0])
    segs[..., 2] = np.where(on_x, far, other[..., 0])
    segs[..., 1] = np.where(on_x, other[..., 1], edge)
    segs[..., 3] = np.where(on_x, other[..., 1], far)
    segs[..., 4] = r
    intens = rng.uniform(0.1, 1.0, (n, s)).astype(np.float32)
    intens[:, -1] = 0.0
    return torch.from_numpy(segs), torch.from_numpy(intens)


def random_scenes(n, s, seed):
    """Random capsules in [0, 1]², radii up to 0.05, segment 0 a dot and
    segment 1 a zero-radius dot, the last one padding."""
    rng = np.random.default_rng(seed)
    segs = rng.uniform(0.0, 1.0, (n, s, 5)).astype(np.float32)
    segs[..., 4] *= np.float32(0.05)
    segs[:, :2, 2:4] = segs[:, :2, 0:2]
    segs[:, 1, 4] = 0.0
    intens = rng.uniform(0.1, 1.0, (n, s)).astype(np.float32)
    intens[:, -1] = 0.0
    return torch.from_numpy(segs), torch.from_numpy(intens)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", ENVS)
def test_env_scenes(name, tile):
    segs, intens = env_scenes(name, 3, seed=len(name))
    kept = assert_cull_exact(segs, intens, 84, 84, tile)
    if name in ("Maze", "Snake", "LightsOut", "Breakout"):
        assert kept < 0.6, f"the cull keeps {kept:.0%} of the live segments"


@pytest.mark.parametrize("tile", TILES)
def test_segments_at_the_margin(tile):
    segs, intens = margin_scenes(4, 48, 84, seed=7)
    kept = tile_keep(segs, intens, 84, 84, tile)
    assert kept.any() and not kept[..., :-1].all(), "both sides of the margin"
    assert_cull_exact(segs, intens, 84, 84, tile)


@pytest.mark.parametrize("tile", TILES)
def test_ragged_tiles_and_dots(tile):
    segs, intens = random_scenes(3, 12, seed=11)
    assert_cull_exact(segs, intens, 60, 100, tile)
    assert_cull_exact(*margin_scenes(2, 24, 60, seed=12), 60, 100, tile)


def test_tile_keep_shape_and_padding():
    segs, intens = random_scenes(2, 5, seed=3)
    keep = tile_keep(segs, intens, 60, 100, (16, 32))
    assert keep.shape == (2, 4 * 4, 5) and keep.dtype == torch.bool
    assert not keep[..., -1].any(), "zero-intensity padding is never kept"
    assert torch.equal(tile_keep(segs, intens, 60, 100, 16),
                       tile_keep(segs, intens, 60, 100, (16, 16)))


if __name__ == "__main__":
    shapes = ((8, 32), (8, 16), (16, 16), (32, 32))
    print("work left by the cull, 64 lanes a family:", shapes)
    for name in ENVS:
        segs, intens = env_scenes(name, 64, seed=1)
        live = int((intens != 0).sum()) * 84 * 84
        print(f"{name:10s}", " ".join(
            f"{float(tile_keep(segs, intens, 84, 84, t).sum()) * t[0] * t[1] / live:.3f}"
            for t in shapes))
