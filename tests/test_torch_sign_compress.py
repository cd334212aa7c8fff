"""The work list of the persistent ``sign_compress`` CUDA kernel.

The kernel (``src/repro_torch/csrc/sign_compress.cu``) runs on the card
only, but the list of work items it walks is built on the host by
``repro_torch.kernels.sign_compress.schedule``, a pure function. These
tests hold that list to the rules the kernel's correctness and its freedom
from deadlock rest on, over five layouts: DeepFM's 11 leaf segments (a
reduced model in the resident layout), one segment over a whole worker, a
flat K = 1 tensor, segments with zero rows and a ragged last tile. Then
they run the list as the kernel does, in numpy (the A items write q and
the tile sums, the segment's last A item takes the scale, the B items
apply it), and hold the result to the plain version and to the JAX
package's kernel; and they step a grid of blocks through the list as the
kernel hands it out, one item ahead, and find that it always finishes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sign_compress as jsc
from repro_torch._tree import tree_map
from repro_torch.kernels import pack as tpack
from repro_torch.kernels import sign_compress as tsc
from repro_torch.models.deepfm import init_deepfm

torch.set_num_threads(2)

LANE = tpack.LANE
# the persistent grid of the H100 (2 blocks on each of 132 SMs), a small
# grid, and one block
LAGS = [264, 5, 1]
# the scale is a sum, taken in another order by each version
SCALE_RTOL = 1e-5


def deepfm_layout():
    """DeepFM's 11 leaves in the resident layout, K = 8 (39 fields as in
    the paper, 40 features each, embed 10, MLP 400-400-400)."""
    one = init_deepfm(torch.Generator().manual_seed(0), 39 * 40, 39, 10,
                      (400, 400, 400))
    stacked = tree_map(lambda x: torch.empty((8,) + tuple(x.shape),
                                             device="meta"), one)
    spec = tpack.make_spec(stacked, stacked=True,
                           block_rows=tpack.BLOCK_ROWS, leaf_align=True)
    ranges = tpack.leaf_row_ranges(spec)
    assert len(ranges) == 11
    return 8, spec.rows * LANE, tuple((a * LANE, b * LANE)
                                      for a, b in ranges), spec.sizes


def rows(ranges):
    return tuple((a * LANE, b * LANE) for a, b in ranges)


# (K, n elements a worker, segment bounds, true counts); None: all true
LAYOUTS = {
    "deepfm_11_leaves": deepfm_layout,
    "one_segment": lambda: (8, 3 * tsc.TILE + 384,
                            ((0, 3 * tsc.TILE + 384),), None),
    "k1_flat": lambda: (1, 5 * tsc.TILE + 7, ((0, 5 * tsc.TILE + 7),),
                        None),
    "zero_row_segments": lambda: (3, 776 * LANE, rows(
        ((0, 0), (0, 256), (256, 768), (768, 768), (768, 776))), None),
    "ragged_last_tile": lambda: (2, 300 * LANE, rows(
        ((0, 100), (100, 300))), (12_000, 25_600)),
}


def decoded(sch):
    """[(k, t, pass)] of the items, in list order."""
    T = len(sch.tile_start)
    return [((code >> 1) // T, (code >> 1) % T, code & 1)
            for code in sch.items]


def positions(sch, K):
    """{(k, s): ([A positions], [B positions with their tiles])}."""
    out = {(k, s): ([], []) for k in range(K)
           for s in range(len(sch.seg_first) - 1)}
    for at, (k, t, p) in enumerate(decoded(sch)):
        out[k, sch.tile_seg[t]][p].append((at, t))
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("lag", LAGS)
def test_each_tile_is_one_a_and_one_b_item(layout, lag):
    K, n, bounds, _ = LAYOUTS[layout]()
    sch = tsc.schedule(bounds, K, lag)
    T = len(sch.tile_start)
    want = sorted((k, t, p) for k in range(K) for t in range(T)
                  for p in (0, 1))
    assert sorted(decoded(sch)) == want
    assert len(sch.items) == 2 * K * T


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tiles_cover_each_segment_and_its_counter_target(layout):
    """The tiles of segment s are seg_first[s]:seg_first[s + 1], cover its
    bounds in order with at most TILE elements each, and their count, the
    value its counter must reach (the kernel reads it from seg_first), is
    the number of A items of the segment for every worker."""
    K, n, bounds, _ = LAYOUTS[layout]()
    sch = tsc.schedule(bounds, K, LAGS[0])
    assert len(sch.seg_first) == len(bounds) + 1 and sch.seg_first[0] == 0
    for s, (a, b) in enumerate(bounds):
        tiles = range(sch.seg_first[s], sch.seg_first[s + 1])
        assert all(sch.tile_seg[t] == s for t in tiles)
        edges = [a] + [sch.tile_end[t] for t in tiles]
        assert [sch.tile_start[t] for t in tiles] == edges[:-1]
        assert edges[-1] == b
        assert all(0 < sch.tile_end[t] - sch.tile_start[t] <= tsc.TILE
                   for t in tiles)
        assert len(tiles) == -(-(b - a) // tsc.TILE)
    for (k, s), (a_pos, _) in positions(sch, K).items():
        assert len(a_pos) == sch.seg_first[s + 1] - sch.seg_first[s]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("lag", LAGS)
def test_a_items_precede_b_items_which_descend(layout, lag):
    K, n, bounds, _ = LAYOUTS[layout]()
    sch = tsc.schedule(bounds, K, lag)
    for (k, s), (a_pos, b_pos) in positions(sch, K).items():
        if not a_pos:
            assert not b_pos
            continue
        assert max(at for at, _ in a_pos) < min(at for at, _ in b_pos)
        # A ascending, B descending, each segment's B items together
        assert [t for _, t in a_pos] == sorted(t for _, t in a_pos)
        assert [t for _, t in b_pos] == sorted((t for _, t in b_pos),
                                               reverse=True)
        assert [at for at, _ in b_pos] == list(range(
            b_pos[0][0], b_pos[0][0] + len(b_pos)))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("lag", LAGS)
def test_b_items_lag_the_last_a_item(layout, lag):
    """At least ``lag`` items lie between a segment's last A item and its
    first B item, unless no A item is left to put there; and the work runs
    worker by worker: the A items come in worker and segment order."""
    K, n, bounds, _ = LAYOUTS[layout]()
    sch = tsc.schedule(bounds, K, lag)
    items = decoded(sch)
    last_a = max(at for at, it in enumerate(items) if it[2] == 0)
    for (k, s), (a_pos, b_pos) in positions(sch, K).items():
        if a_pos:
            gap = b_pos[0][0] - a_pos[-1][0] - 1
            assert gap >= lag or b_pos[0][0] > last_a
    order = [(k, sch.tile_seg[t], t) for k, t, p in items if p == 0]
    assert order == sorted(order)


def run_items(sch, x, hat, K, n_trues):
    """The kernel's work list run in list order, in numpy f32: an A item
    writes q and its tile's sum; the last A item of a segment takes the
    scale from the tile sums (each of 256 threads sums a stride of them in
    tile order, then the threads' sums are added); a B item applies it."""
    T, L = len(sch.tile_start), len(sch.seg_first) - 1
    x, hat = x.reshape(K, -1), hat.reshape(K, -1)
    q = np.zeros(x.shape, np.int8)
    out = np.full(x.shape, np.nan, np.float32)
    partials = np.zeros((K, T), np.float32)
    scales = np.zeros((K, L), np.float32)
    arrived = np.zeros((K, L), int)
    for code in sch.items:
        k, t = divmod(code >> 1, T)
        s = sch.tile_seg[t]
        a, b = sch.tile_start[t], sch.tile_end[t]
        if code & 1 == 0:
            d = x[k, a:b] - hat[k, a:b]
            q[k, a:b] = np.sign(d)
            partials[k, t] = np.abs(d).sum(dtype=np.float32)
            arrived[k, s] += 1
            first, last = sch.seg_first[s], sch.seg_first[s + 1]
            if arrived[k, s] == last - first:
                part = partials[k, first:last]
                lanes = [part[i::256].sum(dtype=np.float32)
                         for i in range(256)]
                scales[k, s] = (np.float32(sum(lanes, np.float32(0)))
                                / np.float32(max(n_trues[s], 1)))
        else:
            assert arrived[k, s] == sch.seg_first[s + 1] - sch.seg_first[s]
            out[k, a:b] = hat[k, a:b] + scales[k, s] * q[k, a:b]
    return q, scales, out


def inputs(K, n, bounds, n_trues, seed):
    """x and hat with differences far from 0, zero past each segment's
    true count (the resident layout's padding)."""
    rng = np.random.default_rng(seed)
    hat = rng.standard_normal((K, n)).astype(np.float32)
    d = rng.uniform(0.01, 1.0, (K, n)) * rng.choice([-1.0, 1.0], (K, n))
    x = (hat + d).astype(np.float32)
    if n_trues is not None:
        for (a, b), t in zip(bounds, n_trues):
            x[:, a + t:b] = 0.0
            hat[:, a + t:b] = 0.0
    return x, hat


@pytest.mark.parametrize("layout", LAYOUTS)
def test_running_the_list_matches_the_plain_version(layout):
    K, n, bounds, n_trues = LAYOUTS[layout]()
    x, hat = inputs(K, n, bounds, n_trues, seed=3)
    true = (n_trues if n_trues is not None
            else tuple(b - a for a, b in bounds))
    sch = tsc.schedule(bounds, K, LAGS[1])
    q, scales, out = run_items(sch, x, hat, K, true)
    if layout == "k1_flat":
        want = tsc.sign_compress_plain(*map(torch.from_numpy, (x[0],
                                                               hat[0])))
        want = (want[0][None], want[1].reshape(1, 1), want[2][None])
    else:
        rr = tuple((a // LANE, b // LANE) for a, b in bounds)
        want = tsc.sign_compress_stacked_plain(
            *(torch.from_numpy(v.reshape(K, -1, LANE)) for v in (x, hat)),
            n_true=true, row_ranges=rr)
    np.testing.assert_array_equal(q, want[0].reshape(K, -1).numpy())
    np.testing.assert_allclose(scales, want[1].numpy(), rtol=SCALE_RTOL,
                               atol=0)
    slack = float(np.abs(scales).max()) * SCALE_RTOL
    np.testing.assert_allclose(out, want[2].reshape(K, -1).numpy(),
                               rtol=1e-6, atol=1e-6 + slack)


def test_running_the_list_matches_the_jax_kernel():
    """One worker's DeepFM segments, leaf by leaf, against the JAX
    package's ``sign_compress_stacked`` on each leaf slice (interpret
    mode): q equal, the scale and the new hat at the f32 tolerance."""
    K, n, bounds, n_trues = deepfm_layout()
    x, hat = inputs(1, n, bounds, n_trues, seed=4)
    q, scales, out = run_items(tsc.schedule(bounds, 1, 5), x, hat, 1,
                               n_trues)
    for s, ((a, b), t) in enumerate(zip(bounds, n_trues)):
        leaf = lambda v: jnp.asarray(v[:, a:b].reshape(1, -1, LANE))
        jq, jscale, jhat = jsc.sign_compress_stacked(
            leaf(x), leaf(hat), n_true=t, block_rows=tpack.BLOCK_ROWS,
            interpret=True)
        np.testing.assert_array_equal(q[:, a:b].reshape(jq.shape),
                                      np.asarray(jq))
        np.testing.assert_allclose(scales[:, s], np.asarray(jscale),
                                   rtol=2e-5, atol=0)
        np.testing.assert_allclose(out[:, a:b].reshape(jhat.shape),
                                   np.asarray(jhat), rtol=2e-5, atol=2e-5)


def step_grid(sch, blocks: int, resident: int):
    """Step ``blocks`` blocks through the list as the kernel hands it out,
    ``resident`` of them running at a time (the others start as running
    ones exit): a block claims an item when it starts and the next one as
    it begins each item, finishes an A item in one step and a B item in
    one step once its segment's A items are all done (the last one takes
    the scale as it finishes). Returns the steps taken; raises if a step
    passes in which no block advanced."""
    T = len(sch.tile_start)
    n_items = len(sch.items)
    need = {}
    for code in sch.items:
        k, t = divmod(code >> 1, T)
        s = sch.tile_seg[t]
        need[k, s] = need.get((k, s), 0) + (code & 1 == 0)
    done = dict.fromkeys(need, 0)
    counter = 0
    waiting = list(range(blocks))
    running = {}                     # block -> [current item, claimed next]
    steps = 0
    while waiting or running:
        while waiting and len(running) < resident:
            running[waiting.pop(0)] = [counter, None]
            counter += 1
        moved = False
        for blk, held in list(running.items()):
            cur = held[0]
            if cur >= n_items:
                del running[blk]
                moved = True
                continue
            if held[1] is None:      # the claim one item ahead
                held[1] = counter
                counter += 1
            k, t = divmod(sch.items[cur] >> 1, T)
            key = (k, sch.tile_seg[t])
            if sch.items[cur] & 1 == 0:
                done[key] += 1
            elif done[key] < need[key]:
                continue
            running[blk] = [held[1], None]
            moved = True
        if not moved:
            raise AssertionError(f"no block advanced at step {steps}")
        steps += 1
    return steps


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("blocks,resident", [(264, 264), (6, 6), (6, 2),
                                             (1, 1)])
def test_the_grid_always_finishes(layout, blocks, resident):
    K, n, bounds, _ = LAYOUTS[layout]()
    sch = tsc.schedule(bounds, K, blocks)
    steps = step_grid(sch, blocks, resident)
    assert steps <= len(sch.items) + blocks


def test_device_tables_hold_the_schedule():
    K, n, bounds, n_trues = LAYOUTS["zero_row_segments"]()
    true = tuple(b - a for a, b in bounds)
    tabs, T, n_items = tsc.device_tables(bounds, true, K,
                                         torch.device("cpu"), 7)
    # the B items lag LAG_GRIDS grids of 7 blocks
    sch = tsc.schedule(bounds, K, tsc.LAG_GRIDS * 7)
    start, end, seg, first, div, items = tabs
    assert T == len(sch.tile_start) and n_items == 2 * K * T
    assert start.dtype == end.dtype == torch.int64
    assert seg.dtype == first.dtype == items.dtype == torch.int32
    assert tuple(items.tolist()) == sch.items
    assert tuple(first.tolist()) == sch.seg_first
    # an empty segment divides by 1: its scale is 0 / 1
    assert div.tolist() == [float(max(t, 1)) for t in true]
    assert tsc.device_tables(bounds, true, K, torch.device("cpu"),
                             7)[0] is tabs
