"""The whole-block kernel's work list (`csrc/lgb_block.cu`), on the CPU.

`lgteun_tpu_torch.ops.lgb_block_kernel.lgb_schedule` computes the list's
numbers, which the wrapper passes to the kernel: the items of each kind
an image (LN items, mixer planes, window items, tail items), and
`lgb_work_list` / `lgb_item_needs` spell out the order in which the
kernel hands the items out and the per-image counters each waits on.
These tests hold those numbers to the shapes, check that every item's
dependencies stand before it in the list, and simulate k blocks that
take items in list order and block on unmet counters: the list must run
to its end for any k (one block included), and every item must start
only after the items that wrote what it reads, worked out here from the
geometry (pixels, windows, tiles and their halo), not from the kernel's
per-image rule.
"""

from __future__ import annotations

import heapq

import numpy as np
import pytest

from lgteun_tpu_torch.ops.lgb_block_kernel import (KINDS, _schedule_ints,
                                                   lgb_attention_branch,
                                                   lgb_item_needs,
                                                   lgb_schedule,
                                                   lgb_work_list)

# (C, H, W): the UnlgFormer block shapes, the scene engine's, and a
# 16-band model's bottleneck (the wide tail)
SHAPES = ((32, 128, 128), (64, 64, 64), (32, 144, 144), (64, 72, 72),
          (128, 32, 32))


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@pytest.mark.parametrize("heads", (2, 4))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("b", (1, 4, 16))
def test_schedule_counts(b, shape, heads):
    c, h, w = shape
    s = lgb_schedule(b, c, h, w, heads, 8)
    per = s["per_image"]
    nwin, tiles = (h // 8) * (w // 8), (h // 8) * (w // 8)
    branch = lgb_attention_branch(c // 2, heads, 8)
    assert s["branch"] == branch
    assert per["planes"] == c // 2
    ln_px = s["ln_px"]
    # 512-2048 pixels an item, about 128 items in all where there are enough
    assert ln_px in (512, 1024, 1536, 2048)
    assert ln_px == 512 or b * h * w >= ln_px * 128
    assert ln_px == 2048 or b * h * w < (ln_px + 512) * 128
    assert per["ln"] == ceil_div(h * w, ln_px)
    if branch == "tc":   # (window, head) pairs, about 128 / (C/2) an item
        assert s["pairs"] == nwin * heads
        assert s["per_item"] % 2 == 0 and 2 <= s["per_item"] <= 16
        assert s["per_item"] == {16: 8, 32: 4, 64: 2}.get(c // 2,
                                                          s["per_item"])
        assert per["windows"] == ceil_div(nwin * heads, s["per_item"])
    else:                # one window an item
        assert s["pairs"] == nwin
        assert s["per_item"] == 1
        assert per["windows"] == nwin
    assert per["tails"] == tiles   # one tile an item
    # at C <= 32 each pair of a block's warpgroups takes tail items
    assert s["tail_workers"] == (2 if c <= 32 else 1)
    # every pixel and pair in exactly one item
    assert (per["ln"] - 1) * ln_px < h * w <= per["ln"] * ln_px
    group = s["per_item"]
    assert (per["windows"] - 1) * group < s["pairs"] <= per["windows"] * group
    items = lgb_work_list(s)
    assert len(items) == b * sum(per.values())
    assert len(set(items)) == len(items)
    # the 7 numbers the kernel takes, in LgbSchedule's order
    assert _schedule_ints(s) == [per["ln"], per["planes"], per["windows"],
                                 per["tails"], ln_px, s["pairs"],
                                 s["per_item"]]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("b", (1, 4))
def test_dependencies_precede(b, shape):
    s = lgb_schedule(b, *shape)
    items = lgb_work_list(s)
    first = {}
    last = {}
    for i, (kind, image, _j) in enumerate(items):
        first.setdefault((kind, image), i)
        last[kind, image] = i
    for i, (kind, image, _j) in enumerate(items):
        for (dkind, dimage), count in lgb_item_needs(s, kind, image).items():
            assert count == s["per_image"][dkind]
            assert last[dkind, dimage] < i, (kind, image, dkind)
    # the kinds in KINDS order, images in order within a kind
    assert [k for k, _b, _j in items] == sorted(
        (k for k, _b, _j in items), key=KINDS.index)


def writes(s: dict, h: int, w: int, heads: int, kind: str, j: int) -> set:
    """What item j of `kind` of one image writes: pixels of y1/y2 (LN),
    a plane of x2 (planes), windows of x1 (windows)."""
    if kind == "ln":
        n = s["ln_px"]
        return {("px", p) for p in range(j * n, min(h * w, (j + 1) * n))}
    if kind == "planes":
        return {("plane", j)}
    if kind == "windows":
        if s["branch"] == "tc":
            n = s["per_item"]
            pairs = range(j * n, min(s["pairs"], (j + 1) * n))
            return {("win", p // heads, p % heads) for p in pairs}
        return {("win", j, hh) for hh in range(heads)}
    return set()


def reads(s: dict, c: int, h: int, w: int, heads: int, kind: str,
          j: int) -> set:
    """What item j of `kind` of one image reads of the scratch."""
    wx = w // 8
    if kind == "planes":   # the whole plane of y2: every pixel's LN
        return {("px", p) for p in range(h * w)}
    if kind == "windows":
        n = s["per_item"]
        wins = ({p // heads for p in range(j * n, min(
            s["pairs"], (j + 1) * n))} if s["branch"] == "tc" else {j})
        return {("px", (wi // wx * 8 + y) * w + wi % wx * 8 + x)
                for wi in wins for y in range(8) for x in range(8)}
    if kind == "tails":    # x1 at the tile's halo pixels, x2 every plane
        need = {("plane", ch) for ch in range(c // 2)}
        ty, tx = j // wx, j % wx
        for y in range(ty * 8 - 1, ty * 8 + 9):
            for x in range(tx * 8 - 1, tx * 8 + 9):
                if 0 <= y < h and 0 <= x < w:
                    need |= {("win", y // 8 * wx + x // 8, hh)
                             for hh in range(heads)}
        return need
    return set()


def simulate(s: dict, items: list, workers: int, seed: int, check=None):
    """k blocks take the items in list order, each blocking until the
    counters its item needs are reached, then run it for a random time;
    a block that takes its first tail item becomes s["tail_workers"]
    workers (at C <= 32 its second pair of warpgroups takes an item of its
    own then). Returns the items' (start, end) times; raises on a
    deadlock. `check` (item, finished items) is called as each item
    starts."""
    rng = np.random.default_rng(seed)
    done = {}                   # (kind, image) -> items ended
    ended = set()
    nxt = 0
    running = []                # heap of (end time, worker, item index)
    waiting = {}                # worker -> item index
    idle = list(range(workers))
    split = set()               # blocks whose second pair has joined
    now = 0.0
    times = {}

    def ready(i):
        kind, image, _j = items[i]
        return all(done.get(key, 0) >= n for key, n in
                   lgb_item_needs(s, kind, image).items())

    while True:
        for wk in list(idle):   # idle workers take the next items
            if nxt < len(items):
                waiting[wk] = nxt
                nxt += 1
                idle.remove(wk)
                if (items[waiting[wk]][0] == "tails" and wk < workers
                        and s["tail_workers"] == 2 and wk not in split):
                    split.add(wk)
                    idle.append(workers + wk)   # its second pair
        for wk, i in sorted(waiting.items()):
            if ready(i):
                del waiting[wk]
                if check:
                    check(items[i], ended)
                heapq.heappush(running, (now + rng.uniform(0.5, 2.0), wk, i))
                times[i] = [now, None]
        if not running:
            if waiting:
                raise RuntimeError(f"deadlock: {len(waiting)} workers wait, "
                                   f"item {min(waiting.values())} of "
                                   f"{len(items)}")
            return times
        now, wk, i = heapq.heappop(running)
        kind, image, j = items[i]
        done[kind, image] = done.get((kind, image), 0) + 1
        ended.add(items[i])
        times[i][1] = now
        idle.append(wk)


CASES = ((1, 32, 128, 128, 2), (4, 64, 64, 64, 2), (2, 128, 32, 32, 2),
         (2, 32, 64, 64, 4), (3, 32, 40, 48, 2))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("workers", (1, 2, 3, 17))
def test_simulated_blocks_finish_in_dependency_order(workers, case):
    b, c, h, w, heads = case
    s = lgb_schedule(b, c, h, w, heads, 8)
    items = lgb_work_list(s)
    written = {}                # (image, what) -> the item that writes it
    for item in items:
        kind, image, j = item
        for what in writes(s, h, w, heads, kind, j):
            assert (image, what) not in written
            written[image, what] = item

    def check(item, ended):
        kind, image, j = item
        for what in reads(s, c, h, w, heads, kind, j):
            assert written[image, what] in ended, (item, what)

    times = simulate(s, items, workers, seed=workers * 1000 + b, check=check)
    assert len(times) == len(items)
    if workers == 1:            # one block runs the list strictly in order
        starts = [times[i][0] for i in range(len(items))]
        assert starts == sorted(starts)
        # one item at a time; in the tail at C <= 32 one on each pair
        for i in range(len(items)):
            inflight = 1 + sum(times[k][0] <= times[i][0] < times[k][1]
                               for k in range(i))
            assert inflight <= (s["tail_workers"]
                                if items[i][0] == "tails" else 1)


@pytest.mark.parametrize("workers", (1, 3))
def test_simulation_finds_a_list_out_of_order(workers):
    """The simulation is able to fail: tail items moved before the window
    items deadlock with few blocks."""
    s = lgb_schedule(1, 32, 64, 64)
    items = lgb_work_list(s)
    tails = [it for it in items if it[0] == "tails"]
    bad = [it for it in items if it[0] != "tails"]
    at = next(i for i, it in enumerate(bad) if it[0] == "windows")
    bad = bad[:at] + tails + bad[at:]
    with pytest.raises(RuntimeError, match="deadlock"):
        simulate(s, bad, workers, seed=0)
