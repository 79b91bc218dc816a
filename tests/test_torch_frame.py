"""tpurt_torch's frame-pass pieces against tpurt's, on the CPU: the
plain versions of the three kernels of the wavefront, persist and film
paths (kernels/compact.py, refill.py, film_fold.py), the per-frame-size
order cache, and a persist render whose pool regenerates.

  * packet_compact_plain: array-equal to tpurt's _compact_packets, the
    slice to the kept packets and trace_chunk_staged's packet-row commit
    (tpurt/wavefront.py:313-317), on every field and on rad_out; with a
    slot permuted row by row, against tpurt's row commit (commit_rows);
  * persist_refill_plain: array-equal to a numpy transcription of
    tpurt/wavefront.py:496-516 on every slot field (the new rays through
    the port's camera, their streams through tpurt's make_streams), the
    film within 1e-6 (both add in slot order; tpurt's scatter-add may
    not);
  * film_fold_plain: array-equal to tpurt's fold (render.py:167-170);
  * order_cached: equal to tpurt's _order_pad_cached arrays;
  * a c4-scene persist render that regenerates: tpurt's rays, iteration
    count and occupancy.
The CUDA kernels are held against these plain versions on the card by
chip_smoke.py's ``frame`` phase.
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt import config as jconfig  # noqa: E402
from tpurt import render as jrender  # noqa: E402
from tpurt import rng as jrng  # noqa: E402
from tpurt import wavefront as jwave  # noqa: E402
from tpurt_torch import config as tconfig  # noqa: E402
from tpurt_torch import render as trender  # noqa: E402
from tpurt_torch import scene as tscene  # noqa: E402
from tpurt_torch import wavefront as twave  # noqa: E402
from tpurt_torch.kernels import compact, refill  # noqa: E402
from tpurt_torch.kernels import film_fold as fold_k  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

F32 = np.float32


def _queue_arrays(rs, alive, permuted=False):
    """Random queue fields of len(alive) rows; slot keeps packets whole
    (a packet's rows come from one packet of the first queue), or with
    ``permuted`` is any permutation of the rows."""
    n = alive.shape[0]
    pk = n // 128
    slot = (rs.permutation(n) if permuted else
            (rs.permutation(pk)[:, None] * 128 + np.arange(128)).reshape(-1))
    return dict(
        o=rs.normal(size=(n, 3)).astype(F32),
        d=rs.normal(size=(n, 3)).astype(F32),
        atten=rs.uniform(size=(n, 3)).astype(F32),
        rad=rs.uniform(size=(n, 3)).astype(F32),
        pix=rs.randint(0, 5000, n).astype(np.int32),
        key=rs.randint(0, 2 ** 32, (3, n), dtype=np.uint64),
        alive=alive, slot=slot)


def _mask(case, pk, rs):
    n = pk * 128
    if case == "all_dead":
        return np.zeros(n, bool), 0
    if case == "all_live":
        return np.ones(n, bool), pk
    if case == "last_packet":
        alive = np.zeros(n, bool)
        alive[-3] = True
        return alive, 1
    if case == "keep_over_live":
        # 3 live packets, the last one among them; 8 kept, so 5 dead
        # packets follow them in the kept queue
        alive = np.zeros(n, bool)
        for p in (2, 9, pk - 1):
            alive[p * 128 + rs.randint(0, 128)] = True
        return alive, 8
    # ragged (and permuted_slot): 5 of 16 packets hold a live ray, 6 are
    # kept
    alive = np.zeros(n, bool)
    for p in rs.choice(pk, 5, replace=False):
        alive[p * 128 + rs.randint(0, 128, 3)] = True
    return alive, 6


COMPACT_CASES = ["all_dead", "all_live", "last_packet", "ragged",
                 "keep_over_live", "permuted_slot"]


@pytest.mark.parametrize("case", COMPACT_CASES)
def test_packet_compact_plain_equals_tpurt(case):
    """permuted_slot: the slot is a permutation of rows, not of whole
    packets (the kernel must not assume a packet's slots are 128
    consecutive values), so tpurt's row commit is the reference."""
    rs = np.random.RandomState(COMPACT_CASES.index(case))
    pk = 16
    alive, keep = _mask(case, pk, rs)
    a = _queue_arrays(rs, alive, permuted=case == "permuted_slot")
    tq = twave.Queue(**{k: torch.from_numpy(v.astype(np.int64) if k in (
        "key", "slot") else v) for k, v in a.items()})
    rad_out = torch.zeros((pk * 128, 3))
    got = compact.packet_compact_plain(tq, rad_out, keep)

    jq = jwave.Queue(**{k: jnp.asarray(v.astype(np.uint32) if k == "key"
                                       else v.astype(np.int32)
                                       if k == "slot" else v)
                        for k, v in a.items()})
    jq = jwave._compact_packets(jq)
    b = keep * 128
    if case == "permuted_slot":
        # rows [b:] home one by one (tpurt/wavefront.py:182)
        j_out = jwave.commit_rows(jnp.zeros((pk * 128, 3), jnp.float32),
                                  jq.rad[b:], jq.slot[b:])
    else:
        # tpurt/wavefront.py:313-317: rows [b:] home as packet rows
        spk = jq.slot[b::128] // 128
        j_out = jnp.zeros((pk, 384), jnp.float32).at[spk].set(
            jq.rad[b:].reshape(-1, 384))
    np.testing.assert_array_equal(rad_out.numpy(),
                                  np.asarray(j_out).reshape(-1, 3))
    for field in twave.Queue._fields:
        want = np.asarray(getattr(jq, field))
        want = want[:, :b] if field == "key" else want[:b]
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), want.astype(
                getattr(got, field).numpy().dtype), err_msg=field)


@pytest.fixture(scope="module")
def small_cam():
    cfg = tconfig.RenderConfig(width=32, height=16, scene="spheres_plane")
    return tconfig.build_scene(cfg)[1]


def _np_refill(st, counter, frame):
    """tpurt/wavefront.py:496-516 in numpy on a pool state (dict of
    arrays), with the new rays' o and d from the port's camera (held
    against tpurt's elsewhere) and their streams from tpurt's
    make_streams. Returns (state, counter, the refilled slots)."""
    st = {k: v.copy() for k, v in st.items()}
    table = frame.pixel_table.numpy()
    npix_chunk = table.shape[0]
    bounce = np.where(st["live_hit"], st["depth"] + 1, st["depth"])
    alive = st["alive"] & (bounce < frame.max_depth)
    dead = ~alive
    rank = np.cumsum(dead.astype(np.int64)) - 1
    new_r = counter + rank
    fill = dead & (new_r < frame.total)
    np.add.at(st["film"], st["pix"][fill], st["rad"][fill])
    smp = frame.sample_lo + new_r // npix_chunk
    pix2 = table[np.where(fill, new_r % npix_chunk, 0)]
    o2, d2, _ = refill.camera_k.camera_rays_plain(
        frame.cam, frame.width, frame.height, frame.seed,
        torch.from_numpy(pix2), torch.from_numpy(smp))
    streams2 = np.asarray(jrng.make_streams(frame.seed, pix2, smp))
    st["o"] = np.where(fill[:, None], o2.numpy(), st["o"])
    st["d"] = np.where(fill[:, None], d2.numpy(), st["d"])
    st["pix"] = np.where(fill, pix2, st["pix"])
    st["streams"] = np.where(fill[None, :], streams2.astype(np.int64),
                             st["streams"])
    st["atten"] = np.where(fill[:, None], F32(1.0), st["atten"])
    st["rad"] = np.where(fill[:, None], F32(0.0), st["rad"])
    st["depth"] = np.where(fill, 0, bounce)
    st["alive"] = alive | fill
    return st, counter + int(fill.sum()), fill


# (counter, total, cap): every dead slot refills; the counter runs out
# among them; nothing is left to hand out; a pool that ends inside a
# block of the kernel (refill.SLOTS slots) and inside a warp; every slot
# dies in the step; total runs out inside a warp of the third block
REFILL_CASES = {"all_refill": (300, 5000, 256), "runs_out": (980, 1000, 256),
                "exhausted": (1000, 1000, 256),
                "ragged_cap": (300, 5000, 2 * refill.SLOTS + 77),
                "all_die": (300, 5000, 3 * refill.SLOTS),
                "out_in_warp": (300, None, 4 * refill.SLOTS)}


@pytest.mark.parametrize("case", sorted(REFILL_CASES))
def test_persist_refill_plain_equals_tpurt(case, small_cam):
    counter0, total, cap = REFILL_CASES[case]
    rs = np.random.RandomState(len(case))
    npix = 32 * 16
    table = rs.permutation(npix)[:100].astype(np.int64)
    live_hit = rs.uniform(size=cap) < 0.7
    alive = live_hit & (rs.uniform(size=cap) < 0.6)
    if case == "all_die":
        alive[:] = False
    if total is None:
        # the cut falls on the 10th dead slot of the third block's warp 5
        dead_at = np.flatnonzero(~alive)
        third = dead_at[dead_at >= 2 * refill.SLOTS + 5 * 32]
        total = counter0 + int(np.searchsorted(dead_at, third[9]))
    frame = refill.Frame(small_cam, 32, 16, 7, torch.from_numpy(table), 3,
                         total, 5)
    st = dict(
        film=rs.uniform(size=(npix, 3)).astype(F32),
        o=rs.normal(size=(cap, 3)).astype(F32),
        d=rs.normal(size=(cap, 3)).astype(F32),
        atten=rs.uniform(size=(cap, 3)).astype(F32),
        rad=rs.uniform(size=(cap, 3)).astype(F32),
        alive=alive,
        live_hit=live_hit,
        depth=rs.randint(0, 5, cap).astype(np.int64),
        # few pixels: slots of one pixel die together
        pix=rs.choice(table[:8], cap).astype(np.int64),
        streams=rs.randint(0, 2 ** 32, (3, cap)).astype(np.int64))
    want, want_counter, fill = _np_refill(st, counter0, frame)
    t = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    counter = torch.tensor([counter0])
    live = torch.zeros(1, dtype=torch.int32)
    refill.persist_refill_plain(frame, t["film"], t["o"], t["d"],
                                t["atten"], t["rad"], t["alive"],
                                t["live_hit"], t["depth"], t["pix"],
                                t["streams"], counter, live)
    assert int(counter) == want_counter
    assert int(live) == int(want["alive"].sum())
    for k in ("o", "d", "atten", "rad", "alive", "depth", "pix", "streams"):
        np.testing.assert_array_equal(t[k].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(t["film"].numpy(), want["film"], rtol=0,
                               atol=1e-6)
    if case == "exhausted":
        assert not fill.any()
    else:
        # two slots of one pixel died and refilled in this step
        assert np.bincount(st["pix"][fill]).max() >= 2
    if case == "all_die":
        assert fill.all()
    if case == "out_in_warp":
        # the last refilled slot and the first dead one left without a
        # ray share a warp
        last = np.flatnonzero(fill)[-1]
        first_left = np.flatnonzero(~want["alive"])[0]
        assert last // 32 == first_left // 32 and last < first_left


@pytest.mark.parametrize("c", [1, 3])
def test_film_fold_plain_equals_tpurt(c):
    """tpurt's fold: old + rad.reshape(c, block, 3).sum(axis=0); the port
    sums the sample planes in order, the same additions."""
    rs = np.random.RandomState(c)
    block = 384
    rad = rs.uniform(size=(c * block, 3)).astype(F32)
    old = rs.uniform(size=(block, 3)).astype(F32)
    want = np.asarray(jnp.asarray(old) + jnp.asarray(rad).reshape(
        c, block, 3).sum(axis=0))
    acc = torch.from_numpy(old.copy())
    fold_k.film_fold(acc, torch.from_numpy(rad), c, block)
    np.testing.assert_array_equal(acc.numpy(), want)
    # the ragged last block: its first m rows only
    part = torch.from_numpy(old[:100].copy())
    fold_k.film_fold(part, torch.from_numpy(rad), c, block)
    np.testing.assert_array_equal(part.numpy(), want[:100])


@pytest.mark.parametrize("width,height,block", [(64, 48, 2048),
                                               (1280, 720, 1 << 19),
                                               (50, 37, 1024)])
def test_order_cache_equals_tpurt(width, height, block):
    pix, valid, inv = trender.order_cached(width, height, block, "cpu")
    j_pix, j_valid, j_inv = jrender._order_pad_cached(width, height, block)
    np.testing.assert_array_equal(pix.numpy(), np.asarray(j_pix))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(j_inv))
    assert trender.order_cached(width, height, block, "cpu")[0] is pix


def test_persist_render_regenerates_as_tpurt():
    """c4's scene cut to subdiv 2, 96x54 at 2 spp through pools of 2,048
    slots (each block's 4,096 rays regenerate): tpurt's rays and
    occupancy; and the first block's pool takes tpurt's iterations."""
    kw = dict(mesh_subdiv=2, width=96, height=54, spp=2, ray_batch=2048,
              mode="persist")
    jcfg = jconfig.PRESETS["c4-wavefront"].replace(**kw)
    tcfg = tconfig.PRESETS["c4-wavefront"].replace(**kw)
    _, js = jrender.render(jcfg)
    _, ts = trender.render(tcfg, device="cpu")
    assert ts["rays"] == js["rays"]
    assert ts["occupancy"] == js["occupancy"]

    jscene, jcam = jconfig.build_scene(jcfg)
    tsc, tcam = tconfig.build_scene(tcfg)
    tsc = tscene.to_device(tsc, "cpu")
    order = trender.tile_order(96, 54)[:2048]
    _, jrays, _, jiters = jwave.trace_persistent(
        jscene.device(), jcam, jnp.zeros((96 * 54, 3), jnp.float32),
        jnp.asarray(order), jnp.int32(0), jnp.int32(2), jnp.uint32(11),
        96, 54, tcfg.max_depth, tcfg.rr_start, 2048)
    _, trays, _, titers = twave.trace_persistent(
        tsc, tcam, torch.zeros((96 * 54, 3)),
        torch.from_numpy(order.astype(np.int64)), 0, 2, 11, 96, 54,
        tcfg.max_depth, tcfg.rr_start, 2048)
    assert trays == int(jrays)
    assert titers == int(jiters)
    assert trays > 2048 * 2     # rays beyond the first fill: it regenerated


@pytest.mark.parametrize("mode", ["wavefront", "persist"])
def test_smoke_frame_check_on_a_cpu_render(mode):
    """chip_smoke.FrameCheck and FusedCheck (the card's frame phase)
    around a small CPU render whose queue shrinks or whose pool
    regenerates: every wrapped call runs and compares, the film within
    film_bound, every bounce's packet flags in mode wavefront, and the
    wrappers are restored; the phase's permuted-slot compaction runs on
    the kept shrink."""
    # 36-packet queues shrink; 1,024-slot pools take 3,072 rays a block
    cfg = tconfig.RenderConfig(width=48, height=32, spp=3, max_depth=6,
                               rr_start=2, seed=4, scene="spheres_plane",
                               ray_batch=4608 if mode == "wavefront"
                               else 1024, mode=mode)
    wrapped = (fold_k.film_fold, compact.packet_compact,
               refill.persist_refill, refill.persist_commit)
    with chip_smoke.FusedCheck("cpu") as fused, \
            chip_smoke.FrameCheck("cpu") as chk:
        # the host loop, whose wrapper calls the checks see (a graph's
        # schedule passes fixed out buffers), as the frame phase renders
        _, rays = chip_smoke.host_frame(cfg)
    assert (fold_k.film_fold, compact.packet_compact, refill.persist_refill,
            refill.persist_commit) == wrapped
    _, mega = trender.render(cfg.replace(mode="mega"), device="cpu")
    assert rays == mega["rays"]
    if mode == "wavefront":
        assert chk.stats["film_fold"]["calls"] > 0
        assert chk.stats["film_fold"]["bit_diffs"] == 0
        assert chk.stats["packet_compact"]["calls"] > 0
        q, rad_out, keep, flags, live_pk = chk.kept["packet_compact"]
        assert keep > 0 and 0 < live_pk == int(flags.sum()) <= keep
        bounces = fused.stats["bounce_shade"]
        assert bounces["flag_calls"] == bounces["calls"] > 0
        res = chip_smoke.check_permuted_slot(q, rad_out, keep,
                                             (flags, live_pk))
        assert res[f"keep_{keep}"]["bit_diffs"] == 0
        assert res["keep_0"]["rows_home"] == q.o.shape[0]
    else:
        st = chk.stats["persist_refill"]
        assert st["calls"] > 0 and st["refills"] > 0
        assert st["film_diffs"] == 0
        assert "film_fold" not in chk.stats    # the pool adds into the film
        assert chk.stats["persist_commit"]["calls"] > 0
        frame, before, refills, scan = chk.kept["persist_refill"]
        assert refills == st["most_refills"] > 0
        assert len(before) == 12
        # the pool's scan state, as trace_persistent passed it
        assert len(scan) == 1 and scan[0].dtype == torch.int64
        pools = chip_smoke.check_refill_pools("cpu")
        assert set(pools) == set(chip_smoke.REFILL_POOLS)
        assert all(p["calls"] == 3 and p["refills"] > 0
                   and p["bit_diffs"] == 0 for p in pools.values())


def test_wrappers_run_plain_on_cpu_and_raise_elsewhere(small_cam,
                                                       monkeypatch):
    """On CPU tensors each wrapper is its plain version, takes the card's
    extra arguments (packet flags and count, the scan state) and launches
    nothing; tensors on another device (meta) make it raise, never fall
    back. On a card the compaction raises without its packet flags or on
    a base pointer off 16 bytes, and the refill without its scan state,
    before any launch (shown with meta tensors let through as a card's)."""
    from tpurt_torch.kernels import _build
    _build.reset_launches()
    rs = np.random.RandomState(9)
    rad = torch.from_numpy(rs.uniform(size=(2 * 256, 3)).astype(F32))
    acc = torch.zeros((200, 3))
    fold_k.film_fold(acc, rad, 2, 256)
    assert torch.equal(acc, rad[:200] + rad[256:456])
    a = _queue_arrays(rs, rs.uniform(size=256) < 0.01)
    q = twave.Queue(**{k: torch.from_numpy(v.astype(np.int64) if k in (
        "key", "slot") else v) for k, v in a.items()})
    flags = q.alive.reshape(2, 128).any(dim=1)
    rad_out = torch.zeros((256, 3))
    kept = compact.packet_compact(q, rad_out, 1, flags, int(flags.sum()))
    want_out = torch.zeros((256, 3))
    want = compact.packet_compact_plain(q, want_out, 1)
    assert all(torch.equal(g, w) for g, w in zip(kept, want))
    assert torch.equal(rad_out, want_out)
    rad_out.zero_()
    assert compact.packet_compact(q, rad_out, 0).o.shape == (0, 3)
    assert torch.equal(rad_out[q.slot], q.rad)
    film = torch.zeros((512, 3))
    refill.persist_commit(film, q.slot, q.rad)
    assert torch.equal(film[q.slot], q.rad)
    assert all(v == 0 for v in _build.LAUNCHES.values())
    meta = {k: v.to("meta") for k, v in q._asdict().items()}
    with pytest.raises(ValueError):
        fold_k.film_fold(acc.to("meta"), rad.to("meta"), 2, 256)
    with pytest.raises(ValueError):
        compact.packet_compact(twave.Queue(**meta), rad_out.to("meta"), 1,
                               flags.to("meta"), 1)
    with pytest.raises(ValueError):
        refill.persist_commit(film.to("meta"), meta["slot"], meta["rad"])
    frame = refill.Frame(small_cam, 32, 16, 7, torch.arange(100), 0, 100, 5)
    state = (film.to("meta"), meta["o"], meta["d"], meta["atten"],
             meta["rad"], meta["alive"], meta["alive"], meta["slot"],
             meta["slot"], meta["key"], meta["slot"][:1],
             torch.zeros(1, dtype=torch.int32, device="meta"))
    scan = refill.scan_state(256, "meta")
    with pytest.raises(ValueError):
        refill.persist_refill(frame, *state, scan)
    # CPU: the plain version, with or without the scan state
    cpu_state = (film, q.o, q.d, q.atten, q.rad, q.alive, q.alive, q.slot,
                 q.slot, q.key, torch.tensor([0]),
                 torch.zeros(1, dtype=torch.int32))
    got = [t.clone() for t in cpu_state]
    want = [t.clone() for t in cpu_state]
    refill.persist_refill(frame, *got, refill.scan_state(256, "cpu"))
    refill.persist_refill_plain(frame, *want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(got[-1]) > 0 and _build.LAUNCHES["persist_refill"] == 0

    # meta tensors let through as a card's: the checks before the launch
    monkeypatch.setattr(_build, "cuda_device", lambda kernel, t: t.device)

    def launch(*args):
        raise AssertionError("launched")

    monkeypatch.setattr(_build, "launch", launch)
    mq = twave.Queue(**meta)
    with pytest.raises(ValueError, match="packet_flags"):
        compact.packet_compact(mq, rad_out.to("meta"), 1)
    with pytest.raises(ValueError, match="packet_flags"):
        compact.packet_compact(mq, rad_out.to("meta"), 1, flags.to("meta"))
    off = torch.empty(256 * 3 + 1, device="meta")[1:].view(256, 3)
    for name in ("o", "rad"):
        with pytest.raises(ValueError, match="aligned"):
            compact.packet_compact(mq._replace(**{name: off}),
                                   rad_out.to("meta"), 1, flags.to("meta"),
                                   1)
    odd_flags = torch.empty(3, dtype=torch.bool, device="meta")[1:]
    with pytest.raises(ValueError, match="aligned"):
        compact.packet_compact(mq, rad_out.to("meta"), 1, odd_flags, 1)
    with pytest.raises(AssertionError, match="launched"):
        compact.packet_compact(mq, rad_out.to("meta"), 1, flags.to("meta"),
                               1)
    with pytest.raises(ValueError, match="scan_state"):
        refill.persist_refill(frame._replace(
            pixel_table=frame.pixel_table.to("meta")), *state)
