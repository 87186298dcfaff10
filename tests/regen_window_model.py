"""A model on the CPU of the window sweep of the regeneration sweep
adjoints (csrc/regen_window.cuh: window_sweep, the body of B11's
regen_window_kernel and B13's dyn_regen_window_kernel) and of their
per-pixel checking builds (regen_body.cuh: regen_sweep_chunk), shared by
tests/test_torch_regen_sweep_window.py and
tests/test_torch_dyn_regen_sweep_window.py.

Both schedules run over the same rows with the same statements, in
float32 without fused multiply-add, one accumulator column a pixel: the
per-pixel order (each pixel's chunks in order, its segments in row
order, the rows read from the arrays) and the window kernel's (each
warp's rows copied in windows into a ring, swept in rounds of a segment
a lane). A family is its decoder of the row word (`table_decode`,
`dyn_decode`), which says a row's table rows, whether it is live,
whether Russian roulette was on and whether it starts a sample."""

import numpy as np
import torch

from drt_tpu_torch.ops.regen import WINDOW_ROWS, ring_windows

BLOCK, WARP = 128, 32


def table_decode(code):
    """The scene-table family's rmeta = best | want << 8 | rr_on << 9,
    with code i64[shapes] the window kernel's word per shape (albedo row
    + 1 | emission row + 1 << 8, 0 for a sentinel row)."""
    def decode(meta):
        best = meta & 0xFF
        cd = code[(best - 1).clamp(0, code.shape[0] - 1)]
        arow = torch.where(best > 0, (cd & 255) - 1, -1)
        erow = torch.where(best > 0, ((cd >> 8) & 255) - 1, -1)
        return (arow, erow, best > 0, ((meta >> 9) & 1) > 0,
                ((meta >> 8) & 1) > 0)

    return decode


def dyn_decode(n_alb, n_emi):
    """The memory-resident family's rrow = albedo row | emission row << 8
    | live << 16 | want << 17 | rr_on << 18 (dyn_regen_adjoint.cu:
    RowDecode); a table's last row is its sentinel (-1 here)."""
    def decode(pack):
        ar, er = pack & 255, (pack >> 8) & 255
        return (torch.where(ar < n_alb - 1, ar, -1),
                torch.where(er < n_emi - 1, er, -1),
                ((pack >> 16) & 1) > 0, ((pack >> 18) & 1) > 0,
                ((pack >> 17) & 1) > 0)

    return decode


def segments(m, t, t_act, read, tabs, g, acc, dmax, inv_keep):
    """One sample's segment of each lane in m, from its row t (a want
    row) of its t_act rows, replayed and swept into acc[E, lanes] by the
    statements of regen_sweep_chunk / window_segment, a lane per column.
    read(rows, mask) -> (sc, meta) at each lane's row; tabs = (alb, emi,
    decode), decode(meta) -> (arow, erow, live, rr_on, want) of the
    family's row word. Returns each lane's segment length (0 outside
    m)."""
    alb, emi, decode = tabs
    n_alb = alb.shape[0]
    lanes = torch.arange(m.shape[0])

    def rows_of(tab, row, fill):
        return torch.where(row >= 0, tab[row.clamp(min=0)].T, fill)

    one = torch.tensor(1.0, dtype=torch.float32)
    zero = torch.tensor(0.0, dtype=torch.float32)
    inv_keep = torch.tensor(inv_keep, dtype=torch.float32)
    _, meta = read(t, m)
    T = torch.ones((3, m.shape[0]), dtype=torch.float32)
    steps, length, is_open = [], torch.zeros_like(t), m.clone()
    for k in range(dmax):
        on = is_open
        if not on.any():
            break
        arow, erow, live, rr_on, _ = decode(meta)
        sc, _ = read(t + k, on)
        gate = torch.where(live, torch.where(rr_on, inv_keep, one), zero)
        P = T * gate
        T = torch.where(on, P * rows_of(alb, arow, 1.0) * sc, T)
        steps.append((on, P, sc, gate, arow, erow))
        length = torch.where(on, k + 1, length)
        more = on & (t + k + 1 < t_act)
        _, nxt = read(t + k + 1, more)
        meta = torch.where(more, nxt, meta)
        is_open = more & ~decode(meta)[4]
    S = torch.zeros((3, m.shape[0]), dtype=torch.float32)
    for on, P, sc, gate, arow, erow in reversed(steps):
        e = rows_of(emi, erow, 0.0)
        a = rows_of(alb, arow, 1.0)
        gP = g * P
        for ch in range(3):
            ke = on & (erow >= 0)
            ie = (n_alb - 1) * 3 + erow[ke] * 3 + ch
            acc[ie, lanes[ke]] = acc[ie, lanes[ke]] + gP[ch][ke]
            ka = on & (arow >= 0)
            ia = arow[ka] * 3 + ch
            acc[ia, lanes[ka]] = (acc[ia, lanes[ka]]
                                  + gP[ch][ka] * sc[ka] * S[ch][ka])
        S = torch.where(on, (e + a * sc * S) * gate, S)
    return length


def dmax_of(depth):
    return 8 if depth <= 8 else 32


def per_pixel_columns(cfg, rsc, rmeta, trips, tabs, g):
    """The checking build's order: each pixel's chunks in order, its
    segments in row order, the rows read from the arrays themselves."""
    C, cap, n = rsc.shape
    alb, emi, _ = tabs
    E = (alb.shape[0] - 1 + emi.shape[0] - 1) * 3
    acc = torch.zeros((E, n), dtype=torch.float32)
    inv_keep = np.float32(1.0 / (1.0 - cfg.absorb_prob))
    pix = torch.arange(n)
    for c in range(C):
        tr = trips[c].long()

        def read(row, mask):
            at = row.clamp(max=cap - 1)
            sc, meta = rsc[c, at, pix], rmeta[c, at, pix].long()
            assert torch.isfinite(sc[mask]).all() and (meta[mask] >= 0).all()
            return sc, meta

        t = torch.zeros(n, dtype=torch.long)
        while (t < tr).any():
            m = t < tr
            t = t + segments(m, t, tr, read, tabs, g, acc,
                              dmax_of(cfg.max_depth), inv_keep)
    return acc


def window_columns(cfg, rsc, rmeta, trips, tabs, g):
    """The window kernel's schedule, warp by warp of each 128-pixel group
    and chunk by chunk: window v (rows [v W, v W + W) of the warp's 32
    pixels, a lane's only below its trips) copied into slots r % ROWS,
    the windows landing in order as ring_wait lets them; in rounds, each
    lane sweeps its next segment once the rows of every lane's next
    segment have landed (from t to t + max_depth, or all of its own), or,
    where the ring cannot take the window that needs, the lanes whose
    rows have; window v is copied once every lane still at work is past
    window v - WINDOWS. Every read is checked against the row the slot
    holds and whether it has landed. Returns the columns and (rounds run,
    samples a warp's lanes have)."""
    C, cap, n = rsc.shape
    alb, emi, _ = tabs
    E = (alb.shape[0] - 1 + emi.shape[0] - 1) * 3
    W, D = WINDOW_ROWS, cfg.max_depth
    windows = ring_windows(D)
    ROWS = windows * W
    groups = -(-n // BLOCK)
    acc = torch.zeros((E, groups * BLOCK), dtype=torch.float32)
    rounds = [0, 0]  # the warps' rounds, and the samples of their chunks
    inv_keep = np.float32(1.0 / (1.0 - cfg.absorb_prob))
    lane = torch.arange(WARP)
    for grp in range(groups):
        for c in range(C):
            for w0 in range(BLOCK // WARP):
                pix = grp * BLOCK + w0 * WARP + lane
                ok = pix < n
                tr = torch.where(ok, trips[c, pix.clamp(max=n - 1)].long(),
                                 0)
                n_win = -(-int(tr.max()) // W)
                ring_sc = torch.full((ROWS, WARP), float("nan"))
                ring_meta = torch.full((ROWS, WARP), -1, dtype=torch.long)
                tag = torch.full((ROWS, WARP), -1, dtype=torch.long)
                arrived = torch.ones((ROWS, WARP), dtype=torch.bool)
                pending = []

                def copy(v):
                    slots = []
                    for k in range(W):
                        r = v * W + k
                        s = r % ROWS
                        on = r < tr
                        at = min(r, cap - 1)
                        src = pix.clamp(max=n - 1)
                        ring_sc[s] = torch.where(on, rsc[c, at, src], 0.0)
                        ring_meta[s] = torch.where(
                            on, rmeta[c, at, src].long(), 0)
                        tag[s] = torch.where(on, r, -2)
                        arrived[s] = False
                        slots.append(s)
                    pending.append(slots)

                def wait(allowed):
                    while len(pending) > allowed:
                        arrived[pending.pop(0)] = True

                def read(row, mask):
                    s = row % ROWS
                    held = (tag[s, lane] == row) & arrived[s, lane]
                    assert held[mask].all(), "a row the ring does not hold"
                    sc, meta = ring_sc[s, lane], ring_meta[s, lane]
                    assert torch.isfinite(sc[mask]).all()
                    return sc, meta

                def may_copy(v, t_min):
                    return v < n_win and (v - windows + 1) * W <= t_min

                def lagging(t):
                    return int(torch.where(t < tr, t, 1 << 30).min())

                copied, landed = 0, 0
                while copied < min(n_win, windows):
                    copy(copied)
                    copied += 1
                t = torch.zeros(WARP, dtype=torch.long)
                col = torch.zeros((E, WARP), dtype=torch.float32)
                col[:] = acc[:, grp * BLOCK + w0 * WARP + lane]
                while (t < tr).any():
                    work = t < tr
                    need = int(torch.where(work, torch.minimum(
                        t + D + 1, tr), 0).max())
                    while landed * W < need:
                        if landed == copied:
                            if not may_copy(copied, lagging(t)):
                                break
                            copy(copied)
                            copied += 1
                        wait(copied - landed - 1)
                        landed += 1
                    top = landed * W
                    m = work & ((t + D < top) | (top >= tr))
                    assert m[t == lagging(t)].all(), "the last lane waits"
                    rounds[0] += 1
                    t = t + segments(m, t, tr, read, tabs,
                                      g[:, pix.clamp(max=n - 1)], col,
                                      dmax_of(D), inv_keep)
                    while may_copy(copied, lagging(t)):
                        copy(copied)
                        copied += 1
                rounds[1] += int(tr.gt(0).any()) * (
                    cfg.spp // cfg.spp_chunks)
                assert (t == tr).all(), "rows left unswept"
                acc[:, grp * BLOCK + w0 * WARP + lane] = col
    return acc[:, :n], rounds


