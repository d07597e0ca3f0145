"""Cut a saved K2 call down to the tile of its worst element: the fixture
of ``tests/test_torch_k2_chain.py``.

    python scripts/port_k2_fixture.py chiprun_out/k2_holds/<call>.npz \
        tests/fixtures/port_k2/<name>.npz

The input is what ``chip_smoke.py``'s K2 hold or
``scripts/port_k2_hold_sweep.py`` saves for a call that failed (the
kernel's inputs, its geometry, the card's kernel gradients ``d_kernel`` and
the card's float32 plain gradients ``d_plain``). The float64 oracle
(``rasterize_cuda.composite_backward_f64``) is evaluated here on the CPU;
the tile that holds the element where the card's float32 plain version
used the most of K2's gate is kept as a one-tile slab (its ``tile_offset``
in the frame), with the whole call's largest |gradient| of each row
(``row_max``: the gate's absolute part) and rows 0-9 of both card outputs.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

ROWS = 10


def main(src: str, dst: str) -> int:
    from chip_smoke import k2_shares
    from dreamgaussian_tpu_torch.ops import rasterize_cuda as rc

    z = np.load(src)
    geo = {k: int(z[k]) for k in ("grid_x", "num_tiles", "chunk", "tile", "tile_offset")}
    args = [torch.from_numpy(z[k]) for k in ("dup_feat", "chunk_starts", "n_chunks", "fwd_out",
                                             "g_out")]
    exact = rc.composite_backward_f64(*args, **geo)[:ROWS]
    plain = torch.from_numpy(z["d_plain"][:ROWS]).double()
    row_max = exact.abs().amax(1)
    tol = 1e-4 * exact.abs() + 1e-5 * row_max[:, None]
    used = (plain - exact).abs() / tol.clamp_min(1e-300)
    worst = int(used.amax(0).argmax())
    cs, nc = z["chunk_starts"], z["n_chunks"]
    chunk = geo["chunk"]
    t = next(t for t in range(len(cs)) if cs[t] * chunk <= worst < (cs[t] + nc[t]) * chunk)
    cols = slice(int(cs[t]) * chunk, int(cs[t] + nc[t]) * chunk)
    feat = np.zeros((16, (int(nc[t]) + 1) * chunk), np.float32)
    feat[5] = rc.Q_SENTINEL
    feat[:, :int(nc[t]) * chunk] = z["dup_feat"][:, cols]
    out = {"dup_feat": feat, "chunk_starts": np.zeros(1, np.int32),
           "n_chunks": nc[t:t + 1].astype(np.int32), "fwd_out": z["fwd_out"][t:t + 1],
           "g_out": z["g_out"][t:t + 1], "d_kernel": z["d_kernel"][:ROWS, cols],
           "d_plain": z["d_plain"][:ROWS, cols], "row_max": row_max.numpy(),
           "grid_x": geo["grid_x"], "num_tiles": 1, "chunk": chunk, "tile": geo["tile"],
           "tile_offset": geo["tile_offset"] + t}
    Path(dst).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(dst, **{k: np.asarray(v) for k, v in out.items()})
    shares = {name: [round(x, 4) for x in k2_shares(torch.from_numpy(z[name][:ROWS]).double(),
                                                    exact)]
              for name in ("d_kernel", "d_plain")}
    print(f"tile {t} of {len(cs)} ({int(nc[t])} chunks, largest n_contrib "
          f"{int(z['fwd_out'][t, 5].max())}); the whole call's shares of the gate against "
          f"float64 per row: {shares}; wrote {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
