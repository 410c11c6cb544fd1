"""Generate scripts/_torch_volume_drill_golden.json: what the port's volume
drill writes at `--scale smoke` when its campaign runs uninterrupted on
the CPU (`scripts/torch_volume_drill.py --mode campaign --scale smoke
--device cpu`, PYTHONHASHSEED 0): the SHA-256 of every output file, and of
each relation parquet its row count, the SHA-256 of its identity columns
and overlap, and its distance, yaw and pitch values. A killed and resumed
campaign on the card is held to it file for file, the parquets by their
columns with the limits chip_smoke.py holds the card's relations to
against the CPU's (phase 15: overlap exact, a distance within DIST_ULP
ulp, an angle difference within 2 * ANGLE_ULP ulp of 180 or 90 degrees in
the column's dtype: the card's atan2 and sums of squares round apart).

    python scripts/gen_drill_golden.py            # write the file
    python scripts/gen_drill_golden.py --check    # exit 1 if it differs
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRILL = os.path.join(REPO, "scripts", "torch_volume_drill.py")
OUT = os.path.join(REPO, "scripts", "_torch_volume_drill_golden.json")
PARQUETS = ("indices/frame_relations.parquet",
            "indices/frame_relations_nonzero.parquet")
# chip_smoke.py's card-vs-CPU relation limits (phase 15)
ANGLE_ULP, DIST_ULP = 8, 2
EXACT = ("scene_id", "image_id1", "image_id2", "overlap")
NEAR = ("distance", "yaw", "pitch")


def relation_columns(path: str) -> dict:
    """A relation parquet as the golden holds it: rows, the SHA-256 of
    each exact column, the values (and dtype) of the others."""
    import pandas as pd

    df = pd.read_parquet(path)
    exact = {}
    for c in EXACT:
        v = np.asarray(df[c])
        data = ("\n".join(map(str, v)).encode() if v.dtype == object
                else v.tobytes())
        exact[c] = hashlib.sha256(f"{v.dtype}".encode() + data).hexdigest()
    return {"rows": len(df), "columns": sorted(df.columns), "exact": exact,
            "dtype": str(np.asarray(df["yaw"]).dtype),
            "near": {c: [float(x) for x in np.asarray(df[c])] for c in NEAR}}


def summary(root: str) -> dict:
    """The golden's record of a drill root: `digests` of every data file
    but the parquets, and `parquets` by `relation_columns`."""
    sys.path.insert(0, os.path.dirname(DRILL))
    from torch_volume_drill import output_digests

    digests = output_digests(root)
    return {"digests": {k: v for k, v in digests.items()
                        if k not in PARQUETS},
            "parquets": {k: relation_columns(os.path.join(root, "out", k))
                         for k in PARQUETS}}


def limits(want: dict) -> dict:
    """Each near column's absolute limits, from the reference values."""
    kind = np.dtype(want["dtype"]).type
    dist = np.asarray(want["near"]["distance"], dtype=kind)
    n = len(dist)
    return {"distance": DIST_ULP * np.spacing(np.abs(dist)).astype(float),
            "yaw": np.full(n, 2 * ANGLE_ULP * float(np.spacing(kind(180)))),
            "pitch": np.full(n, 2 * ANGLE_ULP * float(np.spacing(kind(90))))}


def differences(got: dict, want: dict) -> list[str]:
    """What differs between two summaries (the near columns past their
    limits)."""
    out = []
    g, w = got["digests"], want["digests"]
    out += [f"missing {k}" for k in sorted(set(w) - set(g))]
    out += [f"extra {k}" for k in sorted(set(g) - set(w))]
    out += [f"differs {k}" for k in sorted(set(g) & set(w)) if g[k] != w[k]]
    for k, wp in want["parquets"].items():
        gp = got["parquets"][k]
        for key in ("rows", "columns", "dtype"):
            if gp[key] != wp[key]:
                out.append(f"differs {k}: {key} {gp[key]} != {wp[key]}")
        out += [f"differs {k}: column {c}" for c in EXACT
                if gp["exact"][c] != wp["exact"][c]]
        if gp["rows"] != wp["rows"]:
            continue
        for c, lim in limits(wp).items():
            a, b = np.asarray(gp["near"][c]), np.asarray(wp["near"][c])
            gap = np.where(np.isnan(a) & np.isnan(b), 0.0, np.abs(a - b))
            if not (gap <= lim).all():
                i = int(np.argmax(~(gap <= lim)))
                out.append(f"differs {k}: {c} row {i} {a[i]!r} vs {b[i]!r}")
    return out


def load() -> dict:
    with open(OUT) as f:
        return json.load(f)


def generate() -> dict:
    with tempfile.TemporaryDirectory() as root:
        subprocess.run([sys.executable, DRILL, "--mode", "campaign",
                        "--scale", "smoke", "--device", "cpu", "--root",
                        root], check=True, capture_output=True,
                       env=dict(os.environ, PYTHONHASHSEED="0"))
        return summary(root)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    fresh = generate()
    if args.check:
        diff = differences(fresh, load())
        print("\n".join(diff) if diff else
              f"equal: {len(fresh['digests'])} files and the parquets")
        return 1 if diff else 0
    with open(OUT, "w") as f:
        json.dump(fresh, f, indent=0, sort_keys=True)
        f.write("\n")
    print(f"wrote {OUT}: {len(fresh['digests'])} files")
    return 0


if __name__ == "__main__":
    sys.exit(main())
