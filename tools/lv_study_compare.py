#!/usr/bin/env python3
"""Hold a port run of the Lotka-Volterra noise study to the JAX study's archive, lane by lane.

    python3 tools/lv_study_compare.py build/lv_study/loop_study.npz [--replay-combo]

Reads the port's ``loop_study.npz`` (written by
``python -m universal_differential_equations_torch.examples.run_loops``) and
the JAX study's ``examples/lotka_volterra/results/loop_study.npz``, and
prints for each arm the exact rates per noise level of both, the lanes whose
two equations select the same active sets (in all and per level), and the
lanes where the exact flags agree; for the oracle and weak arms, every lane
that disagrees with both supports.  With ``--replay-combo`` it runs the
port's combo playoff on the CPU for the lanes whose combo selection
disagrees, from the JAX archive's own trained and weak coefficients, and
reports on how many it then selects the archive's active sets.  Imports no
JAX.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JAX_ARCHIVE = ROOT / "examples" / "lotka_volterra" / "results" / "loop_study.npz"
ARMS = (("trained", ""), ("sr3", "_sr3"), ("sr3d", "_sr3d"), ("oracle", "_oracle"),
        ("weak", "_weak"), ("combo", "_combo"))


def same_sets(p, j, suf):
    return (((p["coef1" + suf] != 0) == (j["coef1" + suf] != 0)).all(1)
            & ((p["coef2" + suf] != 0) == (j["coef2" + suf] != 0)).all(1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("port_archive")
    ap.add_argument("--replay-combo", action="store_true")
    args = ap.parse_args()
    import numpy as np

    p, j = dict(np.load(args.port_archive)), dict(np.load(JAX_ARCHIVE))
    n_levels, runs = j["exact"].shape
    for arm, suf in ARMS:
        ex = "exact" + suf
        same = same_sets(p, j, suf)
        rate = lambda z: "/".join(f"{100 * v:.0f}" for v in z[ex].mean(1))  # noqa: E731
        print(f"{arm:8s} exact % port {rate(p)} | JAX {rate(j)} | same active sets "
              f"{int(same.sum())}/{same.size} (per level "
              f"{same.reshape(n_levels, runs).sum(1).tolist()}) | exact flags equal "
              f"{int((p[ex] == j[ex]).sum())}/{p[ex].size}")
        if arm in ("oracle", "weak"):
            for i in np.nonzero(~same)[0]:
                sup = lambda z, k: np.nonzero(z[k + suf][i])[0].tolist()  # noqa: E731
                print(f"  lane {i}: port {sup(p, 'coef1')} / {sup(p, 'coef2')}, JAX "
                      f"{sup(j, 'coef1')} / {sup(j, 'coef2')}")
    if args.replay_combo:
        import torch

        sys.path.insert(0, str(ROOT))
        from universal_differential_equations_torch.examples import run_loops as rl

        lanes = np.nonzero(~same_sets(p, j, "_combo"))[0]
        if not lanes.size:
            return
        st = rl.build_stages(device="cpu")
        data, _, mags = st.lane_inputs(lanes, runs)
        coef = lambda k: torch.as_tensor(j[k][lanes])  # noqa: E731
        _, _, c1, c2 = st.combo_stage(data, mags, coef("coef1"), coef("coef2"),
                                      coef("coef1_weak"), coef("coef2_weak"))
        ok = (((c1.numpy() != 0) == (j["coef1_combo"][lanes] != 0)).all(1)
              & ((c2.numpy() != 0) == (j["coef2_combo"][lanes] != 0)).all(1))
        print(f"combo replayed on the CPU from the JAX archive's trained and weak "
              f"coefficients, on the {lanes.size} lanes that disagreed: {int(ok.sum())} select "
              f"the archive's active sets; still apart: {lanes[~ok].tolist()}")


if __name__ == "__main__":
    main()
