"""Fig. 7's three arms (ridge; coded = encoded L-BFGS, replication and
uncoded GD) through ``experiments.run --workloads ridge``, the port on the
CPU against the JAX package, at the ``bench`` preset (the paper's m = 32,
k = 24 at n = 1024, p = 512) with 2 realizations.

At the ``paper`` preset with 32 realizations the final suboptimality gaps
(f - f*, about 0.3-0.5 on f about 96.7) agree to rel 6.7e-5, 1.22e-4 and
1.11e-4 on a CPU (ROADMAP.md, Queue 3): the gap cancels about 300x, so
the float32 rounding of f (sums in another order, a few ulps) reaches
the gap 300x larger.  This test holds the mechanism at a size a test can run: the
simulated times bit for bit, every objective entry to rel 1e-5, f* the
same, so the gaps differ by the objectives' difference and nothing else.
"""
import numpy as np


def test_fig7_arms_gaps_differ_by_objective_rounding(tmp_path, capsys):
    from repro.experiments.run import main as j_main
    from repro_torch.experiments.run import main as p_main
    args = ["--workloads", "ridge", "--preset", "bench", "--strategies",
            "coded,replication,uncoded", "--trials", "2", "--formats",
            "json"]
    ref = j_main(args + ["--out", str(tmp_path / "j")]).records
    out = p_main(args + ["--out", str(tmp_path / "p"), "--device",
                         "cpu"]).records
    capsys.readouterr()
    assert [r["strategy"] for r in out] == [r["strategy"] for r in ref] == [
        "coded-lbfgs", "replication", "uncoded"]
    for p, j in zip(out, ref):
        assert p["times"] == j["times"]
        po, jo = np.asarray(p["objective"]), np.asarray(j["objective"])
        assert np.max(np.abs(po - jo) / np.abs(jo)) <= 1e-5
        pm, jm = np.asarray(p["metric"]), np.asarray(j["metric"])
        # gap = f - f*: the same f* on both sides
        fstar_p, fstar_j = po[:, -1] - pm[:, -1], jo[:, -1] - jm[:, -1]
        assert np.max(np.abs(fstar_p - fstar_j)) <= 1e-6 * np.max(
            np.abs(jo[:, -1]))
        d_gap = p["final_metric"] - j["final_metric"]
        d_f = p["final_objective"] - j["final_objective"]
        assert abs(d_gap - d_f) <= 1e-6 * abs(j["final_objective"])
