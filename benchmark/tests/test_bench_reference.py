"""The frozen plain reference agrees with the port on the CPU at a small
size: one tracking step's stages (DPT, encoders, update module, lookup,
DBA and DSPO solves, depth filter) and the mapper's first train steps."""

from benchmark.tests import tiny


def test_tracking_stages_agree(monkeypatch):
    tiny.small_dpt(monkeypatch)
    res = tiny.run("replica-track")
    got = {k: v["value"] for k, v in res["checked"].items()}
    assert set(got) == {"dpt", "fnet", "cnet", "update", "lookup", "dba",
                        "dspo", "depth_filter"}
    # the port computes float32 on the CPU; only the lookup's output is
    # rounded to bf16 (2^-8 relative at most)
    for name, v in got.items():
        assert v <= (4e-3 if name == "lookup" else 1e-5), (name, v)
    assert res["correct"]


def test_mapper_steps_agree():
    res = tiny.run("replica-map")
    got = {k: v["value"] for k, v in res["checked"].items()}
    assert set(got) == {"loss", "grad", "change", "loss.color",
                        "grad.color", "change.color"}
    assert max(got.values()) <= 1e-5, got
    assert res["correct"]
