"""Device-routing cost model (runtime/costmodel.py) — the Amdahl A/B
turned into policy: --engine tpu must never lose to the native plane,
because work is dispatched to the device only when the device's own
measured model predicts a win."""

import dataclasses
import datetime
import json
import pathlib

import pytest

from alignasm_tpu.config import DEFAULT_CONFIG
from alignasm_tpu.runtime.costmodel import DeviceCostModel, load_model
from alignasm_tpu.testing.synth import generate_paf

# a complete, fresh calibration measured on the test device ("cpu")
FIELDS = {
    "dispatch_rtt_s": 0.026, "h2d_bytes_per_s": 50e6,
    "d2h_bytes_per_s": 14e6, "solve_s_per_record": 6.1e-7,
    "solve_s_per_contig_min": 2e-6, "finish_vs_solve": 1.07,
    "device_s_per_contig": 1.7e-6, "device_s_per_step": 2e-6,
}


def _cal(device_kind="cpu", days=30, **over):
    today = datetime.date.today()
    return {**FIELDS, **over,
            "_meta": {"date": today.isoformat(),
                      "stale_after": (today + datetime.timedelta(days=days))
                      .isoformat(),
                      "device_kind": device_kind, "method": "unit"}}


def test_default_model_routes_nothing():
    """With no calibration for the device there is no model and auto
    routing sends nothing to it; a model whose finish_vs_solve >= 1 (the
    device-assisted finish costs MORE than the full native solve it
    replaces) means no bucket can ever win — corpus-independent."""
    from alignasm_tpu.runtime.scheduler import _routing

    assert _routing(DEFAULT_CONFIG, None) == ("auto", False)
    m = DeviceCostModel(**FIELDS)
    assert not m.any_possible_win()
    assert _routing(DEFAULT_CONFIG, m) == ("auto", False)
    # even an absurdly favorable bucket loses with finish_vs_solve >= 1
    assert not m.bucket_profitable(
        n_contigs=10**6, V=64, wire_bytes=1, row_bytes=1,
        sum_records=10**7)


def test_calibrated_model_can_route(tmp_path, monkeypatch):
    """On hardware where the finish is cheaper than the solve it
    replaces (a real DP-dominated regime), the model routes buckets
    whose saved work exceeds the transport cost."""
    cal = tmp_path / "cal.json"
    cal.write_text(json.dumps(_cal(
        finish_vs_solve=0.2, dispatch_rtt_s=2e-5,
        h2d_bytes_per_s=8e9, d2h_bytes_per_s=8e9,
    )))
    monkeypatch.setenv("ALIGNASM_TPU_COSTMODEL", str(cal))
    m = load_model()
    assert m.any_possible_win()
    # a large bucket saves real work...
    assert m.bucket_profitable(n_contigs=4096, V=64, wire_bytes=400_000,
                               row_bytes=270_000, sum_records=70_000)
    # ...a single tiny contig does not cover even a 20 us dispatch
    assert not m.bucket_profitable(n_contigs=1, V=8, wire_bytes=100,
                                   row_bytes=10, sum_records=4)


def test_model_rejects_unknown_fields(tmp_path, monkeypatch):
    cal = tmp_path / "bad.json"
    cal.write_text(json.dumps(_cal(finish_vs_solve=0.5, typo_field=1)))
    monkeypatch.setenv("ALIGNASM_TPU_COSTMODEL", str(cal))
    with pytest.raises(ValueError, match="typo_field"):
        load_model()
    # a partial artifact has no defaults to fall back on
    partial = {k: v for k, v in _cal().items() if k != "device_s_per_step"}
    cal.write_text(json.dumps(partial))
    with pytest.raises(ValueError, match="device_s_per_step"):
        load_model()


def test_calibration_from_another_device_rejected(tmp_path, monkeypatch):
    """A calibration is a measurement of one device: an artifact whose
    _meta.device_kind differs from the running device (or names none)
    never steers routing — the committed artifact is ignored with the
    reason recorded, an operator override raises."""
    from alignasm_tpu.runtime import costmodel

    monkeypatch.delenv("ALIGNASM_TPU_COSTMODEL", raising=False)
    art = tmp_path / "calibration.json"
    monkeypatch.setattr(costmodel, "CALIBRATION_PATH", str(art))
    art.write_text(json.dumps(_cal(device_kind="NVIDIA H100 80GB HBM3",
                                   finish_vs_solve=0.2)))
    m, prov = costmodel.load_model_info()          # running on "cpu"
    assert m is None
    assert prov["source"] == "none" and prov["device_kind"] == "cpu"
    assert "measured on 'NVIDIA H100 80GB HBM3'" in prov["note"]
    m, prov = costmodel.load_model_info("NVIDIA H100 80GB HBM3")
    assert m.finish_vs_solve == 0.2 and prov["source"] == "artifact"

    raw = _cal(finish_vs_solve=0.2)
    del raw["_meta"]["device_kind"]
    art.write_text(json.dumps(raw))
    m, prov = costmodel.load_model_info()
    assert m is None and "no _meta.device_kind" in prov["note"]

    env_cal = tmp_path / "op.json"
    env_cal.write_text(json.dumps(_cal(device_kind="other")))
    monkeypatch.setenv("ALIGNASM_TPU_COSTMODEL", str(env_cal))
    with pytest.raises(ValueError, match="measured on 'other'"):
        costmodel.load_model_info()


def test_calibration_artifact_used_when_fresh(tmp_path, monkeypatch):
    """The committed artifact (regenerated by `devbench --calibrate`)
    is consumed on its own device when fresh per its own
    _meta.stale_after, with dated provenance."""
    from alignasm_tpu.runtime import costmodel

    monkeypatch.delenv("ALIGNASM_TPU_COSTMODEL", raising=False)
    art = tmp_path / "calibration.json"
    art.write_text(json.dumps(_cal(device_kind="testkind",
                                   finish_vs_solve=1.11,
                                   dispatch_rtt_s=0.031)))
    monkeypatch.setattr(costmodel, "CALIBRATION_PATH", str(art))
    m, prov = costmodel.load_model_info("testkind")
    assert m.finish_vs_solve == 1.11 and m.dispatch_rtt_s == 0.031
    assert prov["source"] == "artifact"
    assert prov["age_days"] == 0
    assert prov["device_kind"] == "testkind"


def test_stale_or_absent_calibration_falls_back(tmp_path, monkeypatch):
    """A stale, absent, torn, or drifted artifact must NEVER silently
    steer the gate: there is no model (auto routes to the native plane),
    with the reason recorded in the provenance."""
    from alignasm_tpu.runtime import costmodel

    monkeypatch.delenv("ALIGNASM_TPU_COSTMODEL", raising=False)
    art = tmp_path / "calibration.json"

    monkeypatch.setattr(costmodel, "CALIBRATION_PATH", str(art))
    m, prov = costmodel.load_model_info()          # absent
    assert m is None and prov["source"] == "none"

    raw = _cal(finish_vs_solve=0.2)
    raw["_meta"].update(date="2026-01-01", stale_after="2026-02-01")
    art.write_text(json.dumps(raw))
    m, prov = costmodel.load_model_info()          # stale
    assert m is None
    assert "stale since 2026-02-01" in prov["note"]

    raw = _cal(finish_vs_solve=0.2)
    del raw["_meta"]["stale_after"]
    art.write_text(json.dumps(raw))
    m, prov = costmodel.load_model_info()          # no shelf life declared
    assert m is None and "stale_after" in prov["note"]

    art.write_text("{torn")
    m, prov = costmodel.load_model_info()          # unparsable
    assert m is None and prov["source"] == "none"

    # corruption classes: a truthy non-dict _meta, non-string dates, and
    # a non-object root must all fall back, never raise
    art.write_text(json.dumps({**FIELDS, "_meta": "2026-08-20"}))
    m, prov = costmodel.load_model_info()
    assert m is None and prov["source"] == "none"

    raw = _cal(finish_vs_solve=0.2)
    raw["_meta"]["stale_after"] = 5
    art.write_text(json.dumps(raw))
    m, prov = costmodel.load_model_info()
    assert m is None and "unparsable" in prov["note"]

    art.write_text(json.dumps([1, 2, 3]))
    m, prov = costmodel.load_model_info()
    assert m is None and prov["source"] == "none"

    art.write_text(json.dumps(_cal(days=9, finish_vs_solve=0.2,
                                   renamed_field=1)))
    m, prov = costmodel.load_model_info()          # field drift
    assert m is None and "invalid" in prov["note"]


def test_env_override_beats_artifact(tmp_path, monkeypatch):
    from alignasm_tpu.runtime import costmodel

    art = tmp_path / "calibration.json"
    art.write_text(json.dumps(_cal(days=9, finish_vs_solve=1.5)))
    monkeypatch.setattr(costmodel, "CALIBRATION_PATH", str(art))
    env_cal = tmp_path / "op.json"
    env_cal.write_text(json.dumps(_cal(finish_vs_solve=0.4)))
    monkeypatch.setenv("ALIGNASM_TPU_COSTMODEL", str(env_cal))
    m, prov = costmodel.load_model_info()
    assert m.finish_vs_solve == 0.4
    assert prov["source"] == "env"


def test_committed_calibration_artifact_is_valid():
    """Whatever calibration artifact ships in the repo must parse with
    only known fields (drift in either direction is a test failure, not
    a silent defaults fallback at a customer site)."""
    import os

    from alignasm_tpu.runtime import costmodel

    if not os.path.exists(costmodel.CALIBRATION_PATH):
        pytest.skip("no committed calibration artifact yet")
    raw = json.loads(open(costmodel.CALIBRATION_PATH).read())
    model, _ = costmodel._parse_model(raw, "artifact",
                                      costmodel.CALIBRATION_PATH)
    assert model.dispatch_rtt_s > 0
    assert raw.get("_meta", {}).get("date"), "artifact must be dated"
    assert raw.get("_meta", {}).get("stale_after"), \
        "artifact must declare its shelf life"
    from alignasm_tpu.runtime.devbench import DEVICE_PEAKS

    assert raw["_meta"].get("device_kind") in DEVICE_PEAKS, \
        "artifact must name a known card"


def test_auto_routing_byte_identical_and_recorded(tmp_path):
    """device_routing='auto' (the production default) must produce the
    same bytes as the forced device pipeline, record the decision in
    stats, and route through the fused native plane on a device with no
    calibration."""
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    p = tmp_path / "r.paf"
    p.write_text(generate_paf(n_contigs=20, seed=13))
    prefix = str(p)[:-4]

    assert DEFAULT_CONFIG.device_routing == "auto"
    solve_dataset_tpu(None, DEFAULT_CONFIG, src_paths=(str(p), None),
                      write_prefix=prefix)
    s = solve_dataset_tpu.last_stats
    assert s["routing"] == "auto"
    assert s["routed"] == "fused-native"
    assert s["device_routed_frac"] == 0.0
    # every routed run states which measurement its gate ran on (none
    # here: the test device "cpu" has no calibration) and its device
    assert s["cost_model"]["calibration"]["source"] == "none"
    assert s["cost_model"]["calibration"]["device_kind"] == "cpu"
    assert (s["platform"], s["device_kind"]) == ("cpu", "cpu")
    auto_bytes = [pathlib.Path(prefix + f".aln{x}.paf").read_bytes()
                  for x in ("", ".alt", ".all")]

    forced = dataclasses.replace(DEFAULT_CONFIG, device_routing="always")
    solve_dataset_tpu(None, forced, src_paths=(str(p), None),
                      write_prefix=prefix)
    s2 = solve_dataset_tpu.last_stats
    assert s2["device"] + s2["fallback"] + s2["singleton"] \
        + s2["native_direct"] >= 20
    for b, x in zip(auto_bytes, ("", ".alt", ".all")):
        assert b == pathlib.Path(prefix + f".aln{x}.paf").read_bytes(), x


def test_auto_routing_in_memory_results(tmp_path):
    """Without a write prefix (callers needing in-memory rows), auto
    routing solves on the exporter plane with the device gated off —
    results must equal the exact engine."""
    import copy

    from alignasm_tpu.engine.exact import solve_dataset
    from alignasm_tpu.io.paf import read_paf
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    p = tmp_path / "m.paf"
    p.write_text(generate_paf(n_contigs=10, seed=21))
    ds = read_paf(p)
    ds2 = copy.deepcopy(ds)
    got = solve_dataset_tpu(ds, DEFAULT_CONFIG, src_paths=(str(p), None))
    s = solve_dataset_tpu.last_stats
    assert s["routed"] == "native-plane"
    assert s["device"] == 0
    assert got == solve_dataset(ds2, DEFAULT_CONFIG)


def test_auto_with_calibration_gates_per_bucket(tmp_path, monkeypatch):
    """With a calibration where wins are possible (finish_vs_solve < 1),
    auto routing takes the exporter plane and gates per bucket: a huge
    dispatch RTT must gate every bucket (native covers, bytes correct),
    a negligible one must launch them."""
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    p = tmp_path / "g.paf"
    p.write_text(generate_paf(n_contigs=16, seed=31))
    prefix = str(p)[:-4]

    def run_with(cal):
        calp = tmp_path / "cal.json"
        calp.write_text(json.dumps(cal))
        monkeypatch.setenv("ALIGNASM_TPU_COSTMODEL", str(calp))
        solve_dataset_tpu(None, DEFAULT_CONFIG, src_paths=(str(p), None),
                          write_prefix=prefix)
        return dict(solve_dataset_tpu.last_stats)

    # wins possible in principle, but a 1000 s dispatch gates everything
    s = run_with(_cal(finish_vs_solve=0.2, dispatch_rtt_s=1000.0))
    assert s["routing"] == "auto"
    assert s.get("buckets_gated", 0) >= 1, s
    assert s["device"] == 0
    gated_bytes = [pathlib.Path(prefix + f".aln{x}.paf").read_bytes()
                   for x in ("", ".alt", ".all")]

    # near-free transport: the same buckets must launch
    s = run_with(_cal(finish_vs_solve=0.2, dispatch_rtt_s=1e-7,
                      h2d_bytes_per_s=1e12, d2h_bytes_per_s=1e12,
                      device_s_per_contig=1e-9, device_s_per_step=1e-9,
                      solve_s_per_record=1e-3))
    assert s.get("buckets_gated", 0) == 0, s
    assert s["device"] + s["fallback"] >= 1, s
    for b, x in zip(gated_bytes, ("", ".alt", ".all")):
        assert b == pathlib.Path(prefix + f".aln{x}.paf").read_bytes(), x
