"""Device-routing cost model — the Amdahl A/B turned into policy.

The device route replaces the full native solve of a bucket of contigs
with export + transfer + kernel + a device-assisted host finish:

    t_device = t_export_and_finish + t_transfer + t_kernel

so it can only win where the host-side part alone (``finish_vs_solve``
times the native solve) costs less than the native solve it replaces.
This module makes that measurement the routing decision: a bucket of
contigs is dispatched to the device only when the model predicts a
win; otherwise the engine runs the same fused native plane
``--engine native`` uses, so ``--engine tpu`` can never be slower than
the native plane by more than the decision cost (~0).

Every field is a measurement, and a measurement belongs to the device
it was taken on: the model comes only from a calibration artifact
(``devbench --calibrate``) whose ``_meta.device_kind`` equals
``jax.devices()[0].device_kind``.  With no matching artifact there is
no model, and ``device_routing="auto"`` routes everything to the native
plane.  An operator may point ``$ALIGNASM_TPU_COSTMODEL`` at another
artifact for the same device.

The reference has no analogue (it has one engine).
"""

from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass(frozen=True)
class DeviceCostModel:
    # --- transfer ---
    dispatch_rtt_s: float       # fixed round trip per dispatch/transfer
    h2d_bytes_per_s: float      # host->device, sparse-wire content
    d2h_bytes_per_s: float      # device->host, gate-row content

    # --- host plane: full native solve, all cores ---
    solve_s_per_record: float
    solve_s_per_contig_min: float

    # --- the Amdahl ratio ---
    # the device route's host-side cost with the DP removed (export/pack
    # + finish_bulk8) over the full native solve of the same contigs,
    # identical cold-graph state.  The device can only win when this is
    # < 1 (the finish must be cheaper than the work it replaces by more
    # than the transfer).
    finish_vs_solve: float

    # --- device compute ---
    device_s_per_contig: float  # marginal per-contig kernel cost, V <= 64
    device_s_per_step: float    # per-vertex cost of the big-V blocked kernel

    def any_possible_win(self) -> bool:
        """Can ANY bucket on this hardware profile route profitably?

        The device route costs at least ``finish_vs_solve * t_native +
        rtt``, so a win requires finish_vs_solve < 1.  With the measured
        ratio >= 1 the answer is corpus-independent: route nothing, run
        the fused native plane.
        """
        return self.finish_vs_solve < 0.999

    def predict_native_s(self, sum_records: int, n_contigs: int) -> float:
        """Full native solve of a contig set (all-core host plane)."""
        return max(self.solve_s_per_record * sum_records,
                   self.solve_s_per_contig_min * n_contigs)

    def predict_device_s(self, n_contigs: int, V: int, wire_bytes: int,
                         row_bytes: int, sum_records: int) -> float:
        """Device route of one bucket: transfer + kernel + finish."""
        kernel = max(self.device_s_per_contig * n_contigs,
                     self.device_s_per_step * V)
        finish = self.finish_vs_solve * self.predict_native_s(
            sum_records, n_contigs)
        return (self.dispatch_rtt_s
                + wire_bytes / self.h2d_bytes_per_s
                + row_bytes / self.d2h_bytes_per_s
                + kernel + finish)

    def bucket_profitable(self, n_contigs: int, V: int, wire_bytes: int,
                          row_bytes: int, sum_records: int) -> bool:
        return (self.predict_device_s(n_contigs, V, wire_bytes, row_bytes,
                                      sum_records)
                < self.predict_native_s(sum_records, n_contigs))

    def summary(self) -> dict:
        return {
            "finish_vs_solve": self.finish_vs_solve,
            "dispatch_rtt_s": self.dispatch_rtt_s,
            "h2d_MB_per_s": round(self.h2d_bytes_per_s / 1e6, 1),
            "d2h_MB_per_s": round(self.d2h_bytes_per_s / 1e6, 1),
            "any_possible_win": self.any_possible_win(),
        }


# the committed calibration artifact `devbench --calibrate` regenerates
CALIBRATION_PATH = os.path.join(os.path.dirname(__file__),
                                "calibration.json")


def current_device_kind() -> str:
    import jax

    return jax.devices()[0].device_kind


def _meta_of(raw: dict) -> dict:
    """The _meta block, tolerating corruption: any non-dict value (a
    torn artifact must NEVER steer or crash the gate) reads as absent."""
    meta = raw.get("_meta")
    return meta if isinstance(meta, dict) else {}


def _parse_model(raw: dict, source: str, path: str):
    meta = _meta_of(raw)
    fields = {f.name for f in dataclasses.fields(DeviceCostModel)}
    unknown = set(raw) - fields - {"_meta"}
    if unknown:
        raise ValueError(f"unknown cost-model fields: {sorted(unknown)}")
    missing = fields - set(raw)
    if missing:
        raise ValueError(f"missing cost-model fields: {sorted(missing)}")
    model = DeviceCostModel(**{k: float(v) for k, v in raw.items()
                               if k != "_meta"})
    prov = {"source": source, "path": path}
    for k in ("date", "stale_after", "device_kind", "method"):
        if k in meta:
            prov[k] = meta[k]
    if "date" in meta:
        import datetime

        try:
            age = (datetime.date.today()
                   - datetime.date.fromisoformat(meta["date"])).days
            prov["age_days"] = age
        except (ValueError, TypeError):
            pass
    return model, prov


def _rejection(raw: dict, device_kind: str) -> str | None:
    """Why an artifact must NOT steer routing on ``device_kind`` (None
    when it may): it was measured on another device, names none, or is
    past its own ``_meta.stale_after`` (ISO date)."""
    import datetime

    meta = _meta_of(raw)
    measured_on = meta.get("device_kind")
    if measured_on != device_kind:
        return (f"measured on {measured_on!r}, running on {device_kind!r}"
                if measured_on else "no _meta.device_kind")
    stale_after = meta.get("stale_after")
    if not stale_after:
        return "no _meta.stale_after"
    try:
        limit = datetime.date.fromisoformat(stale_after)
    except (ValueError, TypeError):
        return f"unparsable stale_after {stale_after!r}"
    if datetime.date.today() > limit:
        return f"stale since {stale_after}"
    return None


def load_model_info(device_kind: str | None = None
                    ) -> tuple[DeviceCostModel | None, dict]:
    """(model, provenance) for ``device_kind`` (default: the running
    device).  Resolution order:

    1. ``$ALIGNASM_TPU_COSTMODEL`` — explicit operator override; an
       artifact with unknown or missing fields, or one measured on
       another device, raises;
    2. the committed calibration artifact (``CALIBRATION_PATH``) when it
       was measured on this device and is fresh per its own
       ``_meta.stale_after``;
    3. no model: ``(None, {"source": "none", "device_kind": ...})``.

    The provenance dict is recorded in ``solve_dataset_tpu.last_stats``
    so every routed run states which measurement its gate ran on."""
    if device_kind is None:
        device_kind = current_device_kind()
    path = os.environ.get("ALIGNASM_TPU_COSTMODEL")
    if path:
        with open(path) as fh:
            raw = json.load(fh)
        model, prov = _parse_model(raw, "env", path)
        why = _rejection(raw, device_kind)
        if why and why.startswith(("measured on", "no _meta.device_kind")):
            raise ValueError(f"cost model {path}: {why}")
        return model, prov
    none = {"source": "none", "device_kind": device_kind}
    try:
        with open(CALIBRATION_PATH) as fh:
            raw = json.load(fh)
        if not isinstance(raw, dict):
            raise ValueError("calibration root is not an object")
    except (OSError, ValueError) as exc:
        return None, {**none,
                      "note": f"no calibration artifact "
                              f"({exc.__class__.__name__})"}
    why = _rejection(raw, device_kind)
    if why:
        return None, {**none, "note": f"calibration artifact ignored: {why}"}
    try:
        return _parse_model(raw, "artifact", CALIBRATION_PATH)
    except (ValueError, TypeError) as exc:
        return None, {**none, "note": f"calibration artifact invalid: {exc}"}


def load_model() -> DeviceCostModel | None:
    """The running device's model, or None (see load_model_info)."""
    return load_model_info()[0]
