"""Every cell, configuration, mix, metric reader and span is found by its
name, and BENCHMARK.json keeps to the benchmark's contract."""

import importlib
import json
import re

import pytest

from cubebench import chains, harness
from cubebench.reference import chains as ref_chains

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["cubebench"]
    assert bench["command"] == ["python3", "cubebench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(bench, kind):
    names = [e["name"] for e in bench[kind]]
    assert len(names) == len(set(names))
    for e in bench[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_every_workload_resolves(bench, root):
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        cell = harness.load_cell(w["name"], root)
        assert cell.shape == tuple(cell.config["shape"])
        for op in cell.mix["chain"]:
            assert callable(chains.step(op["op"]).run)
            assert ref_chains.step(op["op"]).KIND in ("spectra", "cube")
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        # each is named by what the harness measures, before any suffix
        assert {n.split(".")[0] for n in names} <= {
            "cube_s", "peak_gib", "setup_s"}
        assert cell.per_layer, w["name"]
        assert cell.limits, f"no limits for {w['name']}"


def test_every_config_is_used_and_holds_its_keys(bench, root):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("cubebench/configs/")
        with open(root / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for key in ("shape", "dtype", "header", "beam", "target_beam",
                    "assumed", "deployment"):
            assert key in cfg


def test_every_metric_has_a_reader_and_moves_a_reported_metric(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert callable(harness.reader(m["name"]))
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)


def test_every_span_names_a_boundary_of_the_program(bench):
    spans = harness.spans_read(bench["per_layer"])
    assert set(spans) == {p.stem for p in
                          (harness.HERE / "spans").glob("*.json")}
    installed, missing, remove = harness.install_spans(spans)
    try:
        assert installed == spans and not missing
    finally:
        remove()


@pytest.mark.parametrize("name,spans", [
    ("alma.pipeline", {"cube.mad_std", "cube.convolve_to",
                       "ops.spatial_pixel_mapping"}),
    ("casa623.spectral", {"cube.spectral_smooth",
                          "cube.sigma_clip_spectrally"}),
    ("alma.spectral", {"cube.spectral_smooth",
                       "cube.sigma_clip_spectrally"})])
def test_a_cell_installs_the_spans_its_metrics_read(root, name, spans):
    cell = harness.load_cell(name, root)
    assert set(harness.spans_read(cell.per_layer)) == spans


@pytest.mark.parametrize("gone", [
    {"target": "spectral_cube_tpu_torch.cube:SpectralCube.no_such"},
    None])
def test_a_span_whose_boundary_is_gone_is_missing(tmp_path, monkeypatch,
                                                  gone):
    spans = tmp_path / "spans"
    spans.mkdir()
    if gone is not None:
        (spans / "gone.json").write_text(json.dumps(gone))
    monkeypatch.setattr(harness, "HERE", tmp_path)
    installed, missing, remove = harness.install_spans(["gone"])
    remove()
    assert installed == [] and missing == ["gone"]


def test_every_mix_operation_has_both_steps(root):
    for path in (root / "cubebench" / "mixes").glob("*.json"):
        mix = json.loads(path.read_text())
        for op in mix["chain"]:
            assert chains.step(op["op"]) is not None
            assert ref_chains.step(op["op"]) is not None


def test_an_operation_without_a_step_is_refused():
    with pytest.raises(ValueError):
        chains.step("no_such_operation")
    with pytest.raises(ValueError):
        ref_chains.step("no_such_operation")


@pytest.mark.parametrize("name,reads", [
    ("device.idle_share", "device.idle_share"),
    ("device.idle_share.pipeline", "device.idle_share"),
    ("cube.mad_std_device_ms", "cube.mad_std_device_ms")])
def test_a_split_metric_shares_its_reader(name, reads):
    assert harness.metric_module(name) is harness.metric_module(reads)


def test_metric_readers_leave_out_what_they_cannot_read(bench):
    class Empty:
        idle_share = 0.25

        def span(self, name):
            return None

        def roofline_pct(self, span, stage):
            return None
    for m in bench["per_layer"]:
        v = harness.reader(m["name"])(Empty())
        assert v is None or m["name"].startswith("device.idle_share")


def test_the_harness_modules_import():
    for name in ("cubebench.harness", "cubebench.chains",
                 "cubebench.cubegen", "cubebench.tracearith",
                 "cubebench.roofline"):
        importlib.import_module(name)
