"""PyTorch port, the dry run's report (``launch/report.py``): the same
record JSONs through both packages' ``report`` modules give the same
tables — but for the "next lever" hints, which name the H100's units —
the same summary and the same record order and tag filtering.  The
records are built here the way both dry runs write them (ok, skipped and
failed cells, both meshes, a hillclimb variant); ``test_torch_dryrun.py``
sends the port's own records through both modules too."""

import contextlib
import io
import json

import pytest

from repro.launch import report as jreport
from repro_torch.launch import report
from repro_torch.launch.roofline import RooflineTerms


def _ok(arch, shape, mesh, flops, coll, overrides=None):
    terms = RooflineTerms(arch=arch, shape=shape, mesh=mesh, chips=256, hlo_flops=flops,
                          hlo_bytes=4e12, coll_bytes=coll, coll_by_kind={"all-gather": coll},
                          model_flops=3e14)
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok", "lower_s": 1.25,
            "compile_s": 7.5, "rule_overrides": overrides or {},
            "memory": {"argument_size_in_bytes": 2.5e9, "temp_size_in_bytes": 7.25e9,
                       "temp_adjusted_bytes": 7.25e9},
            "roofline": terms.to_json()}


RECORDS = {
    "smollm-135m_train_4k_pod16x16": _ok("smollm-135m", "train_4k", "pod16x16", 7e15, 2e10),
    "smollm-135m_train_4k_pod2x16x16": _ok("smollm-135m", "train_4k", "pod2x16x16", 7e12, 2e10),
    "smollm-135m_decode_32k_pod16x16": _ok("smollm-135m", "decode_32k", "pod16x16", 1e11, 5e12),
    "deepseek-67b_train_4k_pod16x16": _ok("deepseek-67b", "train_4k", "pod16x16", 1e12, 1e8,
                                          {"act_seq": "model"}),
    "whisper-medium_long_500k_pod16x16": {
        "arch": "whisper-medium", "shape": "long_500k", "mesh": "pod16x16",
        "status": "skipped", "reason": "full-attention arch"},
    "olmo-1b_prefill_32k_pod16x16": {
        "arch": "olmo-1b", "shape": "prefill_32k", "mesh": "pod16x16", "status": "error",
        "error": "RuntimeError('x')"},
    "smollm-135m_train_4k_pod16x16_hc1": _ok("smollm-135m", "train_4k", "pod16x16", 1e12, 1e9),
}


@pytest.fixture(scope="module")
def directory(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    for stem, rec in RECORDS.items():
        (d / f"{stem}.json").write_text(json.dumps(rec))
    return str(d)


def _strip_hints(table: str) -> str:
    return "\n".join(line.rsplit("|", 2)[0] for line in table.splitlines())


@pytest.mark.parametrize("tag", ["", "hc1"])
def test_load_records_same_order_and_filter(directory, tag):
    got = report.load_records(directory, tag)
    assert got == jreport.load_records(directory, tag)
    assert len(got) == (6 if not tag else 1)


@pytest.mark.parametrize("tag", ["", "hc1"])
def test_dryrun_table_identical(directory, tag):
    recs = report.load_records(directory, tag)
    assert report.dryrun_table(recs) == jreport.dryrun_table(recs)


@pytest.mark.parametrize("mesh", ["pod16x16", "pod2x16x16"])
def test_roofline_table_identical_but_hints(directory, mesh):
    recs = report.load_records(directory)
    got, want = report.roofline_table(recs, mesh), jreport.roofline_table(recs, mesh)
    assert _strip_hints(got) == _strip_hints(want)
    assert got.count("\n") == want.count("\n") >= 2
    for line in got.splitlines()[2:]:
        bottleneck = line.split("|")[6].strip()
        assert line.rsplit("|", 2)[1].strip() == report._HINTS[bottleneck]


def test_hints_name_the_cards_units():
    assert set(report._HINTS) == set(jreport._HINTS)
    text = " ".join(report._HINTS.values())
    for unit in ("tensor-core", "HBM3", "NVLink"):
        assert unit in text
    for tpu in ("MXU", "ICI"):
        assert tpu not in text


def test_summary_identical(directory):
    recs = report.load_records(directory)
    assert report.summary(recs) == jreport.summary(recs)
    assert "1 errors" in report.summary(recs)


def test_main_prints_the_same_report(directory, monkeypatch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert report.main(["--dir", directory]) == 0
    mine = out.getvalue()
    out = io.StringIO()
    monkeypatch.setattr("sys.argv", ["report", "--dir", directory])
    with contextlib.redirect_stdout(out):
        assert jreport.main() == 0
    assert _strip_hints(mine) == _strip_hints(out.getvalue())
