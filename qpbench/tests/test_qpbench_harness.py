"""The harness finds cells, configurations, traffic mixes and metrics by
name: a new one is new files and entries, with no edit to a file that is
there.  And the result line has the contract's keys."""

import json
import shutil

from qpbench import harness
from qpbench.harness import Check, Run
from qpbench.tests import tiny


def test_new_cell_config_mix_and_metric_are_files_only(tmp_path):
    shutil.copytree(harness.ROOT / "qpbench", tmp_path / "qpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark()
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "qpbench").rglob("*") if p.is_file()}
    # a configuration: a narrower copy of the default, in a file of its own
    cfg = json.loads((tmp_path / "qpbench/configs/qpnet_default.json")
                     .read_text())
    (tmp_path / "qpbench/configs/qpnet_narrow.json").write_text(
        json.dumps(dict(cfg, **tiny.TINY)))
    bench["configs"].append({"name": "qpnet_narrow", "source": "test",
                             "file": "qpbench/configs/qpnet_narrow.json",
                             "reduced": [], "why": "test"})
    # a traffic mix: data only, read by the decode runner
    mix = json.loads((tmp_path / "qpbench/traffic/decode_b20.json")
                     .read_text())
    mix.update(tiny.SMALL["default.decode.b20"], batch=2)
    (tmp_path / "qpbench/traffic/decode_b2.json").write_text(json.dumps(mix))
    bench["workloads"].append({"name": "narrow.decode.b2",
                               "config": "qpnet_narrow",
                               "traffic": "decode_b2", "chips": 1,
                               "why": "test"})
    # a metric: a reader of its own, for the new cell alone
    (tmp_path / "qpbench/metrics/calls_per_window.py").write_text(
        "def read(run):\n    return run.counts.get('calls')\n")
    bench["per_layer"].append({"name": "calls_per_window", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "decode runner",
                               "moves": "decode_samples_per_s",
                               "workloads": ["narrow.decode.b2"]})
    for m in bench["end_to_end"]:
        if m["name"] == "decode_samples_per_s":
            m["workloads"].append("narrow.decode.b2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "qpbench").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items()
               if "__pycache__" not in k.parts)

    run = harness.run_cell("narrow.decode.b2", 5, 0.5, False,
                           tiny.torch.device("cpu"), root=tmp_path)
    assert run.correct and run.counts["batch"] == 2
    e2e = harness.read_metrics(tmp_path, harness.benchmark(tmp_path),
                               "narrow.decode.b2", run, False)
    assert set(e2e) == {"decode_samples_per_s", "setup_s"}
    per = harness.read_metrics(tmp_path, harness.benchmark(tmp_path),
                               "narrow.decode.b2", run, True)
    assert per["calls_per_window"]["value"] == run.counts["calls"]
    # the decode cells' metrics that need a trace find nothing: left out
    assert "k1_roofline.decode" not in per


def test_every_metric_has_a_reader_and_every_cell_its_files():
    bench = harness.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (harness.ROOT / "qpbench/metrics" / f"{m['name']}.py").exists()
    for w in bench["workloads"]:
        tr = harness.traffic(harness.ROOT, w["traffic"])
        assert (harness.ROOT / "qpbench/runners" / f"{tr['runner']}.py") \
            .exists()
        e2e = harness.metrics_of(bench, w["name"], False)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert harness.metrics_of(bench, w["name"], True)


def test_result_line_keys():
    run = Run(attempted=3, failed=0, checks={"gap": Check(0.1, 1.0)})
    line = json.loads(harness.result_line(
        run, {"setup_s": {"value": 1.0, "unit": "s"}},
        {"platform": "gpu", "kind": "x", "count": 1,
         "memory_peak_bytes": 1}, False))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert line["checks"] == {"gap": {"value": 0.1, "limit": 1.0}}
    assert not Run(checks={"gap": Check(2.0, 1.0)}).correct
    assert not Run(checks={"gap": Check(float("nan"), 1.0)}).correct
    assert not Run(failed=1).correct


def test_traced_run_reports_per_layer_metrics_on_cpu():
    """The CPU has no device events: the device metrics find nothing to
    read and are left out, the host's are there."""
    run = tiny.run("default.train.f32", trace=True, seconds=0.5)
    per = harness.read_metrics(harness.ROOT, harness.benchmark(),
                               "default.train.f32", run, True)
    assert "train_mfu" in per and "train.batch_wait_ms" in per
    assert run.trace is not None and run.trace.busy_s == 0
    assert "device_idle.train" not in per
