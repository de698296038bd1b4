"""The harness's contract on the CPU: no result without a card, the import
check by whole top-level names, the server's flags and where a run writes."""

import json
import shutil
import subprocess
import sys

import pytest

from perfbench import check, harness, run
from perfbench.tests.tiny import tiny_bench


def test_no_card_no_result(capsys):
    if harness.torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert run.main(["--workload", "wave24k.open", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_banned_modules_by_whole_top_level_name():
    assert harness.banned_modules(["miotts_tpu_torch", "miotts_tpu_torch.serving", "jaxtyping",
                                   "flaxen", "numpy"]) == []
    assert harness.banned_modules(["miotts_tpu.models", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "miotts_tpu"]


def test_the_harness_loads_no_jax():
    code = ("import sys, perfbench.run, perfbench.harness, perfbench.check, perfbench.control, "
            "perfbench.sweep, perfbench.loadgen; import miotts_tpu_torch.serving.server; "
            "print(perfbench.harness.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, perfbench.check; "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('miotts')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.PKG, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "wave24k.open",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""


def test_server_argv_writes_under_the_run_dir(tmp_path):
    b = harness.Bench("wave24k.open")
    paths = {k: tmp_path / "weights" / f"{k}.gguf" for k in ("llm", "codec", "voice")}
    argv = b.server_argv(tmp_path, paths)
    assert argv[argv.index("--output-dir") + 1] == str(tmp_path / "wav")
    assert argv[argv.index("--port") + 1] == "0"
    assert argv[argv.index("-np") + 1] == "8" and argv[argv.index("-n") + 1] == "512"
    assert argv[argv.index("--warmup") + 1] == "on"
    ref = json.loads(argv[argv.index("--reference-file") + 1])
    assert ref == {"key": "voice", "path": str(paths["voice"])}
    from miotts_tpu_torch.serving import server

    cfg = server.config_from_args(server.build_arg_parser().parse_args(argv))
    assert cfg.output_dir == str(tmp_path / "wav") and cfg.n_parallel == 8 and cfg.warmup


def test_every_cell_finds_its_files():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        b = harness.Bench(cell["name"])
        assert b.params["rate_rps"] > 0 and set(b.params["limits"]) <= set(check.NAMES)
        assert {"wav_err", "stream_err"} <= set(b.params["limits"])
        for m in b.end_to_end + b.per_layer:
            assert callable(harness.metric_reader(m["name"]))
        assert any(m["name"] == "setup_s" for m in b.end_to_end)
        assert len(b.end_to_end) >= 2 and b.per_layer
        assert any(m["source"] == "device_trace" for m in b.per_layer)


def test_a_run_writes_only_under_its_directory(tmp_path):
    """The weights, the WAVs, the codes, the kept audio and the load
    generator's records all land under the run's directory."""
    b = tiny_bench(tmp_path / "root")
    args = run.parse(["--workload", "tiny.open", "--seed", "5", "--seconds", "2"])
    run.run(args, harness.torch.device("cpu"), b, tmp_path / "run")
    names = {p.relative_to(tmp_path / "run").parts[0] for p in (tmp_path / "run").rglob("*")}
    assert names <= {"weights", "wav", "window1"}
    assert not list((tmp_path / "run" / "wav").glob("*.wav"))  # each read and deleted
