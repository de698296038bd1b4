"""On the card, at each cell's own size and load, in short windows on three
seeds: the program reads under the cell's limits, and each control comes
out as not correct on every seed. The controls: the reference one
precision below the configuration's in the program's place (the LLM's
weights through float8, the codec in TF32), and the program serving its
LLM through its own lower-precision path (``--llm-quant q8_0``). Run on the
chip: ``python -m pytest perfbench/tests -m card``."""

import json

import pytest

from perfbench import control, harness

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]
SEEDS = ["101", "102", "103"]


def readings(workload, capsys, *flags):
    assert control.main(["--workload", workload, "--seed", str(2**31 + 99), "--seconds", "20",
                         "--seeds", *SEEDS, *flags]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with capsys.disabled():  # the readings, for the record
        print(json.dumps(last))
    return last


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_reference_controls_are_not_correct(card, workload, capsys):
    last = readings(workload, capsys)
    limits = harness.Bench(workload).params["limits"]
    assert all(v <= limits[k] for k, v in last["program_max"].items() if k in limits)
    ctl = last["control_min"]
    assert ctl["llm_gap.fp8"] > limits["llm_gap"]
    assert ctl["wav_err.tf32"] > limits["wav_err"] or ctl["stream_err.tf32"] > limits["stream_err"]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_programs_q8_0_path_is_not_correct(card, workload, capsys):
    last = readings(workload, capsys, "--llm-quant", "q8_0")
    limits = harness.Bench(workload).params["limits"]
    ctl = last["control_min"]
    assert any(ctl[f"{n}.q8_0"] > lim for n, lim in limits.items())
