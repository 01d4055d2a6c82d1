"""``repro_torch.examples.quickstart`` against the JAX package's own
``examples/quickstart.py``, run unchanged in a subprocess on the CPU: at
the same flags every printed line is the same once the times are masked
(the plan, the portfolio's counters, the DSL pattern's count, the
pipeline's F1, precision and recall).  Then, for all five examples:
without ``--device`` and without a card each raises."""
import importlib

import pytest
import torch

from repro_torch.examples import quickstart
from tests.examples_parity import TINY_FLAGS, masked, run_reference

FLAGS = ["--scale", "0.1", "--trees", "5"]

# the lines the port prints on purpose otherwise than the script: none
DEPARTURES = ()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lines_equal_reference_script(tmp_path, capsys):
    want = run_reference("quickstart", FLAGS, tmp_path)
    capsys.readouterr()
    got = quickstart.main(FLAGS + ["--device", "cpu"])
    printed = capsys.readouterr().out
    assert masked(printed, DEPARTURES) == masked(want, DEPARTURES)
    assert (got["roundtrip3_counts"] == got["roundtrip3_oracle"]).all()
    assert got["counts"].shape == (got["n_edges"], 4) and got["columns"] == [
        "scatter_gather", "fan_in", "fan_out", "cycle3"]
    assert f"F1={got['f1']:.3f}" in printed and got["pipeline"].classifier is not None


@pytest.mark.parametrize("name,flags", TINY_FLAGS, ids=[n for n, _ in TINY_FLAGS])
def test_raises_without_card_or_device(name, flags, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the default device is the card here")
    if name == "trace_capture":
        flags = flags + ["--out-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA device"):
        importlib.import_module(f"repro_torch.examples.{name}").main(flags)
