"""A short traced run of each cell on the card: correct, with every metric
the cell lists (10 s, so that the steps outside the profiled ones give the
step intervals' 90th percentile ten intervals or more).  On the card's machine:
``python3 -m pytest -q portbench/tests/test_portbench_card.py``."""

import pytest

from portbench import run

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["deflow.train-b16", "fastflow3d.train-b16"])
def test_a_short_traced_run(card, cell):
    result, _ = run.run_cell(cell, 2 ** 31 + 101, 10.0, True, card)
    bench = run.load_cell(cell)[0]
    want = {m["name"] for m in run.metric_names(bench, cell, True)}
    assert result["correct"], result["checks"]
    assert want <= set(result["metrics"]), want - set(result["metrics"])
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert 0 < result["metrics"]["kernel_roofline.train"]["value"] <= 100
