"""On the card: the control at a cell's own size, on three seeds (a short
window at the cell's own load; the limits in ``limits/`` were set from
these readings and a dozen of the program's, PERF.md).  The control stands
in the check in the program's place, and the harness has to judge it not
correct, while the program's own reading on the same sample stays within
the limit.  Each seed's readings are printed as they come."""

import json

import pytest

from h100_bench import control, spec


@pytest.mark.card
@pytest.mark.parametrize("cell", ["mini-w4.chat", "vision-w4.image-qa"])
def test_control_reads_above_the_limit_on_the_card(card, cell, capsys):
    assert control.main(["--workload", cell, "--seeds", "11,12,13", "--seconds", "15"]) == 0
    limit = spec.load(cell)["limits"]["logit_gap"]["limit"]
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    with capsys.disabled():
        for row in rows:
            print(cell, json.dumps(row))
    for row in rows:
        assert row["correct"] is False and row["served"] <= limit < row["checks"]["logit_gap"]["value"]
