"""Terminal display of the port: the boxed config table the CLIs print (a
copy of ``simple_table`` of ``wavernn_tpu/utils/display.py``)."""

from __future__ import annotations

from typing import Sequence, Tuple


def simple_table(item_tuples: Sequence[Tuple[object, object]]) -> None:
    """Print a boxed one-row ASCII table of (heading, value) pairs."""
    headings, cells = [], []
    for heading, cell in item_tuples:
        heading, cell = str(heading), str(cell)
        pad = abs(len(heading) - len(cell))
        left, right = " " * (pad // 2), " " * (pad - pad // 2)
        if len(heading) < len(cell):
            heading = left + heading + right
        else:
            cell = left + cell + right
        headings.append(heading)
        cells.append(cell)

    border = head = body = ""
    for i, (h, c) in enumerate(zip(headings, cells)):
        head_piece = f"| {h} "
        body_piece = f"| {c} "
        border += "+" + "-" * (len(head_piece) - 1)
        head += head_piece
        body += body_piece
        if i == len(headings) - 1:
            head += "|"
            body += "|"
            border += "+"
    print(border)
    print(head)
    print(border)
    print(body)
    print(border)
    print(" ")
