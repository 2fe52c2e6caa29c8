"""Terminal selection with injectable IO (port of `get_selection` of
`autoposeestimation_tpu/pipeline/tui.py`)."""
from __future__ import annotations

from typing import Callable, List, Sequence


def get_selection(name: str, options: Sequence[str], multi: bool = False,
                  add_all: bool = False,
                  input_fn: Callable[[str], str] = input,
                  print_fn: Callable[[str], None] = print):
    """Select one (or several) options by index. Returns a string or a list.

    Multi-select keeps asking until 'd'/'done'; 'a'/'all' selects everything.
    Invalid entries re-prompt. Empty option list returns None/[].
    """
    options = list(options)
    if not options:
        return [] if multi else None
    selected: List[str] = []
    while True:
        print_fn(f"Select {name}:")
        for i, opt in enumerate(options):
            marker = "*" if opt in selected else " "
            print_fn(f" {marker}[{i}] {opt}")
        extras = []
        if multi:
            extras.append("'d'=done")
        if add_all:
            extras.append("'a'=all")
        raw = input_fn(f"choice {' '.join(extras)}> ").strip().lower()
        if multi and raw in ("d", "done"):
            return selected
        if add_all and raw in ("a", "all"):
            return list(options) if multi else options[0]
        try:
            idx = int(raw)
            choice = options[idx]
        except (ValueError, IndexError):
            print_fn("invalid choice")
            continue
        if not multi:
            return choice
        if choice not in selected:
            selected.append(choice)
