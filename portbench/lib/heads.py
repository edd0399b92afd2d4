"""Heads found by name.  A configuration's ``model.decoder_option`` names
a file ``<decoder_option>.py``, looked for in the directories of a search
path, first to last: ``portbench/reference/heads`` holds each head's plain
reference, ``portbench/counts/heads`` its FLOPs and kernel bounds.  A new
head is two new files; the trunk's files name no head."""

from __future__ import annotations

import importlib.util
import re
from functools import lru_cache
from pathlib import Path
from typing import Iterable, List


def find(search: Iterable[Path], name: str, what: str):
    """The module of head ``name`` from the first directory of ``search``
    that holds ``<name>.py``; a head with no file stops the run with an
    error that names the files looked for."""
    files = [Path(d) / f"{name}.py" for d in search]
    if re.fullmatch(r"[A-Za-z0-9_]+", str(name)):
        for f in files:
            if f.is_file():
                return _load(f.resolve(), what)
    raise FileNotFoundError(f"no {what} of the head {name!r}: looked for "
                            + ", ".join(str(f) for f in files))


def names(search: Iterable[Path]) -> List[str]:
    """Every head on ``search``, by name."""
    found = {p.stem for d in search for p in Path(d).glob("*.py") if p.stem != "__init__"}
    return sorted(found)


@lru_cache(maxsize=None)
def _load(path: Path, what: str):
    spec = importlib.util.spec_from_file_location(f"portbench_{what}_head_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
