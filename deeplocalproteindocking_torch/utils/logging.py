"""Structured JSONL metrics logging.

The port's own copy of ``deeplocalproteindocking_tpu/utils/logging.py``
(standard library only): every evaluation event is one JSON line with a
wall-clock timestamp, appended to a file and optionally echoed.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, event: str, **fields: Any) -> Dict[str, Any]:
        rec = {"time": time.time(), "event": event}
        for k, v in fields.items():
            if hasattr(v, "item"):
                v = v.item()
            rec[k] = v
        line = json.dumps(rec, sort_keys=True)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        if self.echo:
            print(line)
        return rec

    def close(self):
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
