"""Run logging and metrics (PyTorch port of
``shiftedscalequantization_tpu/utils/logging.py``; reference: print-based
+ {device}.log append + Telegram push, common.py:87-125,
ShiftedScaleQuant.py:400-404, myScaledMethods.py:159,196-197).

The messaging-bot hook is a generic webhook, off unless SSQ_WEBHOOK_URL is
set.
"""
from __future__ import annotations

import json
import os
import time
from datetime import datetime


class AverageMeter:
    """(reference common.py:87-108)"""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count

    def __str__(self):
        s = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return s.format(**self.__dict__)


class RunLog:
    """Appends timestamped result lines to a log file (the reference's
    '{run_device}.log' append, ShiftedScaleQuant.py:400-404)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)

    def append(self, config: str, payload):
        stamp = datetime.now().strftime("[%m-%d %H:%M:%S]")
        with open(self.path, "a") as f:
            f.write(f"{stamp}:{config}: {json.dumps(payload)}\n")


def notify(message: str):
    """Webhook notifier (Telegram-bot equivalent, myScaledMethods.py:159).
    No-op unless SSQ_WEBHOOK_URL is set."""
    url = os.environ.get("SSQ_WEBHOOK_URL")
    if not url:
        return False
    try:
        import urllib.request
        req = urllib.request.Request(
            url, data=json.dumps({"text": message}).encode(),
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=5)
        return True
    except Exception:
        return False


class Timer:
    def __init__(self):
        self.t0 = time.time()

    def lap(self):
        now = time.time()
        dt = now - self.t0
        self.t0 = now
        return dt
