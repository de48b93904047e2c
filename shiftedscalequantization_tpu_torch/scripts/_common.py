"""What the accuracy scripts share: the ``--platform`` flag, the port's CLI
run in this process with its printed lines kept, and the served state of
a CLI checkpoint (the sim forward and the integer deploy inputs)."""
from __future__ import annotations

import contextlib
import io
import os
import sys
import tempfile
import time

import numpy as np
import torch



def add_platform(ap):
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card (raises without one); cpu: the CPU")


def platform_flags(args) -> list:
    """The flags that put the port's CLI and trainer on ``args.platform``
    (their default is the card)."""
    return ["--platform", "cpu"] if args.platform == "cpu" else []


def tmp_path(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


class Tee(io.TextIOBase):
    """A stdout that passes every write on and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        self.out.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def run_cli(argv):
    """``cli.main(argv)`` in this process, its lines passed on to stdout.
    Returns (its result, what it printed, wall seconds)."""
    from .. import cli
    tee = Tee(sys.stdout)
    t0 = time.time()
    with contextlib.redirect_stdout(tee):
        final = cli.main(argv)
    return final, tee.buf.getvalue(), time.time() - t0


def served_state(arch, dataset, npz, qstate_path, nbw, nba, device):
    """A CLI run's hardened state on ``device``: (graph, the sim forward
    with every weight and act site on, deploy params, act steps)."""
    from .. import deploy
    from ..graph import Flags, forward
    from ..models import zoo
    from ..quantize import QuantConfig, act_flags, prepare_model
    from ..train import load_raw_params
    from ..utils import checkpoint as ckpt
    graph, _ = zoo.build(arch, dataset=dataset)
    # the quantizers are the checkpoint's: prepare_model's own init is
    # dropped, so it takes the cheapest
    cfg = QuantConfig(n_bits_w=nbw, n_bits_a=nba, w_scale_method="max",
                      a_scale_method="max")
    params, _ = prepare_model(graph, load_raw_params(npz, device=device),
                              cfg, device=device)
    qstate, _ = ckpt.load_qstate(qstate_path, device=device)
    flags = act_flags(graph, cfg, base=Flags().all_weights(graph))
    dparams = deploy.build_deploy_params(graph, params, qstate,
                                         device=device)
    steps = deploy.act_steps_from_qstate(graph, qstate)

    def sim(x):
        return forward(graph, params, qstate, x, flags, device=device)
    return graph, sim, dparams, steps


def top1(fn, x_te, y_te, device, bs=256) -> float:
    """Top-1 % of ``fn`` (NHWC batch -> logits) in batches of ``bs`` on
    ``device``, rounded to 3 places."""
    good = tot = 0
    with torch.no_grad():
        for i in range(0, len(x_te), bs):
            xb = torch.as_tensor(np.asarray(x_te[i:i + bs]), device=device)
            pred = fn(xb).argmax(-1).cpu().numpy()
            good += int((pred == np.asarray(y_te[i:i + bs])).sum())
            tot += len(pred)
    return round(100.0 * good / tot, 3)
