"""CD-Adam compressor study on the port: quality against wire bytes for
each delta-contraction operator, on the paper's CTR setting. The port of
``examples/compressed_comm.py``.

    PYTHONPATH=src python -m repro_torch.launch.compressed_comm
    PYTHONPATH=src python -m repro_torch.launch.compressed_comm --steps 20 \
        --device cpu

Four rows, in the JAX example's order: D-Adam at full precision, then
CD-Adam (gamma 0.4) with the sign compressor, top-k at fraction 1/16 and
the 16-level quantizer. Each trains DeepFM (8 fields x 32 features,
embedding 10, hidden (64, 64)) on an 8-worker ring at eta 1e-3, gossip
every p=4 steps, 32 examples a worker a step, and prints its final loss,
the held-out AUC of the consensus mean and the comm MB in the example's
line format. ``--steps`` defaults to ``$COMPRESSED_COMM_STEPS`` or 150, as
the example's ``STEPS``. Runs on ``cuda`` unless ``--device cpu`` is
given, on the example's default ``reference`` backend. ``--backend
packed`` runs the resident state and the CUDA kernels for the D-Adam and
sign rows; the packed backend fuses only the sign compressor, so the
top-k and quantize rows stay on ``reference`` and their labels say so.
The params come from a torch generator seeded 0 and the batches from one
seeded 1 (the example's keys; the draws are torch's, not JAX's); the AUC
is ``deepfm_ctr.heldout_auc``'s, 512 examples a worker drawn from seed
99. Returns the rows.
"""
from __future__ import annotations

import argparse
import os
from typing import List, NamedTuple, Optional

from repro_torch.launch import deepfm_ctr

K = deepfm_ctr.K
PERIOD, PER_WORKER, HIDDEN = 4, 32, (64, 64)
N_FIELDS, FEATURES_PER_FIELD = 8, 32
# the example's line, label padded to 24
LINE = "{name:24s} loss={loss:.4f} AUC={auc:.4f} comm={mb:8.2f} MB"
# (label, optimizer kind, its options)
ROWS = (("full precision", "d-adam", {}),
        ("sign (paper)", "cd-adam", dict(compressor="sign", gamma=0.4)),
        ("topk 1/16", "cd-adam",
         dict(compressor="topk", gamma=0.4, fraction=1 / 16)),
        ("quantize 16 levels", "cd-adam",
         dict(compressor="quantize", gamma=0.4)))


class Row(NamedTuple):
    label: str
    loss: float
    auc: float
    comm_mb: float


def main(argv: Optional[List[str]] = None) -> List[Row]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=int(
        os.environ.get("COMPRESSED_COMM_STEPS", "150")))
    ap.add_argument("--backend", default="reference",
                    choices=("reference", "packed"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rows = []
    for label, kind, kw in ROWS:
        backend = args.backend
        if backend == "packed" and kw.get("compressor", "sign") != "sign":
            # the packed backend fuses only the sign compressor
            backend, label = "reference", f"{label} [reference]"
        res = deepfm_ctr.run(
            label, "deepfm", kind, args.steps, n_fields=N_FIELDS,
            features_per_field=FEATURES_PER_FIELD, hidden=HIDDEN,
            per_worker=PER_WORKER, backend=backend, device=args.device,
            period=PERIOD, row=LINE, **kw)
        rows.append(Row(label, res.log.loss[-1], res.auc,
                        res.log.comm_mb[-1]))
    return rows


if __name__ == "__main__":
    main()
