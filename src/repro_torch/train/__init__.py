"""The gradient pipeline (``grad``), the decentralized trainer (``loop``)
and the evaluation metrics (``metrics``)."""
