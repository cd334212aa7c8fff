"""The gradient pipeline (``grad``), the decentralized trainer (``loop``),
the evaluation metrics (``metrics``) and the online train->serve loop
(``online``)."""
