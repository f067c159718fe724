"""The reference's six example scripts, on the card.

Counterparts of ``examples/*.py`` of the JAX package, each run as
``python -m csmom_tpu_torch.examples.<name>`` and callable as
``main(argv)``:

- :mod:`~csmom_tpu_torch.examples.pack_at_scale` and
  :mod:`~csmom_tpu_torch.examples.north_star_grid` on synthetic panels;
- :mod:`~csmom_tpu_torch.examples.replicate_reference`,
  :mod:`~csmom_tpu_torch.examples.strategy_zoo`,
  :mod:`~csmom_tpu_torch.examples.cost_frontier` and
  :mod:`~csmom_tpu_torch.examples.causal_scoring` on a ``--data-dir`` of
  daily and intraday CSV caches.

Each keeps its reference's flags, printed lines, float types and
asserts, with ``--device {cuda,cpu}`` (default cuda; without a card the
script raises, naming ``device='cpu'``) in place of ``--platform``.
"""
