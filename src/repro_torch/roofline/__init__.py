"""Roofline bookkeeping: the analytic per-region cost model and the
three-term roofline report.

``cost_model``, ``analysis`` and ``aggregate`` are copies of the
reference's ``src/repro/roofline/`` modules with only their imports
changed (held so by ``tests/test_torch_roofline.py``). Two consequences:

- ``analysis.roofline_terms`` keeps the reference's default
  ``hw=TPU_V5E``. Callers that price work on the card pass
  ``hw=repro_torch.core.hardware.H100_SXM``.
- ``roofline_terms`` reads an XLA ``cost_analysis()`` dict and HLO text.
  Its first caller in the port will be the port's dry run (ROADMAP A11),
  which has to produce both from torch. Until then,
  ``cost_model.step_region_costs`` feeds energy optimisation and timeline
  synthesis, and ``model_flops`` needs no compiled artifact.
"""
