"""Roofline bookkeeping: the analytic per-region cost model and the
three-term roofline report.

``cost_model``, ``analysis`` and ``aggregate`` are copies of the
reference's ``src/repro/roofline/`` modules with only their imports
changed (held so by ``tests/test_torch_roofline.py``). Two consequences:

- ``analysis.roofline_terms`` keeps the reference's default
  ``hw=TPU_V5E``. Callers that price work on the card pass
  ``hw=repro_torch.core.hardware.H100_SXM``.
- ``roofline_terms`` reads an XLA ``cost_analysis()`` dict and HLO text.
  Its caller in the port is the dry run
  (:mod:`repro_torch.launch.dryrun`), which builds the dict from its
  meter's per-device FLOPs and bytes and the text from the collectives
  it counted (one HLO-style line each, output shape and kind).
  ``cost_model.step_region_costs`` feeds energy optimisation and timeline
  synthesis, and ``model_flops`` needs no compiled artifact.
"""
