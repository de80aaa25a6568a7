"""Servable agentic workflows, the port's copy of ``repro.workflows``:
:mod:`repro_torch.workflows.runtime` and the two workflows that
``repro_torch.launch.serve`` serves, :mod:`~repro_torch.workflows.beam_search`
and :mod:`~repro_torch.workflows.rag_reranker`."""
