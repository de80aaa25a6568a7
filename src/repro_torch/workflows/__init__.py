"""Servable agentic workflows, the port's copy of ``repro.workflows``:
:mod:`repro_torch.workflows.runtime`, every workflow of the reference's
registry (:mod:`~repro_torch.workflows.registry`: beam_search, rag_reranker,
react_agent, debate, map_reduce, session_chat and recursive_agent), the
traffic generators (:mod:`~repro_torch.workflows.traffic`) and the
systems the paper compares Scepsy against
(:mod:`~repro_torch.workflows.baselines`).  ``repro_torch.launch.serve``
serves beam_search and rag_reranker, as the reference's launcher does."""
