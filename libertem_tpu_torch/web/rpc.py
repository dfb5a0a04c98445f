"""Compound-analysis RPC procedures (counterpart of
``libertem_tpu/web/rpc.py``): procedures such as the CoM parameter
guess run in the server against the live state.
"""
from __future__ import annotations

import uuid as uuid_mod


class RPCContext:
    """What an RPC procedure gets: the state of one compound analysis,
    its analyses' details and results, and the engine to run them."""

    def __init__(self, state, compound_analysis_id: str, engine):
        self.state = state
        self.compound_analysis_id = compound_analysis_id
        self.engine = engine

    def get_compound_analysis(self) -> dict:
        return self.state.compound_analysis_state[
            self.compound_analysis_id
        ]

    def have_analysis_results(self, analysis_id: str) -> bool:
        return self.state.analysis_state.have_results(analysis_id)

    def get_analysis_details(self, analysis_id: str) -> dict:
        return self.state.analysis_state[analysis_id]

    def get_analysis_results(self, analysis_id: str):
        return self.state.analysis_state.get_results(analysis_id)

    async def run_analysis(self, analysis_id: str):
        job_id = str(uuid_mod.uuid4())
        return await self.engine.run_analysis(analysis_id, job_id)

    async def run_sync(self, fn, *args, **kwargs):
        """Run blocking compute off the event loop."""
        return await self.engine.run_sync(fn, *args, **kwargs)
