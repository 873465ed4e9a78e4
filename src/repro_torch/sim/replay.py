"""``python -m repro_torch.sim.replay`` — what-if wall-time prediction.

Thin entry point for the trace subsystem's replay walker; the
implementation (and the library API ``predict_run``) lives in
``repro_torch.sim.trace.replay``.  The cost model comes from the caller
(``--model``: a model dict, or a trace ``.jsonl`` recorded on the
machine to predict for); there is no default.
"""
from repro_torch.sim.trace.replay import build_parser, main, predict_run

__all__ = ["build_parser", "main", "predict_run"]

if __name__ == "__main__":
    import sys
    sys.exit(main())
