"""The port's operator scripts: copies of the reference's ``scripts/``
pointed at the port, each run as ``python -m pbft_tpu_torch.scripts.<name>``.

- ``pbft_lint``           every static-analysis pass (``analysis/``)
- ``check_trace_schema``  the metrics pass alone (a shim)
- ``verify_status``       the verify daemon's JSON status
- ``flight_dump``         decode black-box flight-recorder dumps
- ``trace_report``        summarize per-replica JSONL traces
- ``consensus_timeline``  per-(view, seq) phase breakdowns across replicas
- ``pbft_top``            live ``/status`` console and health gate
- ``chaos_bench``         a gateway firehose under a seeded fault schedule
- ``endurance_soak``      a WAL-on soak gated by the health detectors

``chaos_bench`` and ``endurance_soak`` verify on the card by default: they
start the port's verify daemon (``--verifier daemon``) and dial every
replica to it; ``--verifier cpu`` runs each replica's host verify pool.
"""
