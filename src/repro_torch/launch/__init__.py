"""Launchers (counterpart of ``repro.launch``).

serve     the serving launcher: BNN engines, workloads, multi-tenant lanes
          and the LM decode server behind the servers' protocol, with
          artifacts, the request journal and a seeded fault storm
train     the fault-tolerant LM training driver: checkpoints, restart,
          the straggler monitor, ``--fail-at``
"""
