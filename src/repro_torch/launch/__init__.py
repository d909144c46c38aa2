"""Launchers (counterpart of ``repro.launch``).

mesh      named meshes over torch.distributed (``make_host_mesh``), the
          process group from torchrun's environment or N spawned ranks;
          the production meshes (``make_production_mesh``: 16×16,
          2×16×16) over a fake process group in one process
cells     (arch × shape) -> one rank's step, its inputs' global and local
          shapes and specs; ``trace_step`` runs it once on fakes
          (FakeTensorMode) and counts FLOPs, bytes, collectives, the peak
analysis the counts as H100 roofline terms (``CellReport``),
          ``model_flops_cell``
dryrun    trace every cell on the production meshes; the report table
serve     the serving launcher: BNN engines, workloads, multi-tenant lanes
          and the LM decode server behind the servers' protocol, with
          artifacts, the request journal and a seeded fault storm; under
          torchrun the LM server sharded over a (1, N) mesh
train     the fault-tolerant LM training driver: checkpoints, restart,
          the straggler monitor, ``--fail-at``
"""
