"""Launchers (counterpart of ``repro.launch``).

mesh      named meshes over torch.distributed (``make_host_mesh``), the
          process group from torchrun's environment or N spawned ranks
serve     the serving launcher: BNN engines, workloads, multi-tenant lanes
          and the LM decode server behind the servers' protocol, with
          artifacts, the request journal and a seeded fault storm; under
          torchrun the LM server sharded over a (1, N) mesh
train     the fault-tolerant LM training driver: checkpoints, restart,
          the straggler monitor, ``--fail-at``
"""
