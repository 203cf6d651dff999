"""The paper's contribution on the port: adaptive cost/capacity
orchestration (§3), the counterpart of the JAX package's ``core``.

  policy        — Eq.(5)/(6)/(7)/(8) + switching, on torch tensors (float32)
  deployment    — DUProfile / DeploymentUnit (the (model,hw,framework) triplet)
  capacity      — CapacityPool dynamics (Karpenter stand-in)
  autoscaler    — KEDA-style replica controller
  controller    — binary-step mode switcher (+ hysteresis/EWMA extensions)
  router        — weighted routing, spillover, queue latency, hedging
  simulator     — discrete-event cluster simulator (Figs. 5-7 testbed)
  metrics       — per-tick and per-request accounting
  allocation    — LP/greedy exact solvers for Eq.(1)-(3) (beyond paper)
"""
