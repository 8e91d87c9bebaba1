"""Cost-based planning of read queries.

- ``planner`` — cardinality estimation, operand reordering,
  short-circuiting, CSE through the generation-token-keyed subresult
  cache, and the (inert until calibrated) per-subtree placement.
- ``record`` — plan trees, the per-query plan record, the normalized
  fingerprint.
"""

from .planner import Planner, SubresultCache
from .record import PlanNode, PlanRecord, fingerprint_calls

__all__ = ["Planner", "SubresultCache", "PlanNode", "PlanRecord",
           "fingerprint_calls"]
