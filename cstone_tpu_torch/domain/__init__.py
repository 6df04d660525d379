"""Domain decomposition and sync (counterpart of cstone_tpu/domain)."""

from .domain import CAP_NAMES, Domain, DomainState, SyncResult, sync_with_retry

__all__ = ["CAP_NAMES", "Domain", "DomainState", "SyncResult", "sync_with_retry"]
