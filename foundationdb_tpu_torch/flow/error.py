"""Error model: FdbError with the reference's numeric codes.

The port's own copy of the reference package's ``flow/error.py`` (itself
modelled on flow/Error.h and flow/error_definitions.h): the same
name -> code table, so retry classification and the client surface match,
plus ``ActorCancelled`` (what a cancelled actor sees at its wait point) and
``SimulationFailure`` (an actor died of a bug, not a simulated fault).
"""

from __future__ import annotations

_ERRORS: dict[str, int] = {
    # name -> code  (subset of flow/error_definitions.h, codes verified
    # against the reference file)
    "success": 0,
    "end_of_stream": 1,
    "operation_failed": 1000,
    "wrong_shard_server": 1001,
    "timed_out": 1004,
    "coordinated_state_conflict": 1005,
    "all_alternatives_failed": 1006,
    "transaction_too_old": 1007,
    "no_more_servers": 1008,
    "future_version": 1009,
    "movekeys_conflict": 1010,
    "tlog_stopped": 1011,
    "server_request_queue_full": 1012,
    "not_committed": 1020,
    "commit_unknown_result": 1021,
    "transaction_cancelled": 1025,
    "connection_failed": 1026,
    "coordinators_changed": 1027,
    "new_coordinators_timed_out": 1028,
    "watch_cancelled": 1029,
    "request_maybe_delivered": 1030,
    "transaction_timed_out": 1031,
    "too_many_watches": 1032,
    "locality_information_unavailable": 1033,
    "watches_disabled": 1034,
    "accessed_unreadable": 1036,
    "process_behind": 1037,
    "database_locked": 1038,
    # Proxy GRV admission shedding (ref: proxy_memory_limit_exceeded /
    # batch_transaction_throttled in later error_definitions.h revisions):
    # the default lane sheds with the former, the batch-priority lane —
    # which starves first under overload — with the latter.  Both are
    # retryable; clients back off exponentially with jitter.
    "proxy_memory_limit_exceeded": 1042,
    "batch_transaction_throttled": 1051,
    "broken_promise": 1100,
    "actor_cancelled": 1101,  # reference name: operation_cancelled
    "recruitment_failed": 1200,
    "move_to_removed_server": 1201,
    "worker_removed": 1202,
    "master_recovery_failed": 1203,
    "master_max_versions_in_flight": 1204,
    "master_tlog_failed": 1205,
    "worker_recovery_failed": 1206,
    "please_reboot": 1207,
    "please_reboot_delete": 1208,
    "master_proxy_failed": 1209,
    "master_resolver_failed": 1210,
    # Rebuild-specific (no 6.0 analog code): a fresh replacement tlog was
    # asked for versions predating its recruitment; the peeker must fail
    # over to a surviving replica of its tag.
    "peek_below_begin": 1211,
    # Rebuild-specific: a coordinator quorum change named an address with
    # no registered worker — the request is unsatisfiable and rejected
    # (the 6.0 changeQuorum surfaces this as CoordinatorsResult, not an
    # error code).
    "no_such_worker": 1212,
    # Rebuild-specific: WRITING_CSTATE found a newer generation already
    # locked — this recovery must abort, not regress the chain (the 6.0
    # equivalent surfaces via coordinated_state_conflict in
    # MovableCoordinatedState).
    "recovery_superseded": 1213,
    # Directory-layer errors (rebuild-specific codes in an unused range;
    # the 6.0 bindings raise language exceptions for these, but the
    # rebuild keeps the one-error-type model).
    "directory_already_exists": 2131,
    "directory_does_not_exist": 2132,
    "directory_incompatible_layer": 2133,
    "directory_moved_under_itself": 2134,
    "directory_prefix_not_empty": 2135,
    "platform_error": 1500,
    "io_error": 1510,
    "file_not_found": 1511,
    "bind_failed": 1512,
    "file_not_readable": 1513,
    "file_not_writable": 1514,
    "file_too_large": 1516,
    "checksum_failed": 1520,
    "io_timeout": 1521,
    "file_corrupt": 1522,
    "client_invalid_operation": 2000,
    "commit_read_incomplete": 2002,
    "key_outside_legal_range": 2004,
    "inverted_range": 2005,
    "invalid_option_value": 2006,
    "invalid_option": 2007,
    "network_not_setup": 2008,
    "read_version_already_set": 2010,
    "version_invalid": 2011,
    "range_limits_invalid": 2012,
    "used_during_commit": 2017,
    "invalid_mutation_type": 2018,
    "transaction_invalid_version": 2020,
    "environment_variable_network_option_failed": 2022,
    "transaction_read_only": 2023,
    "incompatible_protocol_version": 2100,
    "key_too_large": 2102,
    "value_too_large": 2103,
    "unsupported_operation": 2108,
    "http_bad_response": 2150,
    "restore_error": 2301,
    "restore_invalid_version": 2315,
    # Internal: a shard fetch observed its AddingShard replaced mid-page
    # (storage._fetch_pages); consumed by the fetch retry loop only.
    "fetch_superseded": 2317,
    "internal_error": 4100,
}

_CODE_TO_NAME = {v: k for k, v in _ERRORS.items()}


def error_code(name: str) -> int:
    return _ERRORS[name]


class FdbError(Exception):
    """An error with a stable numeric code, as in the reference's Error class.

    `detail` is an optional structured cause riding the error: the proxy
    attaches an abort witness {"version", "range", "range_index"} so the
    client can retry at the conflicting version.  None on every other
    path, so bare errors compare and travel as before."""

    __slots__ = ("code", "name", "detail")

    def __init__(self, name_or_code, detail=None):
        if isinstance(name_or_code, int):
            self.code = name_or_code
            self.name = _CODE_TO_NAME.get(name_or_code, f"error_{name_or_code}")
        else:
            self.name = name_or_code
            self.code = _ERRORS[name_or_code]
        self.detail = detail
        super().__init__(f"{self.name} ({self.code})")

    def is_retryable_in_transaction(self) -> bool:
        # Matches Transaction::onError's retry set (ref:
        # fdbclient/NativeAPI.actor.cpp onError): these reset and retry.
        return self.name in (
            "not_committed",
            "commit_unknown_result",
            "transaction_too_old",
            "future_version",
            "process_behind",
            "database_locked",
            "proxy_memory_limit_exceeded",
            "batch_transaction_throttled",
        )


class ActorCancelled(FdbError):
    """Raised inside a coroutine when its Task is cancelled.

    Subclasses BaseException semantics are not needed; flow treats
    actor_cancelled as an ordinary error that must not be swallowed.
    """

    def __init__(self):
        super().__init__("actor_cancelled")


class SimulationFailure(Exception):
    """An actor crashed with a non-FdbError exception (a genuine bug, not a
    simulated fault).  The event loop surfaces this immediately from
    run_until so a broken role constructor fails every test loudly instead
    of hanging the cluster (the reference crashes the process on broken
    invariants; determinism-as-sanitizer, SURVEY §5)."""


def internal_error(msg: str = "") -> FdbError:
    e = FdbError("internal_error")
    if msg:
        e.args = (f"internal_error (4100): {msg}",)
    return e
