"""Error types for the AgileLog abstraction."""


class AgileLogError(Exception):
    """Base class for AgileLog errors."""


class UnknownLog(AgileLogError):
    """Operation on a log id that does not exist (or was squashed/promoted away)."""


class ForkBlocked(AgileLogError):
    """Operation blocked because an active promotable cFork restricts it (§4.1)."""


class InvalidOperation(AgileLogError):
    """Semantically invalid call (e.g. squash of a root log, promote of an sFork)."""


class ConflictError(AgileLogError):
    """A speculative commit could not be sequenced (DESIGN.md §12).

    Raised by ``Speculation.commit()`` when the bounded auto-rebase budget is
    exhausted (the parent kept advancing, or a sibling speculation won the
    promote race), or when an ``on_rebase`` validation hook rejects the
    rebased state. Carries the metadata layer's fork-point/tail diagnostics
    so the caller can see exactly how far the parent ran ahead.
    """

    def __init__(self, msg: str, *, log_id=None, fork_id=None, fork_point=None,
                 parent_tail=None, expected=None, advanced=0, attempts=0,
                 holds_epoch=None) -> None:
        super().__init__(msg)
        self.log_id = log_id            # the parent (commit target)
        self.fork_id = fork_id          # the speculative cFork
        self.fork_point = fork_point    # fork point of the last attempt
        self.parent_tail = parent_tail  # parent tail the metadata layer saw
        self.expected = expected        # parent tail the speculation validated
        self.advanced = advanced        # records sequenced past `expected`
        self.attempts = attempts        # promote attempts (1 + rebases)
        self.holds_epoch = holds_epoch  # metadata holds_version at the check


class ObjectMissing(AgileLogError, KeyError):
    """A GET/ranged-GET named an object key the store does not hold.

    Every backend raises this one type (DESIGN.md §18) — the seed backends
    leaked their implementation's native miss (`KeyError` from the dict-backed
    stores, `FileNotFoundError` from the file store), so a caller that caught
    one silently missed the other. Deterministic, not transient: the key is
    gone (reaped, never written, or torn and swept) and retrying will not
    bring it back. Subclasses ``KeyError`` so pre-§18 external callers that
    caught the memory backend's miss keep working.
    """

    def __init__(self, key=None) -> None:
        super().__init__(f"object missing: {key!r}")
        self.key = key

    def __str__(self) -> str:        # KeyError.__str__ repr()s the arg
        return self.args[0]


class Unavailable(AgileLogError):
    """A layer of the system cannot serve the request *right now* (DESIGN.md
    §15). Unlike the deterministic command errors above, unavailability is
    transient-by-contract: the client retry policy treats every subclass as
    retryable (replicas recover, brokers fail over, leaders get re-elected).
    """


class NoQuorum(Unavailable):
    """The metadata layer lost its majority: proposals cannot commit and a
    leader cannot be elected until enough replicas recover."""


class NotLeader(Unavailable):
    """Metadata proposal handled by a replica that is not (or no longer) the
    leader (DESIGN.md §16). Under the message-level network plane this is the
    term fence: a partitioned stale leader's AppendEntries are rejected by the
    higher term of the majority-side quorum, so its proposals raise this
    instead of acking. Retryable — the client's :class:`RetryPolicy` fails
    over to the current leader."""


class LeaseExpired(Unavailable):
    """A lease-fenced local read was attempted on a replica whose leader
    lease has lapsed (DESIGN.md §16). A partitioned stale leader stops
    winning majority ack rounds, its lease stops being extended, and once the
    DES clock passes the lease horizon its local reads are fenced — they
    raise this instead of returning stale state. Retryable: the client fails
    over and re-reads through the current leader."""


class NoLiveBrokers(Unavailable):
    """Every broker in the fleet is marked dead; there is nowhere to route
    the data-plane request."""


class StoreFault(Unavailable):
    """An injected (or, with a real backend, observed) object-store failure:
    a PUT/GET/DELETE that did not complete. A *torn* PUT raises this after
    durably writing a prefix of the payload — the caller must treat the key
    as garbage until a full re-PUT succeeds (DESIGN.md §15)."""


class BrokerCrashed(Unavailable):
    """A broker died mid-operation (injected, DESIGN.md §15) — typically in
    the window after an object PUT and before its metadata proposal. The
    fleet layer fails the broker over on sight: staged group-commit records
    move to a surviving broker, the orphaned PUT goes to the §13 reaper."""

    def __init__(self, msg: str, broker_id=None) -> None:
        super().__init__(msg)
        self.broker_id = broker_id


class AmbiguousProposal(Unavailable):
    """A propose() timed out after the entry may have committed (DESIGN.md
    §15): the command is possibly applied, possibly not. Safe to retry ONLY
    with the same idempotency token — the replicated dedup table makes the
    retry apply-at-most-once."""

    def __init__(self, msg: str, token=None) -> None:
        super().__init__(msg)
        self.token = token          # the idempotency token to retry with


class RetryBudgetExhausted(Unavailable):
    """The client retry policy gave up: every attempt hit an Unavailable
    error and the bounded backoff budget ran out. Carries the last cause."""

    def __init__(self, msg: str, attempts: int = 0,
                 last_error: Exception = None) -> None:
        super().__init__(msg)
        self.attempts = attempts
        self.last_error = last_error
