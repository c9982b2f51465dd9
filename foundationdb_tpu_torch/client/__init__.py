"""Client library: Database / Transaction with read-your-writes.

Reference: REF:fdbclient/NativeAPI.actor.cpp (Transaction) wrapped by
REF:fdbclient/ReadYourWrites.actor.cpp (RYW cache + conflict-range
bookkeeping).  Here both collapse into one Transaction class because the
RYW layer is not optional in practice.
"""

from .database import Database
from .transaction import Transaction
from .change_feed import ChangeFeedCursor
from ..core.data import KeySelector
