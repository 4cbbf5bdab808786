"""Error codes.

The reference uses registered named error codes (dsn::error_code,
src/utils/error_code.h) plus rocksdb status codes surfaced through the rrdb
API as int32 `error` fields (src/server/pegasus_server_impl.cpp uses
rocksdb::Status::code()). We keep one enum for framework errors and a small
mapping for the storage-status integers the client-visible rrdb responses
carry (0 = OK, 1 = NotFound, ...).
"""

from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    """Framework-level error codes (parity: src/utils/error_code.h registry)."""

    ERR_OK = 0
    ERR_UNKNOWN = 1
    ERR_SERVICE_NOT_FOUND = 2
    ERR_SERVICE_ALREADY_RUNNING = 3
    ERR_INVALID_PARAMETERS = 4
    ERR_OBJECT_NOT_FOUND = 5
    ERR_TIMEOUT = 6
    ERR_BUSY = 7
    ERR_NETWORK_FAILURE = 8
    ERR_HANDLER_NOT_FOUND = 9
    ERR_OPERATION_DISABLED = 10
    ERR_NOT_ENOUGH_MEMBER = 11
    ERR_FILE_OPERATION_FAILED = 12
    ERR_INVALID_STATE = 13
    ERR_INACTIVE_STATE = 14
    ERR_NOT_IMPLEMENTED = 15
    ERR_CHECKPOINT_FAILED = 16
    ERR_WRONG_TIMING = 17
    ERR_NO_NEED_OPERATE = 18
    ERR_CORRUPTION = 19
    ERR_TRY_AGAIN = 20
    ERR_CLUSTER_NOT_FOUND = 21
    ERR_CLUSTER_ALREADY_EXIST = 22
    ERR_APP_NOT_EXIST = 23
    ERR_APP_EXIST = 24
    ERR_APP_DROPPED = 25
    ERR_BUSY_CREATING = 26
    ERR_BUSY_DROPPING = 27
    ERR_EXPIRED = 28
    ERR_LOCK_ALREADY_EXIST = 29
    ERR_HOLD_BY_OTHERS = 30
    ERR_RECURSIVE_LOCK = 31
    ERR_NO_OWNER = 32
    ERR_NODE_ALREADY_EXIST = 33
    ERR_INCONSISTENT_STATE = 34
    ERR_ARRAY_INDEX_OUT_OF_RANGE = 35
    ERR_DIR_NOT_EMPTY = 36
    ERR_PATH_NOT_FOUND = 37
    ERR_PATH_ALREADY_EXIST = 38
    ERR_ADDRESS_ALREADY_USED = 39
    ERR_STATE_FREEZED = 40
    ERR_LOCAL_APP_FAILURE = 41
    ERR_BIND_IOCP_FAILED = 42
    ERR_NETWORK_INIT_FAILED = 43
    ERR_FORWARD_TO_OTHERS = 44
    ERR_OBJECT_EXIST = 45
    ERR_NO_NEED_LEARN = 46
    ERR_LEARN_FILE_FAILED = 47
    ERR_GET_LEARN_STATE_FAILED = 48
    ERR_INVALID_VERSION = 49
    ERR_INGESTION_FAILED = 50
    ERR_CAPACITY_EXCEEDED = 51
    ERR_CHILD_REGISTERED = 52
    ERR_PARENT_PARTITION_MISUSED = 53
    ERR_CHILD_NOT_READY = 54
    ERR_DISK_INSUFFICIENT = 55
    ERR_SPLITTING = 56
    ERR_RDB_CORRUPTION = 57
    ERR_DISK_IO_ERROR = 58
    ERR_RANGER_POLICIES_NO_NEED_UPDATE = 59
    ERR_RANGER_PARSE_ACL = 60
    ERR_ACL_DENY = 61
    ERR_DUP_EXIST = 62
    ERR_CHECKSUM_FAILED = 63
    ERR_DUP_FENCED = 64
    ERR_STALE_REPLICA = 65
    ERR_CU_OVERBUDGET = 66


class StorageStatus(enum.IntEnum):
    """Per-request storage status codes surfaced in rrdb responses.

    Parity: rocksdb::Status::Code as used by the reference's handlers
    (src/server/pegasus_server_impl.cpp:418 on_get returns Status::code()).
    """

    OK = 0
    NOT_FOUND = 1
    CORRUPTION = 2
    NOT_SUPPORTED = 3
    INVALID_ARGUMENT = 4
    IO_ERROR = 5
    INCOMPLETE = 7
    TRY_AGAIN = 13


def rocksdb_status(ok: bool) -> int:
    """OK or NOT_FOUND as a response's status code."""
    return int(StorageStatus.OK if ok else StorageStatus.NOT_FOUND)


class PegasusError(Exception):
    """Framework exception carrying an ErrorCode."""

    def __init__(self, code: ErrorCode, message: str = ""):
        self.code = code
        super().__init__(f"{code.name}: {message}" if message else code.name)


class StorageCorruptionError(RuntimeError):
    """On-disk bytes failed an integrity check (block crc32, index crc,
    bad magic, an unsupported codec); carries the file path."""

    def __init__(self, path: str, detail: str = ""):
        self.path = path
        self.detail = detail
        super().__init__(f"{path}: {detail}" if detail else path)
