"""Key-component type bytes.

Counterpart of ``yugabyte_db_tpu/dockv/key_encoding.py`` cut to the
``ValueType`` bytes the vectorized bulk encoders (bulk.py) write.  They
are the reference's bytes, so encoded keys — and the key hashes derived
from them — match byte for byte."""
from __future__ import annotations


class ValueType:
    """Type bytes for key components, ordered so encodings sort
    correctly (analog of reference dockv::KeyEntryType)."""
    kGroupEnd = 0x03
    kHybridTime = 0x05
    kUInt16Hash = 0x08   # 2-byte big-endian hash prefix (key start only)
    kInt32 = 0x24
    kInt64 = 0x26
    kDouble = 0x28
    kTimestamp = 0x2C
    # descending variants (= kX + 0x20): payload bytes complemented
    kInt32Desc = 0x44
    kInt64Desc = 0x46
    kDoubleDesc = 0x48
    kTimestampDesc = 0x4C
