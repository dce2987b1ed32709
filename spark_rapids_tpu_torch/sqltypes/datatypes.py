"""Spark SQL data types and their device representations in the torch port.

A host-only copy of `spark_rapids_tpu/sqltypes/datatypes.py` (the JAX
package's type universe), so the port never imports the JAX package.
Device layouts match the reference column for column:

- integral / fractional / boolean / date / timestamp -> torch tensors of
  the matching width (`torch_dtype`; int64 and float64 exactly, as the
  reference runs with x64 enabled).
- StringType -> a padded byte matrix [rows, max_bytes] uint8 plus an int32
  length vector, or int16/int32 dictionary codes plus a shared dictionary
  (columnar/encoding.py).
- DecimalType(p<=18) -> scaled int64.

All types are singletons except DecimalType/StructType, matching Spark.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch


class DataType:
    """Base of the SQL type lattice."""

    #: numpy dtype of the primary device buffer (None for StringType).
    np_dtype: Optional[np.dtype] = None

    @property
    def simpleString(self) -> str:
        return type(self).__name__.replace("Type", "").lower()

    def __repr__(self) -> str:
        return type(self).__name__ + "()"

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self).__name__)

    @property
    def default_size(self) -> int:
        """Bytes per value of the device representation (validity excluded)."""
        if self.np_dtype is None:
            return 8
        return np.dtype(self.np_dtype).itemsize


class NullType(DataType):
    np_dtype = np.dtype(np.int8)  # carrier; every row is null


class BooleanType(DataType):
    np_dtype = np.dtype(np.bool_)


class NumericType(DataType):
    pass


class IntegralType(NumericType):
    pass


class ByteType(IntegralType):
    np_dtype = np.dtype(np.int8)

    @property
    def simpleString(self):
        return "tinyint"


class ShortType(IntegralType):
    np_dtype = np.dtype(np.int16)

    @property
    def simpleString(self):
        return "smallint"


class IntegerType(IntegralType):
    np_dtype = np.dtype(np.int32)

    @property
    def simpleString(self):
        return "int"


class LongType(IntegralType):
    np_dtype = np.dtype(np.int64)

    @property
    def simpleString(self):
        return "bigint"


class FractionalType(NumericType):
    pass


class FloatType(FractionalType):
    np_dtype = np.dtype(np.float32)


class DoubleType(FractionalType):
    np_dtype = np.dtype(np.float64)


class StringType(DataType):
    """UTF-8 string; device layout is (bytes[rows, max_bytes] u8, len[rows] i32)."""

    np_dtype = None


class DateType(DataType):
    """Days since 1970-01-01, int32 — same physical encoding as Spark/cuDF."""

    np_dtype = np.dtype(np.int32)


class TimestampType(DataType):
    """Microseconds since epoch UTC, int64 — Spark's TIMESTAMP physical encoding."""

    np_dtype = np.dtype(np.int64)


class DecimalType(FractionalType):
    """Fixed-point decimal; device representation is scaled int64.

    The reference supports precision<=38 via cuDF DECIMAL128 and JNI
    `DecimalUtils` (`SURVEY.md` section 2.12); v1 here covers precision<=18
    (DECIMAL64). 128-bit (two-limb int64) is a planned extension.
    """

    MAX_PRECISION = 38
    MAX_LONG_DIGITS = 18
    np_dtype = np.dtype(np.int64)

    def __init__(self, precision: int = 10, scale: int = 0):
        if not (1 <= precision <= self.MAX_PRECISION):
            raise ValueError(f"precision {precision} out of range")
        if not (0 <= scale <= precision):
            raise ValueError(f"scale {scale} out of range for precision {precision}")
        self.precision = precision
        self.scale = scale

    @property
    def simpleString(self):
        return f"decimal({self.precision},{self.scale})"

    def __repr__(self):
        return f"DecimalType({self.precision},{self.scale})"

    def __eq__(self, other):
        return (
            isinstance(other, DecimalType)
            and other.precision == self.precision
            and other.scale == self.scale
        )

    def __hash__(self):
        return hash(("decimal", self.precision, self.scale))


class ArrayType(DataType):
    """Variable-length list of a primitive element type. Device layout
    (columnar.batch): a [cap, max_elems] padded element matrix + per-row
    element counts + per-element validity — the same padded-matrix
    discipline as strings, sized per capacity bucket (the cuDF
    offsets+child layout rethought for XLA static shapes)."""

    def __init__(self, elementType: DataType, containsNull: bool = True):
        self.elementType = elementType
        self.containsNull = containsNull

    @property
    def simpleString(self):
        return f"array<{self.elementType.simpleString}>"

    def __repr__(self):
        return f"ArrayType({self.elementType!r}, {self.containsNull})"

    def __eq__(self, other):
        return (isinstance(other, ArrayType)
                and other.elementType == self.elementType
                and other.containsNull == self.containsNull)

    def __hash__(self):
        return hash(("array", self.elementType, self.containsNull))


class MapType(DataType):
    """map<key, value> with primitive key/value types. Device layout
    (columnar.batch): keys in the column's [cap, max_elems] data
    matrix, values in a parallel map_values matrix, plus per-row entry
    counts and per-entry value validity (keys are never null in Spark
    maps) — the cuDF LIST<STRUCT<K,V>> layout re-thought as two padded
    matrices for XLA static shapes."""

    def __init__(self, keyType: DataType, valueType: DataType,
                 valueContainsNull: bool = True):
        self.keyType = keyType
        self.valueType = valueType
        self.valueContainsNull = valueContainsNull

    @property
    def simpleString(self):
        return (f"map<{self.keyType.simpleString},"
                f"{self.valueType.simpleString}>")

    def __repr__(self):
        return (f"MapType({self.keyType!r}, {self.valueType!r}, "
                f"{self.valueContainsNull})")

    def __eq__(self, other):
        return (isinstance(other, MapType)
                and other.keyType == self.keyType
                and other.valueType == self.valueType
                and other.valueContainsNull == self.valueContainsNull)

    def __hash__(self):
        return hash(("map", self.keyType, self.valueType,
                     self.valueContainsNull))


class StructField:
    def __init__(self, name: str, dataType: DataType, nullable: bool = True):
        self.name = name
        self.dataType = dataType
        self.nullable = nullable

    def __repr__(self):
        return f"StructField({self.name!r}, {self.dataType!r}, {self.nullable})"

    def __eq__(self, other):
        return (
            isinstance(other, StructField)
            and self.name == other.name
            and self.dataType == other.dataType
            and self.nullable == other.nullable
        )


class StructType(DataType):
    def __init__(self, fields: Optional[List[StructField]] = None):
        self.fields = list(fields or [])

    def add(self, name: str, dataType: DataType, nullable: bool = True) -> "StructType":
        return StructType(self.fields + [StructField(name, dataType, nullable)])

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def field_index(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.fields[key]
        return self.fields[self.field_index(key)]

    def __len__(self):
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __repr__(self):
        return f"StructType({self.fields!r})"

    def __eq__(self, other):
        return isinstance(other, StructType) and self.fields == other.fields

    def __hash__(self):
        return hash(tuple((f.name, f.dataType, f.nullable) for f in self.fields))


# Singleton instances, Spark-style module-level names.
null_t = NullType()
boolean = BooleanType()
byte = ByteType()
short = ShortType()
integer = IntegerType()
long = LongType()
float_t = FloatType()
double = DoubleType()
string = StringType()
date = DateType()
timestamp = TimestampType()

INTEGRAL_TYPES: Tuple[DataType, ...] = (byte, short, integer, long)
FRACTIONAL_TYPES: Tuple[DataType, ...] = (float_t, double)
NUMERIC_TYPES: Tuple[DataType, ...] = INTEGRAL_TYPES + FRACTIONAL_TYPES
ATOMIC_TYPES: Tuple[DataType, ...] = (
    (boolean,) + NUMERIC_TYPES + (string, date, timestamp)
)


@functools.lru_cache(maxsize=None)
def _promote_table():
    order = [byte, short, integer, long, float_t, double]
    return {t: i for i, t in enumerate(order)}


def numeric_promotion(a: DataType, b: DataType) -> DataType:
    """Spark's binary-arithmetic common type for non-decimal numerics."""
    tbl = _promote_table()
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        raise ValueError("decimal promotion handled by caller")
    order = [byte, short, integer, long, float_t, double]
    return order[max(tbl[a], tbl[b])]


def from_arrow_type(at) -> DataType:
    """pyarrow DataType -> Spark DataType."""
    import pyarrow as pa

    if pa.types.is_boolean(at):
        return boolean
    if pa.types.is_int8(at):
        return byte
    if pa.types.is_int16(at):
        return short
    if pa.types.is_int32(at):
        return integer
    if pa.types.is_int64(at):
        return long
    if pa.types.is_float32(at):
        return float_t
    if pa.types.is_float64(at):
        return double
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return string
    if pa.types.is_date32(at):
        return date
    if pa.types.is_timestamp(at):
        return timestamp
    if pa.types.is_decimal(at):
        # precision <= 18: scaled int64 (DECIMAL64); wider: [cap, 2]
        # int64 limb pairs (DECIMAL128, ops/decimal128.py)
        return DecimalType(at.precision, at.scale)
    if pa.types.is_list(at) or pa.types.is_large_list(at):
        return ArrayType(from_arrow_type(at.value_type))
    if pa.types.is_map(at):
        return MapType(from_arrow_type(at.key_type),
                       from_arrow_type(at.item_type))
    if pa.types.is_struct(at):
        return StructType([
            StructField(at.field(i).name,
                        from_arrow_type(at.field(i).type),
                        at.field(i).nullable)
            for i in range(at.num_fields)])
    if pa.types.is_dictionary(at):
        return from_arrow_type(at.value_type)
    raise TypeError(f"unsupported arrow type {at}")


def to_arrow_type(dt: DataType):
    import pyarrow as pa

    mapping = {
        BooleanType: pa.bool_(),
        ByteType: pa.int8(),
        ShortType: pa.int16(),
        IntegerType: pa.int32(),
        LongType: pa.int64(),
        FloatType: pa.float32(),
        DoubleType: pa.float64(),
        StringType: pa.string(),
        DateType: pa.date32(),
        TimestampType: pa.timestamp("us", tz="UTC"),
        NullType: pa.null(),
    }
    if isinstance(dt, DecimalType):
        return pa.decimal128(dt.precision, dt.scale)
    if isinstance(dt, ArrayType):
        return pa.list_(to_arrow_type(dt.elementType))
    if isinstance(dt, MapType):
        return pa.map_(to_arrow_type(dt.keyType),
                       to_arrow_type(dt.valueType))
    if isinstance(dt, StructType):
        return pa.struct([
            pa.field(f.name, to_arrow_type(f.dataType), f.nullable)
            for f in dt.fields])
    try:
        return mapping[type(dt)]
    except KeyError:
        raise TypeError(f"unsupported type {dt}")


def parse_type_name(name: str) -> DataType:
    """PySpark-style type-name strings ('int', 'bigint', 'decimal(p,s)',
    ...) -> DataType (Column.cast('long') support)."""
    n = name.strip().lower()
    simple = {
        "boolean": boolean, "bool": boolean,
        "byte": byte, "tinyint": byte,
        "short": short, "smallint": short,
        "int": integer, "integer": integer,
        "long": long, "bigint": long,
        "float": float_t, "real": float_t,
        "double": double,
        "string": string, "str": string,
        "date": date,
        "timestamp": timestamp,
    }
    if n in simple:
        return simple[n]
    if n.startswith("decimal"):
        inner = n[len("decimal"):].strip()
        if not inner:
            return DecimalType(10, 0)
        inner = inner.strip("()")
        p, _, s = inner.partition(",")
        return DecimalType(int(p), int(s or 0))
    raise ValueError(f"cannot parse type name {name!r}")


def parse_ddl_schema(ddl) -> "StructType":
    """'a long, b double' DDL string (or a StructType passthrough) ->
    StructType — the schema argument convention of applyInPandas /
    mapInPandas."""
    if isinstance(ddl, StructType):
        return ddl
    # split on commas not inside parens (decimal(10,2) stays whole)
    parts, depth, cur = [], 0, []
    for ch in str(ddl):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    fields = []
    for part in parts:
        part = part.strip()
        if not part:
            continue
        name, _, tname = part.partition(" ")
        if not tname:
            raise ValueError(f"bad DDL field {part!r} (want 'name type')")
        fields.append(StructField(name.strip(), parse_type_name(tname),
                                  True))
    return StructType(fields)


_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.uint8): torch.uint8,
}


def torch_dtype(dt) -> torch.dtype:
    """torch dtype of a numpy dtype, or of a DataType's `data` leaf
    (StringType -> the uint8 byte matrix)."""
    if isinstance(dt, StringType):
        return torch.uint8
    if isinstance(dt, DataType):
        dt = dt.np_dtype
    return _TORCH_DTYPES[np.dtype(dt)]
