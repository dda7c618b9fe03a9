"""Data readers: ingestion and event-time aggregation (the JAX package's
`readers/` module, on the port's host data path)."""

from transmogrifai_tpu_torch.readers.readers import (
    AggregateDataReader,
    AvroReader,
    ConditionalDataReader,
    CSVReader,
    DataReaders,
    JoinedDataReader,
    ParquetReader,
    Reader,
    SimpleReader,
    StreamingReader,
)

__all__ = [
    "AggregateDataReader", "AvroReader", "ConditionalDataReader", "CSVReader",
    "DataReaders", "JoinedDataReader", "ParquetReader", "Reader", "SimpleReader",
    "StreamingReader",
]
