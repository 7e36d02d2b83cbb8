"""Plugin families (the port of pinot_tpu/plugins/; reference:
pinot-plugins/ — stream ingestion, file systems, input formats, batch
runners, metrics). File-system plugins register with spi/filesystem.py,
input formats with plugins/inputformat/readers.py. The stream plugins
(Kafka, Kinesis, Pulsar, Confluent) are not ported yet: spi/stream.py
resolves a stream type through spi/plugins.py and raises for an unknown
one."""
