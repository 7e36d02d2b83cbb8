"""Stream connector plugins (the port of pinot_tpu/plugins/stream/;
reference: pinot-plugins/pinot-stream-ingestion).

Importing a connector module registers its streamType with the SPI registry
(spi/stream.py); `get_stream_consumer_factory` auto-imports
``pinot_tpu_torch.plugins.stream.<streamType>`` on first use (kafka,
kinesis, pulsar), so a table config naming ``streamType: kafka`` resolves
without explicit imports. Each client library is optional and imported
where it is used: kafka-python, boto3 and pulsar-client raise the same
ImportError as in the JAX package when absent, and each factory's
``client_factory`` is the seam that injects another client.
"""
