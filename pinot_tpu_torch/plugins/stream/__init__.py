"""Stream plugins (the port of pinot_tpu/plugins/stream/).

Kafka, Kinesis, Pulsar and the Confluent decoder are not ported yet. The
package exists so that ``spi/plugins.resolve("stream", name)`` looks for
``pinot_tpu_torch.plugins.stream.<name>`` and, finding none, raises the
same ``ValueError`` as for any unknown plugin name.
"""
