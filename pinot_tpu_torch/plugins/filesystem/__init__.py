"""Object-store PinotFS plugins (the port of pinot_tpu/plugins/filesystem/;
reference: pinot-plugins/pinot-file-system).

Importing a module registers its URI scheme with spi/filesystem.py;
`get_fs` auto-imports ``pinot_tpu_torch.plugins.filesystem.<scheme>`` on first
use. Cloud SDKs are optional dependencies resolved lazily — each plugin
exposes an injectable client factory so tests (and alternate SDKs) run the
full FS surface against fakes.
"""
