"""The C ABI of the port (`xflow_c_api.h`): a C shim that embeds CPython
and drives `embed.py`."""
