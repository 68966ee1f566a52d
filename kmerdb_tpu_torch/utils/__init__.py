"""Host-side utilities: the C++ runtime bindings, formatting, filters, logging."""
