"""One-off measurements on the card that the kernels' designs rest on."""
