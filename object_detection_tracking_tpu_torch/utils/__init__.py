"""Host-side helpers: mask pasting and RLE, drawing."""
