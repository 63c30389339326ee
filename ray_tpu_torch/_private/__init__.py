"""Private helpers of the port: `constants` (the engine's tunables)."""
