"""Identity gallery: SQLite store and the device-resident exact index."""
