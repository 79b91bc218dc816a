"""Copy of tpurt/io: the P6 PPM writer/reader and the OBJ loader."""
