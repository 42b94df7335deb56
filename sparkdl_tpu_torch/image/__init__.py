"""Image schema and IO: image structs, decoding, files to DataFrames."""
