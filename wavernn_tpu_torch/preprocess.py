"""Preprocessing CLI of the PyTorch port (ports ``preprocess.py``).

    python -m wavernn_tpu_torch.preprocess --path wavs --hp_file hp.py \
        [--extension .wav] [--num_workers N]

wav dataset → data/mel/*.npy + data/quant/*.npy + dataset.pkl (+
text_dict.pkl from the LJSpeech ``metadata.csv`` unless ``ignore_tts``).
The features are the JAX package's, from the port's copy of its DSP.
"""

from __future__ import annotations

import argparse
import pickle
from multiprocessing import cpu_count

from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.data.preprocess import preprocess_dataset
from wavernn_tpu_torch.paths import Paths
from wavernn_tpu_torch.text.recipes import ljspeech
from wavernn_tpu_torch.utils.display import progbar, simple_table, stream
from wavernn_tpu_torch.utils.files import get_files


def valid_n_workers(num):
    n = int(num)
    if n < 1:
        raise argparse.ArgumentTypeError(f"{num!r} must be an integer greater than 0")
    return n


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Preprocessing for WaveRNN and Tacotron (PyTorch port)")
    parser.add_argument("--path", "-p", help="directly point to dataset path (overrides hparams.wav_path)")
    parser.add_argument("--extension", "-e", metavar="EXT", default=".wav",
                        help="file extension to search for in dataset folder")
    parser.add_argument("--num_workers", "-w", metavar="N", type=valid_n_workers,
                        default=max(1, cpu_count() - 1),
                        help="number of preprocessing workers")
    parser.add_argument("--hp_file", metavar="FILE", default="hparams.py",
                        help="the file to use for the hyperparameters")
    args = parser.parse_args(argv)

    hp.configure(args.hp_file)
    if args.path is None:
        args.path = hp.wav_path

    wav_files = get_files(args.path, args.extension)
    paths = Paths(hp.data_path, hp.voc_model_id, hp.tts_model_id)

    print(f'\n{len(wav_files)} {args.extension[1:]} files found in "{args.path}"\n')

    if len(wav_files) == 0:
        print("Please point wav_path in hparams.py to your dataset,")
        print("or use the --path option.\n")
        return

    if not hp.ignore_tts:
        text_dict = ljspeech(args.path)
        with open(paths.data / "text_dict.pkl", "wb") as f:
            pickle.dump(text_dict, f)

    n_workers = max(1, args.num_workers)
    simple_table([
        ("Sample Rate", hp.sample_rate),
        ("Bit Depth", hp.bits),
        ("Mu Law", hp.mu_law),
        ("Hop Length", hp.hop_length),
        ("CPU Usage", f"{n_workers}/{cpu_count()}"),
    ])

    def progress(i, n):
        stream(f"{progbar(i, n)} {i}/{n} ")

    preprocess_dataset(wav_files, paths, n_workers=n_workers, progress=progress)
    print('\n\nCompleted. Ready to run "python -m wavernn_tpu_torch.train_wavernn".\n')


if __name__ == "__main__":
    main()
